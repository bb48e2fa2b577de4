"""Bases, chain math and fused RK kernels."""
