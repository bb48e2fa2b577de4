"""Sparsity regularization, per-edge activations and pruning of KAN
chains (port of `kanodes_tpu/sparsify/`; `grid_refine.py` waits for the
B-spline model, ROADMAP.md M13)."""
