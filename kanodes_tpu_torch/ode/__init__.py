"""Fixed-step RK tableaus and integrators."""
