"""Sparsity regularization, per-edge activations, pruning and grid
refinement of KAN chains (port of `kanodes_tpu/sparsify/`)."""
