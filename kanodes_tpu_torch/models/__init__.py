"""KAN layers and containers."""
from kanodes_tpu_torch.models.kdense import KDense, KDense1, KANChain
from kanodes_tpu_torch.models.mlp import MLP

__all__ = ["KDense", "KDense1", "KANChain", "MLP"]
