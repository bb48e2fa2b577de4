"""KAN layers and containers."""
from kanodes_tpu_torch.models.bspline import BSplineKAN, BSplineKANChain
from kanodes_tpu_torch.models.hybrid import DataNormalizer, HybridKANMLP
from kanodes_tpu_torch.models.kdense import KDense, KDense1, KANChain
from kanodes_tpu_torch.models.mlp import MLP

__all__ = ["BSplineKAN", "BSplineKANChain", "DataNormalizer",
           "HybridKANMLP", "KDense", "KDense1", "KANChain", "MLP"]
