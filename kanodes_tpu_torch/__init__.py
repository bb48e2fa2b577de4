"""kanodes_tpu_torch — the PyTorch / CUDA port of kanodes_tpu.

The JAX package `kanodes_tpu` stays the reference; every module here
mirrors its counterpart's path and public names, and the tests hold
each one against it. This package imports torch and numpy, never jax.

Its layers (the exports below are the JAX package's top-level names):

  ode/         tableaus (copied), fixed-step and adaptive RK integrators
               with every adjoint of the JAX package, `odeint_adjoint`,
               and the implicit Kvaerno3 solver (`ode/stiff.py`)
  ops/         bases, normalizers and base activations, the chain math,
               and the hand-written CUDA kernels (csrc/) with their plain
               PyTorch versions
  models/      `KDense`, `KDense1`, `KANChain`, `MLP`, packed chains,
               the B-spline chain and the hybrid KAN + MLP
  train/       the training loop (Adam, AdamW, SGD), L-BFGS polish,
               checkpoints, CLI config overrides (copied)
  experiments/ the LV, PDE and sweep experiments and their profilers
  interop.py   numpy params <-> the port's parameters
"""

__version__ = "0.1.0"

from kanodes_tpu_torch.ops import basis as basis
from kanodes_tpu_torch.models.kdense import KDense, KDense1, KANChain
from kanodes_tpu_torch.models.mlp import MLP
from kanodes_tpu_torch.models.bspline import BSplineKAN, BSplineKANChain
from kanodes_tpu_torch.models.hybrid import DataNormalizer, HybridKANMLP
from kanodes_tpu_torch.ode.integrate import (odeint, odeint_adjoint,
                                             odeint_fixed)
from kanodes_tpu_torch.ode.stiff import odeint_implicit

__all__ = [
    "basis",
    "KDense",
    "KDense1",
    "KANChain",
    "MLP",
    "BSplineKAN",
    "BSplineKANChain",
    "DataNormalizer",
    "HybridKANMLP",
    "odeint",
    "odeint_fixed",
    "odeint_adjoint",
    "odeint_implicit",
]
