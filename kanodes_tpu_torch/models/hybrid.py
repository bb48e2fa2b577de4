"""Hybrid KAN + MLP model and data normalization (port of
`kanodes_tpu/models/hybrid.py`).

The optimized-PyTorch pipeline's extras
(`Lotka-Volterra-Pytorch/optimized_kan.py`):
  * `HybridKANMLP` (:346-389): a B-spline KAN branch and an MLP branch
    blended by a learned scalar gate, alpha = sigmoid(gate):
    y = alpha kan + (1 - alpha) mlp. Parameters in JAX's sorted-key leaf
    order: `gate`, then the `kan` chain's, then the `mlp`'s;
  * `DataNormalizer` (:396-464): min-max mapping of states to [-1, 1]
    with the chain-rule RHS rescaling used in ODE training
    (`optimized_training.py:382-394`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from kanodes_tpu_torch.models.bspline import BSplineKANChain
from kanodes_tpu_torch.models.mlp import MLP

Tensor = torch.Tensor


class HybridKANMLP(nn.Module):
    """alpha-blended KAN + MLP (optimized_kan.py:346-389)."""

    def __init__(self, widths: list[int], grid_size: int = 5,
                 mlp_hidden: int = 32, *, device=None, **kan_kw):
        super().__init__()
        self.gate = nn.Parameter(torch.zeros((), device=device))
        self.kan = BSplineKANChain(widths, grid_size=grid_size,
                                   device=device, **kan_kw)
        self.mlp = MLP((widths[0], mlp_hidden, widths[-1]), device=device)
        self.in_dims, self.out_dims = widths[0], widths[-1]

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "HybridKANMLP":
        """The KAN's init, then the MLP's, from one generator; the gate
        at 0 (sigmoid(0) = 0.5, :361)."""
        self.kan.init(generator)
        self.mlp.init(generator)
        self.gate.zero_()
        return self

    def apply(self, x: Tensor) -> Tensor:
        alpha = torch.sigmoid(self.gate)
        return alpha * self.kan.apply(x) + (1.0 - alpha) * self.mlp.apply(x)

    def forward(self, x: Tensor) -> Tensor:
        return self.apply(x)

    def blend(self) -> float:
        return float(torch.sigmoid(self.gate.detach()))

    def num_params(self) -> int:
        return self.kan.num_params() + self.mlp.num_params() + 1


@dataclasses.dataclass
class DataNormalizer:
    """Min-max to [-1, 1] (optimized_kan.py:396-464), fit on host data;
    `scale` is the per-dim half-range of the RHS rescaling: if z =
    norm(u), dz/dt = du/dt / scale."""

    lo: np.ndarray
    hi: np.ndarray

    @classmethod
    def fit(cls, X: np.ndarray, margin: float = 0.0) -> "DataNormalizer":
        lo = X.min(axis=0) - margin
        hi = X.max(axis=0) + margin
        span = np.maximum(hi - lo, 1e-12)
        return cls(lo.astype(np.float32), (lo + span).astype(np.float32))

    @property
    def scale(self) -> np.ndarray:
        return (self.hi - self.lo) / 2.0

    def _bounds(self, like: Tensor) -> tuple[Tensor, Tensor]:
        return (torch.as_tensor(self.lo, device=like.device),
                torch.as_tensor(self.hi, device=like.device))

    def normalize(self, u: Tensor) -> Tensor:
        lo, hi = self._bounds(u)
        return 2.0 * (u - lo) / (hi - lo) - 1.0

    def denormalize(self, z: Tensor) -> Tensor:
        lo, hi = self._bounds(z)
        return (z + 1.0) * (hi - lo) / 2.0 + lo

    def wrap_rhs(self, rhs):
        """rhs(t, u, p) in physical space -> the normalized-space RHS
        (optimized_training.py:382-394): the model sees z in [-1, 1], the
        dynamics rescaled by 1 / scale."""
        def rhs_norm(t, z, p):
            s = torch.as_tensor(self.scale, device=z.device)
            return rhs(t, self.denormalize(z), p) / s

        return rhs_norm
