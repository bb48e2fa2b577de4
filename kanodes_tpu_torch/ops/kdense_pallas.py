"""The 2-layer KDense chain as the fused RK kernels see it (port of the
chain math of `kanodes_tpu/ops/kdense_pallas.py`).

`ChainSpec` describes a fusable chain (local basis, swish residual,
tanh/softsign normalizer, one shared grid); `fused_params` views the
chain's parameters as the 2-D blocks the kernels take: `c1 [I*G, H]`,
`w1 [I, H]`, `c2 [H*G, O]`, `w2 [H, O]`, rows `i*G+g`.

`_layer_fwd` / `_layer_bwd` are the per-layer math in plain torch: the
CPU path and the plain versions of the RK kernels (`ops/rk_fused.py`)
are built from them, and `csrc/kan_chain.cuh` computes the same per
row. The basis is indexed `[K, I, G]` directly; the JAX kernels' 0/1
expand/collapse GEMMs exist only because Mosaic cannot reshape, and
are not ported. The standalone chain and single-layer kernels
(`kan_chain_apply`, `kdense_single_apply`) wait (ROADMAP.md, K1/K9).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ChainSpec:
    """Static description of a 2-layer KDense chain (local basis, swish
    base act, tanh or softsign normalizer)."""
    in_dims: int
    hidden: int
    out_dims: int
    grid_len: int
    grid_lims: tuple[float, float] = (-1.0, 1.0)
    denominator: float | None = None
    normalizer: str = "tanh"
    basis: str = "rbf"                 # rbf | iqf | rswaf (local bases)

    @property
    def h(self) -> float:
        if self.denominator is not None:
            return self.denominator
        return (self.grid_lims[1] - self.grid_lims[0]) / (self.grid_len - 1)

    def grid(self) -> np.ndarray:
        """The G basis centers, float32 as the JAX kernels get them."""
        return np.linspace(self.grid_lims[0], self.grid_lims[1],
                           self.grid_len, dtype=np.float32)


def _norm(x, kind: str):
    if kind == "tanh":
        return torch.tanh(x)
    if kind == "softsign":
        return x / (1.0 + torch.abs(x))
    raise ValueError(kind)


def _dnorm(x, kind: str):
    if kind == "tanh":
        t = torch.tanh(x)
        return 1.0 - t * t
    if kind == "softsign":
        d = 1.0 + torch.abs(x)
        return 1.0 / (d * d)
    raise ValueError(kind)


def _basis_val(u, kind: str):
    """B(u) on the normalized distance u, for the three local bases."""
    if kind == "rbf":
        return torch.exp(-(u * u))
    if kind == "iqf":
        return 1.0 / (1.0 + u * u)
    if kind == "rswaf":
        t = torch.tanh(u)
        return 1.0 - t * t
    raise ValueError(kind)


def _basis_du(u, B, kind: str):
    """dB/du given the already-computed B."""
    if kind == "rbf":
        return -2.0 * u * B
    if kind == "iqf":
        return -2.0 * u * B * B
    if kind == "rswaf":
        return -2.0 * torch.tanh(u) * B
    raise ValueError(kind)


def _swish(x):
    return x * torch.sigmoid(x)


def _dswish(x):
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def _layer_fwd(x, c, w, grid, h, normalizer="tanh", basis_kind="rbf"):
    """One KDense layer: x[K,I], c[I*G,O], w[I,O], grid[G].
    Returns (y [K,O], u [K,I,G], basis [K,I*G])."""
    u = (_norm(x, normalizer)[:, :, None] - grid) * (1.0 / h)
    basis = _basis_val(u, basis_kind).reshape(x.shape[0], -1)
    y = basis @ c + _swish(x) @ w
    return y, u, basis


def _layer_bwd(x, c, w, h, u, basis, gy, normalizer="tanh",
               basis_kind="rbf"):
    """Backward of one layer for the cotangent gy [K,O].
    Returns (dx [K,I], dc [I*G,O], dw [I,O])."""
    dc = basis.T @ gy
    dw = _swish(x).T @ gy
    m = (gy @ c.T).reshape(u.shape)
    du = _basis_du(u, basis.reshape(u.shape), basis_kind)
    dxn = (m * du * (1.0 / h)).sum(-1)
    dx = dxn * _dnorm(x, normalizer) + (gy @ w.T) * _dswish(x)
    return dx, dc, dw


def chain_spec_of(chain) -> ChainSpec:
    """Build a ChainSpec from a 2-layer KANChain (validates fusability)."""
    if len(chain.layers) != 2:
        raise ValueError("fused path supports exactly 2 layers")
    l1, l2 = chain.layers
    for l in (l1, l2):
        if l.basis not in ("rbf", "iqf", "rswaf") or \
                (l.base_act, l.use_base_act) != ("swish", True) or \
                l.normalizer not in ("tanh", "softsign"):
            raise ValueError("fused path requires a local basis "
                             "(rbf/iqf/rswaf), swish base act, and a "
                             "tanh/softsign normalizer")
        if l.grid_len != l1.grid_len or l.grid_lims != l1.grid_lims \
                or l.normalizer != l1.normalizer or l.basis != l1.basis:
            raise ValueError("fused path requires shared "
                             "grid/normalizer/basis")
    return ChainSpec(l1.in_dims, l1.out_dims, l2.out_dims, l1.grid_len,
                     tuple(float(v) for v in l1.grid_lims),
                     l1.denominator, l1.normalizer, l1.basis)


def fused_params(chain) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """(c1, w1, c2, w2): the chain's `C` [I,G,O] viewed as [I*G, O]
    (a contiguous view, so gradients reach `C`), and `W` as it is."""
    l1, l2 = chain.layers
    return (l1.C.reshape(-1, l1.C.shape[-1]), l1.W,
            l2.C.reshape(-1, l2.C.shape[-1]), l2.W)
