"""Grid-basis functions for KAN layers (port of `kanodes_tpu/ops/basis.py`).

The three local radial bases of the reference basis library
(`Lotka-Volterra/src/utils.jl:8-62`), the tanh/softsign normalizers and
the swish base activation, as plain torch compositions: autograd
differentiates them, and they are the reference the fused kernels'
plain versions are built from. All bases broadcast
`x[..., 1] against grid[G] -> [..., G]`.

`cheby`, `fourier`, `bspline_basis` and the closed-form `*_dx`
derivatives are not ported yet (ROADMAP.md, M1).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

Tensor = torch.Tensor


def make_grid(grid_len: int, grid_lims: tuple[float, float] = (-1.0, 1.0),
              dtype=torch.float32, device=None) -> Tensor:
    """Uniform grid of basis centers (`kdense.jl:88-92`): numpy's
    linspace rounded to `dtype`, the grid the fused kernels get
    (`ChainSpec.grid`), so both paths of the port share it. It can
    differ from `jnp.linspace` in the last bit for other limits than
    (-1, 1)."""
    g = np.linspace(grid_lims[0], grid_lims[1], grid_len)
    return torch.tensor(g, dtype=dtype, device=device)


def default_denominator(grid_len: int,
                        grid_lims: tuple[float, float] = (-1.0, 1.0)) -> float:
    """Shared bandwidth h = span / (G - 1)  (`kdense.jl:27`)."""
    return (grid_lims[1] - grid_lims[0]) / (grid_len - 1)


def rbf(x: Tensor, grid: Tensor, h) -> Tensor:
    """Gaussian RBF: exp(-((x - z)/h)^2)   (utils.jl:8-13)."""
    y = (x[..., None] - grid) / h
    return torch.exp(-(y * y))


def rswaf(x: Tensor, grid: Tensor, h) -> Tensor:
    """Reflectional switch: 1 - tanh((x-z)/h)^2  (utils.jl:27-34)."""
    y = (x[..., None] - grid) / h
    t = torch.tanh(y)
    return 1.0 - t * t


def iqf(x: Tensor, grid: Tensor, h) -> Tensor:
    """Inverse quadratic: 1 / (1 + y^2)   (utils.jl:49-54)."""
    y = (x[..., None] - grid) / h
    return 1.0 / (1.0 + y * y)


BASIS_FUNCS: dict[str, Callable[..., Tensor]] = {
    "rbf": rbf,
    "rswaf": rswaf,
    "iqf": iqf,
}


def get_basis(name_or_fn) -> Callable[..., Tensor]:
    if callable(name_or_fn):
        return name_or_fn
    try:
        return BASIS_FUNCS[name_or_fn]
    except KeyError:
        raise ValueError(
            f"unknown basis {name_or_fn!r}; have {sorted(BASIS_FUNCS)}"
        ) from None


def softsign(x: Tensor) -> Tensor:
    return x / (1.0 + torch.abs(x))


def swish(x: Tensor) -> Tensor:
    return x * torch.sigmoid(x)


NORMALIZERS: dict[str, Callable[[Tensor], Tensor]] = {
    "tanh": torch.tanh,
    "softsign": softsign,
}

BASE_ACTS: dict[str, Callable[[Tensor], Tensor]] = {
    "swish": swish,
    "silu": swish,
}


def get_normalizer(name_or_fn):
    if callable(name_or_fn):
        return name_or_fn
    return NORMALIZERS[name_or_fn]


def get_base_act(name_or_fn):
    if callable(name_or_fn):
        return name_or_fn
    return BASE_ACTS[name_or_fn]
