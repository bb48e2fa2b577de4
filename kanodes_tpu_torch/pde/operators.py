"""1-D method-of-lines finite-difference operators (port of
`kanodes_tpu/pde/operators.py`).

Two forms, as there: stencils on tensors (`torch.roll` and slicing,
O(N), over the last axis or the last two) and dense operator matrices
and grids, which stay numpy: they are built once on the host and sent to
the device by their caller.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


# -- stencil forms -----------------------------------------------------------

def laplacian_periodic(u: Tensor, dx: float) -> Tensor:
    """Second-order centered Laplacian with periodic wrap (last axis)."""
    return (torch.roll(u, -1, dims=-1) - 2.0 * u + torch.roll(u, 1, dims=-1)) \
        / (dx * dx)


def laplacian_periodic_2d(u: Tensor, dx: float) -> Tensor:
    """5-point periodic Laplacian over the last TWO axes (square dx)."""
    return (torch.roll(u, -1, dims=-1) + torch.roll(u, 1, dims=-1)
            + torch.roll(u, -1, dims=-2) + torch.roll(u, 1, dims=-2)
            - 4.0 * u) / (dx * dx)


def _pad(u: Tensor, left: float, right: float) -> Tensor:
    return torch.cat([torch.full_like(u[..., :1], left), u,
                      torch.full_like(u[..., :1], right)], dim=-1)


def laplacian_dirichlet(u: Tensor, dx: float, left: float = 0.0,
                        right: float = 0.0) -> Tensor:
    """Centered Laplacian with Dirichlet ghost values (last axis)."""
    up = _pad(u, left, right)
    return (up[..., 2:] - 2.0 * up[..., 1:-1] + up[..., :-2]) / (dx * dx)


def ddx_central_periodic(u: Tensor, dx: float) -> Tensor:
    return (torch.roll(u, -1, dims=-1) - torch.roll(u, 1, dims=-1)) \
        / (2.0 * dx)


def ddx_central_dirichlet(u: Tensor, dx: float, left: float = 0.0,
                          right: float = 0.0) -> Tensor:
    up = _pad(u, left, right)
    return (up[..., 2:] - up[..., :-2]) / (2.0 * dx)


# -- dense operator matrices (Fisher-KPP_Source.jl:55-59 pattern) -----------

def laplacian_matrix_periodic(n: int, dx: float, dtype=np.float64) -> np.ndarray:
    lap = (np.diag(-2.0 * np.ones(n)) + np.diag(np.ones(n - 1), 1)
           + np.diag(np.ones(n - 1), -1))
    lap[0, -1] = 1.0
    lap[-1, 0] = 1.0
    return (lap / dx ** 2).astype(dtype)


def laplacian_matrix_dirichlet(n: int, dx: float, dtype=np.float64) -> np.ndarray:
    lap = (np.diag(-2.0 * np.ones(n)) + np.diag(np.ones(n - 1), 1)
           + np.diag(np.ones(n - 1), -1))
    return (lap / dx ** 2).astype(dtype)


# -- grids -------------------------------------------------------------------

def uniform_grid(lo: float, hi: float, n: int, *, endpoint: bool = True,
                 dtype=np.float64):
    """Return (x, dx). endpoint=False gives the periodic convention."""
    if endpoint:
        x = np.linspace(lo, hi, n, dtype=dtype)
        dx = (hi - lo) / (n - 1)
    else:
        x = np.linspace(lo, hi, n, endpoint=False, dtype=dtype)
        dx = (hi - lo) / n
    return x, float(dx)
