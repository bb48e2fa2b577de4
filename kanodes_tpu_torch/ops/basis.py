"""Grid-basis functions for KAN layers (port of `kanodes_tpu/ops/basis.py`).

The three local radial bases of the reference basis library
(`Lotka-Volterra/src/utils.jl:8-62`) and the two global ones of the JAX
package (`cheby`, `fourier`), their closed-form derivatives (`BASIS_DX`),
the normalizers and the base activations, as plain torch compositions:
autograd differentiates them, and they are the reference the fused
kernels' plain versions are built from. All bases broadcast
`x[..., 1] against grid[G] -> [..., G]`. `gelu` is the tanh
approximation, `jax.nn.gelu`'s default, in JAX's expression.
`bspline_basis` and `make_bspline_grid` are the B-spline layer's
(`models/bspline.py`): Cox-de Boor on a per-feature padded knot grid.
"""

from __future__ import annotations

from typing import Callable

import math

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


def cheby(x: Tensor, grid: Tensor, h) -> Tensor:
    """Chebyshev polynomials T_0..T_{G-1} of clip(x, -1, 1): `grid` only
    sets G and `h` is unused (the fKAN-style variant of the JAX
    package)."""
    G = grid.shape[-1]
    z = torch.clamp(x, -1.0, 1.0)
    ts = [torch.ones_like(z), z]
    for _ in range(2, G):
        ts.append(2.0 * z * ts[-1] - ts[-2])
    return torch.stack(ts[:G], dim=-1)


def fourier(x: Tensor, grid: Tensor, h) -> Tensor:
    """Truncated Fourier features 1, sin(pi x), cos(pi x), sin(2 pi x),
    ...: G of them; `grid` only sets G and `h` is unused (the
    FourierKAN-style variant of the JAX package)."""
    G = grid.shape[-1]
    feats = [torch.ones_like(x)]
    k = 1
    while len(feats) < G:
        feats.append(torch.sin(k * math.pi * x))
        if len(feats) < G:
            feats.append(torch.cos(k * math.pi * x))
        k += 1
    return torch.stack(feats[:G], dim=-1)


BASIS_FUNCS: dict[str, Callable[..., Tensor]] = {
    "rbf": rbf,
    "rswaf": rswaf,
    "iqf": iqf,
    "cheby": cheby,
    "fourier": fourier,
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


# closed-form first derivatives w.r.t. x (autograd of the bases above
# agrees with them)

def rbf_dx(x: Tensor, grid: Tensor, h) -> Tensor:
    y = (x[..., None] - grid) / h
    return -2.0 * y * torch.exp(-(y * y)) / h


def rswaf_dx(x: Tensor, grid: Tensor, h) -> Tensor:
    y = (x[..., None] - grid) / h
    t = torch.tanh(y)
    return -2.0 * t * (1.0 - t * t) / h


def iqf_dx(x: Tensor, grid: Tensor, h) -> Tensor:
    y = (x[..., None] - grid) / h
    d = 1.0 + y * y
    return -2.0 * y / (d * d) / h


def cheby_dx(x: Tensor, grid: Tensor, h) -> Tensor:
    """dT_k/dx = k U_{k-1}(x); zero outside [-1, 1] (the clip's
    derivative)."""
    G = grid.shape[-1]
    z = torch.clamp(x, -1.0, 1.0)
    inside = ((x >= -1.0) & (x <= 1.0)).to(z.dtype)
    us = [torch.ones_like(z), 2.0 * z]
    for _ in range(2, G - 1):
        us.append(2.0 * z * us[-1] - us[-2])
    ds = [torch.zeros_like(z)]
    for k in range(1, G):
        ds.append(k * us[k - 1] * inside)
    return torch.stack(ds[:G], dim=-1)


def fourier_dx(x: Tensor, grid: Tensor, h) -> Tensor:
    """d/dx of `fourier`: 0, pi cos(pi x), -pi sin(pi x), ..."""
    G = grid.shape[-1]
    ds = [torch.zeros_like(x)]
    k = 1
    while len(ds) < G:
        ds.append(k * math.pi * torch.cos(k * math.pi * x))
        if len(ds) < G:
            ds.append(-k * math.pi * torch.sin(k * math.pi * x))
        k += 1
    return torch.stack(ds[:G], dim=-1)


BASIS_DX = {"rbf": rbf_dx, "rswaf": rswaf_dx, "iqf": iqf_dx,
            "cheby": cheby_dx, "fourier": fourier_dx}


def softsign(x: Tensor) -> Tensor:
    return x / (1.0 + torch.abs(x))


def swish(x: Tensor) -> Tensor:
    return x * torch.sigmoid(x)


_SQRT_2_OVER_PI = float(np.float32(np.sqrt(2 / np.pi)))


def gelu(x: Tensor) -> Tensor:
    """`jax.nn.gelu`'s default, the tanh approximation, written as JAX
    writes it: autograd then differentiates the same expression (torch's
    `gelu(approximate="tanh")` has its own backward formula, which parts
    from JAX's derivative by ~1e-6 in the tails)."""
    cdf = 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI
                                  * (x + 0.044715 * (x ** 3))))
    return x * cdf


def identity(x: Tensor) -> Tensor:
    return x


NORMALIZERS: dict[str, Callable[[Tensor], Tensor]] = {
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softsign": softsign,
    "identity": identity,
}

BASE_ACTS: dict[str, Callable[[Tensor], Tensor]] = {
    "swish": swish,
    "silu": swish,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "gelu": gelu,
    "identity": identity,
}


def get_normalizer(name_or_fn):
    if callable(name_or_fn):
        return name_or_fn
    return NORMALIZERS[name_or_fn]


def get_base_act(name_or_fn):
    if callable(name_or_fn):
        return name_or_fn
    return BASE_ACTS[name_or_fn]


# ---------------------------------------------------------------------------
# Cox-de Boor B-spline basis (efficientkan.py:78-111): a per-feature padded
# knot grid [I, G + 2k + 1], bases of order k by recursion, so that the
# quantile refit of `models/bspline.update_grid` can move the knots.
# ---------------------------------------------------------------------------

def bspline_basis(x: Tensor, grid: Tensor, k: int) -> Tensor:
    """B-spline bases of order `k` (degree k) on a padded knot grid.

    x: [..., I] inputs; grid: [I, G + 2k + 1] knots, ascending along the
    last axis; returns [..., I, G + k] basis values (each row sums to 1
    inside the grid)."""
    x = x[..., None]                         # [..., I, 1]
    # order 0: the indicator of the knot interval
    b = ((x >= grid[..., :-1]) & (x < grid[..., 1:])).to(x.dtype)
    for d in range(1, k + 1):
        left_num = x - grid[..., : -(d + 1)]
        left_den = grid[..., d:-1] - grid[..., : -(d + 1)]
        right_num = grid[..., d + 1:] - x
        right_den = grid[..., d + 1:] - grid[..., 1:-d]
        b = (left_num / left_den) * b[..., :-1] \
            + (right_num / right_den) * b[..., 1:]
    return b


def make_bspline_grid(in_dims: int, grid_size: int, k: int,
                      grid_range: tuple[float, float] = (-1.0, 1.0),
                      dtype=torch.float32, device=None) -> Tensor:
    """Padded uniform knot grid, one row per input feature
    (efficientkan.py:27-36): (arange(-k, G + k + 1) * h + lo) in `dtype`,
    h = (hi - lo) / G, as JAX rounds it."""
    lo, hi = grid_range
    h = (hi - lo) / grid_size
    knots = torch.arange(-k, grid_size + k + 1, dtype=dtype,
                         device=device) * h + lo
    return knots[None, :].repeat(in_dims, 1)
