"""B-spline KAN layer, the efficient-kan flavor (port of
`kanodes_tpu/models/bspline.py`).

Cox-de Boor B-spline bases of order k on a per-feature padded knot grid
(`efficientkan.py:27-36, 78-111`), the least-squares coefficient fit
`curve2coeff` (:113-143), the fused linear forward (:153-166), the
quantile grid refit `update_grid` (:168-215) and the L1 + entropy
regularization view (:217-237).

Parameters, registered in JAX's sorted-key leaf order: `base_w` [I, O],
`coeff` [I, G+k, O], `grid` [I, G+2k+1] and, with the standalone scaler,
`scaler` [I, O]. The knot grid is state, not a weight: a parameter that
does not require grad (JAX keeps it in the params dict under
stop_gradient), so Adam and SGD leave it as it is (`train` refuses
AdamW's weight decay here, which JAX applies to every leaf), `update_grid`
rewrites it, checkpoints and `state_dict` save it, and the continuous
adjoints carry it as a zero cotangent in their augmented state as JAX
does.

`curve2coeff` is JAX's `jnp.linalg.lstsq`: the min-norm least-squares
solution over an SVD, singular values under eps * max(M, N) times the
largest dropped, batched over input features on the layer's device (the
init fit is underdetermined: G + 1 sample rows against G + k
coefficients).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from kanodes_tpu_torch.models.core import glorot_uniform
from kanodes_tpu_torch.ops import basis as B

Tensor = torch.Tensor


def lstsq_min_norm(a: Tensor, b: Tensor) -> Tensor:
    """JAX's `jnp.linalg.lstsq(a, b)[0]` batched over the leading axis:
    a [..., M, N], b [..., M, K] -> [..., N, K], through the SVD with
    JAX's cutoff rcond = eps * max(M, N) relative to the largest singular
    value."""
    m, n = a.shape[-2:]
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    rcond = float(torch.finfo(a.dtype).eps) * max(m, n)
    mask = (s > 0) & (s >= rcond * s[..., :1])
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    return vh.mT @ (s_inv[..., None] * (u.mT @ b))


def quantile_rows(n: int, grid_size: int) -> np.ndarray:
    """JAX's `jnp.linspace(0, n - 1, G + 1).astype(int32)`, truncated as
    XLA computes it in float32: stop (i / G) reassociated to
    i (stop (1 / G)), each product rounded, the stop itself exact (start
    is 0). Another float32 rounding (torch's linspace, or i / G first)
    can land an ulp under an integer and pick the row below: at n = 96,
    G = 19 the fourth row is 15 here and in JAX, 14 in torch."""
    f32 = np.float32
    c = f32(f32(n - 1) * f32(f32(1.0) / f32(grid_size)))
    out = np.arange(grid_size, dtype=f32) * c
    return np.append(out, f32(n - 1)).astype(np.int32)


class BSplineKAN(nn.Module):
    """One KANLinear layer (efficientkan.py:9-76 constructor parity):
    grid_size G intervals, spline order k, coefficients [I, G+k, O].
    Parameters are allocated on `device` (the grid uniform over
    `grid_range`, the rest zero); `init(generator)` draws the reference's
    noise-fit init into them."""

    def __init__(self, in_dims: int, out_dims: int, grid_size: int = 5,
                 spline_order: int = 3, scale_noise: float = 0.1,
                 scale_base: float = 1.0, scale_spline: float = 1.0,
                 base_act: str = "swish", grid_eps: float = 0.02,
                 grid_range: tuple[float, float] = (-1.0, 1.0),
                 standalone_scaler: bool = True, *, device=None):
        super().__init__()
        self.in_dims, self.out_dims = in_dims, out_dims
        self.grid_size, self.spline_order = grid_size, spline_order
        self.scale_noise, self.scale_base = scale_noise, scale_base
        self.scale_spline = scale_spline
        self.base_act, self.grid_eps = base_act, grid_eps
        self.grid_range = tuple(grid_range)
        self.standalone_scaler = standalone_scaler
        self.base_w = nn.Parameter(torch.zeros(in_dims, out_dims,
                                               device=device))
        self.coeff = nn.Parameter(torch.zeros(in_dims, self.n_coeff,
                                              out_dims, device=device))
        self.grid = nn.Parameter(
            B.make_bspline_grid(in_dims, grid_size, spline_order,
                                self.grid_range, device=device),
            requires_grad=False)
        self.scaler = (nn.Parameter(torch.zeros(in_dims, out_dims,
                                                device=device))
                       if standalone_scaler else None)

    @property
    def n_coeff(self) -> int:
        return self.grid_size + self.spline_order

    def num_params(self) -> int:
        """base_w, coeff and the scaler, as JAX counts them (the grid is
        not)."""
        n = self.in_dims * self.out_dims
        n += self.in_dims * self.n_coeff * self.out_dims
        if self.standalone_scaler:
            n += self.in_dims * self.out_dims
        return n

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "BSplineKAN":
        """efficientkan.py:38-62: glorot base weights, spline
        coefficients fit to noise at the grid points, a glorot scaler;
        the grid reset to uniform over `grid_range`."""
        I, O, G, k = self.in_dims, self.out_dims, self.grid_size, \
            self.spline_order
        dev = self.coeff.device
        self.grid.copy_(B.make_bspline_grid(I, G, k, self.grid_range,
                                            device=dev))
        self.base_w.copy_(glorot_uniform((I, O), I, O, generator,
                                         device=dev) * self.scale_base)
        pts = self.grid[:, k:-k].T                     # [G+1, I]
        u = torch.rand((G + 1, I, O), generator=generator,
                       device=generator.device).to(dev)
        noise = (u - 0.5) * self.scale_noise / G
        coeff = self.curve2coeff(pts, noise, self.grid)
        if not self.standalone_scaler:
            coeff = coeff * self.scale_spline
        self.coeff.copy_(coeff)
        if self.standalone_scaler:
            self.scaler.copy_(glorot_uniform((I, O), I, O, generator,
                                             device=dev) * self.scale_spline)
        return self

    def scaled_coeff(self) -> Tensor:
        c = self.coeff
        if self.standalone_scaler:
            c = c * self.scaler[:, None, :]
        return c

    def apply(self, x: Tensor) -> Tensor:
        """[..., I] -> [..., O] (efficientkan.py:153-166)."""
        bas = B.bspline_basis(x, self.grid.detach(), self.spline_order)
        flat = bas.reshape(*bas.shape[:-2], self.in_dims * self.n_coeff)
        spline = flat @ self.scaled_coeff().reshape(
            self.in_dims * self.n_coeff, self.out_dims)
        return spline + B.get_base_act(self.base_act)(x) @ self.base_w

    def forward(self, x: Tensor) -> Tensor:
        return self.apply(x)

    def curve2coeff(self, x: Tensor, y: Tensor, grid: Tensor) -> Tensor:
        """Coefficients [I, G+k, O] whose splines fit (x [N, I], y
        [N, I, O]) in the least-squares, min-norm sense
        (efficientkan.py:113-143, JAX's lstsq)."""
        bas = B.bspline_basis(x, grid, self.spline_order)   # [N, I, G+k]
        return lstsq_min_norm(bas.transpose(0, 1), y.transpose(0, 1))

    @torch.no_grad()
    def update_grid(self, x: Tensor) -> "BSplineKAN":
        """Refit the knot grid to the sample distribution of x ([N, I]),
        quantile knots mixed with uniform ones by grid_eps, then refit
        the coefficients so that the layer's function is kept
        (efficientkan.py:168-215); in place. The refit is folded into
        coeff / scaler, the scaler kept."""
        k, G = self.spline_order, self.grid_size
        bas = B.bspline_basis(x, self.grid, k)
        y = torch.einsum("nig,igo->nio", bas, self.scaled_coeff())
        xs = torch.sort(x, dim=0).values                  # [N, I]
        idx = torch.as_tensor(quantile_rows(x.shape[0], G),
                              dtype=torch.long, device=x.device)
        grid_adaptive = xs[idx].T                         # [I, G+1]
        step = (xs[-1] - xs[0] + 2 * 0.01) / G            # margin (:189)
        ar = torch.arange(G + 1, device=x.device)
        grid_uniform = (xs[0] - 0.01)[:, None] + step[:, None] * ar[None, :]
        core = self.grid_eps * grid_uniform \
            + (1 - self.grid_eps) * grid_adaptive         # [I, G+1]
        left = core[:, :1] - step[:, None] * torch.arange(
            k, 0, -1, device=x.device)
        right = core[:, -1:] + step[:, None] * torch.arange(
            1, k + 1, device=x.device)
        new_grid = torch.cat([left, core, right], dim=1)
        new_coeff = self.curve2coeff(x, y, new_grid)
        self.grid.copy_(new_grid)
        if self.standalone_scaler:
            new_coeff = new_coeff / self.scaler[:, None, :]
        self.coeff.copy_(new_coeff)
        return self

    def regularization_loss(self, act_reg: float = 1.0,
                            entropy_reg: float = 1.0) -> Tensor:
        """L1 + entropy over the per-edge mean |coeff|
        (efficientkan.py:217-237)."""
        a = self.coeff.abs().mean(dim=1)                  # [I, O] (:229)
        total = torch.sum(a)
        frac = a / (total + 1e-12)
        entropy = -torch.sum(frac * torch.log(frac + 1e-12))
        return act_reg * total + entropy_reg * entropy


class BSplineKANChain(nn.Module):
    """Stack of BSplineKAN layers, the reference `KAN` module
    (efficientkan.py:240-285) with `update_grids` threading."""

    def __init__(self, widths: list[int], *, device=None, **kw):
        super().__init__()
        self.layers = nn.ModuleList(
            BSplineKAN(i, o, device=device, **kw)
            for i, o in zip(widths[:-1], widths[1:]))
        self.in_dims, self.out_dims = widths[0], widths[-1]

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "BSplineKANChain":
        for layer in self.layers:
            layer.init(generator)
        return self

    def apply(self, x: Tensor) -> Tensor:
        for layer in self.layers:
            x = layer.apply(x)
        return x

    def forward(self, x: Tensor) -> Tensor:
        return self.apply(x)

    @torch.no_grad()
    def update_grids(self, x: Tensor) -> "BSplineKANChain":
        """Thread x through the chain, refitting every layer's grid on
        its inputs (efficientkan.py:263-266); in place."""
        for layer in self.layers:
            layer.update_grid(x)
            x = layer.apply(x)
        return self

    def num_params(self) -> int:
        return sum(layer.num_params() for layer in self.layers)

    def regularization_loss(self, act_reg: float = 1.0,
                            entropy_reg: float = 1.0) -> Tensor:
        return sum(layer.regularization_loss(act_reg, entropy_reg)
                   for layer in self.layers)

    def param_dicts(self) -> list[dict[str, Tensor]]:
        """The layers' tensors as JAX's per-layer dicts `{base_w, coeff,
        grid, scaler}` (the tensors themselves, not copies)."""
        return [{n: p for n, p in layer.named_parameters()}
                for layer in self.layers]
