"""Strain-limiting PINN physics: residual, stress, and loss terms (port of
`kanodes_tpu/pinn/losses.py`).

PDE (Eq. 40 of the strain-limiting model): with the nonlinear flux
    q = grad(phi) / (2 mu (1 + beta |grad phi|^alpha)^(1/alpha)),
find phi with div q = 0 on the notched plate.

Rebuild of `StrainLimiting_KAN_PINN.py:560-860` (autograd residual,
tip-weighted PDE loss, Dirichlet boundary loss, gauge pin, mirror
symmetry, tip-stress amplitude + near/far ratio hinge) and the Julia
FD-residual flavor (`StrainLimiting_KAN_PINN.jl:109-149`).

Every function takes the field batched: `phi(xy [N, 2]) -> [N]` (e.g.
`model.phi`), where JAX's takes it a point at a time under `vmap`.
Each point's value depends on its own coordinates only, so a gradient of
the batch's sum in the coordinates is every point's gradient at once.
The residual is reverse over reverse: g = d(sum phi)/d(xy) with
`create_graph`, the flux q(g), then one more coordinate gradient of each
flux component's sum, d q_x/dx + d q_y/dy. JAX takes the same
derivatives forward over reverse, per point under `vmap`; the two agree
to rounding. With `create_graph=True` (the default, the training loss)
the parameter gradient comes back through all of it; scoring a candidate
pool passes False. The FD flavor evaluates the field at JAX's 16 shifted
points of every point ((p + s) + t for s, t in +-h e_x, +-h e_y, rounded
as JAX rounds them) stacked into one call.
"""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Material:
    """MaterialParams (StrainLimiting_KAN_PINN.py:62-66)."""
    mu: float = 1.0
    beta: float = 1.0
    alpha: float = 0.2


def flux_from_grad(g: Tensor, mat: Material, eps: float = 1e-10) -> Tensor:
    """q = g / (2 mu (1 + beta |g|^alpha)^(1/alpha))  (:560-565)."""
    gnorm = torch.sqrt(torch.sum(g * g, dim=-1) + eps)
    denom = 2.0 * mat.mu * (1.0 + mat.beta * gnorm ** mat.alpha) \
        ** (1.0 / mat.alpha)
    return g / denom[..., None]


def field_grad(phi, xy: Tensor, create_graph: bool = True) -> Tensor:
    """grad phi at each point of xy [N, 2] -> [N, 2]; with
    `create_graph` it is differentiable again (in xy and in the
    parameters)."""
    with torch.enable_grad():
        xy = xy.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(phi(xy).sum(), xy,
                                   create_graph=create_graph)
    return g


def pde_residual(phi, xy: Tensor, mat: Material, eps: float = 1e-10,
                 create_graph: bool = True) -> Tensor:
    """div q at each point of xy [N, 2] -> [N] (:612-654)."""
    with torch.enable_grad():
        xy = xy.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(phi(xy).sum(), xy, create_graph=True)
        q = flux_from_grad(g, mat, eps)
        (dqx,) = torch.autograd.grad(q[:, 0].sum(), xy, retain_graph=True,
                                     create_graph=create_graph)
        (dqy,) = torch.autograd.grad(q[:, 1].sum(), xy,
                                     create_graph=create_graph)
    return dqx[:, 0] + dqy[:, 1]


def _fd_shifts(xy: Tensor, fd_eps: float) -> Tensor:
    """[+h e_x, -h e_x, +h e_y, -h e_y] added to xy: [4, N, 2], each sum
    as JAX's `p + ex` rounds it."""
    h = torch.tensor(fd_eps, dtype=xy.dtype, device=xy.device)
    z = torch.zeros((), dtype=xy.dtype, device=xy.device)
    e = torch.stack([torch.stack([h, z]), torch.stack([-h, z]),
                     torch.stack([z, h]), torch.stack([z, -h])])
    # p - ex is p + (-ex) exactly (negation is exact)
    return xy[None] + e[:, None, :]


def pde_residual_fd(phi, xy: Tensor, mat: Material, fd_eps: float = 2e-3,
                    eps: float = 1e-10) -> Tensor:
    """Julia-flavor nested central finite differences
    (`StrainLimiting_KAN_PINN.jl:109-149`): 16 field values per point,
    one call."""
    n = xy.shape[0]
    outer = _fd_shifts(xy, fd_eps)                     # [4, N, 2]
    pts = _fd_shifts(outer.reshape(4 * n, 2), fd_eps)  # [4 (inner), 4N, 2]
    vals = phi(pts.reshape(16 * n, 2)).reshape(4, 4, n)   # [inner, outer, N]
    two_h = 2 * fd_eps
    g = torch.stack([(vals[0] - vals[1]) / two_h,
                     (vals[2] - vals[3]) / two_h], dim=-1)   # [outer, N, 2]
    q = flux_from_grad(g, mat, eps)
    dqx = (q[0, :, 0] - q[1, :, 0]) / two_h
    dqy = (q[2, :, 1] - q[3, :, 1]) / two_h
    return dqx + dqy


def stress(phi, xy: Tensor, eps: float = 1e-10, create_graph: bool = True
           ) -> tuple[Tensor, Tensor, Tensor]:
    """(tau_xz, tau_yz, tau_eq): tau_xz = d(phi)/dy, tau_yz = -d(phi)/dx
    (:637-655)."""
    g = field_grad(phi, xy, create_graph)
    tau_xz = g[:, 1]
    tau_yz = -g[:, 0]
    tau_eq = torch.sqrt(tau_xz ** 2 + tau_yz ** 2 + eps)
    return tau_xz, tau_yz, tau_eq


# ---------------------------------------------------------------------------
# loss terms
# ---------------------------------------------------------------------------

def tip_residual_weights(xy: Tensor, tip: tuple[float, float],
                         power: float = 0.5, w_eps: float = 1e-3,
                         clip: float = 50.0) -> Tensor:
    """1/(dist^power + eps) residual weights, mean-normalized + clipped
    (:672-686)."""
    if power <= 0:
        return torch.ones(xy.shape[0], dtype=xy.dtype, device=xy.device)
    d = torch.sqrt((xy[:, 0] - tip[0]) ** 2 + (xy[:, 1] - tip[1]) ** 2
                   + 1e-10)
    raw = 1.0 / (d ** power + w_eps)
    raw = raw / torch.clamp_min(raw.mean(), 1e-12).detach()
    return torch.clamp_max(raw, clip) if clip > 0 else raw


def residual_of(phi, xy: Tensor, mat: Material, kind: str = "autograd",
                fd_eps: float = 2e-3, create_graph: bool = True) -> Tensor:
    """The configured residual: "autograd" (`pde_residual`) or "fd"
    (`pde_residual_fd`)."""
    if kind == "fd":
        return pde_residual_fd(phi, xy, mat, fd_eps=fd_eps)
    return pde_residual(phi, xy, mat, create_graph=create_graph)


def weighted_pde_loss(phi, xy: Tensor, mat: Material,
                      tip: tuple[float, float], *, weight_power: float,
                      residual: str = "autograd",
                      fd_eps: float = 2e-3) -> Tensor:
    """mean((w * r)^2) (:688-712)."""
    r = residual_of(phi, xy, mat, residual, fd_eps)
    w = tip_residual_weights(xy, tip, power=weight_power)
    return torch.mean((w * r) ** 2)


def boundary_loss(phi, bdata: dict[str, Tensor],
                  btargets: dict[str, Tensor]) -> tuple[Tensor, dict]:
    """Mean over labels of per-label Dirichlet MSE (:764-791); every
    label's points in one field call."""
    labels = list(bdata)
    if not labels:
        return torch.zeros(()), {}
    pred = phi(torch.cat([bdata[k] for k in labels]))
    terms, i = {}, 0
    for k in labels:
        n = bdata[k].shape[0]
        terms[k] = torch.mean((pred[i:i + n] - btargets[k]) ** 2)
        i += n
    return torch.mean(torch.stack(list(terms.values()))), terms


def gauge_loss(phi, *, device=None, dtype=torch.float32) -> Tensor:
    """phi(0,0)^2 — pins the potential's additive constant (:826-828);
    the origin as a [1, 2] batch on `device`."""
    return phi(torch.zeros(1, 2, dtype=dtype, device=device))[0] ** 2


def symmetry_loss(phi, pairs_a: Tensor, pairs_b: Tensor) -> Tensor:
    """Mirror symmetry about the tip line (:831-852); point pairs
    precomputed host-side, both sides in one field call."""
    n = pairs_a.shape[0]
    if n == 0:
        return torch.zeros((), dtype=pairs_a.dtype, device=pairs_a.device)
    v = phi(torch.cat([pairs_a, pairs_b]))
    return torch.mean((v[:n] - v[n:]) ** 2)


def tip_stress_loss(phi, tip_xy: Tensor, tip: tuple[float, float], *,
                    c: float = 0.25, s_eps: float = 1e-5,
                    r_weight_power: float = 0.5) -> Tensor:
    """Enforce the crack-tip amplitude tau_eq * sqrt(r) ~ c with
    1/r^pw weights (:715-736)."""
    if tip_xy.shape[0] == 0:
        return torch.zeros((), dtype=tip_xy.dtype, device=tip_xy.device)
    _, _, tau = stress(phi, tip_xy)
    r = torch.sqrt((tip_xy[:, 0] - tip[0]) ** 2
                   + (tip_xy[:, 1] - tip[1]) ** 2 + 1e-10)
    mism2 = (tau * torch.sqrt(r + s_eps) - c) ** 2
    if r_weight_power <= 0:
        return torch.mean(mism2)
    w = 1.0 / (r + s_eps) ** r_weight_power
    return torch.sum(w * mism2) / (torch.sum(w) + 1e-12)


def tip_ratio_loss(phi, near_xy: Tensor, far_xy: Tensor, *,
                   target: float = 1.2) -> tuple[Tensor, Tensor]:
    """Hinge on the near/far equivalent-stress ratio (:739-761); both
    probe lines in one gradient call."""
    n = near_xy.shape[0]
    _, _, t = stress(phi, torch.cat([near_xy, far_xy]))
    ratio = torch.mean(t[:n]) / (torch.mean(t[n:]) + 1e-8)
    return torch.relu(target - ratio) ** 2, ratio
