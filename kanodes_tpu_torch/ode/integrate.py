"""Explicit RK integration (port of `kanodes_tpu/ode/integrate.py`):
fixed-step (`rk_step`, `odeint_fixed`) and adaptive (`odeint` with the
"none", "direct" and "direct_remat" adjoints).

Plain torch ops, differentiated by autograd: exact reverse AD through
every stage (discretize-then-optimize), the reference the fused RK
kernels are held against. States are tensors `[..., d]`; `rhs(t, y,
args)`.

The adaptive controller (`_adaptive_step`) keeps its scalars (t, dt,
the PI memory) as 0-dim float32 tensors computed as the JAX package
computes them, and reads its accept/save decisions on the host once
per iteration: a Python loop that stops when every save time is
reached. JAX's "direct" scans all `max_steps` iterations instead, and
the ones after `done` are identities, so the result and the gradients
are the same. The error norm and the initial dt are out of the graph
(`lax.stop_gradient` in the JAX package); gradients reach y0, args and
`ts` through the save-clipped stepper. The interpolating and backsolve
adjoints, `odeint_adjoint` and `odeint_members` wait (ROADMAP.md, M7).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch
import torch.utils.checkpoint

from kanodes_tpu_torch.ode.tableaus import Tableau, get_tableau

Tensor = torch.Tensor


def _weighted_sum(coeffs, ks):
    """sum_i coeffs[i] * ks[i], skipping zero coefficients, in order."""
    acc = None
    for c, k in zip(coeffs, ks):
        if c == 0.0:
            continue
        term = c * k
        acc = term if acc is None else acc + term
    return torch.zeros_like(ks[0]) if acc is None else acc


def rk_step(tab: Tableau, f: Callable, t, y: Tensor, dt, args, k1=None):
    """One explicit RK step. Returns (y1, err, k_last): `err` is the
    embedded error estimate (None without one), `k_last` is f(t+dt, y1)
    for FSAL tableaus."""
    ks = [k1 if k1 is not None else f(t, y, args)]
    for i in range(1, tab.stages):
        yi = y + dt * _weighted_sum(tab.a[i], ks)
        ks.append(f(t + tab.c[i] * dt, yi, args))
    y1 = y + dt * _weighted_sum(tab.b, ks)
    err = None
    if tab.b_err is not None:
        err = dt * _weighted_sum(tab.b_err, ks)
    k_last = ks[-1] if tab.fsal else None
    return y1, err, k_last


def odeint_fixed(f: Callable, y0: Tensor, ts, args=None, *,
                 solver: str | Tableau = "tsit5",
                 substeps: int = 1) -> Tensor:
    """Integrate on the save grid `ts` with `substeps` equal RK steps per
    interval; returns [T, ...] including y0. Step sizes are computed in
    float32 on the host, as the JAX scan computes them from float32 `ts`."""
    tab = get_tableau(solver)
    if isinstance(ts, Tensor):
        ts = ts.detach().cpu().numpy()
    ts = np.asarray(ts, dtype=np.float32)
    ys = [y0]
    y = y0
    for t0, t1 in zip(ts[:-1], ts[1:]):
        h = np.float32((t1 - t0) / np.float32(substeps))
        for i in range(substeps):
            t = float(t0 + np.float32(i) * h)
            y, _, _ = rk_step(tab, f, t, y, float(h), args)
        ys.append(y)
    return torch.stack(ys, dim=0)


# ---------------------------------------------------------------------------
# adaptive step controller
# ---------------------------------------------------------------------------

def error_norm(err: Tensor, y0: Tensor, y1: Tensor, rtol, atol) -> Tensor:
    """Hairer mixed-tolerance RMS norm of the local error estimate."""
    scale = atol + rtol * torch.maximum(torch.abs(y0), torch.abs(y1))
    return torch.sqrt(torch.sum((err / scale) ** 2) / err.numel())


@dataclasses.dataclass(frozen=True)
class StepController:
    """Proportional-integral step-size controller (Hairer-Wanner IV.2).

    dt_next = dt * clip(safety * err^(-(icoeff+pcoeff)/order)
                               * err_prev^(pcoeff/order))

    The default (pcoeff=0) is the classic I-controller; `pi()` gives the
    recommended PI pair for explicit embedded RK (err_prev is the error
    norm of the last ACCEPTED step).
    """
    safety: float = 0.9
    min_factor: float = 0.2
    max_factor: float = 10.0
    dt_min: float = 1e-10
    pcoeff: float = 0.0       # proportional gain (0 -> pure I control)
    icoeff: float = 1.0       # integral gain

    @classmethod
    def pi(cls, **kw) -> "StepController":
        """Recommended PI pair for explicit RK (beta1=0.7/k, beta2=0.4/k)."""
        kw.setdefault("pcoeff", 0.4)
        kw.setdefault("icoeff", 0.3)
        return cls(**kw)

    def factor(self, err_nrm: Tensor, order: int,
               err_prev: Tensor | None = None) -> Tensor:
        # guard err == 0 -> max growth
        e = torch.clamp_min(err_nrm, 1e-12)
        fac = self.safety * e ** (-(self.icoeff + self.pcoeff) / order)
        if self.pcoeff != 0.0 and err_prev is not None:
            fac = fac * torch.clamp_min(err_prev, 1e-12) ** (
                self.pcoeff / order)
        return torch.clamp(fac, self.min_factor, self.max_factor)


def initial_dt(f: Callable, t0, y0: Tensor, args, order: int, rtol, atol,
               tdir) -> Tensor:
    """Hairer-Wanner starting step heuristic (simplified)."""
    f0 = f(t0, y0, args)

    def nrm(v):
        sc = atol + rtol * torch.abs(y0)
        return torch.sqrt(torch.sum((v / sc) ** 2) / v.numel())

    d0, d1 = nrm(y0), nrm(f0)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
    y1 = y0 + (tdir * h0) * f0
    f1 = f(t0 + tdir * h0, y1, args)
    d2 = nrm(f1 - f0) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(dmax <= 1e-15, torch.clamp_min(h0 * 1e-3, 1e-6),
                     (0.01 / dmax) ** (1.0 / (order + 1)))
    return torch.minimum(100.0 * h0, h1)


# ---------------------------------------------------------------------------
# adaptive integration
# ---------------------------------------------------------------------------

def _hermite(t0, t1, y0, y1, f0, f1, t_eval):
    """Cubic Hermite interpolation on [t0, t1] (3rd-order dense output;
    f0/f1 are the RHS values at the endpoints, free via FSAL)."""
    h = t1 - t0
    s = (t_eval - t0) / h
    h00 = (1 + 2 * s) * (1 - s) ** 2
    h10 = s * (1 - s) ** 2
    h01 = s * s * (3 - 2 * s)
    h11 = s * s * (s - 1)
    return h00 * y0 + h10 * h * f0 + h01 * y1 + h11 * h * f1


def _adaptive_step(tab: Tableau, f: Callable, args, rtol, atol,
                   ctrl: StepController, ts: Tensor, state: dict,
                   dense: bool = False) -> dict:
    """One controller iteration of an unfinished solve; returns the new
    state and leaves `state` as it was (so a checkpointed step can be
    run again).

    dense=False: clip steps so accepted steps land exactly on save times
    (exact save values; reverse-differentiable).
    dense=True: take natural controller steps and fill save points inside
    each accepted step by cubic Hermite interpolation (fewer steps; for
    forward passes that are not differentiated).
    """
    t, y, dt, k1 = state["t"], state["y"], state["dt"], state["k1"]
    save_idx, tdir = state["save_idx"], state["tdir"]
    T = ts.shape[0]

    t_save = ts[save_idx]
    remaining = (t_save - t) * tdir                    # > 0 while not done
    hit = dt >= remaining
    if dense:
        # never step beyond the final save time
        dt_used = torch.minimum(dt, (ts[T - 1] - t) * tdir)
    else:
        dt_used = torch.where(hit, remaining, dt)

    y1, err, k_last = rk_step(tab, f, t, y, tdir * dt_used, args, k1=k1)
    err_nrm = error_norm(err.detach(), y.detach(), y1.detach(), rtol, atol)
    accept = (err_nrm <= 1.0) | (dt_used <= ctrl.dt_min)
    fac = ctrl.factor(err_nrm, tab.order, state["err_prev"])
    dt_next = torch.clamp_min(dt_used * fac, ctrl.dt_min)
    accept, hit = torch.stack([accept, hit]).tolist()   # one host read

    new = dict(state, dt=dt_next, n_iter=state["n_iter"] + 1)
    if not accept:
        new["n_reject"] = state["n_reject"] + 1
        return new
    t1_ = t + tdir * dt_used
    ys = list(state["ys"])
    if dense:
        new["t"] = t1_
        # fill every save time inside (t, t1] by Hermite interpolation
        while save_idx < T and bool((ts[save_idx] - t1_) * tdir <= 1e-6):
            ys[save_idx] = _hermite(t, t1_, y, y1, k1, k_last, ts[save_idx])
            save_idx += 1
    else:
        new["t"] = t_save if hit else t1_
        if hit:
            ys[save_idx] = y1
            save_idx += 1
    new.update(y=y1, k1=k_last, ys=ys, save_idx=save_idx,
               done=save_idx >= T, n_accept=state["n_accept"] + 1,
               # PI memory: error norm of the last ACCEPTED step
               err_prev=torch.clamp_min(err_nrm, 1e-12))
    return new


def _init_state(tab: Tableau, f: Callable, y0: Tensor, ts: Tensor, args,
                rtol, atol, dt0) -> dict:
    t0 = ts[0]
    tdir = torch.sign(ts[-1] - ts[0])
    if dt0 is None:
        # step-size selection must NOT be differentiated: d(solution)/
        # d(step size) is an error-level quantity with error-level
        # conditioning (the JAX package's stop_gradient)
        with torch.no_grad():
            dt = initial_dt(f, t0, y0, args, tab.order, rtol, atol, tdir)
    else:
        dt = torch.tensor(dt0, dtype=ts.dtype, device=ts.device)
    k1 = f(t0, y0, args)
    T = ts.shape[0]
    return {
        "t": t0, "y": y0, "dt": dt, "k1": k1,
        "save_idx": 1, "ys": [y0] + [None] * (T - 1),
        "done": T <= 1, "tdir": tdir,
        "err_prev": torch.ones((), dtype=ts.dtype, device=ts.device),
        "n_accept": 0, "n_reject": 0, "n_iter": 0,
    }


def _adaptive_loop(tab: Tableau, f: Callable, y0, ts, args, rtol, atol, dt0,
                   max_steps: int, ctrl: StepController, dense: bool = False,
                   remat: bool = False) -> dict:
    state = _init_state(tab, f, y0, ts, args, rtol, atol, dt0)
    step = functools.partial(_adaptive_step, tab, f, args, rtol, atol, ctrl,
                             ts, dense=dense)
    for _ in range(max_steps):
        if state["done"]:
            break
        if remat:
            # checkpointed direct adjoint: each controller step's stages
            # are recomputed in the backward pass instead of stored
            state = torch.utils.checkpoint.checkpoint(step, state,
                                                      use_reentrant=False)
        else:
            state = step(state)
    return state


def _fill_unreached(state: dict) -> Tensor:
    """ys with the save rows the bounded solve never reached (max_steps
    ran out) set to the last integrated state, stacked [T, ...]."""
    return torch.stack([state["y"] if v is None else v
                        for v in state["ys"]])


@dataclasses.dataclass
class SolveStats:
    n_accept: Any
    n_reject: Any
    n_iter: Any
    success: Any


def odeint(f: Callable, y0: Tensor, ts, args=None, *,
           solver: str | Tableau = "tsit5",
           rtol: float = 1e-3, atol: float = 1e-6,
           dt0: float | None = None, max_steps: int = 4096,
           adjoint: str = "backsolve",
           controller: StepController = StepController(),
           return_stats: bool = False,
           dense: bool = False):
    """Adaptive ODE solve at save times `ts` (torchdiffeq-compatible
    shape): [T, ...] including y0.

    adjoint:
      "direct"        exact reverse AD through the save-clipped adaptive
                      loop (autograd records every stage);
      "direct_remat"  the same gradients, each controller step recomputed
                      in the backward pass (torch.utils.checkpoint);
      "none"          no gradients (runs under torch.no_grad); with
                      dense=True, Hermite-filled save points;
      "interpolating", "backsolve": not ported yet (ROADMAP.md, M7).

    The loop stops when every save time is reached or after `max_steps`
    iterations; rows never reached hold the last state (`return_stats`
    -> stats.success says whether all were). Stats are Python ints.
    """
    tab = get_tableau(solver)
    if tab.b_err is None:
        raise ValueError(f"solver {tab.name!r} has no embedded error "
                         "estimate; use odeint_fixed")
    if not tab.fsal:
        raise ValueError("adaptive path requires an FSAL tableau "
                         "(tsit5/dopri5/bs3)")
    ts = torch.as_tensor(ts, dtype=y0.dtype, device=y0.device)
    if dense and adjoint in ("direct", "interpolating"):
        raise ValueError("dense output is not reverse-differentiable; "
                         "use adjoint='none' or 'backsolve'")
    if adjoint in ("interpolating", "backsolve"):
        raise NotImplementedError(
            f"odeint(adjoint={adjoint!r}) is not ported yet (ROADMAP.md, "
            f"M7 {adjoint} adjoint); use 'direct' or 'direct_remat'")
    if adjoint == "none":
        with torch.no_grad():
            st = _adaptive_loop(tab, f, y0, ts, args, rtol, atol, dt0,
                                max_steps, controller, dense=dense)
    elif adjoint in ("direct", "direct_remat"):
        st = _adaptive_loop(tab, f, y0, ts, args, rtol, atol, dt0,
                            max_steps, controller,
                            remat=adjoint == "direct_remat")
    else:
        raise ValueError(f"unknown adjoint {adjoint!r}")
    ys = _fill_unreached(st)
    if return_stats:
        return ys, SolveStats(st["n_accept"], st["n_reject"], st["n_iter"],
                              st["done"])
    return ys


def odeint_adjoint(f, y0, ts, args=None, adjoint_params=None, **kw):
    """torchdiffeq `odeint_adjoint` equivalent: not ported yet."""
    raise NotImplementedError("odeint_adjoint is not ported yet "
                              "(ROADMAP.md, M7 backsolve adjoint)")


def odeint_members(f, y0, ts, args=None, **kw):
    """One step controller per packed-ensemble member: not ported yet."""
    raise NotImplementedError("odeint_members is not ported yet "
                              "(ROADMAP.md, M11 odeint_members)")
