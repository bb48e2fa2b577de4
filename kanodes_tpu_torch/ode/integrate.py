"""Fixed-step explicit RK integration (port of the fixed-step part of
`kanodes_tpu/ode/integrate.py`, `rk_step` and `odeint_fixed`).

Plain torch ops, differentiated by autograd: exact reverse AD through
every stage (discretize-then-optimize), the reference the fused RK
kernels are held against. States are tensors `[..., d]`; `rhs(t, y,
args)`. The adaptive solvers and their adjoints wait (ROADMAP.md, M7).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

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
