"""The whole bounded adaptive solve over the 2-layer KDense chain as one
kernel: K4 with one step controller, K8 with one per packed-ensemble
member (port of `kanodes_tpu/ops/rk_adaptive_fused.py`).

`fused_adaptive_odeint` runs the entire controller loop of an FSAL
embedded pair (tsit5/dopri5/bs3) for a batch x0 [K, I] in ONE launch
(K4f): every iteration runs all stages, the Hairer error norm over all
K*I entries, the I/PI controller and the save-point clipping of
`ode/integrate._adaptive_step` (dense=False); accepted steps land
exactly on the save times `ts`, and rows never reached (max_steps ran
out) repeat the final state. Its backward (K4b) replays the recorded
accepted steps in reverse: the "direct" adjoint w.r.t. x0 and the chain
parameters. Step sizes are gradient constants (the error norm and the
initial dt are out of the graph), rejected steps are gradient-
transparent, and `ts` gets a hard-zero cotangent, as in the JAX kernel.
The kernels are hand-written CUDA (`csrc/rk_adaptive.cu`).

Dispatch: a CUDA tensor launches the kernel or raises; a CPU tensor runs
the plain PyTorch version of the same math (`_fwd_plain`, `_bwd_plain`).
The plain forward is also differentiable by autograd, which then gives
the same direct adjoint; it and the explicit plain backward are exported
for tests and `chip_smoke.py` as `fused_adaptive_odeint_reference` and
`fused_adaptive_odeint_bwd_reference`. The records the backward replays
(x_in and k1 of each accepted step, its signed dt, its save index or -1,
and stats = [n_accept, n_reject, n_iter, final save index]) stay on the
device: neither wrapper reads them on the host. The plain versions read
the controller's decisions on the host once per iteration. `LAUNCHES`
counts kernel launches.

`fused_adaptive_members_odeint` is the same solve for a packed ensemble
(`models/packed.py`): x0 [K, S*d] member-major, and every member runs its
own save-clipped controller (its own t, dt, save index, done flag and PI
memory, error norms over its own (K, d) block), the fused counterpart of
`ode/integrate.odeint_members`. The forward (K8f) records every active
iteration (x_in, k1, and per member the signed dt, accepted-and-
unfinished, the save row or -1); the backward (K8b) replays them in
reverse, rejected members passing their k1 cotangent through: every
iteration rebuilt at once with its stage Jacobians, then the recursion a
warp a row, then the parameter sums. The kernels are
`csrc/rk_adaptive_members.cu`; the chain is evaluated dense
over the packed width, so raw parameter cotangents are non-zero off the
member blocks unless the parameters are masked (`packed.apply_mask`).
Its plain versions are `fused_adaptive_members_odeint_reference` and
`fused_adaptive_members_odeint_bwd_reference`.

The controller's powers are written as exp/log, as the JAX kernel
writes them (`_ctrl_factor`); `ode/integrate.StepController.factor`
uses `**`, as its own counterparts (`odeint`, `odeint_members`) do.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from kanodes_tpu_torch.ode.integrate import StepController
from kanodes_tpu_torch.ode.tableaus import Tableau, get_tableau
from kanodes_tpu_torch.ops import _cuda
from kanodes_tpu_torch.ops.kdense_pallas import (ChainSpec, _chain_f,
                                                 _chain_vjp, grid_of)
from kanodes_tpu_torch.ops.rk_fused import _check_launch, check_bwd_precision


# kernel launches since the last reset_launch_counts(); each wrapper adds
# one where it launches its kernel, and nowhere else (K8b's one call of
# three launches, phases A, B and C, counts one)
LAUNCHES = {"fused_adaptive_odeint_fwd": 0, "fused_adaptive_odeint_bwd": 0,
            "fused_adaptive_members_odeint_fwd": 0,
            "fused_adaptive_members_odeint_bwd": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _validate(tab: Tableau) -> None:
    if tab.b_err is None or not tab.fsal:
        raise ValueError("fused adaptive path requires an FSAL tableau "
                         "with an embedded error estimate (tsit5/dopri5/"
                         "bs3)")


class _Consts:
    """Tableau, tolerances and controller of one fused adaptive solve, and
    the kernel's structs built from them (raw f32 coefficients: dt
    changes every iteration, so nothing is folded on the host)."""

    def __init__(self, spec: ChainSpec, solver: str, rtol: float,
                 atol: float, ctrl: StepController, dt0: float | None):
        self.tab = get_tableau(solver)
        _validate(self.tab)
        self.spec, self.rtol, self.atol = spec, rtol, atol
        self.ctrl, self.dt0 = ctrl, dt0
        self._structs = None

    def structs(self):
        """(ChainDims, AdaptTab, AdaptCtrl), built once, then reused."""
        if self._structs is None:
            tab, c = self.tab, self.ctrl
            t = _cuda.AdaptTab()
            t.stages = tab.stages
            for i, row in enumerate(tab.a):
                t.a[i][:len(row)] = row
            t.b[:tab.stages] = tab.b
            t.e[:tab.stages] = tab.b_err
            k = _cuda.AdaptCtrl(
                self.rtol, self.atol, c.safety, c.min_factor, c.max_factor,
                c.dt_min, -(c.icoeff + c.pcoeff) / tab.order,
                c.pcoeff / tab.order, int(c.pcoeff != 0.0),
                0.0 if self.dt0 is None else self.dt0,
                int(self.dt0 is not None), 1.0 / (tab.order + 1))
            self._structs = (_cuda.chain_dims(self.spec), t, k)
        return self._structs


@functools.lru_cache(maxsize=64)
def _consts(spec: ChainSpec, solver: str, rtol: float, atol: float,
            ctrl: StepController, dt0: float | None) -> _Consts:
    return _Consts(spec, solver, rtol, atol, ctrl, dt0)


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path; references for the kernels)
# ---------------------------------------------------------------------------

def _hairer_norm(diff, y0, y1, rtol, atol):
    """Mixed-tolerance RMS norm (integrate.error_norm, single-leaf)."""
    scale = atol + rtol * torch.maximum(torch.abs(y0), torch.abs(y1))
    r = diff / scale
    return torch.sqrt(torch.sum(r * r) / diff.numel())


def _ctrl_factor(ctrl: StepController, err_nrm, order: int, err_prev):
    """StepController.factor with pow spelled as exp/log, as the kernel
    computes it."""
    e = torch.clamp_min(err_nrm, 1e-12)
    fac = ctrl.safety * torch.exp(
        (-(ctrl.icoeff + ctrl.pcoeff) / order) * torch.log(e))
    if ctrl.pcoeff != 0.0:
        ep = torch.clamp_min(err_prev, 1e-12)
        fac = fac * torch.exp((ctrl.pcoeff / order) * torch.log(ep))
    return torch.clamp(fac, ctrl.min_factor, ctrl.max_factor)


def _stage_sweep(tab: Tableau, chain, x, dts, k1):
    """All stages from step input x with signed step dts and FSAL k1.

    Returns (ks, xs, y1s, y1): per-stage RHS values, stage inputs and
    layer-1 outputs (xs[0]/y1s[0] are None: stage 1 is the carried FSAL
    value, not a chain evaluation), and the step's result."""
    s = tab.stages
    ks = [k1] + [None] * (s - 1)
    xs = [None] * s
    y1s = [None] * s
    for i in range(1, s):
        xi = x
        for j in range(i):
            if tab.a[i][j] != 0.0:
                xi = xi + (dts * tab.a[i][j]) * ks[j]
        xs[i] = xi
        ks[i], y1s[i] = chain(xi)
    y1 = x
    for i in range(s):
        if tab.b[i] != 0.0:
            y1 = y1 + (dts * tab.b[i]) * ks[i]
    return ks, xs, y1s, y1


def _initial_dt_inkernel(chain_y, x0, f0, tdir, order, rtol, atol):
    """integrate.initial_dt, single-leaf form (the kernel's heuristic);
    the caller keeps it out of the graph."""
    def nrm(v):
        sc = atol + rtol * torch.abs(x0)
        r = v / sc
        return torch.sqrt(torch.sum(r * r) / v.numel())

    d0, d1 = nrm(x0), nrm(f0)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
    y1 = x0 + (tdir * h0) * f0
    f1 = chain_y(y1)
    d2 = nrm(f1 - f0) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(
        dmax <= 1e-15,
        torch.clamp_min(h0 * 1e-3, 1e-6),
        torch.exp((1.0 / (order + 1)) * torch.log(0.01 / dmax)))
    return torch.minimum(100.0 * h0, h1)


def _fwd_plain(k: _Consts, max_steps: int, x0, ts, params, grid):
    """The kernel's controller loop in torch ops. Returns (ys [T, K, I],
    records): ys is differentiable by autograd w.r.t. x0 and params (the
    direct adjoint); records = (rx, rk1 [n_acc, K, I], rdt [n_acc],
    rsx [n_acc] int32, stats [4] int32), detached."""
    tab, ctrl, spec = k.tab, k.ctrl, k.spec

    def chain(x):
        return _chain_f(x, *params, grid, spec)

    T = ts.shape[0]
    t0 = ts[0]
    tdir = torch.where(ts[T - 1] >= t0, 1.0, -1.0).to(x0.dtype)
    k1 = chain(x0)[0]
    if k.dt0 is None:
        with torch.no_grad():
            dt = _initial_dt_inkernel(lambda x: chain(x)[0], x0, k1, tdir,
                                      tab.order, k.rtol, k.atol)
    else:
        dt = torch.tensor(np.float32(k.dt0), dtype=x0.dtype,
                          device=x0.device)
    ys = [x0] + [None] * (T - 1)
    rx, rk1, rdt, rsx = [], [], [], []
    t, x, err_prev = t0, x0, torch.ones((), dtype=x0.dtype, device=x0.device)
    sidx, done = 1, T <= 1
    n_acc = n_rej = n_it = 0
    for _ in range(max_steps):
        if done:
            break
        t_save = ts[sidx]
        remaining = (t_save - t) * tdir
        hit = dt >= remaining
        dt_used = torch.where(hit, remaining, dt)
        dts = tdir * dt_used
        ks, _, _, y1 = _stage_sweep(tab, chain, x, dts, k1)
        err = None
        for i in range(tab.stages):
            if tab.b_err[i] != 0.0:
                term = (dts * tab.b_err[i]) * ks[i]
                err = term if err is None else err + term
        err_nrm = _hairer_norm(err.detach(), x.detach(), y1.detach(),
                               k.rtol, k.atol)
        accept = (err_nrm <= 1.0) | (dt_used <= ctrl.dt_min)
        fac = _ctrl_factor(ctrl, err_nrm, tab.order, err_prev)
        dt_next = torch.clamp_min(dt_used * fac, ctrl.dt_min)
        accept_h, hit_h = torch.stack([accept, hit]).tolist()
        if accept_h:
            rx.append(x.detach())
            rk1.append(k1.detach())
            rdt.append(dts.detach())
            rsx.append(sidx if hit_h else -1)
            t = t_save if hit_h else t + dts
            x, k1 = y1, ks[-1]
            err_prev = torch.clamp_min(err_nrm, 1e-12)
            if hit_h:
                ys[sidx] = y1
                sidx += 1
            n_acc += 1
        else:
            n_rej += 1
        dt = dt_next
        n_it += 1
        done = sidx >= T
    for i in range(sidx, T):      # unreached save rows: the final state
        ys[i] = x
    K, I = x0.shape
    dev = x0.device
    records = (
        torch.stack(rx) if rx else x0.new_zeros((0, K, I)),
        torch.stack(rk1) if rk1 else x0.new_zeros((0, K, I)),
        torch.stack(rdt) if rdt else x0.new_zeros((0,)),
        torch.tensor(rsx, dtype=torch.int32, device=dev),
        torch.tensor([n_acc, n_rej, n_it, sidx], dtype=torch.int32,
                     device=dev))
    return torch.stack(ys), records


def _bwd_plain(tab: Tableau, spec: ChainSpec, x0, params, grid, records,
               gys):
    """The accepted steps replayed in reverse (the kernel's recursion):
    (dx0, dc1, dw1, dc2, dw2) for the cotangents gys [T, K, I]."""
    rx, rk1, rdt, rsx, stats = records

    def chain(x):
        return _chain_f(x, *params, grid, spec)

    n_acc, _, _, sidx_final = stats.tolist()
    sxs = rsx[:n_acc].tolist()
    T = gys.shape[0]
    # cotangent of the final state from the unreached fill
    xbar = torch.zeros_like(x0)
    for i in range(max(sidx_final, 1), T):
        xbar = xbar + gys[i]
    k1bar = torch.zeros_like(x0)
    grads = [torch.zeros_like(p) for p in params]
    for s in range(n_acc - 1, -1, -1):
        dts = rdt[s]
        if sxs[s] >= 0:
            xbar = xbar + gys[sxs[s]]
        ks, xs, y1s, _ = _stage_sweep(tab, chain, rx[s], dts, rk1[s])
        kbar = [None] * tab.stages
        for i in range(tab.stages):
            if tab.b[i] != 0.0:
                kbar[i] = (dts * tab.b[i]) * xbar
        # FSAL carry-out: the next step's k1 was this step's last stage
        kbar[-1] = k1bar if kbar[-1] is None else kbar[-1] + k1bar
        xbar_new = xbar
        for i in range(tab.stages - 1, 0, -1):
            if kbar[i] is None:
                continue
            dxi, *dps = _chain_vjp(xs[i], y1s[i], *params, grid, spec,
                                   kbar[i])
            grads = [g + d for g, d in zip(grads, dps)]
            xbar_new = xbar_new + dxi
            for j in range(i):
                if tab.a[i][j] != 0.0:
                    contrib = (dts * tab.a[i][j]) * dxi
                    kbar[j] = contrib if kbar[j] is None \
                        else kbar[j] + contrib
        # stage 1 is the carried FSAL value: its cotangent goes back a step
        k1bar = kbar[0] if kbar[0] is not None else torch.zeros_like(k1bar)
        xbar = xbar_new
    # the very first k1 was f(x0): one chain VJP at the inputs
    _, y1 = chain(x0)
    dxk, *dps = _chain_vjp(x0, y1, *params, grid, spec, k1bar)
    grads = [g + d for g, d in zip(grads, dps)]
    return (xbar + dxk + gys[0], *grads)


def fused_adaptive_odeint_reference(spec: ChainSpec, solver: str,
                                    rtol: float, atol: float, max_steps: int,
                                    ctrl: StepController, dt0: float | None,
                                    x0, ts, c1, w1, c2, w2):
    """Plain PyTorch version of K4f: (ys, records); autograd through ys
    gives the direct adjoint."""
    k = _consts(spec, solver, rtol, atol, ctrl, dt0)
    return _fwd_plain(k, max_steps, x0, ts, (c1, w1, c2, w2),
                      grid_of(spec, x0))


def fused_adaptive_odeint_bwd_reference(spec: ChainSpec, solver: str,
                                        x0, c1, w1, c2, w2, records, gys):
    """Plain PyTorch version of K4b on the records of a forward (the
    kernel's or the plain version's): (dx0, dc1, dw1, dc2, dw2)."""
    tab = get_tableau(solver)
    _validate(tab)
    return _bwd_plain(tab, spec, x0, (c1, w1, c2, w2), grid_of(spec, x0),
                      records, gys)


# ---------------------------------------------------------------------------
# CUDA launch wrappers
# ---------------------------------------------------------------------------

def _check_rows(k: _Consts, x0, params) -> int:
    K = _check_launch(k.spec, x0, params, 0)
    if K > _cuda.MAX_ADAPT_ROWS:
        raise ValueError(f"the adaptive kernel runs one block of K rows; "
                         f"K={K} > {_cuda.MAX_ADAPT_ROWS}")
    return K


def _launch_fwd(k: _Consts, max_steps: int, x0, ts, params):
    K = _check_rows(k, x0, params)
    if ts.dim() != 1 or ts.shape[0] < 1:
        raise ValueError(f"ts must be [T] with T >= 1, got "
                         f"{tuple(ts.shape)}")
    _cuda.check_tensors(ts)
    T, I, dev = ts.shape[0], k.spec.in_dims, x0.device
    ys = torch.empty((T, K, I), dtype=torch.float32, device=dev)
    rx = torch.empty((max_steps, K, I), dtype=torch.float32, device=dev)
    rk1 = torch.empty_like(rx)
    rdt = torch.empty(max_steps, dtype=torch.float32, device=dev)
    rsx = torch.empty(max_steps, dtype=torch.int32, device=dev)
    stats = torch.empty(4, dtype=torch.int32, device=dev)
    dims, tab, ctrl = k.structs()
    plan = _cuda.adaptive_fwd_plan(k.spec, K, k.tab.stages)
    ptr = _cuda.ptr
    lib = _cuda.library()
    with torch.cuda.device(dev):
        err = lib.kc_adaptive_fwd(
            ptr(x0), ptr(ts), T, *map(ptr, params), ptr(ys), ptr(rx),
            ptr(rk1), ptr(rdt), ptr(rsx), ptr(stats), K, max_steps,
            plan.warps, ctypes.byref(dims), ctypes.byref(tab),
            ctypes.byref(ctrl), _cuda.stream())
    LAUNCHES["fused_adaptive_odeint_fwd"] += 1
    _cuda.check(err, "fused_adaptive_odeint_fwd")
    return ys, (rx, rk1, rdt, rsx, stats)


def _launch_bwd(k: _Consts, x0, params, records, gys):
    K = _check_rows(k, x0, params)
    rx, rk1, rdt, rsx, stats = records
    max_steps, I = rx.shape[0], k.spec.in_dims
    gys = gys.contiguous()
    if gys.dim() != 3 or tuple(gys.shape[1:]) != (K, I):
        raise ValueError(f"gys shape {tuple(gys.shape)} != [T, {K}, {I}]")
    if tuple(rx.shape) != (max_steps, K, I) or rk1.shape != rx.shape or \
            rdt.shape != (max_steps,) or rsx.shape != (max_steps,) or \
            rsx.dtype != torch.int32 or stats.dtype != torch.int32:
        raise ValueError("records do not come from the forward kernel")
    _cuda.check_tensors(gys, rx, rk1, rdt)
    dx0 = torch.empty_like(x0)
    grads = [torch.empty_like(p) for p in params]
    n_rec = (max_steps * (k.tab.stages - 1) + 1) * K
    scratch = torch.empty(n_rec * _cuda.rec_width(k.spec),
                          dtype=torch.float32, device=x0.device)
    plan = _cuda.warp_adjoint_plan(k.spec, K, k.tab.stages - 1, max_steps)
    dims, tab, _ = k.structs()
    ptr = _cuda.ptr
    lib = _cuda.library()
    with torch.cuda.device(x0.device):
        err = lib.kc_adaptive_bwd(
            ptr(x0), *map(ptr, params), ptr(rx), ptr(rk1), ptr(rdt),
            ptr(rsx), ptr(stats), ptr(gys), gys.shape[0], ptr(dx0),
            *map(ptr, grads), ptr(scratch), K, plan.warps, plan.chunk,
            ctypes.byref(dims), ctypes.byref(tab), _cuda.stream())
    LAUNCHES["fused_adaptive_odeint_bwd"] += 1
    _cuda.check(err, "fused_adaptive_odeint_bwd")
    return (dx0, *grads)


# ---------------------------------------------------------------------------
# public differentiable op
# ---------------------------------------------------------------------------

def _forward(k: _Consts, max_steps: int, x0, ts, params):
    if _cuda.on_cuda(x0, ts, *params):
        return _launch_fwd(k, max_steps, x0, ts, params)
    return _fwd_plain(k, max_steps, x0, ts, params, grid_of(k.spec, x0))


class _FusedAdaptive(torch.autograd.Function):
    @staticmethod
    def forward(ctx, k, max_steps, x0, ts, c1, w1, c2, w2):
        params = (c1, w1, c2, w2)
        ys, records = _forward(k, max_steps, x0, ts, params)
        ctx.k = k
        ctx.save_for_backward(x0, ts, *params, *records)
        return ys

    @staticmethod
    def backward(ctx, gys):
        x0, ts, c1, w1, c2, w2, *records = ctx.saved_tensors
        params, k = (c1, w1, c2, w2), ctx.k
        if _cuda.on_cuda(gys, x0, *params):
            grads = _launch_bwd(k, x0, params, records, gys)
        else:
            grads = _bwd_plain(k.tab, k.spec, x0, params,
                               grid_of(k.spec, x0), records, gys)
        dts = torch.zeros_like(ts) if ctx.needs_input_grad[3] else None
        return (None, None, grads[0], dts, *grads[1:])


def fused_adaptive_odeint(spec: ChainSpec, solver: str, rtol: float,
                          atol: float, max_steps: int, ctrl: StepController,
                          dt0: float | None, x0, ts, c1, w1, c2, w2,
                          bwd_precision: str = "highest"):
    """Whole bounded adaptive solve as ONE kernel (+ ONE for backward).

    x0: [K, I] batch of initial states; ts: [T] float32 save times on
    x0's device (save-clipped controller: accepted steps land exactly on
    save times). Returns ys [T, K, I] including the x0 row, with rows
    never reached (max_steps ran out) filled with the final state, as
    `ode/integrate.odeint(adjoint="direct")` returns them.

    Differentiable w.r.t. x0 and the chain params with the "direct"
    adjoint's gradients; the `ts` cotangent is hard zero. dt0=None uses
    the in-kernel initial-step heuristic (a gradient constant either
    way)."""
    check_bwd_precision(bwd_precision)
    if max_steps < 1:
        raise ValueError(f"max_steps must be >= 1, got {max_steps}")
    k = _consts(spec, solver, float(rtol), float(atol), ctrl,
                None if dt0 is None else float(dt0))
    return _FusedAdaptive.apply(k, int(max_steps), x0, ts, c1, w1, c2, w2)


@torch.no_grad()
def fused_adaptive_stats(spec: ChainSpec, solver: str, rtol: float,
                         atol: float, max_steps: int, ctrl: StepController,
                         dt0: float | None, x0, ts, c1, w1, c2, w2):
    """Run the forward only; returns (ys, stats) with n_accept, n_reject,
    n_iter (0-dim int32 tensors on x0's device, not read back) and
    success (all save times reached). Not differentiable."""
    if max_steps < 1:
        raise ValueError(f"max_steps must be >= 1, got {max_steps}")
    k = _consts(spec, solver, float(rtol), float(atol), ctrl,
                None if dt0 is None else float(dt0))
    ys, records = _forward(k, int(max_steps), x0, ts, (c1, w1, c2, w2))
    stats = records[4]
    return ys, {"n_accept": stats[0], "n_reject": stats[1],
                "n_iter": stats[2], "success": stats[3] >= ts.shape[0]}


# ---------------------------------------------------------------------------
# K8: one controller per packed member
# ---------------------------------------------------------------------------

def _validate_members(spec: ChainSpec, tab: Tableau, n_members: int) -> None:
    _validate(tab)
    if spec.in_dims != spec.out_dims:
        raise ValueError("adaptive solve needs a state-to-state chain")
    if n_members < 1 or spec.in_dims % n_members:
        raise ValueError(f"state dim {spec.in_dims} not divisible by "
                         f"n_members={n_members}")


def _member_norm_inkernel(v, S: int):
    """Per-member RMS [S] of v [K, S*d] over each member's (K, d) block."""
    r = v.reshape(v.shape[0], S, -1)
    return torch.sqrt(torch.sum(r * r, dim=(0, 2)) / (r.shape[0] * r.shape[2]))


def _initial_dt_members_inkernel(chain_y, x0, f0, tdir, order, rtol, atol,
                                 S: int):
    """integrate._initial_dt_members in the kernel's form (pow as
    exp/log); the caller keeps it out of the graph."""
    d = x0.shape[1] // S
    sc = atol + rtol * torch.abs(x0)
    d0 = _member_norm_inkernel(x0 / sc, S)
    d1 = _member_norm_inkernel(f0 / sc, S)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
    f1 = chain_y(x0 + (tdir * h0).repeat_interleave(d) * f0)
    d2 = _member_norm_inkernel((f1 - f0) / sc, S) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(
        dmax <= 1e-15,
        torch.clamp_min(h0 * 1e-3, 1e-6),
        torch.exp((1.0 / (order + 1)) * torch.log(0.01 / dmax)))
    return torch.minimum(100.0 * h0, h1)


def _members_fwd_plain(k: _Consts, S: int, max_steps: int, x0, ts, params,
                       grid):
    """K8f's controller loop in torch ops. Returns (ys [T, K, I],
    records): ys is differentiable by autograd w.r.t. x0 and params (the
    per-member direct adjoint); records = (rx, rk1 [n_it, K, I], rdt
    [n_it, S], racc, rsx [n_it, S] int32, mstats [4, S] int32, nit [1]
    int32), detached. Reads each iteration's decisions on the host."""
    tab, ctrl, spec = k.tab, k.ctrl, k.spec

    def chain(x):
        return _chain_f(x, *params, grid, spec)

    K, I = x0.shape
    d, dev = I // S, x0.device
    expand = lambda v: v.repeat_interleave(d)          # [S] -> [I]
    ts = ts.detach()
    T = ts.shape[0]
    t0 = ts[0]
    tdir = torch.where(ts[T - 1] >= t0, 1.0, -1.0).to(x0.dtype)
    k1 = chain(x0)[0]
    with torch.no_grad():
        if k.dt0 is None:
            dt = _initial_dt_members_inkernel(
                lambda x: chain(x)[0], x0.detach(), k1.detach(), tdir,
                tab.order, k.rtol, k.atol, S)
        else:
            dt = torch.full((S,), np.float32(k.dt0), dtype=x0.dtype,
                            device=dev)
        t = t0.expand(S).clone()
        err_prev = torch.ones(S, dtype=x0.dtype, device=dev)
    ys = [x0] + [torch.zeros_like(x0)] * (T - 1)
    sidx, done = [1] * S, [T <= 1] * S
    n_acc, n_rej, n_itv = [0] * S, [0] * S, [0] * S
    rx, rk1, rdt, racc, rsx = [], [], [], [], []
    x = x0
    for _ in range(max_steps):
        if all(done):
            break
        rows = [min(i, T - 1) for i in sidx]
        with torch.no_grad():
            t_save = ts[torch.tensor(rows, device=dev)]
            remaining = (t_save - t) * tdir
            hit = dt >= remaining
            dt_used = torch.where(hit, remaining, dt)
            dts = tdir * dt_used
        dts_e = expand(dts)
        ks, _, _, y1 = _stage_sweep(tab, chain, x, dts_e, k1)
        with torch.no_grad():
            err = None
            for i in range(tab.stages):
                if tab.b_err[i] != 0.0:
                    term = (dts_e * tab.b_err[i]) * ks[i]
                    err = term if err is None else err + term
            scale = k.atol + k.rtol * torch.maximum(torch.abs(x),
                                                    torch.abs(y1))
            err_nrm = _member_norm_inkernel(err / scale, S)
            accept = (err_nrm <= 1.0) | (dt_used <= ctrl.dt_min)
            fac = _ctrl_factor(ctrl, err_nrm, tab.order, err_prev)
            dt_next = torch.clamp_min(dt_used * fac, ctrl.dt_min)
            done_t = torch.tensor(done, device=dev)
            ok = accept & ~done_t
            saved = ok & hit
            ok_h, acc_h, saved_h = torch.stack([ok, accept, saved]).tolist()
            rx.append(x.detach())
            rk1.append(k1.detach())
            rdt.append(dts)
            racc.append(ok.to(torch.int32))
            rsx.append(torch.tensor([r if v else -1 for r, v in
                                     zip(rows, saved_h)], dtype=torch.int32,
                                    device=dev))
            t = torch.where(ok, torch.where(hit, t_save, t + dts), t)
            dt = torch.where(done_t, dt, dt_next)
            err_prev = torch.where(ok, torch.clamp_min(err_nrm, 1e-12),
                                   err_prev)
        ok_e = expand(ok)
        x = torch.where(ok_e, y1, x)
        k1 = torch.where(ok_e, ks[-1], k1)
        for row in sorted({r for r, v in zip(rows, saved_h) if v}):
            cm = expand(torch.tensor([v and r == row for r, v in
                                      zip(rows, saved_h)], device=dev))
            ys[row] = torch.where(cm, y1, ys[row])
        for s in range(S):
            n_acc[s] += ok_h[s]
            n_rej[s] += not acc_h[s] and not done[s]
            n_itv[s] += not done[s]
            sidx[s] += saved_h[s]
            done[s] = done[s] or sidx[s] >= T
    for i in range(1, T):      # rows a member never reached: its final state
        if any(v <= i for v in sidx):
            cm = expand(torch.tensor([v <= i for v in sidx], device=dev))
            ys[i] = torch.where(cm, x, ys[i])
    i32 = dict(dtype=torch.int32, device=dev)
    records = (
        torch.stack(rx) if rx else x0.new_zeros((0, K, I)),
        torch.stack(rk1) if rk1 else x0.new_zeros((0, K, I)),
        torch.stack(rdt) if rdt else x0.new_zeros((0, S)),
        torch.stack(racc) if racc else torch.zeros((0, S), **i32),
        torch.stack(rsx) if rsx else torch.zeros((0, S), **i32),
        torch.tensor([n_acc, n_rej, n_itv, sidx], **i32),
        torch.tensor([len(rx)], **i32))
    return torch.stack(ys), records


def _members_bwd_plain(tab: Tableau, spec: ChainSpec, S: int, x0, params,
                       grid, records, gys):
    """K8b's recursion: the recorded iterations replayed in reverse, (dx0,
    dc1, dw1, dc2, dw2) for the cotangents gys [T, K, I]."""
    rx, rk1, rdt, racc, rsx, mstats, nit = records

    def chain(x):
        return _chain_f(x, *params, grid, spec)

    d, dev = x0.shape[1] // S, x0.device
    expand = lambda v: v.repeat_interleave(d)
    T, n_it = gys.shape[0], int(nit[0])
    sidx_final = mstats[3].tolist()
    # the fill's cotangent: rows i >= member s's final save index
    xbar = torch.zeros_like(x0)
    for i in range(1, T):
        if any(v <= i for v in sidx_final):
            cm = expand(torch.tensor([v <= i for v in sidx_final],
                                     device=dev))
            xbar = torch.where(cm, xbar + gys[i], xbar)
    k1bar = torch.zeros_like(x0)
    grads = [torch.zeros_like(p) for p in params]
    rsx_h = rsx[:n_it].tolist()
    for it in range(n_it - 1, -1, -1):
        for row in sorted({r for r in rsx_h[it] if r >= 0}):
            cm = expand(torch.tensor([r == row for r in rsx_h[it]],
                                     device=dev))
            xbar = torch.where(cm, xbar + gys[row], xbar)
        dts_e = expand(rdt[it])
        acc_e = expand(racc[it].to(x0.dtype))
        ks, xs, y1s, _ = _stage_sweep(tab, chain, rx[it], dts_e, rk1[it])
        xbar_m = xbar * acc_e
        kbar = [None] * tab.stages
        for i in range(tab.stages):
            if tab.b[i] != 0.0:
                kbar[i] = (dts_e * tab.b[i]) * xbar_m
        # FSAL carry-out, accepted members only
        fsal = k1bar * acc_e
        kbar[-1] = fsal if kbar[-1] is None else kbar[-1] + fsal
        xbar_new = xbar          # the identity path, accepted and rejected
        for i in range(tab.stages - 1, 0, -1):
            if kbar[i] is None:
                continue
            dxi, *dps = _chain_vjp(xs[i], y1s[i], *params, grid, spec,
                                   kbar[i])
            grads = [g + dp for g, dp in zip(grads, dps)]
            xbar_new = xbar_new + dxi
            for j in range(i):
                if tab.a[i][j] != 0.0:
                    contrib = (dts_e * tab.a[i][j]) * dxi
                    kbar[j] = contrib if kbar[j] is None \
                        else kbar[j] + contrib
        # stage 1 is the carried k1; rejected members pass theirs through
        k1bar = k1bar * (1.0 - acc_e)
        if kbar[0] is not None:
            k1bar = k1bar + kbar[0]
        xbar = xbar_new
    # the very first k1 was f(x0): one chain VJP at the inputs
    _, y1 = chain(x0)
    dxk, *dps = _chain_vjp(x0, y1, *params, grid, spec, k1bar)
    grads = [g + dp for g, dp in zip(grads, dps)]
    return (xbar + dxk + gys[0], *grads)


def fused_adaptive_members_odeint_reference(
        spec: ChainSpec, solver: str, rtol: float, atol: float,
        max_steps: int, ctrl: StepController, dt0: float | None,
        n_members: int, x0, ts, c1, w1, c2, w2):
    """Plain PyTorch version of K8f: (ys, records); autograd through ys
    gives the per-member direct adjoint."""
    k = _consts(spec, solver, rtol, atol, ctrl, dt0)
    _validate_members(spec, k.tab, n_members)
    return _members_fwd_plain(k, n_members, max_steps, x0, ts,
                              (c1, w1, c2, w2), grid_of(spec, x0))


def fused_adaptive_members_odeint_bwd_reference(spec: ChainSpec, solver: str,
                                                n_members: int, x0, c1, w1,
                                                c2, w2, records, gys):
    """Plain PyTorch version of K8b on the records of a forward (the
    kernel's or the plain version's): (dx0, dc1, dw1, dc2, dw2)."""
    tab = get_tableau(solver)
    _validate_members(spec, tab, n_members)
    return _members_bwd_plain(tab, spec, n_members, x0, (c1, w1, c2, w2),
                              grid_of(spec, x0), records, gys)


def _check_members(k: _Consts, S: int, x0, params) -> int:
    """Validate a K8 launch (shapes, float32, contiguity, caps); K."""
    I, H, G = k.spec.in_dims, k.spec.hidden, k.spec.grid_len
    if x0.dim() != 2 or x0.shape[1] != I or x0.shape[0] < 1:
        raise ValueError(f"x0 shape {tuple(x0.shape)} != [K, {I}]")
    want = ((I * G, H), (I, H), (H * G, I), (H, I))
    for name, p, shape in zip(("c1", "w1", "c2", "w2"), params, want):
        if tuple(p.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(p.shape)} != {shape}")
    _cuda.check_tensors(x0, *params)
    K = x0.shape[0]
    _cuda.check_members_caps(k.spec, k.tab.stages, K)
    return K


def _launch_members_fwd(k: _Consts, S: int, max_steps: int, x0, ts, params):
    K = _check_members(k, S, x0, params)
    if ts.dim() != 1 or ts.shape[0] < 1:
        raise ValueError(f"ts must be [T] with T >= 1, got "
                         f"{tuple(ts.shape)}")
    _cuda.check_tensors(ts)
    T, I, dev = ts.shape[0], k.spec.in_dims, x0.device
    f32, i32 = dict(dtype=torch.float32, device=dev), \
        dict(dtype=torch.int32, device=dev)
    ys = torch.empty((T, K, I), **f32)
    rx = torch.empty((max_steps, K, I), **f32)
    rk1 = torch.empty_like(rx)
    rdt = torch.empty((max_steps, S), **f32)
    racc = torch.empty((max_steps, S), **i32)
    rsx = torch.empty((max_steps, S), **i32)
    mstats = torch.empty((4, S), **i32)
    nit = torch.empty(1, **i32)
    dims, tab, ctrl = k.structs()
    ptr = _cuda.ptr
    lib = _cuda.library()
    with torch.cuda.device(dev):
        err = lib.mb_adaptive_fwd(
            ptr(x0), ptr(ts), T, *map(ptr, params), ptr(ys), ptr(rx),
            ptr(rk1), ptr(rdt), ptr(racc), ptr(rsx), ptr(mstats), ptr(nit),
            K, S, max_steps, ctypes.byref(dims), ctypes.byref(tab),
            ctypes.byref(ctrl), _cuda.stream())
    LAUNCHES["fused_adaptive_members_odeint_fwd"] += 1
    _cuda.check(err, "fused_adaptive_members_odeint_fwd")
    return ys, (rx, rk1, rdt, racc, rsx, mstats, nit)


def _launch_members_bwd(k: _Consts, S: int, x0, params, records, gys):
    K = _check_members(k, S, x0, params)
    rx, rk1, rdt, racc, rsx, mstats, nit = records
    max_steps, I = rx.shape[0], k.spec.in_dims
    gys = gys.contiguous()
    if gys.dim() != 3 or tuple(gys.shape[1:]) != (K, I):
        raise ValueError(f"gys shape {tuple(gys.shape)} != [T, {K}, {I}]")
    ints = (racc, rsx, mstats, nit)
    if tuple(rx.shape) != (max_steps, K, I) or rk1.shape != rx.shape or \
            tuple(rdt.shape) != (max_steps, S) or \
            racc.shape != rdt.shape or rsx.shape != rdt.shape or \
            tuple(mstats.shape) != (4, S) or \
            any(t.dtype != torch.int32 for t in ints):
        raise ValueError("records do not come from the forward kernel")
    _cuda.check_tensors(gys, rx, rk1, rdt)
    dx0 = torch.empty_like(x0)
    grads = [torch.empty_like(p) for p in params]
    plan = _cuda.members_bwd_plan(k.spec, K, k.tab.stages, max_steps)
    scratch = torch.empty(plan.scratch_floats, dtype=torch.float32,
                          device=x0.device)
    dims, tab, _ = k.structs()
    ptr = _cuda.ptr
    lib = _cuda.library()
    with torch.cuda.device(x0.device):
        err = lib.mb_adaptive_bwd(
            ptr(x0), *map(ptr, params), ptr(rx), ptr(rk1), ptr(rdt),
            ptr(racc), ptr(rsx), ptr(mstats), ptr(nit), ptr(gys),
            gys.shape[0], ptr(dx0), *map(ptr, grads), ptr(scratch), K, S,
            max_steps, ctypes.byref(dims), ctypes.byref(tab),
            _cuda.stream())
    LAUNCHES["fused_adaptive_members_odeint_bwd"] += 1
    _cuda.check(err, "fused_adaptive_members_odeint_bwd")
    return (dx0, *grads)


def _members_forward(k: _Consts, S: int, max_steps: int, x0, ts, params):
    if _cuda.on_cuda(x0, ts, *params):
        return _launch_members_fwd(k, S, max_steps, x0, ts, params)
    return _members_fwd_plain(k, S, max_steps, x0, ts, params,
                              grid_of(k.spec, x0))


class _FusedAdaptiveMembers(torch.autograd.Function):
    @staticmethod
    def forward(ctx, k, S, max_steps, x0, ts, c1, w1, c2, w2):
        params = (c1, w1, c2, w2)
        ys, records = _members_forward(k, S, max_steps, x0, ts, params)
        ctx.k, ctx.S = k, S
        ctx.save_for_backward(x0, ts, *params, *records)
        return ys

    @staticmethod
    def backward(ctx, gys):
        x0, ts, c1, w1, c2, w2, *records = ctx.saved_tensors
        params, k, S = (c1, w1, c2, w2), ctx.k, ctx.S
        if _cuda.on_cuda(gys, x0, *params):
            grads = _launch_members_bwd(k, S, x0, params, records, gys)
        else:
            grads = _members_bwd_plain(k.tab, k.spec, S, x0, params,
                                       grid_of(k.spec, x0), records, gys)
        dts = torch.zeros_like(ts) if ctx.needs_input_grad[4] else None
        return (None, None, None, grads[0], dts, *grads[1:])


def _members_consts(spec, solver, rtol, atol, max_steps, ctrl, dt0,
                    n_members) -> _Consts:
    if max_steps < 1:
        raise ValueError(f"max_steps must be >= 1, got {max_steps}")
    k = _consts(spec, solver, float(rtol), float(atol), ctrl,
                None if dt0 is None else float(dt0))
    _validate_members(spec, k.tab, int(n_members))
    return k


def fused_adaptive_members_odeint(spec: ChainSpec, solver: str, rtol: float,
                                  atol: float, max_steps: int,
                                  ctrl: StepController, dt0: float | None,
                                  n_members: int, x0, ts, c1, w1, c2, w2,
                                  bwd_precision: str = "highest"):
    """The per-member bounded adaptive solve as ONE kernel (+ one call of
    three for backward), the fused counterpart of
    `ode/integrate.odeint_members`.

    x0: [K, S*d] member-major packed batch (`models/packed.py`); ts: [T]
    float32 save times on x0's device. Each member runs its own
    save-clipped I/PI controller. Returns ys [T, K, S*d] including the
    x0 row; rows a member never reached hold its final state.

    Differentiable w.r.t. x0 and the chain params with each member's
    direct-adjoint gradients; the `ts` cotangent is hard zero. The chain
    is evaluated dense: train block-diagonal params through
    `packed.apply_mask`, which zeroes the off-block cotangents."""
    check_bwd_precision(bwd_precision)
    k = _members_consts(spec, solver, rtol, atol, max_steps, ctrl, dt0,
                        n_members)
    return _FusedAdaptiveMembers.apply(k, int(n_members), int(max_steps),
                                       x0, ts, c1, w1, c2, w2)


@torch.no_grad()
def fused_adaptive_members_stats(spec: ChainSpec, solver: str, rtol: float,
                                 atol: float, max_steps: int,
                                 ctrl: StepController, dt0: float | None,
                                 n_members: int, x0, ts, c1, w1, c2, w2):
    """Run the forward only; returns (ys, stats) with per-member [S]
    n_accept, n_reject, n_iter (int32 tensors on x0's device, not read
    back) and success (all save times reached). Not differentiable."""
    k = _members_consts(spec, solver, rtol, atol, max_steps, ctrl, dt0,
                        n_members)
    ys, records = _members_forward(k, int(n_members), int(max_steps), x0,
                                   ts, (c1, w1, c2, w2))
    m = records[5]
    return ys, {"n_accept": m[0], "n_reject": m[1], "n_iter": m[2],
                "success": m[3] >= ts.shape[0]}
