"""Implicit (stiff-capable) integration: ESDIRK with controlled Newton
(port of `kanodes_tpu/ode/stiff.py`).

The reference generates stiff truth data with Rosenbrock23 / Rodas5
(`Allen-Cahn_Surrogate.jl:63`, `Schrodinger_Surrogate.jl:69`); the
primary data path is host-side fine-step RK4 in float64 (`pde/datagen.py`),
and Kvaerno3, a 4-stage, 3rd-order, stiffly accurate L-stable ESDIRK
pair, is the independent cross-check. Each stage solves its implicit
equation by modified Newton on a dense Jacobian (`torch.func.jacfwd`),
factored once (`torch.linalg.lu_factor_ex`) and applied by `lu_solve`; JAX
computes these outside any Pallas kernel, and so does the port.

As in JAX:
  * Newton iterations carry a convergence mask: once the relative update
    norm drops below `newton_tol` further sweeps are no-ops, so the fixed
    number of sweeps stays differentiable; the stage equation's residual
    is checked at the end and the flag returned;
  * the step returns Kvaerno's embedded 2nd-order error estimate;
  * `odeint_implicit(..., adaptive=True)` is a PI-controlled loop with
    save-point clipping, steps sized by the embedded error and halved on
    a Newton failure; here a host loop (two host reads a step), not
    differentiated: on the CPU a Newton sweep's host read lets it stop at
    convergence, on the card a step is one CUDA graph of every (masked)
    sweep, the same values; the fixed grid is differentiable by
    autograd.

Everything runs in the dtype and on the device of the state: float64
tensors give a float64 solve.
"""

from __future__ import annotations

import torch

from kanodes_tpu_torch.ode.integrate import StepController, error_norm

Tensor = torch.Tensor

# Kvaerno (2004) 3/2 ESDIRK tableau; gamma = 0.4358665215084590.
# Stiffly accurate: b == A[3]; the 3rd stage (c=1) is the embedded
# 2nd-order solution, so b_err = b - A[2] (padded with -gamma at i=3).
_G = 0.4358665215084590
KV3_A = (
    (0.0,),
    (_G, _G),
    (0.490563388419108, 0.073570090080892, _G),
    (0.308809969973036, 1.490563388254106, -1.235239879727145, _G),
)
KV3_B = (0.308809969973036, 1.490563388254106, -1.235239879727145, _G)
KV3_B_ERR = tuple(b - a for b, a in zip(KV3_B, KV3_A[2] + (0.0,)))
KV3_C = (0.0, 2 * _G, 1.0, 1.0)
KV3_ORDER = 3


def _newton_solve(f, t, y0: Tensor, rhs_const: Tensor, gamma_dt,
                  newton_iters: int, newton_tol: float, stop_early: bool):
    """Solve y = rhs_const + gamma_dt f(t, y) by modified Newton (one
    Jacobian and LU a stage, at the predictor `y0`); returns (y,
    converged). Sweeps after the relative update norm drops below the
    tolerance are masked no-ops, so `newton_iters` bounds the work and
    the solve stays differentiable. With `stop_early` those no-ops are
    skipped, the mask read on the host after each sweep: the same
    result."""
    n = y0.shape[0]
    # in y0's dtype: forward mode can promote a 0-d component's tangent
    # to float64 (a Python scalar times a 0-d tensor)
    J = torch.func.jacfwd(lambda v: f(t, v))(y0).to(y0.dtype)   # [N, N]
    A = torch.eye(n, dtype=y0.dtype, device=y0.device) - gamma_dt * J
    LU, piv, _ = torch.linalg.lu_factor_ex(A)    # no host sync on `info`
    # the requested tol cannot undercut the dtype's resolution
    tol = max(newton_tol, 100.0 * float(torch.finfo(y0.dtype).eps))
    y = y0
    settled = torch.zeros((), dtype=torch.bool, device=y0.device)
    for _ in range(newton_iters):
        g = y - rhs_const - gamma_dt * f(t, y)
        dy = torch.linalg.lu_solve(LU, piv, g[:, None])[:, 0]
        y_new = torch.where(settled, y, y - dy)
        rel = torch.linalg.norm(dy) / (torch.linalg.norm(y_new) + 1e-300)
        y, settled = y_new, settled | (rel < tol)
        if stop_early and bool(settled):
            break
    # a small update under a frozen (possibly huge) Jacobian does not
    # imply a small residual: check the stage equation itself
    fy = f(t, y)
    g = y - rhs_const - gamma_dt * fy
    scale = (torch.linalg.norm(y) + torch.linalg.norm(rhs_const)
             + abs(gamma_dt) * torch.linalg.norm(fy) + 1e-300)
    converged = settled & (torch.linalg.norm(g) <= 10.0 * tol * scale)
    return y, converged


def kvaerno3_step(f, t, y: Tensor, dt, args, newton_iters: int = 8,
                  newton_tol: float = 1e-9):
    """One Kvaerno3 ESDIRK step of a flat state; returns (y1, err,
    converged): the 3rd-order solution, the embedded 2nd-order error
    estimate, and whether every stage's Newton solve converged. With
    grad off the Newton sweeps stop once settled."""
    return _kvaerno3_step(f, t, y, dt, args, newton_iters, newton_tol,
                          not torch.is_grad_enabled())


def _kvaerno3_step(f, t, y: Tensor, dt, args, newton_iters: int,
                   newton_tol: float, stop_early: bool):
    def fa(ti, yi):
        return f(ti, yi, args)

    k = [None] * 4
    k[0] = fa(t, y)
    converged = torch.ones((), dtype=torch.bool, device=y.device)
    for i in (1, 2, 3):
        # stage equation: yi = y + dt sum_{j<i} a_ij k_j + dt gamma f(ti, yi)
        acc = y
        for j in range(i):
            if KV3_A[i][j] != 0.0:
                acc = acc + dt * KV3_A[i][j] * k[j]
        ti = t + KV3_C[i] * dt
        yi, conv_i = _newton_solve(fa, ti, acc, acc, dt * _G, newton_iters,
                                   newton_tol, stop_early)
        converged = converged & conv_i
        k[i] = fa(ti, yi)
    y1 = y
    err = torch.zeros_like(y)
    for i in range(4):
        if KV3_B[i] != 0.0:
            y1 = y1 + dt * KV3_B[i] * k[i]
        if KV3_B_ERR[i] != 0.0:
            err = err + dt * KV3_B_ERR[i] * k[i]
    return y1, err, converged


def _graphed_step(f, y: Tensor, args, newton_iters: int,
                  newton_tol: float):
    """A Kvaerno3 step on the card as one CUDA graph, replayed each
    iteration of the adaptive loop: step(t, y, dt) -> (y1, err,
    converged). The graph runs every Newton sweep, masked once settled,
    which gives the early-stopping loop's values bit for bit; a step's
    ~1500 small launches (three `jacfwd`s, LUs and sweeps) then cost one
    replay and no host read. The LU runs on cuSOLVER (capturable), set
    for the warm-up and the capture only."""
    t_s = torch.zeros((), dtype=y.dtype, device=y.device)
    dt_s = torch.zeros_like(t_s)
    y_s = y.clone()

    def body():
        return _kvaerno3_step(f, t_s, y_s, dt_s, args, newton_iters,
                              newton_tol, stop_early=False)

    backend = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        # warm-up off the capture: library handles and workspaces
        side = torch.cuda.Stream(y.device)
        side.wait_stream(torch.cuda.current_stream(y.device))
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream(y.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = body()
    finally:
        torch.backends.cuda.preferred_linalg_library(backend)

    def step(t, y, dt):
        t_s.copy_(t)
        y_s.copy_(y)
        dt_s.copy_(dt)
        graph.replay()
        return tuple(o.clone() for o in out)
    return step


@torch.no_grad()
def _implicit_adaptive(f, y0: Tensor, ts: Tensor, args, rtol, atol,
                       newton_iters, newton_tol, max_steps,
                       ctrl: StepController) -> dict:
    """JAX's PI-controlled adaptive Kvaerno3 while_loop over the save grid
    `ts` (forward time), accepted steps clipped onto save points, as a
    host loop: the same arithmetic on the device, its two branch
    decisions read on the host each step."""
    T = ts.shape[0]
    ys = torch.zeros((T,) + tuple(y0.shape), dtype=y0.dtype,
                     device=y0.device)
    ys[0] = y0
    t, y, dt = ts[0], y0, ts[1] - ts[0]
    err_prev = torch.ones((), dtype=y0.dtype, device=y0.device)
    save_idx, n_iter, n_reject = 1, 0, 0
    done = T <= 1
    step = (_graphed_step(f, y0, args, newton_iters, newton_tol)
            if y0.is_cuda and not done else None)
    while not done and n_iter < max_steps:
        t_save = ts[min(save_idx, T - 1)]
        remaining = t_save - t
        hit = bool(dt >= remaining)
        dt_used = remaining if hit else dt
        if step is None:
            y1, err, conv = _kvaerno3_step(f, t, y, dt_used, args,
                                           newton_iters, newton_tol, True)
        else:
            y1, err, conv = step(t, y, dt_used)
        enrm = error_norm(err, y, y1, rtol, atol)
        conv_ok, err_ok, at_min = torch.stack(
            [conv, enrm <= 1.0, dt_used <= ctrl.dt_min]).tolist()
        # Newton failure: halve; otherwise the controller's factor
        fac = ctrl.factor(enrm, KV3_ORDER, err_prev) if conv_ok else 0.5
        dt_next = torch.clamp_min(dt_used * fac, ctrl.dt_min)
        if (err_ok and conv_ok) or at_min:
            t = t_save if hit else t + dt_used
            y = y1
            err_prev = torch.clamp_min(enrm, 1e-12)
            if hit:
                ys[save_idx] = y1
                save_idx += 1
        else:
            n_reject += 1
        dt = dt_next
        done = save_idx >= T
        n_iter += 1
    return {"ys": ys, "n_iter": n_iter, "n_reject": n_reject,
            "success": done}


def odeint_implicit(f, y0: Tensor, ts, args=None, *, substeps: int = 1,
                    newton_iters: int = 8, newton_tol: float = 1e-9,
                    adaptive: bool = False, rtol: float = 1e-6,
                    atol: float = 1e-9, max_steps: int = 100_000,
                    controller: StepController = StepController(),
                    return_stats: bool = False):
    """Stiff ESDIRK solve of a flat state at save times `ts` (a tensor on
    y0's device, or anything `torch.as_tensor` takes, in y0's dtype).

    adaptive=False: a fixed grid, `substeps` Kvaerno3 steps a save
    interval, differentiable by autograd (the training-capable path).
    adaptive=True: embedded-error step control with Newton-failure
    halving (truth generation and validation; not differentiated), stats
    {"n_iter", "n_reject", "success"} as Python values. On the card a
    step is one CUDA graph, so `f` must not read the device from the
    host."""
    ts = torch.as_tensor(ts, dtype=y0.dtype, device=y0.device)
    if adaptive:
        st = _implicit_adaptive(f, y0, ts, args, rtol, atol, newton_iters,
                                newton_tol, max_steps, controller)
        if return_stats:
            return st["ys"], {k: st[k] for k in ("n_iter", "n_reject",
                                                 "success")}
        return st["ys"]
    y, out = y0, [y0]
    for t0, t1 in zip(ts[:-1], ts[1:]):
        h = (t1 - t0) / substeps
        for i in range(substeps):
            y, _, _ = kvaerno3_step(f, t0 + i * h, y, h, args, newton_iters,
                                    newton_tol)
        out.append(y)
    ys = torch.stack(out, dim=0)
    if return_stats:
        return ys, {"success": True}
    return ys
