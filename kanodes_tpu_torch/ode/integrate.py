"""Explicit RK integration (port of `kanodes_tpu/ode/integrate.py`):
fixed-step (`rk_step`, `odeint_fixed`) and adaptive (`odeint` with the
"none", "direct", "direct_remat", "interpolating" and "backsolve"
adjoints, and `odeint_adjoint`).

Plain torch ops, differentiated by autograd: exact reverse AD through
every stage (discretize-then-optimize), the reference the fused RK
kernels are held against. `rhs(t, y, args)`; a state is a tensor
`[..., d]` or a tuple (or list) of such states, as the JAX package's
pytrees: the stepper works leaf by leaf, and the error norm sums every
leaf's squares in leaf order over the total size.

The adaptive controller (`_adaptive_step`) keeps its scalars (t, dt,
the PI memory) as 0-dim float32 tensors computed as the JAX package
computes them, and reads its accept/save decisions on the host once
per iteration: a Python loop that stops when every save time is
reached. JAX's "direct" scans all `max_steps` iterations instead, and
the ones after `done` are identities, so the result and the gradients
are the same. The error norm and the initial dt are out of the graph
(`lax.stop_gradient` in the JAX package); gradients reach y0, args and
`ts` through the save-clipped stepper. `odeint_members` gives every
member of a packed ensemble its own controller, the same way.

The continuous adjoints ("interpolating", "backsolve") are each one
`torch.autograd.Function` over y0, `ts` and the tensors of `args` (a
module's parameters, a tensor or a tuple of tensors), as JAX's
`custom_vjp`s: the forward is the "none" loop, and the backward
integrates the adjoint ODE a' = -a df/dy, taking each VJP of `rhs` with
`torch.autograd.grad` (so a right-hand side whose kernel has its own
autograd Function, K1's `kan_chain_apply`, runs that kernel's backward
there). They give `ts` the continuous boundary terms.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from kanodes_tpu_torch.ode.tableaus import Tableau, get_tableau

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# state trees: a tensor, or tuples / lists of trees (JAX's pytrees)
# ---------------------------------------------------------------------------

def _tmap(f, *trees):
    """f leaf by leaf over trees of one structure."""
    t = trees[0]
    if isinstance(t, (tuple, list)):
        return type(t)(_tmap(f, *xs) for xs in zip(*trees))
    return f(*trees)


def _leaves(tree) -> list:
    """The tree's leaves in order (JAX's `tree_leaves`)."""
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _rebuild(like, leaves):
    """A tree of `like`'s structure holding `leaves` (an iterator)."""
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(t, leaves) for t in like)
    return next(leaves)


def _vdot(a, b) -> Tensor:
    """sum over leaves of <a, b>, leaf by leaf in order."""
    tot = None
    for x, y in zip(_leaves(a), _leaves(b)):
        s = torch.sum(x * y)
        tot = s if tot is None else tot + s
    return tot


def _weighted_sum(coeffs, ks):
    """sum_i coeffs[i] * ks[i], skipping zero coefficients, in order."""
    acc = None
    for c, k in zip(coeffs, ks):
        if c == 0.0:
            continue
        term = _tmap(lambda x: c * x, k)
        acc = term if acc is None else _tmap(torch.add, acc, term)
    return _tmap(torch.zeros_like, ks[0]) if acc is None else acc


def rk_step(tab: Tableau, f: Callable, t, y, dt, args, k1=None):
    """One explicit RK step. Returns (y1, err, k_last): `err` is the
    embedded error estimate (None without one), `k_last` is f(t+dt, y1)
    for FSAL tableaus."""
    ks = [k1 if k1 is not None else f(t, y, args)]
    for i in range(1, tab.stages):
        yi = _tmap(lambda base, inc: base + dt * inc, y,
                   _weighted_sum(tab.a[i], ks))
        ks.append(f(t + tab.c[i] * dt, yi, args))
    y1 = _tmap(lambda base, inc: base + dt * inc, y, _weighted_sum(tab.b, ks))
    err = None
    if tab.b_err is not None:
        err = _tmap(lambda e: dt * e, _weighted_sum(tab.b_err, ks))
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

def error_norm(err, y0, y1, rtol, atol) -> Tensor:
    """Hairer mixed-tolerance RMS norm of the local error estimate: the
    squares summed leaf by leaf in leaf order, over the total size."""
    sq, n = None, 0
    for e, a, b in zip(_leaves(err), _leaves(y0), _leaves(y1)):
        scale = atol + rtol * torch.maximum(torch.abs(a), torch.abs(b))
        s = torch.sum((e / scale) ** 2)
        sq = s if sq is None else sq + s
        n += e.numel()
    return torch.sqrt(sq / n)


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


def initial_dt(f: Callable, t0, y0, args, order: int, rtol, atol,
               tdir) -> Tensor:
    """Hairer-Wanner starting step heuristic (simplified)."""
    f0 = f(t0, y0, args)

    def nrm(v):
        sq, n = None, 0
        for leaf, yref in zip(_leaves(v), _leaves(y0)):
            sc = atol + rtol * torch.abs(yref)
            s = torch.sum((leaf / sc) ** 2)
            sq = s if sq is None else sq + s
            n += leaf.numel()
        return torch.sqrt(sq / n)

    d0, d1 = nrm(y0), nrm(f0)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
    y1 = _tmap(lambda a, b: a + (tdir * h0) * b, y0, f0)
    f1 = f(t0 + tdir * h0, y1, args)
    d2 = nrm(_tmap(torch.sub, f1, f0)) / h0
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
    return _tmap(lambda a, b, fa, fb: h00 * a + h10 * h * fa + h01 * b
                 + h11 * h * fb, y0, y1, f0, f1)


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
    err_nrm = error_norm(*(_tmap(Tensor.detach, v) for v in (err, y, y1)),
                         rtol, atol)
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


def _init_state(tab: Tableau, f: Callable, y0, ts: Tensor, args,
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
                   remat: bool = False, record: list | None = None) -> dict:
    """The controller loop until every save time is reached or
    `max_steps` iterations ran. `record`: a list that gets, for every
    accepted step, its Hermite data (t0, t1, y0, y1, f0, f1) and the save
    index it ended on (-1 if none), as JAX's `_adaptive_while_record`."""
    state = _init_state(tab, f, y0, ts, args, rtol, atol, dt0)
    step = functools.partial(_adaptive_step, tab, f, args, rtol, atol, ctrl,
                             ts, dense=dense)
    for _ in range(max_steps):
        if state["done"]:
            break
        if remat:
            # checkpointed direct adjoint: each controller step's stages
            # are recomputed in the backward pass instead of stored
            new = torch.utils.checkpoint.checkpoint(step, state,
                                                    use_reentrant=False)
        else:
            new = step(state)
        if record is not None and new["n_accept"] > state["n_accept"]:
            saved = new["save_idx"] > state["save_idx"]
            record.append((state["t"], new["t"], state["y"], new["y"],
                           state["k1"], new["k1"],
                           state["save_idx"] if saved else -1))
        state = new
    return state


def _fill_unreached(state: dict, zeros: bool = False):
    """ys stacked [T, ...] leaf by leaf, the save rows the bounded solve
    never reached (max_steps ran out) set to the last integrated state,
    or to zeros (backsolve's, as JAX's)."""
    fill = _tmap(torch.zeros_like, state["y"]) if zeros else state["y"]
    return _tmap(lambda *vs: torch.stack(vs),
                 *[fill if v is None else v for v in state["ys"]])


@dataclasses.dataclass
class SolveStats:
    n_accept: Any
    n_reject: Any
    n_iter: Any
    success: Any


def _adaptive_tableau(solver) -> Tableau:
    tab = get_tableau(solver)
    if tab.b_err is None:
        raise ValueError(f"solver {tab.name!r} has no embedded error "
                         "estimate; use odeint_fixed")
    if not tab.fsal:
        raise ValueError("adaptive path requires an FSAL tableau "
                         "(tsit5/dopri5/bs3)")
    return tab


def odeint(f: Callable, y0, ts, args=None, *,
           solver: str | Tableau = "tsit5",
           rtol: float = 1e-3, atol: float = 1e-6,
           dt0: float | None = None, max_steps: int = 4096,
           adjoint: str = "backsolve",
           controller: StepController = StepController(),
           return_stats: bool = False,
           dense: bool = False):
    """Adaptive ODE solve at save times `ts` (torchdiffeq-compatible
    shape): [T, ...] including y0 (a tree of them for a tree state).

    adjoint:
      "direct"        exact reverse AD through the save-clipped adaptive
                      loop (autograd records every stage);
      "direct_remat"  the same gradients, each controller step recomputed
                      in the backward pass (torch.utils.checkpoint);
      "interpolating" the forward is the "none" loop (its values bit for
                      bit), recording each accepted step's Hermite data;
                      the backward integrates the adjoint ODE over every
                      recorded step in reverse, 2 fixed steps of the
                      same tableau a step, y(t) from the Hermite
                      interpolant (stable where backsolve diverges);
      "backsolve"     continuous adjoint: the forward is the "none" loop
                      with `dt0` ignored (as JAX), the backward one
                      adaptive solve of (y, a_y, a_args) back over every
                      save interval (O(1) memory);
      "none"          no gradients (runs under torch.no_grad); with
                      dense=True, Hermite-filled save points.

    The loop stops when every save time is reached or after `max_steps`
    iterations; rows never reached hold the last state (`return_stats`
    -> stats.success says whether all were), except under backsolve,
    whose unreached rows are zeros as in JAX. Stats are Python ints.
    "backsolve" and "interpolating" give `ts` the continuous boundary
    terms dL/dt_i = g_i . f(t_i, y_i) (i >= 1) and dL/dt_0 = -a(t_0) .
    f(t_0, y_0).
    """
    tab = _adaptive_tableau(solver)
    like = _leaves(y0)[0]
    ts = torch.as_tensor(ts, dtype=like.dtype, device=like.device)
    if dense and adjoint in ("direct", "interpolating"):
        raise ValueError("dense output is not reverse-differentiable; "
                         "use adjoint='none' or 'backsolve'")
    if adjoint in ("interpolating", "backsolve"):
        return _continuous(adjoint, f, tab, y0, ts, args, rtol, atol, dt0,
                           max_steps, controller, return_stats, dense)
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


def odeint_adjoint(f, y0, ts, args=None, adjoint_params=None, *,
                   solver: str | Tableau = "tsit5",
                   rtol: float = 1e-3, atol: float = 1e-6,
                   dt0: float | None = None, max_steps: int = 4096,
                   controller: StepController = StepController(),
                   return_stats: bool = False, dense: bool = False):
    """torchdiffeq `odeint_adjoint` equivalent: `odeint` with the
    backsolve adjoint.

    `adjoint_params` mirrors torchdiffeq's parameter-subset selection
    (`predator_prey_adjoint.py:132-142`) as a prefix tree of bools over
    `args`: one bool for all of it; for a module, a dict from parameter
    or submodule names (`named_parameters` / `named_modules` names) to
    bools, names it does not cover kept; for a tuple of tensors, a tuple
    of such trees. Tensors marked False get exactly-zero cotangents, as
    JAX's `stop_gradient` outside its custom_vjp gives them: the backward
    still solves for their cotangents (they count in the augmented
    state's error norm, so the kept ones take the unmasked solve's steps
    and equal its values) and then drops them.
    """
    tab = _adaptive_tableau(solver)
    like = _leaves(y0)[0]
    ts = torch.as_tensor(ts, dtype=like.dtype, device=like.device)
    return _continuous("backsolve", f, tab, y0, ts, args, rtol, atol, dt0,
                       max_steps, controller, return_stats, dense,
                       adjoint_params)


# ---------------------------------------------------------------------------
# the continuous adjoints: one autograd.Function each way
# ---------------------------------------------------------------------------

def _continuous(kind, f, tab, y0, ts, args, rtol, atol, dt0, max_steps,
                ctrl, return_stats, dense, mask=None):
    """odeint through the "interpolating" or "backsolve" adjoint; `mask`
    is `odeint_adjoint`'s."""
    if return_stats:
        raise ValueError(f"return_stats unsupported with {kind}")
    prob = _Adjoint(kind, f, tab, args, y0, rtol, atol,
                    # backsolve's forward ignores dt0, as JAX's
                    dt0 if kind == "interpolating" else None,
                    max_steps, ctrl, dense, mask)
    out = _AdjointSolve.apply(prob, ts, *_leaves(y0), *prob.params)
    return _rebuild(y0, iter(out))


def _arg_tensors(args) -> list[Tensor]:
    """The tensors of `args` in the JAX package's leaf order: a module's
    parameters (`named_parameters`: per KDense layer C, W, then
    grid_offset and log_h; per B-spline layer base_w, coeff, grid,
    scaler: JAX's sorted dict keys; a parameter that does not require
    grad, as the B-spline knot grid, included), a tensor, or the leaves
    of a tuple of tensors; None has none."""
    if args is None:
        return []
    if isinstance(args, nn.Module):
        return [p for _, p in args.named_parameters()]
    leaves = _leaves(args)
    if not all(isinstance(v, Tensor) for v in leaves):
        raise TypeError("args must be a module, a tensor, a tuple of "
                        "tensors or None")
    return leaves


def _kept(args, params: list[Tensor], mask) -> list[bool]:
    """`adjoint_params` as one bool a tensor of `_arg_tensors(args)`."""
    if mask is None:
        return [True] * len(params)
    if isinstance(mask, bool):
        return [mask] * len(params)
    if isinstance(args, nn.Module) and isinstance(mask, dict):
        names = [n for n, _ in args.named_parameters()]
        modules = {n for n, _ in args.named_modules()}
        unknown = set(mask) - set(names) - modules
        if unknown:
            raise ValueError(f"adjoint_params names no parameter or "
                             f"submodule: {sorted(unknown)}")
        out = []
        for n in names:
            # the longest covering entry decides (a parameter over its
            # module, a submodule over its parent)
            hits = [k for k in mask if k == n or n.startswith(k + ".")
                    or k == ""]
            out.append(bool(mask[max(hits, key=len)]) if hits else True)
        return out
    if isinstance(args, (tuple, list)) and isinstance(mask, (tuple, list)) \
            and len(args) == len(mask):
        return [k for a, m in zip(args, mask)
                for k in _kept(a, _leaves(a), m)]
    raise ValueError(f"adjoint_params {mask!r} does not match args' "
                     f"structure")


class _Adjoint:
    """One continuous-adjoint solve: the right-hand side, its args, which
    of their tensors the backward differentiates (every tensor of tuple
    args; a module's parameters that require grad) and which of those
    the mask keeps, the solver settings, and what the forward leaves for
    the backward."""

    def __init__(self, kind, f, tab, args, y0, rtol, atol, dt0, max_steps,
                 ctrl, dense, mask):
        self.kind, self.f, self.tab, self.args = kind, f, tab, args
        self.y_like, self.n_y = y0, len(_leaves(y0))
        self.rtol, self.atol, self.dt0 = rtol, atol, dt0
        self.max_steps, self.ctrl, self.dense = max_steps, ctrl, dense
        self.params = _arg_tensors(args)
        module = isinstance(args, nn.Module)
        self.diff = [p.requires_grad or not module for p in self.params]
        self.kept = _kept(args, self.params, mask)
        self.record = None

    def __call__(self, t, y):
        """f(t, y, args), out of the graph."""
        with torch.no_grad():
            return self.f(t, y, self.args)

    def vjp(self, t, y, a_y):
        """(f(t, y), a_y . df/dy, a_y . df/dargs), out of the graph; the
        tensors not differentiated (a module's parameters that do not
        require grad) and unused ones get zeros."""
        with torch.enable_grad():
            y_ = _tmap(lambda v: v.detach().requires_grad_(), y)
            if isinstance(self.args, nn.Module) or self.args is None:
                out = self.f(t, y_, self.args)
                wrt = [p for p, d in zip(self.params, self.diff) if d]
            else:
                subs = [p.detach().requires_grad_() for p in self.params]
                out = self.f(t, y_, _rebuild(self.args, iter(subs)))
                wrt = [p for p, d in zip(subs, self.diff) if d]
            wrt = _leaves(y_) + wrt
            pairs = [(o, g) for o, g in zip(_leaves(out), _leaves(a_y))
                     if o.requires_grad]
            grads = (torch.autograd.grad([o for o, _ in pairs], wrt,
                                         [g for _, g in pairs],
                                         allow_unused=True)
                     if pairs else [None] * len(wrt))
        grads = [torch.zeros_like(w) if g is None else g
                 for g, w in zip(grads, wrt)]
        it = iter(grads[self.n_y:])
        args_bar = tuple(next(it) if d else torch.zeros_like(p)
                         for p, d in zip(self.params, self.diff))
        return (_tmap(Tensor.detach, out),
                _rebuild(y, iter(grads[:self.n_y])), args_bar)

    def forward(self, y0, ts):
        """The "none" loop; the interpolating adjoint records its
        accepted steps. Backsolve leaves unreached rows zero (JAX's
        `_odeint_backsolve` returns its while loop's buffer unfilled)."""
        rec = [] if self.kind == "interpolating" else None
        st = _adaptive_loop(self.tab, self.f, y0, ts, self.args, self.rtol,
                            self.atol, self.dt0, self.max_steps, self.ctrl,
                            dense=self.dense, record=rec)
        if rec is None:
            return _fill_unreached(st, zeros=True)
        self.record, self.save_idx = rec, st["save_idx"]
        return _fill_unreached(st)

    def zero_args(self) -> tuple:
        """JAX's `zeros_like(args)`: a cotangent for every tensor of the
        args, the ones not differentiated included (they stay zero, and
        count in backsolve's augmented error norm, as in JAX)."""
        return tuple(torch.zeros_like(p) for p in self.params)

    def backsolve(self, ts, ys, ys_bar):
        """JAX `_backsolve_bwd`: one adaptive solve of the augmented
        state (y, a_y, a_args) from ts[i] back to ts[i-1] per save
        interval, under the forward's tolerances, max_steps and
        controller; returns (a_y, ts_bar, a_args)."""
        T = ts.shape[0]

        def aug_dyn(t, aug, _):
            y, a_y, _a = aug
            f_val, y_bar, args_bar = self.vjp(t, y, a_y)
            return f_val, _tmap(torch.neg, y_bar), _tmap(torch.neg, args_bar)

        def row(tree, i):
            return _tmap(lambda b: b[i], tree)

        a_y = _tmap(torch.zeros_like, row(ys, 0))
        a_args = self.zero_args()
        ts_bar = torch.zeros_like(ts)
        for idx in range(T - 1, 0, -1):
            y_i, g_i = row(ys, idx), row(ys_bar, idx)
            # save-time boundary term dL/dt_i = g_i . f(t_i, y_i): moving
            # the measurement time slides the readout along the
            # trajectory (torchdiffeq's time_vjps)
            ts_bar[idx] = _vdot(g_i, self(ts[idx], y_i))
            a_y = _tmap(torch.add, a_y, g_i)
            st = _adaptive_loop(self.tab, aug_dyn, (y_i, a_y, a_args),
                                torch.stack([ts[idx], ts[idx - 1]]), None,
                                self.rtol, self.atol, None, self.max_steps,
                                self.ctrl)
            end = st["ys"][1]
            if end is None:     # unreached: JAX's zero-initialised row
                end = _tmap(torch.zeros_like, st["y"])
            _, a_y, a_args = end
        # initial-time term dL/dt_0 = -a(t_0) . f(t_0, y_0), with the
        # adjoint BEFORE the g_0 injection
        ts_bar[0] = -_vdot(a_y, self(ts[0], row(ys, 0)))
        return _tmap(torch.add, a_y, row(ys_bar, 0)), ts_bar, a_args

    def interpolating(self, ts, ys, ys_bar, bwd_substeps: int = 2):
        """JAX `_interp_bwd`: the adjoint ODE over every recorded step in
        reverse, `bwd_substeps` fixed steps of the same tableau a step,
        y(t) from the step's Hermite interpolant; each save's cotangent
        enters at the step that ended on it. Rows past the last save
        reached repeat the final state (`_fill_unreached`), so their
        cotangents start the adjoint."""
        T = ts.shape[0]
        unreached = torch.arange(T, device=ts.device) >= self.save_idx
        a_y = _tmap(lambda b: torch.where(
            unreached.reshape((T,) + (1,) * (b.dim() - 1)), b,
            torch.zeros_like(b)).sum(0), ys_bar)
        a_args = self.zero_args()
        ts_bar = torch.zeros_like(ts)
        for t0, t1, y0v, y1v, f0, f1, sidx in reversed(self.record):
            if sidx >= 0:
                g = _tmap(lambda b: b[sidx], ys_bar)
                a_y = _tmap(torch.add, a_y, g)
                # the save-clipped forward ends the step on the save
                # time, so f1 = f(t_i, y_i)
                ts_bar[sidx] += _vdot(g, f1)

            def aug_dyn(t, a, _, t0=t0, t1=t1, y0v=y0v, y1v=y1v, f0=f0,
                        f1=f1):
                y_t = _hermite(t0, t1, y0v, y1v, f0, f1, t)
                _, y_bar, args_bar = self.vjp(t, y_t, a[0])
                return _tmap(torch.neg, y_bar), _tmap(torch.neg, args_bar)

            h = (t0 - t1) / bwd_substeps
            a = (a_y, a_args)
            for k in range(bwd_substeps):
                a, _, _ = rk_step(self.tab, aug_dyn, t1 + k * h, a, h, None)
            a_y, a_args = a
        if self.record:
            # dL/dt_0 = -a(t_0) . f(t_0, y_0), before the g_0 injection
            ts_bar[0] += -_vdot(a_y, self.record[0][4])
        a_y = _tmap(torch.add, a_y, _tmap(lambda b: b[0], ys_bar))
        return a_y, ts_bar, a_args


class _AdjointSolve(torch.autograd.Function):
    """odeint(adjoint="interpolating" | "backsolve") as one Function of
    (ts, y0's leaves, args' tensors): JAX's `_odeint_interp` /
    `_odeint_backsolve` custom_vjp."""

    @staticmethod
    def forward(ctx, prob, ts, *tensors):
        y0 = _rebuild(prob.y_like, iter(tensors[:prob.n_y]))
        ys = tuple(_leaves(prob.forward(y0, ts)))
        ctx.prob = prob
        ctx.save_for_backward(ts, *ys)
        return ys

    @staticmethod
    def backward(ctx, *ys_bar):
        prob = ctx.prob
        ts, *ys = ctx.saved_tensors
        ys = _rebuild(prob.y_like, iter(ys))
        ys_bar = _rebuild(prob.y_like, iter(ys_bar))
        with torch.no_grad():
            if prob.kind == "backsolve":
                a_y, ts_bar, a_args = prob.backsolve(ts, ys, ys_bar)
            else:
                a_y, ts_bar, a_args = prob.interpolating(ts, ys, ys_bar)
        # masked tensors: the solved cotangent dropped (JAX's
        # stop_gradient outside the custom_vjp)
        grads = [g if d and k else torch.zeros_like(p) for g, d, k, p in
                 zip(a_args, prob.diff, prob.kept, prob.params)]
        return (None, ts_bar, *_leaves(a_y), *grads)


# ---------------------------------------------------------------------------
# per-member adaptive integration for packed ensembles
# ---------------------------------------------------------------------------

def _member_norm(err: Tensor, y0: Tensor, y1: Tensor, rtol, atol,
                 n_members: int) -> Tensor:
    """Member-blocked Hairer norm: the last axis is member-major [S*d];
    one error norm per member [S] over its block, batch axes included."""
    scale = atol + rtol * torch.maximum(torch.abs(y0), torch.abs(y1))
    r = (err / scale).reshape(*y0.shape[:-1], n_members, -1)
    return torch.sqrt(torch.mean(r * r, dim=tuple(range(r.dim() - 2))
                                 + (r.dim() - 1,)))


def _initial_dt_members(f: Callable, t0, y0: Tensor, args, order: int, rtol,
                        atol, tdir, n_members: int) -> Tensor:
    """`initial_dt` with every norm over the member's own block, so each
    member starts where its own solve would."""
    d = y0.shape[-1] // n_members
    f0 = f(t0, y0, args)

    def nrm(v):
        r = (v / (atol + rtol * torch.abs(y0))).reshape(
            *y0.shape[:-1], n_members, d)
        return torch.sqrt(torch.mean(r * r, dim=tuple(range(r.dim() - 2))
                                     + (r.dim() - 1,)))

    d0, d1 = nrm(y0), nrm(f0)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
    y1 = y0 + (tdir * h0).repeat_interleave(d) * f0
    f1 = f(t0 + tdir * h0, y1, args)
    d2 = nrm(f1 - f0) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(dmax <= 1e-15, torch.clamp_min(h0 * 1e-3, 1e-6),
                     (0.01 / dmax) ** (1.0 / (order + 1)))
    return torch.minimum(100.0 * h0, h1)


def odeint_members(f: Callable, y0: Tensor, ts, args=None, *,
                   n_members: int, solver: str | Tableau = "tsit5",
                   rtol: float = 1e-3, atol: float = 1e-6,
                   dt0: float | None = None, max_steps: int = 4096,
                   controller: StepController = StepController(),
                   return_stats: bool = False):
    """Adaptive solve of a PACKED ensemble state with one independent
    step controller per member.

    `y0`'s last axis is member-major [S*d] (`models/packed.py`); `f` must
    be block-diagonal across members (a masked packed chain is) and is
    called with a per-member time vector t [S], which autonomous RHSs
    ignore. Each member carries its own (t, dt, save index, PI memory):
    error norms over its own block, steps clipped to its own next save
    time, accept/reject decisions that never couple members.

    Differentiable by autograd, as `odeint(adjoint="direct")` is: the
    error norms and the initial dt are out of the graph. Returns ys [T,
    ..., S*d] (rows a member never reached hold its final state) and,
    with `return_stats`, SolveStats of int32 [S] counts and a bool [S]
    success.
    """
    tab = get_tableau(solver)
    if tab.b_err is None or not tab.fsal:
        raise ValueError("per-member adaptive requires an FSAL embedded "
                         "tableau (tsit5/dopri5/bs3)")
    ts = torch.as_tensor(ts, dtype=y0.dtype, device=y0.device)
    S = int(n_members)
    if y0.shape[-1] % S:
        raise ValueError(f"state dim {y0.shape[-1]} not divisible by "
                         f"n_members={S}")
    d, dev = y0.shape[-1] // S, y0.device
    T = ts.shape[0]
    tdir = torch.sign(ts[-1] - ts[0])

    def expand(v):                                     # [S] -> [S*d]
        return v.repeat_interleave(d)

    def members(flags):
        return expand(torch.tensor(flags, device=dev))

    t = ts[0].expand(S)
    if dt0 is None:
        with torch.no_grad():
            dt = _initial_dt_members(f, t, y0, args, tab.order, rtol, atol,
                                     tdir, S)
    else:
        dt = torch.full((S,), dt0, dtype=ts.dtype, device=dev)
    k1 = f(t, y0, args)
    y, ys = y0, [y0] + [torch.zeros_like(y0)] * (T - 1)
    err_prev = torch.ones(S, dtype=ts.dtype, device=dev)
    save_idx, done = [1] * S, [T <= 1] * S
    n_acc, n_rej, n_it = [0] * S, [0] * S, [0] * S
    for _ in range(max_steps):
        if all(done):       # the JAX scan's remaining iterations are no-ops
            break
        rows = [min(i, T - 1) for i in save_idx]
        t_save = ts[torch.tensor(rows, device=dev)]
        remaining = (t_save - t) * tdir
        hit = dt >= remaining
        dt_used = torch.where(hit, remaining, dt)
        h = expand(tdir * dt_used)
        ks = [k1]
        for i in range(1, tab.stages):
            yi = y + h * _weighted_sum(tab.a[i], ks)
            ks.append(f(t + tab.c[i] * dt_used, yi, args))
        y1 = y + h * _weighted_sum(tab.b, ks)
        err = h * _weighted_sum(tab.b_err, ks)
        err_nrm = _member_norm(err.detach(), y.detach(), y1.detach(), rtol,
                               atol, S)
        accept = (err_nrm <= 1.0) | (dt_used <= controller.dt_min)
        fac = controller.factor(err_nrm, tab.order, err_prev)
        dt_next = torch.clamp_min(dt_used * fac, controller.dt_min)
        done_t = torch.tensor(done, device=dev)
        step_ok = accept & ~done_t
        saved = step_ok & hit
        ok_h, acc_h, saved_h = torch.stack([step_ok, accept, saved]).tolist()
        t = torch.where(step_ok, torch.where(hit, t_save, t + tdir * dt_used),
                        t)
        ok = expand(step_ok)
        y = torch.where(ok, y1, y)
        k1 = torch.where(ok, ks[-1], k1)                      # FSAL
        for row in sorted({r for r, v in zip(rows, saved_h) if v}):
            ys[row] = torch.where(
                members([v and r == row for r, v in zip(rows, saved_h)]),
                y1, ys[row])
        dt = torch.where(done_t, dt, dt_next)
        err_prev = torch.where(step_ok, torch.clamp_min(err_nrm, 1e-12),
                               err_prev)
        for s in range(S):
            n_acc[s] += ok_h[s]
            n_rej[s] += not acc_h[s] and not done[s]
            n_it[s] += not done[s]
            save_idx[s] += saved_h[s]
            done[s] = done[s] or save_idx[s] >= T
    # save rows a member never reached (max_steps ran out): its last state
    for i in range(1, T):
        if any(v <= i for v in save_idx):
            ys[i] = torch.where(members([v <= i for v in save_idx]), y,
                                ys[i])
    ys = torch.stack(ys)
    if return_stats:
        i32 = dict(dtype=torch.int32, device=dev)
        return ys, SolveStats(torch.tensor(n_acc, **i32),
                              torch.tensor(n_rej, **i32),
                              torch.tensor(n_it, **i32),
                              torch.tensor(done, device=dev))
    return ys
