"""Whole-RK-step and multistep fused kernels over the 2-layer KDense chain
(port of `kanodes_tpu/ops/rk_fused.py`).

`fused_rk_step` runs ONE explicit RK step of a state batch `x [K, I]`
(all stages of the tableau, unused stages pruned) as one kernel launch,
and its discrete adjoint as one more. `fused_rk_multistep` runs
`n_steps` whole steps in one launch and returns every post-step state
`[n_steps, K, I]`; its backward is one reverse sweep that takes a
cotangent for every stored state. The kernels are hand-written CUDA
(`csrc/rk_fused.cu`). Two flavors (`_cuda.fused_rk_flavor`): chains
within kan_chain.cuh's caps (I, O <= 8, H <= 32, G <= 16; the LV model)
take K2f/K2b and K3f/K3b, a warp a row (K2f is K3f's kernel at one step,
K2b K3b's phases at one step over many blocks); wider chains
(the Burgers and 1-D Allen-Cahn surrogates [41, 10, 41], the packed LV
ensemble [16, 80, 16]) take the medium flavor up to
`_cuda.check_block_caps`: K2f-m and K2b-m a block a row
(`csrc/kan_chain_block.cuh`), K3f-m a block of 512 threads a row and
K3b-m in three phases (`csrc/kan_chain_multistep.cuh`; its scratch sized
by `_cuda.multistep_bwd_mid_plan`); past those a launch raises
ValueError.

Dispatch: a CUDA tensor launches the kernel or raises; a CPU tensor runs
the plain PyTorch version of the same math (`_step_fwd_plain`,
`_step_bwd_plain`, and their multistep loops). Nothing else switches
between the two. The plain versions are exported for tests and
`chip_smoke.py` as `fused_rk_step_reference` (differentiable by
autograd), `fused_rk_step_bwd_reference` (the explicit adjoint), and the
same pair for the multistep: they are shape-generic, so they are the
plain versions of both flavors. `LAUNCHES` counts kernel launches, the
medium flavor's under its own names (`..._mid`; a backward counts one,
its later launches, the parameter sums among them, with it).

The reverse recursion of the backward (rk_fused.py:19-24):
    x_bar = g ;  kbar_i = dt * b_i * g
    for i = s-1 .. 0:
        (dx_i, dtheta_i) = vjp_chain(x_i, kbar_i)
        x_bar += dx_i ;  kbar_j += dt * a_ij * dx_i  (j < i)
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from kanodes_tpu_torch.ode.tableaus import Tableau, get_tableau
from kanodes_tpu_torch.ops import _cuda
from kanodes_tpu_torch.ops._cuda import on_cuda as _on_cuda
from kanodes_tpu_torch.ops._cuda import ptr as _ptr
from kanodes_tpu_torch.ops._cuda import stream as _stream
from kanodes_tpu_torch.ops.kdense_pallas import (ChainSpec, _chain_f,
                                                 _chain_vjp,
                                                 check_chain_launch, grid_of)

Tensor = torch.Tensor

# kernel launches since the last reset_launch_counts(); each wrapper adds
# one where it launches its kernel, and nowhere else
LAUNCHES = {"fused_rk_step_fwd": 0, "fused_rk_step_bwd": 0,
            "fused_rk_multistep_fwd": 0, "fused_rk_multistep_bwd": 0,
            "fused_rk_step_fwd_mid": 0, "fused_rk_step_bwd_mid": 0,
            "fused_rk_multistep_fwd_mid": 0, "fused_rk_multistep_bwd_mid": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _needed_stages(tab: Tableau) -> list[bool]:
    s = tab.stages
    needed = [False] * s
    for i in range(s):
        if tab.b[i] != 0.0:
            needed[i] = True
    # propagate: a stage is needed if any needed stage consumes it
    changed = True
    while changed:
        changed = False
        for i in range(s):
            if not needed[i]:
                continue
            for j in range(i):
                if tab.a[i][j] != 0.0 and not needed[j]:
                    needed[j] = True
                    changed = True
    return needed


def check_bwd_precision(bwd_precision: str) -> str:
    if bwd_precision == "highest":
        return bwd_precision
    if bwd_precision == "bf16":
        raise NotImplementedError(
            "bwd_precision='bf16' is not ported yet (ROADMAP.md, "
            "bf16 backward); use 'highest'")
    raise ValueError(f"bwd_precision must be one of ['bf16', 'highest'], "
                     f"got {bwd_precision!r}")


class _Consts:
    """Tableau and chain constants of one (spec, solver, dt), folded on
    the host: dt*a_ij and dt*b_i products in f64, rounded to f32 as JAX
    folds them; 1/h the same way."""

    def __init__(self, spec: ChainSpec, solver: str, dt: float):
        tab = get_tableau(solver)
        self.spec = spec
        self.stages = tab.stages
        self.needed = _needed_stages(tab)
        self.dta = [[float(np.float32(dt * a)) for a in row] for row in tab.a]
        self.dtb = [float(np.float32(dt * b)) for b in tab.b]
        self.n_slots = sum(self.needed)
        self._dims = self._tab = None

    @property
    def flavor(self) -> str:
        """"small" or "medium" (`_cuda.fused_rk_flavor`); raises past the
        medium caps."""
        return _cuda.fused_rk_flavor(self.spec, self.stages)

    # the chain the stages evaluate (the wide kernels' constants override
    # both with the grid-major layout of their parameters)
    def chain_f(self, x, params, grid):
        return _chain_f(x, *params, grid, self.spec)

    def chain_vjp(self, x, y1, params, grid, gy):
        return _chain_vjp(x, y1, *params, grid, self.spec, gy)

    def structs(self) -> tuple[_cuda.ChainDims, _cuda.StepTab]:
        """The kernels' ChainDims / StepTab (built once, then reused)."""
        if self._dims is None:
            d = _cuda.chain_dims(self.spec)
            t = _cuda.StepTab()
            t.stages = self.stages
            for i, row in enumerate(self.dta):
                t.a[i][:len(row)] = row
            t.b[:self.stages] = self.dtb
            t.needed[:self.stages] = [int(n) for n in self.needed]
            self._dims, self._tab = d, t
        return self._dims, self._tab


@functools.lru_cache(maxsize=64)
def _consts(spec: ChainSpec, solver: str, dt: float) -> _Consts:
    return _Consts(spec, solver, dt)


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path; references for the kernels)
# ---------------------------------------------------------------------------

def _stages(k: _Consts, x, params, grid):
    """Stage inputs xs, stage derivatives ks and layer-1 outputs y1s."""
    ks, xs, y1s = [None] * k.stages, [None] * k.stages, [None] * k.stages
    for i in range(k.stages):
        if not k.needed[i]:
            continue
        xi = x
        for j in range(i):
            if k.dta[i][j] != 0.0 and ks[j] is not None:
                xi = xi + k.dta[i][j] * ks[j]
        xs[i] = xi
        ks[i], y1s[i] = k.chain_f(xi, params, grid)
    return xs, ks, y1s


def _step_fwd_plain(k: _Consts, x, params, grid):
    _, ks, _ = _stages(k, x, params, grid)
    y = x
    for i in range(k.stages):
        if k.dtb[i] != 0.0:
            y = y + k.dtb[i] * ks[i]
    return y


def _step_bwd_plain(k: _Consts, x, params, grid, gy):
    xs, _, y1s = _stages(k, x, params, grid)
    xbar = gy
    kbar = [None] * k.stages
    for i in range(k.stages):
        if k.needed[i] and k.dtb[i] != 0.0:
            kbar[i] = k.dtb[i] * gy
    grads = [torch.zeros_like(p) for p in params]
    for i in range(k.stages - 1, -1, -1):
        if not k.needed[i] or kbar[i] is None:
            continue
        dxi, *dps = k.chain_vjp(xs[i], y1s[i], params, grid, kbar[i])
        xbar = xbar + dxi
        grads = [g + d for g, d in zip(grads, dps)]
        for j in range(i):
            if k.dta[i][j] != 0.0 and k.needed[j]:
                contrib = k.dta[i][j] * dxi
                kbar[j] = contrib if kbar[j] is None else kbar[j] + contrib
    return (xbar, *grads)


def _multistep_fwd_plain(k: _Consts, n_steps, x0, params, grid):
    ys, x = [], x0
    for _ in range(n_steps):
        x = _step_fwd_plain(k, x, params, grid)
        ys.append(x)
    return torch.stack(ys)


def _multistep_bwd_plain(k: _Consts, n_steps, x0, ys, params, grid, gys):
    xbar = torch.zeros_like(x0)
    grads = [torch.zeros_like(p) for p in params]
    for s in range(n_steps - 1, -1, -1):
        x_in = x0 if s == 0 else ys[s - 1]
        xbar, *dps = _step_bwd_plain(k, x_in, params, grid, xbar + gys[s])
        grads = [g + d for g, d in zip(grads, dps)]
    return (xbar, *grads)


def _grid_of(k: _Consts, x):
    return grid_of(k.spec, x)


def fused_rk_step_reference(spec: ChainSpec, solver: str, dt: float,
                            x, c1, w1, c2, w2):
    """Plain PyTorch version of the fused RK step (differentiable by
    autograd through its ops)."""
    k = _consts(spec, solver, dt)
    return _step_fwd_plain(k, x, (c1, w1, c2, w2), _grid_of(k, x))


def fused_rk_step_bwd_reference(spec: ChainSpec, solver: str, dt: float,
                                x, c1, w1, c2, w2, gy):
    """Plain PyTorch version of the step's discrete adjoint:
    (dx, dc1, dw1, dc2, dw2) for the output cotangent gy."""
    k = _consts(spec, solver, dt)
    return _step_bwd_plain(k, x, (c1, w1, c2, w2), _grid_of(k, x), gy)


def fused_rk_multistep_reference(spec: ChainSpec, solver: str, dt: float,
                                 n_steps: int, x0, c1, w1, c2, w2):
    """Plain PyTorch version of the multistep forward, [n_steps, K, I]."""
    k = _consts(spec, solver, dt)
    return _multistep_fwd_plain(k, n_steps, x0, (c1, w1, c2, w2),
                                _grid_of(k, x0))


def fused_rk_multistep_bwd_reference(spec: ChainSpec, solver: str,
                                     dt: float, n_steps: int, x0, ys,
                                     c1, w1, c2, w2, gys):
    """Plain PyTorch version of the multistep reverse sweep:
    (dx0, dc1, dw1, dc2, dw2) for the cotangents gys of every state."""
    k = _consts(spec, solver, dt)
    return _multistep_bwd_plain(k, n_steps, x0, ys, (c1, w1, c2, w2),
                                _grid_of(k, x0), gys)


# ---------------------------------------------------------------------------
# CUDA launch wrappers
# ---------------------------------------------------------------------------

def _check_rhs(spec: ChainSpec) -> None:
    if spec.out_dims != spec.in_dims:
        raise ValueError(f"an ODE right-hand side maps I -> I; got "
                         f"out_dims {spec.out_dims} != in_dims "
                         f"{spec.in_dims}")


def _check_launch(spec: ChainSpec, x, params, n_leading: int,
                  stages: int = _cuda.MAX_STAGES) -> int:
    """Validate a K2/K3 launch against the kernels' contract, the caps of
    the chain's flavor under an s-stage tableau included (default: the
    most stages); returns K."""
    _check_rhs(spec)
    _cuda.fused_rk_flavor(spec, stages)     # raises past the medium caps
    return check_chain_launch(spec, x, params, n_leading, caps=False)


def check_rhs_launch(spec: ChainSpec, x, params, n_leading: int) -> int:
    """Validate a launch of a kernel on kan_chain.cuh's one-thread /
    one-warp chain (K4): an I -> I chain within its caps; returns K."""
    _check_rhs(spec)
    _cuda.check_chain_caps(spec)
    return check_chain_launch(spec, x, params, n_leading, caps=False)


def _count(k: _Consts, name: str) -> str:
    name = name if k.flavor == "small" else name + "_mid"
    LAUNCHES[name] += 1
    return name


def _launch_step_fwd(k: _Consts, x, params):
    K = _check_launch(k.spec, x, params, 0, k.stages)
    y = torch.empty_like(x)
    dims, tab = k.structs()
    lib = _cuda.library()
    with torch.cuda.device(x.device):
        if k.flavor == "small":
            # K2f is K3f at one step: y is its ys[0]
            plan = _cuda.multistep_fwd_plan(k.spec, K, k.stages)
            err = lib.kc_rk_multistep_fwd(
                _ptr(x), *map(_ptr, params), _ptr(y), K, 1, plan.warps,
                ctypes.byref(dims), ctypes.byref(tab), _stream())
        else:
            err = lib.kb_rk_step_fwd(
                _ptr(x), *map(_ptr, params), _ptr(y), K,
                ctypes.byref(dims), ctypes.byref(tab), _stream())
    _cuda.check(err, _count(k, "fused_rk_step_fwd"))
    return y


def _scratch(k: _Consts, n_rec: int, like: Tensor) -> Tensor:
    return torch.empty(n_rec * _cuda.rec_width(k.spec), dtype=torch.float32,
                       device=like.device)


def _launch_step_bwd(k: _Consts, x, params, gy):
    K = _check_launch(k.spec, x, params, 0, k.stages)
    gy = gy.contiguous()
    dx = torch.empty_like(x)
    grads = [torch.empty_like(p) for p in params]
    scratch = _scratch(k, K * k.n_slots, x)
    dims, tab = k.structs()
    lib = _cuda.library()
    args = (_ptr(x), _ptr(gy), *map(_ptr, params), _ptr(dx),
            *map(_ptr, grads), _ptr(scratch), K, k.n_slots)
    with torch.cuda.device(x.device):
        if k.flavor == "small":
            plan = _cuda.step_bwd_plan(k.spec, K, k.n_slots)
            err = lib.kc_rk_step_bwd(*args, plan.warps, ctypes.byref(dims),
                                     ctypes.byref(tab), _stream())
        else:
            err = lib.kb_rk_step_bwd(*args, ctypes.byref(dims),
                                     ctypes.byref(tab), _stream())
    _cuda.check(err, _count(k, "fused_rk_step_bwd"))
    return (dx, *grads)


def _launch_multistep_fwd(k: _Consts, n_steps: int, x0, params):
    K = _check_launch(k.spec, x0, params, 0, k.stages)
    ys = torch.empty((n_steps,) + tuple(x0.shape), dtype=torch.float32,
                     device=x0.device)
    dims, tab = k.structs()
    lib = _cuda.library()
    with torch.cuda.device(x0.device):
        if k.flavor == "small":
            plan = _cuda.multistep_fwd_plan(k.spec, K, k.stages)
            err = lib.kc_rk_multistep_fwd(
                _ptr(x0), *map(_ptr, params), _ptr(ys), K, n_steps,
                plan.warps, ctypes.byref(dims), ctypes.byref(tab), _stream())
        else:
            err = lib.kb_rk_multistep_fwd(
                _ptr(x0), *map(_ptr, params), _ptr(ys), K, n_steps,
                ctypes.byref(dims), ctypes.byref(tab), _stream())
    _cuda.check(err, _count(k, "fused_rk_multistep_fwd"))
    return ys


def _launch_multistep_bwd(k: _Consts, n_steps: int, x0, ys, params, gys):
    K = _check_launch(k.spec, x0, params, 0, k.stages)
    gys = gys.contiguous()
    if tuple(ys.shape) != (n_steps, K, k.spec.in_dims) or \
            tuple(gys.shape) != tuple(ys.shape):
        raise ValueError(f"ys/gys shapes {tuple(ys.shape)}, "
                         f"{tuple(gys.shape)} != {(n_steps, K)}+[I]")
    dx0 = torch.empty_like(x0)
    grads = [torch.empty_like(p) for p in params]
    if k.flavor == "small":
        scratch = _scratch(k, n_steps * K * k.n_slots, x0)
    else:
        # the records, then each one's stage Jacobian block (one allocation)
        plan = _cuda.multistep_bwd_mid_plan(k.spec, K, k.stages, n_steps,
                                            k.n_slots)
        scratch = torch.empty(plan.scratch_floats, dtype=torch.float32,
                              device=x0.device)
    dims, tab = k.structs()
    lib = _cuda.library()
    with torch.cuda.device(x0.device):
        if k.flavor == "small":
            plan = _cuda.warp_adjoint_plan(k.spec, K, k.n_slots, n_steps)
            err = lib.kc_rk_multistep_bwd(
                _ptr(x0), _ptr(ys), _ptr(gys), *map(_ptr, params),
                _ptr(dx0), *map(_ptr, grads), _ptr(scratch), K, n_steps,
                k.n_slots, plan.warps, plan.chunk, ctypes.byref(dims),
                ctypes.byref(tab), _stream())
        else:
            err = lib.kb_rk_multistep_bwd(
                _ptr(x0), _ptr(ys), _ptr(gys), *map(_ptr, params),
                _ptr(dx0), *map(_ptr, grads), _ptr(scratch), K, n_steps,
                k.n_slots, ctypes.byref(dims), ctypes.byref(tab), _stream())
    _cuda.check(err, _count(k, "fused_rk_multistep_bwd"))
    return (dx0, *grads)


# ---------------------------------------------------------------------------
# public differentiable ops
# ---------------------------------------------------------------------------

class _FusedRKStep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, k, x, c1, w1, c2, w2):
        params = (c1, w1, c2, w2)
        ctx.k = k
        ctx.save_for_backward(x, *params)
        if _on_cuda(x, *params):
            return _launch_step_fwd(k, x, params)
        return _step_fwd_plain(k, x, params, _grid_of(k, x))

    @staticmethod
    def backward(ctx, gy):
        x, *params = ctx.saved_tensors
        k = ctx.k
        if _on_cuda(gy, x, *params):
            grads = _launch_step_bwd(k, x, params, gy)
        else:
            grads = _step_bwd_plain(k, x, params, _grid_of(k, x), gy)
        return (None, *grads)


class _FusedRKMultistep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, k, n_steps, x0, c1, w1, c2, w2):
        params = (c1, w1, c2, w2)
        if _on_cuda(x0, *params):
            ys = _launch_multistep_fwd(k, n_steps, x0, params)
        else:
            ys = _multistep_fwd_plain(k, n_steps, x0, params,
                                      _grid_of(k, x0))
        ctx.k, ctx.n_steps = k, n_steps
        ctx.save_for_backward(x0, ys, *params)
        return ys

    @staticmethod
    def backward(ctx, gys):
        x0, ys, *params = ctx.saved_tensors
        k, n = ctx.k, ctx.n_steps
        if _on_cuda(gys, x0, *params):
            grads = _launch_multistep_bwd(k, n, x0, ys, params, gys)
        else:
            grads = _multistep_bwd_plain(k, n, x0, ys, params,
                                         _grid_of(k, x0), gys)
        return (None, None, *grads)


def fused_rk_step(spec: ChainSpec, solver: str, dt: float,
                  x, c1, w1, c2, w2, bwd_precision: str = "highest"):
    """One whole RK step y = x + dt*sum(b_i k_i) over the chain.

    x: [K, I] batch of states; solver: fixed-step tableau name; dt: step
    size. Differentiable w.r.t. x and all params; the backward is the
    single-kernel discrete adjoint."""
    check_bwd_precision(bwd_precision)
    return _FusedRKStep.apply(_consts(spec, solver, float(dt)), x,
                              c1, w1, c2, w2)


def fused_rk_multistep(spec: ChainSpec, solver: str, dt: float,
                       n_steps: int, x0, c1, w1, c2, w2,
                       bwd_precision: str = "highest"):
    """n_steps whole RK steps in one launch; returns the post-step state
    history ys [n_steps, K, I] (x0 not included). The backward is one
    reverse sweep accepting a cotangent for every saved state."""
    check_bwd_precision(bwd_precision)
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    return _FusedRKMultistep.apply(_consts(spec, solver, float(dt)),
                                   int(n_steps), x0, c1, w1, c2, w2)
