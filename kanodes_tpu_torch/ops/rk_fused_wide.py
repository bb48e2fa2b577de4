"""Wide-state fused RK kernels (port of `kanodes_tpu/ops/rk_fused_wide.py`).

The narrow kernels of `ops/rk_fused.py` keep a row's whole state in one
thread; a full-state PDE surrogate ([402,10,402] Schrödinger,
[1024,10,1024] 2-D Allen-Cahn) needs the wide axis spread over a block.
`fused_rk_step_wide` runs one RK step of a PADDED state `x [K, Ipad]`
(K6), `fused_rk_multistep_wide` runs `n_steps` of them in one launch and
returns every post-step state `[n_steps, K, Ipad]` (K7); each backward is
one more call. At K == 1 the multistep backward goes through the
low-rank step Jacobian `I + U Ds (I - L)^{-1} V` (K10), as the JAX
package resolves `lowrank=None`. The kernels are hand-written CUDA
(`csrc/rk_fused_wide.cu`).

Layout (`WideSpec.pad_params`, the JAX package's, so padded arrays cross
over unchanged): `c1p [G*Ipad, H]` grouped by grid node (row g*Ipad+i),
`w1p [Ipad, H]`, `c2p [H*G, Ipad]`, `w2p [H, Ipad]`, `Ipad` the next
multiple of `block`. Pad columns of the state stay 0 and every function
here returns zeros on the pad lanes of `ys`, `dx` and the parameter
cotangents (the JAX kernel's raw `dc1p` is non-zero on pad rows, which
`pad_params`' transpose throws away).

K7f (K6f), K7b (K6b) and K10's serial chain run one thread-block
cluster per state row on the card: `WideSpec.cluster_plan` cuts the
padded row into C equal column slices, one block each, and says whether
each block's weight slice (K7f, K7b) and double-buffered factor slices
(K10) fit its shared memory (`csrc/rk_fused_wide.cu`).

Dispatch: a CUDA tensor launches the kernel or raises; a CPU tensor runs
the plain PyTorch version of the same math, exported for tests and
`chip_smoke.py` as the `*_reference` functions. The plain versions index
and broadcast; the JAX kernels' 0/1 selector GEMMs, lane-replicated grid
row, tree collapse and window batching are Mosaic devices and are not
ported. `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from kanodes_tpu_torch.ops import _cuda
from kanodes_tpu_torch.ops._cuda import on_cuda as _on_cuda
from kanodes_tpu_torch.ops._cuda import ptr as _ptr
from kanodes_tpu_torch.ops._cuda import stream as _stream
from kanodes_tpu_torch.ops.kdense_pallas import (ChainSpec, _basis_du,
                                                 _basis_val, _dnorm, _dswish,
                                                 _layer_bwd, _layer_fwd,
                                                 _norm, _swish, chain_spec_of,
                                                 fused_params, grid_of)
from kanodes_tpu_torch.ops.rk_fused import (_Consts, _multistep_bwd_plain,
                                            _multistep_fwd_plain, _stages,
                                            _step_bwd_plain, _step_fwd_plain,
                                            check_bwd_precision)

Tensor = torch.Tensor

# kernel launches since the last reset_launch_counts(); each wrapper adds
# one where it launches its kernel, and nowhere else
LAUNCHES = {"fused_rk_step_wide_fwd": 0, "fused_rk_step_wide_bwd": 0,
            "fused_rk_multistep_wide_fwd": 0,
            "fused_rk_multistep_wide_bwd": 0,
            "fused_rk_multistep_wide_bwd_lr": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# dynamic shared memory a block may take on Hopper (232,448 bytes)
SMEM_BYTES = 232_448
# the portable cluster size: at most 8 blocks per cluster
MAX_CLUSTER = 8


class ClusterPlan(NamedTuple):
    """How K7f/K6f, K7b/K6b and K10's chain lay one state row over a
    cluster: `cluster` blocks of `threads` threads, each owning `cols`
    columns of the padded row; whether the weight slice (K7f), the two
    factor buffers (K10) and the weight slice beside the reverse sweep's
    buffers (K7b) sit in shared memory, and each kernel's dynamic shared
    memory per block in bytes (`wd_smem_bytes` of the kernels)."""
    cluster: int
    cols: int
    threads: int
    smem_weights: bool
    smem_factors: bool
    fwd_bytes: int
    lr_bytes: int
    smem_weights_bwd: bool
    bwd_bytes: int


class WideSpec:
    """Static config for a wide 2-layer chain, padded to `block` lanes."""

    def __init__(self, spec: ChainSpec, block: int = 128):
        self.spec = spec
        self.block = block
        self.I = spec.in_dims
        self.H = spec.hidden
        self.O = spec.out_dims
        self.G = spec.grid_len
        if self.O != self.I:
            raise ValueError("WideSpec supports in_dims == out_dims "
                             "chains (full PDE surrogates)")
        self.Ipad = -(-self.I // block) * block
        self.Opad = self.Ipad      # RK state must keep its padded width
        self.nb = self.Ipad // block

    def __eq__(self, other):
        return isinstance(other, WideSpec) and \
            (self.spec, self.block) == (other.spec, other.block)

    def __hash__(self):
        return hash((self.spec, self.block))

    def cluster_blocks(self) -> int:
        """Blocks per state row: 1 for a row of at most 128 lanes (or one
        not a multiple of 32), else the most blocks, up to the portable 8,
        that cut Ipad into equal slices of a multiple of 32 lanes."""
        if self.Ipad <= 128 or self.Ipad % 32:
            return 1
        c = MAX_CLUSTER
        while (self.Ipad // 32) % c:
            c //= 2
        return c

    def cluster_plan(self, n_slots: int) -> ClusterPlan:
        """The cluster layout of K7f, K7b and K10's chain for `n_slots`
        needed stages, with the shared memory each block takes (the
        kernels' wd_fwd_smem_bytes / wd_lr_smem_bytes / wd_bwd_smem_bytes,
        float for float)."""
        C = self.cluster_blocks()
        W = self.Ipad // C
        # threads over the slice's real columns, in Q groups; at most 256
        # a block (WD_CLUSTER_THREADS)
        Wt = min(-(-min(W, self.I) // 32) * 32, 256)
        Q = 256 // Wt
        threads = Wt * Q
        H, G, SH = self.H, self.G, n_slots * self.H
        fwd = 8 + (1 + 2 * n_slots + Q) * W + threads // 32 * H \
            + H * G + H + 2 * C * H
        weights = (2 * G + 2) * H * W
        smem_weights = self.Ipad % 32 == 0 \
            and 4 * (fwd + weights) <= SMEM_BYTES
        lr = 4 + 2 * W + (threads // SH) * SH + 2 * C * SH + SH
        factors = 2 * (2 * SH * W + SH * SH)
        smem_factors = 4 * (lr + factors) <= SMEM_BYTES
        # K7b: the step input, stage inputs and cotangents, xbar, the
        # layer-2 and VJP partials, the m2 exchange [2, C, H*G + H], the
        # rows' coefficients and the stages' y1
        R2 = H * G + H
        bwd = 8 + (2 + 2 * n_slots + 2 * Q) * W + threads // 32 * H + R2 \
            + 2 * C * H + 2 * C * R2 + R2 + SH + H
        smem_weights_bwd = self.Ipad % 32 == 0 \
            and 4 * (bwd + weights) <= SMEM_BYTES
        return ClusterPlan(C, W, threads, smem_weights, smem_factors,
                           4 * (fwd + (weights if smem_weights else 0)),
                           4 * (lr + (factors if smem_factors else 0)),
                           smem_weights_bwd,
                           4 * (bwd + (weights if smem_weights_bwd else 0)))

    def pad_params(self, c1, w1, c2, w2):
        """c1 [I*G, H] (rows i*G+g) -> [G*Ipad, H] grouped BY GRID NODE
        (rows g*Ipad+i, zero pad rows); w1 [I, H] -> [Ipad, H];
        c2 [H*G, O] -> [H*G, Opad]; w2 [H, O] -> [H, Opad]."""
        pad_i = self.Ipad - self.I
        c1p = F.pad(c1.reshape(self.I, self.G, self.H),
                    (0, 0, 0, 0, 0, pad_i))
        c1p = c1p.transpose(0, 1).reshape(self.G * self.Ipad, self.H)
        w1p = F.pad(w1, (0, 0, 0, pad_i))
        pad_o = self.Opad - self.O
        return c1p, w1p, F.pad(c2, (0, pad_o)), F.pad(w2, (0, pad_o))

    # the real (unpadded) part of padded arrays, and back ----------------
    def real_params(self, c1p, w1p, c2p, w2p):
        """Views of the real columns: c1 [G, I, H], w1 [I, H],
        c2 [H*G, I], w2 [H, I]."""
        I = self.I
        return (c1p.reshape(self.G, self.Ipad, self.H)[:, :I], w1p[:I],
                c2p[:, :I], w2p[:, :I])

    def pad_state(self, x):
        """[..., I] -> [..., Ipad], zeros on the pad lanes."""
        return F.pad(x, (0, self.Ipad - self.I))

    def pad_grads(self, dx, dc1, dw1, dc2, dw2):
        """Cotangents of the real part, zero-padded to the padded layout."""
        pad = self.Ipad - self.I
        return (F.pad(dx, (0, pad)),
                F.pad(dc1, (0, 0, 0, pad)).reshape(self.G * self.Ipad,
                                                   self.H),
                F.pad(dw1, (0, 0, 0, pad)), F.pad(dc2, (0, pad)),
                F.pad(dw2, (0, pad)))


class _WideConsts(_Consts):
    """Constants of one (ws, solver, dt): the tableau folded as
    `rk_fused._Consts` folds it, and the chain math on the real columns
    of the wide layout (c1 [G, I, H])."""

    def __init__(self, ws: WideSpec, solver: str, dt: float):
        super().__init__(ws.spec, solver, dt)
        self.ws = ws
        self.live = [i for i in range(self.stages) if self.needed[i]]
        self._wide_tab = None

    def _u1(self, x, grid):
        sp = self.spec
        return (_norm(x, sp.normalizer)[:, None, :] - grid[:, None]) \
            * (1.0 / sp.h)                                   # [K, G, I]

    def chain_f(self, x, params, grid):
        c1, w1, c2, w2 = params
        sp = self.spec
        B = _basis_val(self._u1(x, grid), sp.basis)
        y1 = torch.einsum("kgi,gih->kh", B, c1) + _swish(x) @ w1
        y2, _, _ = _layer_fwd(y1, c2, w2, grid, sp.h, sp.normalizer,
                              sp.basis)
        return y2, y1

    def chain_vjp(self, x, y1, params, grid, gy):
        c1, w1, c2, w2 = params
        sp = self.spec
        _, u2, b2 = _layer_fwd(y1, c2, w2, grid, sp.h, sp.normalizer,
                               sp.basis)
        dy1, dc2, dw2 = _layer_bwd(y1, c2, w2, sp.h, u2, b2, gy,
                                   sp.normalizer, sp.basis)
        u = self._u1(x, grid)
        B = _basis_val(u, sp.basis)
        m = torch.einsum("kh,gih->kgi", dy1, c1)
        dxn = (m * _basis_du(u, B, sp.basis) * (1.0 / sp.h)).sum(1)
        dx = dxn * _dnorm(x, sp.normalizer) + (dy1 @ w1.T) * _dswish(x)
        dc1 = torch.einsum("kgi,kh->gih", B, dy1)
        dw1 = _swish(x).T @ dy1
        return dx, dc1, dw1, dc2, dw2

    def wide_tab(self) -> _cuda.WideTab:
        """The kernels' WideTab (built once, then reused)."""
        if self._wide_tab is None:
            ws, sp = self.ws, self.spec
            _cuda.check_wide_caps(sp, self.stages)
            t = _cuda.WideTab()
            t.I, t.Ipad, t.H, t.G = ws.I, ws.Ipad, ws.H, ws.G
            t.normalizer = _cuda._NORMALIZERS[sp.normalizer]
            t.basis = _cuda._BASES[sp.basis]
            t.inv_h = float(np.float32(1.0 / sp.h))
            t.grid[:ws.G] = [float(g) for g in sp.grid()]
            t.stages, t.n_slots = self.stages, self.n_slots
            for i, row in enumerate(self.dta):
                t.a[i][:len(row)] = row
            t.b[:self.stages] = self.dtb
            t.needed[:self.stages] = [int(n) for n in self.needed]
            slot = 0
            for i in range(self.stages):
                t.slot[i] = slot
                slot += int(self.needed[i])
            plan = ws.cluster_plan(self.n_slots)
            t.cluster, t.threads = plan.cluster, plan.threads
            t.smem_weights = int(plan.smem_weights)
            t.smem_factors = int(plan.smem_factors)
            t.smem_weights_bwd = int(plan.smem_weights_bwd)
            self._wide_tab = t
        return self._wide_tab


@functools.lru_cache(maxsize=64)
def _consts(ws: WideSpec, solver: str, dt: float) -> _WideConsts:
    return _WideConsts(ws, solver, dt)


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path; references for the kernels). Each takes
# and returns PADDED arrays and computes on the real columns.
# ---------------------------------------------------------------------------

def _step_fwd_wide_plain(k: _WideConsts, x, pp):
    ws = k.ws
    y = _step_fwd_plain(k, x[:, :ws.I], ws.real_params(*pp), grid_of(k.spec,
                                                                     x))
    return ws.pad_state(y)


def _step_bwd_wide_plain(k: _WideConsts, x, pp, gy):
    """`_step_adjoint_wide`: the step's discrete adjoint."""
    ws = k.ws
    return ws.pad_grads(*_step_bwd_plain(
        k, x[:, :ws.I], ws.real_params(*pp), grid_of(k.spec, x),
        gy[:, :ws.I]))


def _multistep_fwd_wide_plain(k: _WideConsts, n_steps, x0, pp):
    ws = k.ws
    ys = _multistep_fwd_plain(k, n_steps, x0[:, :ws.I], ws.real_params(*pp),
                              grid_of(k.spec, x0))
    return ws.pad_state(ys)


def _multistep_bwd_wide_plain(k: _WideConsts, n_steps, x0, ys, pp, gys):
    """The reverse sweep, a cotangent for every stored state."""
    ws = k.ws
    return ws.pad_grads(*_multistep_bwd_plain(
        k, n_steps, x0[:, :ws.I], ys[..., :ws.I], ws.real_params(*pp),
        grid_of(k.spec, x0), gys[..., :ws.I]))


def _lowrank_step(k: _WideConsts, x, a, params, grid):
    """One step of the low-rank reverse chain at K == 1, from the step
    input x [1, I] with the output cotangent a [1, I]: (xbar, dc1, dw1,
    dc2, dw2).

    With A_i = dk_i/dy1 [I, H] and B_i^T = dy1/dx at stage i [H, I] the
    step Jacobian is I + U Ds (I - L)^{-1} V: U = [A_1 .. A_S], V =
    [B_1^T; ..; B_S^T], Ds = blockdiag(dt b_i), L_ji = dt a_ji B_j^T A_i
    strictly block-lower, so (I - L)^{-1} = I + L + .. + L^{S-1}. The
    hidden cotangents t = (a U) Ds (I - L)^{-1} are the stages' dy1bar;
    kbar_i = dt b_i a + sum_{j>i} dt a_ji t_j B_j^T."""
    sp, H, G = k.spec, k.ws.H, k.ws.G
    c1, w1, c2, w2 = params
    inv_h = 1.0 / sp.h
    xs, _, y1s = _stages(k, x, params, grid)
    live, S = k.live, len(k.live)
    At, V, Bs, b2s = [], [], [], []
    for i in live:
        xi, y1 = xs[i][0], y1s[i][0]                         # [I], [H]
        u2 = (_norm(y1, sp.normalizer)[:, None] - grid) * inv_h   # [H, G]
        b2 = _basis_val(u2, sp.basis)
        d2 = _basis_du(u2, b2, sp.basis) * inv_h \
            * _dnorm(y1, sp.normalizer)[:, None]
        At.append(torch.einsum("hg,hgo->ho", d2, c2.reshape(H, G, -1))
                  + _dswish(y1)[:, None] * w2)               # A_i^T [H, I]
        u = (_norm(xi, sp.normalizer)[None, :] - grid[:, None]) * inv_h
        B = _basis_val(u, sp.basis)                          # [G, I]
        dB = _basis_du(u, B, sp.basis) * inv_h \
            * _dnorm(xi, sp.normalizer)[None, :]
        V.append(torch.einsum("gi,gih->hi", dB, c1)
                 + _dswish(xi)[None, :] * w1.T)              # B_i^T [H, I]
        Bs.append(B)
        b2s.append(b2.reshape(-1))
    At_all, V_all = torch.cat(At), torch.cat(V)              # [S*H, I]
    acoef = x.new_zeros((S * H, S * H))
    dtb = x.new_zeros((S * H,))
    for pi, i in enumerate(live):
        dtb[pi * H:(pi + 1) * H] = k.dtb[i]
        for pj, j in enumerate(live):
            if j < i:
                acoef[pi * H:(pi + 1) * H, pj * H:(pj + 1) * H] = k.dta[i][j]
    L = (V_all @ At_all.T) * acoef
    eye = torch.eye(S * H, dtype=x.dtype, device=x.device)
    T = eye
    for _ in range(S - 1):
        T = eye + L @ T
    t = ((a @ At_all.T) * dtb) @ T                           # [1, S*H]
    xbar = a + t @ V_all
    grads = [torch.zeros_like(p) for p in params]
    dxs = [t[:, p * H:(p + 1) * H] @ V[p] for p in range(S)]
    for pi, i in enumerate(live):
        ti = t[0, pi * H:(pi + 1) * H]
        kbar = k.dtb[i] * a
        for pj, j in enumerate(live):
            if j > i and k.dta[j][i] != 0.0:
                kbar = kbar + k.dta[j][i] * dxs[pj]
        grads[0] = grads[0] + Bs[pi][:, :, None] * ti
        grads[1] = grads[1] + _swish(xs[i][0])[:, None] * ti
        grads[2] = grads[2] + b2s[pi][:, None] * kbar[0]
        grads[3] = grads[3] + _swish(y1s[i][0])[:, None] * kbar[0]
    return (xbar, *grads)


def _multistep_bwd_lr_wide_plain(k: _WideConsts, n_steps, x0, ys, pp, gys):
    """The K == 1 reverse sweep through the low-rank step Jacobian."""
    ws = k.ws
    params, grid = ws.real_params(*pp), grid_of(k.spec, x0)
    x0r, ysr, gysr = x0[:, :ws.I], ys[..., :ws.I], gys[..., :ws.I]
    xbar = torch.zeros_like(x0r)
    grads = [torch.zeros_like(p) for p in params]
    for s in range(n_steps - 1, -1, -1):
        x_in = x0r if s == 0 else ysr[s - 1]
        xbar, *dps = _lowrank_step(k, x_in, xbar + gysr[s], params, grid)
        grads = [g + d for g, d in zip(grads, dps)]
    return ws.pad_grads(xbar, *grads)


def fused_rk_step_wide_reference(ws: WideSpec, solver: str, dt: float,
                                 x, c1p, w1p, c2p, w2p):
    """Plain PyTorch version of K6f (differentiable by autograd)."""
    return _step_fwd_wide_plain(_consts(ws, solver, float(dt)), x,
                                (c1p, w1p, c2p, w2p))


def fused_rk_step_wide_bwd_reference(ws: WideSpec, solver: str, dt: float,
                                     x, c1p, w1p, c2p, w2p, gy):
    """Plain PyTorch version of K6b: (dx, dc1p, dw1p, dc2p, dw2p)."""
    return _step_bwd_wide_plain(_consts(ws, solver, float(dt)), x,
                                (c1p, w1p, c2p, w2p), gy)


def fused_rk_multistep_wide_reference(ws: WideSpec, solver: str, dt: float,
                                      n_steps: int, x0, c1p, w1p, c2p, w2p):
    """Plain PyTorch version of K7f, [n_steps, K, Ipad] (differentiable by
    autograd)."""
    return _multistep_fwd_wide_plain(_consts(ws, solver, float(dt)), n_steps,
                                     x0, (c1p, w1p, c2p, w2p))


def fused_rk_multistep_wide_bwd_reference(ws: WideSpec, solver: str,
                                          dt: float, n_steps: int, x0, ys,
                                          c1p, w1p, c2p, w2p, gys,
                                          lowrank: bool = False):
    """Plain PyTorch version of K7b, or with `lowrank` of K10 (K == 1):
    (dx0, dc1p, dw1p, dc2p, dw2p) for the cotangents gys of every state."""
    k = _consts(ws, solver, float(dt))
    if lowrank:
        _check_lowrank(x0.shape[0])
        return _multistep_bwd_lr_wide_plain(k, n_steps, x0, ys,
                                            (c1p, w1p, c2p, w2p), gys)
    return _multistep_bwd_wide_plain(k, n_steps, x0, ys,
                                     (c1p, w1p, c2p, w2p), gys)


def _check_lowrank(K: int) -> None:
    if K != 1:
        raise ValueError("lowrank backward supports K == 1 only (the "
                         "factors U/V/T are per-trajectory)")


# ---------------------------------------------------------------------------
# CUDA launch wrappers
# ---------------------------------------------------------------------------

def _check_launch(k: _WideConsts, x, pp) -> int:
    """Validate a launch against the kernels' contract; returns K."""
    ws = k.ws
    if x.dim() != 2 or x.shape[1] != ws.Ipad or x.shape[0] < 1:
        raise ValueError(f"state shape {tuple(x.shape)} is not "
                         f"[K, {ws.Ipad}] (the padded width)")
    want = ((ws.G * ws.Ipad, ws.H), (ws.Ipad, ws.H), (ws.H * ws.G, ws.Opad),
            (ws.H, ws.Opad))
    for name, p, shape in zip(("c1p", "w1p", "c2p", "w2p"), pp, want):
        if tuple(p.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(p.shape)} != {shape}")
        if x.is_cuda and p.data_ptr() % 16:
            # K7f copies its weight slices with 16-byte bulk copies
            raise ValueError(f"{name}: the kernels take weights whose data "
                             f"starts on a 16-byte boundary")
    _cuda.check_tensors(x, *pp)
    return x.shape[0]


def _records(k: _WideConsts, n_rec: int, like: Tensor):
    """Scratch of the backward: per record the stage input and stage
    cotangent [I], y1 and its cotangent [H]."""
    def buf(width):
        return torch.empty((n_rec, width), dtype=torch.float32,
                           device=like.device)
    return buf(k.ws.I), buf(k.ws.I), buf(k.ws.H), buf(k.ws.H)


def _launch_step_fwd(k: _WideConsts, x, pp):
    K = _check_launch(k, x, pp)
    y = torch.empty_like(x)
    lib = _cuda.library()
    with torch.cuda.device(x.device):
        # one step of K7f's device code: y is ys [1, K, Ipad]
        err = lib.wd_multistep_fwd(_ptr(x), *map(_ptr, pp), _ptr(y), K, 1,
                                   ctypes.byref(k.wide_tab()), _stream())
    LAUNCHES["fused_rk_step_wide_fwd"] += 1
    _cuda.check(err, "fused_rk_step_wide_fwd")
    return y


def _launch_step_bwd(k: _WideConsts, x, pp, gy):
    K = _check_launch(k, x, pp)
    gy = gy.contiguous()
    if tuple(gy.shape) != tuple(x.shape):
        raise ValueError(f"gy shape {tuple(gy.shape)} != {tuple(x.shape)}")
    _cuda.check_tensors(gy)
    dx = torch.empty_like(x)
    grads = [torch.empty_like(p) for p in pp]
    rec = _records(k, K * k.n_slots, x)
    lib = _cuda.library()
    with torch.cuda.device(x.device):
        # one step of K7b's device code; step 0 reads x, never ys
        err = lib.wd_multistep_bwd(_ptr(x), _ptr(x), _ptr(gy),
                                   *map(_ptr, pp), _ptr(dx),
                                   *map(_ptr, grads), *map(_ptr, rec), K, 1,
                                   ctypes.byref(k.wide_tab()), _stream())
    LAUNCHES["fused_rk_step_wide_bwd"] += 1
    _cuda.check(err, "fused_rk_step_wide_bwd")
    return (dx, *grads)


def _launch_multistep_fwd(k: _WideConsts, n_steps: int, x0, pp):
    K = _check_launch(k, x0, pp)
    ys = torch.empty((n_steps,) + tuple(x0.shape), dtype=torch.float32,
                     device=x0.device)
    lib = _cuda.library()
    with torch.cuda.device(x0.device):
        err = lib.wd_multistep_fwd(_ptr(x0), *map(_ptr, pp), _ptr(ys), K,
                                   n_steps, ctypes.byref(k.wide_tab()),
                                   _stream())
    LAUNCHES["fused_rk_multistep_wide_fwd"] += 1
    _cuda.check(err, "fused_rk_multistep_wide_fwd")
    return ys


def _check_history(k: _WideConsts, n_steps: int, K: int, ys, gys):
    want = (n_steps, K, k.ws.Ipad)
    if tuple(ys.shape) != want or tuple(gys.shape) != want:
        raise ValueError(f"ys/gys shapes {tuple(ys.shape)}, "
                         f"{tuple(gys.shape)} != {want}")
    _cuda.check_tensors(ys, gys)


def _launch_multistep_bwd(k: _WideConsts, n_steps: int, x0, ys, pp, gys):
    K = _check_launch(k, x0, pp)
    gys = gys.contiguous()
    _check_history(k, n_steps, K, ys, gys)
    dx0 = torch.empty_like(x0)
    grads = [torch.empty_like(p) for p in pp]
    rec = _records(k, n_steps * K * k.n_slots, x0)
    lib = _cuda.library()
    with torch.cuda.device(x0.device):
        err = lib.wd_multistep_bwd(
            _ptr(x0), _ptr(ys), _ptr(gys), *map(_ptr, pp), _ptr(dx0),
            *map(_ptr, grads), *map(_ptr, rec), K, n_steps,
            ctypes.byref(k.wide_tab()), _stream())
    LAUNCHES["fused_rk_multistep_wide_bwd"] += 1
    _cuda.check(err, "fused_rk_multistep_wide_bwd")
    return (dx0, *grads)


def _launch_multistep_bwd_lr(k: _WideConsts, n_steps: int, x0, ys, pp, gys):
    K = _check_launch(k, x0, pp)
    _check_lowrank(K)
    gys = gys.contiguous()
    _check_history(k, n_steps, K, ys, gys)
    dx0 = torch.empty_like(x0)
    grads = [torch.empty_like(p) for p in pp]
    rec = _records(k, n_steps * k.n_slots, x0)
    SH = k.n_slots * k.ws.H

    def buf(*shape):
        return torch.empty(shape, dtype=torch.float32, device=x0.device)

    factors = (buf(n_steps, SH, k.ws.I), buf(n_steps, SH, k.ws.I),
               buf(n_steps, SH, SH))                        # A^T, V, L
    lib = _cuda.library()
    with torch.cuda.device(x0.device):
        err = lib.wd_multistep_bwd_lr(
            _ptr(x0), _ptr(ys), _ptr(gys), *map(_ptr, pp), _ptr(dx0),
            *map(_ptr, grads), *map(_ptr, rec), *map(_ptr, factors),
            n_steps, ctypes.byref(k.wide_tab()), _stream())
    LAUNCHES["fused_rk_multistep_wide_bwd_lr"] += 1
    _cuda.check(err, "fused_rk_multistep_wide_bwd_lr")
    return (dx0, *grads)


# ---------------------------------------------------------------------------
# public differentiable ops
# ---------------------------------------------------------------------------

class _FusedRKStepWide(torch.autograd.Function):
    @staticmethod
    def forward(ctx, k, x, c1p, w1p, c2p, w2p):
        pp = (c1p, w1p, c2p, w2p)
        ctx.k = k
        ctx.save_for_backward(x, *pp)
        if _on_cuda(x, *pp):
            return _launch_step_fwd(k, x, pp)
        return _step_fwd_wide_plain(k, x, pp)

    @staticmethod
    def backward(ctx, gy):
        x, *pp = ctx.saved_tensors
        if _on_cuda(gy, x, *pp):
            grads = _launch_step_bwd(ctx.k, x, pp, gy)
        else:
            grads = _step_bwd_wide_plain(ctx.k, x, pp, gy)
        return (None, *grads)


class _FusedRKMultistepWide(torch.autograd.Function):
    @staticmethod
    def forward(ctx, k, n_steps, lowrank, x0, c1p, w1p, c2p, w2p):
        pp = (c1p, w1p, c2p, w2p)
        if _on_cuda(x0, *pp):
            ys = _launch_multistep_fwd(k, n_steps, x0, pp)
        else:
            ys = _multistep_fwd_wide_plain(k, n_steps, x0, pp)
        ctx.k, ctx.n_steps, ctx.lowrank = k, n_steps, lowrank
        ctx.save_for_backward(x0, ys, *pp)
        return ys

    @staticmethod
    def backward(ctx, gys):
        x0, ys, *pp = ctx.saved_tensors
        k, n = ctx.k, ctx.n_steps
        K = x0.shape[0]
        # lowrank=None: the low-rank backward when K == 1 (trajectory mode)
        use_lr = (K == 1) if ctx.lowrank is None else ctx.lowrank
        if use_lr:
            _check_lowrank(K)
        if _on_cuda(gys, x0, *pp):
            launch = _launch_multistep_bwd_lr if use_lr \
                else _launch_multistep_bwd
            grads = launch(k, n, x0, ys, pp, gys)
        else:
            plain = _multistep_bwd_lr_wide_plain if use_lr \
                else _multistep_bwd_wide_plain
            grads = plain(k, n, x0, ys, pp, gys)
        return (None, None, None, *grads)


def fused_rk_step_wide(ws: WideSpec, solver: str, dt: float,
                       x, c1p, w1p, c2p, w2p):
    """One whole RK step on a PADDED wide state x [K, Ipad] with padded
    params (see WideSpec.pad_params). Returns y [K, Ipad]; the backward
    is the single-call discrete adjoint."""
    return _FusedRKStepWide.apply(_consts(ws, solver, float(dt)), x,
                                  c1p, w1p, c2p, w2p)


def fused_rk_multistep_wide(ws: WideSpec, solver: str, dt: float,
                            n_steps: int, x0, c1p, w1p, c2p, w2p,
                            lowrank: bool | None = None,
                            bwd_precision: str = "highest"):
    """n_steps whole wide RK steps in ONE kernel launch on a PADDED
    state x0 [K, Ipad]; returns the post-step history [n_steps, K, Ipad]
    (x0 NOT included). Backward is one more call.

    lowrank: None (auto: the low-rank step-Jacobian backward when K == 1,
    the trajectory-mode shape) | True (K != 1 raises at the backward) |
    False. bwd_precision: "highest"; "bf16" is not ported."""
    check_bwd_precision(bwd_precision)
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    return _FusedRKMultistepWide.apply(_consts(ws, solver, float(dt)),
                                       int(n_steps), lowrank, x0,
                                       c1p, w1p, c2p, w2p)


def wide_chain_adapter(chain, block: int = 128, multistep: bool = True,
                       solver: str = "tsit5",
                       bwd_precision: str = "highest"):
    """Build (ws, advance) for a 2-layer chain with a wide state:
    `advance(chain, x_unpadded, dt, n_steps)` runs n_steps fused wide RK
    steps on the chain's current parameters and returns the unpadded
    final state. multistep=True runs them in ONE kernel launch (fwd) +
    one (bwd); False loops over single-step kernels (one launch per
    step)."""
    check_bwd_precision(bwd_precision)
    spec = chain_spec_of(chain)
    if spec.out_dims != spec.in_dims:
        raise ValueError("wide adapter expects in_dims == out_dims")
    ws = WideSpec(spec, block)

    def advance(m, x, dt, n_steps):
        pp = ws.pad_params(*fused_params(m))
        xp = ws.pad_state(x)
        if multistep:
            ys = fused_rk_multistep_wide(ws, solver, dt, n_steps, xp, *pp,
                                         None, bwd_precision)
            return ys[-1][:, :ws.I]
        for _ in range(n_steps):
            xp = fused_rk_step_wide(ws, solver, dt, xp, *pp)
        return xp[:, :ws.I]

    return ws, advance
