"""Whole-RK-step kernel K5 for gray-box (hidden-physics) right-hand sides
(port of `kanodes_tpu/ops/graybox_fused.py`).

The source-recovery experiments integrate
    du/dt = D * known(u) + phi(u),     phi = pointwise 1->1 KDense
    phi(u) = W * swish(u) + sum_g C[g] * exp(-((norm(u) - z_g)/h)^2)
where known(u) is `u @ lap` for row states u [K, N] and a symmetric
dense [N, N] operator, or with `kron=True` the Kronecker-sum Laplacian
`lap @ U + U @ lap` of one 2-D field U [n, n] (lap the 1-D operator).
`fused_graybox_rk_step` runs every stage of one RK step as one kernel
launch (K5f, `csrc/graybox.cu`) and its discrete adjoint (du, dC, dW) as
one more (K5b); D and lap are known physics and get no cotangent.

Dispatch: a CUDA tensor launches the kernel or raises; a CPU tensor runs
the plain PyTorch version (`_phi`, `_phi_vjp`, `_known`, `_rhs`,
`_rhs_vjp` and the step loops below), exported for tests and
`chip_smoke.py` as `fused_graybox_rk_step_reference` (differentiable by
autograd) and `fused_graybox_rk_step_bwd_reference`. `LAUNCHES` counts
kernel launches. The adapters replace the JAX `lax.scan` over steps with
a Python loop of one launch per step.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from kanodes_tpu_torch.ode.tableaus import get_tableau
from kanodes_tpu_torch.ops import _cuda
from kanodes_tpu_torch.ops.kdense_pallas import (_dnorm, _dswish, _norm,
                                                 _swish)
from kanodes_tpu_torch.ops.rk_fused import _needed_stages, check_bwd_precision

Tensor = torch.Tensor

# kernel launches since the last reset_launch_counts(); each wrapper adds
# one where it launches its kernel, and nowhere else
LAUNCHES = {"fused_graybox_rk_step_fwd": 0, "fused_graybox_rk_step_bwd": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class GrayboxSpec:
    """Static config: 1->1 KDense (rbf) + symmetric dense operator."""

    def __init__(self, grid_len: int, normalizer: str = "softsign",
                 grid_lims=(-1.0, 1.0), denominator=None):
        self.G = grid_len
        self.normalizer = normalizer
        self.lims = grid_lims
        self.h = denominator if denominator is not None else \
            (grid_lims[1] - grid_lims[0]) / (grid_len - 1)
        self.centers = tuple(np.linspace(grid_lims[0], grid_lims[1],
                                         grid_len).tolist())

    @classmethod
    def of_layer(cls, layer) -> "GrayboxSpec":
        if (layer.in_dims, layer.out_dims) != (1, 1) or \
                layer.basis != "rbf" or not layer.use_base_act:
            raise ValueError("graybox kernel needs a 1->1 rbf KDense")
        return cls(layer.grid_len, layer.normalizer,
                   tuple(float(v) for v in layer.grid_lims),
                   layer.denominator)

    def key(self) -> tuple:
        """Everything the kernels' constants depend on (hashable)."""
        return (self.G, self.normalizer, self.h, self.centers)


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path; references for the kernels)
# ---------------------------------------------------------------------------

def _phi(spec, u, c, w):
    """Pointwise KAN on u; c [1, G], w a 0-d tensor."""
    un = _norm(u, spec.normalizer)
    y = w * _swish(u)
    inv_h = 1.0 / spec.h
    for g in range(spec.G):
        z = (un - spec.centers[g]) * inv_h
        y = y + c[0, g] * torch.exp(-(z * z))
    return y


def _phi_vjp(spec, u, c, w, gy):
    """Returns (du, dc [1, G], dw 0-d)."""
    un = _norm(u, spec.normalizer)
    inv_h = 1.0 / spec.h
    dun = torch.zeros_like(u)
    dcs = []
    for g in range(spec.G):
        z = (un - spec.centers[g]) * inv_h
        b = torch.exp(-(z * z))
        dcs.append(torch.sum(gy * b))
        dun = dun + c[0, g] * (-2.0 * z * inv_h) * b
    du = gy * dun * _dnorm(u, spec.normalizer) + w * gy * _dswish(u)
    dw = torch.sum(gy * _swish(u))
    return du, torch.stack(dcs).reshape(1, spec.G), dw


def _known(D, u, lap, kron):
    """The known linear operator: u @ lap for row states u [K, N], or
    lap @ U + U @ lap for one 2-D field (`kron`). Self-adjoint for the
    symmetric operators it is given, so the VJP reuses it."""
    if kron:
        return D * (lap @ u + u @ lap)
    return D * (u @ lap)


def _rhs(spec, D, u, lap, c, w, kron=False):
    return _known(D, u, lap, kron) + _phi(spec, u, c, w)


def _rhs_vjp(spec, D, u, lap, c, w, gy, kron=False):
    du_lin = _known(D, gy, lap, kron)    # operator self-adjoint
    du_phi, dc, dw = _phi_vjp(spec, u, c, w, gy)
    return du_lin + du_phi, dc, dw


class _Consts:
    """Tableau constants of one (solver, dt): dt*a_ij and dt*b_i folded in
    float64 and rounded to float32 (as JAX folds the Python-float
    products into the float32 kernel), which stages are needed, which
    get a cotangent in the reverse sweep, and each needed stage's slot."""

    def __init__(self, solver: str, dt: float):
        tab = get_tableau(solver)
        self.stages = tab.stages
        self.needed = _needed_stages(tab)
        self.dta = [[float(np.float32(dt * a)) for a in row] for row in tab.a]
        self.dtb = [float(np.float32(dt * b)) for b in tab.b]
        active = [False] * self.stages
        for i in range(self.stages - 1, -1, -1):
            active[i] = self.needed[i] and (
                self.dtb[i] != 0.0
                or any(active[j] and self.dta[j][i] != 0.0
                       for j in range(i + 1, self.stages)))
        self.active = active
        self.slot = [sum(self.needed[:i]) if self.needed[i] else 0
                     for i in range(self.stages)]
        self.n_slots = sum(self.needed)


@functools.lru_cache(maxsize=64)
def _consts(solver: str, dt: float) -> _Consts:
    return _Consts(solver, dt)


def _stages(k: _Consts, spec, D, u, lap, c, w, kron):
    """Stage inputs us and stage derivatives ks of the needed stages."""
    us, ks = [None] * k.stages, [None] * k.stages
    for i in range(k.stages):
        if not k.needed[i]:
            continue
        ui = u
        for j in range(i):
            if k.dta[i][j] != 0.0 and ks[j] is not None:
                ui = ui + k.dta[i][j] * ks[j]
        us[i] = ui
        ks[i] = _rhs(spec, D, ui, lap, c, w, kron)
    return us, ks


def _step_fwd_plain(k: _Consts, spec, D, u, lap, c, w, kron):
    _, ks = _stages(k, spec, D, u, lap, c, w[0, 0], kron)
    y = u
    for i in range(k.stages):
        if k.dtb[i] != 0.0:
            y = y + k.dtb[i] * ks[i]
    return y


def _step_bwd_plain(k: _Consts, spec, D, u, lap, c, w, gy, kron):
    w0 = w[0, 0]
    us, _ = _stages(k, spec, D, u, lap, c, w0, kron)
    ubar = gy
    kbar = [None] * k.stages
    for i in range(k.stages):
        if k.needed[i] and k.dtb[i] != 0.0:
            kbar[i] = k.dtb[i] * gy
    dc = torch.zeros_like(c)
    dw = torch.zeros((), dtype=w.dtype, device=w.device)
    for i in range(k.stages - 1, -1, -1):
        if not k.needed[i] or kbar[i] is None:
            continue
        dui, dci, dwi = _rhs_vjp(spec, D, us[i], lap, c, w0, kbar[i], kron)
        ubar = ubar + dui
        dc = dc + dci
        dw = dw + dwi
        for j in range(i):
            if k.dta[i][j] != 0.0 and k.needed[j]:
                contrib = k.dta[i][j] * dui
                kbar[j] = contrib if kbar[j] is None else kbar[j] + contrib
    return ubar, dc, dw.reshape(1, 1)


def fused_graybox_rk_step_reference(spec: GrayboxSpec, solver: str,
                                    dt: float, D: float, u, lap, c, w,
                                    kron: bool = False):
    """Plain PyTorch version of K5f (differentiable by autograd)."""
    return _step_fwd_plain(_consts(solver, float(dt)), spec, float(D), u,
                           lap, c, w, kron)


def fused_graybox_rk_step_bwd_reference(spec: GrayboxSpec, solver: str,
                                        dt: float, D: float, u, lap, c, w,
                                        gy, kron: bool = False):
    """Plain PyTorch version of K5b: (du, dc [1, G], dw [1, 1])."""
    return _step_bwd_plain(_consts(solver, float(dt)), spec, float(D), u,
                           lap, c, w, gy, kron)


# ---------------------------------------------------------------------------
# CUDA launch wrappers
# ---------------------------------------------------------------------------

class GrayTab(ctypes.Structure):
    """Mirror of `struct GrayTab` in csrc/graybox.cu."""
    _S = _cuda.MAX_GB_STAGES
    _fields_ = [("stages", ctypes.c_int), ("n_slots", ctypes.c_int),
                ("a", (ctypes.c_float * _S) * _S),
                ("b", ctypes.c_float * _S),
                ("needed", ctypes.c_int * _S),
                ("active", ctypes.c_int * _S),
                ("slot", ctypes.c_int * _S),
                ("nodes", ctypes.c_int), ("N", ctypes.c_int),
                ("kron", ctypes.c_int), ("G", ctypes.c_int),
                ("normalizer", ctypes.c_int),
                ("D", ctypes.c_float), ("inv_h", ctypes.c_float),
                ("centers", ctypes.c_float * _cuda.MAX_GB_G)]


@functools.lru_cache(maxsize=64)
def _gray_tab(spec_key: tuple, solver: str, dt: float, D: float,
              kron: bool, nodes: int, N: int) -> GrayTab:
    """The kernels' GrayTab: tableau and spec constants folded in float64
    and rounded to float32 (ctypes rounds on assignment)."""
    G, normalizer, h, centers = spec_key
    k = _consts(solver, dt)
    t = GrayTab()
    t.stages, t.n_slots = k.stages, k.n_slots
    for i, row in enumerate(k.dta):
        t.a[i][:len(row)] = row
    t.b[:k.stages] = k.dtb
    t.needed[:k.stages] = [int(v) for v in k.needed]
    t.active[:k.stages] = [int(v) for v in k.active]
    t.slot[:k.stages] = k.slot
    t.nodes, t.N, t.kron, t.G = nodes, N, int(kron), G
    t.normalizer = _cuda._NORMALIZERS[normalizer]
    t.D, t.inv_h = float(np.float32(D)), float(np.float32(1.0 / h))
    t.centers[:G] = [float(np.float32(z)) for z in centers]
    return t


def check_graybox_launch(spec: GrayboxSpec, u, lap, c, w, kron) -> tuple:
    """Validate a K5 launch against the kernels' contract and caps;
    returns (nodes, N)."""
    if spec.G > _cuda.MAX_GB_G or spec.normalizer not in _cuda._NORMALIZERS:
        raise ValueError(f"kernel caps: G <= {_cuda.MAX_GB_G} and a "
                         f"tanh/softsign normalizer; got G={spec.G}, "
                         f"{spec.normalizer!r}")
    if u.dim() != 2:
        raise ValueError(f"u: shape {tuple(u.shape)} is not 2-D")
    N = u.shape[1]
    if kron and u.shape[0] != N:
        raise ValueError(f"kron: the field must be square, got "
                         f"{tuple(u.shape)}")
    nodes = u.shape[0] * N
    if not (1 <= nodes <= _cuda.MAX_GB_NODES and N <= _cuda.MAX_GB_N):
        raise ValueError(f"kernel caps: K*N (n*n with kron) <= "
                         f"{_cuda.MAX_GB_NODES} nodes and N <= "
                         f"{_cuda.MAX_GB_N}; got u {tuple(u.shape)}")
    for name, p, shape in (("lap", lap, (N, N)), ("c", c, (1, spec.G)),
                           ("w", w, (1, 1))):
        if tuple(p.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(p.shape)} != {shape}")
    _cuda.check_tensors(u, lap, c, w)
    return nodes, N


def _launch_fwd(spec, solver, dt, D, u, lap, c, w, kron):
    nodes, N = check_graybox_launch(spec, u, lap, c, w, kron)
    y = torch.empty_like(u)
    tab = _gray_tab(spec.key(), solver, dt, D, kron, nodes, N)
    lib = _cuda.library()
    with torch.cuda.device(u.device):
        err = lib.gb_step_fwd(_cuda.ptr(u), _cuda.ptr(lap), _cuda.ptr(c),
                              _cuda.ptr(w), _cuda.ptr(y), ctypes.byref(tab),
                              _cuda.stream())
    LAUNCHES["fused_graybox_rk_step_fwd"] += 1
    _cuda.check(err, "fused_graybox_rk_step_fwd")
    return y


def _launch_bwd(spec, solver, dt, D, u, lap, c, w, gy, kron):
    nodes, N = check_graybox_launch(spec, u, lap, c, w, kron)
    gy = gy.contiguous()
    if gy.shape != u.shape:
        raise ValueError(f"gy: shape {tuple(gy.shape)} != "
                         f"{tuple(u.shape)}")
    _cuda.check_tensors(gy)
    du, dc, dw = (torch.empty_like(t) for t in (u, c, w))
    tab = _gray_tab(spec.key(), solver, dt, D, kron, nodes, N)
    lib = _cuda.library()
    with torch.cuda.device(u.device):
        err = lib.gb_step_bwd(_cuda.ptr(u), _cuda.ptr(lap), _cuda.ptr(c),
                              _cuda.ptr(w), _cuda.ptr(gy), _cuda.ptr(du),
                              _cuda.ptr(dc), _cuda.ptr(dw), ctypes.byref(tab),
                              _cuda.stream())
    LAUNCHES["fused_graybox_rk_step_bwd"] += 1
    _cuda.check(err, "fused_graybox_rk_step_bwd")
    return du, dc, dw


class _FusedGrayboxStep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, solver, dt, D, kron, u, lap, c, w):
        ctx.static = (spec, solver, dt, D, kron)
        ctx.save_for_backward(u, lap, c, w)
        if _cuda.on_cuda(u, lap, c, w):
            return _launch_fwd(spec, solver, dt, D, u, lap, c, w, kron)
        return fused_graybox_rk_step_reference(spec, solver, dt, D, u, lap,
                                               c, w, kron)

    @staticmethod
    def backward(ctx, gy):
        u, lap, c, w = ctx.saved_tensors
        spec, solver, dt, D, kron = ctx.static
        if _cuda.on_cuda(gy, u, lap, c, w):
            du, dc, dw = _launch_bwd(spec, solver, dt, D, u, lap, c, w, gy,
                                     kron)
        else:
            du, dc, dw = fused_graybox_rk_step_bwd_reference(
                spec, solver, dt, D, u, lap, c, w, gy, kron)
        # D and lap are known physics: no cotangent
        return None, None, None, None, None, du, None, dc, dw


def fused_graybox_rk_step(spec: GrayboxSpec, solver: str, dt: float,
                          D: float, u, lap, c, w,
                          bwd_precision: str = "highest",
                          kron: bool = False):
    """One whole RK step of du/dt = D*known(u) + phi(u) as ONE kernel.

    u: [K, N]; lap: [N, N] SYMMETRIC dense operator; c: [1, G] KAN
    spline coefficients; w: [1, 1] residual weight. kron=True instead
    takes the 2-D field u=[n, n] with lap=[n, n] the 1-D operator and
    applies the Kronecker-sum Laplacian as lap@U + U@lap. Differentiable
    w.r.t. u, c, w (D and lap are known physics). bwd_precision:
    "highest" only ("bf16" is not ported yet)."""
    check_bwd_precision(bwd_precision)
    return _FusedGrayboxStep.apply(spec, solver, float(dt), float(D),
                                   bool(kron), u, lap, c, w)


def _operator(lap, like: Tensor) -> Tensor:
    """The operator (numpy or tensor) as float32 on `like`'s device."""
    return torch.as_tensor(lap, dtype=torch.float32,
                           device=like.device).contiguous()


def graybox_kernel_adapter(layer, lap, D: float,
                           bwd_precision: str = "highest"):
    """Build advance(params, u [N], dt, n_steps) -> [n_steps+1, N] for a
    1->1 KDense gray-box RHS; params maps "C" and "W" to the layer's
    tensors (e.g. `dict(layer.named_parameters())`). One launch a step."""
    spec = GrayboxSpec.of_layer(layer)
    check_bwd_precision(bwd_precision)
    lap = _operator(lap, layer.C)

    def advance(params, u, dt, n_steps):
        c = params["C"].reshape(1, spec.G)
        w = params["W"].reshape(1, 1)
        x = u[None, :]
        ys = [x]
        for _ in range(n_steps):
            x = fused_graybox_rk_step(spec, "tsit5", dt, D, x, lap, c, w,
                                      bwd_precision)
            ys.append(x)
        return torch.cat(ys, dim=0)

    return spec, advance


def graybox_kron_kernel_adapter(layer, lap1, D: float,
                                bwd_precision: str = "highest"):
    """Build advance(params, U [n, n], dt, n_steps) -> [n_steps+1, n, n]
    for the 2-D gray-box RHS D*lap2d(U) + phi.(U), the Kronecker-sum
    Laplacian factored inside the kernel as L@U + U@L."""
    spec = GrayboxSpec.of_layer(layer)
    check_bwd_precision(bwd_precision)
    lap1 = _operator(lap1, layer.C)

    def advance(params, U, dt, n_steps):
        c = params["C"].reshape(1, spec.G)
        w = params["W"].reshape(1, 1)
        ys = [U]
        for _ in range(n_steps):
            U = fused_graybox_rk_step(spec, "tsit5", dt, D, U, lap1, c, w,
                                      bwd_precision, True)
            ys.append(U)
        return torch.stack(ys, dim=0)

    return spec, advance
