"""The 2-layer KDense chain and its fused kernel K1 (port of
`kanodes_tpu/ops/kdense_pallas.py`).

`ChainSpec` describes a fusable chain (local basis, swish residual,
tanh/softsign normalizer, one shared grid); `fused_params` views the
chain's parameters as the 2-D blocks the kernels take: `c1 [I*G, H]`,
`w1 [I, H]`, `c2 [H*G, O]`, `w2 [H, O]`, rows `i*G+g`.

`_layer_fwd` / `_layer_bwd` are the per-layer math in plain torch, and
`_chain_f` / `_chain_vjp` the chain built from them: the CPU path and
the plain versions of every kernel of `csrc/` are made of these, and
`csrc/kan_chain.cuh` computes the same per row. The basis is indexed
`[K, I, G]` directly; the JAX kernels' 0/1 expand/collapse GEMMs exist
only because Mosaic cannot reshape, and are not ported.

`kan_chain_apply` is the chain x[K, I] -> [K, O] as one kernel launch
(K1f, `csrc/kan_chain_apply.cu`) with its VJP as one more (K1b; its
parameter sums a second launch counted with it, but at K = 1 in the
small flavor), in the flavor
`_cuda.chain_apply_flavor` picks: a warp a row within kan_chain.cuh's
caps, a block a row past them (counted under `..._mid`). A CUDA tensor
launches the kernel or raises; a CPU tensor runs the plain version
(`kan_chain_apply_reference`, `kan_chain_apply_bwd_reference`).
`kan_chain_rhs` makes it the right-hand side of an ODE (`impl="pallas"`).

`kdense_single_apply` is one KDense layer x[K, I] -> [K, O] as one
launch (K9f, `csrc/kdense_single.cu`: tiled products planned by
`_cuda.single_plan`, at any width) with its VJP (dx, dc, dw) as one more
(K9b); `kdense_pallas` is what `KDense.apply(impl="pallas")` calls.
Like the JAX kernel it computes the rbf basis whatever `spec.basis` says
(`kdense_pallas.py:346-350` never passes it on), and `kdense_pallas`
takes rbf layers only. `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from kanodes_tpu_torch.ops import _cuda

Tensor = torch.Tensor

# kernel launches since the last reset_launch_counts(); each wrapper adds
# one where it launches its kernel, and nowhere else
LAUNCHES = {"kan_chain_apply_fwd": 0, "kan_chain_apply_bwd": 0,
            "kan_chain_apply_fwd_mid": 0, "kan_chain_apply_bwd_mid": 0,
            "kdense_single_apply_fwd": 0, "kdense_single_apply_bwd": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class ChainSpec:
    """Static description of a 2-layer KDense chain (local basis, swish
    base act, tanh or softsign normalizer)."""
    in_dims: int
    hidden: int
    out_dims: int
    grid_len: int
    grid_lims: tuple[float, float] = (-1.0, 1.0)
    denominator: float | None = None
    normalizer: str = "tanh"
    basis: str = "rbf"                 # rbf | iqf | rswaf (local bases)

    @property
    def h(self) -> float:
        if self.denominator is not None:
            return self.denominator
        return (self.grid_lims[1] - self.grid_lims[0]) / (self.grid_len - 1)

    def grid(self) -> np.ndarray:
        """The G basis centers, float32 as the JAX kernels get them."""
        return np.linspace(self.grid_lims[0], self.grid_lims[1],
                           self.grid_len, dtype=np.float32)


def _norm(x, kind: str):
    if kind == "tanh":
        return torch.tanh(x)
    if kind == "softsign":
        return x / (1.0 + torch.abs(x))
    raise ValueError(kind)


def _dnorm(x, kind: str):
    if kind == "tanh":
        t = torch.tanh(x)
        return 1.0 - t * t
    if kind == "softsign":
        d = 1.0 + torch.abs(x)
        return 1.0 / (d * d)
    raise ValueError(kind)


def _basis_val(u, kind: str):
    """B(u) on the normalized distance u, for the three local bases."""
    if kind == "rbf":
        return torch.exp(-(u * u))
    if kind == "iqf":
        return 1.0 / (1.0 + u * u)
    if kind == "rswaf":
        t = torch.tanh(u)
        return 1.0 - t * t
    raise ValueError(kind)


def _basis_du(u, B, kind: str):
    """dB/du given the already-computed B."""
    if kind == "rbf":
        return -2.0 * u * B
    if kind == "iqf":
        return -2.0 * u * B * B
    if kind == "rswaf":
        return -2.0 * torch.tanh(u) * B
    raise ValueError(kind)


def _swish(x):
    return x * torch.sigmoid(x)


def _dswish(x):
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def _layer_fwd(x, c, w, grid, h, normalizer="tanh", basis_kind="rbf"):
    """One KDense layer: x[K,I], c[I*G,O], w[I,O], grid[G].
    Returns (y [K,O], u [K,I,G], basis [K,I*G])."""
    u = (_norm(x, normalizer)[:, :, None] - grid) * (1.0 / h)
    basis = _basis_val(u, basis_kind).reshape(x.shape[0], -1)
    y = basis @ c + _swish(x) @ w
    return y, u, basis


def _layer_bwd(x, c, w, h, u, basis, gy, normalizer="tanh",
               basis_kind="rbf"):
    """Backward of one layer for the cotangent gy [K,O].
    Returns (dx [K,I], dc [I*G,O], dw [I,O])."""
    dc = basis.T @ gy
    dw = _swish(x).T @ gy
    m = (gy @ c.T).reshape(u.shape)
    du = _basis_du(u, basis.reshape(u.shape), basis_kind)
    dxn = (m * du * (1.0 / h)).sum(-1)
    dx = dxn * _dnorm(x, normalizer) + (gy @ w.T) * _dswish(x)
    return dx, dc, dw


def _chain_f(x, c1, w1, c2, w2, grid, spec: ChainSpec):
    """The chain on x [K, I]: (y [K, O], y1 [K, H] = layer 1's output)."""
    y1, _, _ = _layer_fwd(x, c1, w1, grid, spec.h, spec.normalizer,
                          spec.basis)
    y2, _, _ = _layer_fwd(y1, c2, w2, grid, spec.h, spec.normalizer,
                          spec.basis)
    return y2, y1


def _chain_vjp(x, y1, c1, w1, c2, w2, grid, spec: ChainSpec, gy):
    """VJP of the chain at x (y1 = layer 1's output) for the cotangent
    gy [K, O], recomputing both bases: (dx, dc1, dw1, dc2, dw2)."""
    _, u2, b2 = _layer_fwd(y1, c2, w2, grid, spec.h, spec.normalizer,
                           spec.basis)
    dy1, dc2, dw2 = _layer_bwd(y1, c2, w2, spec.h, u2, b2, gy,
                               spec.normalizer, spec.basis)
    _, u1, b1 = _layer_fwd(x, c1, w1, grid, spec.h, spec.normalizer,
                           spec.basis)
    dx, dc1, dw1 = _layer_bwd(x, c1, w1, spec.h, u1, b1, dy1,
                              spec.normalizer, spec.basis)
    return dx, dc1, dw1, dc2, dw2


def grid_of(spec: ChainSpec, like: Tensor) -> Tensor:
    """The basis centers as a float32 tensor on `like`'s device."""
    return torch.as_tensor(spec.grid(), device=like.device)


def kan_chain_apply_reference(spec: ChainSpec, x, c1, w1, c2, w2):
    """Plain PyTorch version of K1f: (y [K, O], y1 [K, H]);
    differentiable by autograd through its ops."""
    return _chain_f(x, c1, w1, c2, w2, grid_of(spec, x), spec)


def kan_chain_apply_bwd_reference(spec: ChainSpec, x, y1, c1, w1, c2, w2,
                                  gy):
    """Plain PyTorch version of K1b: (dx, dc1, dw1, dc2, dw2)."""
    return _chain_vjp(x, y1, c1, w1, c2, w2, grid_of(spec, x), spec, gy)


# ---------------------------------------------------------------------------
# CUDA launch wrappers of K1
# ---------------------------------------------------------------------------

def check_chain_launch(spec: ChainSpec, x, params, n_leading: int = 0,
                       caps: bool = True) -> int:
    """Validate a launch of a chain kernel: K1's caps, those of either of
    its flavors (`_cuda.chain_apply_flavor`; unless the caller has checked
    its own: `caps=False`), x [..., K, I] with `n_leading` leading axes,
    the four parameter shapes, float32, contiguous. Returns K."""
    I, H, O, G = spec.in_dims, spec.hidden, spec.out_dims, spec.grid_len
    if caps:
        _cuda.chain_apply_flavor(spec)
    if x.dim() != n_leading + 2 or x.shape[-1] != I or x.shape[-2] < 1:
        raise ValueError(f"state shape {tuple(x.shape)} does not end in "
                         f"[K, {I}]")
    want = ((I * G, H), (I, H), (H * G, O), (H, O))
    for name, p, shape in zip(("c1", "w1", "c2", "w2"), params, want):
        if tuple(p.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(p.shape)} != {shape}")
    _cuda.check_tensors(x, *params)
    return x.shape[-2]


def _count(spec: ChainSpec, name: str) -> None:
    """Count a K1 launch under its flavor's key (`..._mid`: a block a
    row)."""
    medium = _cuda.chain_apply_flavor(spec) == "medium"
    LAUNCHES[name + "_mid" if medium else name] += 1


def _launch_fwd(spec: ChainSpec, x, params):
    K = check_chain_launch(spec, x, params)
    y = torch.empty((K, spec.out_dims), dtype=torch.float32, device=x.device)
    y1 = torch.empty((K, spec.hidden), dtype=torch.float32, device=x.device)
    lib = _cuda.library()
    with torch.cuda.device(x.device):
        err = lib.kc_chain_apply_fwd(_cuda.ptr(x), *map(_cuda.ptr, params),
                                     _cuda.ptr(y), _cuda.ptr(y1), K,
                                     ctypes.byref(_cuda.chain_dims(spec)),
                                     _cuda.stream())
    _count(spec, "kan_chain_apply_fwd")
    _cuda.check(err, "kan_chain_apply_fwd")
    return y, y1


def _launch_bwd(spec: ChainSpec, x, y1, params, gy, direct=None):
    """K1b: in the small flavor at K = 1 (`direct`, the default there) the
    cotangents are the one record's outer products, written in the same
    launch; else the K records go to a scratch and the parameter sums are
    a second launch, counted with the first."""
    K = check_chain_launch(spec, x, params)
    if tuple(y1.shape) != (K, spec.hidden) or \
            tuple(gy.shape) != (K, spec.out_dims):
        raise ValueError(f"y1/gy shapes {tuple(y1.shape)}, "
                         f"{tuple(gy.shape)} != [{K}, H], [{K}, O]")
    _cuda.check_tensors(y1, gy)
    small = _cuda.chain_apply_flavor(spec) == "small"
    direct = K == 1 and small if direct is None else direct
    if direct and not (K == 1 and small):
        raise ValueError(f"cotangents in the launch need K = 1 and the "
                         f"small flavor, got K={K}")
    dx = torch.empty_like(x)
    grads = [torch.empty_like(p) for p in params]
    scratch = None if direct else torch.empty(
        K * _cuda.rec_width(spec), dtype=torch.float32, device=x.device)
    lib = _cuda.library()
    with torch.cuda.device(x.device):
        err = lib.kc_chain_apply_bwd(
            _cuda.ptr(x), _cuda.ptr(y1), _cuda.ptr(gy),
            *map(_cuda.ptr, params), _cuda.ptr(dx), *map(_cuda.ptr, grads),
            None if scratch is None else _cuda.ptr(scratch), K, int(direct),
            ctypes.byref(_cuda.chain_dims(spec)), _cuda.stream())
    _count(spec, "kan_chain_apply_bwd")
    _cuda.check(err, "kan_chain_apply_bwd")
    return (dx, *grads)


class _KanChainApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, x, c1, w1, c2, w2):
        params = (c1, w1, c2, w2)
        if _cuda.on_cuda(x, *params):
            y, y1 = _launch_fwd(spec, x, params)
        else:
            y, y1 = _chain_f(x, *params, grid_of(spec, x), spec)
        ctx.spec = spec
        ctx.save_for_backward(x, y1, *params)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, y1, *params = ctx.saved_tensors
        spec = ctx.spec
        gy = gy.contiguous()
        if _cuda.on_cuda(gy, x, *params):
            grads = _launch_bwd(spec, x, y1, params, gy)
        else:
            grads = _chain_vjp(x, y1, *params, grid_of(spec, x), spec, gy)
        return (None, *grads)


def kan_chain_apply(spec: ChainSpec, x, c1, w1, c2, w2):
    """Fused 2-layer KDense chain: x[K, I] -> [K, O] in one launch, its
    VJP (dx and the four parameter cotangents) in one more.

    c1: [I*G, H], w1: [I, H], c2: [H*G, O], w2: [H, O] (2-D, i-major
    g-minor rows: `fused_params` of a `KANChain`)."""
    return _KanChainApply.apply(spec, x, c1, w1, c2, w2)


def chain_spec_of(chain) -> ChainSpec:
    """Build a ChainSpec from a 2-layer KANChain (validates fusability)."""
    if len(chain.layers) != 2:
        raise ValueError("fused path supports exactly 2 layers")
    l1, l2 = chain.layers
    for l in (l1, l2):
        if l.basis not in ("rbf", "iqf", "rswaf") or \
                (l.base_act, l.use_base_act) != ("swish", True) or \
                l.normalizer not in ("tanh", "softsign"):
            raise ValueError("fused path requires a local basis "
                             "(rbf/iqf/rswaf), swish base act, and a "
                             "tanh/softsign normalizer")
        if l.grid_len != l1.grid_len or l.grid_lims != l1.grid_lims \
                or l.normalizer != l1.normalizer or l.basis != l1.basis:
            raise ValueError("fused path requires shared "
                             "grid/normalizer/basis")
    return ChainSpec(l1.in_dims, l1.out_dims, l2.out_dims, l1.grid_len,
                     tuple(float(v) for v in l1.grid_lims),
                     l1.denominator, l1.normalizer, l1.basis)


def fused_params(chain) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """(c1, w1, c2, w2): the chain's `C` [I,G,O] viewed as [I*G, O]
    (a contiguous view, so gradients reach `C`), and `W` as it is."""
    l1, l2 = chain.layers
    return (l1.C.reshape(-1, l1.C.shape[-1]), l1.W,
            l2.C.reshape(-1, l2.C.shape[-1]), l2.W)


def kan_chain_rhs(chain):
    """rhs(t, u, model) through `kan_chain_apply`, for u [K, I] or [I]
    (a single state gets a row axis for the call and loses it after)."""
    spec = chain_spec_of(chain)

    def rhs(t, u, m):
        single = u.dim() == 1
        x = (u[None, :] if single else u).contiguous()
        y = kan_chain_apply(spec, x, *fused_params(m))
        return y[0] if single else y

    return rhs


# ---------------------------------------------------------------------------
# the single-layer kernel K9 (KDense.apply(impl="pallas"))
# ---------------------------------------------------------------------------

def _single_spec(spec: ChainSpec) -> ChainSpec:
    """The spec the layer math runs with: rbf, as the JAX kernel (its
    `_single_fwd_kernel` calls `_layer_fwd` without `spec.basis`)."""
    return dataclasses.replace(spec, basis="rbf")


def kdense_single_apply_reference(spec: ChainSpec, x, c, w):
    """Plain PyTorch version of K9f: y [K, O]; differentiable by autograd
    through its ops."""
    y, _, _ = _layer_fwd(x, c, w, grid_of(spec, x), spec.h, spec.normalizer)
    return y


def kdense_single_apply_bwd_reference(spec: ChainSpec, x, c, w, gy):
    """Plain PyTorch version of K9b: (dx, dc, dw), the basis recomputed."""
    _, u, b = _layer_fwd(x, c, w, grid_of(spec, x), spec.h, spec.normalizer)
    return _layer_bwd(x, c, w, spec.h, u, b, gy, spec.normalizer)


def check_single_launch(spec: ChainSpec, x, c, w) -> int:
    """Validate a K9 launch: caps (2 <= G <= MAX_G, every array under 2^31
    elements, the features I (G + 1) under 2^22), x [K, I], c [I*G, O],
    w [I, O], float32, contiguous. Returns K."""
    I, O, G = spec.in_dims, spec.out_dims, spec.grid_len
    if not 2 <= G <= _cuda.MAX_G:
        raise ValueError(f"kernel caps: 2 <= G <= {_cuda.MAX_G}; got G={G}")
    if x.dim() != 2 or x.shape[1] != I or x.shape[0] < 1:
        raise ValueError(f"x: shape {tuple(x.shape)} is not [K, {I}]")
    if max(x.shape[0] * max(I, O), I * (G + 1) * O) >= 2 ** 31 \
            or I * (G + 1) >= 2 ** 22:
        raise ValueError(f"kernel caps: every array under 2^31 elements, "
                         f"I (G + 1) under 2^22; got K={x.shape[0]}, I={I}, "
                         f"O={O}, G={G}")
    for name, p, shape in (("c", c, (I * G, O)), ("w", w, (I, O))):
        if tuple(p.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(p.shape)} != {shape}")
    _cuda.check_tensors(x, c, w)
    return x.shape[0]


def _single_plan(spec: ChainSpec, K: int, *bases) -> _cuda.SinglePlan:
    """K9's plan; its Q copies are vectorised where every base is 16-byte
    aligned."""
    return _cuda.single_plan(K, spec.in_dims, spec.out_dims, spec.grid_len,
                             all(t.data_ptr() % 16 == 0 for t in bases))


def _launch_single_fwd(spec: ChainSpec, x, c, w):
    K = check_single_launch(spec, x, c, w)
    plan = _single_plan(spec, K, c, w)
    y = torch.empty((K, spec.out_dims), dtype=torch.float32, device=x.device)
    lib = _cuda.library()
    with torch.cuda.device(x.device):
        err = lib.kd_single_fwd(_cuda.ptr(x), _cuda.ptr(c), _cuda.ptr(w),
                                _cuda.ptr(y), K,
                                ctypes.byref(_cuda.chain_dims(spec)),
                                ctypes.byref(plan.fwd), plan.fwd_cluster,
                                _cuda.stream())
    LAUNCHES["kdense_single_apply_fwd"] += 1
    _cuda.check(err, "kdense_single_apply_fwd")
    return y


def _launch_single_bwd(spec: ChainSpec, x, c, w, gy):
    """K9b: dx's product and the parameter cotangents' as the two halves
    of one kernel's blocks."""
    K = check_single_launch(spec, x, c, w)
    if tuple(gy.shape) != (K, spec.out_dims):
        raise ValueError(f"gy: shape {tuple(gy.shape)} != "
                         f"{(K, spec.out_dims)}")
    _cuda.check_tensors(gy)
    plan = _single_plan(spec, K, gy)
    dx, dc, dw = (torch.empty_like(t) for t in (x, c, w))
    lib = _cuda.library()
    with torch.cuda.device(x.device):
        err = lib.kd_single_bwd(
            _cuda.ptr(x), _cuda.ptr(gy), _cuda.ptr(c), _cuda.ptr(w),
            _cuda.ptr(dx), _cuda.ptr(dc), _cuda.ptr(dw), K,
            ctypes.byref(_cuda.chain_dims(spec)), ctypes.byref(plan.dx),
            ctypes.byref(plan.db), plan.bwd_cluster, _cuda.stream())
    LAUNCHES["kdense_single_apply_bwd"] += 1
    _cuda.check(err, "kdense_single_apply_bwd")
    return dx, dc, dw


class _KDenseSingleApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, x, c, w):
        ctx.spec = spec
        ctx.save_for_backward(x, c, w)
        if _cuda.on_cuda(x, c, w):
            return _launch_single_fwd(spec, x, c, w)
        return kdense_single_apply_reference(spec, x, c, w)

    @staticmethod
    def backward(ctx, gy):
        x, c, w = ctx.saved_tensors
        gy = gy.contiguous()
        if _cuda.on_cuda(gy, x, c, w):
            grads = _launch_single_bwd(ctx.spec, x, c, w, gy)
        else:
            grads = kdense_single_apply_bwd_reference(ctx.spec, x, c, w, gy)
        return (None, *grads)


def kdense_single_apply(spec: ChainSpec, x, c, w):
    """Fused single KDense layer: x[K, I] -> [K, O] with c[I*G, O],
    w[I, O], in one launch, its VJP (dx, dc, dw) in one more.
    `spec.hidden` is the layer's out_dims here; the basis is rbf."""
    return _KDenseSingleApply.apply(_single_spec(spec), x, c, w)


def kdense_pallas(layer, x):
    """Dispatch target of `KDense.apply(x, impl="pallas")`: x [..., I] ->
    [..., O] through `kdense_single_apply`."""
    if (layer.basis, layer.base_act, layer.use_base_act) != \
            ("rbf", "swish", True) or \
            layer.normalizer not in ("tanh", "softsign"):
        raise ValueError("fused path requires rbf basis, swish base act, "
                         "and a tanh/softsign normalizer")
    spec = ChainSpec(layer.in_dims, layer.out_dims, layer.out_dims,
                     layer.grid_len,
                     tuple(float(v) for v in layer.grid_lims),
                     layer.denominator, layer.normalizer)
    c = layer.C.reshape(-1, layer.C.shape[-1])
    x2 = x.reshape(-1, layer.in_dims).contiguous()
    y = kdense_single_apply(spec, x2, c, layer.W)
    return y.reshape(*x.shape[:-1], layer.out_dims)
