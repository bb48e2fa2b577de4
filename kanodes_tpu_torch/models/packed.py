"""Packed (block-diagonal) KAN ensembles: S replicas as ONE wider chain
(port of `kanodes_tpu/models/packed.py`).

A KDense output is a sum over input edges of per-edge functions of a
single input, so with C and W zero outside the member-diagonal blocks
member s's outputs depend only on member s's inputs: the packed chain
[S*I, S*H, S*O] computes S independent forwards at once, the member
axis riding the width. The packed state is member-major: member s owns
the columns [s*d, (s+1)*d).

Gradient isolation: `apply_mask` registers the 0/1 block mask as a
parametrization of every `C` and `W` of the packed chain, so every
consumer of the weights (`KANChain.apply`, `ops.kdense_pallas.
fused_params` and `kan_chain_rhs`, the fused kernels) reads mask * param,
off-block gradients are exactly zero, and Adam never moves off-block
entries from zero. It is the JAX package's "multiply by the mask inside
the loss", made a property of the model.

Adaptive solves of a packed state go through one controller per member
(`ode/integrate.odeint_members`, `ops/rk_adaptive_fused.
fused_adaptive_members_odeint`); `experiments/lv.make_ode_fns` routes
there when given `reduce_fn` and `n_members`.

`member_ids` and `member_lr_scales` give the per-entry member index and
learning-rate factor trees of the packed parameters (the packed L-BFGS,
`train/packed_polish.py`, and `train(lr_scales=)`). `HeteroPacked` packs
members of DIFFERENT hidden widths and grid sizes (the Fig-3C trend
sweep, `experiments/sweep.packed_trend_sweep`) as one chain of
`HeteroKDense` layers with per-input-row grids and bandwidths; it runs
the plain path only (per-row grids are outside the fused kernels'
shared-grid contract).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

from kanodes_tpu_torch.models.kdense import KANChain, KDense
from kanodes_tpu_torch.ops import basis as B

Tensor = torch.Tensor


def _check(chain: KANChain) -> None:
    for l in chain.layers:
        if not isinstance(l, KDense):
            raise ValueError("packing supports KDense chains only")
        if l.trainable_grid:
            raise ValueError("a packed layer shares one grid; "
                             "trainable_grid would couple members")


def _ones(chain: KANChain, value: float = 1.0) -> list[dict]:
    """Per-layer `{"C", "W"}` of a member chain's shapes, all `value`
    (no `W` for a layer without the base activation)."""
    out = []
    for l in chain.layers:
        p = {"C": torch.full((l.in_dims, l.grid_len, l.out_dims), value)}
        if l.use_base_act:
            p["W"] = torch.full((l.in_dims, l.out_dims), value)
        out.append(p)
    return out


def _device(chain: KANChain) -> torch.device:
    return chain.layers[0].grid_pts.device


def _f32(v) -> Tensor:
    """A tensor or an array (a JAX one, say) as a float32 tensor."""
    if isinstance(v, Tensor):
        return v.float()
    return torch.tensor(np.asarray(v, dtype=np.float32))


def pack_chain(chain: KANChain, n_members: int) -> KANChain:
    """The S-member packed chain: every layer's in/out dims scaled by S
    (grid, basis and normalizer unchanged: they act per input), with zero
    parameters on `chain`'s device."""
    _check(chain)
    return KANChain(*[
        KDense(n_members * l.in_dims, n_members * l.out_dims, l.grid_len,
               normalizer=l.normalizer, grid_lims=l.grid_lims,
               denominator=l.denominator, basis=l.basis,
               base_act=l.base_act, use_base_act=l.use_base_act,
               device=_device(chain))
        for l in chain.layers])


def pack_params(chain: KANChain, member_params: list) -> list[dict]:
    """Block-diagonal packed params from S per-member param lists.

    `member_params`: S lists of per-layer `{"C", "W"}` (tensors or numpy
    arrays, e.g. JAX inits). Returns per layer `{"C": [S*I, G, S*O], "W":
    [S*I, S*O]}` float32 tensors on `chain`'s device (no `W` without the
    base activation), member s in the block (s*I:(s+1)*I, s*O:(s+1)*O),
    exact zeros elsewhere."""
    _check(chain)
    S, dev = len(member_params), _device(chain)
    packed = []
    for li, l in enumerate(chain.layers):
        I, G, O = l.in_dims, l.grid_len, l.out_dims
        C = torch.zeros((S * I, G, S * O), device=dev)
        for s, mp in enumerate(member_params):
            C[s * I:(s + 1) * I, :, s * O:(s + 1) * O] = _f32(mp[li]["C"])
        p = {"C": C}
        if l.use_base_act:
            W = torch.zeros((S * I, S * O), device=dev)
            for s, mp in enumerate(member_params):
                W[s * I:(s + 1) * I, s * O:(s + 1) * O] = _f32(mp[li]["W"])
            p["W"] = W
        packed.append(p)
    return packed


def extract_member(chain: KANChain, packed_params: list, n_members: int,
                   member: int) -> list[dict]:
    """Member `member`'s original-shape params out of packed per-layer
    `{"C", "W"}` (tensors or numpy arrays; `chain` is the member chain)."""
    _check(chain)
    out = []
    for li, l in enumerate(chain.layers):
        sI, sO = member * l.in_dims, member * l.out_dims
        p = packed_params[li]
        m = {"C": p["C"][sI:sI + l.in_dims, :, sO:sO + l.out_dims]}
        if l.use_base_act:
            m["W"] = p["W"][sI:sI + l.in_dims, sO:sO + l.out_dims]
        out.append(m)
    return out


def block_mask(chain: KANChain, n_members: int) -> list[dict]:
    """The 0/1 block-diagonal mask with the packed params' structure."""
    _check(chain)
    return pack_params(chain, [_ones(chain)] * n_members)


def member_ids(chain: KANChain, n_members: int) -> list[dict]:
    """Int32 member-index tree with the packed params' structure: member
    s's block entries carry s. Off-block entries carry 0: always pair
    with `block_mask`, which zeroes them (`train/packed_polish.py` takes
    the two together)."""
    _check(chain)
    packed = pack_params(chain, [_ones(chain, float(s))
                                 for s in range(n_members)])
    return [{k: v.to(torch.int32) for k, v in p.items()} for p in packed]


def member_lr_scales(chain: KANChain, factors) -> list[dict]:
    """Per-member learning-rate factor tree of the (homogeneous) packed
    layout: member s's block entries carry `factors[s]`, off-block
    entries 0 (their gradients are exactly zero under the mask). Feed to
    `train(..., lr_scales=...)`: member s then steps as under
    Adam(cfg.lr * factors[s])."""
    _check(chain)
    return pack_params(chain, [_ones(chain, float(f)) for f in factors])


class _Mask(nn.Module):
    """The parametrization param -> mask * param."""

    def __init__(self, mask: Tensor):
        super().__init__()
        self.register_buffer("mask", mask)

    def forward(self, p: Tensor) -> Tensor:
        return p * self.mask


def apply_mask(mask: list, packed: KANChain) -> KANChain:
    """Mask the packed chain in place: every later read of a layer's `C`
    or `W` is mask * param (a `torch.nn.utils.parametrize`
    parametrization; the stored parameter becomes
    `layers.<i>.parametrizations.<C|W>.original`). Returns the chain."""
    for l in packed.layers:
        if not isinstance(l, (KDense, HeteroKDense)):
            raise ValueError("masking supports KDense and HeteroKDense "
                             "chains only")
    if len(mask) != len(packed.layers):
        raise ValueError(f"{len(mask)} mask dicts for {len(packed.layers)} "
                         f"layers")
    for layer, m in zip(packed.layers, mask):
        for name in ("C", "W") if layer.use_base_act else ("C",):
            if parametrize.is_parametrized(layer, name):
                raise ValueError(f"{name} is masked already")
            want = tuple(getattr(layer, name).shape)
            if tuple(m[name].shape) != want:
                raise ValueError(f"mask {name}: shape "
                                 f"{tuple(m[name].shape)} != {want}")
            parametrize.register_parametrization(
                layer, name, _Mask(m[name].to(layer.grid_rows.device
                                              if isinstance(layer,
                                                            HeteroKDense)
                                              else _device(packed))))
    return packed


def member_mean(n_members: int):
    """`reduce_fn` for losses over a packed state: squared-error tensor
    [..., S*d] -> per-member mean vector [S]."""
    def reduce(err: Tensor) -> Tensor:
        e = err.reshape(*err.shape[:-1], n_members,
                        err.shape[-1] // n_members)
        return e.mean(dim=tuple(i for i in range(e.dim()) if i != e.dim() - 2))
    return reduce


def tile_state(x: Tensor, n_members: int) -> Tensor:
    """Tile data or state along the last axis for the packed chain
    ([..., d] -> [..., S*d], member-major)."""
    return x.tile((1,) * (x.dim() - 1) + (n_members,))


# ---------------------------------------------------------------------------
# heterogeneous packing: members of DIFFERENT widths / grid sizes
# ---------------------------------------------------------------------------

class HeteroKDense(nn.Module):
    """One layer of a heterogeneous packed ensemble: `KDense`'s math with
    a grid PER INPUT ROW. Input dim i evaluates its basis on
    `grid_rows[i]` with bandwidth `h_rows[i]`, so members with different
    grid sizes coexist in one product (a member with fewer grid points
    than G repeats its last center in the padded slots, whose C entries
    the mask zeroes). The bases broadcast x[..., I, 1] - grid[I, G]
    (`ops/basis.py`). Parameters `C` [I, G, O] and `W` [I, O] (none
    without the base activation), zeros on `device`."""

    def __init__(self, in_dims: int, out_dims: int, grid_len: int,
                 grid_rows, h_rows, normalizer: str = "tanh",
                 basis: str = "rbf", base_act: str = "swish",
                 use_base_act: bool = True, *, device=None):
        super().__init__()
        self.in_dims, self.out_dims, self.grid_len = in_dims, out_dims, \
            grid_len
        self.normalizer, self.basis, self.base_act = normalizer, basis, \
            base_act
        self.use_base_act = use_base_act
        self.C = nn.Parameter(torch.zeros(in_dims, grid_len, out_dims,
                                          device=device))
        self.W = (nn.Parameter(torch.zeros(in_dims, out_dims, device=device))
                  if use_base_act else None)
        self.register_buffer("grid_rows", _f32(grid_rows).to(device),
                             persistent=False)                  # [I, G]
        self.register_buffer("h_rows", _f32(h_rows).to(device),
                             persistent=False)                  # [I]

    def apply(self, x: Tensor, *, impl: str = "xla") -> Tensor:
        if impl != "xla":
            raise ValueError("HeteroKDense runs the plain path only (per-row "
                             "grids are outside the fused kernels' "
                             "shared-grid contract)")
        xn = B.get_normalizer(self.normalizer)(x)
        bas = B.get_basis(self.basis)(xn, self.grid_rows,
                                      self.h_rows[:, None])    # [..., I, G]
        flat = bas.reshape(*bas.shape[:-2], self.in_dims * self.grid_len)
        y = flat @ self.C.reshape(self.in_dims * self.grid_len,
                                  self.out_dims)
        if self.use_base_act:
            y = y + B.get_base_act(self.base_act)(x) @ self.W
        return y

    def forward(self, x: Tensor) -> Tensor:
        return self.apply(x)


class HeteroPacked(nn.Module):
    """S member `KANChain`s of DIFFERENT hidden widths and/or grid sizes
    (same depth, basis, normalizer, base activation and grid limits)
    packed as ONE block-diagonal chain of `HeteroKDense` layers: the
    member blocks are variable-sized (layer dims are the sums of the
    members'), only the grid axis pads to G_max. The plain path only.
    Its parameters start at zero; load members with `pack` and
    `interop.hetero_params_from_numpy`, and mask with
    `apply_mask(hp.mask(), hp)`."""

    def __init__(self, members: list[KANChain]):
        super().__init__()
        if not members:
            raise ValueError("need at least one member chain")
        depth = len(members[0].layers)
        for m in members:
            _check(m)
            if len(m.layers) != depth:
                raise ValueError("members must share depth")
            for l, l0 in zip(m.layers, members[0].layers):
                for attr in ("normalizer", "basis", "base_act",
                             "use_base_act", "grid_lims"):
                    if getattr(l, attr) != getattr(l0, attr):
                        raise ValueError(
                            f"members must share {attr}; packing only "
                            "varies widths and grid sizes")
        self.member_chains = tuple(members)      # not submodules
        self.n_members = len(members)
        dev = _device(members[0])
        layers, self.in_offs, self.out_offs = [], [], []
        for li in range(depth):
            ls = [m.layers[li] for m in members]
            g_max = max(l.grid_len for l in ls)
            in_off, out_off = [0], [0]
            for l in ls:
                in_off.append(in_off[-1] + l.in_dims)
                out_off.append(out_off[-1] + l.out_dims)
            grid_rows, h_rows = [], []
            for l in ls:
                g = [float(v) for v in l.grid().cpu()]
                g = g + [g[-1]] * (g_max - l.grid_len)   # pad: repeat last
                grid_rows.extend([g] * l.in_dims)
                h_rows.extend([l.h] * l.in_dims)
            layers.append(HeteroKDense(
                in_off[-1], out_off[-1], g_max, grid_rows, h_rows,
                normalizer=ls[0].normalizer, basis=ls[0].basis,
                base_act=ls[0].base_act, use_base_act=ls[0].use_base_act,
                device=dev))
            self.in_offs.append(tuple(in_off))
            self.out_offs.append(tuple(out_off))
        self.layers = nn.ModuleList(layers)
        self.in_dims = layers[0].in_dims
        self.out_dims = layers[-1].out_dims

    # -- chain protocol (enough for make_ode_fns' plain path) -------------
    def apply(self, x: Tensor, *, impl: str = "xla") -> Tensor:
        for layer in self.layers:
            x = layer.apply(x, impl=impl)
        return x

    def forward(self, x: Tensor) -> Tensor:
        return self.apply(x)

    def num_params(self) -> int:
        return sum(m.num_params() for m in self.member_chains)

    # -- pack / extract / mask ---------------------------------------------
    def pack(self, member_params: list) -> list[dict]:
        """S members' per-layer `{"C", "W"}` (tensors or numpy arrays) ->
        the packed per-layer `{"C", "W"}` float32 tensors (exact zeros off
        the blocks and in the padded grid columns)."""
        if len(member_params) != self.n_members:
            raise ValueError(f"{len(member_params)} member param lists for "
                             f"{self.n_members} members")
        packed = []
        for li, layer in enumerate(self.layers):
            C = torch.zeros((layer.in_dims, layer.grid_len, layer.out_dims))
            W = torch.zeros((layer.in_dims, layer.out_dims))
            for s, m in enumerate(self.member_chains):
                i0, o0 = self.in_offs[li][s], self.out_offs[li][s]
                l = m.layers[li]
                C[i0:i0 + l.in_dims, :l.grid_len, o0:o0 + l.out_dims] = \
                    _f32(member_params[s][li]["C"])
                if layer.use_base_act:
                    W[i0:i0 + l.in_dims, o0:o0 + l.out_dims] = \
                        _f32(member_params[s][li]["W"])
            p = {"C": C.to(layer.grid_rows.device)}
            if layer.use_base_act:
                p["W"] = W.to(layer.grid_rows.device)
            packed.append(p)
        return packed

    def extract_member(self, packed_params: list, member: int) -> list[dict]:
        """Member `member`'s original-shape `{"C", "W"}` out of packed
        per-layer params (tensors or numpy arrays)."""
        out = []
        for li, l in enumerate(self.member_chains[member].layers):
            i0, o0 = self.in_offs[li][member], self.out_offs[li][member]
            p = packed_params[li]
            m = {"C": p["C"][i0:i0 + l.in_dims, :l.grid_len,
                             o0:o0 + l.out_dims]}
            if l.use_base_act:
                m["W"] = p["W"][i0:i0 + l.in_dims, o0:o0 + l.out_dims]
            out.append(m)
        return out

    def mask(self) -> list[dict]:
        """The 0/1 mask: 1 on each member's block, 0 off the blocks and in
        the padded grid columns."""
        return self.pack([_ones(m) for m in self.member_chains])

    def member_ids(self) -> list[dict]:
        """Int32 member-index tree (pair with `mask()`: off-block and
        padded entries carry 0 there)."""
        packed = self.pack([_ones(m, float(s))
                            for s, m in enumerate(self.member_chains)])
        return [{k: v.to(torch.int32) for k, v in p.items()} for p in packed]

    def lr_scales(self, factors) -> list[dict]:
        """Per-member learning-rate factors for `train(lr_scales=)`."""
        return self.pack([_ones(m, float(f))
                          for m, f in zip(self.member_chains, factors)])

    def member_mean(self):
        """Per-member mean `reduce_fn` over the FINAL layer's output
        blocks (members may have different state dims): [..., D] -> [S]."""
        sizes = [self.out_offs[-1][s + 1] - self.out_offs[-1][s]
                 for s in range(self.n_members)]
        total = self.out_offs[-1][-1]
        ind = torch.zeros((total, self.n_members))
        for s in range(self.n_members):
            o0 = self.out_offs[-1][s]
            ind[o0:o0 + sizes[s], s] = 1.0 / sizes[s]

        def reduce(err: Tensor) -> Tensor:
            flat = err.reshape(-1, total)
            return flat.mean(dim=0) @ ind.to(err.device)
        return reduce

    def tile_state(self, x: Tensor) -> Tensor:
        """Tile a shared dataset across the member input blocks (every
        member's state dim must equal x's last axis)."""
        d = x.shape[-1]
        for s in range(self.n_members):
            if self.in_offs[0][s + 1] - self.in_offs[0][s] != d:
                raise ValueError("tile_state needs uniform member state "
                                 "dims matching the data")
        return tile_state(x, self.n_members)
