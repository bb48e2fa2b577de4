"""Packed (block-diagonal) KAN ensembles: S replicas as ONE wider chain
(port of the homogeneous half of `kanodes_tpu/models/packed.py`).

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

Not ported yet (ROADMAP.md, M11): `member_ids`, `member_lr_scales`,
`HeteroKDense` and `HeteroPacked`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

from kanodes_tpu_torch.models.kdense import KANChain, KDense

Tensor = torch.Tensor


def _check(chain: KANChain) -> None:
    for l in chain.layers:
        if not isinstance(l, KDense):
            raise ValueError("packing supports KDense chains only")


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
    [S*I, S*O]}` float32 tensors on `chain`'s device, member s in the
    block (s*I:(s+1)*I, s*O:(s+1)*O), exact zeros elsewhere."""
    _check(chain)
    S, dev = len(member_params), _device(chain)
    packed = []
    for li, l in enumerate(chain.layers):
        I, G, O = l.in_dims, l.grid_len, l.out_dims
        C = torch.zeros((S * I, G, S * O), device=dev)
        W = torch.zeros((S * I, S * O), device=dev)
        for s, mp in enumerate(member_params):
            C[s * I:(s + 1) * I, :, s * O:(s + 1) * O] = _f32(mp[li]["C"])
            W[s * I:(s + 1) * I, s * O:(s + 1) * O] = _f32(mp[li]["W"])
        packed.append({"C": C, "W": W})
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
        out.append({"C": p["C"][sI:sI + l.in_dims, :, sO:sO + l.out_dims],
                    "W": p["W"][sI:sI + l.in_dims, sO:sO + l.out_dims]})
    return out


def block_mask(chain: KANChain, n_members: int) -> list[dict]:
    """The 0/1 block-diagonal mask with the packed params' structure."""
    _check(chain)
    one = [{"C": torch.ones(l.in_dims, l.grid_len, l.out_dims),
            "W": torch.ones(l.in_dims, l.out_dims)} for l in chain.layers]
    return pack_params(chain, [one] * n_members)


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
    _check(packed)
    if len(mask) != len(packed.layers):
        raise ValueError(f"{len(mask)} mask dicts for {len(packed.layers)} "
                         f"layers")
    for layer, m in zip(packed.layers, mask):
        for name in ("C", "W"):
            if parametrize.is_parametrized(layer, name):
                raise ValueError(f"{name} is masked already")
            want = tuple(getattr(layer, name).shape)
            if tuple(m[name].shape) != want:
                raise ValueError(f"mask {name}: shape "
                                 f"{tuple(m[name].shape)} != {want}")
            parametrize.register_parametrization(
                layer, name, _Mask(m[name].to(_device(packed))))
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
