"""Carry KDense and chain parameters between the JAX package and this port.

Torch cannot reproduce `jax.random` init, so a run that must match a
JAX run starts from the JAX params: `{"C": [I,G,O], "W": [I,O]}` as
numpy arrays for one layer (`kanodes_tpu.models.KDense.init`; no `W`
without the base activation, `grid_offset` [G] and `log_h` [] with a
trainable grid; `KDense1`'s `{"C": [I,G], "W": [I,O]}`), a list of
such dicts for a chain (`KANChain.init`). S member inits become the port's packed chain
(`models/packed.py`) with `packed_params_from_numpy`, laid out as JAX
`pack_params` lays them; `packed.extract_member` goes the other way. An
MLP's are per-layer `{"W": [i,o], "b": [o]}` (`kanodes_tpu.models.MLP`):
`mlp_params_from_numpy` / `mlp_params_to_numpy`; `params_from_numpy`
picks by the model. A stacked multi-seed tree (JAX's `init_stacked`: the
chain's per-layer dicts with [S, ...] leaves) goes into the port's
`train.loop.Stacked` with `stacked_params_from_numpy`, and S members of
different widths into a `HeteroPacked` with `hetero_params_from_numpy`.
A B-spline chain's are per-layer `{"base_w", "coeff", "grid", "scaler"}`
(`kanodes_tpu.models.BSplineKANChain`), the knot grid included:
`bspline_params_from_numpy` / `bspline_params_to_numpy`; a
`HybridKANMLP`'s `{"gate", "kan", "mlp"}`: `hybrid_params_from_numpy`.
The strain-limiting PINN's (`kanodes_tpu.pinn.model.KANPINN`) are
per-layer `{"coeff", "lin", "bias", "centers", "logwidth"}`:
`pinn_params_from_numpy` / `pinn_params_to_numpy`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn.utils import parametrize

from kanodes_tpu_torch.models.bspline import BSplineKANChain
from kanodes_tpu_torch.models.hybrid import HybridKANMLP
from kanodes_tpu_torch.models.mlp import MLP
from kanodes_tpu_torch.models.packed import pack_params
from kanodes_tpu_torch.pinn.model import LAYER_KEYS, KANPINN, load_params


def stored_param(layer, name: str) -> torch.Tensor:
    """The parameter tensor itself: under a parametrization (the packed
    chain's mask) the original, not the value it reads as."""
    if parametrize.is_parametrized(layer, name):
        return layer.parametrizations[name].original
    return getattr(layer, name)


def tree_per_param(chain, params, tree) -> list:
    """A KDense chain's per-layer `{"C", "W"}` tree (a mask, member ids,
    lr factors) laid against `params`, the chain's stored parameters in
    `named_parameters()` order: each one's entry, or None where the tree
    has none."""
    if (len(tree) != len(chain.layers)
            or not all(isinstance(d, dict) for d in tree)):
        raise ValueError(f"expected {len(chain.layers)} per-layer "
                         f"{{'C', 'W'}} dicts")
    by_id = {id(stored_param(layer, k)): v
             for layer, d in zip(chain.layers, tree) for k, v in d.items()}
    return [by_id.get(id(p)) for p in params]


def layer_param_names(layer) -> list[str]:
    """The names of a KDense-like layer's parameters, in JAX's leaf
    order: `C`, then `W` where it has one, then `grid_offset` and
    `log_h` where its grid is trainable."""
    return [n for n in ("C", "W", "grid_offset", "log_h")
            if getattr(layer, n, None) is not None]


@torch.no_grad()
def kdense_params_from_numpy(layer, params) -> None:
    """Copy one layer's arrays (`layer_param_names` of them) into its
    parameters (on their device, as float32). Names and shapes must
    match exactly."""
    names = layer_param_names(layer)
    if set(params) != set(names):
        raise ValueError(f"layer keys {sorted(params)} != {names}")
    for name in names:
        dst = stored_param(layer, name)
        src = np.array(params[name], dtype=np.float32)   # writable copy
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {src.shape} != "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(src).to(dst.device))


def kdense_params_to_numpy(layer) -> dict[str, np.ndarray]:
    """One layer's parameters as numpy arrays, under JAX's names."""
    return {n: getattr(layer, n).detach().cpu().numpy().copy()
            for n in layer_param_names(layer)}


def chain_params_from_numpy(chain, params) -> None:
    """Copy per-layer arrays (`{"C", "W"}`, say) into the chain's
    parameters (on their device, as float32). Shapes must match
    exactly."""
    if len(params) != len(chain.layers):
        raise ValueError(f"{len(params)} param dicts for "
                         f"{len(chain.layers)} layers")
    for layer, p in zip(chain.layers, params):
        kdense_params_from_numpy(layer, p)


def chain_params_to_numpy(chain) -> list[dict[str, np.ndarray]]:
    """The chain's parameters as per-layer numpy arrays (`{"C", "W"}`,
    say)."""
    return [kdense_params_to_numpy(layer) for layer in chain.layers]


def packed_params_from_numpy(packed, chain, member_params) -> None:
    """Copy S members' per-layer `{"C", "W"}` arrays (S JAX inits, say)
    into the packed chain of `chain` (`packed.pack_chain(chain, S)`),
    block-diagonally with exact zeros elsewhere, as JAX `pack_params`
    lays them out."""
    chain_params_from_numpy(packed, [
        {k: v.cpu().numpy() for k, v in p.items()}
        for p in pack_params(chain, member_params)])


@torch.no_grad()
def mlp_params_from_numpy(mlp, params) -> None:
    """Copy per-layer `{"W", "b"}` arrays (JAX's MLP params) into the
    MLP's parameters (on their device, as float32). Shapes must match."""
    if len(params) != len(mlp.layers):
        raise ValueError(f"{len(params)} param dicts for "
                         f"{len(mlp.layers)} layers")
    for layer, p in zip(mlp.layers, params):
        names = ("W", "b") if layer.b is not None else ("W",)
        if set(p) != set(names):
            raise ValueError(f"layer keys {sorted(p)} != {list(names)}")
        for name in names:
            dst = getattr(layer, name)
            src = np.array(p[name], dtype=np.float32)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: shape {src.shape} != "
                                 f"{tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(src).to(dst.device))


def mlp_params_to_numpy(mlp) -> list[dict[str, np.ndarray]]:
    """The MLP's parameters as per-layer `{"W", "b"}` numpy arrays."""
    out = []
    for layer in mlp.layers:
        p = {"W": layer.W.detach().cpu().numpy().copy()}
        if layer.b is not None:
            p["b"] = layer.b.detach().cpu().numpy().copy()
        out.append(p)
    return out


@torch.no_grad()
def _copy_named(module, params, names) -> None:
    """Copy the arrays `params[name]` into `module`'s tensors of those
    names (on their device, as float32). Names and shapes must match."""
    if set(params) != set(names):
        raise ValueError(f"layer keys {sorted(params)} != {list(names)}")
    for name in names:
        dst = getattr(module, name)
        src = np.array(params[name], dtype=np.float32)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {src.shape} != "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(src).to(dst.device))


def bspline_params_from_numpy(chain, params) -> None:
    """Copy per-layer `{"base_w", "coeff", "grid", "scaler"}` arrays (JAX's
    B-spline chain params, the knot grid included; no scaler without the
    standalone scaler) into the chain's tensors."""
    if len(params) != len(chain.layers):
        raise ValueError(f"{len(params)} param dicts for "
                         f"{len(chain.layers)} layers")
    for layer, p in zip(chain.layers, params):
        _copy_named(layer, p, [n for n, _ in layer.named_parameters()])


def bspline_params_to_numpy(chain) -> list[dict[str, np.ndarray]]:
    """The chain's tensors as per-layer numpy arrays under JAX's names,
    the current knot grid included."""
    return [{n: p.detach().cpu().numpy().copy()
             for n, p in layer.named_parameters()} for layer in chain.layers]


@torch.no_grad()
def hybrid_params_from_numpy(model, params) -> None:
    """JAX's `HybridKANMLP` params `{"gate", "kan", "mlp"}` into the
    port's model."""
    if set(params) != {"gate", "kan", "mlp"}:
        raise ValueError(f"hybrid keys {sorted(params)} != "
                         f"['gate', 'kan', 'mlp']")
    _copy_named(model, {"gate": params["gate"]}, ["gate"])
    bspline_params_from_numpy(model.kan, params["kan"])
    mlp_params_from_numpy(model.mlp, params["mlp"])


def pinn_params_from_numpy(model, params) -> None:
    """Copy per-layer `{"coeff", "lin", "bias", "centers", "logwidth"}`
    arrays (JAX's `KANPINN` params, e.g. the pickled list of
    `artifacts/pinn_adaptive_best_params.npy`) into the PINN's
    parameters, on their device, in their dtype. Shapes must match."""
    load_params(model, list(params))


def pinn_params_to_numpy(model) -> list[dict[str, np.ndarray]]:
    """The PINN's parameters as JAX's per-layer numpy dicts."""
    return [{k: getattr(layer, k).detach().cpu().numpy().copy()
             for k in LAYER_KEYS} for layer in model.layers]


def params_from_numpy(model, params) -> None:
    """JAX-layout arrays into `model`: an MLP's `{"W", "b"}`, a B-spline
    chain's `{"base_w", "coeff", "grid", "scaler"}`, a hybrid's `{"gate",
    "kan", "mlp"}`, a PINN's `{"coeff", "lin", "bias", "centers",
    "logwidth"}` or a KDense chain's `{"C", "W"}`."""
    if isinstance(model, KANPINN):
        pinn_params_from_numpy(model, params)
    elif isinstance(model, MLP):
        mlp_params_from_numpy(model, params)
    elif isinstance(model, BSplineKANChain):
        bspline_params_from_numpy(model, params)
    elif isinstance(model, HybridKANMLP):
        hybrid_params_from_numpy(model, params)
    else:
        chain_params_from_numpy(model, params)



@torch.no_grad()
def stacked_params_from_numpy(stacked, tree) -> None:
    """Copy a stacked tree (JAX's `init_stacked` layout: per-layer dicts
    of [S, ...] arrays) into a `train.loop.Stacked` of a chain or MLP,
    on its parameters' device, as float32. Shapes must match exactly."""
    layers = stacked.members.layers
    if len(tree) != len(layers):
        raise ValueError(f"{len(tree)} param dicts for {len(layers)} layers")
    for layer, p in zip(layers, tree):
        for name, v in p.items():
            dst = getattr(layer, name)
            src = np.array(v, dtype=np.float32)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: shape {src.shape} != "
                                 f"{tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(src).to(dst.device))


def hetero_params_from_numpy(hp, member_params) -> None:
    """Copy S members' per-layer `{"C", "W"}` arrays (of their own
    widths and grid sizes) into a `models.packed.HeteroPacked`, packed as
    its `pack` lays them out (JAX `HeteroPacked.pack`)."""
    chain_params_from_numpy(hp, [
        {k: v.cpu().numpy() for k, v in p.items()}
        for p in hp.pack(member_params)])
