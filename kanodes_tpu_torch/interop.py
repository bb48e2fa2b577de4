"""Carry KDense and chain parameters between the JAX package and this port.

Torch cannot reproduce `jax.random` init, so a run that must match a
JAX run starts from the JAX params: `{"C": [I,G,O], "W": [I,O]}` as
numpy arrays for one layer (`kanodes_tpu.models.KDense.init`), a list of
such dicts for a chain (`KANChain.init`). S member inits become the port's packed chain
(`models/packed.py`) with `packed_params_from_numpy`, laid out as JAX
`pack_params` lays them; `packed.extract_member` goes the other way.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn.utils import parametrize

from kanodes_tpu_torch.models.packed import pack_params


def _stored(layer, name: str) -> torch.Tensor:
    """The parameter tensor itself: under a parametrization (the packed
    chain's mask) the original, not the value it reads as."""
    if parametrize.is_parametrized(layer, name):
        return layer.parametrizations[name].original
    return getattr(layer, name)


@torch.no_grad()
def kdense_params_from_numpy(layer, params) -> None:
    """Copy one layer's `{"C", "W"}` arrays into its parameters (on their
    device, as float32). Shapes must match exactly."""
    for name in ("C", "W"):
        dst = _stored(layer, name)
        src = np.array(params[name], dtype=np.float32)   # writable copy
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {src.shape} != "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(src).to(dst.device))


def kdense_params_to_numpy(layer) -> dict[str, np.ndarray]:
    """One layer's parameters as `{"C", "W"}` numpy arrays."""
    return {"C": layer.C.detach().cpu().numpy().copy(),
            "W": layer.W.detach().cpu().numpy().copy()}


def chain_params_from_numpy(chain, params) -> None:
    """Copy per-layer `{"C", "W"}` arrays into the chain's parameters
    (on their device, as float32). Shapes must match exactly."""
    if len(params) != len(chain.layers):
        raise ValueError(f"{len(params)} param dicts for "
                         f"{len(chain.layers)} layers")
    for layer, p in zip(chain.layers, params):
        kdense_params_from_numpy(layer, p)


def chain_params_to_numpy(chain) -> list[dict[str, np.ndarray]]:
    """The chain's parameters as per-layer `{"C", "W"}` numpy arrays."""
    return [kdense_params_to_numpy(layer) for layer in chain.layers]


def packed_params_from_numpy(packed, chain, member_params) -> None:
    """Copy S members' per-layer `{"C", "W"}` arrays (S JAX inits, say)
    into the packed chain of `chain` (`packed.pack_chain(chain, S)`),
    block-diagonally with exact zeros elsewhere, as JAX `pack_params`
    lays them out."""
    chain_params_from_numpy(packed, [
        {k: v.cpu().numpy() for k, v in p.items()}
        for p in pack_params(chain, member_params)])
