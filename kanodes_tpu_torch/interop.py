"""Carry KDense and chain parameters between the JAX package and this port.

Torch cannot reproduce `jax.random` init, so a run that must match a
JAX run starts from the JAX params: `{"C": [I,G,O], "W": [I,O]}` as
numpy arrays for one layer (`kanodes_tpu.models.KDense.init`), a list of
such dicts for a chain (`KANChain.init`).
"""

from __future__ import annotations

import numpy as np
import torch


@torch.no_grad()
def kdense_params_from_numpy(layer, params) -> None:
    """Copy one layer's `{"C", "W"}` arrays into its parameters (on their
    device, as float32). Shapes must match exactly."""
    for name in ("C", "W"):
        dst = getattr(layer, name)
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
