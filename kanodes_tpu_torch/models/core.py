"""Layer container and init (port of `kanodes_tpu/models/core.py`).

In the JAX package layers are static dataclasses and params a separate
pytree; here each layer is an `nn.Module` that owns its parameters, and
`Chain` is the sequential container. The basis grid stays a static
constant of the layer, not a parameter.
"""

from __future__ import annotations

import math

import torch
from torch import nn

Tensor = torch.Tensor


def glorot_uniform(shape: tuple[int, ...], fan_in: int, fan_out: int,
                   generator: torch.Generator, dtype=torch.float32,
                   device=None) -> Tensor:
    """Glorot/Xavier uniform with explicit fans (`kdense.jl:75`).

    Drawn on the generator's device and moved to `device`, so one seed
    gives the same values on every device. Torch cannot reproduce
    `jax.random` streams: to start from a JAX init, load its arrays with
    `interop.chain_params_from_numpy`.
    """
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    return (u * (2.0 * limit) - limit).to(device)


class Chain(nn.Module):
    """Sequential container of layers with matching widths."""

    def __init__(self, *layers: nn.Module):
        super().__init__()
        if not layers:
            raise ValueError("Chain needs at least one layer")
        for a, b in zip(layers[:-1], layers[1:]):
            if a.out_dims != b.in_dims:
                raise ValueError(
                    f"layer size mismatch: {a.out_dims} -> {b.in_dims}")
        self.layers = nn.ModuleList(layers)
        self.in_dims = layers[0].in_dims
        self.out_dims = layers[-1].out_dims

    def forward(self, x: Tensor) -> Tensor:
        for layer in self.layers:
            x = layer(x)
        return x

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())
