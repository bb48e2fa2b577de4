"""MLP baseline, the reference's MLP-NODE comparator (port of
`kanodes_tpu/models/mlp.py`).

`LV_driver_MLP.jl:61` uses `Chain(Dense(2 => 50, tanh), Dense(50 => 2))`;
this is the same family as one configurable module, so the
parameter-efficiency sweep (`experiments/sweep.py`) trains both families
through one path. Same parameters as the JAX module: per layer `W`
[i, o] and `b` [o] (`layers.<k>.W`, `layers.<k>.b`), so JAX's per-layer
`{"W", "b"}` arrays cross with `interop.mlp_params_from_numpy`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from kanodes_tpu_torch.models.core import glorot_uniform
from kanodes_tpu_torch.ops import basis as B

Tensor = torch.Tensor

# the JAX package's base activations and normalizers by name
# (kanodes_tpu/ops/basis.py BASE_ACTS, NORMALIZERS); jax.nn.gelu is the
# tanh approximation
ACTIVATIONS = {
    "swish": B.swish, "silu": B.swish, "tanh": torch.tanh,
    "relu": torch.relu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "identity": lambda x: x, "sigmoid": torch.sigmoid,
    "softsign": B.softsign,
}


class Dense(nn.Module):
    """One affine layer x @ W (+ b)."""

    def __init__(self, in_dims: int, out_dims: int, use_bias: bool = True,
                 *, device=None):
        super().__init__()
        self.in_dims, self.out_dims = in_dims, out_dims
        self.W = nn.Parameter(torch.zeros(in_dims, out_dims, device=device))
        if use_bias:
            self.b = nn.Parameter(torch.zeros(out_dims, device=device))
        else:
            self.b = None

    def forward(self, x: Tensor) -> Tensor:
        y = x @ self.W
        return y if self.b is None else y + self.b


class MLP(nn.Module):
    """Fully connected network over `widths`, `activation` between
    layers and `final_activation` after the last. Parameters are zeros
    on `device` until `init(generator)`."""

    def __init__(self, widths, activation: str = "tanh",
                 final_activation: str = "identity", use_bias: bool = True,
                 *, device=None):
        super().__init__()
        self.widths = tuple(int(w) for w in widths)
        for name in (activation, final_activation):
            if name not in ACTIVATIONS:
                raise ValueError(f"unknown activation {name!r}; have "
                                 f"{sorted(ACTIVATIONS)}")
        self.activation = activation
        self.final_activation = final_activation
        self.use_bias = use_bias
        self.layers = nn.ModuleList(
            Dense(i, o, use_bias, device=device)
            for i, o in zip(self.widths[:-1], self.widths[1:]))

    @property
    def in_dims(self) -> int:
        return self.widths[0]

    @property
    def out_dims(self) -> int:
        return self.widths[-1]

    def num_params(self) -> int:
        return sum(i * o + (o if self.use_bias else 0)
                   for i, o in zip(self.widths[:-1], self.widths[1:]))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "MLP":
        """Glorot-uniform weights (fans i, o) layer by layer from one
        generator, zero biases."""
        for layer in self.layers:
            layer.W.copy_(glorot_uniform(
                (layer.in_dims, layer.out_dims), layer.in_dims,
                layer.out_dims, generator, device=layer.W.device))
            if layer.b is not None:
                layer.b.zero_()
        return self

    def apply(self, x: Tensor) -> Tensor:
        """[..., widths[0]] -> [..., widths[-1]] in exact float32 (TF32
        is off: `utils/precision.set_exact_f32`)."""
        act = ACTIVATIONS[self.activation]
        n = len(self.layers)
        for idx, layer in enumerate(self.layers):
            x = layer(x)
            if idx < n - 1:
                x = act(x)
        if self.final_activation != "identity":
            x = ACTIVATIONS[self.final_activation](x)
        return x

    def forward(self, x: Tensor) -> Tensor:
        return self.apply(x)
