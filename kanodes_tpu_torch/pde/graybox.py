"""Gray-box RHS composition: known physics + learned pointwise KAN (port
of `kanodes_tpu/pde/graybox.py`).

The reference's hidden-physics pattern (`Fisher-KPP_Source.jl:95-98`,
`Allen-Cahn_Source.jl:90-93`) is
    du/dt = D * Lap @ u  +  kan.(u)
— a known linear operator plus a scalar 1->1 KAN broadcast over every
grid node, the nodes being the layer's batch axis.

The layer owns its parameters here, so the integrators' `args` slot
carries the layer to use (the one held by the RHS when it is None).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GrayBoxRHS:
    """rhs(t, u, model) = known(t, u) + model.apply(u) node by node.

    `model` maps [..., 1] -> [..., 1]; it is applied to the grid state
    u: [N] by treating nodes as the batch axis.
    """

    known: Callable[[float, Tensor], Tensor]   # (t, u[N]) -> [N]
    model: torch.nn.Module                     # layer with .apply

    def __call__(self, t, u: Tensor, model=None) -> Tensor:
        m = self.model if model is None else model
        return self.known(t, u) + m.apply(u[..., None])[..., 0]


@dataclasses.dataclass(frozen=True)
class FullSurrogateRHS:
    """rhs = model(u): the whole semi-discrete RHS is the network, the
    grid state is the network input vector (`Burgers_Surrogate.jl:82-88`,
    402-dim for Schrödinger `Schrodinger_Surrogate.jl:93-96`)."""

    model: torch.nn.Module

    def __call__(self, t, u: Tensor, model=None) -> Tensor:
        return (self.model if model is None else model).apply(u)
