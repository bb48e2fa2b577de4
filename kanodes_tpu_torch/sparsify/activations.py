"""Per-edge activation extraction for KAN chains (port of
`kanodes_tpu/sparsify/activations.py`).

Rebuild of `Lotka-Volterra/Activation_getter.jl:3-63`: instead of the
matmul-fused layer output, expose each learned scalar function
phi_{i->o}(x_i) — the quantity pruning scores, symbolic regression fits,
and the paper's spline plots all consume. Layer n's activations are
evaluated at layer n-1's outputs, so the whole chain is threaded through
`KDense.edge_activations`, on the device the chain and x are on, without
gradients.
"""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class ChainActivations:
    """inputs[l]: [N, I_l] layer inputs; acts[l]: [N, I_l, O_l] per-edge
    activation values phi_{i->o} evaluated at those inputs."""
    inputs: list
    acts: list

    def edge_curves(self, layer: int, i: int, o: int):
        """(x values, phi(x) values) for edge i->o of a layer — the data
        behind the reference's activation plots and SR targets."""
        return self.inputs[layer][:, i], self.acts[layer][:, i, o]


@torch.no_grad()
def chain_activations(chain, x: Tensor) -> ChainActivations:
    """Thread x ([N, in_dims]) through the chain collecting per-edge
    activations at every layer."""
    inputs, acts = [], []
    for layer in chain.layers:
        a = layer.edge_activations(x)         # [N, I, O]
        inputs.append(x)
        acts.append(a)
        x = a.sum(dim=-2)                     # == layer.apply(x)
    return ChainActivations(inputs, acts)


def activation_magnitudes(chain, x: Tensor) -> list:
    """max_t |phi_{i->o}(x_i(t))| per edge and layer: [I_l, O_l] tensors.

    This is the score the reference's pruning uses
    (`LV_driver_KANODE.jl:73-84`).
    """
    ca = chain_activations(chain, x)
    return [a.abs().amax(dim=0) for a in ca.acts]
