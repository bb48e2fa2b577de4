"""Hidden-node pruning for 2-layer KAN chains (port of
`kanodes_tpu/sparsify/prune.py`).

Rebuild of `prune` (`Lotka-Volterra/LV_driver_KANODE.jl:52-108`): score
every hidden node by the activations flowing through it on training
inputs; a node survives when BOTH its strongest incoming edge and its
strongest outgoing edge exceed the threshold
    keep_j = min(max_i max_t |phi_{i->j}|, max_o max_t |phi_{j->o}|) > theta
(:76-84, theta = 1e-2 in the paper, 1e-1 at the call site :169), then
rebuild a narrower chain holding the surviving parameter slices
(:87-107). Pruning is a repack boundary: training restarts on the new
chain, as the reference restarts its training script after pruning
(:18-25).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kanodes_tpu_torch.interop import chain_params_to_numpy
from kanodes_tpu_torch.models.kdense import KANChain, KDense
from kanodes_tpu_torch.sparsify.activations import activation_magnitudes

Tensor = torch.Tensor


@dataclasses.dataclass
class PruneResult:
    chain: KANChain           # the narrower chain, holding the kept slices
    params: list              # its per-layer {"C", "W"} numpy arrays
    kept: np.ndarray          # indices of surviving hidden nodes
    scores: np.ndarray        # per-node min(in, out) scores


def node_scores(chain: KANChain, x: Tensor) -> np.ndarray:
    """min(strongest-in, strongest-out) activation magnitude per hidden
    node of a 2-layer chain (LV_driver_KANODE.jl:76-84)."""
    if len(chain.layers) != 2:
        raise ValueError("prune supports 2-layer chains (as the reference)")
    mags = activation_magnitudes(chain, x)
    in_score = mags[0].amax(dim=0)            # [hidden] strongest incoming
    out_score = mags[1].amax(dim=1)           # [hidden] strongest outgoing
    return torch.minimum(in_score, out_score).cpu().numpy()


def _narrowed(layer: KDense, in_dims: int, out_dims: int) -> KDense:
    """A KDense like `layer` (grid, limits, denominator, basis,
    normalizer, base activation, trainable grid, device) with other
    widths."""
    return KDense(in_dims, out_dims, layer.grid_len,
                  normalizer=layer.normalizer, grid_lims=layer.grid_lims,
                  denominator=layer.denominator, basis=layer.basis,
                  base_act=layer.base_act, use_base_act=layer.use_base_act,
                  trainable_grid=layer.trainable_grid, device=layer.C.device)


@torch.no_grad()
def prune(chain: KANChain, x: Tensor, threshold: float = 1e-2) -> PruneResult:
    """Drop weak hidden nodes; returns the repacked smaller chain, on the
    old chain's device.

    x: [N, in_dims] sample states on the chain's device (the reference
    uses the training trajectory). Keeps at least one node.
    """
    if not all(l.use_base_act for l in chain.layers):
        # the JAX package's prune slices both layers' W before it looks
        # at use_base_act (kanodes_tpu/sparsify/prune.py:69-75), so it
        # raises on such a chain; so does the port
        raise ValueError("prune needs W in both layers (use_base_act="
                         "True), as the JAX package's prune does")
    scores = node_scores(chain, x)
    kept = np.where(scores > threshold)[0]
    if kept.size == 0:
        kept = np.asarray([int(scores.argmax())])
    l1, l2 = chain.layers
    n = int(kept.size)
    new_chain = KANChain(_narrowed(l1, l1.in_dims, n),
                         _narrowed(l2, n, l2.out_dims))
    idx = torch.as_tensor(kept, device=l1.C.device)
    n1, n2 = new_chain.layers
    n1.C.copy_(l1.C[:, :, idx])
    n1.W.copy_(l1.W[:, idx])
    n2.C.copy_(l2.C[idx, :, :])
    n2.W.copy_(l2.W[idx, :])
    # the grid parameters act per layer, not per node: kept whole
    for old, new in ((l1, n1), (l2, n2)):
        if old.trainable_grid:
            new.grid_offset.copy_(old.grid_offset)
            new.log_h.copy_(old.log_h)
    return PruneResult(new_chain, chain_params_to_numpy(new_chain), kept,
                       scores)
