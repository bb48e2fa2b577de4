"""Magnitude-threshold edge pruning for B-spline KAN layers (port of
`kanodes_tpu/sparsify/edge_prune.py`).

Rebuild of `OptimizedKANLinear`'s pruning (`optimized_kan.py:256-273`):
edges whose spline-coefficient magnitude falls below a threshold are
zeroed via a persistent mask (soft pruning — shapes stay the same;
contrast with the KDense `prune`, which repacks shapes,
`sparsify/prune.py`). The layers are dicts of tensors: `coeff`
[I, G+k, O], `base_w` [I, O] and optionally `scaler` [I, O] (a
`models.bspline.BSplineKANChain`'s `param_dicts()`).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def edge_magnitudes(params: dict) -> Tensor:
    """Per-edge mean |coeff| over the spline dimension: [I, O]
    (optimized_kan.py:258-262)."""
    return params["coeff"].abs().mean(dim=1)


def prune_edges(params: dict, threshold: float) -> tuple[dict, Tensor]:
    """Zero out weak edges; returns (new params, keep mask [I, O])."""
    mag = edge_magnitudes(params)
    mask = (mag > threshold).to(params["coeff"].dtype)
    out = dict(params)
    out["coeff"] = params["coeff"] * mask[:, None, :]
    if "scaler" in out:
        out["scaler"] = params["scaler"] * mask
    out["base_w"] = params["base_w"] * mask
    return out, mask


def prune_chain_edges(chain_params: list, threshold: float
                      ) -> tuple[list, list, int]:
    """Apply edge pruning to every layer; returns (params, masks,
    number of pruned edges) (optimized_kan.py:256-273 chain loop)."""
    new, masks, pruned = [], [], 0
    for p in chain_params:
        q, m = prune_edges(p, threshold)
        new.append(q)
        masks.append(m)
        pruned += int(m.numel() - float(m.sum()))
    return new, masks, pruned
