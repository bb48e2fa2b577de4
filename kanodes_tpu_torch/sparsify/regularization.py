"""Sparsity regularization (Eq. 12 of the KAN-ODEs paper; port of
`kanodes_tpu/sparsify/regularization.py`).

Parity with `LV_driver_KANODE.jl:187-194`: an L1 term over the flat
parameter vector plus an entropy term over the L1-normalized magnitudes
(pushes mass onto few edges), combined as
    act_reg * sum|p| + entropy_reg * H(|p| / sum|p|).
The reference trains LV with (5e-4, 0) at `LV_driver_KANODE.jl:199-201`.
The PyTorch flavor's extra L2 / spline-smoothness terms
(`optimized_kan.py:211-233`) are provided as well.

Each term takes a model (its `parameters()`, in registration order: for
a `KANChain` each layer's `C` then `W`, for a B-spline chain `base_w`,
`coeff`, `grid`, `scaler`, the JAX pytree's leaf order) or an iterable
of tensors in place of the JAX pytree. The terms are plain
torch ops: autograd adds their gradient to whatever the loss's kernels
write into the same parameters.
"""

from __future__ import annotations

import torch
from torch import nn

Tensor = torch.Tensor


def _leaves(params, weights_only: bool = False) -> list[Tensor]:
    leaves = (list(params.parameters()) if isinstance(params, nn.Module)
              else list(params))
    if weights_only:
        leaves = [x for x in leaves if x.requires_grad]
    return leaves


def _abs(x: Tensor) -> Tensor:
    """|x| with JAX's derivative: +1 at x = 0 (and -0.0), where torch's
    `abs` has 0. A parameter at exactly 0 gets the same L1 and entropy
    gradient as in the JAX package."""
    return torch.where(x >= 0, x, -x)


def _flat_abs(params) -> Tensor:
    return torch.cat([_abs(x).reshape(-1) for x in _leaves(params)])


def l1_entropy_reg(params, act_reg: float = 1.0, entropy_reg: float = 1.0,
                   eps: float = 1e-12) -> Tensor:
    """act_reg * sum|p|  +  entropy_reg * entropy(|p|/sum|p|)."""
    a = _flat_abs(params)
    total = torch.sum(a)
    frac = a / (total + eps)
    entropy = -torch.sum(frac * torch.log(frac + eps))
    return act_reg * total + entropy_reg * entropy


def l2_reg(params, weight: float = 1.0, *,
           weights_only: bool = False) -> Tensor:
    """Sum of squares (optimized_kan.py:211-216). `weights_only` leaves
    out the tensors that do not require grad: the B-spline knot grid,
    coordinates rather than weights (`scripts/harness_compare.py`'s
    `_weights_only`); by default every leaf counts, as in JAX."""
    sq = sum(torch.sum(x * x) for x in _leaves(params, weights_only))
    return weight * sq


def spline_smoothness_reg(kan_params, weight: float = 1.0) -> Tensor:
    """Second-difference penalty along each edge's grid coefficients
    (optimized_kan.py:218-233). Accepts a chain (its layers' `C`, or a
    B-spline chain's `coeff`) or a list of dicts with the spline tensor
    under "C" (KDense, [I, G, O]) or "coeff" (B-spline layers,
    [I, G+k, O]) — the penalty runs over the middle (grid) axis either
    way."""
    if isinstance(kan_params, nn.Module):
        kan_params = [{"coeff": layer.coeff} if hasattr(layer, "coeff")
                      else {"C": layer.C} for layer in kan_params.layers]
    total = 0.0
    for p in kan_params:
        C = p["C"] if "C" in p else p.get("coeff")
        if C is None:
            continue
        d2 = C[:, 2:, :] - 2.0 * C[:, 1:-1, :] + C[:, :-2, :]
        total = total + torch.sum(d2 * d2)
    return weight * total
