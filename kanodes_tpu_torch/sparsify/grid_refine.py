"""Grid refinement for KDense chains (port of
`kanodes_tpu/sparsify/grid_refine.py`): efficient-kan's `update_grid`
for the grid-basis layer family, used by the PDE-surrogate chains.

The basis grid is a static uniform [lo, hi] span, folded into the fused
kernels' constants (`ops/_cuda.chain_dims`, cached per `ChainSpec`), so
a refit

  1. measures the span the normalized layer inputs actually occupy
     (numpy quantiles on the host over the states visited by the trained
     trajectory), pooled over the layers;
  2. rebuilds the layers with `grid_lims` on that span and `denominator`
     None (h from the span; one span for both layers, the fused
     ChainSpec contract); and
  3. refits every edge's C by ridge-regularized least squares on a dense
     per-dim input grid, so that the learned functions are kept on the
     sampled range (the lstsq step of `efficientkan.py:113-143`); W, the
     grid-free base branch, is copied. The normal equations are solved
     per input feature in float32 with TF32 off.

The returned chain is a new module whose `ChainSpec` differs, so the
next fused call builds new kernel constants and reuses no old ones.
"""

from __future__ import annotations

import numpy as np
import torch

from kanodes_tpu_torch.models.kdense import KDense
from kanodes_tpu_torch.ops import basis as B
from kanodes_tpu_torch.sparsify.activations import chain_activations
from kanodes_tpu_torch.utils.precision import set_exact_f32

Tensor = torch.Tensor


def _relimited(layer: KDense, lims: tuple[float, float]) -> KDense:
    """A KDense like `layer` (its options, device) on the span `lims`
    with h from the span; parameters zero."""
    return KDense(layer.in_dims, layer.out_dims, layer.grid_len,
                  normalizer=layer.normalizer, grid_lims=lims,
                  denominator=None, basis=layer.basis,
                  base_act=layer.base_act, use_base_act=layer.use_base_act,
                  device=layer.C.device)


@torch.no_grad()
def refine_kdense_chain_grid(chain, x_samples: Tensor, *,
                             q: tuple[float, float] = (0.0, 1.0),
                             pad: float = 0.05) -> tuple:
    """Refit a KDense chain's shared basis-grid span onto the inputs it
    actually sees.

    chain: a KANChain of KDense layers (2 for the fused path), trained.
    x_samples: [N, in_dims] states the RHS visits (the predicted training
      trajectory, say), on the chain's device.
    q: the quantile band of normalized inputs the new span must cover
      (default min/max: rbf values decay outside the span, so clipping
      tails trades tail fidelity for center resolution).
    pad: relative padding on each side of the measured span.

    Returns (new_chain, info): info holds the old and new spans and each
    layer's relative function-keeping error. A trainable grid raises, as
    in JAX: its offsets and log-bandwidth would be read against the new
    span while C was refit without them.
    """
    for layer in chain.layers:
        if getattr(layer, "trainable_grid", False):
            raise ValueError(
                "refine_kdense_chain_grid does not support "
                "trainable_grid layers: the adaptive-basis params "
                "already adapt the span during training")
    set_exact_f32()
    ca = chain_activations(chain, x_samples)

    # 1. the measured span of NORMALIZED inputs, pooled over the layers
    lo, hi = np.inf, -np.inf
    for layer, x_l in zip(chain.layers, ca.inputs):
        xn = B.get_normalizer(layer.normalizer)(x_l).cpu().numpy().ravel()
        ql, qh = np.quantile(xn, q[0]), np.quantile(xn, q[1])
        lo, hi = min(lo, float(ql)), max(hi, float(qh))
    span = max(hi - lo, 1e-6)
    lo, hi = lo - pad * span, hi + pad * span
    new_lims = (float(lo), float(hi))

    # 2. the layers on the refined span (shared h from the span)
    new_layers = [_relimited(layer, new_lims) for layer in chain.layers]
    new_chain = type(chain)(*new_layers)

    # 3. C refit on a DENSE per-dim input grid over the observed range
    # (the visited samples alone can be fewer than G), layer by layer:
    # layer l+1's range comes from the refit layer l, so the refit error
    # does not compound through the chain
    M = 96
    errs = []
    x_cur = x_samples
    t = torch.linspace(-pad, 1.0 + pad, M, device=x_samples.device)[:, None]
    for layer, new_layer in zip(chain.layers, new_layers):
        xi_min = torch.min(x_cur, dim=0).values           # [I]
        xi_max = torch.max(x_cur, dim=0).values
        span_i = torch.clamp_min(xi_max - xi_min, 1e-3)
        X_dense = xi_min[None, :] + t * span_i[None, :]    # [M, I]
        spline_old = torch.einsum("nig,igo->nio",
                                  layer.basis_values(X_dense), layer.C)
        bas_new = new_layer.basis_values(X_dense)          # [M, I, G]
        # lightly ridge-regularized normal equations, per input feature:
        # stable where the new centers overlap (rbf collinearity at small
        # spans)
        bn = bas_new.transpose(0, 1)                       # [I, M, G]
        A = bn.mT @ bn + 1e-8 * torch.eye(
            bn.shape[-1], device=bn.device)
        C_new = torch.linalg.solve(A, bn.mT @ spline_old.transpose(0, 1))
        new_layer.C.copy_(C_new)
        if layer.use_base_act:
            new_layer.W.copy_(layer.W)
        spline_new = torch.einsum("nig,igo->nio", bas_new, C_new)
        denom = float(torch.mean(spline_old ** 2)) + 1e-30
        errs.append(float(torch.mean((spline_new - spline_old) ** 2))
                    / denom)
        x_cur = new_layer.apply(x_cur)

    info = {"old_lims": tuple(chain.layers[0].grid_lims),
            "new_lims": new_lims,
            "relative_refit_error": errs}
    return new_chain, info
