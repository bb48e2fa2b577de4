"""Serializable model specs: rebuild a model from a checkpoint (port of
`kanodes_tpu/deploy/spec.py`, kinds "kan", "mlp" and "bspline_kan").

The reference's checkpoints carry the network shape next to the weights
(`size_KAN` in the .mat files, `LV_driver_KANODE.jl:252-272`), so that
post-hoc tools can rebuild the model without the training script's
constants. A spec is a small JSON-able dict naming the model family and
its constructor arguments; `lv.run` stores it in
`TrainState.extra["model_spec"]`. Parameters stay in the checkpoint.

A "kan" spec records `use_base_act` and `trainable_grid` as JAX's
does; a "bspline_kan" spec its widths, grid size and spline order (the
knot grid is state that `update_grid` moves: it is in the checkpoint's
parameters, not the spec); a "kanpinn" spec the strain-limiting PINN's
widths, basis count and center flavor. Export and the deploy CLI are
M15.
"""

from __future__ import annotations

from typing import Any

from kanodes_tpu_torch.models.bspline import BSplineKAN, BSplineKANChain
from kanodes_tpu_torch.models.kdense import KANChain, KDense
from kanodes_tpu_torch.models.mlp import MLP
from kanodes_tpu_torch.pinn.model import KANPINN


def spec_of(model) -> dict[str, Any]:
    """The spec dict of a live model: a chain of KDense layers, an MLP,
    a B-spline chain or the KAN-PINN."""
    if isinstance(model, KANChain) and all(
            isinstance(l, KDense) for l in model.layers):
        l0 = model.layers[0]
        if not isinstance(l0.basis, str):
            raise TypeError(
                "spec_of cannot serialize a callable basis; use a "
                "named basis ('rbf'/'rswaf'/'iqf') for checkpoint->"
                "deploy rebuilds")
        # the spec records layer 0's attributes chain-wide; a
        # heterogeneous chain would rebuild silently wrong
        for k in ("grid_len", "basis", "normalizer", "grid_lims",
                  "denominator", "base_act", "use_base_act",
                  "trainable_grid"):
            vals = {getattr(l, k) for l in model.layers}
            if len(vals) != 1:
                raise ValueError(
                    f"spec_of needs homogeneous KDense layers; "
                    f"attribute {k!r} differs across layers: {vals}")
        widths = [l0.in_dims] + [l.out_dims for l in model.layers]
        return {
            "kind": "kan",
            "widths": widths,
            "grid_len": l0.grid_len,
            "basis": l0.basis,
            "normalizer": l0.normalizer,
            "grid_lims": list(l0.grid_lims),
            "denominator": l0.denominator,
            "base_act": l0.base_act,
            "use_base_act": l0.use_base_act,
            "trainable_grid": l0.trainable_grid,
        }
    if isinstance(model, MLP):
        return {
            "kind": "mlp",
            "widths": list(model.widths),
            "activation": model.activation,
            "final_activation": model.final_activation,
            "use_bias": model.use_bias,
        }
    if isinstance(model, BSplineKANChain) and all(
            isinstance(l, BSplineKAN) for l in model.layers):
        l0 = model.layers[0]
        for k in ("grid_size", "spline_order"):
            vals = {getattr(l, k) for l in model.layers}
            if len(vals) != 1:
                raise ValueError(
                    f"spec_of needs homogeneous BSplineKAN layers; "
                    f"attribute {k!r} differs across layers: {vals}")
        widths = [l0.in_dims] + [l.out_dims for l in model.layers]
        return {
            "kind": "bspline_kan",
            "widths": widths,
            "grid_size": l0.grid_size,
            "spline_order": l0.spline_order,
        }
    if isinstance(model, KANPINN):
        return {
            "kind": "kanpinn",
            "widths": list(model.widths),
            "n_basis": model.n_basis,
            "trainable_centers": model.trainable_centers,
        }
    raise TypeError(f"no spec rule for model type {type(model).__name__}")


def model_from_spec(spec: dict[str, Any], *, device=None):
    """Rebuild a model (parameters zero, on `device`) from `spec_of`'s
    output or a hand-written spec."""
    kind = spec["kind"]
    if kind == "kan":
        kw = {k: spec[k] for k in ("basis", "normalizer", "denominator",
                                   "base_act", "use_base_act",
                                   "trainable_grid") if k in spec}
        if "grid_lims" in spec:
            kw["grid_lims"] = tuple(spec["grid_lims"])
        return KANChain.mlp_like(list(spec["widths"]),
                                 grid_len=spec["grid_len"], device=device,
                                 **kw)
    if kind == "mlp":
        kw = {k: spec[k] for k in ("activation", "final_activation",
                                   "use_bias") if k in spec}
        return MLP(tuple(spec["widths"]), device=device, **kw)
    if kind == "bspline_kan":
        kw = {k: spec[k] for k in ("grid_size", "spline_order") if k in spec}
        return BSplineKANChain(list(spec["widths"]), device=device, **kw)
    if kind == "kanpinn":
        kw = {k: spec[k] for k in ("n_basis", "trainable_centers")
              if k in spec}
        return KANPINN(tuple(spec["widths"]), device=device, **kw)
    raise ValueError(f"unknown model spec kind: {kind!r}")
