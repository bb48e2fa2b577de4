"""Gaussian-basis KAN layers for the strain-limiting PINN (port of
`kanodes_tpu/pinn/model.py`).

Two flavors, as in JAX:
  * `GaussianKANLayer` — trainable coeff/lin/bias + TRAINABLE centers and
    log-widths (the Python flavor, `StrainLimiting_KAN_PINN.py:188-213`);
  * the Julia flavor (`StrainLimiting_KAN_PINN.jl:12-48`) has fixed
    centers — `trainable_centers=False`: `centers` and `logwidth` stay
    parameters (JAX's layout) that do not require grad, so they get no
    gradient and no optimizer moves them, as JAX's `stop_gradient` leaves
    them with a zero one.

`KANPINN` stacks them with tanh between hidden layers
(`StrainLimiting_KAN_PINN.py:216-227`: [2, H, H, H, 1]; Julia
[2, 32, 32, 1] :50-58 — depth configurable).

Parameters under JAX's names and shapes, layer by layer: `coeff` [I, B, O],
`lin` [I, O], `bias` [O], `centers` [B], `logwidth` [B]. Everything is
plain torch, no custom backward: the PINN residual differentiates the
field twice in the input and the loss then once more in the parameters.
The two products are `torch.matmul` in float32 (no TF32 on the entry
points, `utils/precision.set_exact_f32`), as JAX computes them at
HIGHEST outside any Pallas kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

Tensor = torch.Tensor


class GaussianKANLayer(nn.Module):
    """One layer: lin_part + basis_part + bias, the basis exp(-z^2) with
    z = (x - centers) / (exp(logwidth) + 1e-5), flattened to [.., I*B].
    Parameters are allocated on `device` (centers and log-widths at
    their init values, the rest zero); `init(generator)` draws the
    weights."""

    def __init__(self, in_dims: int, out_dims: int, n_basis: int,
                 scale: float = 0.1, trainable_centers: bool = True,
                 center_range: tuple[float, float] = (0.0, 1.0),
                 init_logwidth: float = math.log(0.15), *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.in_dims, self.out_dims, self.n_basis = in_dims, out_dims, n_basis
        self.scale = scale
        self.trainable_centers = trainable_centers
        self.center_range = tuple(center_range)
        self.init_logwidth = init_logwidth
        kw = dict(device=device, dtype=dtype)
        self.coeff = nn.Parameter(torch.zeros(in_dims, n_basis, out_dims,
                                              **kw))
        self.lin = nn.Parameter(torch.zeros(in_dims, out_dims, **kw))
        self.bias = nn.Parameter(torch.zeros(out_dims, **kw))
        self.centers = nn.Parameter(
            torch.linspace(self.center_range[0], self.center_range[1],
                           n_basis, **kw), requires_grad=trainable_centers)
        self.logwidth = nn.Parameter(
            torch.full((n_basis,), init_logwidth, **kw),
            requires_grad=trainable_centers)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "GaussianKANLayer":
        """JAX's distributions and scales: coeff and lin scale * N(0, 1),
        bias zero, centers linspace(center_range, B), log-widths
        init_logwidth. Drawn on the generator's device, then copied."""
        gdev = generator.device
        for p in (self.coeff, self.lin):
            p.copy_(self.scale * torch.randn(p.shape, generator=generator,
                                             device=gdev, dtype=p.dtype))
        self.bias.zero_()
        self.centers.copy_(torch.linspace(
            self.center_range[0], self.center_range[1], self.n_basis,
            dtype=self.centers.dtype))
        self.logwidth.fill_(self.init_logwidth)
        return self

    def forward(self, x: Tensor) -> Tensor:
        widths = torch.exp(self.logwidth) + 1e-5                  # (:205)
        z = (x[..., None] - self.centers) / widths                # [.., I, B]
        bi = torch.exp(-(z * z))
        flat = bi.reshape(*bi.shape[:-2], self.in_dims * self.n_basis)
        cflat = self.coeff.reshape(self.in_dims * self.n_basis,
                                   self.out_dims)
        basis_part = torch.matmul(flat, cflat)
        lin_part = torch.matmul(x, self.lin)
        return lin_part + basis_part + self.bias

    def num_params(self) -> int:
        n = self.in_dims * self.n_basis * self.out_dims \
            + self.in_dims * self.out_dims + self.out_dims
        n += 2 * self.n_basis
        return n


class KANPINN(nn.Module):
    """tanh-coupled Gaussian-KAN stack; widths e.g. (2, 96, 96, 96, 1)."""

    def __init__(self, widths: tuple[int, ...] = (2, 96, 96, 96, 1),
                 n_basis: int = 48, trainable_centers: bool = True, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.widths = tuple(widths)
        self.n_basis = n_basis
        self.trainable_centers = trainable_centers
        self.layers = nn.ModuleList(
            GaussianKANLayer(i, o, n_basis,
                             trainable_centers=trainable_centers,
                             device=device, dtype=dtype)
            for i, o in zip(self.widths[:-1], self.widths[1:]))

    @property
    def in_dims(self) -> int:
        return self.widths[0]

    @property
    def out_dims(self) -> int:
        return self.widths[-1]

    def init(self, generator: torch.Generator) -> "KANPINN":
        """Each layer's `init` in turn from one generator (torch cannot
        draw jax.random's numbers; a run that must match JAX loads JAX's
        init with `interop.pinn_params_from_numpy`)."""
        for layer in self.layers:
            layer.init(generator)
        return self

    def forward(self, x: Tensor) -> Tensor:
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < n - 1:
                x = torch.tanh(x)
        return x

    def phi(self, xy: Tensor) -> Tensor:
        """Scalar field: [N, 2] -> [N] (phi_scalar, :631-633)."""
        return self(xy)[..., 0]

    def num_params(self) -> int:
        return sum(l.num_params() for l in self.layers)


# a layer's parameters in JAX's per-layer dict
LAYER_KEYS = ("coeff", "lin", "bias", "centers", "logwidth")


def named_params(model: KANPINN, params) -> dict[str, Tensor]:
    """`params` as a name -> tensor dict (`named_parameters()`'s names) on
    the model's device and in its dtype, outside autograd: JAX's list of
    per-layer dicts (`LAYER_KEYS`, numpy or JAX arrays, e.g. the pickled
    list of `artifacts/pinn_adaptive_best_params.npy`) or a name ->
    array or tensor dict (a checkpoint's, `train`'s `best_params`).
    Names and shapes must match exactly."""
    if isinstance(params, (list, tuple)):
        if len(params) != len(model.layers):
            raise ValueError(f"{len(params)} param dicts for "
                             f"{len(model.layers)} layers")
        flat = {}
        for i, d in enumerate(params):
            if set(d) != set(LAYER_KEYS):
                raise ValueError(f"layer {i} keys {sorted(d)} != "
                                 f"{sorted(LAYER_KEYS)}")
            flat.update({f"layers.{i}.{k}": v for k, v in d.items()})
        params = flat
    own = dict(model.named_parameters())
    if set(params) != set(own):
        raise ValueError(f"parameter names {sorted(params)} != "
                         f"{sorted(own)}")
    out = {}
    for name, v in params.items():
        dst = own[name]
        t = (v.detach() if isinstance(v, torch.Tensor)
             else torch.from_numpy(np.array(v)))
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(dst.shape)}")
        out[name] = t.to(device=dst.device, dtype=dst.dtype)
    return out


@torch.no_grad()
def load_params(model: KANPINN, params) -> None:
    """Copy `params` (either layout of `named_params`) into the model's
    parameters."""
    for name, t in named_params(model, params).items():
        model.get_parameter(name).copy_(t)


def params_dtype(params) -> torch.dtype:
    """float64 for float64 arrays (JAX's x64 init), else float32."""
    first = params[0]["coeff"] if isinstance(params, (list, tuple)) \
        else next(iter(params.values()))
    if isinstance(first, torch.Tensor):
        return first.dtype
    return torch.float64 if np.asarray(first).dtype == np.float64 \
        else torch.float32


def frozen_phi(model: KANPINN):
    """The batched field at the model's current parameters, outside the
    parameters' autograd graph (for scoring and evaluation)."""
    return phi_of(model, {n: p.detach() for n, p in model.named_parameters()})


def phi_of(model: KANPINN, params: dict[str, Tensor] | None = None):
    """The batched field [N, 2] -> [N] of `model` at `params` (name ->
    tensor, `named_parameters()`'s names; None: the model's own)."""
    if params is None:
        return model.phi
    return lambda xy: torch.func.functional_call(model, params, (xy,))[..., 0]
