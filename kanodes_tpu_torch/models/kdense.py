"""KDense — the grid-basis KAN layer (port of `kanodes_tpu/models/kdense.py`).

Each scalar edge i->o is a learned function
    phi_{i,o}(x) = sum_g C[i,g,o] * basis((norm(x) - grid[g]) / h)
                   + W[i,o] * base_act(x)
and the layer output is o_j = sum_i phi_{i,j}(x_i)  (`kdense.jl:5-130`).

Same parameter names and layout as the JAX layer: `C` [I, G, O] and
`W` [I, O], so params cross between the packages as numpy arrays
(`interop.py`). `KDense1` and `trainable_grid` are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from kanodes_tpu_torch.models.core import Chain, glorot_uniform
from kanodes_tpu_torch.ops import basis as B

Tensor = torch.Tensor


class KDense(nn.Module):
    """Grid-basis KAN layer (kdense.jl:20-37 constructor parity).

    Parameters are allocated as zeros on `device`; `init(generator)`
    draws the reference's glorot init into them.
    """

    def __init__(self, in_dims: int, out_dims: int, grid_len: int,
                 normalizer: str = "tanh",
                 grid_lims: tuple[float, float] = (-1.0, 1.0),
                 denominator: float | None = None, basis: str = "rbf",
                 base_act: str = "swish", use_base_act: bool = True,
                 *, device=None):
        super().__init__()
        if not use_base_act:
            raise NotImplementedError(
                "use_base_act=False is not ported yet (ROADMAP.md, M2)")
        self.in_dims, self.out_dims, self.grid_len = in_dims, out_dims, \
            grid_len
        self.normalizer = normalizer
        self.grid_lims = tuple(grid_lims)
        self.denominator = denominator
        self.basis = basis
        self.base_act = base_act
        self.use_base_act = use_base_act
        self.C = nn.Parameter(torch.zeros(in_dims, grid_len, out_dims,
                                          device=device))
        self.W = nn.Parameter(torch.zeros(in_dims, out_dims, device=device))
        self.register_buffer(
            "grid_pts", B.make_grid(grid_len, self.grid_lims, device=device),
            persistent=False)

    @property
    def h(self) -> float:
        if self.denominator is not None:
            return self.denominator
        return B.default_denominator(self.grid_len, self.grid_lims)

    def grid(self) -> Tensor:
        return self.grid_pts

    def num_params(self) -> int:
        return self.in_dims * self.grid_len * self.out_dims \
            + self.in_dims * self.out_dims

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "KDense":
        """Glorot init with the reference's fans (C as [O, G*I])."""
        dev = self.C.device
        self.C.copy_(glorot_uniform(
            (self.in_dims, self.grid_len, self.out_dims),
            self.in_dims * self.grid_len, self.out_dims, generator,
            device=dev))
        self.W.copy_(glorot_uniform((self.in_dims, self.out_dims),
                                    self.in_dims, self.out_dims, generator,
                                    device=dev))
        return self

    def basis_values(self, x: Tensor) -> Tensor:
        """[..., I] -> [..., I, G] basis tensor on the normalized input."""
        xn = B.get_normalizer(self.normalizer)(x)
        return B.get_basis(self.basis)(xn, self.grid_pts, self.h)

    def apply(self, x: Tensor, *, impl: str = "xla") -> Tensor:
        """Forward pass [..., I] -> [..., O]. `impl="xla"` is the plain
        composition; `impl="pallas"` runs the single-layer kernel K9
        (`ops/kdense_pallas.kdense_pallas`; rbf layers only)."""
        if impl == "pallas":
            from kanodes_tpu_torch.ops.kdense_pallas import kdense_pallas
            return kdense_pallas(self, x)
        if impl != "xla":
            raise ValueError(f"impl must be 'xla' or 'pallas', got {impl!r}")
        bas = self.basis_values(x)
        flat = bas.reshape(*bas.shape[:-2], self.in_dims * self.grid_len)
        y = flat @ self.C.reshape(self.in_dims * self.grid_len,
                                  self.out_dims)
        return y + B.get_base_act(self.base_act)(x) @ self.W

    def forward(self, x: Tensor) -> Tensor:
        return self.apply(x)

    def edge_activations(self, x: Tensor) -> Tensor:
        """Per-edge activations phi_{i->o}(x_i): [..., I, O]; their sum
        over i is `apply` (`Activation_getter.jl:3-63`)."""
        spline = torch.einsum("...ig,igo->...io", self.basis_values(x),
                              self.C)
        base = B.get_base_act(self.base_act)(x)
        return spline + base[..., None] * self.W


class KANChain(Chain):
    """Chain of KDense layers — `Lux.Chain(KDense, KDense)`
    (`LV_driver_KANODE.jl:136-142`)."""

    @classmethod
    def mlp_like(cls, widths: list[int], grid_len: int, *, device=None,
                 **kw) -> "KANChain":
        return cls(*[KDense(i, o, grid_len, device=device, **kw)
                     for i, o in zip(widths[:-1], widths[1:])])

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "KANChain":
        for layer in self.layers:
            layer.init(generator)
        return self

    def apply(self, x: Tensor, *, impl: str = "xla") -> Tensor:
        for layer in self.layers:
            x = layer.apply(x, impl=impl)
        return x
