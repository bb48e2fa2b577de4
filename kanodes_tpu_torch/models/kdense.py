"""KDense — the grid-basis KAN layer (port of `kanodes_tpu/models/kdense.py`).

Each scalar edge i->o is a learned function
    phi_{i,o}(x) = sum_g C[i,g,o] * basis((norm(x) - grid[g]) / h)
                   (+ W[i,o] * base_act(x)  when use_base_act)
and the layer output is o_j = sum_i phi_{i,j}(x_i)  (`kdense.jl:5-130`).

Same parameter names and layout as the JAX layer: `C` [I, G, O], `W`
[I, O] (none without the base activation), and with `trainable_grid` the
learned center offsets `grid_offset` [G] and log-bandwidth `log_h` [],
registered in that order, JAX's sorted-key leaf order; so params cross
between the packages as numpy arrays (`interop.py`). `KDense1` is the
reference's alternate shared-spline layer (`alternate.jl:7-70`).
"""

from __future__ import annotations

import torch
from torch import nn

from kanodes_tpu_torch.models.core import Chain, glorot_uniform
from kanodes_tpu_torch.ops import basis as B

Tensor = torch.Tensor


class KDense(nn.Module):
    """Grid-basis KAN layer (kdense.jl:20-37 constructor parity).

    Parameters are allocated on `device` (zeros; `log_h` = log h);
    `init(generator)` draws the reference's glorot init into them.
    `trainable_grid` learns per-layer center offsets and a
    log-bandwidth on the plain path; the fused kernels run the static
    grid, as JAX's do.
    """

    def __init__(self, in_dims: int, out_dims: int, grid_len: int,
                 normalizer: str = "tanh",
                 grid_lims: tuple[float, float] = (-1.0, 1.0),
                 denominator: float | None = None, basis: str = "rbf",
                 base_act: str = "swish", use_base_act: bool = True,
                 trainable_grid: bool = False, *, device=None):
        super().__init__()
        self.in_dims, self.out_dims, self.grid_len = in_dims, out_dims, \
            grid_len
        self.normalizer = normalizer
        self.grid_lims = tuple(grid_lims)
        self.denominator = denominator
        self.basis = basis
        self.base_act = base_act
        self.use_base_act = use_base_act
        self.trainable_grid = trainable_grid
        self.C = nn.Parameter(torch.zeros(in_dims, grid_len, out_dims,
                                          device=device))
        self.W = (nn.Parameter(torch.zeros(in_dims, out_dims, device=device))
                  if use_base_act else None)
        if trainable_grid:
            self.grid_offset = nn.Parameter(torch.zeros(grid_len,
                                                        device=device))
            self.log_h = nn.Parameter(torch.zeros((), device=device))
            self._reset_log_h()
        self.register_buffer(
            "grid_pts", B.make_grid(grid_len, self.grid_lims, device=device),
            persistent=False)

    @torch.no_grad()
    def _reset_log_h(self) -> None:
        # log h in float32, as JAX's jnp.log of the weak-typed float
        self.log_h.copy_(torch.log(torch.tensor(self.h, dtype=torch.float32)))

    @property
    def h(self) -> float:
        if self.denominator is not None:
            return self.denominator
        return B.default_denominator(self.grid_len, self.grid_lims)

    def grid(self) -> Tensor:
        return self.grid_pts

    def num_params(self) -> int:
        """C and W, as JAX counts them (the grid parameters are not)."""
        n = self.in_dims * self.grid_len * self.out_dims
        if self.use_base_act:
            n += self.in_dims * self.out_dims
        return n

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "KDense":
        """Glorot init with the reference's fans (C as [O, G*I]); the
        grid parameters start at offsets 0 and log h."""
        dev = self.C.device
        self.C.copy_(glorot_uniform(
            (self.in_dims, self.grid_len, self.out_dims),
            self.in_dims * self.grid_len, self.out_dims, generator,
            device=dev))
        if self.use_base_act:
            self.W.copy_(glorot_uniform((self.in_dims, self.out_dims),
                                        self.in_dims, self.out_dims,
                                        generator, device=dev))
        if self.trainable_grid:
            self.grid_offset.zero_()
            self._reset_log_h()
        return self

    def basis_values(self, x: Tensor) -> Tensor:
        """[..., I] -> [..., I, G] basis tensor on the normalized input."""
        xn = B.get_normalizer(self.normalizer)(x)
        grid, h = self.grid_pts, self.h
        if self.trainable_grid:
            grid = grid + self.grid_offset
            h = torch.exp(self.log_h)
        return B.get_basis(self.basis)(xn, grid, h)

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
        if self.use_base_act:
            y = y + B.get_base_act(self.base_act)(x) @ self.W
        return y

    def forward(self, x: Tensor) -> Tensor:
        return self.apply(x)

    def edge_activations(self, x: Tensor) -> Tensor:
        """Per-edge activations phi_{i->o}(x_i): [..., I, O]; their sum
        over i is `apply` (`Activation_getter.jl:3-63`)."""
        spline = torch.einsum("...ig,igo->...io", self.basis_values(x),
                              self.C)
        if not self.use_base_act:
            return spline
        base = B.get_base_act(self.base_act)(x)
        return spline + base[..., None] * self.W


class KDense1(nn.Module):
    """Alternate shared-spline KAN layer (`src/alternate.jl:7-70`): one
    spline a input (`C` [I, G], on tanh(x) over the grid (-1, 1) with
    h = 2/(G-1)), plus base_act(x) when use_base_act, then a linear mix
    `W` [I, O]. Kept for parity: the reference keeps it as a documented
    negative result ("doesn't train well", alternate.jl:4)."""

    def __init__(self, in_dims: int, out_dims: int, grid_len: int,
                 denominator: float | None = None, base_act: str = "swish",
                 use_base_act: bool = True, basis: str = "rbf", *,
                 device=None):
        super().__init__()
        self.in_dims, self.out_dims, self.grid_len = in_dims, out_dims, \
            grid_len
        self.denominator = denominator
        self.base_act = base_act
        self.use_base_act = use_base_act
        self.basis = basis
        self.C = nn.Parameter(torch.zeros(in_dims, grid_len, device=device))
        self.W = nn.Parameter(torch.zeros(in_dims, out_dims, device=device))
        self.register_buffer("grid_pts",
                             B.make_grid(grid_len, (-1.0, 1.0), device=device),
                             persistent=False)

    @property
    def h(self) -> float:
        if self.denominator is not None:
            return self.denominator
        return 2.0 / (self.grid_len - 1)

    def grid(self) -> Tensor:
        return self.grid_pts

    def num_params(self) -> int:
        return self.in_dims * (self.grid_len + self.out_dims)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "KDense1":
        """Glorot init with JAX's fans (C: I -> G, W: I -> O)."""
        dev = self.C.device
        self.C.copy_(glorot_uniform((self.in_dims, self.grid_len),
                                    self.in_dims, self.grid_len, generator,
                                    device=dev))
        self.W.copy_(glorot_uniform((self.in_dims, self.out_dims),
                                    self.in_dims, self.out_dims, generator,
                                    device=dev))
        return self

    def apply(self, x: Tensor) -> Tensor:
        """[..., I] -> [..., O]."""
        bas = B.get_basis(self.basis)(torch.tanh(x), self.grid_pts, self.h)
        spline = torch.sum(self.C * bas, dim=-1)               # [..., I]
        if self.use_base_act:
            spline = spline + B.get_base_act(self.base_act)(x)
        return spline @ self.W

    def forward(self, x: Tensor) -> Tensor:
        return self.apply(x)


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

    def num_params(self) -> int:
        """The layers' counts, as JAX's `Chain.num_params`."""
        return sum(layer.num_params() for layer in self.layers)

    def apply(self, x: Tensor, *, impl: str = "xla") -> Tensor:
        for layer in self.layers:
            x = layer.apply(x, impl=impl)
        return x
