"""Hidden-physics source-term recovery: Fisher-KPP and Allen-Cahn, 1-D and
2-D (port of `kanodes_tpu/experiments/pde_source.py`).

Rebuild of `PDE examples/Fisher-KPP_Source.jl` and `Allen-Cahn_Source.jl`:
a known diffusion operator plus a pointwise 1->1 KAN as the unknown
reaction term,
    du/dt = D * lap_cyclic @ u + kan.(u)        (rc_kanode, :95-98)
trained on snapshots of the true dynamics, then symbolic regression on
the learned scalar function recovers the reaction law (:216-234).

`impl="xla"` integrates with the plain fixed-step Tsit5 of
`ode/integrate.py` (autograd through every stage); `impl="fused"` runs
every RK step as one launch of the gray-box kernel K5 and its adjoint as
one more (`ops/graybox_fused.py`, `csrc/graybox.cu`), in 2-D with the
Kronecker-sum Laplacian factored inside the kernel. Kernels run on CUDA
tensors and their plain versions on CPU tensors. The sharded path
(`sp>1`) and `bwd_precision="bf16"` raise NotImplementedError naming
their ROADMAP.md item.

Run:  python -m kanodes_tpu_torch.experiments.pde_source [--key=value ...]
      [--device=cuda|cpu]   (default cuda; raises without a card)
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from kanodes_tpu_torch.interop import kdense_params_from_numpy
from kanodes_tpu_torch.models.kdense import KDense
from kanodes_tpu_torch.ode.integrate import odeint_fixed
from kanodes_tpu_torch.pde import datagen
from kanodes_tpu_torch.train.loop import TrainConfig, train
from kanodes_tpu_torch.utils.device import require_device
from kanodes_tpu_torch.utils.precision import set_exact_f32


@dataclasses.dataclass(frozen=True)
class SourceConfig:
    """The JAX package's SourceConfig without `max_iters_per_call` (a TPU
    execution bound). Values outside the slice raise when used."""
    problem: str = "fisher_kpp"        # fisher_kpp | allen_cahn
    # beyond parity: 2-D problems on periodic square grids (the
    # reference is 1-D only)
    ndim: int = 1
    grid_n: int | None = None          # 2-D grid points per side
    kan_grid: int = 10                 # KANgrid=10 (:82-86)
    normalizer: str = "softsign"       # (:81)
    lr: float = 1e-2                   # Adam 1e-2 (:167-170)
    iters: int = 2000                  # reference: 2e4 (fkpp) / 5e4 (AC)
    eval_every: int = 500
    substeps: int | None = None        # None -> per-problem default
    impl: str = "xla"                  # xla | fused (whole-RK-step kernel)
    bwd_precision: str = "highest"     # "bf16": later
    seed: int = 0
    sp: int = 1                        # >1: sharded grid, later (M16)
    # dataset overrides (None -> reference values)
    data_dx: float | None = None
    data_substeps: int | None = None

    def resolved_substeps(self) -> int:
        if self.substeps is not None:
            return self.substeps
        if self.ndim == 2:
            # fisher: lambda = 8*D/dx^2 (5-point stencil) = 81.9 at
            # n=32; tsit5 real-axis bound ~3.3 -> dt <= 0.04 -> 16/0.5.
            # AC: tiny diffusion + dt=0.01 saves -> 1-D default carries
            return 16 if self.problem == "fisher_kpp" else 2
        # fkpp saves every dt=0.5 with diffusion lambda ~25 -> h=0.0625;
        # AC saves every dt=0.01 with lambda ~15 -> one step is plenty
        return 8 if self.problem == "fisher_kpp" else 2


def _check_slice(cfg: SourceConfig) -> None:
    """Raise on what this slice of the port does not run yet."""
    if cfg.sp > 1:
        raise NotImplementedError(
            f"SourceConfig(sp={cfg.sp}) is not ported yet (ROADMAP.md, M16 "
            "pde/sharded.py)")
    if cfg.impl not in ("xla", "fused"):
        raise ValueError(f"impl must be 'xla' or 'fused', got {cfg.impl!r}")
    if cfg.impl == "fused":
        from kanodes_tpu_torch.ops.rk_fused import check_bwd_precision
        check_bwd_precision(cfg.bwd_precision)


def make_data(cfg: SourceConfig) -> datagen.PDEData:
    """Host float64 truth snapshots (numpy; `make_fns` sends them to the
    model's device as float32)."""
    kw = {}
    if cfg.data_substeps is not None:
        kw["substeps"] = cfg.data_substeps
    if cfg.ndim == 2:
        if cfg.data_dx is not None:
            raise ValueError("data_dx is 1-D only; use grid_n for ndim=2")
        if cfg.grid_n is not None:
            kw["n"] = cfg.grid_n
        if cfg.problem == "fisher_kpp":
            return datagen.fisher_kpp_2d(**kw)
        if cfg.problem == "allen_cahn":
            return datagen.allen_cahn_source_2d(**kw)
        raise ValueError(cfg.problem)
    if cfg.data_dx is not None:
        kw["dx"] = cfg.data_dx
    if cfg.problem == "fisher_kpp":
        return datagen.fisher_kpp(**kw)
    if cfg.problem == "allen_cahn":
        return datagen.allen_cahn_source(**kw)
    raise ValueError(cfg.problem)


def truth_reaction(cfg: SourceConfig):
    if cfg.problem == "fisher_kpp":
        return lambda u: u * (1 - u)
    return lambda u: 5.0 * u - 5.0 * u ** 3


def make_model(cfg: SourceConfig, device="cuda") -> KDense:
    return KDense(1, 1, cfg.kan_grid, normalizer=cfg.normalizer,
                  device=require_device(device))


def _fused_predict(cfg, advance, u0, data):
    """The fused path's prediction: one kernel step at the Python-float
    dt_save / sub, every sub-th state kept."""
    sub = cfg.resolved_substeps()
    dt_save = float(data.ts[1] - data.ts[0])
    n_steps = (len(data.ts) - 1) * sub

    def predict(m):
        return advance(dict(m.named_parameters()), u0, dt_save / sub,
                       n_steps)[::sub]

    return predict


def make_fns(cfg: SourceConfig, model: KDense, data: datagen.PDEData):
    """(loss_fn, eval_fn, predict), each taking the model: the MSE of the
    predicted snapshots against the truth (the eval is the same loss)."""
    _check_slice(cfg)
    if cfg.ndim == 2:
        return _make_fns_2d(cfg, model, data)
    dev = model.C.device
    lap = torch.as_tensor(datagen._cyclic_lap(len(data.x), data.dx),
                          dtype=torch.float32, device=dev)
    D = data.meta["D"]
    X = torch.as_tensor(data.X, dtype=torch.float32, device=dev)
    u0 = X[0]

    def rhs(t, u, m):
        known = D * torch.matmul(lap, u)
        learned = m.apply(u[:, None])[:, 0]
        return known + learned

    if cfg.impl == "fused":
        from kanodes_tpu_torch.ops.graybox_fused import graybox_kernel_adapter
        _, advance = graybox_kernel_adapter(model, lap, float(D),
                                            cfg.bwd_precision)
        predict = _fused_predict(cfg, advance, u0, data)
    else:
        def predict(m):
            return odeint_fixed(rhs, u0, data.ts, m, solver="tsit5",
                                substeps=cfg.resolved_substeps())

    def loss_fn(m):
        return torch.mean((predict(m) - X) ** 2)

    return loss_fn, loss_fn, predict


def _make_fns_2d(cfg: SourceConfig, model: KDense, data: datagen.PDEData):
    """2-D gray-box objective: du/dt = D*lap2d(u) + kan.(u), u [n, n].
    The XLA path: the 5-point roll stencil and the layer over all n*n
    nodes; the fused path: K5 with the Kronecker-sum Laplacian factored
    as L@U + U@L."""
    from kanodes_tpu_torch.pde.operators import laplacian_periodic_2d

    dev = model.C.device
    D = float(data.meta["D"])
    dx = float(data.dx)
    X = torch.as_tensor(data.X, dtype=torch.float32, device=dev)
    u0 = X[0]
    n = u0.shape[0]

    if cfg.impl == "fused":
        from kanodes_tpu_torch.ops.graybox_fused import \
            graybox_kron_kernel_adapter
        _, advance = graybox_kron_kernel_adapter(
            model, datagen._cyclic_lap(n, dx), D, cfg.bwd_precision)
        predict = _fused_predict(cfg, advance, u0, data)
    else:
        def rhs(t, u, m):
            known = D * laplacian_periodic_2d(u, dx)
            learned = m.apply(u.reshape(-1, 1)).reshape(u.shape)
            return known + learned

        def predict(m):
            return odeint_fixed(rhs, u0, data.ts, m, solver="tsit5",
                                substeps=cfg.resolved_substeps())

    def loss_fn(m):
        return torch.mean((predict(m) - X) ** 2)

    return loss_fn, loss_fn, predict


def run(cfg: SourceConfig | None = None, params=None, *, device="cuda",
        generator: torch.Generator | None = None) -> dict[str, Any]:
    """Train the gray-box source model end to end on `device`; returns
    the `train()` dict plus cfg, model, data and predict.

    `params`: the layer's `{"C", "W"}` numpy arrays to start from (e.g. a
    JAX init, `interop.py`); default is the layer's glorot init drawn
    from `generator` (a CPU generator seeded with `cfg.seed` if None).
    The loss is evaluated again after every block of `eval_every`
    iterations (`eval_history`; the JAX run records NaN there).
    """
    cfg = cfg or SourceConfig()
    _check_slice(cfg)
    set_exact_f32()
    data = make_data(cfg)
    model = make_model(cfg, device)
    if params is None:
        model.init(generator if generator is not None
                   else torch.Generator().manual_seed(cfg.seed))
    else:
        kdense_params_from_numpy(model, params)
    loss_fn, eval_fn, predict = make_fns(cfg, model, data)
    tc = TrainConfig(lr=cfg.lr, iters=cfg.iters, eval_every=cfg.eval_every)
    out = train(loss_fn, model, tc, eval_fn=eval_fn)
    out.update(cfg=cfg, model=model, data=data, predict=predict)
    return out


def _learned(out: dict):
    """The trained layer at its best parameters as a numpy function."""
    model, params = out["model"], out["best_params"]
    dev = model.C.device

    def learned(u):
        x = torch.as_tensor(np.asarray(u), dtype=torch.float32, device=dev)
        with torch.no_grad():
            y = torch.func.functional_call(model, params, (x[:, None],))
        return y[:, 0].cpu().numpy()

    return learned


def recover_source(out: dict, generations: int = 250,
                   seed: int = 0,
                   ops: tuple = ("+", "-", "*"),
                   method: str = "gp") -> dict:
    """SR post-pass on the trained 1->1 KAN over the state range — the
    reference's SRRegressor step (`Fisher-KPP_Source.jl:216-234`,
    recovered 0.9953*x*(1.0024-x)). method="sindy" swaps the GP search
    for the closed-form STLSQ engine (`symbolic/sindy.py`). Host code,
    except the layer's evaluation on its device."""
    from kanodes_tpu_torch.symbolic.fit import (fit_scalar_function,
                                                simplify_expression)

    X = np.asarray(out["data"].X)
    lo, hi = float(X.min()), float(X.max())
    learned = _learned(out)

    if method == "sindy":
        from kanodes_tpu_torch.symbolic.sindy import fit_sindy
        u = np.linspace(lo, hi, 400)[:, None]
        fit = fit_sindy(u, learned(u[:, 0]), degree=4, threshold="auto")[0]
        return {"fit": fit, "pretty": simplify_expression(fit.expression),
                "range": (lo, hi)}

    # polynomial-only ops by default: the reference's source laws are
    # polynomial and '/' invites rational overfits of KAN approx error
    fit = fit_scalar_function(learned, lo, hi, generations=generations,
                              seed=seed, ops=ops)
    return {"fit": fit, "pretty": simplify_expression(fit.expression),
            "range": (lo, hi)}


def recover_source_from_data(data: datagen.PDEData, *, ndim: int = 1,
                             degree: int = 4, **kw) -> dict:
    """NO-TRAINING source recovery straight from the snapshots:
    estimate du/dt by 4th-order central differences on the save grid,
    subtract the KNOWN diffusion term, and SINDy-fit the pointwise
    residual against the state. Host numpy; returns the same dict shape
    as `recover_source`."""
    from kanodes_tpu_torch.symbolic.fit import simplify_expression
    from kanodes_tpu_torch.symbolic.sindy import fit_sindy

    ts = np.asarray(data.ts, np.float64)
    X = np.asarray(data.X, np.float64)
    h = float(np.diff(ts).mean())
    dXdt = (-X[4:] + 8.0 * X[3:-1] - 8.0 * X[1:-3] + X[:-4]) / (12.0 * h)
    Xi = X[2:-2]
    D = float(data.meta["D"])
    if ndim == 2:
        known = D * np.stack([datagen._lap2d_periodic_np(u, data.dx)
                              for u in Xi])
    else:
        lap = datagen._cyclic_lap(X.shape[1], data.dx)
        known = D * (Xi @ lap.T)
    resid = (dXdt - known).reshape(-1)
    u = Xi.reshape(-1, 1)
    kw.setdefault("gamma", 1.0)      # FD truncation error, as in
    fit = fit_sindy(u, resid, degree=degree, **kw)[0]  # fit_sindy_trajectory
    return {"fit": fit, "pretty": simplify_expression(fit.expression),
            "range": (float(u.min()), float(u.max()))}


# the reference's full training budgets (Fisher-KPP_Source.jl:170 2e4
# iterations; Allen-Cahn_Source.jl:164 5e4)
BUDGETS = {"fisher_kpp": 20_000, "allen_cahn": 50_000}


def main(argv: list[str]) -> int:
    """Both problems at the reference budgets on the fused kernel, each
    followed by the GP recovery of its law; `--problem=` runs one, and
    `--key=value` (or KANODE_SOURCE_<KEY>) overrides any SourceConfig
    field."""
    import time

    from kanodes_tpu_torch.train.config import (override_from_args,
                                                override_from_env)

    device = "cuda"
    problems = list(BUDGETS)
    for a in argv:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        if a.startswith("--problem="):
            problems = [a.split("=", 1)[1]]
    for problem in problems:
        cfg = SourceConfig(problem=problem, iters=BUDGETS.get(problem, 2000),
                           eval_every=5000, impl="fused")
        cfg = override_from_env(cfg, "KANODE_SOURCE_")
        cfg = override_from_args(cfg, argv)
        t0 = time.perf_counter()
        out = run(cfg, device=device)
        best = float(out["best_loss"])             # waits for the device
        dt = time.perf_counter() - t0
        rec = recover_source(out)
        print(f"{problem}: loss {best:.3e} ({cfg.iters} iters in {dt:.1f}s, "
              f"{cfg.iters / dt:.1f} it/s on {device}) recovered: "
              f"{rec['pretty']}", flush=True)
    return 0


if __name__ == "__main__":
    import sys

    raise SystemExit(main(sys.argv[1:]))
