"""Lotka-Volterra KAN-ODE — the canonical experiment (port of
`kanodes_tpu/experiments/lv.py`: fixed, shooting and adaptive modes).

Reference experimental protocol (`Lotka-Volterra/LV_driver_KANODE.jl`):
  truth:    dx = alpha x - beta x y ; dy = gamma x y - delta y,
            (alpha,beta,gamma,delta) = (1.5, 1, 1, 3), u0 = (1, 1)
  data:     saveat dt=0.1 over t in (0, 14); train on the first
            floor(141 * 3.5/14) = 35 points, test on the full horizon
  model:    KDense chain [2, 10, 2], grid 5, rbf basis, tanh normalizer;
            init = glorot / 1e5
  loss:     MSE over the train horizon, Adam

`impl="fused"` runs every RK step through the hand-written CUDA kernels
of `ops/rk_fused.py` (fixed, shooting) or the whole adaptive solve
through the one of `ops/rk_adaptive_fused.py` (adaptive);
`impl="pallas"` evaluates every right-hand side through the chain
kernel of `ops/kdense_pallas.py` inside the plain integrators;
`impl="xla"` composes plain torch ops and autograd. Kernels run on CUDA
tensors and their plain versions on CPU tensors. `solve_mode="adaptive"`
is the reference-faithful protocol: adaptive Tsit5 with a step
controller, differentiated straight through the controller loop
(`LV_driver_KANODE.jl:180-184`). `make_ode_fns(reduce_fn=, n_members=)`
trains a packed ensemble (`models/packed.py`, driven by
`experiments/lv_members.py`), one controller per member in adaptive
mode. What lies outside this slice raises NotImplementedError naming
its ROADMAP.md item.

Run:  python -m kanodes_tpu_torch.experiments.lv [--key=value ...]
      [--device=cuda|cpu]   (default cuda; raises without a card)
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from kanodes_tpu_torch.interop import chain_params_from_numpy
from kanodes_tpu_torch.models.kdense import KANChain
from kanodes_tpu_torch.ode.integrate import (StepController, odeint,
                                             odeint_fixed, odeint_members)
from kanodes_tpu_torch.train.loop import TrainConfig, train
from kanodes_tpu_torch.utils.device import require_device
from kanodes_tpu_torch.utils.host_rk import rk4_dense
from kanodes_tpu_torch.utils.precision import set_exact_f32

LV_PARAMS = (1.5, 1.0, 1.0, 3.0)


@dataclasses.dataclass(frozen=True)
class LVConfig:
    """The JAX package's LVConfig. `max_iters_per_call` is the training
    loop's chunk: it shapes the iteration and eval schedule as in JAX
    (`train.loop.TrainConfig`) and bounds no execution. Values outside
    the slice raise when used."""
    # data (reference values, LV_driver_KANODE.jl:110-127)
    tspan: tuple[float, float] = (0.0, 14.0)
    train_tmax: float = 3.5
    dt: float = 0.1
    u0: tuple[float, float] = (1.0, 1.0)
    # model
    model: str = "kan"                 # kan (mlp, bspline_kan: later)
    layer_width: int = 10
    kan_widths: tuple[int, ...] | None = None
    grid_size: int = 5
    basis: str = "rbf"
    normalizer: str = "tanh"
    mlp_widths: tuple[int, ...] = (2, 50, 2)
    init_scale: float = 1e-5           # glorot/1e5, :179
    # training
    lr: float = 5e-4
    iters: int = 10_000
    eval_every: int = 100
    sparse_on: bool = False
    act_reg: float = 5e-4
    entropy_reg: float = 0.0
    # solver
    solve_mode: str = "fixed"          # fixed | shooting | adaptive
    substeps: int = 1                  # fixed-mode Tsit5 steps per interval
    segment_len: int = 1               # shooting-mode intervals per segment
    rtol: float = 1e-6
    atol: float = 1e-8
    max_steps: int = 256
    # adaptive-mode differentiation strategy: direct | direct_remat
    # (interpolating, backsolve: later)
    adjoint: str = "direct"
    # xla: plain torch ops + autograd | pallas: chain-RHS CUDA kernel |
    # fused: whole-RK-step kernels (fixed/shooting) or the whole-adaptive-
    # solve kernel (adaptive)
    impl: str = "xla"
    bwd_precision: str = "highest"     # "bf16": later
    seed: int = 0
    max_iters_per_call: int = 10_000   # the train loop's chunk
    record_history: bool = False


def _check_slice(cfg: LVConfig) -> None:
    """Raise on what this slice of the port does not run yet."""
    later = {
        ("model", "mlp"): "M8 (models/mlp.py)",
        ("model", "bspline_kan"): "M13 (models/bspline.py)",
        ("impl", "fused_wide"): "'Not ported' (the fused_wide LV route); "
                                "the wide kernels themselves are in "
                                "ops/rk_fused_wide.py",
    }
    for (field, value), item in later.items():
        if getattr(cfg, field) == value:
            raise NotImplementedError(
                f"LVConfig({field}={value!r}) is not ported yet "
                f"(ROADMAP.md, {item})")
    if cfg.sparse_on:
        raise NotImplementedError("LVConfig(sparse_on=True) is not ported "
                                  "yet (ROADMAP.md, M12 sparsify)")
    if cfg.model != "kan":
        raise ValueError(cfg.model)
    if cfg.impl not in ("xla", "fused", "pallas"):
        raise ValueError(f"impl must be 'xla', 'fused' or 'pallas', got "
                         f"{cfg.impl!r}")
    if cfg.solve_mode not in ("fixed", "shooting", "adaptive"):
        raise ValueError(f"unknown solve_mode {cfg.solve_mode!r}")
    if (cfg.solve_mode == "adaptive" and cfg.impl != "fused"
            and cfg.adjoint in ("interpolating", "backsolve")):
        raise NotImplementedError(
            f"LVConfig(adjoint={cfg.adjoint!r}) is not ported yet "
            f"(ROADMAP.md, M7 {cfg.adjoint} adjoint)")


def make_data(cfg: LVConfig, device="cuda") -> dict[str, Any]:
    """Host float64 truth trajectory, split into train/test cuts; `ts`
    and `X` go to `device` as float32 (host copies ride along)."""
    ts = np.arange(0.0, cfg.tspan[1] + cfg.dt / 2, cfg.dt)

    def f(t, u):
        a, b, g, d = LV_PARAMS
        x, y = u
        return np.array([a * x - b * x * y, g * x * y - d * y])

    X = rk4_dense(f, np.asarray(cfg.u0), ts, substeps=50)
    n_train = int(np.floor(len(ts) * cfg.train_tmax / cfg.tspan[1]))
    ts32, X32 = ts.astype(np.float32), X.astype(np.float32)
    dev = require_device(device)
    return {
        "ts": torch.from_numpy(ts32).to(dev),
        "X": torch.from_numpy(X32).to(dev),          # [T, 2]
        "ts_host": ts32,
        "n_train": n_train,
    }


def make_model(cfg: LVConfig, device="cuda") -> KANChain:
    _check_slice(cfg)
    widths = (list(cfg.kan_widths) if cfg.kan_widths is not None
              else [2, cfg.layer_width, 2])
    return KANChain.mlp_like(widths, grid_len=cfg.grid_size,
                             basis=cfg.basis, normalizer=cfg.normalizer,
                             device=require_device(device))


@torch.no_grad()
def init_params(cfg: LVConfig, model: KANChain,
                generator: torch.Generator | None = None) -> KANChain:
    """Glorot init scaled by `init_scale` (reference: glorot/1e5,
    LV_driver_KANODE.jl:179), in place; the generator defaults to a CPU
    generator seeded with `cfg.seed`."""
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    model.init(generator)
    for p in model.parameters():
        p.mul_(cfg.init_scale)
    return model


def make_ode_fns(cfg: LVConfig, model: KANChain, data, *, reduce_fn=None,
                 n_members: int | None = None):
    """(loss_fn, eval_fn, predict) closing over the dataset; loss_fn and
    eval_fn take the model, predict takes (model, t_grid).

    `reduce_fn` maps the squared-error tensor (last axis = state dim) to
    the loss; the default is the scalar mean. A packed ensemble
    (`models/packed.py`, pre-tiled data) passes `packed.member_mean(S)`,
    so the loss is the [S] vector `train()` takes. `n_members` declares
    its member count; adaptive mode needs it with a `reduce_fn`, and
    then gives every member its own controller: impl="fused" runs the
    whole solve as one K8 launch (and one for the backward,
    `ops/rk_adaptive_fused.fused_adaptive_members_odeint`), "xla" and
    "pallas" run `ode/integrate.odeint_members` on the chain or on K1.
    Fused fixed and shooting modes run K3 and K2, and "pallas" K1, whose
    medium flavors (a block a row) take the packed chain, [16, 80, 16] at
    8 members, up to H <= 256.
    Without `n_members`, adaptive mode with a `reduce_fn` raises: one
    shared controller would couple the members through dt."""
    if reduce_fn is not None and cfg.sparse_on:
        raise ValueError("sparse_on adds a scalar regularizer; it does "
                         "not compose with a vector reduce_fn")
    if (reduce_fn is not None and cfg.solve_mode == "adaptive"
            and n_members is None):
        raise ValueError(
            "adaptive solve with a vector reduce_fn needs n_members= "
            "(per-member step control via odeint_members); a shared "
            "controller would couple the ensemble members through dt")
    _check_slice(cfg)
    _reduce = reduce_fn if reduce_fn is not None else torch.mean
    X, n_train, ts_host = data["X"], data["n_train"], data["ts_host"]
    u0 = X[0]
    adaptive = cfg.solve_mode == "adaptive"
    members = adaptive and n_members is not None
    use_fused = cfg.impl == "fused"
    if n_members is not None and cfg.impl == "pallas":
        # K1 takes a packed chain in its medium flavor (a block a row);
        # past its caps refuse here on every device
        from kanodes_tpu_torch.ops._cuda import chain_apply_flavor
        from kanodes_tpu_torch.ops.kdense_pallas import chain_spec_of
        chain_apply_flavor(chain_spec_of(model))
    if use_fused and not adaptive:
        # K2/K3 take packed chains in their medium flavor; past its caps
        # refuse here on every device
        from kanodes_tpu_torch.ode.tableaus import get_tableau
        from kanodes_tpu_torch.ops._cuda import fused_rk_flavor
        from kanodes_tpu_torch.ops.kdense_pallas import chain_spec_of
        fused_rk_flavor(chain_spec_of(model), get_tableau("tsit5").stages)
    if use_fused:
        from kanodes_tpu_torch.ops.kdense_pallas import (chain_spec_of,
                                                         fused_params)
        from kanodes_tpu_torch.ops.rk_adaptive_fused import (
            fused_adaptive_members_odeint, fused_adaptive_odeint)
        from kanodes_tpu_torch.ops.rk_fused import (fused_rk_multistep,
                                                    fused_rk_step)
        spec = chain_spec_of(model)
        h = cfg.dt / cfg.substeps

        def fused_interval(m, x):
            """Advance a batch of states one save interval (one kernel
            per substep)."""
            fp = fused_params(m)
            for _ in range(cfg.substeps):
                x = fused_rk_step(spec, "tsit5", h, x, *fp,
                                  cfg.bwd_precision)
            return x

    if cfg.impl == "pallas":
        from kanodes_tpu_torch.ops.kdense_pallas import kan_chain_rhs
        rhs = kan_chain_rhs(model)
    else:
        def rhs(t, u, m):
            return m.apply(u)

    def predict(m, t_grid):
        """[len(t_grid), 2] trajectory from u0 (t_grid: the save grid,
        host array or tensor; the adaptive modes take it on the device,
        the fixed-step ones on the host)."""
        if adaptive:
            # save-point clipping floors the iteration count at one
            # accepted step per save time, so the bounded loop grows
            # with the grid (the train grid uses cfg.max_steps as it is)
            ms = max(cfg.max_steps, 2 * len(t_grid))
            t_grid = torch.as_tensor(t_grid, dtype=torch.float32,
                                     device=X.device)
            if members and use_fused:
                # every member's controller loop and its discrete adjoint
                # as ONE kernel launch each
                ys = fused_adaptive_members_odeint(
                    spec, "tsit5", cfg.rtol, cfg.atol, ms, StepController(),
                    None, n_members, u0[None], t_grid, *fused_params(m),
                    bwd_precision=cfg.bwd_precision)
                return ys[:, 0, :]
            if members:
                return odeint_members(rhs, u0, t_grid, m, n_members=n_members,
                                      solver="tsit5", rtol=cfg.rtol,
                                      atol=cfg.atol, max_steps=ms)
            if use_fused:
                # whole bounded controller loop + its discrete adjoint as
                # ONE kernel launch each; the same save-clipped stepper
                # and param gradients as adjoint="direct"
                ys = fused_adaptive_odeint(
                    spec, "tsit5", cfg.rtol, cfg.atol, ms, StepController(),
                    None, u0[None], t_grid, *fused_params(m),
                    bwd_precision=cfg.bwd_precision)
                return ys[:, 0, :]
            return odeint(rhs, u0, t_grid, m, solver="tsit5", rtol=cfg.rtol,
                          atol=cfg.atol, max_steps=ms, adjoint=cfg.adjoint)
        if use_fused:
            n_steps = (len(t_grid) - 1) * cfg.substeps
            # whole solve in ONE kernel launch (+1 for its backward)
            ys = fused_rk_multistep(spec, "tsit5", h, n_steps, u0[None],
                                    *fused_params(m), cfg.bwd_precision)
            ys = torch.cat([u0[None, None], ys], dim=0)
            if cfg.substeps != 1:
                ys = ys[::cfg.substeps]
            return ys[:, 0, :]
        return odeint_fixed(rhs, u0, t_grid, m, solver="tsit5",
                            substeps=cfg.substeps)

    # save grids in the form predict takes them
    grid_all = data["ts"] if adaptive else ts_host
    grid_train = grid_all[:n_train]

    def trajectory_loss(m):
        pred = predict(m, grid_train)
        return _reduce((pred - X[:n_train]) ** 2)

    L = cfg.segment_len
    Xtr = X[:n_train]
    starts = Xtr[:-L]                                    # [S, 2]
    seg_ts = np.arange(L + 1, dtype=np.float32) * np.float32(cfg.dt)
    # targets[s] = X[s+1 : s+L+1]
    idx = (torch.arange(starts.shape[0], device=X.device)[:, None]
           + torch.arange(1, L + 1, device=X.device))
    targets = Xtr[idx]                                   # [S, L, 2]

    def shooting_loss(m):
        """Multiple shooting: short segments from every data point,
        integrated in parallel (the segment batch is the kernel batch)."""
        if use_fused:
            x, preds = starts, []
            for _ in range(L):
                x = fused_interval(m, x)
                preds.append(x)
            preds = torch.stack(preds, dim=1)            # [S, L, 2]
        else:
            ys = odeint_fixed(rhs, starts, seg_ts, m, solver="tsit5",
                              substeps=cfg.substeps)     # [L+1, S, 2]
            preds = ys[1:].transpose(0, 1)
        return _reduce((preds - targets) ** 2)

    def loss_fn(m):
        if cfg.solve_mode == "shooting":
            return shooting_loss(m)
        return trajectory_loss(m)

    def eval_fn(m):
        return _reduce((predict(m, grid_all) - X) ** 2)

    return loss_fn, eval_fn, predict


def run(cfg: LVConfig | None = None, params=None, *, device="cuda",
        generator: torch.Generator | None = None,
        checkpoint_dir: str | None = None, restart: bool = False,
        prune_threshold: float | None = None) -> dict[str, Any]:
    """Train an LV neural ODE end to end on `device`; returns the
    `train()` dict plus cfg, model, data and predict.

    `params`: per-layer `{"C", "W"}` numpy arrays to start from (e.g. a
    JAX init, `interop.py`); default is `init_params` with `generator`.
    """
    cfg = cfg or LVConfig()
    _check_slice(cfg)
    if checkpoint_dir is not None or restart:
        raise NotImplementedError("checkpoint_dir/restart are not ported "
                                  "yet (ROADMAP.md, M8 checkpointing)")
    if prune_threshold is not None:
        raise NotImplementedError("prune_threshold is not ported yet "
                                  "(ROADMAP.md, M12 pruning)")
    set_exact_f32()
    data = make_data(cfg, device)
    model = make_model(cfg, device)
    if params is None:
        init_params(cfg, model, generator)
    else:
        chain_params_from_numpy(model, params)
    loss_fn, eval_fn, predict = make_ode_fns(cfg, model, data)
    tc = TrainConfig(lr=cfg.lr, iters=cfg.iters, eval_every=cfg.eval_every,
                     max_iters_per_call=cfg.max_iters_per_call)
    out = train(loss_fn, model, tc, eval_fn=eval_fn,
                record_history=cfg.record_history)
    out.update(cfg=cfg, model=model, data=data, predict=predict)
    return out


def main(argv: list[str]) -> int:
    import time

    from kanodes_tpu_torch.train.config import (override_from_args,
                                                override_from_env)

    device = "cuda"
    for a in argv:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
    if "--checkpoint" in argv or "--restart" in argv:
        raise NotImplementedError("--checkpoint/--restart are not ported "
                                  "yet (ROADMAP.md, M8 checkpointing)")
    cfg = LVConfig(iters=10_000)
    cfg = override_from_env(cfg, "KANODE_LV_")
    cfg = override_from_args(cfg, argv)
    t0 = time.perf_counter()
    out = run(cfg, device=device)
    last = float(out["loss_history"][-1])       # waits for the device
    dt = time.perf_counter() - t0
    print(f"train loss {last:.3e}  "
          f"best {float(out['best_loss']):.3e}  "
          f"test {float(out['eval_history'][-1]):.3e}  "
          f"({cfg.iters} iters in {dt:.1f}s, {cfg.iters / dt:.0f} it/s "
          f"on {device})")
    return 0


if __name__ == "__main__":
    import sys

    raise SystemExit(main(sys.argv[1:]))
