"""Full PDE surrogates: Burgers, Allen-Cahn (1-D and 2-D), Schrödinger
(port of `kanodes_tpu/experiments/pde_surrogate.py`, single device).

Rebuild of `PDE examples/Burgers_Surrogate.jl`, `Allen-Cahn_Surrogate.jl`,
`Schrodinger_Surrogate.jl`: the entire semi-discrete RHS is a 2-layer
KDense chain whose input is the whole grid state ([41,10,41] grid 5 for
Burgers :82-88; [41,10,41] grid 10 for AC :82-87; [402,10,402] grid 10
for Schrödinger :93-96; [1024,10,1024] for the 2-D Allen-Cahn field),
trained on a handful of trajectory snapshots.

The loss integrates from u0 over the snapshot time grid with a fixed-step
tableau and compares at the snapshot rows only (the reference's
`NeuralODE(..., saveat=dt_train)` protocol); `solve_mode="shooting"`
integrates every inter-snapshot interval from the data instead.

`impl="xla"` integrates with the plain `ode/integrate.odeint_fixed`
(autograd through every stage). `impl="fused"` with the wide flavor
(`in_dims*grid_len > 2048`, or `wide_kernels=True`) runs the whole
snapshot trajectory as ONE launch of K7 and its backward as one of K10
(K == 1), and a shooting loss as one K7 forward and one backward (K7b,
or K10 for a single segment) per group of equally long segments
(`ops/rk_fused_wide.py`, `csrc/rk_fused_wide.cu`). The narrow flavor
(below, and the default for Burgers and 1-D Allen-Cahn, [41, 10, 41])
runs K2 of `ops/rk_fused.py` once per step: a trajectory loss steps each
snapshot interval (one K2f launch and one K2b a step: 180 each at
Burgers' reference grid, whose float32 snapshot times miss the uniform
test), a shooting loss steps each group of equally long segments as one
batch; on a uniform step grid the trajectory is one K3 launch each way.
At these widths K2/K3 run their medium flavor, a block a row
(`csrc/kan_chain_block.cuh`); a chain past its caps raises ValueError
naming ROADMAP.md 2a. Kernels
run on CUDA tensors and their plain versions on CPU tensors. The sharded
path (`mesh=`) and `bwd_precision="bf16"` raise NotImplementedError
naming their ROADMAP.md item. `run_grid_refinement` refits the chain's
grid span during training (`sparsify/grid_refine.py`), and the fused
route then runs its kernels at the refined span.

Run:  python -m kanodes_tpu_torch.experiments.pde_surrogate
      [--problem=burgers|allen_cahn|allen_cahn_2d|schrodinger]
      [--key=value ...] [--device=cuda|cpu]  (default cuda; raises
      without a card)
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from kanodes_tpu_torch.interop import chain_params_from_numpy
from kanodes_tpu_torch.models.kdense import KANChain
from kanodes_tpu_torch.ode.integrate import odeint_fixed, rk_step
from kanodes_tpu_torch.ode.tableaus import get_tableau
from kanodes_tpu_torch.pde import datagen
from kanodes_tpu_torch.train.loop import TrainConfig, train
from kanodes_tpu_torch.utils.device import require_device
from kanodes_tpu_torch.utils.precision import set_exact_f32

# reference snapshot selections (indices into the dt=0.01 save grid)
_SNAPSHOTS = {
    # Burgers_Surrogate.jl:67-73 — t=0 row is u0 itself (included in loss)
    "burgers": dict(idx=[0, 10, 30, 50, 70, 90], include_t0=True,
                    kan_grid=5, hidden=10, iters_ref=20_000),
    # Allen-Cahn_Surrogate.jl:66-71 — t0 excluded
    "allen_cahn": dict(idx=[10, 30, 50, 70, 90], include_t0=False,
                       kan_grid=10, hidden=10, iters_ref=100_000),
    # beyond parity: 2-D Allen-Cahn full-state surrogate ([n^2,H,n^2]
    # chain on flattened 32x32 fields) — 1-D AC snapshot protocol
    "allen_cahn_2d": dict(idx=[10, 30, 50, 70, 90], include_t0=False,
                          kan_grid=10),
    # Schrodinger_Surrogate.jl:72-78 — 8 snapshots, t0 excluded
    "schrodinger": dict(idx=[10, 30, 50, 70, 90, 110, 130, 150],
                        include_t0=False, kan_grid=10, hidden=10,
                        iters_ref=100_000),
}


@dataclasses.dataclass(frozen=True)
class SurrogateConfig:
    """The JAX package's SurrogateConfig, field for field. `mesh` and
    `bwd_precision="bf16"` raise when used; `max_iters_per_call` (None:
    `resolved_chunk`) is the training loop's chunk: it shapes the
    iteration and eval schedule as in JAX and bounds no execution."""
    problem: str = "burgers"
    hidden: int = 10
    kan_grid: int | None = None        # None -> reference value
    normalizer: str = "softsign"
    basis: str = "rbf"                 # rbf | iqf | rswaf (all fused)
    lr: float = 1e-2                   # Burgers/AC 1e-2, Schr 1e-3
    iters: int = 2000
    eval_every: int = 500
    substeps: int = 20                 # per snapshot interval
    solve_mode: str = "fixed"          # fixed | shooting
    impl: str = "xla"                  # xla | fused (whole-RK-step kernels)
    # fixed-grid stepper. These solves are STABILITY-bound (substeps set
    # by the semi-discrete operator's spectrum, not accuracy), so a
    # tableau with more stability per stage can beat Tsit5.
    rk_solver: str = "tsit5"
    bwd_precision: str = "highest"     # "bf16": later
    # fused-kernel flavor: None = auto (the wide kernels when
    # in_dims*grid_len > 2048, else the narrow whole-RK-step kernels);
    # True/False force it.
    wide_kernels: bool | None = None
    max_iters_per_call: int | None = None
    seed: int = 0
    mesh: tuple[int, int] | None = None    # (dp, sp): later (M16)
    # dataset overrides (None -> the reference protocol values)
    data_dx: float | None = None
    data_substeps: int | None = None
    data_n: int | None = None          # 2-D problems: grid points per side

    def resolved_chunk(self) -> int:
        if self.max_iters_per_call is not None:
            return self.max_iters_per_call
        return 200 if self.problem == "schrodinger" else 5000

    def resolved_lr(self) -> float:
        if self.problem == "schrodinger" and self.lr == 1e-2:
            return 1e-3                # Schrodinger_Surrogate.jl:170
        return self.lr


def _check_slice(cfg: SurrogateConfig) -> None:
    """Raise on what this slice of the port does not run yet."""
    if cfg.mesh is not None:
        raise NotImplementedError(
            f"SurrogateConfig(mesh={cfg.mesh}) is not ported yet "
            "(ROADMAP.md, M16 pde/sharded.py)")
    if cfg.problem not in _SNAPSHOTS:
        raise ValueError(f"unknown problem {cfg.problem!r}")
    if cfg.impl not in ("xla", "fused"):
        raise ValueError(f"impl must be 'xla' or 'fused', got {cfg.impl!r}")
    if cfg.solve_mode not in ("fixed", "shooting"):
        raise ValueError(f"unknown solve_mode {cfg.solve_mode!r}")
    if cfg.impl == "fused":
        from kanodes_tpu_torch.ops.rk_fused import check_bwd_precision
        check_bwd_precision(cfg.bwd_precision)


def make_data(cfg: SurrogateConfig) -> datagen.PDEData:
    """Host float64 truth snapshots (numpy; `make_fns` sends them to the
    model's device as float32)."""
    gen = {"burgers": datagen.burgers,
           "allen_cahn": datagen.allen_cahn_surrogate,
           "allen_cahn_2d": datagen.allen_cahn_surrogate_2d,
           "schrodinger": datagen.schrodinger}[cfg.problem]
    kw = {}
    if cfg.problem.endswith("_2d"):
        if cfg.data_dx is not None:
            raise ValueError("data_dx is 1-D only; use data_n for 2-D")
        if cfg.data_n is not None:
            kw["n"] = cfg.data_n
    elif cfg.data_dx is not None:
        kw["dx"] = cfg.data_dx
    if cfg.data_substeps is not None:
        kw["substeps"] = cfg.data_substeps
    return gen(**kw)


def make_model(cfg: SurrogateConfig, data: datagen.PDEData,
               device="cuda") -> KANChain:
    spec = _SNAPSHOTS[cfg.problem]
    n_state = data.X.shape[1]
    grid = cfg.kan_grid or spec["kan_grid"]
    return KANChain.mlp_like([n_state, cfg.hidden, n_state],
                             grid_len=grid, normalizer=cfg.normalizer,
                             basis=cfg.basis, device=require_device(device))


def step_plan(cfg: SurrogateConfig, data: datagen.PDEData) -> dict:
    """The static step structure of the objectives, computed on the host:
    `t_grid` (float32: t = 0 plus the snapshot times), `base_h`,
    `interval_steps` (fused steps per snapshot interval), `uniform`,
    `total_steps`, `snap_rows` (post-step rows of the snapshots), and the
    shooting segments: `seg_t0`, `seg_t1` (float32) and `groups`, the
    segment indices of each distinct interval length."""
    idx = np.asarray(_SNAPSHOTS[cfg.problem]["idx"])
    ts_snap = np.asarray(data.ts[idx], np.float32)
    # integration grid: u0 at t=0 plus the snapshot times
    if idx[0] == 0:
        t_np = ts_snap
    else:
        t_np = np.concatenate([np.zeros((1,), np.float32), ts_snap])
    # snapshot intervals are non-uniform (0.1 then 0.2); the fused path
    # takes a static per-interval step count at the smallest interval's
    # step size
    base_h = float(min(np.diff(t_np))) / cfg.substeps
    interval_steps = [max(int(round((t_np[i + 1] - t_np[i]) / base_h)), 1)
                      for i in range(len(t_np) - 1)]
    # is the whole snapshot trajectory a single uniform-dt step grid?
    # (true for all reference problems: snapshot spacings are exact
    # multiples of base_h). If so, trajectory mode runs as ONE multistep
    # kernel launch (fwd) + ONE (bwd) instead of one pair per interval.
    uniform = all(abs(n * base_h - float(t_np[i + 1] - t_np[i])) < 1e-9
                  for i, n in enumerate(interval_steps))
    ts_snap64 = np.asarray(data.ts[idx], np.float64)
    if idx[0] == 0:
        seg_t0, seg_t1 = ts_snap[:-1], ts_snap[1:]
        seg_lens = np.round(ts_snap64[1:] - ts_snap64[:-1], 9)
    else:
        # include the u0 -> first-snapshot segment
        seg_t0 = np.concatenate([np.zeros(1, np.float32), ts_snap[:-1]])
        seg_t1 = ts_snap
        seg_lens = np.round(ts_snap64 - np.concatenate(
            [[0.0], ts_snap64[:-1]]), 9)
    groups = [(float(length), np.where(seg_lens == length)[0])
              for length in sorted(set(seg_lens.tolist()))]
    return dict(t_grid=t_np, base_h=base_h, interval_steps=interval_steps,
                uniform=uniform, total_steps=int(sum(interval_steps)),
                snap_rows=np.cumsum(interval_steps) - 1,
                seg_t0=seg_t0, seg_t1=seg_t1, groups=groups)


def make_fns(cfg: SurrogateConfig, model: KANChain,
             data: datagen.PDEData, *, reduce_fn=None):
    """(train_loss, snapshot_loss, predict), each taking the model and
    closing over the dataset.

    `reduce_fn` maps the squared-error tensor (last axis = state dim) to
    the loss; default scalar mean.
    """
    _check_slice(cfg)
    _reduce = reduce_fn if reduce_fn is not None else torch.mean
    idx = np.asarray(_SNAPSHOTS[cfg.problem]["idx"])
    dev = next(model.parameters()).device
    X_snap = torch.as_tensor(data.X[idx], dtype=torch.float32, device=dev)
    u0 = torch.as_tensor(data.X[0], dtype=torch.float32, device=dev)
    plan = step_plan(cfg, data)
    t_np, base_h = plan["t_grid"], plan["base_h"]
    interval_steps, uniform = plan["interval_steps"], plan["uniform"]
    total_steps = plan["total_steps"]
    rows_t = torch.as_tensor(plan["snap_rows"], device=dev)

    def rhs(t, u, m):
        return m.apply(u)

    impl = cfg.impl
    wide = (model.in_dims * model.layers[0].grid_len > 2048
            if cfg.wide_kernels is None else cfg.wide_kernels)
    fused_trajectory = None
    if impl == "fused" and wide:
        # wide states go to the kernels that spread a row over a cluster
        from kanodes_tpu_torch.ops.kdense_pallas import fused_params
        from kanodes_tpu_torch.ops.rk_fused_wide import (
            fused_rk_multistep_wide, wide_chain_adapter)
        ws, _advance = wide_chain_adapter(model, solver=cfg.rk_solver,
                                          bwd_precision=cfg.bwd_precision)

        def fused_advance(m, x, n_steps, dt_total):
            return _advance(m, x, dt_total / n_steps, n_steps)

        if uniform:
            def fused_trajectory(m):
                pp = ws.pad_params(*fused_params(m))
                ys = fused_rk_multistep_wide(ws, cfg.rk_solver, base_h,
                                             total_steps,
                                             ws.pad_state(u0[None]), *pp,
                                             None, cfg.bwd_precision)
                return ys[rows_t][:, 0, :ws.I]
    elif impl == "fused":
        # the narrow flavor: K2 stepped n times per advance, and K3 for
        # the whole trajectory when the step grid is uniform (JAX
        # pde_surrogate.py:201-225); at these widths the medium K2/K3 run,
        # a block a row. A chain past their caps raises here, on every
        # device
        from kanodes_tpu_torch.ops import _cuda
        from kanodes_tpu_torch.ops.kdense_pallas import (chain_spec_of,
                                                         fused_params)
        from kanodes_tpu_torch.ops.rk_fused import (fused_rk_multistep,
                                                    fused_rk_step)
        spec = chain_spec_of(model)
        _cuda.fused_rk_flavor(spec, get_tableau(cfg.rk_solver).stages)

        def fused_advance(m, x, n_steps, dt_total):
            fp = fused_params(m)
            h = dt_total / n_steps
            for _ in range(n_steps):
                x = fused_rk_step(spec, cfg.rk_solver, h, x, *fp,
                                  cfg.bwd_precision)
            return x

        if uniform:
            def fused_trajectory(m):
                ys = fused_rk_multistep(spec, cfg.rk_solver, base_h,
                                        total_steps, u0[None],
                                        *fused_params(m), cfg.bwd_precision)
                return ys[rows_t][:, 0, :]

    def predict(m):
        if impl == "fused" and fused_trajectory is not None:
            ys = torch.cat([u0[None], fused_trajectory(m)], dim=0)
        elif impl == "fused":
            x = u0[None]
            rows = [x]
            for i, n in enumerate(interval_steps):
                x = fused_advance(m, x, n, float(t_np[i + 1] - t_np[i]))
                rows.append(x)
            ys = torch.cat(rows, dim=0)
        else:
            ys = odeint_fixed(rhs, u0, t_np, m, solver=cfg.rk_solver,
                              substeps=cfg.substeps)
        return ys if idx[0] == 0 else ys[1:]

    def loss_fn(m):
        return _reduce((predict(m) - X_snap) ** 2)

    # the shooting segments (static): every inter-snapshot interval from
    # the data, with the u0 -> first-snapshot one where t0 is no snapshot
    if idx[0] == 0:
        starts, targets = X_snap[:-1], X_snap[1:]
    else:
        starts = torch.cat([u0[None], X_snap[:-1]], dim=0)
        targets = X_snap
    groups = [(length, torch.as_tensor(sel, device=dev))
              for length, sel in plan["groups"]]
    # the plain path's per-segment step, float32 as the JAX scan computes
    # it from float32 times
    seg_h = torch.as_tensor(
        ((plan["seg_t1"] - plan["seg_t0"])
         / np.float32(cfg.substeps)).astype(np.float32), device=dev)[:, None]
    tab = get_tableau(cfg.rk_solver)

    def shooting_loss(m):
        """Snapshot-to-snapshot shooting: integrate each inter-snapshot
        interval from the data, batched."""
        if impl == "fused":
            # group segments by (static) interval length; each group is
            # one batched fused solve with its own step count
            preds = torch.zeros_like(targets)
            for length, sel in groups:
                n = max(int(round(length / base_h)), 1)
                preds = preds.index_copy(
                    0, sel, fused_advance(m, starts[sel], n, length))
            return _reduce((preds - targets) ** 2)
        # every segment takes cfg.substeps steps of its own size (the
        # right-hand side does not read the time)
        y = starts
        for _ in range(cfg.substeps):
            y, _, _ = rk_step(tab, rhs, 0.0, y, seg_h, m)
        return _reduce((y - targets) ** 2)

    train_loss = shooting_loss if cfg.solve_mode == "shooting" else loss_fn
    return train_loss, loss_fn, predict


def build_mesh(cfg: SurrogateConfig):
    raise NotImplementedError("build_mesh is not ported yet (ROADMAP.md, "
                              "M16 parallel/sharding.py)")


def make_sharded_fns(cfg: SurrogateConfig, model, data, mesh):
    raise NotImplementedError("make_sharded_fns is not ported yet "
                              "(ROADMAP.md, M16 pde/sharded.py)")


def run(cfg: SurrogateConfig | None = None, params=None, *, device="cuda",
        generator: torch.Generator | None = None) -> dict[str, Any]:
    """Train a surrogate end to end on `device`; returns the `train()`
    dict plus cfg, model, data and predict.

    `params`: per-layer `{"C", "W"}` numpy arrays to start from (e.g. a
    JAX init, `interop.py`); default is the chain's glorot init drawn
    from `generator` (a CPU generator seeded with `cfg.seed` if None).
    """
    cfg = cfg or SurrogateConfig()
    _check_slice(cfg)
    set_exact_f32()
    data = make_data(cfg)
    model = make_model(cfg, data, device)
    if params is None:
        model.init(generator if generator is not None
                   else torch.Generator().manual_seed(cfg.seed))
    else:
        chain_params_from_numpy(model, params)
    train_loss, eval_loss, predict = make_fns(cfg, model, data)
    tc = TrainConfig(lr=cfg.resolved_lr(), iters=cfg.iters,
                     eval_every=cfg.eval_every,
                     max_iters_per_call=cfg.resolved_chunk())
    out = train(train_loss, model, tc, eval_fn=eval_loss)
    out.update(cfg=cfg, model=model, data=data, predict=predict)
    return out


def run_grid_refinement(cfg: SurrogateConfig | None = None, *,
                        refit_points: tuple[int, ...] | None = None,
                        verbose: bool = False, device="cuda", params=None,
                        generator: torch.Generator | None = None
                        ) -> dict[str, Any]:
    """Train with the efficient-kan `update_grid` cadence on a KDense
    surrogate chain (JAX `pde_surrogate.run_grid_refinement`): at each
    iteration in `refit_points` (default: one refit at 10% of the
    budget), refit the shared basis-grid span onto the normalized inputs
    the current trajectory visits (`sparsify/grid_refine.
    refine_kdense_chain_grid`) and rebuild the objectives on the refined
    chain, so that the fused route runs its kernels with the new span's
    constants (a new `ChainSpec`: grid_lims, h). A fresh Adam each block,
    as in JAX.

    Refits are early-training events: the lstsq projection between rbf
    spaces on different centers perturbs the learned functions by an
    O(1e-3)-relative floor, negligible early, dominant after convergence.

    `params`: per-layer `{"C", "W"}` numpy arrays to start from, else the
    chain's init drawn from `generator` (a CPU generator seeded with
    `cfg.seed` if None). Returns run()'s keys for the last block (model,
    params, histories concatenated over the blocks) plus `refits` (per
    refit: old and new spans, the refit errors, the snapshot loss before
    and after).
    """
    from kanodes_tpu_torch.sparsify.grid_refine import \
        refine_kdense_chain_grid
    cfg = cfg or SurrogateConfig(problem="allen_cahn")
    _check_slice(cfg)
    set_exact_f32()
    if refit_points is None:
        refit_points = (max(cfg.iters // 10, 1),)
    data = make_data(cfg)
    model = make_model(cfg, data, device)
    if params is None:
        model.init(generator if generator is not None
                   else torch.Generator().manual_seed(cfg.seed))
    else:
        chain_params_from_numpy(model, params)

    bounds = [p for p in sorted(refit_points) if p < cfg.iters]
    blocks = np.diff([0] + bounds + [cfg.iters]).tolist()
    losses, evals, refits = [], [], []
    for bi, iters_b in enumerate(blocks):
        cfg_block = dataclasses.replace(cfg, iters=int(iters_b))
        train_loss, eval_loss, predict = make_fns(cfg_block, model, data)
        tc = TrainConfig(lr=cfg.resolved_lr(), iters=int(iters_b),
                         eval_every=min(cfg.eval_every, int(iters_b)),
                         max_iters_per_call=cfg.resolved_chunk())
        out = train(train_loss, model, tc, eval_fn=eval_loss)
        losses.append(out["loss_history"])
        evals.append(out["eval_history"])
        if bi < len(blocks) - 1:
            with torch.no_grad():
                samples = predict(model)
                before = float(eval_loss(model))
                model, info = refine_kdense_chain_grid(model, samples)
                _, eval_new, _ = make_fns(cfg_block, model, data)
                after = float(eval_new(model))
            info.update(eval_before=before, eval_after=after)
            refits.append(info)
            if verbose:
                print(f"[refit @{sum(blocks[:bi + 1])}] lims "
                      f"{info['old_lims']} -> {info['new_lims']}, eval "
                      f"{before:.3e} -> {after:.3e} (refit err "
                      f"{info['relative_refit_error']})", flush=True)
    out.update(cfg=cfg, model=model, data=data, predict=predict,
               refits=refits,
               loss_history=torch.cat(losses),
               eval_history=torch.cat(evals))
    return out


def main(argv: list[str]) -> int:
    """One problem (`--problem=`, or the first bare argument as the JAX
    module takes it; default burgers); `--key=value` (or
    KANODE_SURROGATE_<KEY>) overrides any SurrogateConfig field."""
    import time

    from kanodes_tpu_torch.train.config import (override_from_args,
                                                override_from_env)

    device = "cuda"
    cfg = SurrogateConfig()
    for a in argv:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif not a.startswith("-"):
            cfg = dataclasses.replace(cfg, problem=a)
    cfg = override_from_env(cfg, "KANODE_SURROGATE_")
    cfg = override_from_args(cfg, argv)
    t0 = time.perf_counter()
    out = run(cfg, device=device)
    last = float(out["loss_history"][-1])       # waits for the device
    dt = time.perf_counter() - t0
    print(f"{cfg.problem}: loss {last:.3e} "
          f"best {float(out['best_loss']):.3e} "
          f"eval {float(out['eval_history'][-1]):.3e} "
          f"({cfg.iters} iters in {dt:.1f}s, {cfg.iters / dt:.1f} it/s "
          f"on {device}, impl {cfg.impl}, {cfg.solve_mode})", flush=True)
    return 0


if __name__ == "__main__":
    import sys

    raise SystemExit(main(sys.argv[1:]))
