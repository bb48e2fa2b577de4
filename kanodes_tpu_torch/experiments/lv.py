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
(`LV_driver_KANODE.jl:180-184`) or, with `adjoint="interpolating"` or
`"backsolve"`, by a continuous adjoint (`ode/integrate.odeint`; on
impl="pallas" the adjoint's augmented dynamics run K1 forward and
backward at every evaluation; impl="fused" ignores `adjoint`, as JAX).
`make_ode_fns(reduce_fn=, n_members=)` trains a packed ensemble
(`models/packed.py`, driven by `experiments/lv_members.py`), one
controller per member in adaptive mode. `sparse_on` adds the L1/entropy regularizer
(`sparsify/regularization.py`) to the loss in every mode and impl, and
`run(prune_threshold=)` prunes weak hidden nodes before training
(`sparsify/prune.py`; the pipeline is `experiments/lv_symbolic.py`).
`model="mlp"` trains the reference's MLP baseline (`models/mlp.py`) and
`model="bspline_kan"` the PyTorch flavor's efficient-kan B-spline chain
(`models/bspline.py`, [2, layer_width, 2], grid_size intervals) on the
plain path, whatever `impl` says, as in JAX; `run_grid_refinement`
trains the B-spline chain with the reference's `update_grid` cadence. `run(checkpoint_dir=,
restart=)` saves a checkpoint after every chunk of the training schedule
and continues from the latest one, extending its histories
(`train/checkpoint.py`; the reference's `is_restart` flow).
`make_stacked_fns` gives the stacked multi-seed layout's losses (JAX's
`jax.vmap(loss_fn)`; impl="fused" runs K2/K3 with a member axis), and
`make_ode_fns` takes a `models.packed.HeteroPacked` on the plain path.
What lies outside this slice raises NotImplementedError naming its
ROADMAP.md item.

Run:  python -m kanodes_tpu_torch.experiments.lv [--key=value ...]
      [--device=cuda|cpu]   (default cuda; raises without a card)
      [--checkpoint] [--restart]   (checkpoints/lv, as in JAX)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from kanodes_tpu_torch.interop import params_from_numpy
from kanodes_tpu_torch.models.bspline import BSplineKANChain
from kanodes_tpu_torch.models.kdense import KANChain
from kanodes_tpu_torch.models.mlp import MLP
from kanodes_tpu_torch.ode.integrate import (StepController, odeint,
                                             odeint_fixed, odeint_members)
from kanodes_tpu_torch.sparsify.regularization import l1_entropy_reg
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
    model: str = "kan"                 # kan | mlp | bspline_kan
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
    # adaptive-mode differentiation strategy: direct | direct_remat |
    # interpolating | backsolve (ode/integrate.odeint adjoints)
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
        ("impl", "fused_wide"): "'Not ported' (the fused_wide LV route); "
                                "the wide kernels themselves are in "
                                "ops/rk_fused_wide.py",
    }
    for (field, value), item in later.items():
        if getattr(cfg, field) == value:
            raise NotImplementedError(
                f"LVConfig({field}={value!r}) is not ported yet "
                f"(ROADMAP.md, {item})")
    if cfg.model not in ("kan", "mlp", "bspline_kan"):
        raise ValueError(cfg.model)
    if cfg.impl not in ("xla", "fused", "pallas"):
        raise ValueError(f"impl must be 'xla', 'fused' or 'pallas', got "
                         f"{cfg.impl!r}")
    if cfg.solve_mode not in ("fixed", "shooting", "adaptive"):
        raise ValueError(f"unknown solve_mode {cfg.solve_mode!r}")


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


def make_model(cfg: LVConfig, device="cuda"):
    _check_slice(cfg)
    if cfg.model == "mlp":
        return MLP(cfg.mlp_widths, device=require_device(device))
    if cfg.model == "bspline_kan":
        # the PyTorch flavor's LV model: the efficient-kan B-spline chain
        # ([2,10,2] grid 5, predator_prey.py:101)
        return BSplineKANChain([2, cfg.layer_width, 2],
                               grid_size=cfg.grid_size,
                               device=require_device(device))
    widths = (list(cfg.kan_widths) if cfg.kan_widths is not None
              else [2, cfg.layer_width, 2])
    return KANChain.mlp_like(widths, grid_len=cfg.grid_size,
                             basis=cfg.basis, normalizer=cfg.normalizer,
                             device=require_device(device))


@torch.no_grad()
def init_params(cfg: LVConfig, model: KANChain | MLP,
                generator: torch.Generator | None = None):
    """Glorot init scaled by `init_scale` (reference: glorot/1e5,
    LV_driver_KANODE.jl:179), every parameter (an MLP's zero biases
    too) but the B-spline chain's knot grids, which are coordinates, not
    weights (scaling them would collapse the knot span, as JAX notes), in
    place; the generator defaults to a CPU generator seeded with
    `cfg.seed`."""
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    model.init(generator)
    for name, p in model.named_parameters():
        if not (cfg.model == "bspline_kan" and name.endswith("grid")):
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
    shared controller would couple the members through dt. A
    `HeteroPacked` model (its `member_mean()` as `reduce_fn`) runs the
    plain path only: impl="xla"."""
    from kanodes_tpu_torch.models.packed import HeteroPacked
    if isinstance(model, HeteroPacked) and cfg.impl != "xla":
        raise ValueError(
            f"HeteroPacked runs impl='xla' only, got {cfg.impl!r}: its "
            f"per-row grids are outside the fused kernels' shared-grid "
            f"contract")
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
    # the kernels take KDense chains; an MLP and the B-spline chain run
    # the plain path (JAX: the fused and pallas routes only for
    # model == "kan")
    kan = cfg.model == "kan"
    use_fused = cfg.impl == "fused" and kan
    use_pallas = cfg.impl == "pallas" and kan
    if n_members is not None and use_pallas:
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

    if use_pallas:
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
            loss = shooting_loss(m)
        else:
            loss = trajectory_loss(m)
        if cfg.sparse_on:
            # autograd adds the term's gradient to what the kernels' VJPs
            # write into the same C / W leaves
            loss = loss + l1_entropy_reg(m, cfg.act_reg, cfg.entropy_reg)
        return loss

    def eval_fn(m):
        return _reduce((predict(m, grid_all) - X) ** 2)

    return loss_fn, eval_fn, predict


def make_stacked_fns(cfg: LVConfig, model: KANChain, data):
    """(loss_fn, eval_fn, predict) of the stacked multi-seed layout:
    `make_ode_fns`'s member loss and eval under `train.loop.vmap_members`,
    each taking a `train.loop.Stacked` of `model` and returning [S] (JAX's
    `jax.vmap(loss_fn)` over an `init_stacked` tree). impl="fused" runs
    K2/K3 with a member axis: one launch a call for all S members. What
    has no member axis yet raises NotImplementedError here, before any
    launch (ROADMAP.md, 2a.4): impl="pallas" (K1), solve_mode="adaptive"
    (K4; the plain adaptive loop's host control flow is not vmap-safe),
    and a chain past K2/K3's small caps (their medium flavor)."""
    from kanodes_tpu_torch.train.loop import vmap_members
    _check_slice(cfg)
    later = None
    if cfg.solve_mode == "adaptive":
        later = (f"solve_mode='adaptive' (impl={cfg.impl!r}: K4 has no "
                 f"member axis and the plain adaptive loop's host control "
                 f"flow is not vmap-safe)")
    elif cfg.model == "kan" and cfg.impl == "pallas":
        later = "impl='pallas' (K1 has no member axis)"
    if later is not None:
        raise NotImplementedError(f"a stacked multi-seed run with {later} "
                                  f"is not ported yet (ROADMAP.md, 2a.4)")
    if cfg.model == "kan" and cfg.impl == "fused":
        from kanodes_tpu_torch.ode.tableaus import get_tableau
        from kanodes_tpu_torch.ops.kdense_pallas import chain_spec_of
        from kanodes_tpu_torch.ops.rk_fused import check_members_flavor
        check_members_flavor(chain_spec_of(model),
                             get_tableau("tsit5").stages)
    loss_fn, eval_fn, predict = make_ode_fns(cfg, model, data)
    return vmap_members(loss_fn), vmap_members(eval_fn), predict


def run(cfg: LVConfig | None = None, params=None, *, device="cuda",
        generator: torch.Generator | None = None,
        checkpoint_dir: str | None = None, restart: bool = False,
        prune_threshold: float | None = None) -> dict[str, Any]:
    """Train an LV neural ODE end to end on `device`; returns the
    `train()` dict plus cfg, model, data and predict.

    `params`: the parameters to start from: per-layer numpy arrays in
    the JAX layout (`{"C", "W"}` for a KAN, `{"W", "b"}` for an MLP; a
    JAX init, say, `interop.py`) or a name -> tensor dict (`out["params"]`
    of an earlier run); default is `init_params` with `generator`.

    `checkpoint_dir`: save a `TrainState` there after every chunk of the
    schedule (`TrainConfig.max_iters_per_call`), at step = the restored
    step + the history length so far, with the model's spec in
    `extra["model_spec"]` (`deploy/spec.py`). `restart`: start from the
    latest checkpoint there (if any): its parameters (a model of its
    spec's widths), and its loss and eval histories, which the returned
    ones extend. The optimizer state is not restored, as in JAX.
    `prune_threshold` prunes weak hidden nodes (of the restored
    parameters on a restart) before training (`sparsify/prune.py`; the
    reference's `is_restart` / `is_prune` flow,
    `LV_driver_KANODE.jl:18-25,146-170`): the returned `model` and `cfg`
    carry the new width.
    """
    cfg = cfg or LVConfig()
    _check_slice(cfg)
    set_exact_f32()
    data = make_data(cfg, device)
    model = make_model(cfg, device)

    # restart as LV_driver_KANODE.jl:146-160: reload the parameters AND
    # the loss/test histories so the continued run extends them
    ckptr = None
    prev_loss = np.zeros((0,), np.float32)
    prev_eval = np.zeros((0,), np.float32)
    prev_step = 0
    if checkpoint_dir is not None:
        from kanodes_tpu_torch.train.checkpoint import Checkpointer
        ckptr = Checkpointer(checkpoint_dir)
        if restart and ckptr.latest_step() is not None:
            st = ckptr.restore()
            model, cfg = _restored_model(cfg, model, st, device)
            params = {k: torch.from_numpy(v) for k, v in st["params"].items()}
            prev_step = int(st.get("step", 0))
            if st.get("loss_history") is not None:
                prev_loss = np.asarray(st["loss_history"], np.float32)
            if st.get("eval_history") is not None:
                prev_eval = np.asarray(st["eval_history"], np.float32)

    if params is None:
        init_params(cfg, model, generator)
    elif isinstance(params, dict):
        with torch.no_grad():
            model.load_state_dict(params)
    else:
        params_from_numpy(model, params)
    if prune_threshold is not None:
        from kanodes_tpu_torch.sparsify.prune import prune
        res = prune(model, data["X"][:data["n_train"]],
                    threshold=prune_threshold)
        model = res.chain
        cfg = dataclasses.replace(cfg,
                                  layer_width=model.layers[0].out_dims)
    loss_fn, eval_fn, predict = make_ode_fns(cfg, model, data)
    tc = TrainConfig(lr=cfg.lr, iters=cfg.iters, eval_every=cfg.eval_every,
                     max_iters_per_call=cfg.max_iters_per_call)

    on_chunk = None
    if ckptr is not None:
        from kanodes_tpu_torch.deploy.spec import spec_of
        from kanodes_tpu_torch.train.checkpoint import TrainState
        model_spec = spec_of(model)

        def on_chunk(i, st):
            losses = st["loss_history"].cpu().numpy()    # the chunk's sync
            evals = st["eval_history"].cpu().numpy()
            step = prev_step + len(losses)
            ckptr.save(TrainState(
                params=st["params"], step=step,
                best_params=st["best_params"],
                best_loss=float(st["best_loss"]),
                loss_history=np.concatenate([prev_loss, losses]),
                eval_history=np.concatenate([prev_eval, evals]),
                # the spec rides along so post-hoc tools can rebuild the
                # network (the reference's size_KAN in its .mat files)
                extra={"model_spec": model_spec}))

    out = train(loss_fn, model, tc, eval_fn=eval_fn,
                record_history=cfg.record_history, on_chunk=on_chunk)
    if ckptr is not None:
        dev = out["loss_history"].device
        out["loss_history"] = torch.cat(
            [torch.from_numpy(prev_loss).to(dev), out["loss_history"]])
        out["eval_history"] = torch.cat(
            [torch.from_numpy(prev_eval).to(dev), out["eval_history"]])
    out.update(cfg=cfg, model=model, data=data, predict=predict)
    return out


def _restored_model(cfg: LVConfig, model, st: dict, device):
    """(model, cfg) for a restored checkpoint: a checkpoint of a pruned
    run holds a narrower chain than cfg describes, so the model is
    rebuilt from the stored spec when its widths differ."""
    spec = (st.get("extra") or {}).get("model_spec")
    if spec is None or spec["kind"] != cfg.model:
        return model, cfg
    from kanodes_tpu_torch.deploy.spec import model_from_spec, spec_of
    if spec_of(model)["widths"] == list(spec["widths"]):
        return model, cfg
    model = model_from_spec(spec, device=require_device(device))
    if cfg.model == "mlp":
        return model, dataclasses.replace(cfg, mlp_widths=model.widths)
    if cfg.kan_widths is not None:
        return model, dataclasses.replace(cfg,
                                          kan_widths=tuple(spec["widths"]))
    return model, dataclasses.replace(cfg,
                                      layer_width=model.layers[0].out_dims)


def run_grid_refinement(cfg: LVConfig | None = None, *,
                        update_every: int = 500, verbose: bool = False,
                        device="cuda", params=None,
                        generator: torch.Generator | None = None
                        ) -> dict[str, Any]:
    """The efficient-kan `update_grid` cadence on the B-spline LV model
    (JAX `lv.run_grid_refinement`): train a block of `update_every`
    iterations (a fresh Adam each block, as JAX), refit every layer's
    knot grid to the quantiles of its current inputs along the predicted
    train trajectory (the function-keeping lstsq refit), and go on; the
    reference train loop's `model(x, update_grid=True)` rhythm
    (`efficientkan.py:263-266`). `params`: JAX-layout arrays to start
    from (`interop.bspline_params_from_numpy`), else `init_params` with
    `generator`.

    Returns run()'s keys (the histories concatenated over blocks) plus
    `refits`, the (loss_before, loss_after) pair of every refit.
    """
    cfg = cfg or LVConfig(model="bspline_kan", iters=3000, lr=2e-3,
                          init_scale=1.0)
    if cfg.model != "bspline_kan":
        raise ValueError("grid refinement applies to the B-spline chain")
    set_exact_f32()
    data = make_data(cfg, device)
    model = make_model(cfg, device)
    if params is None:
        init_params(cfg, model, generator)
    else:
        params_from_numpy(model, params)
    loss_fn, eval_fn, predict = make_ode_fns(cfg, model, data)
    n = data["n_train"]
    grid_train = (data["ts"] if cfg.solve_mode == "adaptive"
                  else data["ts_host"])[:n]

    n_blocks = max(cfg.iters // update_every, 1)
    losses, evals, refits = [], [], []
    best_loss, best_params = math.inf, None
    for b in range(n_blocks):
        out = train(loss_fn, model,
                    TrainConfig(lr=cfg.lr, iters=update_every,
                                eval_every=min(cfg.eval_every, update_every),
                                max_iters_per_call=cfg.max_iters_per_call),
                    eval_fn=eval_fn)
        losses.append(out["loss_history"])
        evals.append(out["eval_history"])
        block_best = float(out["best_loss"])     # the block's one sync
        if block_best < best_loss:
            best_loss, best_params = block_best, out["best_params"]
        if b < n_blocks - 1:
            # knots -> quantiles of the states the RHS actually sees
            with torch.no_grad():
                xs = predict(model, grid_train)
                pre = float(loss_fn(model))
                model.update_grids(xs)
                post = float(loss_fn(model))
            refits.append((pre, post))
            if verbose:
                print(f"[lv-grid] block {b}: refit loss {pre:.3e} -> "
                      f"{post:.3e}", flush=True)
    return {"params": {k: v.detach().clone()
                       for k, v in model.named_parameters()},
            "best_params": best_params, "best_loss": best_loss,
            "loss_history": torch.cat(losses),
            "eval_history": torch.cat(evals),
            "refits": refits, "cfg": cfg,
            "model": model, "data": data, "predict": predict}


def main(argv: list[str]) -> int:
    import time

    from kanodes_tpu_torch.train.config import (override_from_args,
                                                override_from_env)

    device = "cuda"
    for a in argv:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
    cfg = LVConfig(iters=10_000)
    cfg = override_from_env(cfg, "KANODE_LV_")
    cfg = override_from_args(cfg, argv)
    t0 = time.perf_counter()
    out = run(cfg, device=device,
              checkpoint_dir=("checkpoints/lv" if "--checkpoint" in argv
                              else None),
              restart="--restart" in argv)
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
