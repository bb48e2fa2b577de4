"""LV interpretability pipeline: sparsify -> prune -> symbolic recovery
(port of `kanodes_tpu/experiments/lv_symbolic.py`).

Rebuild of the reference's post-hoc chain (SURVEY.md §3.5):
  1. train the LV KAN-ODE with L1/entropy sparsity
     (`LV_driver_KANODE.jl:199-201`): fused shooting at segment_len 1,
     then 4 (K2 and its adjoint every step; K3f for the evals);
  2. prune weak hidden nodes (threshold 1e-1 at the call site :169) and
     retrain the smaller network [2, k, 2] (:168-170): fused shooting at
     segment_len 4 (K2), then fused fixed (K3 and its reverse sweep);
  3. symbolic regression on the host's GP engine:
     a. per-edge activation fits (`Symbolic_reg.jl:138-156`);
     b. GLOBAL 2-variable fits of the full learned RHS — the closed-form
        ODE the paper reports (ẋ=1.495x−0.986xy, ẏ=0.970xy−2.929y,
        `Plotting_symbolic.jl:221-222`);
     c. SINDy on the same samples;
  4. re-simulate both recovered ODEs and compare against data
     (`Plotting_symbolic.jl:196-236`).

Every tensor step (training, pruning, sampling the chain, the
re-simulation) runs on `device`; only the GP engine and the SINDy
least squares run on the host, as in the JAX package. Parameters cross
between the phases as the per-layer numpy dicts `lv.run(params=)`
takes.

Run:  python -m kanodes_tpu_torch.experiments.lv_symbolic [--key=value ...]
      [--device=cuda|cpu]   (default cuda; raises without a card)
      [--init=jax_seed0]   (start from the JAX package's seed-0 init,
      lv_jax_seed0_init.npy; default: the port's own init at --seed)

The default init (the port's draw at --seed=0) does not reproduce the JAX
package's recorded law: the full budget keeps width 3, but SINDy's dy/dt
law takes six terms and its re-simulation diverges. The JAX package's
pipeline does the same from that draw (scripts/lv_symbolic_jax_cpu.py
--init=port_seed0), so the draw, not the port, is at fault. --seed=1
and 2 and --init=jax_seed0 gave the law within 3.1%; --seed=3 failed as
seed 0 did (ROADMAP.md §3).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any

import numpy as np
import torch

from kanodes_tpu_torch.experiments import lv as lv_mod
from kanodes_tpu_torch.interop import chain_params_to_numpy
from kanodes_tpu_torch.ops import rk_fused
from kanodes_tpu_torch.sparsify.prune import prune
from kanodes_tpu_torch.utils.device import require_device
from kanodes_tpu_torch.utils.precision import set_exact_f32


@dataclasses.dataclass(frozen=True)
class SymbolicPipelineConfig:
    sparse_iters: int = 15_000
    retrain_iters: int = 10_000
    prune_threshold: float = 1e-1          # LV_driver_KANODE.jl:169
    act_reg: float = 5e-4                  # :199-201
    sr_generations: int = 300
    sr_restarts: int = 3
    # operator set for the PER-EDGE fits. The default mirrors
    # Symbolic_reg.jl:147; pass ("+", "-", "*") for pole-free
    # polynomial edge fits when the expressions will be COMPOSED over a
    # wide mesh (rational fits extrapolate with poles — same rationale
    # as pde_source.recover_source's polynomial default)
    edge_ops: tuple = ("+", "-", "*", "/")
    seed: int = 0


# the JAX package's LV init at seed 0 (`LVConfig(seed=0)`: glorot / 1e5 on
# [2, 10, 2] grid 5, drawn by jax.random), saved by
# scripts/save_lv_jax_init.py as one flat float32 vector in the JAX leaf
# order (each layer's C, then W); `load_jax_seed0_init` splits it
JAX_SEED0_INIT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "lv_jax_seed0_init.npy")


def load_jax_seed0_init() -> list[dict[str, np.ndarray]]:
    """The JAX package's seed-0 init as per-layer {"C", "W"} arrays on
    `LVConfig()`'s chain, as `run_pipeline(params=)` and
    `lv.run(params=)` take them."""
    flat = np.load(JAX_SEED0_INIT).astype(np.float32)
    cfg = lv_mod.LVConfig()
    widths = (2, cfg.layer_width, 2)
    out, at = [], 0
    for i, o in zip(widths[:-1], widths[1:]):
        layer = {}
        for name, shape in (("C", (i, cfg.grid_size, o)), ("W", (i, o))):
            n = int(np.prod(shape))
            layer[name] = flat[at:at + n].reshape(shape)
            at += n
        out.append(layer)
    assert at == flat.size, (at, flat.size)
    return out


def _train_phase(name: str, cfg: lv_mod.LVConfig, params, device,
                 phases: list) -> dict[str, Any]:
    """lv.run from `params` with one eval at the end; appends the phase's
    record (config, seconds to its synced end, last losses, the K2/K3
    launches it made) to `phases`."""
    cfg = dataclasses.replace(cfg, eval_every=cfg.iters)
    before = dict(rk_fused.LAUNCHES)
    t0 = time.perf_counter()
    out = lv_mod.run(cfg, params=params, device=device)
    last = float(out["loss_history"][-1])        # waits for the device
    seconds = time.perf_counter() - t0
    phases.append({
        "name": name, "cfg": cfg, "seconds": seconds,
        "last_loss": last, "last_eval": float(out["eval_history"][-1]),
        "launches": {k: v - before[k] for k, v in rk_fused.LAUNCHES.items()
                     if v != before[k]}})
    return out


def run_pipeline(cfg: SymbolicPipelineConfig | None = None,
                 device="cuda", verbose: bool = False,
                 params=None) -> dict[str, Any]:
    """The whole pipeline on `device`; returns the JAX dict's keys
    (`params` as per-layer numpy dicts) plus `phases` (each training
    phase's record) and `seconds` (wall seconds of each step, each
    ending in a read of its result on the host).

    `params`: per-layer {"C", "W"} numpy arrays to start the sparse
    training from (e.g. `load_jax_seed0_init()`, the JAX package's own
    init); default `lv.init_params` at `cfg.seed`."""
    cfg = cfg or SymbolicPipelineConfig()
    dev = require_device(device)
    set_exact_f32()
    seconds: dict[str, float] = {}
    phases: list = []

    # -- 1. sparse training (fast shooting curriculum + L1 reg) ----------
    t0 = time.perf_counter()
    base = lv_mod.LVConfig(impl="fused", sparse_on=True,
                           act_reg=cfg.act_reg, seed=cfg.seed)
    sparse = [
        ("sparse L=1", dataclasses.replace(
            base, solve_mode="shooting", segment_len=1, lr=3e-3,
            iters=cfg.sparse_iters // 3 * 2)),
        ("sparse L=4", dataclasses.replace(
            base, solve_mode="shooting", segment_len=4, lr=1e-3,
            iters=cfg.sparse_iters // 3)),
    ]
    data = lv_mod.make_data(base, dev)
    if params is None:
        model = lv_mod.make_model(base, dev)
        lv_mod.init_params(base, model)
        params = chain_params_to_numpy(model)
    for name, ph in sparse:
        out = _train_phase(name, ph, params, dev, phases)
        params = chain_params_to_numpy(out["model"])
    seconds["sparse"] = time.perf_counter() - t0

    # -- 2. prune + retrain dense ----------------------------------------
    t0 = time.perf_counter()
    X_train = data["X"][:data["n_train"]]
    res = prune(out["model"], X_train, threshold=cfg.prune_threshold)
    width = int(res.kept.size)
    seconds["prune"] = time.perf_counter() - t0
    if verbose:
        print(f"pruned hidden width {base.layer_width} -> {width} "
              f"(scores {np.sort(res.scores)[::-1][:5]})", flush=True)
    t0 = time.perf_counter()
    params_p = res.params
    retrain_base = dataclasses.replace(base, layer_width=width,
                                       sparse_on=False)
    retrain = [
        ("retrain shooting L=4", dataclasses.replace(
            retrain_base, solve_mode="shooting", segment_len=4, lr=1e-3,
            iters=cfg.retrain_iters // 2)),
        ("retrain fixed", dataclasses.replace(
            retrain_base, solve_mode="fixed", lr=3e-4,
            iters=cfg.retrain_iters // 2)),
    ]
    for name, ph in retrain:
        out = _train_phase(name, ph, params_p, dev, phases)
        params_p = chain_params_to_numpy(out["model"])
    model_p = out["model"]
    seconds["retrain"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    loss_fn, eval_fn, _ = lv_mod.make_ode_fns(
        dataclasses.replace(retrain_base, solve_mode="fixed"), model_p,
        data)
    with torch.no_grad():
        pruned_train = float(loss_fn(model_p))
        pruned_test = float(eval_fn(model_p))
    seconds["pruned_losses"] = time.perf_counter() - t0

    # -- 3a. per-edge symbolic fits ---------------------------------------
    from kanodes_tpu_torch.symbolic.fit import (compact_fit,
                                                fit_edge_activations,
                                                resimulate_symbolic_rhs,
                                                simplify_expression)
    from kanodes_tpu_torch.symbolic.sindy import fit_sindy

    t0 = time.perf_counter()
    edge_eqs = fit_edge_activations(
        model_p, X_train, ops=cfg.edge_ops,
        generations=cfg.sr_generations // 2, seed=cfg.seed)
    seconds["edge_fits"] = time.perf_counter() - t0

    # -- 3b. global 2-var fits of the learned RHS ------------------------
    # sample ON the training trajectory (+ small jitter): the KAN is only
    # constrained where data visited; uniform box samples would pollute
    # the fit with unconstrained extrapolation regions
    t0 = time.perf_counter()
    rng = np.random.default_rng(cfg.seed)
    Xs = X_train.cpu().numpy()
    span = Xs.max(axis=0) - Xs.min(axis=0)
    reps = 12
    tiled = np.tile(Xs, (reps, 1))
    jitter = rng.normal(0, 0.03, tiled.shape) * span
    samples = (tiled + jitter).astype(np.float32)
    with torch.no_grad():
        rhs_vals = model_p.apply(torch.from_numpy(samples).to(dev)) \
            .cpu().numpy()
    global_eqs, global_pretty = [], []
    for d in range(2):
        fit = compact_fit(samples, rhs_vals[:, d], ops=("+", "-", "*"),
                          generations=cfg.sr_generations,
                          restarts=cfg.sr_restarts, seed=cfg.seed + d)
        global_eqs.append(fit)
        global_pretty.append(simplify_expression(fit.expression))
    seconds["global_fits"] = time.perf_counter() - t0

    # -- 3c. SINDy fast pass on the same samples --------------------------
    t0 = time.perf_counter()
    sindy_fits = fit_sindy(samples, rhs_vals, degree=3, threshold="auto")
    seconds["sindy"] = time.perf_counter() - t0

    # -- 4. re-simulate the symbolic ODE ----------------------------------
    t0 = time.perf_counter()
    u0 = data["X"][0].cpu().numpy()
    ts = data["ts_host"]
    sym_traj = resimulate_symbolic_rhs([f.expression for f in global_eqs],
                                       u0, ts, 2, device=dev)
    sym_mse = float(torch.mean((sym_traj - data["X"]) ** 2))
    sindy_traj = resimulate_symbolic_rhs(
        [f.expression for f in sindy_fits], u0, ts, 2, device=dev)
    sindy_mse = float(torch.mean((sindy_traj - data["X"]) ** 2))
    seconds["resim"] = time.perf_counter() - t0

    return {
        "model": model_p, "params": params_p,
        "kept_nodes": res.kept, "node_scores": res.scores,
        "pruned_train_loss": pruned_train, "pruned_test_loss": pruned_test,
        "edge_equations": edge_eqs,
        "global_equations": global_pretty,
        "global_fits": global_eqs,
        "symbolic_resim_mse": sym_mse,
        "sindy_equations": [f.expression for f in sindy_fits],
        "sindy_fits": sindy_fits,
        "sindy_resim_mse": sindy_mse,
        "data": data,
        "phases": phases, "seconds": seconds,
    }


def main(argv: list[str]) -> int:
    from kanodes_tpu_torch.train.config import override_from_args

    device, params = "cuda", None
    for a in argv:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        if a == "--init=jax_seed0":
            params = load_jax_seed0_init()
        elif a.startswith("--init="):
            raise ValueError(f"{a}: the one init option is --init=jax_seed0")
    cfg = override_from_args(SymbolicPipelineConfig(), argv)
    t0 = time.perf_counter()
    out = run_pipeline(cfg, device=device, verbose=True, params=params)
    print(f"pruned width: {out['kept_nodes'].size}, "
          f"train {out['pruned_train_loss']:.3e} "
          f"test {out['pruned_test_loss']:.3e}")
    print("recovered ODE (GP):")
    print("  dx/dt =", out["global_equations"][0])
    print("  dy/dt =", out["global_equations"][1])
    print("recovered ODE (SINDy):")
    print("  dx/dt =", out["sindy_equations"][0])
    print("  dy/dt =", out["sindy_equations"][1])
    print(f"re-simulation MSE vs data: GP {out['symbolic_resim_mse']:.3e} "
          f"SINDy {out['sindy_resim_mse']:.3e}  "
          f"({time.perf_counter() - t0:.0f}s)")
    for ph in out["phases"]:
        it = ph["cfg"].iters
        print(f"phase {ph['name']}: {it} iters in {ph['seconds']:.2f}s "
              f"({it / ph['seconds']:.0f} it/s), train {ph['last_loss']:.3e} "
              f"test {ph['last_eval']:.3e}, launches {ph['launches']}")
    print("seconds: " + ", ".join(f"{k} {v:.2f}"
                                  for k, v in out["seconds"].items())
          + f" (on {device})")
    return 0


if __name__ == "__main__":
    import sys

    raise SystemExit(main(sys.argv[1:]))
