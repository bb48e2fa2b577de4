"""The PyTorch flavor's LV recipes on the B-spline KAN (port of
`scripts/bspline_lv_full.py` and steps 1-7 of `scripts/harness_compare.py`).

`bspline_lv_full`: `Lotka-Volterra-Pytorch/predator_prey.py:24-25,101,142`
trains a [2,10,2] grid-5 efficient-kan B-spline KAN-ODE with Adam(2e-3)
through torchdiffeq's `odeint` (discretize-then-optimize) and
`predator_prey_adjoint.py:5,132-142` through `odeint_adjoint` (the
continuous backsolve adjoint); the JAX package adds its interpolating
adjoint. Three `lv.run`s: fixed Tsit5 with direct backprop (substeps 2),
and adaptive Tsit5 (rtol 1e-6, atol 1e-8, max_steps 96) through the
backsolve and the interpolating adjoints. The B-spline chain runs the
plain route, as in JAX.

`harness_compare`: `optimized_training.py:719-982`'s main, steps 1-7:
LV data with a 70/15/15 time-ordered split, three models trained with
the horizon curriculum (1.0 -> 2.0 -> 3.5): the baseline B-spline KAN
[2,10,2] (lr 2e-3), the optimized one [2,8,2] with L2 1e-4 and
spline-smoothness 1e-3 regularization on min-max normalized states (lr
1e-3), and the alpha-gated KAN + MLP hybrid; then the metric suite, the
seeded test-horizon rollout and the noise / IC robustness sweeps of
every model (`train/harness.compare_models`), and edge pruning of the
optimized model at 0.01 with its re-evaluation. Steps 8-10 (plots) need
matplotlib and are left out.

Both take an iteration cut. Every run or step reports iterations,
seconds and it/s.

Run:  python -m kanodes_tpu_torch bspline-lv --recipe=full|harness|grid
      [--iters=N] [--curriculum=500,1000,3500] [--update_every=N]
      [--out=PATH] [--device=cuda|cpu]   (default cuda)
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch
from torch import nn

from kanodes_tpu_torch.experiments import lv
from kanodes_tpu_torch.models.bspline import BSplineKANChain
from kanodes_tpu_torch.models.hybrid import DataNormalizer, HybridKANMLP
from kanodes_tpu_torch.ode.integrate import odeint_fixed
from kanodes_tpu_torch.sparsify.edge_prune import prune_chain_edges
from kanodes_tpu_torch.sparsify.regularization import (l2_reg,
                                                       spline_smoothness_reg)
from kanodes_tpu_torch.train.harness import (HarnessConfig, compare_models,
                                             curriculum_train, evaluate_model,
                                             time_ordered_split)
from kanodes_tpu_torch.train.loop import TrainConfig, train
from kanodes_tpu_torch.utils.device import require_device
from kanodes_tpu_torch.utils.precision import set_exact_f32

FULL_ITERS = 10_000


def full_configs(iters: int = FULL_ITERS) -> dict[str, lv.LVConfig]:
    """`scripts/bspline_lv_full.py:54-72`'s three configurations, at
    `iters` iterations."""
    base = dict(model="bspline_kan", iters=iters, lr=2e-3,
                eval_every=min(500, iters))
    adaptive = dict(base, solve_mode="adaptive", rtol=1e-6, atol=1e-8,
                    max_steps=96, max_iters_per_call=2_000)
    return {
        "direct": lv.LVConfig(**base, solve_mode="fixed", substeps=2),
        "backsolve_adjoint": lv.LVConfig(**adaptive, adjoint="backsolve"),
        "interpolating_adjoint": lv.LVConfig(**adaptive,
                                             adjoint="interpolating"),
    }


def run_one(tag: str, cfg: lv.LVConfig, device="cuda") -> dict:
    """One `lv.run` with its record (JAX's keys): the final and best train
    MSE, the full-horizon MSE, seconds and it/s."""
    t0 = time.perf_counter()
    out = lv.run(cfg, device=device)
    final = float(out["loss_history"][-1])          # waits for the device
    dt = time.perf_counter() - t0
    return {"tag": tag, "iters": cfg.iters, "lr": cfg.lr,
            "solve_mode": cfg.solve_mode, "adjoint": cfg.adjoint,
            "first_train": float(out["loss_history"][0]),
            "final_train": final, "best_train": float(out["best_loss"]),
            "full_horizon_mse": float(out["eval_history"][-1]),
            "seconds": dt, "it_per_s": cfg.iters / dt}


def bspline_lv_full(iters: int = FULL_ITERS, device="cuda") -> list[dict]:
    """The three runs of `scripts/bspline_lv_full.py` at `iters`
    iterations each."""
    return [run_one(tag, cfg, device)
            for tag, cfg in full_configs(iters).items()]


class NormalizedPhysicalModel(nn.Module):
    """The physical-space view of a model trained on normalized states:
    du/dt = scale f(z(u)) (optimized_training.py:382-394)."""

    def __init__(self, inner: nn.Module, norm: DataNormalizer):
        super().__init__()
        self.inner, self.norm = inner, norm
        self.in_dims, self.out_dims = inner.in_dims, inner.out_dims

    def apply(self, u):
        s = torch.as_tensor(self.norm.scale, device=u.device)
        return s * self.inner.apply(self.norm.normalize(u))

    def num_params(self) -> int:
        return self.inner.num_params()


def _train_normalized(model, norm, ts_tr, X_tr, hc: HarnessConfig,
                      lr: float, l2_w: float, smooth_w: float) -> list:
    """The optimized model's curriculum (harness_compare.py step 3): the
    trajectory MSE on normalized states plus L2 over the weights (the knot
    grids left out) and spline smoothness, a fresh Adam each stage."""
    dev = next(model.parameters()).device
    stages = []
    for horizon, iters in zip(hc.curriculum_horizons, hc.curriculum_iters):
        n = max(int(np.sum(ts_tr <= horizon + 1e-9)), 2)
        ts_h = np.asarray(ts_tr[:n], np.float32)
        Z_h = norm.normalize(torch.as_tensor(X_tr[:n], device=dev))

        def loss_fn(m, ts_h=ts_h, Z_h=Z_h):
            zs = odeint_fixed(lambda t, z, p: p.apply(z), Z_h[0], ts_h, m,
                              solver="tsit5", substeps=hc.substeps)
            mse = torch.mean((zs - Z_h) ** 2)
            return (mse + l2_w * l2_reg(m, weights_only=True)
                    + smooth_w * spline_smoothness_reg(m))

        out = train(loss_fn, model, TrainConfig(lr=lr, iters=iters,
                                                eval_every=iters))
        stages.append({"horizon": horizon,
                       "final_loss": float(out["loss_history"][-1])})
    return stages


def _timed(fn, iters: int) -> tuple:
    t0 = time.perf_counter()
    res = fn()
    dt = time.perf_counter() - t0
    return res, {"iters": iters, "seconds": dt, "it_per_s": iters / dt}


def harness_compare(curriculum_iters=(500, 1000, 3500), device="cuda",
                    verbose: bool = False) -> dict:
    """`scripts/harness_compare.py` steps 1-7 on `device`, the curriculum
    cut to `curriculum_iters` (JAX's 500/1000/3500 by default); each
    model's init from a CPU generator seeded as JAX's key (0, 1, 2).
    Returns the report (JAX's keys) plus "timing": each step's
    iterations, seconds and it/s, and "models"."""
    set_exact_f32()
    dev = require_device(device)
    hc = HarnessConfig(curriculum_iters=tuple(curriculum_iters))
    iters = int(sum(hc.curriculum_iters))
    timing = {}

    def say(msg):
        if verbose:
            print(msg, flush=True)

    # step 1: data + split
    data = lv.make_data(lv.LVConfig(), device)
    ts, X = data["ts_host"], data["X"].cpu().numpy()
    (ts_tr, X_tr), (ts_va, _), (ts_te, _) = time_ordered_split(ts, X, hc)
    say(f"[1] data: {len(ts)} points, split {len(ts_tr)}/{len(ts_va)}/"
        f"{len(ts_te)}")

    # step 2: the baseline
    baseline = BSplineKANChain([2, 10, 2], grid_size=5, device=dev)
    baseline.init(torch.Generator().manual_seed(0))
    outb, timing["baseline"] = _timed(lambda: curriculum_train(
        baseline, ts_tr, X_tr, dataclasses.replace(hc, lr=2e-3)), iters)
    say(f"[2] baseline KAN [2,10,2]: {baseline.num_params()} params, "
        f"stages {outb['stages']}")

    # step 3: optimized (regularizers + normalizer)
    optimized = BSplineKANChain([2, 8, 2], grid_size=5, device=dev)
    optimized.init(torch.Generator().manual_seed(1))
    norm = DataNormalizer.fit(X_tr)
    stages_o, timing["optimized"] = _timed(lambda: _train_normalized(
        optimized, norm, ts_tr, X_tr, hc, 1e-3, 1e-4, 1e-3), iters)
    opt_phys = NormalizedPhysicalModel(optimized, norm)
    say(f"[3] optimized KAN [2,8,2]+regs+normalizer: "
        f"{optimized.num_params()} params, stages {stages_o}")

    # step 4: the hybrid
    hybrid = HybridKANMLP([2, 8, 2], grid_size=5, mlp_hidden=8, device=dev)
    hybrid.init(torch.Generator().manual_seed(2))
    outh, timing["hybrid"] = _timed(lambda: curriculum_train(
        hybrid, ts_tr, X_tr, dataclasses.replace(hc, lr=1e-3)), iters)
    say(f"[4] hybrid KAN+MLP: {hybrid.num_params()} params, blend alpha "
        f"{hybrid.blend():.3f}, stages {outh['stages']}")

    # steps 5 + 7: evaluation and robustness of every model
    report, timing["compare"] = _timed(lambda: compare_models(
        {"baseline": baseline, "optimized": opt_phys, "hybrid": hybrid},
        ts, X, hc), 0)

    # step 6: edge pruning of the optimized model
    pruned = BSplineKANChain([2, 8, 2], grid_size=5, device=dev)
    dicts, masks, n_pruned = prune_chain_edges(optimized.param_dicts(),
                                               threshold=0.01)
    with torch.no_grad():
        for layer, p in zip(pruned.layers, dicts):
            for name, v in p.items():
                getattr(layer, name).copy_(v)
    pruned_eval = evaluate_model(NormalizedPhysicalModel(pruned, norm), ts,
                                 X, hc)
    report["optimized_pruned"] = {
        "full": pruned_eval, "edges_pruned": n_pruned,
        "edges_total": int(sum(m.numel() for m in masks))}
    say(f"[6] pruning: {n_pruned} edges zeroed, full-horizon MSE "
        f"{pruned_eval['mse']:.3e}")
    report["stages"] = {"baseline": outb["stages"], "optimized": stages_o,
                        "hybrid": outh["stages"]}
    report["blend_alpha"] = hybrid.blend()
    report["num_params"] = {"baseline": baseline.num_params(),
                            "optimized": optimized.num_params(),
                            "hybrid": hybrid.num_params()}
    report["timing"] = timing
    report["models"] = {"baseline": baseline, "optimized": opt_phys,
                        "hybrid": hybrid}
    return report


def grid_refinement(iters: int = 3000, update_every: int = 500,
                    device="cuda") -> dict:
    """`lv.run_grid_refinement`'s default recipe (B-spline LV, lr 2e-3,
    init_scale 1, fixed mode) at `iters` iterations with a refit every
    `update_every`: the refits' loss pairs, iterations, seconds, it/s."""
    cfg = lv.LVConfig(model="bspline_kan", iters=iters, lr=2e-3,
                      init_scale=1.0, eval_every=min(100, update_every))
    t0 = time.perf_counter()
    out = lv.run_grid_refinement(cfg, update_every=update_every,
                                 device=device)
    final = float(out["loss_history"][-1])
    dt = time.perf_counter() - t0
    return {"iters": int(out["loss_history"].shape[0]),
            "update_every": update_every, "refits": out["refits"],
            "final_train": final, "best_train": out["best_loss"],
            "seconds": dt, "it_per_s": out["loss_history"].shape[0] / dt,
            "out": out}


def main(argv: list[str]) -> int:
    opts = {"recipe": "full", "iters": str(FULL_ITERS), "device": "cuda",
            "curriculum": "500,1000,3500", "update_every": "500",
            "out": ""}
    for a in argv:
        if not a.startswith("--") or "=" not in a:
            raise SystemExit(f"unknown argument {a!r}")
        k, v = a[2:].split("=", 1)
        if k not in opts:
            raise SystemExit(f"unknown option --{k}")
        opts[k] = v
    dev = opts["device"]
    if opts["recipe"] == "full":
        result = bspline_lv_full(int(opts["iters"]), dev)
        for rec in result:
            print(json.dumps(rec), flush=True)
    elif opts["recipe"] == "harness":
        rep = harness_compare(
            tuple(int(v) for v in opts["curriculum"].split(",")), dev,
            verbose=True)
        rep.pop("models")
        result = rep
        print(json.dumps({"timing": rep["timing"],
                          "blend_alpha": rep["blend_alpha"]}), flush=True)
    elif opts["recipe"] == "grid":
        res = grid_refinement(int(opts["iters"]),
                              int(opts["update_every"]), dev)
        res.pop("out")
        result = res
        print(json.dumps(res), flush=True)
    else:
        raise SystemExit(f"unknown recipe {opts['recipe']!r}")
    if opts["out"]:
        with open(opts["out"], "w") as f:
            json.dump(result, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    import sys

    raise SystemExit(main(sys.argv[1:]))
