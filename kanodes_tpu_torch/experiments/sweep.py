"""Parameter-efficiency sweep, the paper's Fig. 3C / section A2 study (port of
`kanodes_tpu/experiments/sweep.py`: `train_point` and `run_sweep`).

The reference produced its KAN-vs-MLP loss-vs-size trend by hand-editing
`layer_width` / `grid_size`, re-running the LV driver for 1e5 CPU
iterations a point and hardcoding the converged losses into
`trend_plotter.py:7-14`. Here every point trains through `lv.run` with
the JAX package's curriculum: a 2-layer KAN chain through the fused
kernels (K2 in the shooting phases, K3 in the fixed one and in every
eval), an MLP or a depth-3 chain on the plain path. Sizes train one
after the other (their shapes differ).

`packed_trend_sweep` trains the 8 KAN points at once as ONE
block-diagonal `HeteroPacked` chain on the plain path (as JAX forces
impl="xla" there), optionally with per-member learning rates and the
mask-aware packed L-BFGS (`train/packed_polish.py`); `ensemble_seeds`
trains n same-shape replicas stacked (`train.loop.Stacked`) on one
device (its `mesh=` is ROADMAP.md M16).

Run:  python -m kanodes_tpu_torch.experiments.sweep [--points=kan,mlp]
      [--out=sweep_results_torch.json] [--device=cuda|cpu]
      [--shooting_iters=10000] [--seg4_iters=6000] [--traj_iters=6000]
      [--seed=0] [--n_params=64,52] [--polish_iters=0]
      [--packed=1 [--lr_factors=width|f1,...,f8]]

`--polish_iters=N` polishes each trained point with N L-BFGS iterations
on its train loss (`polish_point`) and reports the polished losses.
`--packed=1` runs `packed_trend_sweep` over the chosen KAN points
instead (the port of scripts/lv_trend_packed.py; `--polish_iters=N` then
polishes the packed members together), `--lr_factors=width` with
scripts/lv_trend_packed.py's width-scaled factors 10 / layer_width.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from kanodes_tpu_torch.experiments import lv as lv_mod

# the reference's published sweep points (trend_plotter.py:7-14).
# "d" in trend_plotter's labels is network DEPTH, not species count:
# the d=2 sizes are one-hidden-layer [2,h,2] MLPs (52/252/502 params at
# h=10/50/100) and the d=3 sizes are two-hidden-layer [2,h,h,2] MLPs —
# h^2+6h+2 gives exactly 29/57/114/162/522 at h=3/5/8/10/20.
REFERENCE_KAN_TREND = {64: 1.4e-4, 80: 5.2e-5, 96: 1.2e-4, 120: 1.9e-5,
                       144: 1.6e-5, 240: 8.3e-7, 480: 6.6e-7, 960: 6.1e-7}
REFERENCE_MLP_TREND = {52: 4.7e-4, 252: 4.14e-5, 502: 1.6e-5}
REFERENCE_MLP3_TREND = {29: 2.0e-4, 57: 2.6e-4, 114: 3.6e-5,
                        162: 3.7e-5, 522: 2.96e-5}

# the default output; the repo's sweep_results.json is the JAX package's
# record and is never written here
DEFAULT_OUT = "sweep_results_torch.json"


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    model: str                  # kan | mlp
    layer_width: int = 10
    grid_size: int = 5
    mlp_hidden: int = 50
    mlp_depth: int = 2          # trend_plotter's "d": hidden layers + 1
    kan_depth: int = 2          # 3 = two-hidden-layer [2,w,w,2] KDense chain

    def mlp_widths(self) -> tuple[int, ...]:
        return (2,) + (self.mlp_hidden,) * (self.mlp_depth - 1) + (2,)

    def kan_widths(self) -> tuple[int, ...]:
        return (2,) + (self.layer_width,) * (self.kan_depth - 1) + (2,)


# KAN sweep matching the reference's param counts:
# params = 12*W*G/5... for [2,W,2] grid G: 4*W*G + 4*W
KAN_SWEEP = (
    SweepPoint("kan", layer_width=4, grid_size=3),    # 64
    SweepPoint("kan", layer_width=5, grid_size=3),    # 80
    SweepPoint("kan", layer_width=4, grid_size=5),    # 96
    SweepPoint("kan", layer_width=5, grid_size=5),    # 120
    SweepPoint("kan", layer_width=6, grid_size=5),    # 144
    SweepPoint("kan", layer_width=10, grid_size=5),   # 240
    SweepPoint("kan", layer_width=20, grid_size=5),   # 480
    SweepPoint("kan", layer_width=40, grid_size=5),   # 960
)
MLP_SWEEP = (
    SweepPoint("mlp", mlp_hidden=10),                 # 52
    SweepPoint("mlp", mlp_hidden=50),                 # 252
    SweepPoint("mlp", mlp_hidden=100),                # 502
)
# beyond-parity depth-3 KAN points ([2,w,w,2], no reference counterpart;
# params = 6*(2w + w^2) at grid 5 — w=4/5/8 -> 192/270/576)
KAN3_SWEEP = (
    SweepPoint("kan", layer_width=4, grid_size=5, kan_depth=3),   # 192
    SweepPoint("kan", layer_width=5, grid_size=5, kan_depth=3),   # 270
    SweepPoint("kan", layer_width=8, grid_size=5, kan_depth=3),   # 576
)
MLP3_SWEEP = (
    SweepPoint("mlp", mlp_hidden=3, mlp_depth=3),     # 29
    SweepPoint("mlp", mlp_hidden=5, mlp_depth=3),     # 57
    SweepPoint("mlp", mlp_hidden=8, mlp_depth=3),     # 114
    SweepPoint("mlp", mlp_hidden=10, mlp_depth=3),    # 162
    SweepPoint("mlp", mlp_hidden=20, mlp_depth=3),    # 522
)
SWEEPS = {"kan": KAN_SWEEP, "mlp": MLP_SWEEP, "kan3": KAN3_SWEEP,
          "mlp3": MLP3_SWEEP}


def base_config(point: SweepPoint, seed: int = 0) -> lv_mod.LVConfig:
    """The point's LVConfig before its phases: the fused kernels cover the
    canonical 2-layer chain; depth-3 chains and MLPs run the plain path."""
    impl = ("fused" if point.model == "kan" and point.kan_depth == 2
            else "xla")
    return lv_mod.LVConfig(model=point.model,
                           seed=seed,
                           layer_width=point.layer_width,
                           kan_widths=(point.kan_widths()
                                       if point.kan_depth != 2 else None),
                           grid_size=point.grid_size,
                           mlp_widths=point.mlp_widths(),
                           impl=impl,
                           # depth-3 chains: the reference's glorot/1e5
                           # init vanishes through the third layer; the
                           # JAX package's probe trained 1e-2 to 9.5e-7
                           # in 3k iterations where 1e-5 stuck at 5.1
                           init_scale=(1.0 if point.model != "kan"
                                       else 1e-5 if point.kan_depth == 2
                                       else 1e-2))


def phase_configs(point: SweepPoint, base: lv_mod.LVConfig, *,
                  shooting_iters: int, seg4_iters: int,
                  traj_iters: int) -> list[lv_mod.LVConfig]:
    """The curriculum: a KAN trains shooting L = 1, then L = 4, then fixed;
    an MLP (tanh MLPs land in rollout-unstable basins under aggressive
    shooting) shooting L = 4, then a long fixed phase at 1e-3 and one at
    2e-4 (the reference trains them Adam(1e-2) on the whole trajectory,
    LV_driver_MLP.jl:92-97). One eval at each phase's end."""
    if point.model == "kan":
        phases = [
            dataclasses.replace(base, solve_mode="shooting", segment_len=1,
                                lr=3e-3, iters=shooting_iters),
            dataclasses.replace(base, solve_mode="shooting", segment_len=4,
                                lr=1e-3, iters=seg4_iters),
            dataclasses.replace(base, solve_mode="fixed", lr=3e-4,
                                iters=traj_iters),
        ]
    else:
        phases = [
            dataclasses.replace(base, solve_mode="shooting", segment_len=4,
                                lr=1e-3, iters=shooting_iters),
            dataclasses.replace(base, solve_mode="fixed", lr=1e-3,
                                iters=seg4_iters + traj_iters),
            dataclasses.replace(base, solve_mode="fixed", lr=2e-4,
                                iters=traj_iters),
        ]
    return [dataclasses.replace(c, eval_every=c.iters) for c in phases]


def train_point(point: SweepPoint, *, shooting_iters: int = 10_000,
                seg4_iters: int = 6_000, traj_iters: int = 6_000,
                seed: int = 0, device="cuda") -> dict[str, Any]:
    """Train one sweep point with the fast curriculum on `device`; returns
    the trajectory-protocol train/test losses (what trend_plotter
    records), the seconds of the phases, each phase's seconds, and the
    final parameters (name -> tensor)."""
    base = base_config(point, seed)
    data = lv_mod.make_data(base, device)
    model = lv_mod.make_model(base, device)
    lv_mod.init_params(base, model)
    n_params = model.num_params()
    params = {n: p.detach() for n, p in model.named_parameters()}

    phase_secs = []
    t0 = time.perf_counter()
    for cfg in phase_configs(point, base, shooting_iters=shooting_iters,
                             seg4_iters=seg4_iters, traj_iters=traj_iters):
        tp = time.perf_counter()
        out = lv_mod.run(cfg, params=params, device=device)
        params = out["params"]
        float(out["loss_history"][-1])          # waits for the device
        phase_secs.append(time.perf_counter() - tp)
    secs = time.perf_counter() - t0

    eval_cfg = dataclasses.replace(base, solve_mode="fixed")
    with torch.no_grad():
        model.load_state_dict(params)
        loss_fn, eval_fn, _ = lv_mod.make_ode_fns(eval_cfg, model, data)
        train_loss, test_loss = float(loss_fn(model)), float(eval_fn(model))
    return {
        "model": point.model,
        "depth": (point.mlp_depth if point.model == "mlp"
                  else point.kan_depth),
        "n_params": n_params,
        "train_loss": train_loss,
        "test_loss": test_loss,
        "seconds": secs,
        "phase_seconds": phase_secs,
        "params": params,
    }


def polish_point(point: SweepPoint, params: dict, *, iters: int = 200,
                 seed: int = 0, device="cuda") -> dict[str, Any]:
    """L-BFGS polish (`train/polish.py`) of a trained point's parameters on
    its fixed-mode (trajectory) train loss, the loss `train_point`
    reports; returns the polished train/test losses, the seconds and the
    polish's bookkeeping (evaluations, host syncs, line-search steps).
    A KAN point's every value-and-gradient is one K3f and one K3b."""
    from kanodes_tpu_torch.train.polish import PolishConfig, polish
    cfg = dataclasses.replace(base_config(point, seed), solve_mode="fixed")
    data = lv_mod.make_data(cfg, device)
    model = lv_mod.make_model(cfg, device)
    with torch.no_grad():
        model.load_state_dict(params)
    loss_fn, eval_fn, _ = lv_mod.make_ode_fns(cfg, model, data)
    t0 = time.perf_counter()
    res = polish(loss_fn, model, PolishConfig(iters=iters))
    best = float(res["best_loss"])              # waits for the device
    secs = time.perf_counter() - t0
    with torch.no_grad():
        test = float(eval_fn(model))
    return {"polish_iters": iters, "polished_train_loss": best,
            "polished_test_loss": test, "polish_seconds": secs,
            "polish_evaluations": res["evaluations"],
            "polish_host_syncs": res["host_syncs"],
            "polish_linesearch_steps": sum(res["linesearch_steps"])}


def run_sweep(points=KAN_SWEEP + MLP_SWEEP, **kw) -> list[dict]:
    """`train_point` over `points`, in order, without their parameters."""
    results = []
    for p in points:
        r = train_point(p, **kw)
        r.pop("params")
        results.append(r)
    return results


def packed_trend_sweep(points=KAN_SWEEP, *, shooting_iters: int = 10_000,
                       seg4_iters: int = 6_000, traj_iters: int = 6_000,
                       seed: int = 0, lr_factors=None,
                       polish_iters: int = 0, on_phase=None,
                       device="cuda", member_params: list | None = None
                       ) -> dict[str, Any]:
    """The Fig-3C KAN d=2 trend sweep as ONE packed program on `device`.

    The member chains (different hidden widths AND grid sizes) pack
    block-diagonally into one `HeteroPacked` chain (variable-size blocks,
    per-row grids), masked, and train together through the `train_point`
    KAN curriculum (shooting L = 1, L = 4, fixed; a fresh Adam each
    phase, as JAX) on the plain path with the per-member mean loss and
    joint best-tracking. `lr_factors` trains member s under
    Adam(lr * lr_factors[s]) (`train(lr_scales=)`). `polish_iters > 0`
    appends the mask-aware packed L-BFGS (`polish_packed`) on the fixed
    loss; each row then also carries polished_{train,test}_loss.
    `member_params`: the members' per-layer `{"C", "W"}` numpy inits (JAX's,
    say); default `lv.init_params` of each member with a CPU generator
    seeded `seed`. `on_phase(i, out)` is called after phase i with its
    `train()` dict.

    Returns {"results": per-point dicts of run_sweep's schema (the
    trajectory-protocol train/test losses of each extracted member),
    "total_seconds" (training only), "phase_seconds", "n_members"} and,
    with a polish, "polish_seconds", "polish_iters", "polish_host_syncs",
    "polish_evaluations"."""
    from kanodes_tpu_torch.interop import (chain_params_from_numpy,
                                           chain_params_to_numpy,
                                           hetero_params_from_numpy)
    from kanodes_tpu_torch.models.packed import HeteroPacked, apply_mask
    from kanodes_tpu_torch.train.loop import TrainConfig, train
    from kanodes_tpu_torch.train.packed_polish import (PackedPolishConfig,
                                                       polish_packed)
    from kanodes_tpu_torch.utils.precision import set_exact_f32
    if any(p.model != "kan" or p.kan_depth != 2 for p in points):
        raise ValueError("packed trend sweep covers the 2-layer KAN "
                         "points (MLPs have no packing analogue here)")
    set_exact_f32()
    cfgs = [lv_mod.LVConfig(model="kan", seed=seed,
                            layer_width=p.layer_width,
                            grid_size=p.grid_size, impl="xla")
            for p in points]
    base = cfgs[0]
    data = lv_mod.make_data(base, device)
    members = [lv_mod.make_model(c, device) for c in cfgs]
    if member_params is None:
        member_params = [chain_params_to_numpy(lv_mod.init_params(c, m))
                         for c, m in zip(cfgs, members)]
    hp = HeteroPacked(members)
    hetero_params_from_numpy(hp, member_params)
    apply_mask(hp.mask(), hp)
    pdata = dict(data, X=hp.tile_state(data["X"]))
    reduce_fn = hp.member_mean()
    lr_scales = None if lr_factors is None else hp.lr_scales(lr_factors)
    phases = [
        dataclasses.replace(base, solve_mode="shooting", segment_len=1,
                            lr=3e-3, iters=shooting_iters),
        dataclasses.replace(base, solve_mode="shooting", segment_len=4,
                            lr=1e-3, iters=seg4_iters),
        dataclasses.replace(base, solve_mode="fixed", lr=3e-4,
                            iters=traj_iters),
    ]
    t0 = time.perf_counter()
    phase_secs = []
    for pi, cfg in enumerate(phases):
        loss_s, _, _ = lv_mod.make_ode_fns(cfg, hp, pdata,
                                           reduce_fn=reduce_fn)
        tp = time.perf_counter()
        out = train(loss_s, hp, TrainConfig(lr=cfg.lr, iters=cfg.iters,
                                            eval_every=cfg.iters),
                    stacked=False, lr_scales=lr_scales)
        out["loss_history"].cpu()                # waits for the device
        phase_secs.append(time.perf_counter() - tp)
        if on_phase is not None:
            on_phase(pi, out)
    total = time.perf_counter() - t0   # training only; the polish apart
    trained = chain_params_to_numpy(hp)           # the masked values

    polished, extra = None, {}
    if polish_iters:
        loss_v, _, _ = lv_mod.make_ode_fns(phases[-1], hp, pdata,
                                           reduce_fn=reduce_fn)
        tp = time.perf_counter()
        pol = polish_packed(loss_v, hp, ids=hp.member_ids(), mask=hp.mask(),
                            n_members=len(points),
                            cfg=PackedPolishConfig(iters=polish_iters))
        pol["best_loss"].cpu()                   # waits for the device
        extra = {"polish_seconds": time.perf_counter() - tp,
                 "polish_iters": polish_iters,
                 "polish_host_syncs": pol["host_syncs"],
                 "polish_evaluations": pol["evaluations"]}
        polished = chain_params_to_numpy(hp)

    def losses(model, cfg, params):
        chain_params_from_numpy(model, params)
        loss_fn, eval_fn, _ = lv_mod.make_ode_fns(
            dataclasses.replace(cfg, solve_mode="fixed"), model, data)
        with torch.no_grad():
            return float(loss_fn(model)), float(eval_fn(model))

    results = []
    for s, (p, c, m) in enumerate(zip(points, cfgs, members)):
        train_loss, test_loss = losses(m, c, hp.extract_member(trained, s))
        row = {"model": "kan", "depth": 2, "layer_width": p.layer_width,
               "grid_size": p.grid_size, "n_params": m.num_params(),
               "train_loss": train_loss, "test_loss": test_loss}
        if polished is not None:
            row["polished_train_loss"], row["polished_test_loss"] = losses(
                m, c, hp.extract_member(polished, s))
        results.append(row)
    return {"results": results, "total_seconds": total,
            "phase_seconds": phase_secs, "n_members": len(points), **extra}


def ensemble_seeds(n: int = 8, *, iters: int = 5000, lr: float = 3e-3,
                   mesh=None, device="cuda",
                   member_params: list | None = None) -> dict[str, Any]:
    """n same-shape LV KAN replicas (different inits) trained as ONE
    stacked program on `device`: plain-path shooting, Adam(lr), `iters`
    iterations (JAX's vmapped scan). `member_params`: a stacked tree of
    [n, ...] numpy leaves to start from (JAX's draws, init scale
    applied); default member s is `lv.init_params` with a CPU generator
    seeded s. Returns {"params" (name -> [n, ...]), "final_losses" (the
    loss at the last iteration), "test_losses"} as numpy. `mesh` (sharding
    the members over devices) is ROADMAP.md M16."""
    import numpy as np

    from kanodes_tpu_torch.interop import stacked_params_from_numpy
    from kanodes_tpu_torch.train.loop import (TrainConfig, init_stacked,
                                              train)
    from kanodes_tpu_torch.utils.precision import set_exact_f32
    if mesh is not None:
        raise NotImplementedError("ensemble_seeds(mesh=) is not ported yet "
                                  "(ROADMAP.md, M16: multi-device)")
    set_exact_f32()
    base = lv_mod.LVConfig(solve_mode="shooting", lr=lr, impl="xla")
    data = lv_mod.make_data(base, device)
    model = lv_mod.make_model(base, device)
    stacked = init_stacked(
        model, lambda m, s: lv_mod.init_params(
            base, m, torch.Generator().manual_seed(s)), range(n))
    if member_params is not None:
        stacked_params_from_numpy(stacked, member_params)
    loss_fn, eval_fn, _ = lv_mod.make_stacked_fns(base, model, data)
    out = train(loss_fn, stacked, TrainConfig(lr=lr, iters=iters,
                                              eval_every=iters),
                track_best=False, stacked=True)
    with torch.no_grad():
        test = eval_fn(stacked)
    return {"params": {k: v.cpu().numpy() for k, v in out["params"].items()},
            "final_losses": out["loss_history"][-1].cpu().numpy(),
            "test_losses": np.asarray(test.cpu())}


def reference_loss(r: dict) -> float | None:
    """The reference's published loss at r's model family, depth and
    size (trend_plotter.py:7-14), if it has one."""
    table = (REFERENCE_KAN_TREND if r["model"] == "kan" and r["depth"] == 2
             else REFERENCE_MLP_TREND if r["model"] == "mlp"
             and r["depth"] == 2
             else REFERENCE_MLP3_TREND if r["model"] == "mlp" else {})
    return table.get(r["n_params"])


def main(argv: list[str]) -> int:
    import json

    opts = {"points": "kan,mlp", "out": DEFAULT_OUT, "device": "cuda",
            "shooting_iters": "10000", "seg4_iters": "6000",
            "traj_iters": "6000", "seed": "0", "n_params": "",
            "polish_iters": "0", "packed": "0", "lr_factors": ""}
    for a in argv:
        key, _, value = a.lstrip("-").partition("=")
        key = key.replace("-", "_")
        if key not in opts or not value:
            raise SystemExit(f"unknown argument {a!r}; have --"
                             + ", --".join(f"{k}=" for k in opts))
        opts[key] = value
    points = [p for name in opts["points"].split(",") for p in SWEEPS[name]]
    if opts["packed"] == "1":       # the packed sweep covers the KAN d=2
        points = [p for p in points if p.model == "kan" and p.kan_depth == 2]
    kw = {k: int(opts[k]) for k in ("shooting_iters", "seg4_iters",
                                     "traj_iters", "seed")}
    if opts["n_params"]:
        wanted = {int(n) for n in opts["n_params"].split(",")}
        points = [p for p in points
                  if lv_mod.make_model(base_config(p), "cpu").num_params()
                  in wanted]
    polish_iters = int(opts["polish_iters"])
    if opts["packed"] == "1":
        return _main_packed(points, opts, kw, polish_iters)
    results = []
    for p in points:
        r = train_point(p, device=opts["device"], **kw)
        params = r.pop("params")
        if polish_iters:
            r.update(polish_point(p, params, iters=polish_iters,
                                  seed=kw["seed"], device=opts["device"]))
        r["reference_loss"] = reference_loss(r)
        results.append(r)
        ref = r["reference_loss"]
        print(f"{r['model']:>4} d={r['depth']} {r['n_params']:>4} params: "
              f"train {r['train_loss']:.2e} test {r['test_loss']:.2e} "
              f"({r['seconds']:.1f}s; phases "
              + ", ".join(f"{s:.1f}" for s in r["phase_seconds"]) + ")"
              + (f"  [reference: {ref:.2e}]" if ref else "")
              + (f"; polished train {r['polished_train_loss']:.2e} test "
                 f"{r['polished_test_loss']:.2e} ({r['polish_seconds']:.1f}s, "
                 f"{r['polish_host_syncs']} syncs)" if polish_iters else ""),
              flush=True)
        # rewritten after every point: a cut run keeps what it finished
        with open(opts["out"], "w") as f:
            json.dump({"device": opts["device"], **kw,
                       "polish_iters": polish_iters, "results": results}, f,
                      indent=1)
    return 0


def _main_packed(points, opts: dict, kw: dict, polish_iters: int) -> int:
    """`--packed=1`: packed_trend_sweep over `points`, then the JSON."""
    import json
    factors = None
    if opts["lr_factors"] == "width":
        # scripts/lv_trend_packed.py: larger members train colder
        factors = [10.0 / p.layer_width for p in points]
    elif opts["lr_factors"]:
        factors = [float(f) for f in opts["lr_factors"].split(",")]
    out = packed_trend_sweep(points, polish_iters=polish_iters,
                             lr_factors=factors, device=opts["device"], **kw)
    for r in out["results"]:
        r["reference_loss"] = reference_loss(r)
        pol = (f" polished {r['polished_train_loss']:.2e}"
               if "polished_train_loss" in r else "")
        print(f"[{r['n_params']:>4} params w={r['layer_width']:>2} "
              f"g={r['grid_size']}] train {r['train_loss']:.2e} "
              f"test {r['test_loss']:.2e}{pol}", flush=True)
    print(f"one packed program, {out['total_seconds']:.1f}s training "
          f"(phases " + ", ".join(f"{s:.1f}" for s in out["phase_seconds"])
          + ")" + (f", polish {out['polish_seconds']:.1f}s "
                   f"({out['polish_host_syncs']} syncs)"
                   if polish_iters else ""), flush=True)
    with open(opts["out"], "w") as f:
        json.dump({"device": opts["device"], **kw, "packed": True,
                   "lr_factors": factors, **out}, f, indent=1)
    return 0


if __name__ == "__main__":
    import sys

    raise SystemExit(main(sys.argv[1:]))
