"""The Allen-Cahn surrogate with a grid refinement at a coarse basis
(port of `scripts/ac_grid_refine.py`, its phases cut in iterations).

At G = 5 the basis resolution binds, so a refit of the grid span pays:
a short shooting warmup on the default (-1, 1) grid, a span refit onto
the visited normalized inputs (`sparsify/grid_refine.py`), then the
remaining phases on the refined span; the fixed-grid arm runs the same
schedule on the default grid. The configuration is the recipe's:
`SurrogateConfig(problem="allen_cahn", impl="fused", kan_grid=5,
rk_solver="rk4", substeps=24)`, so both arms run K2-m (`ops/rk_fused.py`,
a block a row) at rk4, the refined arm at the new span's constants (the
refit's `ChainSpec`: asymmetric grid_lims, h from the span). The refit
restarts the optimizer (Adam moments of the old basis mean nothing in
the new one); a phase of the same mode as the one before continues its
Adam state at the new learning rate, as the script does.

Run:  python -m kanodes_tpu_torch.experiments.ac_grid_refine
      [--refit_at=200] [--phases=49800,30000,20000] [--fixed_arm=1]
      [--out=PATH] [--device=cuda|cpu]   (default: the full budget, cuda)
"""

from __future__ import annotations

import dataclasses
import json
import time

import torch

from kanodes_tpu_torch.experiments.pde_surrogate import (SurrogateConfig,
                                                         make_data, make_fns,
                                                         make_model)
from kanodes_tpu_torch.sparsify.grid_refine import refine_kdense_chain_grid
from kanodes_tpu_torch.train.loop import TrainConfig, train
from kanodes_tpu_torch.utils.precision import set_exact_f32

KAN_GRID = 5
REFIT_AT = 200
# (solve mode, learning rate, iterations): the script's post-refit phases
PHASES = (("shooting", 1e-2, 49_800),
          ("shooting", 1e-3, 30_000),
          ("fixed", 3e-4, 20_000))
BASE = SurrogateConfig(problem="allen_cahn", impl="fused", kan_grid=KAN_GRID,
                       rk_solver="rk4", substeps=24,
                       max_iters_per_call=5_000, eval_every=500)


def cut_phases(iters) -> tuple:
    """PHASES with their iterations replaced by `iters`."""
    return tuple((m, lr, int(n)) for (m, lr, _), n in zip(PHASES, iters))


def _train_phases(model, data, phases, base, on_phase=None) -> list[dict]:
    """Train `model` through `phases` in place, carrying the Adam state
    (at the new learning rate) between phases of one mode."""
    fns = {m: make_fns(dataclasses.replace(base, solve_mode=m), model, data)
           for m in {m for m, _, _ in phases}}
    history, opt_state, prev = [], None, None
    for mode, lr, iters in phases:
        train_loss, eval_loss, _ = fns[mode]
        if opt_state is not None and mode == prev:
            for g in opt_state["param_groups"]:
                g["lr"] = lr
        else:
            opt_state = None
        t0 = time.perf_counter()
        out = train(train_loss, model,
                    TrainConfig(lr=lr, iters=iters,
                                eval_every=min(base.eval_every, iters),
                                max_iters_per_call=base.max_iters_per_call),
                    eval_fn=eval_loss, opt_state=opt_state)
        evals = out["eval_history"]
        rec = {"phase": mode, "lr": lr, "iters": iters,
               "snapshot_mse": float(evals[-1]),
               "snapshot_mse_best": float(torch.min(evals))}
        dt = time.perf_counter() - t0
        rec.update(seconds=dt, it_per_s=iters / dt)
        history.append(rec)
        if on_phase is not None:
            on_phase(rec)
        opt_state, prev = out["opt_state"], mode
    return history


def run_recipe(refit_at: int = REFIT_AT, phases=PHASES,
               fixed_arm: bool = True, device="cuda",
               on_phase=None) -> dict:
    """The recipe on `device`: the `refit_at`-iteration shooting warmup,
    the refit, `phases` on the refined span, and (with `fixed_arm`) the
    same schedule on the default grid from the same init. Returns the
    script's record keys (`refit`, `history_refined`, `history_fixed`,
    `refined`, `fixed`, `total_iters`, `total_wall_s`) plus `model`, the
    refined chain, and `data`; `on_phase(record)` is called after every
    phase and after the refit."""
    set_exact_f32()
    base = BASE
    t_all = time.perf_counter()
    data = make_data(base)
    model = make_model(base, data, device)
    model.init(torch.Generator().manual_seed(base.seed))
    warm = (("shooting", 1e-2, refit_at),)
    history = _train_phases(model, data, warm, base, on_phase)
    history[0]["phase"] = "warmup"

    t0 = time.perf_counter()
    _, eval_loss, predict = make_fns(
        dataclasses.replace(base, solve_mode="shooting"), model, data)
    with torch.no_grad():
        samples = predict(model)
        before = float(eval_loss(model))
        model, info = refine_kdense_chain_grid(model, samples)
        _, eval_new, _ = make_fns(
            dataclasses.replace(base, solve_mode="fixed"), model, data)
        after = float(eval_new(model))
    info.update(eval_before=before, eval_after=after,
                wall_s=time.perf_counter() - t0)
    if on_phase is not None:
        on_phase(dict(info, phase="refit"))
    history += _train_phases(model, data, phases, base, on_phase)
    result = {"kan_grid": base.kan_grid, "refit": info,
              "history_refined": history,
              "refined": {"end": history[-1]["snapshot_mse"],
                          "best": min(h["snapshot_mse_best"]
                                      for h in history)}}
    if fixed_arm:
        model_f = make_model(base, data, device)
        model_f.init(torch.Generator().manual_seed(base.seed))
        hist_f = _train_phases(model_f, data, warm + tuple(phases), base,
                               on_phase)
        result.update(history_fixed=hist_f,
                      fixed={"end": hist_f[-1]["snapshot_mse"],
                             "best": min(h["snapshot_mse_best"]
                                         for h in hist_f)})
    result.update(total_iters=refit_at + sum(p[2] for p in phases),
                  total_wall_s=time.perf_counter() - t_all, model=model,
                  data=data)
    return result


def main(argv: list[str]) -> int:
    opts = {"refit_at": str(REFIT_AT),
            "phases": ",".join(str(p[2]) for p in PHASES),
            "fixed_arm": "1", "out": "", "device": "cuda"}
    for a in argv:
        if not a.startswith("--") or "=" not in a:
            raise SystemExit(f"unknown argument {a!r}")
        k, v = a[2:].split("=", 1)
        if k not in opts:
            raise SystemExit(f"unknown option --{k}")
        opts[k] = v
    res = run_recipe(int(opts["refit_at"]),
                     cut_phases(int(v) for v in opts["phases"].split(",")),
                     fixed_arm=opts["fixed_arm"] not in ("0", "false"),
                     device=opts["device"],
                     on_phase=lambda r: print(json.dumps(r), flush=True))
    res.pop("model")
    res.pop("data")
    print(json.dumps({k: res[k] for k in ("refined", "fixed", "total_iters",
                                          "total_wall_s") if k in res}))
    if opts["out"]:
        with open(opts["out"], "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    import sys

    raise SystemExit(main(sys.argv[1:]))
