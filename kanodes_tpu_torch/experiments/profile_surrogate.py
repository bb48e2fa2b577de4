"""Where a PDE-surrogate training iteration spends its time on the card.

    python -m kanodes_tpu_torch.experiments.profile_surrogate \\
        [--iters=20] [--warmup=5] [--key=value ...]  (SurrogateConfig fields)
    python -m kanodes_tpu_torch.experiments.profile_surrogate --runs=narrow

`--runs=narrow` measures, one line each in one process, Burgers and 1-D
Allen-Cahn fused fixed and shooting on the narrow route (K2/K3 a block a
row), then Burgers fused fixed on the wide kernels beside them.

Builds the trainer as `experiments/pde_surrogate.py` does (the chain's
seeded init), then measures it as `profile_lv` does (`profile_lv.measure`):
one JSON line with wall ms per iteration, device-busy ms per iteration,
the device's idle share, the top kernels and host operations, the eval's
ms and the card's name and power limit. Needs a CUDA device; imports no
JAX.
"""

from __future__ import annotations

import dataclasses
import json
import sys

import torch

from kanodes_tpu_torch.experiments import pde_surrogate as ps
from kanodes_tpu_torch.experiments.profile_lv import measure
from kanodes_tpu_torch.train.config import override_from_args
from kanodes_tpu_torch.utils.precision import set_exact_f32


def profile(cfg: ps.SurrogateConfig, iters: int = 20, warmup: int = 5,
            top: int = 8) -> dict:
    set_exact_f32()
    data = ps.make_data(cfg)
    model = ps.make_model(cfg, data, "cuda")
    model.init(torch.Generator().manual_seed(cfg.seed))
    loss_fn, eval_fn, _ = ps.make_fns(cfg, model, data)
    return measure(f"surrogate {cfg.problem} {cfg.impl}/{cfg.solve_mode}",
                   model, loss_fn, eval_fn, cfg.resolved_lr(), iters, warmup,
                   top)


# --runs=narrow: (problem, solve_mode, wide_kernels), impl="fused"
NARROW_RUNS = (("burgers", "fixed", None), ("burgers", "shooting", None),
               ("allen_cahn", "fixed", None), ("allen_cahn", "shooting", None),
               ("burgers", "fixed", True))


def main(argv: list[str]) -> int:
    opts = {"iters": 20, "warmup": 5}
    runs, rest = None, []
    for a in argv:
        key = a.lstrip("-").split("=", 1)[0]
        if key in opts and "=" in a:
            opts[key] = int(a.split("=", 1)[1])
        elif key == "runs":
            runs = a.split("=", 1)[1]
        else:
            rest.append(a)
    if runs not in (None, "narrow"):
        raise ValueError(f"--runs takes 'narrow', got {runs!r}")
    base = override_from_args(ps.SurrogateConfig(), rest)
    cfgs = [base] if runs is None else [
        dataclasses.replace(base, problem=p, impl="fused", solve_mode=m,
                            wide_kernels=w) for p, m, w in NARROW_RUNS]
    for cfg in cfgs:
        rec = profile(cfg, opts["iters"], opts["warmup"])
        rec["wide_kernels"] = cfg.wide_kernels
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
