"""Where a gray-box source-recovery training iteration spends its time on
the card.

    python -m kanodes_tpu_torch.experiments.profile_source \\
        [--iters=20] [--warmup=5] [--key=value ...]    (SourceConfig fields)

Builds the trainer as `experiments/pde_source.py` does (the layer's
seeded init), then measures it as `profile_lv` does (`profile_lv.measure`):
one JSON line with wall ms per iteration, device-busy ms per iteration,
the device's idle share, the top kernels and host operations, the eval's
ms and the card's name and power limit. Needs a CUDA device; imports no
JAX.
"""

from __future__ import annotations

import json
import sys

import torch

from kanodes_tpu_torch.experiments import pde_source as ps
from kanodes_tpu_torch.experiments.profile_lv import measure
from kanodes_tpu_torch.train.config import override_from_args
from kanodes_tpu_torch.utils.precision import set_exact_f32


def profile(cfg: ps.SourceConfig, iters: int = 20, warmup: int = 5,
            top: int = 8) -> dict:
    set_exact_f32()
    model = ps.make_model(cfg, "cuda")
    model.init(torch.Generator().manual_seed(cfg.seed))
    loss_fn, eval_fn, _ = ps.make_fns(cfg, model, ps.make_data(cfg))
    return measure(f"source {cfg.problem} {cfg.ndim}-D {cfg.impl}", model,
                   loss_fn, eval_fn, cfg.lr, iters, warmup, top)


def main(argv: list[str]) -> int:
    opts = {"iters": 20, "warmup": 5}
    rest = []
    for a in argv:
        key = a.lstrip("-").split("=", 1)[0]
        if key in opts and "=" in a:
            opts[key] = int(a.split("=", 1)[1])
        else:
            rest.append(a)
    cfg = override_from_args(ps.SourceConfig(), rest)
    print(json.dumps(profile(cfg, opts["iters"], opts["warmup"])),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
