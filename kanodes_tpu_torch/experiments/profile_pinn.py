"""Where a KAN-PINN training epoch spends its time on the card.

    python -m kanodes_tpu_torch.experiments.profile_pinn \\
        [--epochs=20] [--warmup=3] [--pde_w=1.0] \\
        [--key=value ...]                               (PINNConfig fields)

Builds the trainer's epoch as `pinn/train.py` does (the port's seeded
init at `cfg.widths`), runs `--warmup` epochs, then `--epochs` more under
`torch.profiler` (CPU and CUDA activities). Each epoch is the trainer's
own body: the host's numpy draw, the one copy, the adaptive top-k (when
`n_adaptive` > 0 and `--pde_w` > 0), the loss, backward, clip and Adam.
Prints one JSON line: wall ms per epoch (host clock, ending in a
synchronize), device-busy ms per epoch (the kernels' own time, one
stream), the device's idle share, the host draw's ms per epoch (timed
alone), the epochs' peak device memory, the kernels and host operations
that take the most time, and the card's name and power limit. Needs a
CUDA device; imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from kanodes_tpu_torch.experiments.profile_lv import _device_us, _is_kernel
from kanodes_tpu_torch.pinn import geometry as G
from kanodes_tpu_torch.pinn import losses as L
from kanodes_tpu_torch.pinn import train as T
from kanodes_tpu_torch.pinn.model import KANPINN
from kanodes_tpu_torch.train.config import override_from_args
from kanodes_tpu_torch.utils.device import require_device
from kanodes_tpu_torch.utils.precision import set_exact_f32


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def build(cfg: T.PINNConfig, device):
    """(model, optimizer, epoch_step, draw): the trainer's pieces on
    `device` at the port's seeded init; draw() is one epoch's batch on
    the device."""
    geo, mat = G.Geometry(), L.Material()
    model = KANPINN(cfg.widths, cfg.n_basis, cfg.trainable_centers,
                    device=device).init(torch.Generator().manual_seed(
                        cfg.seed))
    opt = T.make_optimizer(cfg, model)
    step = T.make_step(cfg, model, geo, mat)[0]
    rng = np.random.default_rng(cfg.seed)
    n_cand = (max(cfg.adaptive_candidates, 4 * cfg.n_adaptive)
              if cfg.n_adaptive > 0 else 0)

    def draw():
        return T.to_device(T.sample_epoch_batch(cfg, geo, rng,
                                                n_cand=n_cand), device)

    return model, opt, step, draw


def profile(cfg: T.PINNConfig, epochs: int = 20, warmup: int = 3,
            pde_w: float = 1.0, top: int = 10) -> dict:
    device = require_device("cuda")
    set_exact_f32()
    model, opt, step, draw = build(cfg, device)

    def epoch():
        step(opt, draw(), pde_w, cfg.learning_rate)

    for _ in range(warmup):
        epoch()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(epochs):
            epoch()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / epochs
    peak = torch.cuda.max_memory_allocated()
    geo, rng = G.Geometry(), np.random.default_rng(cfg.seed)
    n_cand = (max(cfg.adaptive_candidates, 4 * cfg.n_adaptive)
              if cfg.n_adaptive > 0 else 0)
    t0 = time.perf_counter()
    for _ in range(epochs):
        T.sample_epoch_batch(cfg, geo, rng, n_cand=n_cand)
    draw_ms = (time.perf_counter() - t0) * 1e3 / epochs

    events = prof.key_averages()
    host_keys = {e.key for e in events
                 if e.device_type != torch.autograd.DeviceType.CUDA}
    kernels = sorted((e for e in events if _is_kernel(e, host_keys)),
                     key=_device_us, reverse=True)
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / epochs
    if busy_ms > wall_ms * 1.01:
        raise RuntimeError(f"device busy {busy_ms:.4f} ms/epoch exceeds the "
                           f"wall time {wall_ms:.4f} ms/epoch: the device-"
                           f"time sum counts an event twice")
    host = sorted((e for e in events if not _is_kernel(e, host_keys)),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    return {
        "run": f"pinn {list(cfg.widths)} B={cfg.n_basis} "
               f"adaptive {cfg.n_adaptive}/{n_cand} {cfg.residual}",
        "epochs": epochs, "pde_w": pde_w,
        "wall_ms_per_epoch": wall_ms, "device_busy_ms_per_epoch": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "host_draw_ms_per_epoch": draw_ms, "peak_memory_bytes": peak,
        "kernel_launches_per_epoch": sum(e.count for e in kernels) / epochs,
        "top_kernels": [
            {"name": e.key[:80], "ms_per_epoch": _device_us(e) / 1e3 / epochs,
             "calls_per_epoch": e.count / epochs} for e in kernels[:top]],
        "top_host_ops": [
            {"name": e.key[:80],
             "self_cpu_ms_per_epoch": e.self_cpu_time_total / 1e3 / epochs,
             "calls_per_epoch": e.count / epochs} for e in host[:top]],
        "card": card_line(),
    }


def main(argv: list[str]) -> int:
    opts = {"epochs": 20, "warmup": 3}
    pde_w, rest = 1.0, []
    for a in argv:
        key = a.lstrip("-").split("=", 1)[0]
        if key in opts and "=" in a:
            opts[key] = int(a.split("=", 1)[1])
        elif key == "pde_w" and "=" in a:
            pde_w = float(a.split("=", 1)[1])
        else:
            rest.append(a)
    cfg = override_from_args(T.PINNConfig(), rest)
    print(json.dumps(profile(cfg, opts["epochs"], opts["warmup"], pde_w)),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
