"""Where an LV training iteration spends its time on the card.

    python -m kanodes_tpu_torch.experiments.profile_lv \\
        [--iters=20] [--warmup=5] [--key=value ...]    (LVConfig fields)

Builds the LV trainer as `experiments/lv.py` does, runs `--warmup`
iterations (loss, backward, Adam step), then `--iters` more under
`torch.profiler` (CPU and CUDA activities), and times one eval after
them. Prints one JSON line: wall ms per iteration (host clock, ending in
a synchronize), device-busy ms per iteration (the kernels' own time, one
stream, so no overlap), the device's idle share, the kernels and the
host operations that take the most time per iteration, the eval's ms,
and the card's name and power limit. Needs a CUDA device; imports no
JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from kanodes_tpu_torch.experiments import lv
from kanodes_tpu_torch.train.config import override_from_args
from kanodes_tpu_torch.train.loop import TrainConfig, make_optimizer
from kanodes_tpu_torch.utils.device import require_device
from kanodes_tpu_torch.utils.precision import set_exact_f32


def _device_us(event) -> float:
    # the attribute's name changed across PyTorch releases
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def _is_kernel(event, host_keys) -> bool:
    """A device-side event (a kernel or a copy). Not the host op that
    launched it (which carries the same device time), and not a range
    with a host twin of the same name: a user annotation such as
    Optimizer.step, or the profiler's own buffer requests."""
    return (event.device_type == torch.autograd.DeviceType.CUDA
            and event.key not in host_keys)


def device_us_by_kernel(torch, fn, reps: int = 10,
                        short: bool = False) -> dict[str, float]:
    """Device µs per call of fn() under torch.profiler, by kernel name;
    with `short`, the name up to its first parenthesis or template
    argument, without the anonymous namespace. It imports its helpers
    itself: compare_trees runs its source in other checkouts."""
    from kanodes_tpu_torch.experiments.profile_lv import _device_us, _is_kernel
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    host = {e.key for e in events
            if e.device_type != torch.autograd.DeviceType.CUDA}
    out: dict[str, float] = {}
    for e in events:
        if _is_kernel(e, host):
            name = e.key
            if short:
                name = name.replace("(anonymous namespace)::", "")
                name = name.split("(")[0].split("<")[0].split()[-1]
            out[name] = out.get(name, 0.0) + _device_us(e) / reps
    return out


def profile(cfg: lv.LVConfig, iters: int = 20, warmup: int = 5,
            top: int = 8) -> dict:
    device = require_device("cuda")
    set_exact_f32()
    data = lv.make_data(cfg, device)
    model = lv.make_model(cfg, device)
    lv.init_params(cfg, model)
    loss_fn, eval_fn, _ = lv.make_ode_fns(cfg, model, data)
    return measure(f"{cfg.impl}/{cfg.solve_mode}", model, loss_fn, eval_fn,
                   cfg.lr, iters, warmup, top)


def measure(run: str, model, loss_fn, eval_fn, lr: float, iters: int,
            warmup: int, top: int) -> dict:
    """Profile `iters` Adam iterations of loss_fn on `model` (on the card)
    after `warmup`, then time one eval; the JSON record described above,
    labelled `run`."""
    opt = make_optimizer(TrainConfig(lr=lr), model.parameters())

    def step():
        opt.zero_grad(set_to_none=True)
        loss_fn(model).backward()
        opt.step()

    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    t0 = time.perf_counter()
    with torch.no_grad():
        eval_fn(model)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3

    events = prof.key_averages()
    host_keys = {e.key for e in events
                 if e.device_type != torch.autograd.DeviceType.CUDA}
    kernels = sorted((e for e in events if _is_kernel(e, host_keys)),
                     key=_device_us, reverse=True)
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / iters
    # one stream, so the kernels cannot overlap: a busy time above the
    # wall time means an event was counted twice, not a negative idle
    if busy_ms > wall_ms * 1.01:
        raise RuntimeError(f"device busy {busy_ms:.4f} ms/iter exceeds the "
                           f"wall time {wall_ms:.4f} ms/iter: the device-"
                           f"time sum counts an event twice")
    host = sorted((e for e in events if not _is_kernel(e, host_keys)),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return {
        "run": run, "iters": iters,
        "wall_ms_per_iter": wall_ms, "device_busy_ms_per_iter": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "top_kernels": [
            {"name": e.key[:80], "ms_per_iter": _device_us(e) / 1e3 / iters,
             "calls_per_iter": e.count / iters} for e in kernels[:top]],
        "top_host_ops": [
            {"name": e.key[:80],
             "self_cpu_ms_per_iter": e.self_cpu_time_total / 1e3 / iters,
             "calls_per_iter": e.count / iters} for e in host[:top]],
        "eval_ms": eval_ms, "card": card,
    }


def main(argv: list[str]) -> int:
    opts = {"iters": 20, "warmup": 5}
    rest = []
    for a in argv:
        key = a.lstrip("-").split("=", 1)[0]
        if key in opts and "=" in a:
            opts[key] = int(a.split("=", 1)[1])
        else:
            rest.append(a)
    cfg = override_from_args(lv.LVConfig(), rest)
    print(json.dumps(profile(cfg, opts["iters"], opts["warmup"])),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
