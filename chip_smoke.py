#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`kanodes_tpu_torch`) on one GPU.

    python3 chip_smoke.py        (from the root of the repository)

Builds the hand-written CUDA kernels from `kanodes_tpu_torch/csrc/`,
holds each against its plain PyTorch version on the card, drives the LV
KAN-ODE trainer (the port's main path) in shooting and fixed mode through
`kanodes_tpu_torch.experiments.lv.run(..., device="cuda")`, checks from
the launch counters that both runs went through the kernels, and times
each kernel against its plain version with CUDA events.

Every phase prints one JSON line. The line before the last two is the
kernel table, then the card's `nvidia-smi` name and power limit, and the
last line is {"ok": true, "device": {...}}. Any failure raises and exits
non-zero; without a CUDA device, or without the package beside this
file, it exits non-zero before printing a result. Imports no JAX.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# tolerances of the JAX suite's own kernel-vs-XLA parity tests
# (tests/test_rk_fused.py:36,62)
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=5e-4, atol=1e-6)

# Pallas kernel each CUDA kernel replaces
KERNELS = {
    "fused_rk_step_fwd": "kanodes_tpu/ops/rk_fused.py:144",
    "fused_rk_step_bwd": "kanodes_tpu/ops/rk_fused.py:167",
    "fused_rk_multistep_fwd": "kanodes_tpu/ops/rk_fused.py:311",
    "fused_rk_multistep_bwd": "kanodes_tpu/ops/rk_fused.py:346",
}
SOURCE = "kanodes_tpu_torch/csrc/rk_fused.cu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def lv_inputs(rng, torch, K, scale=0.3):
    """LV-width chain params [2,10,2], G=5, and K states, on the card."""
    def t(a):
        return torch.tensor(a, dtype=torch.float32, device="cuda")
    params = [t(rng.uniform(-scale, scale, s))
              for s in ((10, 10), (2, 10), (50, 2), (10, 2))]
    x = t(rng.uniform(0.3, 2.0, (K, 2)))
    return x, params


def assert_close(failures, name, got, want, tol):
    err = float((got - want).abs().max())
    bound = float((tol["atol"] + tol["rtol"] * want.abs()).min())
    ok = bool(((got - want).abs()
               <= tol["atol"] + tol["rtol"] * want.abs()).all())
    if not ok:
        failures.append(f"{name}: max_abs_err {err:.3e} "
                        f"(rtol {tol['rtol']}, atol {tol['atol']}, "
                        f"tightest bound {bound:.3e})")
    return err


def phase_kernels(torch, rk, spec, rng):
    """Kernel vs plain version on the card, values and all gradients."""
    failures, max_err, cases = [], {k: 0.0 for k in KERNELS}, []
    k3f_detail = []
    for solver in ("tsit5", "rk4"):
        x, params = lv_inputs(rng, torch, 34)
        gy = torch.tensor(rng.standard_normal((34, 2)), dtype=torch.float32,
                          device="cuda")
        k = rk._consts(spec, solver, 0.1)
        y = rk._launch_step_fwd(k, x, params)
        y_ref = rk.fused_rk_step_reference(spec, solver, 0.1, x, *params)
        e = assert_close(failures, f"K2f {solver}", y, y_ref, FWD_TOL)
        max_err["fused_rk_step_fwd"] = max(max_err["fused_rk_step_fwd"], e)
        g = rk._launch_step_bwd(k, x, params, gy)
        g_ref = rk.fused_rk_step_bwd_reference(spec, solver, 0.1, x,
                                               *params, gy)
        xs = [t.clone().requires_grad_() for t in (x, *params)]
        g_auto = torch.autograd.grad(
            rk.fused_rk_step_reference(spec, solver, 0.1, *xs), xs, gy)
        for name, a, b, c in zip(("dx", "dc1", "dw1", "dc2", "dw2"),
                                 g, g_ref, g_auto):
            e = assert_close(failures, f"K2b {solver} {name}", a, b,
                             GRAD_TOL)
            assert_close(failures, f"K2b {solver} {name} vs autograd", a, c,
                         GRAD_TOL)
            max_err["fused_rk_step_bwd"] = max(max_err["fused_rk_step_bwd"],
                                               e)
        cases.append(f"K2 K=34 {solver}")
    for n, K in ((34, 1), (140, 1), (12, 3)):
        x0, params = lv_inputs(rng, torch, K)
        gys = torch.tensor(rng.standard_normal((n, K, 2)) / n,
                           dtype=torch.float32, device="cuda")
        k = rk._consts(spec, "tsit5", 0.1)
        ys = rk._launch_multistep_fwd(k, n, x0, params)
        ys_ref = rk.fused_rk_multistep_reference(spec, "tsit5", 0.1, n, x0,
                                                 *params)
        # Many chained steps carry two f32 implementations apart at the
        # f32 floor (on the CPU, JAX and the plain torch version differ by
        # 4e-5 after 140 steps of the trained LV model, each 2e-5 from a
        # float64 run), so an elementwise rtol of 1e-5 cannot hold between
        # them. The multistep forward is held instead to the plain version
        # run in float64: the kernel must be as accurate as the plain f32
        # version (error <= 2x its error + atol).
        ys64 = rk.fused_rk_multistep_reference(
            spec, "tsit5", 0.1, n, x0.double(), *(p.double() for p in params))
        err_k = float((ys.double() - ys64).abs().max())
        err_p = float((ys_ref.double() - ys64).abs().max())
        if err_k > 2 * err_p + FWD_TOL["atol"]:
            failures.append(f"K3f n={n} K={K}: error vs float64 {err_k:.3e} "
                            f"> 2 x plain f32's {err_p:.3e} + atol")
        e = float((ys - ys_ref).abs().max())
        elementwise = bool(((ys - ys_ref).abs() <= FWD_TOL["atol"]
                            + FWD_TOL["rtol"] * ys_ref.abs()).all())
        k3f_detail.append({"n": n, "K": K, "max_abs_err": e,
                           "elementwise_fwd_tol": elementwise,
                           "kernel_err_vs_f64": err_k,
                           "plain_f32_err_vs_f64": err_p})
        max_err["fused_rk_multistep_fwd"] = max(
            max_err["fused_rk_multistep_fwd"], e)
        g = rk._launch_multistep_bwd(k, n, x0, ys, params, gys)
        g_ref = rk.fused_rk_multistep_bwd_reference(spec, "tsit5", 0.1, n,
                                                    x0, ys, *params, gys)
        xs = [t.clone().requires_grad_() for t in (x0, *params)]
        g_auto = torch.autograd.grad(
            rk.fused_rk_multistep_reference(spec, "tsit5", 0.1, n, *xs), xs,
            gys)
        for name, a, b, c in zip(("dx0", "dc1", "dw1", "dc2", "dw2"),
                                 g, g_ref, g_auto):
            e = assert_close(failures, f"K3b n={n} K={K} {name}", a, b,
                             GRAD_TOL)
            assert_close(failures, f"K3b n={n} K={K} {name} vs autograd",
                         a, c, GRAD_TOL)
            max_err["fused_rk_multistep_bwd"] = max(
                max_err["fused_rk_multistep_bwd"], e)
        cases.append(f"K3 n={n} K={K}")
    torch.cuda.synchronize()
    emit({"phase": "kernel_vs_plain", "cases": cases,
          "max_abs_err": max_err, "fwd_tol": FWD_TOL, "grad_tol": GRAD_TOL,
          "multistep_fwd": k3f_detail, "failures": failures})
    if failures:
        raise AssertionError("kernel disagrees with its plain version:\n"
                             + "\n".join(failures))
    return max_err


def expected_launches(cfg):
    """Kernel launches one lv.run() implies (train blocks as train()
    rounds them: every block ends in one eval = one multistep forward)."""
    evals = max(cfg.iters // cfg.eval_every, 1)
    inner = max(cfg.iters // evals, 1)
    n_evals = evals * math.ceil(cfg.iters / (evals * inner))
    iters = n_evals * inner
    if cfg.solve_mode == "shooting":
        steps = iters * cfg.segment_len * cfg.substeps
        return {"fused_rk_step_fwd": steps, "fused_rk_step_bwd": steps,
                "fused_rk_multistep_fwd": n_evals,
                "fused_rk_multistep_bwd": 0}
    return {"fused_rk_step_fwd": 0, "fused_rk_step_bwd": 0,
            "fused_rk_multistep_fwd": iters + n_evals,
            "fused_rk_multistep_bwd": iters}


def main_path_configs(lv):
    return (lv.LVConfig(impl="fused", solve_mode="shooting", segment_len=1,
                        lr=1.5e-2, iters=256, eval_every=128),
            lv.LVConfig(impl="fused", solve_mode="fixed", iters=128,
                        eval_every=64))


def timed_run(torch, lv, cfg):
    """lv.run on the card; returns (out, seconds to the synced end)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = lv.run(cfg, device="cuda",
                 generator=torch.Generator().manual_seed(cfg.seed))
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_main_path(torch, lv, rk, card):
    """The LV trainer on the card, shooting then fixed mode. `seconds`
    includes the data, the model and the process's first use of the
    optimizer on the card; phase_timings repeats the runs warm."""
    launches = {k: 0 for k in KERNELS}
    results = []
    for cfg in main_path_configs(lv):
        torch.cuda.synchronize()
        rk.reset_launch_counts()
        out, seconds = timed_run(torch, lv, cfg)
        counts = dict(rk.LAUNCHES)
        tensors = [out["loss_history"], out["eval_history"], out["best_loss"],
                   *out["params"].values(), *out["best_params"].values(),
                   *out["model"].parameters()]
        assert all(t.is_cuda for t in tensors), "a result left the card"
        losses = out["loss_history"].cpu()
        evals = out["eval_history"].cpu()
        assert losses.shape == (cfg.iters,), losses.shape
        assert bool(torch.isfinite(losses).all()), "non-finite train loss"
        assert bool(torch.isfinite(evals).all()), "non-finite eval loss"
        best, first = float(out["best_loss"]), float(losses[0])
        assert best < first, f"best loss {best} !< first loss {first}"
        want = expected_launches(cfg)
        assert counts == want, f"launches {counts} != expected {want}"
        for name in KERNELS:
            launches[name] += counts[name]
        res = {"phase": "main_path", "solve_mode": cfg.solve_mode,
               "iters": cfg.iters, "first_loss": first, "best_loss": best,
               "last_loss": float(losses[-1]),
               "last_eval": float(evals[-1]), "launches": counts,
               "seconds": seconds, "it_per_s": cfg.iters / seconds,
               "card": card}
        emit(res)
        results.append(res)
    for name in KERNELS:
        assert launches[name] > 0, f"{name} never launched on the main path"
    return launches, results


def cuda_ms(torch, fn, reps):
    """Median milliseconds of fn() over reps, CUDA events, after warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_timings(torch, lv, rk, spec, rng, card):
    """Each kernel against its plain version at the LV training shapes:
    K2 at K=34 rows (shooting, L=1), K3 at n=34 steps K=1 (fixed-mode
    loss); K3 forward also at n=140 (eval). Then both main-path runs
    again in the warm process, for their it/s."""
    x, params = lv_inputs(rng, torch, 34)
    gy = torch.randn_like(x)
    x0 = x[:1].contiguous()
    k = rk._consts(spec, "tsit5", 0.1)
    grid = rk._grid_of(k, x)
    ys34 = rk._launch_multistep_fwd(k, 34, x0, params)
    gys34 = torch.randn_like(ys34)
    cases = {
        "fused_rk_step_fwd": (
            lambda: rk._launch_step_fwd(k, x, params),
            lambda: rk._step_fwd_plain(k, x, params, grid)),
        "fused_rk_step_bwd": (
            lambda: rk._launch_step_bwd(k, x, params, gy),
            lambda: rk._step_bwd_plain(k, x, params, grid, gy)),
        "fused_rk_multistep_fwd": (
            lambda: rk._launch_multistep_fwd(k, 34, x0, params),
            lambda: rk._multistep_fwd_plain(k, 34, x0, params, grid)),
        "fused_rk_multistep_bwd": (
            lambda: rk._launch_multistep_bwd(k, 34, x0, ys34, params, gys34),
            lambda: rk._multistep_bwd_plain(k, 34, x0, ys34, params, grid,
                                            gys34)),
    }
    times = {}
    with torch.no_grad():
        for name, (kern, plain) in cases.items():
            # plain, kernel, kernel, plain: the two medians of each kind
            # are kept; the reported number is their mean
            p1 = cuda_ms(torch, plain, 5)
            k1 = cuda_ms(torch, kern, 50)
            k2 = cuda_ms(torch, kern, 50)
            p2 = cuda_ms(torch, plain, 5)
            times[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                           "ms_runs": [k1, k2], "plain_ms_runs": [p1, p2]}
        eval140 = {
            "ms": cuda_ms(torch, lambda: rk._launch_multistep_fwd(
                k, 140, x0, params), 20),
            "plain_ms": cuda_ms(torch, lambda: rk._multistep_fwd_plain(
                k, 140, x0, params, grid), 3)}
    warm = {}
    for cfg in main_path_configs(lv):
        _, seconds = timed_run(torch, lv, cfg)
        warm[cfg.solve_mode] = {"iters": cfg.iters, "seconds": seconds,
                                "it_per_s": cfg.iters / seconds}
    emit({"phase": "timings", "shapes": {
              "fused_rk_step": "K=34 I=2 H=10 G=5 tsit5",
              "fused_rk_multistep": "n=34 K=1 I=2 H=10 G=5 tsit5"},
          "kernels": times, "multistep_fwd_n140": eval140,
          "main_path_warm": warm, "card": card})
    return times


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "kanodes_tpu_torch")):
        raise SystemExit("chip_smoke.py: kanodes_tpu_torch/ is not beside "
                         "this script; run it from a checkout of the repo")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is "
                         "False; this smoke run needs a CUDA device")
    sys.path.insert(0, REPO)
    from kanodes_tpu_torch.experiments import lv
    from kanodes_tpu_torch.models.kdense import KANChain
    from kanodes_tpu_torch.ops import _cuda
    from kanodes_tpu_torch.ops import rk_fused as rk
    from kanodes_tpu_torch.ops.kdense_pallas import chain_spec_of
    from kanodes_tpu_torch.utils.precision import set_exact_f32
    import numpy as np

    set_exact_f32()
    card = card_line()
    nvcc = subprocess.run([_cuda._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True)
    emit({"phase": "environment", "card": card, "torch": torch.__version__,
          "torch_cuda": torch.version.cuda,
          "nvcc": nvcc.stdout.strip().splitlines()[-1],
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    path, log = _cuda.build()
    _cuda.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(path, REPO),
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})

    rng = np.random.default_rng(0)
    spec = chain_spec_of(KANChain.mlp_like([2, 10, 2], grid_len=5))
    max_err = phase_kernels(torch, rk, spec, rng)
    launches, _ = phase_main_path(torch, lv, rk, card)
    times = phase_timings(torch, lv, rk, spec, rng, card)

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": max_err[name], "ms": times[name]["ms"],
         "plain_ms": times[name]["plain_ms"]}
        for name, replaces in KERNELS.items()]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
