"""Time backward kernels and training iterations of two checkouts of this
repository on one card, in turns.

    python -m kanodes_tpu_torch.experiments.compare_trees PARENT CHANGE \\
        [--out=FILE] [--groups=gray_wide,lv,members,small]

PARENT and CHANGE are the roots of two checkouts (for example a `git
archive` of the parent commit unpacked in a directory .gitignore lists).
For each root, in the order parent, change, change, parent, one
subprocess builds that root's kernels and times, with chip_smoke.py's
helpers and inputs (CUDA-event ms, `cuda_ms`, and the profiler's device
µs, `device_us`), the kernels of each group asked for (all by default):
  * gray_wide: K5f and K5b (tsit5, grid 10) at Fisher-KPP 1-D [1, 26],
    Allen-Cahn 1-D [1, 41] and the [32, 32] fields of 2-D Fisher-KPP and
    Allen-Cahn; K7b at the shooting groups (Schrödinger K = 7, 2-D
    Allen-Cahn K = 4, n = 40); K10 at K = 1, n = 40 and 20 (both);
  * lv: K3b at n = 34, K = 1 and K4b at T = 35, K = 1 (LV defaults, the
    trainer's seeded init; `LV_ADJOINT_INPUTS`); K4f at T = 35, K = 1
    on the same init, and a sha256 of K4f's ys, records (the accepted
    steps') and stats on every `chip_smoke.ADAPTIVE_CASES` input, at K =
    33 and 256 rows and on the two cap chains (`ADAPTIVE_INPUTS`);
    K3f at n = 34 and 140, K = 1 on that init, and the largest
    |difference| of K3f's ys between the two trees there, over K = 17 and
    300 rows and on the cap chains (`k3f_outputs`);
  * members: K8f and K8b on MEMBERS_CASES[0] (8 LV members [16, 80, 16]
    G = 5 at the init, the train grid), and a sha256 of K8f's outputs and
    of K8b's gradients on every members input (`members_hashes`);
  * small: a sha256 of K2's and K3's outputs on the chains within
    kan_chain.cuh's caps (K2 at K = 34, tsit5 and rk4; K3 at n = 34, K =
    1 and on the two cap chains) and of the loss history of 64 LV fused
    shooting iterations (`small_flavor_hashes`), to show that a tree's
    chains within the caps keep their parent's bits.
Then, in the same turns (host times swing on a shared host), the group's
profiles: `profile_source --ndim=2` for Fisher-KPP and Allen-Cahn and
`profile_surrogate --solve_mode=shooting` for Schrödinger and 2-D
Allen-Cahn (gray_wide); `profile_lv --impl=fused` in fixed and adaptive
mode (lv); `lv_members --profile=1`, the ensemble's iteration
(members). Prints one JSON line per run (and writes them to FILE), then
the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

# K3b at n = 34, K = 1 (chip_smoke's LV inputs) and K4b at T = 35, K = 1
# (LV defaults, the trainer's seeded init), both tsit5 [2,10,2] G=5 on the
# card: launch closures and K4f's stats. Uses only what every checkout
# since the port began has.
LV_ADJOINT_INPUTS = r'''
def lv_adjoint_launches(torch, np, cs):
    from kanodes_tpu_torch.experiments import lv
    from kanodes_tpu_torch.ode.integrate import StepController
    from kanodes_tpu_torch.ops import kdense_pallas as kp
    from kanodes_tpu_torch.ops import rk_adaptive_fused as ra
    from kanodes_tpu_torch.ops import rk_fused as rk
    rng = np.random.default_rng(0)
    cfg = lv.LVConfig()
    model = lv.init_params(cfg, lv.make_model(cfg, "cuda"))
    spec = kp.chain_spec_of(model)
    x0, params = cs.lv_inputs(rng, torch, 1)
    k = rk._consts(spec, "tsit5", 0.1)
    ys = rk._launch_multistep_fwd(k, 34, x0, params)
    gys = torch.tensor(rng.standard_normal((34, 1, 2)) / 34,
                       dtype=torch.float32, device="cuda")
    data = lv.make_data(cfg, "cuda")
    fp = [p.detach().contiguous() for p in kp.fused_params(model)]
    u0 = data["X"][:1].contiguous()
    ts = data["ts"][:data["n_train"]].contiguous()
    ka = ra._consts(spec, "tsit5", cfg.rtol, cfg.atol, StepController(),
                    None)
    ysa, rec = ra._launch_fwd(ka, cfg.max_steps, u0, ts, fp)
    gya = torch.tensor(rng.standard_normal(tuple(ysa.shape)) / ts.shape[0],
                       dtype=torch.float32, device="cuda")
    return (lambda: rk._launch_multistep_bwd(k, 34, x0, ys, params, gys),
            lambda: ra._launch_bwd(ka, u0, fp, rec, gya), rec[4].tolist())
'''

# K4f at LV defaults (T = 35, K = 1, the trainer's seeded init), K4f's
# ys, records and stats hashed on chip_smoke's K4 inputs, and K8b on
# MEMBERS_CASES[0] (8 LV members at the init, the train grid: the main
# path's solve) with K8f's records. Uses only what every checkout with
# chip_smoke's cap chains (`cap_inputs`, `CAP_CHAINS`) has.
ADAPTIVE_INPUTS = r'''
def lv_adaptive_launch(torch, np, cs):
    from kanodes_tpu_torch.experiments import lv
    from kanodes_tpu_torch.ode.integrate import StepController
    from kanodes_tpu_torch.ops import kdense_pallas as kp
    from kanodes_tpu_torch.ops import rk_adaptive_fused as ra
    cfg = lv.LVConfig()
    model = lv.init_params(cfg, lv.make_model(cfg, "cuda"))
    spec = kp.chain_spec_of(model)
    data = lv.make_data(cfg, "cuda")
    fp = [p.detach().contiguous() for p in kp.fused_params(model)]
    u0 = data["X"][:1].contiguous()
    ts = data["ts"][:data["n_train"]].contiguous()
    ka = ra._consts(spec, "tsit5", cfg.rtol, cfg.atol, StepController(),
                    None)
    return lambda: ra._launch_fwd(ka, cfg.max_steps, u0, ts, fp)


def k4f_hashes(torch, np, cs):
    import hashlib
    from kanodes_tpu_torch.models.kdense import KANChain
    from kanodes_tpu_torch.ode.integrate import StepController
    from kanodes_tpu_torch.ops import kdense_pallas as kp
    from kanodes_tpu_torch.ops import rk_adaptive_fused as ra
    lv_spec = kp.chain_spec_of(KANChain.mlp_like([2, 10, 2], grid_len=5))
    grid = torch.arange(0, 36, dtype=torch.float32, device="cuda") * 0.1
    cases = []
    for case in cs.ADAPTIVE_CASES:
        x0, params, ts = cs.adaptive_case_inputs(torch, case)
        cases.append((case.label(), lv_spec, case.solver, case.rtol,
                      case.atol, case.max_steps,
                      StepController.pi() if case.pi else StepController(),
                      case.dt0, x0, ts, params))
    for K in (33, 256):
        x0, params = cs.lv_inputs(np.random.default_rng(K), torch, K)
        cases.append((f"K={K} rows, tsit5 rtol=0.001", lv_spec, "tsit5",
                      1e-3, 1e-6, 256, StepController(), None, x0, grid,
                      params))
    for basis, norm in cs.CAP_CHAINS:
        spec, x0, params = cs.cap_inputs(torch, basis, norm)
        cases.append((f"cap [8,32,8] G=16 {basis}/{norm}", spec, "tsit5",
                      1e-3, 1e-6, 256, StepController(), None, x0, grid,
                      params))
    out = {}
    for label, spec, solver, rtol, atol, ms, ctrl, dt0, x0, ts, params \
            in cases:
        k = ra._consts(spec, solver, rtol, atol, ctrl, dt0)
        ys, (rx, rk1, rdt, rsx, stats) = ra._launch_fwd(k, ms, x0, ts,
                                                        params)
        n = int(stats[0])
        h = hashlib.sha256()
        for t in (ys, rx[:n], rk1[:n], rdt[:n], rsx[:n], stats):
            h.update(t.cpu().numpy().tobytes())
        out[label] = {"stats": stats.tolist(), "sha256": h.hexdigest()[:16]}
    return out


def lv_fixed_launch(torch, np, cs, n_steps):
    from kanodes_tpu_torch.experiments import lv
    from kanodes_tpu_torch.ops import kdense_pallas as kp
    from kanodes_tpu_torch.ops import rk_fused as rk
    cfg = lv.LVConfig()
    model = lv.init_params(cfg, lv.make_model(cfg, "cuda"))
    spec = kp.chain_spec_of(model)
    data = lv.make_data(cfg, "cuda")
    fp = [p.detach().contiguous() for p in kp.fused_params(model)]
    u0 = data["X"][:1].contiguous()
    k = rk._consts(spec, "tsit5", cfg.dt / cfg.substeps)
    return lambda: rk._launch_multistep_fwd(k, n_steps, u0, fp)


def members_fwd_launch(torch, np, cs):
    from kanodes_tpu_torch.ode.integrate import StepController
    from kanodes_tpu_torch.ops import rk_adaptive_fused as ra
    case = cs.MEMBERS_CASES[0]
    spec, x0, params, ts = cs.members_case_inputs(torch, case)
    k = ra._consts(spec, case.solver, case.rtol, case.atol,
                   StepController(), case.dt0)
    return lambda: ra._launch_members_fwd(k, case.S, case.max_steps, x0, ts,
                                          params)


def k3f_outputs(torch, np, cs):
    """K3f's ys on the LV seeded init at n = 34 and 140, over K = 17 and
    300 rows of LV-width inputs and on the two cap chains (n = 12), as
    lists, for the largest |difference| between two trees."""
    from kanodes_tpu_torch.models.kdense import KANChain
    from kanodes_tpu_torch.ops import kdense_pallas as kp
    from kanodes_tpu_torch.ops import rk_fused as rk
    out = {f"LV seeded init n={n} K=1": lv_fixed_launch(torch, np, cs, n)()
           for n in (34, 140)}
    spec = kp.chain_spec_of(KANChain.mlp_like([2, 10, 2], grid_len=5))
    k = rk._consts(spec, "tsit5", 0.1)
    for K in (17, 300):
        x0, params = cs.lv_inputs(np.random.default_rng(K), torch, K)
        out[f"n=34 K={K}"] = rk._launch_multistep_fwd(k, 34, x0, params)
    for basis, norm in cs.CAP_CHAINS:
        cap_spec, x0, params = cs.cap_inputs(torch, basis, norm)
        kc = rk._consts(cap_spec, "tsit5", 0.1)
        out[f"cap {basis}/{norm} n=12 K={x0.shape[0]}"] = \
            rk._launch_multistep_fwd(kc, 12, x0, params)
    return {key: ys.cpu().double().numpy().ravel().tolist()
            for key, ys in out.items()}


def members_hashes(torch, np, cs):
    """sha256 of K8f's outputs (ys; rx, rk1, rdt, racc, rsx over the
    recorded iterations; mstats, nit) and of K8b's gradients, on every
    MEMBERS_CASES and MEMBERS_CAP_CASES input and on 8 LV members over K =
    16 rows at the init's weights."""
    import hashlib
    from kanodes_tpu_torch.ode.integrate import StepController
    from kanodes_tpu_torch.ops import rk_adaptive_fused as ra
    cases = [(case, cs.members_case_inputs(torch, case))
             for case in (*cs.MEMBERS_CASES, *cs.MEMBERS_CAP_CASES)]
    case = cs.MEMBERS_CASES[0]
    spec, x0, params, ts = cs.members_case_inputs(torch, case)
    x16 = torch.tensor(np.random.default_rng(16).uniform(0.5, 1.5, (16, 16)),
                       dtype=torch.float32, device="cuda")
    cases.append((case._replace(label="S=8 LV init, K=16 rows", K=16),
                  (spec, x16, params, ts)))
    out = {}
    for i, (case, (spec, x0, params, ts)) in enumerate(cases):
        ctrl = StepController.pi() if case.pi else StepController()
        k = ra._consts(spec, case.solver, case.rtol, case.atol, ctrl,
                       case.dt0)
        ys, rec = ra._launch_members_fwd(k, case.S, case.max_steps, x0, ts,
                                         params)
        n = int(rec[6][0])
        gys = torch.tensor(np.random.default_rng(i).standard_normal(
            tuple(ys.shape)) / ts.shape[0], dtype=torch.float32,
            device="cuda")
        grads = ra._launch_members_bwd(k, case.S, x0, params, rec, gys)
        hf, hb = hashlib.sha256(), hashlib.sha256()
        for t in (ys, *(r[:n] for r in rec[:5]), rec[5], rec[6]):
            hf.update(t.cpu().numpy().tobytes())
        for t in grads:
            hb.update(t.cpu().numpy().tobytes())
        out[case.label] = {"iterations": n, "K8f": hf.hexdigest()[:16],
                           "K8b": hb.hexdigest()[:16]}
    return out


def small_flavor_hashes(torch, np, cs):
    """sha256 of K2f's y and K2b's gradients (LV width, K = 34, tsit5 and
    rk4), K3f's ys and K3b's gradients (n = 34, K = 1; n = 12 on the cap
    chains) and the loss history of 64 LV fused shooting iterations."""
    import hashlib
    from kanodes_tpu_torch.experiments import lv
    from kanodes_tpu_torch.models.kdense import KANChain
    from kanodes_tpu_torch.ops import kdense_pallas as kp
    from kanodes_tpu_torch.ops import rk_fused as rk

    def digest(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()[:16]
    rng = np.random.default_rng(0)
    spec = kp.chain_spec_of(KANChain.mlp_like([2, 10, 2], grid_len=5))
    out = {}
    for solver in ("tsit5", "rk4"):
        x, params = cs.lv_inputs(rng, torch, 34)
        gy = torch.tensor(rng.standard_normal((34, 2)), dtype=torch.float32,
                          device="cuda")
        k = rk._consts(spec, solver, 0.1)
        out[f"K2 {solver} K=34"] = digest(
            rk._launch_step_fwd(k, x, params),
            *rk._launch_step_bwd(k, x, params, gy))
    cases = [("LV", spec, *cs.lv_inputs(rng, torch, 1), 34)]
    for basis, norm in cs.CAP_CHAINS:
        cases.append((f"cap {basis}/{norm}",
                      *cs.cap_inputs(torch, basis, norm), 12))
    for label, spec_i, x0, params, n in cases:
        k = rk._consts(spec_i, "tsit5", 0.1)
        ys = rk._launch_multistep_fwd(k, n, x0, params)
        gys = torch.tensor(rng.standard_normal(tuple(ys.shape)) / n,
                           dtype=torch.float32, device="cuda")
        out[f"K3 {label} n={n}"] = digest(
            ys, *rk._launch_multistep_bwd(k, n, x0, ys, params, gys))
    with torch.enable_grad():
        cfg = lv.LVConfig(impl="fused", solve_mode="shooting", lr=1.5e-2,
                          iters=64, eval_every=32)
        res = lv.run(cfg, device="cuda",
                     generator=torch.Generator().manual_seed(cfg.seed))
    out["LV fused shooting, 64 iterations"] = digest(res["loss_history"])
    return out


def members_bwd_launch(torch, np, cs):
    from kanodes_tpu_torch.ode.integrate import StepController
    from kanodes_tpu_torch.ops import rk_adaptive_fused as ra
    case = cs.MEMBERS_CASES[0]
    spec, x0, params, ts = cs.members_case_inputs(torch, case)
    k = ra._consts(spec, case.solver, case.rtol, case.atol,
                   StepController(), case.dt0)
    ys, rec = ra._launch_members_fwd(k, case.S, case.max_steps, x0, ts,
                                     params)
    gys = torch.tensor(np.random.default_rng(0).standard_normal(
        tuple(ys.shape)) / ts.shape[0], dtype=torch.float32, device="cuda")
    return (lambda: ra._launch_members_bwd(k, case.S, x0, params, rec, gys),
            rec[6].tolist())
'''

KERNELS = r'''
import json, sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from kanodes_tpu_torch.ops import graybox_fused as gb
from kanodes_tpu_torch.ops import kdense_pallas as kp
from kanodes_tpu_torch.ops import rk_fused_wide as tw
from kanodes_tpu_torch.utils.precision import set_exact_f32
''' + LV_ADJOINT_INPUTS + ADAPTIVE_INPUTS + r'''
groups = sys.argv[1].split(",")
set_exact_f32()
out = {}
torch.set_grad_enabled(False)
if "lv" in groups:
    k3b, k4b, stats = lv_adjoint_launches(torch, np, cs)
    out["K3b n=34 K=1"] = {"ms": cs.cuda_ms(torch, k3b, 20),
                           "us": cs.device_us(torch, k3b, reps=10)}
    out["K4b T=35 K=1"] = {"ms": cs.cuda_ms(torch, k4b, 20),
                           "us": cs.device_us(torch, k4b, reps=10),
                           "stats": stats}
    k4f = lv_adaptive_launch(torch, np, cs)
    out["K4f T=35 K=1"] = {"ms": cs.cuda_ms(torch, k4f, 20),
                           "us": cs.device_us(torch, k4f, reps=10)}
    out["K4f sha256"] = k4f_hashes(torch, np, cs)
    for n in (34, 140):
        k3f = lv_fixed_launch(torch, np, cs, n)
        out[f"K3f n={n} K=1"] = {"ms": cs.cuda_ms(torch, k3f, 20),
                                 "us": cs.device_us(torch, k3f, reps=10)}
    out["K3f ys"] = k3f_outputs(torch, np, cs)
if "members" in groups:
    k8f = members_fwd_launch(torch, np, cs)
    out["K8f MEMBERS_CASES[0]"] = {"ms": cs.cuda_ms(torch, k8f, 20),
                                   "us": cs.device_us(torch, k8f, reps=10)}
    out["K8 sha256"] = members_hashes(torch, np, cs)
    k8b, n_it = members_bwd_launch(torch, np, cs)
    out["K8b MEMBERS_CASES[0]"] = {"ms": cs.cuda_ms(torch, k8b, 20),
                                   "us": cs.device_us(torch, k8b, reps=10),
                                   "iterations": n_it}
if "small" in groups:
    out["small flavor sha256"] = small_flavor_hashes(torch, np, cs)
if "gray_wide" in groups:
    for i in (0, 1, 6, 7):
        case = cs.GRAYBOX_CASES[i]
        spec, kron, u, lap, c, w, gy = cs.graybox_case_inputs(torch, gb,
                                                              case)
        st = (spec, case.solver, case.dt, case.D)
        f = lambda: gb._launch_fwd(*st, u, lap, c, w, kron)
        b = lambda: gb._launch_bwd(*st, u, lap, c, w, gy, kron)
        out["K5 " + case.label] = {
            "K5f_ms": cs.cuda_ms(torch, f, 50),
            "K5f_us": cs.device_us(torch, f),
            "K5b_ms": cs.cuda_ms(torch, b, 50),
            "K5b_us": cs.device_us(torch, b)}
    for i, kind in ((6, "K7b"), (9, "K7b"), (5, "K10"), (10, "K10"),
                    (11, "K10"), (12, "K10")):
        case = cs.WIDE_CASES[i]
        ws, pp, x0, gys = cs.wide_case_inputs(torch, tw, kp, case)
        k = tw._consts(ws, case.solver, case.dt)
        ys = tw._launch_multistep_fwd(k, case.n, x0, pp)
        launch = (tw._launch_multistep_bwd if kind == "K7b"
                  else tw._launch_multistep_bwd_lr)
        f = lambda: launch(k, case.n, x0, ys, pp, gys)
        out[kind + " " + case.label] = {
            "ms": cs.cuda_ms(torch, f, 5),
            "us": cs.device_us(torch, f, reps=5)}
print(json.dumps(out))
'''

# group -> profiler runs
PROFILES = {
    "gray_wide": (
        ("profile_source", ("--ndim=2", "--problem=fisher_kpp",
                            "--impl=fused")),
        ("profile_source", ("--ndim=2", "--problem=allen_cahn",
                            "--impl=fused")),
        ("profile_surrogate", ("--problem=schrodinger", "--impl=fused",
                               "--solve_mode=shooting")),
        ("profile_surrogate", ("--problem=allen_cahn_2d", "--impl=fused",
                               "--solve_mode=shooting"))),
    "lv": (
        ("profile_lv", ("--impl=fused", "--solve_mode=fixed")),
        ("profile_lv", ("--impl=fused", "--solve_mode=adaptive"))),
    "members": (("lv_members", ("--profile=1",)),),
    "small": (),
}


def run(root: str, argv: list[str]) -> dict:
    """One subprocess in `root`; its last stdout line as JSON."""
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, *argv], cwd=root, env=env,
                          capture_output=True, text=True, timeout=1200)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: {' '.join(argv)} failed "
                           f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv: list[str]) -> int:
    out_file, groups = None, list(PROFILES)
    roots = []
    for a in argv:
        if a.startswith("--out="):
            out_file = a.split("=", 1)[1]
        elif a.startswith("--groups="):
            groups = a.split("=", 1)[1].split(",")
        else:
            roots.append(os.path.abspath(a))
    if len(roots) != 2 or not set(groups) <= set(PROFILES):
        raise SystemExit(f"usage: compare_trees PARENT CHANGE [--out=FILE] "
                         f"[--groups={','.join(PROFILES)}]")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("compare_trees: needs a CUDA device")
    names = {roots[0]: "parent", roots[1]: "change"}
    lines = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    turns = (roots[0], roots[1], roots[1], roots[0])
    ys = {}
    for root in turns:
        kernels = run(root, ["-c", KERNELS, ",".join(groups)])
        ys.setdefault(names[root], kernels.pop("K3f ys", None))
        emit({"tree": names[root], "kernels": kernels})
    if ys.get("parent") and ys.get("change"):
        emit({"K3f ys, largest |change - parent|": {
            key: max(abs(a - b) for a, b in zip(ys["change"][key], v))
            for key, v in ys["parent"].items()}})
    for root in turns:
        for module, args in (r for g in groups for r in PROFILES[g]):
            emit({"tree": names[root], "profile": module, "args": args,
                  "result": run(root, ["-m",
                                       f"kanodes_tpu_torch.experiments."
                                       f"{module}", *args])})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    emit({"card": card})
    if out_file:
        with open(out_file, "w") as f:
            for obj in lines:
                f.write(json.dumps(obj) + "\n")
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
