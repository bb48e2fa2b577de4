"""A packed ensemble of LV KAN-ODEs trained adaptively, one step controller
per member (the port's counterpart of `scripts/lv_adaptive_members_fused.py`).

S members of the reference LV model ([2,10,2], grid 5, rbf, tanh,
swish) are packed block-diagonally into one [2S, 10S, 2S] chain
(`models/packed.py`) and trained on the tiled LV data at the script's
settings: adaptive Tsit5, rtol 1e-3, atol 1e-6, max_steps 64. With
impl="fused" every iteration is one K8 forward launch and one K8
backward launch (`ops/rk_adaptive_fused.fused_adaptive_members_odeint`),
every eval one more forward; impl="xla" runs `ode/integrate.
odeint_members` on the chain. The gradient is that of the member sum and
best-tracking is joint (`train/loop.py`).

Run:  python -m kanodes_tpu_torch.experiments.lv_members
      [--n_members=8] [--device=cuda|cpu] [--profile=1]
      [--phases=1] [--key=value ...]
      (LVConfig fields; default cuda, which raises without a card)

It prints the per-member final losses and losses at the joint best,
iterations per second and member-iterations per second; `--profile=1`
measures instead, as
`experiments/profile_lv.py` does (`profile_lv.measure`, on the card).

`run_packed_phases` is the port's counterpart of
`scripts/lv_multiseed_packed.py`: 8 seeds of the iqf LV model packed as
one [16, 80, 16] chain, trained through fused shooting (segment_len 1,
then 4: K2 over 34 and 31 rows) and fused fixed mode (K3, n = 34, K = 1),
the script's four phases in turn (`--phases=1`). At this width K2/K3
run their medium flavor, a block a row.

`run_stacked_phases` is the port's counterpart of
`scripts/lv_multiseed_vmapped.py`: the same 8 seeds and four phases, the
members not packed but stacked ([S, ...] parameters, `train.loop.
Stacked`) and the member loss under `torch.func.vmap`
(`lv.make_stacked_fns`): each K2/K3 call is ONE member-axis launch for
all S members (the small flavor, a warp a row, gridDim.y = S), and each
member's trajectory is that of its own sequential run
(`run_sequential_phases`, the unbatched launches) bit for bit in the
kernels. CLI: `--stacked=1` (with `--seeds=8`, `--phase_iters=a,b,c,d`
to cut the phases, `--sequential=1` to time the 8 sequential runs too,
`--profile=1` to profile its iterations instead).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any

import torch

from kanodes_tpu_torch.experiments import lv
from kanodes_tpu_torch.interop import (chain_params_to_numpy,
                                       packed_params_from_numpy)
from kanodes_tpu_torch.models.packed import (apply_mask, block_mask,
                                             extract_member, member_mean,
                                             pack_chain, tile_state)
from kanodes_tpu_torch.train.loop import TrainConfig, init_stacked, train
from kanodes_tpu_torch.utils.device import require_device
from kanodes_tpu_torch.utils.precision import set_exact_f32

# the settings of scripts/lv_adaptive_members_fused.py:68-69
DEFAULT_CFG = lv.LVConfig(solve_mode="adaptive", impl="fused", max_steps=64,
                          rtol=1e-3, atol=1e-6)


def build(cfg: lv.LVConfig, n_members: int, device="cuda",
          generator: torch.Generator | None = None,
          member_params: list | None = None) -> dict[str, Any]:
    """The masked packed chain, its member chain, the tiled data and the
    (loss_fn, eval_fn, predict) of `lv.make_ode_fns` on `device`.

    `member_params`: S per-layer `{"C", "W"}` numpy lists (S JAX inits,
    say) to start from. Default: member s is `lv.init_params` of its own
    chain with `generator` (all members draw from it in turn) or, without
    one, with a CPU generator seeded `cfg.seed + s`."""
    set_exact_f32()
    dev = require_device(device)
    data = lv.make_data(cfg, dev)
    model = lv.make_model(cfg, dev)
    if member_params is None:
        member_params = []
        for s in range(n_members):
            gen = generator if generator is not None else \
                torch.Generator().manual_seed(cfg.seed + s)
            member_params.append(chain_params_to_numpy(
                lv.init_params(cfg, model, gen)))
    if len(member_params) != n_members:
        raise ValueError(f"{len(member_params)} member param lists for "
                         f"n_members={n_members}")
    packed = pack_chain(model, n_members)
    packed_params_from_numpy(packed, model, member_params)
    apply_mask(block_mask(model, n_members), packed)
    pdata = dict(data, X=tile_state(data["X"], n_members))
    fns = lv.make_ode_fns(cfg, packed, pdata,
                          reduce_fn=member_mean(n_members),
                          n_members=n_members)
    return {"model": packed, "member_model": model, "data": pdata,
            "fns": fns}


def run_members(cfg: lv.LVConfig | None = None, n_members: int = 8, *,
                device="cuda", generator: torch.Generator | None = None,
                member_params: list | None = None) -> dict[str, Any]:
    """Train the packed ensemble on `device` (see `build`). Returns the
    `train()` dict (vector losses [iters, S]; "best_loss" [S], every
    member's loss at the joint best that "best_params" holds) with cfg,
    the packed model, data and predict, and per member: its final loss
    ("member_final_loss", [S]) and its trained params in the member
    chain's shapes ("members", S per-layer `{"C", "W"}` numpy lists, as
    `packed.extract_member` gives them)."""
    cfg = cfg or DEFAULT_CFG
    built = build(cfg, n_members, device, generator, member_params)
    packed = built["model"]
    loss_fn, eval_fn, predict = built["fns"]
    # the TrainConfig default chunk, as the JAX ensemble script passes it
    tc = TrainConfig(lr=cfg.lr, iters=cfg.iters, eval_every=cfg.eval_every)
    out = train(loss_fn, packed, tc, eval_fn=eval_fn, stacked=False,
                record_history=cfg.record_history)
    losses = out["loss_history"]
    final = chain_params_to_numpy(packed)
    out.update(cfg=cfg, model=packed, data=built["data"], predict=predict,
               n_members=n_members, member_final_loss=losses[-1],
               members=[extract_member(built["member_model"], final,
                                       n_members, s)
                        for s in range(n_members)])
    return out


# scripts/lv_multiseed_packed.py:44-47: (solve_mode, segment_len, lr, iters)
PACKED_PHASES = (("shooting", 1, 3e-3, 10_000), ("shooting", 4, 1e-3, 6_000),
                 ("fixed", 0, 3e-4, 7_000), ("fixed", 0, 1e-4, 7_000))


def run_packed_phases(phases=PACKED_PHASES, n_members: int = 8, *,
                      basis: str = "iqf", device="cuda",
                      member_params: list | None = None) -> dict[str, Any]:
    """The packed seed sweep of scripts/lv_multiseed_packed.py: members
    seeded 0..S-1 (`lv.init_params`, or `member_params`) of the LV model
    with `basis`, packed and masked, trained phase by phase (`phases`:
    (solve_mode, segment_len, lr, iters)) through impl="fused" with the
    per-member mean loss. A phase with the previous one's mode and
    segment length resumes its Adam state at the new learning rate, as
    the script does; each phase's one eval comes at its end. Returns per
    phase its seconds (host clock to the phase's last loss on the host)
    and first, last and joint-best per-member losses, the per-member best
    trajectory loss over the fixed phases' iterations
    ("best_traj_train_mse"), the packed model and the member chain."""
    base = lv.LVConfig(impl="fused", basis=basis)
    built = build(base, n_members, device, member_params=member_params)
    packed, data = built["model"], built["data"]
    fns, out, prev, opt_state = {}, [], None, None
    best_traj = None
    for mode, L, lr, iters in phases:
        key = (mode, L)
        if key not in fns:
            cfg = dataclasses.replace(base, solve_mode=mode,
                                      segment_len=max(L, 1))
            fns[key] = lv.make_ode_fns(cfg, packed, data,
                                       reduce_fn=member_mean(n_members),
                                       n_members=n_members)
        if key == prev:
            for group in opt_state["param_groups"]:
                group["lr"] = lr
        else:
            opt_state = None
        loss_fn, eval_fn, _ = fns[key]
        t0 = time.perf_counter()
        res = train(loss_fn, packed, TrainConfig(lr=lr, iters=iters,
                                                 eval_every=iters),
                    eval_fn=eval_fn, stacked=False, opt_state=opt_state)
        losses = res["loss_history"].cpu()        # waits for the device
        seconds = time.perf_counter() - t0
        opt_state, prev = res["opt_state"], key
        if mode == "fixed":
            best = losses.min(dim=0).values
            best_traj = best if best_traj is None else torch.minimum(
                best_traj, best)
        out.append({"solve_mode": mode, "segment_len": L, "lr": lr,
                    "iters": iters, "seconds": seconds,
                    "first_loss": losses[0].tolist(),
                    "last_loss": losses[-1].tolist(),
                    "best_loss": res["best_loss"].tolist(),
                    "eval": res["eval_history"][-1].tolist()})
    return {"phases": out, "model": packed,
            "member_model": built["member_model"], "data": data,
            "best_traj_train_mse": (None if best_traj is None
                                    else best_traj.tolist())}


# scripts/lv_multiseed_vmapped.py:51-52: the same recipe, stacked
STACKED_PHASES = PACKED_PHASES


def _seed_generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed))


def run_stacked_phases(phases=STACKED_PHASES, seeds=tuple(range(8)), *,
                       basis: str = "iqf", device="cuda") -> dict[str, Any]:
    """The stacked seed sweep of scripts/lv_multiseed_vmapped.py: the LV
    model with `basis` at seeds `seeds` (member s: `lv.init_params` with a
    CPU generator seeded seeds[s]) stacked, trained
    phase by phase (`phases`: (solve_mode, segment_len, lr, iters))
    through impl="fused" with the member loss under vmap
    (`lv.make_stacked_fns`: one member-axis K2 launch a substep each way,
    one K3 launch each way a fixed iteration). A phase with the previous
    one's mode and segment length resumes its Adam state at the new
    learning rate, as the script does; no eval runs during training, as
    there. Returns per phase its seconds (host clock to the phase's loss
    history on the host), first, last and per-member best losses; the
    per-member loss history of every iteration ("loss_history" [iters,
    S], on the host); per member the best trajectory loss over the fixed
    phases ("best_traj_train_mse"), and the final trajectory train and
    full-horizon test losses ("runs"); the stacked model, member chain
    and data."""
    base = lv.LVConfig(impl="fused", basis=basis)
    set_exact_f32()
    dev = require_device(device)
    data = lv.make_data(base, dev)
    model = lv.make_model(base, dev)
    stacked = init_stacked(
        model, lambda m, seed: lv.init_params(base, m, _seed_generator(seed)),
        seeds)
    fns, out, hist, prev, opt_state = {}, [], [], None, None
    best_traj = None
    for mode, L, lr, iters in phases:
        key = (mode, L)
        if key not in fns:
            fns[key] = lv.make_stacked_fns(
                dataclasses.replace(base, solve_mode=mode,
                                    segment_len=max(L, 1)), model, data)
        if key == prev:
            for group in opt_state["param_groups"]:
                group["lr"] = lr
        else:
            opt_state = None
        t0 = time.perf_counter()
        res = train(fns[key][0], stacked,
                    TrainConfig(lr=lr, iters=iters, eval_every=iters),
                    stacked=True, opt_state=opt_state)
        losses = res["loss_history"].cpu()        # waits for the device
        seconds = time.perf_counter() - t0
        opt_state, prev = res["opt_state"], key
        hist.append(losses)
        if mode == "fixed":
            best = res["best_loss"].cpu()
            best_traj = best if best_traj is None else torch.minimum(
                best_traj, best)
        out.append({"solve_mode": mode, "segment_len": L, "lr": lr,
                    "iters": iters, "seconds": seconds,
                    "first_loss": losses[0].tolist(),
                    "last_loss": losses[-1].tolist(),
                    "best_loss": res["best_loss"].tolist()})
    fixed = dataclasses.replace(base, solve_mode="fixed")
    tl, te, _ = lv.make_stacked_fns(fixed, model, data)
    with torch.no_grad():
        train_mse, test_mse = tl(stacked).tolist(), te(stacked).tolist()
    runs = [{"seed": int(seed),
             "best_traj_train_mse": (None if best_traj is None
                                     else float(best_traj[i])),
             "final_traj_train_mse": train_mse[i],
             "test_full_horizon_mse": test_mse[i]}
            for i, seed in enumerate(seeds)]
    return {"phases": out, "loss_history": torch.cat(hist),
            "runs": runs, "stacked": stacked, "member_model": model,
            "data": data,
            "best_traj_train_mse": (None if best_traj is None
                                    else best_traj.tolist())}


def run_sequential_phases(phases=STACKED_PHASES, seeds=tuple(range(8)), *,
                          basis: str = "iqf", device="cuda"
                          ) -> dict[str, Any]:
    """`run_stacked_phases`' recipe run seed by seed through the unbatched
    launches (scripts/lv_seed_robustness.py's sequential sweep): the same
    inits, phases and Adam carry. Returns "loss_history" [iters, S] on the
    host and "seconds" (all seeds, host clock)."""
    base = lv.LVConfig(impl="fused", basis=basis)
    set_exact_f32()
    dev = require_device(device)
    data = lv.make_data(base, dev)
    model = lv.make_model(base, dev)
    fns, hists = {}, []
    t0 = time.perf_counter()
    for seed in seeds:
        lv.init_params(base, model, _seed_generator(seed))
        hist, prev, opt_state = [], None, None
        for mode, L, lr, iters in phases:
            key = (mode, L)
            if key not in fns:
                fns[key] = lv.make_ode_fns(
                    dataclasses.replace(base, solve_mode=mode,
                                        segment_len=max(L, 1)), model, data)
            if key == prev:
                for group in opt_state["param_groups"]:
                    group["lr"] = lr
            else:
                opt_state = None
            res = train(fns[key][0], model,
                        TrainConfig(lr=lr, iters=iters, eval_every=iters),
                        opt_state=opt_state)
            opt_state, prev = res["opt_state"], key
            hist.append(res["loss_history"])
        hists.append(torch.cat(hist).cpu())        # waits for the device
    return {"loss_history": torch.stack(hists, dim=1),
            "seconds": time.perf_counter() - t0}


def profile(cfg: lv.LVConfig, n_members: int, iters: int = 20,
            warmup: int = 5) -> dict:
    """`profile_lv.measure` of the packed ensemble's iterations (the
    member sum's backward), on the card."""
    from kanodes_tpu_torch.experiments.profile_lv import measure
    built = build(cfg, n_members, "cuda")
    loss_fn, eval_fn, _ = built["fns"]
    rec = measure(f"{n_members} packed members {cfg.impl}/{cfg.solve_mode}",
                  built["model"], lambda m: loss_fn(m).sum(), eval_fn,
                  cfg.lr, iters, warmup, 8)
    rec["member_it_per_s"] = n_members * 1e3 / rec["wall_ms_per_iter"]
    return rec


def main(argv: list[str]) -> int:
    from kanodes_tpu_torch.train.config import override_from_args

    opts = {"n_members": 8, "profile": 0, "warmup": 5, "phases": 0,
            "stacked": 0, "seeds": 8, "sequential": 0}
    device, rest, phase_iters = "cuda", [], None
    for a in argv:
        key, _, value = a.lstrip("-").partition("=")
        if key == "device":
            device = value
        elif key == "phase_iters":
            phase_iters = [int(v) for v in value.split(",")]
        elif key in opts and value:
            opts[key] = int(value)
        elif key == "stacked" and not value:
            opts[key] = 1
        else:
            rest.append(a)
    if opts["stacked"]:
        return _main_stacked(opts, phase_iters, device)
    cfg = override_from_args(dataclasses.replace(DEFAULT_CFG, iters=2000),
                             rest)
    S = opts["n_members"]
    if opts["phases"]:
        res = run_packed_phases(PACKED_PHASES, S, device=device)
        for ph in res["phases"]:
            print(json.dumps(ph), flush=True)
        best = res["best_traj_train_mse"]
        print(json.dumps({"best_traj_train_mse": best,
                          "below_8.3e-7": sum(b < 8.3e-7 for b in best),
                          "seconds": sum(p["seconds"]
                                         for p in res["phases"])}))
        return 0
    if opts["profile"]:
        require_device(device)
        print(json.dumps(profile(cfg, S, min(cfg.iters, 20),
                                 opts["warmup"])), flush=True)
        return 0
    t0 = time.perf_counter()
    out = run_members(cfg, S, device=device)
    final = out["member_final_loss"].tolist()      # waits for the device
    seconds = time.perf_counter() - t0
    best = out["best_loss"].tolist()
    for s in range(S):
        print(f"member {s}: final loss {final[s]:.3e}  at the joint best "
              f"{best[s]:.3e}")
    print(f"{S} members, {cfg.iters} iters in {seconds:.1f}s: "
          f"{cfg.iters / seconds:.1f} it/s, "
          f"{S * cfg.iters / seconds:.1f} member-it/s on {device} "
          f"({cfg.impl}/{cfg.solve_mode})")
    return 0


def profile_stacked(seeds=tuple(range(8)), iters: int = 20,
                    warmup: int = 5) -> list[dict]:
    """`profile_lv.measure` of the stacked run's iterations (the member
    sum's backward) in each of its objectives (shooting L = 1 and 4,
    fixed), on the card, at the seeded inits."""
    from kanodes_tpu_torch.experiments.profile_lv import measure
    base = lv.LVConfig(impl="fused", basis="iqf")
    set_exact_f32()
    data = lv.make_data(base, "cuda")
    model = lv.make_model(base, "cuda")
    out = []
    for mode, L, lr, _ in STACKED_PHASES[:3]:
        stacked = init_stacked(model, lambda m, seed: lv.init_params(
            base, m, _seed_generator(seed)), seeds)
        cfg = dataclasses.replace(base, solve_mode=mode,
                                  segment_len=max(L, 1))
        loss_fn, eval_fn, _ = lv.make_stacked_fns(cfg, model, data)
        rec = measure(f"{len(seeds)} stacked seeds fused/{mode} L={L}",
                      stacked, lambda m: loss_fn(m).sum(), eval_fn, lr,
                      iters, warmup, 8)
        rec["member_it_per_s"] = len(seeds) * 1e3 / rec["wall_ms_per_iter"]
        out.append(rec)
    return out


def _main_stacked(opts: dict, phase_iters, device: str) -> int:
    """`--stacked`: run_stacked_phases (and, with --sequential=1, the same
    recipe seed by seed), one JSON line a phase, then the summary;
    `--profile=1` profiles its iterations instead."""
    if opts["profile"]:
        require_device(device)
        for rec in profile_stacked(tuple(range(opts["seeds"])),
                                   warmup=opts["warmup"]):
            print(json.dumps(rec), flush=True)
        return 0
    phases = STACKED_PHASES
    if phase_iters is not None:
        if len(phase_iters) != len(phases):
            raise SystemExit(f"--phase_iters needs {len(phases)} counts")
        phases = tuple((m, L, lr, n) for (m, L, lr, _), n
                       in zip(phases, phase_iters))
    seeds = tuple(range(opts["seeds"]))
    res = run_stacked_phases(phases, seeds, device=device)
    for ph in res["phases"]:
        print(json.dumps(ph), flush=True)
    for r in res["runs"]:
        print(json.dumps(r), flush=True)
    seconds = sum(p["seconds"] for p in res["phases"])
    iters = sum(p[3] for p in phases)
    summary = {"n_seeds": len(seeds), "iters_per_seed": iters,
               "seconds": seconds,
               "member_it_per_s": len(seeds) * iters / seconds,
               "best_traj_train_mse": res["best_traj_train_mse"],
               "below_8.3e-7": sum(b < 8.3e-7
                                   for b in res["best_traj_train_mse"])}
    if opts["sequential"]:
        seq = run_sequential_phases(phases, seeds, device=device)
        diff = (res["loss_history"] - seq["loss_history"]).abs() / \
            seq["loss_history"].abs()
        summary.update(sequential_seconds=seq["seconds"],
                       max_rel_diff_vs_sequential=float(diff.max()))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    import sys

    raise SystemExit(main(sys.argv[1:]))
