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
      [--n_members=8] [--device=cuda|cpu] [--profile=1] [--key=value ...]
      (LVConfig fields; default cuda, which raises without a card)

It prints the per-member final losses and losses at the joint best,
iterations per second and member-iterations per second; `--profile=1`
measures instead, as
`experiments/profile_lv.py` does (`profile_lv.measure`, on the card).
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
from kanodes_tpu_torch.train.loop import TrainConfig, train
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

    opts = {"n_members": 8, "profile": 0, "warmup": 5}
    device, rest = "cuda", []
    for a in argv:
        key, _, value = a.lstrip("-").partition("=")
        if key == "device":
            device = value
        elif key in opts and value:
            opts[key] = int(value)
        else:
            rest.append(a)
    cfg = override_from_args(dataclasses.replace(DEFAULT_CFG, iters=2000),
                             rest)
    S = opts["n_members"]
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


if __name__ == "__main__":
    import sys

    raise SystemExit(main(sys.argv[1:]))
