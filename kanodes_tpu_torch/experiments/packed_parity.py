"""The float64 rules of the packed seed sweep at its trained points.

A trained ensemble's loss is a small residual, so the f32 rounding of the
forward's trajectory moves the loss's gradient by up to ~1e-4 of its
largest entry. Two f32 forwards whose roundings differ (the kernels and
the plain version, or the plain version with its step sums in another
order) then put their gradients' errors against float64 at anything from
a third to four times each other's: held end to end ("the kernel's
error at most twice plain f32's"), that rule refuses every f32 order at
some trained points. `launch_parity` holds each launch by the same rule
where nothing magnifies its rounding:
  * forward: the objective's predictions from the same parameters and
    starts, the kernels' against the plain version's in f32 and in
    float64 (error at most twice plain f32's + FWD_ATOL);
  * backward: the objective's gradient from the kernel forward's states
    and the loss's cotangents at its predictions, the same f32 inputs
    to the kernels' backward and to the plain backward in f32 and in
    float64 (error at most twice plain f32's + 1e-6 of the largest
    entry).

    python kanodes_tpu_torch/experiments/packed_parity.py [ROOT]
        [--offsets=0,1,2,3,4,5] [--out=FILE]

trains the packed seed sweep (`lv_members.run_packed_phases`, phases cut
to chip_smoke's PACKED_PHASE_ITERS) on the card from each offset's member
inits (member s seeded cfg.seed + 8 o + s; o = 0 is chip_smoke's) with
the kernels of ROOT (a checkout; default this one), and prints one JSON
line an offset: for the shooting (L = 4) and fixed objectives at the
final parameters, the end-to-end ratios of error against float64 to
plain f32's (the kernels; the plain version with the kernels' order of
the step's sums; the kernels' backward on the float64 forward's states)
and `launch_parity`'s ratios. Run as a file, so that ROOT's package is
the one imported. Needs a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

if __name__ == "__main__":
    _root = next((a for a in sys.argv[1:] if not a.startswith("--")), None)
    sys.path.insert(0, os.path.abspath(_root) if _root else
                    os.path.dirname(os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__)))))

import torch

from kanodes_tpu_torch.experiments import lv
from kanodes_tpu_torch.experiments import lv_members as lvm
from kanodes_tpu_torch.interop import chain_params_to_numpy
from kanodes_tpu_torch.models import packed as pk
from kanodes_tpu_torch.ops import rk_fused as rk
from kanodes_tpu_torch.ops.kdense_pallas import chain_spec_of, fused_params

FWD_ATOL = 1e-6
WHAT = ("dx0", "dC1", "dW1", "dC2", "dW2")
N_MEMBERS = 8


def objective(cfg, members, device: str) -> dict:
    """The packed objective of `cfg` (fused shooting or fixed) at `members`
    on `device`, in the pieces the launches take: the step constants, the
    chain's parameters, the rows' starts x0 [K, 2S], the steps, the save
    steps' targets [n_saves, K, 2S] and the rows the loss's mean counts
    besides them (fixed mode: u0's, zero)."""
    built = lvm.build(cfg, N_MEMBERS, device, member_params=members)
    model, data = built["model"], built["data"]
    spec = chain_spec_of(model)
    params = [p.detach().contiguous() for p in fused_params(model)]
    # the packed chain's gradient reaches only its members' blocks
    blocks = pk.block_mask(built["member_model"], N_MEMBERS)
    mask = [torch.as_tensor(blocks[i // 2]["CW"[i % 2]]).reshape(p.shape)
            .to(p) for i, p in enumerate(params)]
    k = rk._consts(spec, "tsit5", cfg.dt / cfg.substeps)
    X, n_train = data["X"], data["n_train"]
    Xtr = X[:n_train]
    if cfg.solve_mode == "shooting":
        L = cfg.segment_len
        x0 = Xtr[:-L].contiguous()
        targets = torch.stack([Xtr[l + 1:l + 1 + x0.shape[0]]
                               for l in range(L)])
        n_saves, extra = L, None
    else:
        x0 = Xtr[:1].contiguous()
        targets = Xtr[1:, None, :]
        n_saves, extra = n_train - 1, Xtr[:1][None]
    return {"k": k, "params": params, "mask": mask, "x0": x0,
            "targets": targets,
            "n_steps": n_saves * cfg.substeps, "substeps": cfg.substeps,
            "shooting": cfg.solve_mode == "shooting", "extra": extra}


def _as(t, impl: str):
    """t as the implementation takes it: the card's f32, the CPU's f32
    or float64 (from the same f32 values)."""
    if impl == "kernel":
        return t
    t = t.detach().cpu()
    return t.double() if impl == "f64" else t


def forward(ob: dict, impl: str, step=None):
    """The states [n_steps + 1, K, 2S] (x0 first) of `impl` ("kernel": the
    launches on the card, K2f-m a step or one K3f-m; "f32", "f64": the
    plain version's steps on the CPU, `step` in place of
    `rk._step_fwd_plain` if given)."""
    k, n = ob["k"], ob["n_steps"]
    params = [_as(p, impl) for p in ob["params"]]
    x0 = _as(ob["x0"], impl)
    if impl == "kernel" and not ob["shooting"]:
        return torch.cat([x0[None],
                          rk._launch_multistep_fwd(k, n, x0, params)])
    grid = rk._grid_of(k, x0)
    step = step or rk._step_fwd_plain
    xs = [x0]
    for _ in range(n):
        xs.append(rk._launch_step_fwd(k, xs[-1], params) if impl == "kernel"
                  else step(k, xs[-1], params, grid))
    return torch.stack(xs)


def predictions(ob: dict, states):
    return states[ob["substeps"]::ob["substeps"]]


def loss_and_cotangents(ob: dict, states):
    """The member losses [S] at the states' predictions and the cotangents
    of their sum for every step's state [n_steps, K, 2S] (zero between
    saves), in the states' dtype and device."""
    P = predictions(ob, states).detach().requires_grad_(True)
    T = ob["targets"].to(P)
    sq = (P - T) ** 2
    if ob["extra"] is not None:
        sq = torch.cat([torch.zeros_like(ob["extra"]).to(P), sq])
    vec = pk.member_mean(N_MEMBERS)(sq.reshape(-1, sq.shape[-1]))
    gP, = torch.autograd.grad(vec.sum(), P)
    g = torch.zeros_like(states[1:])
    g[ob["substeps"] - 1::ob["substeps"]] = gP
    return vec.detach(), g


def backward(ob: dict, impl: str, states, gys):
    """(dx0, dc1, dw1, dc2, dw2) of `impl`'s backward from the given states
    [n_steps + 1, K, 2S] and step cotangents (f32; taken as `impl` takes
    them), the parameters' masked to the members' blocks as the packed
    chain's are."""
    k, n = ob["k"], ob["n_steps"]
    params = [_as(p, impl) for p in ob["params"]]
    states, gys = _as(states, impl), _as(gys, impl)
    grid = rk._grid_of(k, states)
    if not ob["shooting"]:
        if impl == "kernel":
            carry, *grads = rk._launch_multistep_bwd(
                k, n, states[0], states[1:].contiguous(), params,
                gys.contiguous())
        else:
            carry, *grads = rk._multistep_bwd_plain(
                k, n, states[0], states[1:], params, grid, gys)
    else:
        carry, grads = torch.zeros_like(states[0]), None
        for j in range(n - 1, -1, -1):
            g = (carry + gys[j]).contiguous()
            carry, *dps = (rk._launch_step_bwd(k, states[j], params, g)
                           if impl == "kernel" else
                           rk._step_bwd_plain(k, states[j], params, grid, g))
            grads = dps if grads is None else [a + b for a, b in
                                               zip(grads, dps)]
    return (carry, *(g * _as(m, impl) for g, m in zip(grads, ob["mask"])))


def _err(a, ref) -> float:
    return float((a.detach().cpu().double() - ref).abs().max())


def launch_parity(cfg, members) -> tuple[dict, list[str]]:
    """Each launch of the objective `cfg` at `members` by the float64 rule
    (this module's docstring): the numbers and the failures."""
    ob = objective(cfg, members, "cuda")
    out, failures = {}, []
    states = {impl: forward(ob, impl) for impl in ("kernel", "f32", "f64")}
    ref = predictions(ob, states["f64"])
    e_k = _err(predictions(ob, states["kernel"]), ref)
    e_p = _err(predictions(ob, states["f32"]), ref)
    out["forward"] = {"kernel_err_vs_f64": e_k, "plain_f32_err_vs_f64": e_p}
    if e_k > 2 * e_p + FWD_ATOL:
        failures.append(f"forward: error vs float64 {e_k:.3e} > 2 x plain "
                        f"f32's {e_p:.3e} + {FWD_ATOL:g}")
    _, gys = loss_and_cotangents(ob, states["kernel"])
    grads = {impl: backward(ob, impl, states["kernel"], gys)
             for impl in ("kernel", "f32", "f64")}
    out["backward"] = []
    for i, what in enumerate(WHAT):
        ref = grads["f64"][i]
        e_k, e_p = _err(grads["kernel"][i], ref), _err(grads["f32"][i], ref)
        slack = 1e-6 * float(ref.abs().max())
        out["backward"].append({"what": what, "kernel_err_vs_f64": e_k,
                                "plain_f32_err_vs_f64": e_p})
        if e_k > 2 * e_p + slack:
            failures.append(f"backward {what}: error vs float64 {e_k:.3e} "
                            f"> 2 x plain f32's {e_p:.3e} + {slack:.3e}")
    return out, failures


def end_to_end(cfg, members) -> dict:
    """The objective's loss and gradient errors against float64, as ratios
    to the plain f32 version's: the kernels ("kernels"), the plain version
    with each stage's dt b_i k_i fused into the step's sum as the kernels
    add it ("plain, kernels' sum order"), and the kernels' backward on the
    float64 forward's states rounded to f32 ("kernels' backward on the
    float64 forward")."""
    ob = objective(cfg, members, "cuda")
    s64 = forward(ob, "f64")
    l64, g64 = loss_and_cotangents(ob, s64)
    ref = [l64, *backward(ob, "f64", s64, g64)]

    def errs(states, impl):
        vec, g = loss_and_cotangents(ob, states)
        return [_err(a, r) for a, r in
                zip([vec, *backward(ob, impl, states, g)], ref)]

    s32 = forward(ob, "f32")
    base = errs(s32, "f32")
    runs = {"kernels": errs(forward(ob, "kernel"), "kernel"),
            "kernels' backward on the float64 forward":
                errs(s64.float().to(ob["x0"].device), "kernel")}
    runs["plain, kernels' sum order"] = errs(
        forward(ob, "f32", _fused_sum_step), "f32")
    names = ("loss",) + WHAT
    return {"plain_f32_err_vs_f64": dict(zip(names, base)),
            **{run: {w: e / b for w, e, b in zip(names, v, base)}
               for run, v in runs.items()}}


def _fused_sum_step(k, x, params, grid):
    """The plain step with y = fma(dt b_i, k_i, y) in stage order (each
    product exact in float64, one f32 rounding a stage), as the kernels
    form the step's sum."""
    _, ks, _ = rk._stages(k, x, params, grid)
    y = x
    for i in range(k.stages):
        if k.dtb[i] != 0.0:
            y = (y.double() + k.dtb[i] * ks[i].double()).to(x.dtype)
    return y


def member_inits(offset: int):
    """Member s of `offset` seeded cfg.seed + 8 offset + s (None: offset 0,
    run_packed_phases' own inits)."""
    if offset == 0:
        return None
    cfg = lv.LVConfig(impl="fused", basis="iqf")
    model = lv.make_model(cfg, "cpu")
    return [chain_params_to_numpy(lv.init_params(
        cfg, model, torch.Generator().manual_seed(cfg.seed + 8 * offset + s)))
        for s in range(N_MEMBERS)]


def main(argv: list[str]) -> int:
    from kanodes_tpu_torch.utils.precision import set_exact_f32
    offsets, out_file = [0, 1, 2, 3, 4, 5], None
    for a in argv:
        if a.startswith("--offsets="):
            offsets = [int(v) for v in a.split("=", 1)[1].split(",")]
        elif a.startswith("--out="):
            out_file = a.split("=", 1)[1]
    if not torch.cuda.is_available():
        raise SystemExit("packed_parity: needs a CUDA device")
    set_exact_f32()
    iters = (300, 200, 200, 200)             # chip_smoke's PACKED_PHASE_ITERS
    phases = [(m, L, lr, n) for (m, L, lr, _), n in
              zip(lvm.PACKED_PHASES, iters)]
    lines = []
    for o in offsets:
        res = lvm.run_packed_phases(phases, N_MEMBERS, device="cuda",
                                    member_params=member_inits(o))
        final = chain_params_to_numpy(res["model"])
        members = [pk.extract_member(res["member_model"], final, N_MEMBERS,
                                     s) for s in range(N_MEMBERS)]
        line = {"offset": o}
        base = lv.LVConfig(impl="fused", basis="iqf")
        for mode, L in (("shooting", 4), ("fixed", 1)):
            cfg = dataclasses.replace(base, solve_mode=mode, segment_len=L)
            numbers, failures = launch_parity(cfg, members)
            line[f"{mode} L={L}"] = {"end_to_end": end_to_end(cfg, members),
                                     "launches": numbers,
                                     "launch_failures": failures}
        lines.append(line)
        print(json.dumps(line), flush=True)
    if out_file:
        with open(out_file, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
