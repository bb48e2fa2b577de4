"""Time K9's roles other than the ones `_cuda.single_plan` picks, to check
and fit its cost model (`_cuda.k9_cost`).

    python -m kanodes_tpu_torch.experiments.k9_sweep [--top=30]
        [--random=20] [--out=FILE]         (on the card)
    python -m kanodes_tpu_torch.experiments.k9_sweep --score=FILE
                                           (anywhere: no device needed)

On the card: for every `chip_smoke.SINGLE_CASES` shape and each of K9's
three products (K9f, and K9b's dx and parameter halves), the candidate
roles of every block size (`_cuda.k9_candidates`), the `--top` cheapest
by the cost model and `--random` others (seeded); each launched once and
held to the plain version (1e-4, a check of the role's indexing), then
timed as 20 launches in a CUDA graph (the least of 3 replays, µs a
launch). A K9b half is timed with the cheapest other half of the same
register tile. One JSON line a (case, product) to FILE (default
k9_sweep.jsonl) and a summary line on stdout: the fastest
role and the planner's own, where it was among those timed.

--score=FILE: for each (case, product) of FILE, the time of the role the
current cost model ranks first among those timed against the fastest;
prints the ratio of their sums.

    python -m kanodes_tpu_torch.experiments.k9_sweep --plans
        [--out=FILE]                       (on the card)

--plans: the cost model's plan (`_cuda.single_plan`) against `rule_plan`,
a plan with no fitted constant, at every SINGLE_CASES shape: K9f's and
K9b's launches of each plan held to the plain version (1e-4), then timed
as above in the order model, rule, rule, model (the least of each plan's
two readings). One JSON line a case to FILE (default
k9_plans.jsonl) and on stdout, then the sums.
"""

from __future__ import annotations

import copy
import ctypes
import json
import random
import sys
import time


def graph_us(torch, fn, n=20, reps=3) -> float:
    """µs a launch of fn: n launches captured in a CUDA graph, the least
    of `reps` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) * 1e3 / n)
    return best


def _mate(_cuda, role, case, vec, r):
    """The cheapest other K9b half for role r's register tile."""
    other = "db" if role == "dx" else "dx"
    return _cuda._k9_best(other, case.K, case.I, case.O, case.G, vec, 256,
                          (r.MR, r.MO))[1]


def rule_key(_cuda, r) -> tuple:
    """The rule's order of roles: fewest waves of blocks over the SMs,
    then fewest multiply-adds a thread, then the smallest cluster, then
    fewest chunks."""
    return (_cuda._cdiv(r.m_tiles * r.n_tiles * r.SK, _cuda.N_SM),
            _cuda._cdiv(r.KR, r.NK) * r.MR * r.MO, r.SK,
            _cuda._cdiv(r.KR, r.KC))


def rule_plan(K: int, I: int, O: int, G: int, aligned: bool = True):
    """A plan by `rule_key` over the candidates of K9_THREADS-thread blocks
    (`_cuda.k9_candidates`): K9f the first role; K9b, for each register
    tile, the first dx and the first dB role, and of those pairs the one
    of fewest waves of both halves' blocks, then of the larger halves'
    multiply-adds, cluster and chunks."""
    from kanodes_tpu_torch.ops import _cuda
    vec, t = _cuda._k9_vec(O, aligned), _cuda.K9_THREADS

    def first(role, tile=None):
        return min(_cuda.k9_candidates(role, K, I, O, G, vec, t, tile),
                   key=lambda r: rule_key(_cuda, r), default=None)

    fwd = first("fwd")

    def pair_key(p):
        kx, kb = rule_key(_cuda, p[0]), rule_key(_cuda, p[1])
        blocks = sum(r.m_tiles * r.n_tiles * r.SK for r in p)
        return (_cuda._cdiv(blocks, _cuda.N_SM),
                *(max(a, b) for a, b in zip(kx[1:], kb[1:])))

    pairs = ((first("dx", tile), first("db", tile))
             for tile in _cuda.K9_TILES)
    dx, db = min((p for p in pairs if None not in p), key=pair_key)
    cb = max(dx.SK, db.SK)
    fwd, dx, db = (_cuda._k9_blocks(fwd, fwd.SK), _cuda._k9_blocks(dx, cb),
                   _cuda._k9_blocks(db, cb))
    return _cuda.SinglePlan(fwd, fwd.SK, dx, db, cb,
                            4 * _cuda.k9_smem_floats(fwd),
                            4 * max(_cuda.k9_smem_floats(dx),
                                    _cuda.k9_smem_floats(db)))


def plans(out_path: str) -> None:
    import torch

    import chip_smoke as cs
    from kanodes_tpu_torch.ops import _cuda
    from kanodes_tpu_torch.ops import kdense_pallas as kp
    from kanodes_tpu_torch.utils.precision import set_exact_f32

    if not torch.cuda.is_available():
        raise SystemExit("k9_sweep: needs a CUDA device")
    set_exact_f32()
    lib, ptr = _cuda.library(), _cuda.ptr
    sums = {"model": 0.0, "rule": 0.0}
    with open(out_path, "w") as out:
        for case in cs.SINGLE_CASES:
            spec, x, c, w, gy = cs.single_case_inputs(torch, kp, case)
            spec = kp._single_spec(spec)
            K, I, O, G = case.K, case.I, case.O, case.G
            dims = ctypes.byref(_cuda.chain_dims(spec))
            y = torch.empty(K, O, device="cuda")
            dx, dc, dw = (torch.empty_like(t) for t in (x, c, w))
            y_ref = kp.kdense_single_apply_reference(spec, x, c, w)
            g_ref = kp.kdense_single_apply_bwd_reference(spec, x, c, w, gy)
            runs = {}
            for name, p in (("model", _cuda.single_plan(K, I, O, G)),
                            ("rule", rule_plan(K, I, O, G))):
                def fwd(p=p):
                    _cuda.check(lib.kd_single_fwd(
                        ptr(x), ptr(c), ptr(w), ptr(y), K, dims,
                        ctypes.byref(p.fwd), p.fwd_cluster, _cuda.stream()),
                        "fwd")

                def bwd(p=p):
                    _cuda.check(lib.kd_single_bwd(
                        ptr(x), ptr(gy), ptr(c), ptr(w), ptr(dx), ptr(dc),
                        ptr(dw), K, dims, ctypes.byref(p.dx),
                        ctypes.byref(p.db), p.bwd_cluster, _cuda.stream()),
                        "bwd")
                fwd()
                bwd()
                torch.cuda.synchronize()
                ok = all(bool(((a - b).abs() <= 1e-4 + 1e-4 * b.abs()).all())
                         for a, b in zip((y, dx, dc, dw), (y_ref, *g_ref)))
                runs[name] = {"fwd": fwd, "bwd": bwd, "ok": ok, "us": {},
                              "plan": [p.fwd.astuple(), p.dx.astuple(),
                                       p.db.astuple()]}
            for name in ("model", "rule", "rule", "model"):
                for k in ("fwd", "bwd"):
                    us = graph_us(torch, runs[name][k])
                    runs[name]["us"][k] = min(us, runs[name]["us"].get(
                        k, float("inf")))
            line = {"case": case.label}
            for name, r in runs.items():
                line[name] = {"us": r["us"], "ok": r["ok"],
                              "plan": r["plan"]}
                sums[name] += sum(r["us"].values())
            print(json.dumps(line), flush=True)
            out.write(json.dumps(line) + "\n")
    print(json.dumps({"sum_us": sums,
                      "rule_over_model": sums["rule"] / sums["model"],
                      "card": cs.card_line()}), flush=True)


def sweep(top: int, n_random: int, out_path: str) -> None:
    import torch

    import chip_smoke as cs
    from kanodes_tpu_torch.ops import _cuda
    from kanodes_tpu_torch.ops import kdense_pallas as kp
    from kanodes_tpu_torch.utils.precision import set_exact_f32

    if not torch.cuda.is_available():
        raise SystemExit("k9_sweep: needs a CUDA device")
    set_exact_f32()
    lib = _cuda.library()
    ptr = _cuda.ptr
    with open(out_path, "w") as out:
        for case in cs.SINGLE_CASES:
            spec, x, c, w, gy = cs.single_case_inputs(torch, kp, case)
            spec = kp._single_spec(spec)
            K, I, O, G = case.K, case.I, case.O, case.G
            dims = ctypes.byref(_cuda.chain_dims(spec))
            y = torch.empty(K, O, device="cuda")
            dx, dc, dw = (torch.empty_like(t) for t in (x, c, w))
            y_ref = kp.kdense_single_apply_reference(spec, x, c, w)
            g_ref = kp.kdense_single_apply_bwd_reference(spec, x, c, w, gy)
            plan = _cuda.single_plan(K, I, O, G)
            vec = _cuda._k9_vec(O, True)

            def launch(role, r, mate):
                if role == "fwd":
                    def run():
                        _cuda.check(lib.kd_single_fwd(
                            ptr(x), ptr(c), ptr(w), ptr(y), K, dims,
                            ctypes.byref(r), r.SK, _cuda.stream()), "fwd")
                    return run
                rx, rb = (r, mate) if role == "dx" else (mate, r)
                cl = max(rx.SK, rb.SK)
                rx = _cuda._k9_blocks(copy.copy(rx), cl)
                rb = _cuda._k9_blocks(copy.copy(rb), cl)

                def run():
                    _cuda.check(lib.kd_single_bwd(
                        ptr(x), ptr(gy), ptr(c), ptr(w), ptr(dx), ptr(dc),
                        ptr(dw), K, dims, ctypes.byref(rx), ctypes.byref(rb),
                        cl, _cuda.stream()), "bwd")
                return run

            def close(a, b):
                return bool(((a - b).abs() <= 1e-4 + 1e-4 * b.abs()).all())

            for role in ("fwd", "dx", "db"):
                cands = {}
                for t in _cuda.K9_BLOCK_SIZES:
                    for r in _cuda.k9_candidates(role, K, I, O, G, vec, t):
                        cands.setdefault(r.astuple(), r)
                ranked = sorted(cands.values(), key=lambda r: _cuda.k9_cost(
                    role, r, G, _cuda.k9_threads(r)))
                rest = ranked[top:]
                random.Random(0).shuffle(rest)
                chosen = {"fwd": plan.fwd, "dx": plan.dx,
                          "db": plan.db}[role].astuple()[:14]
                rows, t0 = [], time.time()
                for r in ranked[:top] + rest[:n_random]:
                    r = _cuda._k9_blocks(copy.copy(r), r.SK)
                    mate = None if role == "fwd" else _mate(_cuda, role,
                                                            case, vec, r)
                    if role != "fwd" and mate is None:
                        continue
                    run = launch(role, r, mate)
                    run()
                    torch.cuda.synchronize()
                    ok = (close(y, y_ref) if role == "fwd" else
                          close(dx, g_ref[0]) if role == "dx" else
                          close(dc, g_ref[1]) and close(dw, g_ref[2]))
                    rows.append({"role": r.astuple(),
                                 "threads": _cuda.k9_threads(r),
                                 "us": graph_us(torch, run), "ok": ok,
                                 "chosen": r.astuple()[:14] == chosen})
                best = min(rows, key=lambda q: q["us"])
                mine = [q["us"] for q in rows if q["chosen"]]
                line = {"case": case.label, "product": role,
                        "timed": len(rows), "of": len(cands),
                        "best_us": best["us"], "best": best["role"],
                        "chosen_us": mine[0] if mine else None,
                        "wrong": sum(not q["ok"] for q in rows),
                        "seconds": time.time() - t0}
                print(json.dumps(line), flush=True)
                out.write(json.dumps({**line, "rows": rows}) + "\n")
    print(json.dumps({"card": cs.card_line()}), flush=True)


def score(path: str) -> float:
    """Sum over (case, product) of the time of the role the cost model
    ranks first among those timed, over the sum of the fastest."""
    import chip_smoke as cs
    from kanodes_tpu_torch.ops import _cuda
    cases = {c.label: c for c in cs.SINGLE_CASES}
    picked = fastest = 0.0
    for line in open(path):
        d = json.loads(line)
        G = cases[d["case"]].G
        rows = [(_cuda.K9Role(*q["role"]), q["us"]) for q in d["rows"]]
        fastest += min(us for _, us in rows)
        picked += min(rows, key=lambda q: _cuda.k9_cost(
            d["product"], q[0], G, _cuda.k9_threads(q[0])))[1]
    return picked / fastest


def main(argv: list[str]) -> int:
    opts = dict((a[2:].split("=", 1) + [""])[:2] for a in argv
                if a.startswith("--"))
    sys.path.insert(0, ".")
    if "plans" in opts:
        plans(opts.get("out", "k9_plans.jsonl"))
        return 0
    if "score" in opts:
        print(json.dumps({"picked_over_fastest": score(opts["score"])}))
        return 0
    sweep(int(opts.get("top", 30)), int(opts.get("random", 20)),
          opts.get("out", "k9_sweep.jsonl"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
