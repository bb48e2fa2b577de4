"""Where K5b and K7b spend a launch, phase by phase, on the card.

    python -m kanodes_tpu_torch.experiments.trace_phases ROOT [ROOT ...]

For each ROOT (a checkout of this repository), copies its
`kanodes_tpu_torch/` into a temporary directory, inserts `clock64()`
stamps into the copy of `csrc/graybox.cu` (K5b) and `csrc/rk_fused_wide.cu`
(K7b) at fixed places of the kernels' code, builds that copy and runs,
with chip_smoke.py's inputs, K5b at Fisher-KPP 1-D [1, 26], Allen-Cahn
1-D [1, 41] and the two [32, 32] fields, and K7b at the shooting groups
(Schrödinger K = 7, 2-D Allen-Cahn K = 4, n = 40). Thread 0 of block 0
adds the cycles between stamps into its phase's counter (so a phase
inside a loop is thread 0's share of it, and a barrier's phase is its
wait); one JSON line per kernel and case gives the cycles of each phase
(SM clocks, one launch) and their total, then the card's name, power
limit and top SM clock. The stamps cost a few percent of a launch.

Two designs are known, by the code the stamps go into: the one-block
K5b / K7b of the first port, and the four-lane K5b and cluster K7b that
replaced them. A checkout whose kernels match neither raises. The
instrumented copy is thrown away; nothing of ROOT changes. Needs nvcc and
a CUDA device.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

GB_HEAD = """#include "kan_chain.cuh"

__device__ unsigned long long g_trace[16];
__shared__ unsigned long long s_tr[16];
#define TR_MARK() long long _tm = clock64()
#define TR_ADD(i) do { long long _n = clock64(); \\
  if (threadIdx.x == 0 && blockIdx.x == 0) s_tr[i] += _n - _tm; \\
  _tm = _n; } while (0)
"""
WD_HEAD = GB_HEAD.replace("g_trace", "g_wtrace").replace("s_tr", "s_wtr")
GB_READ = """extern "C" {

void gb_trace_read(unsigned long long* out) {
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));
}
"""
WD_READ = GB_READ.replace("gb_trace_read", "wd_trace_read").replace(
    "g_trace", "g_wtrace")
GB_WRITE = ("  if (threadIdx.x == 0 && blockIdx.x == 0)\n"
            "    for (int i = 0; i < 16; ++i) g_trace[i] = s_tr[i];\n")
WD_WRITE = GB_WRITE.replace("g_trace", "g_wtrace").replace("s_tr", "s_wtr")

# design -> (file -> [(code, code with stamps)], K5b phases, K7b phases)
DESIGNS = {
    "one-block K5b and K7b": ({
        "graybox.cu": [
            ('#include "kan_chain.cuh"\n', GB_HEAD),
            ("  float* s_dp = s_cw + G + 1;               // dC[0..G-1], dW\n",
             "  float* s_dp = s_cw + G + 1;               // dC[0..G-1], dW\n"
             "  if (threadIdx.x < 16) s_tr[threadIdx.x] = 0;\n"
             "  TR_MARK();\n"),
            ("  if (threadIdx.x == 0) s_cw[G] = w[0];\n  __syncthreads();\n\n"
             "  // rebuild",
             "  if (threadIdx.x == 0) s_cw[G] = w[0];\n  __syncthreads();\n"
             "  TR_ADD(0);\n\n  // rebuild"),
            ("      us[p] = gb_stage_input(u[p], s_kb, s, p, T);\n"
             "    __syncthreads();\n",
             "      us[p] = gb_stage_input(u[p], s_kb, s, p, T);\n"
             "    __syncthreads();\n    TR_ADD(1);\n"),
            ("    for (int p = threadIdx.x; p < nodes; p += blockDim.x)\n"
             "      ks[p] = gb_known(us, s_lap, p, T) + "
             "gb_phi(us[p], s_cw, T);\n"
             "    __syncthreads();\n",
             "    for (int p = threadIdx.x; p < nodes; p += blockDim.x) {\n"
             "      const float kn_ = gb_known(us, s_lap, p, T);\n"
             "      TR_ADD(2);\n"
             "      ks[p] = kn_ + gb_phi(us[p], s_cw, T);\n"
             "      TR_ADD(3);\n    }\n"
             "    __syncthreads();\n    TR_ADD(4);\n"),
            ("  __syncthreads();\n\n  const int warp = threadIdx.x / 32, "
             "lane = threadIdx.x % 32;\n",
             "  __syncthreads();\n  TR_ADD(5);\n\n  const int warp = "
             "threadIdx.x / 32, lane = threadIdx.x % 32;\n"),
            ("      const float dui = gb_known(kb, s_lap, p, T)\n"
             "                        + gb_phi_du(us[p], kb[p], s_cw, T);\n",
             "      const float kn_ = gb_known(kb, s_lap, p, T);\n"
             "      TR_ADD(6);\n"
             "      const float dui = kn_ + "
             "gb_phi_du(us[p], kb[p], s_cw, T);\n"
             "      TR_ADD(7);\n"),
            ("    // dC[g] += sum_p kbar_i B_g(us_i)",
             "    TR_ADD(8);\n    // dC[g] += sum_p kbar_i B_g(us_i)"),
            ("      if (lane == 0) s_dp[q] = s_dp[q] + acc;\n    }\n"
             "    __syncthreads();\n  }\n",
             "      if (lane == 0) s_dp[q] = s_dp[q] + acc;\n    }\n"
             "    TR_ADD(9);\n    __syncthreads();\n    TR_ADD(10);\n  }\n"),
            ("  if (threadIdx.x == 0) dw[0] = s_dp[G];\n}\n",
             "  if (threadIdx.x == 0) dw[0] = s_dp[G];\n  TR_ADD(11);\n"
             + GB_WRITE + "}\n"),
            ('extern "C" {\n', GB_READ),
        ],
        "rk_fused_wide.cu": [
            ('#include "kan_chain.cuh"\n', WD_HEAD),
            ("  for (int x = threadIdx.x; x < I; x += blockDim.x) "
             "s_xbar[x] = 0.0f;\n",
             "  if (threadIdx.x < 16) s_wtr[threadIdx.x] = 0;\n  TR_MARK();\n"
             "  for (int x = threadIdx.x; x < I; x += blockDim.x) "
             "s_xbar[x] = 0.0f;\n"),
            ("    wd_rebuild(x_in, s_xs, s_kb, s_y1, p, T, s_part, s_b2);\n",
             "    TR_ADD(0);\n"
             "    wd_rebuild(x_in, s_xs, s_kb, s_y1, p, T, s_part, s_b2);\n"
             "    TR_ADD(1);\n"),
            ("    const size_t r0 = ((size_t)s * K + row) * T.n_slots;\n",
             "    TR_ADD(2);\n"
             "    const size_t r0 = ((size_t)s * K + row) * T.n_slots;\n"),
            ("      __syncthreads();                         "
             "// kbar_st is complete\n",
             "      __syncthreads();                         "
             "// kbar_st is complete\n      TR_ADD(3);\n"),
            ("        if (lane == 0) s_m2[r] = acc;\n      }\n"
             "      __syncthreads();\n",
             "        if (lane == 0) s_m2[r] = acc;\n      }\n"
             "      TR_ADD(4);\n      __syncthreads();\n      TR_ADD(5);\n"),
            ("        Y1[(r0 + sl) * H + h] = y1;\n      }\n"
             "      __syncthreads();\n",
             "        Y1[(r0 + sl) * H + h] = y1;\n      }\n"
             "      __syncthreads();\n      TR_ADD(6);\n"),
            ("          s_kb[T.slot[j] * I + x] = s_kb[T.slot[j] * I + x] + "
             "a * dxi;\n        }\n      }\n    }\n  }\n",
             "          s_kb[T.slot[j] * I + x] = s_kb[T.slot[j] * I + x] + "
             "a * dxi;\n        }\n      }\n      TR_ADD(7);\n    }\n  }\n"
             + WD_WRITE),
            ('extern "C" {\n', WD_READ),
        ]},
        ["load", "rebuild: stage inputs and barrier", "rebuild: operator",
         "rebuild: phi", "rebuild: barrier", "seeds",
         "reverse: operator", "reverse: dphi", "reverse: updates",
         "reverse: dC/dW warp sums", "reverse: barrier after the sums",
         "outputs"],
        ["step input", "rebuild", "seeds", "stage barrier", "m2",
         "m2 barrier", "t and barrier", "layer-1 VJP"]),
    "four-lane K5b and cluster K7b": ({
        "graybox.cu": [
            ('#include "kan_chain.cuh"\n', GB_HEAD),
            ("  for (int s = 0; s < T.stages; ++s) {\n"
             "    if (!T.needed[s]) continue;\n"
             "    float* xs = s_xs + T.slot[s] * g.F;\n",
             "  TR_MARK();\n"
             "  for (int s = 0; s < T.stages; ++s) {\n"
             "    if (!T.needed[s]) continue;\n"
             "    float* xs = s_xs + T.slot[s] * g.F;\n"),
            ("    __syncthreads();                 "
             "// the stage input is complete\n",
             "    TR_ADD(1);\n    __syncthreads();                 "
             "// the stage input is complete\n    TR_ADD(2);\n"),
            ("      gb_known_tile<TT, LN>(xs, s_lap, ti, tj, L, T, g, kn);\n",
             "      gb_known_tile<TT, LN>(xs, s_lap, ti, tj, L, T, g, kn);\n"
             "      TR_ADD(3);\n"),
            ("        ks[o] = knv + (s_cw[T.G] * kc_swish(xv) + chains);\n",
             "        ks[o] = knv + (s_cw[T.G] * kc_swish(xv) + chains);\n"
             "      TR_ADD(4);\n"),
            ("  for (int q = 0; q <= G; ++q) dp[q] = 0.0f;\n"
             "  gb_load(u, lap, c, w, s_lap, s_u, s_cw, T, g);\n"
             "  gb_stages<TT, LN>(s_u, s_us, s_kb, s_lap, s_cw, T, g, L);\n",
             "  for (int q = 0; q <= G; ++q) dp[q] = 0.0f;\n"
             "  if (threadIdx.x < 16) s_tr[threadIdx.x] = 0;\n  TR_MARK();\n"
             "  gb_load(u, lap, c, w, s_lap, s_u, s_cw, T, g);\n"
             "  TR_ADD(0);\n"
             "  gb_stages<TT, LN>(s_u, s_us, s_kb, s_lap, s_cw, T, g, L);\n"
             "  _tm = clock64();\n"),
            ("  // the reverse sweep; dC and dW summed on the fly",
             "  TR_ADD(5);\n"
             "  // the reverse sweep; dC and dW summed on the fly"),
            ("    __syncthreads();                 // kbar_s is complete\n",
             "    __syncthreads();                 // kbar_s is complete\n"
             "    TR_ADD(6);\n"),
            ("      gb_known_tile<TT, LN>(kb, s_lap, ti, tj, L, T, g, kn);\n",
             "      gb_known_tile<TT, LN>(kb, s_lap, ti, tj, L, T, g, kn);\n"
             "      TR_ADD(7);\n"),
            ("          kj[o] = kj[o] + a * dui;\n        }\n      }\n"
             "    }\n  }\n",
             "          kj[o] = kj[o] + a * dui;\n        }\n      }\n"
             "      TR_ADD(8);\n    }\n  }\n"),
            ("    if (threadIdx.x < G) dc[threadIdx.x] = v;\n"
             "    else dw[0] = v;\n  }\n}\n",
             "    if (threadIdx.x < G) dc[threadIdx.x] = v;\n"
             "    else dw[0] = v;\n  }\n  TR_ADD(9);\n" + GB_WRITE + "}\n"),
            ('extern "C" {\n', GB_READ),
        ],
        "rk_fused_wide.cu": [
            ('#include "kan_chain.cuh"\n', WD_HEAD),
            ("  int e = 0;                           "
             "// the cluster's exchanges so far\n",
             "  int e = 0;                           "
             "// the cluster's exchanges so far\n"
             "  if (threadIdx.x < 16) s_wtr[threadIdx.x] = 0;\n"
             "  TR_MARK();\n"),
            ("    e = wd_cluster_stages(w, T, R, rank, e, B.x, B.xs, B.kb, "
             "B.y1, B.part,\n                          B.l2, B.b2, B.xch, "
             "B.bar);\n",
             "    TR_ADD(0);\n"
             "    e = wd_cluster_stages(w, T, R, rank, e, B.x, B.xs, B.kb, "
             "B.y1, B.part,\n                          B.l2, B.b2, B.xch, "
             "B.bar);\n    TR_ADD(1);\n"),
            ("      __syncthreads();                 // kbar_st is complete\n",
             "      TR_ADD(2);\n"
             "      __syncthreads();                 // kbar_st is complete\n"
             "      TR_ADD(3);\n"),
            ("      wd_mbar_wait(bar, (e >> 1) & 1);\n      ++e;\n",
             "      TR_ADD(4);\n      wd_mbar_wait(bar, (e >> 1) & 1);\n"
             "      TR_ADD(5);\n      ++e;\n"),
            ("          B.tm[r] = m * kc_dswish(y1[r - HG]);\n        }\n"
             "      }\n      __syncthreads();\n",
             "          B.tm[r] = m * kc_dswish(y1[r - HG]);\n        }\n"
             "      }\n      __syncthreads();\n      TR_ADD(6);\n"),
            ("          Y1[(r0 + sl) * H + h] = yv;\n        }\n      }\n"
             "      __syncthreads();\n",
             "          Y1[(r0 + sl) * H + h] = yv;\n        }\n      }\n"
             "      __syncthreads();\n      TR_ADD(7);\n"),
            ("        B.l2[(Q + R.q) * W + c] = pw;\n      }\n"
             "      __syncthreads();\n",
             "        B.l2[(Q + R.q) * W + c] = pw;\n      }\n"
             "      TR_ADD(8);\n      __syncthreads();\n      TR_ADD(9);\n"),
            ("            B.kb[T.slot[j] * W + c] = B.kb[T.slot[j] * W + c] "
             "+ a * dxi;\n          }\n        }\n      }\n    }\n  }\n",
             "            B.kb[T.slot[j] * W + c] = B.kb[T.slot[j] * W + c] "
             "+ a * dxi;\n          }\n        }\n      }\n      TR_ADD(10);\n"
             "    }\n  }\n" + WD_WRITE),
            ('extern "C" {\n', WD_READ),
        ]},
        ["load", "stage inputs", "barrier before the operator", "operator",
         "phi", "seeds", "reverse barrier", "reverse operator",
         "reverse dphi and updates", "du and the dC/dW reduction"],
        ["step input", "rebuild", "seeds", "stage barrier", "m2 partial and "
         "send", "m2 wait", "m2 coefficients and barrier", "t and barrier",
         "VJP partials", "VJP barrier", "VJP combine"]),
}

RUN = r"""
import ctypes, json, sys
import torch
import chip_smoke as cs
from kanodes_tpu_torch.ops import _cuda
from kanodes_tpu_torch.ops import graybox_fused as gb
from kanodes_tpu_torch.ops import kdense_pallas as kp
from kanodes_tpu_torch.ops import rk_fused_wide as tw
from kanodes_tpu_torch.utils.precision import set_exact_f32
k5_names, k7_names = json.loads(sys.argv[1])
set_exact_f32()
lib = _cuda.library()

def read(fn):
    out = (ctypes.c_ulonglong * 16)()
    fn(out)
    return list(out)

for i in (0, 1, 6, 7):
    case = cs.GRAYBOX_CASES[i]
    spec, kron, u, lap, c, w, gy = cs.graybox_case_inputs(torch, gb, case)
    st = (spec, case.solver, case.dt, case.D)
    for _ in range(3):
        gb._launch_bwd(*st, u, lap, c, w, gy, kron)
    cyc = read(lib.gb_trace_read)[:len(k5_names)]
    print(json.dumps({"kernel": "K5b", "case": case.label,
                      "cycles": dict(zip(k5_names, cyc)),
                      "total": sum(cyc)}), flush=True)
for i in (6, 9):
    case = cs.WIDE_CASES[i]
    ws, pp, x0, gys = cs.wide_case_inputs(torch, tw, kp, case)
    k = tw._consts(ws, case.solver, case.dt)
    ys = tw._launch_multistep_fwd(k, case.n, x0, pp)
    tw._launch_multistep_bwd(k, case.n, x0, ys, pp, gys)
    cyc = read(lib.wd_trace_read)[:len(k7_names)]
    print(json.dumps({"kernel": "K7b", "case": case.label,
                      "cycles": dict(zip(k7_names, cyc)),
                      "total": sum(cyc)}), flush=True)
"""


def instrument(csrc: str) -> tuple[str, list, list]:
    """Insert the stamps of the design whose code csrc holds; returns the
    design's name and its K5b and K7b phase names."""
    for name, (edits, k5, k7) in DESIGNS.items():
        texts = {f: open(os.path.join(csrc, f)).read() for f in edits}
        if all(all(t.count(old) >= 1 for old, _ in edits[f])
               for f, t in texts.items()):
            for f, pairs in edits.items():
                t = texts[f]
                for old, new in pairs:
                    t = t.replace(old, new, 1)
                with open(os.path.join(csrc, f), "w") as out:
                    out.write(t)
            return name, k5, k7
    raise SystemExit(f"trace_phases: the kernels in {csrc} match no known "
                     f"design ({', '.join(DESIGNS)})")


def trace(root: str) -> list[dict]:
    root = os.path.abspath(root)
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(os.path.join(root, "kanodes_tpu_torch"),
                        os.path.join(tmp, "kanodes_tpu_torch"),
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
        name, k5, k7 = instrument(os.path.join(tmp, "kanodes_tpu_torch",
                                               "csrc"))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join((tmp, root)))
        proc = subprocess.run([sys.executable, "-c", RUN,
                               json.dumps([k5, k7])], cwd=tmp, env=env,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"{root}: traced run failed:\n"
                               f"{proc.stderr[-4000:]}")
    return [dict(json.loads(ln), root=root, design=name)
            for ln in proc.stdout.strip().splitlines()]


def main(argv: list[str]) -> int:
    if not argv:
        raise SystemExit("usage: trace_phases ROOT [ROOT ...]")
    for root in argv:
        for line in trace(root):
            print(json.dumps(line), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                           "clocks.max.sm", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
