"""Where K5b, K7b, K3b, K4b, K4f, K8b, K3f, K8f, K2f-m, K2b-m, K2f, K2b,
K3f-m, K3b-m, K1f and K1b spend a launch, phase by phase, on the card.

    python -m kanodes_tpu_torch.experiments.trace_phases \\
        [--kernels=K5b/K7b,K3b/K4b,K4f/K8b,K3f/K8f,K2f-m/K2b-m,K2f/K2b,\\
K3f-m/K3b-m,K1f/K1b] ROOT [...]
    python -m kanodes_tpu_torch.experiments.trace_phases \\
        --report=NAME[,NAME] ROOT [...]      (no traced run: each ROOT's
        build report for the kernels whose names hold a NAME, e.g. k9_,
        and which kernels' SASS differs from the first ROOT's)

For each ROOT (a checkout of this repository), copies its
`kanodes_tpu_torch/` into a temporary directory, inserts `clock64()`
stamps into the copy's sources at fixed places of the kernels' code,
builds that copy and runs, with chip_smoke.py's inputs, each family
asked for (all by default):
  * K5b/K7b (`csrc/graybox.cu`, `csrc/rk_fused_wide.cu`): K5b at
    Fisher-KPP 1-D [1, 26], Allen-Cahn 1-D [1, 41] and the two [32, 32]
    fields, and K7b at the shooting groups (Schrödinger K = 7, 2-D
    Allen-Cahn K = 4, n = 40);
  * K3b/K4b (`csrc/rk_fused.cu`, `csrc/rk_adaptive.cu` and the chain
    routines of `csrc/kan_chain.cuh` / `kan_chain_warp.cuh`): K3b at n =
    34, K = 1 and K4b at T = 35, K = 1 (LV defaults, the trainer's seeded
    init), tsit5 [2,10,2] G=5 (`compare_trees.LV_ADJOINT_INPUTS`);
  * K4f/K8b (`csrc/rk_adaptive.cu`, `csrc/rk_adaptive_members.cu`, and
    for the warp forward `csrc/kan_chain_warp.cuh`): K4f at T = 35, K = 1
    (LV defaults, the trainer's seeded init) and K8b on
    MEMBERS_CASES[0], the main path's solve (`compare_trees.
    ADAPTIVE_INPUTS`); K8b's three kernels of the new design share one
    line, thread 0 of block 0 of each;
  * K3f/K8f (`csrc/rk_fused.cu`, `csrc/rk_adaptive_members.cu`, and the
    chain routines of `csrc/kan_chain.cuh` / `kan_chain_warp.cuh`): K3f
    at n = 34, K = 1 (LV defaults, the trainer's seeded init) and K8f on
    MEMBERS_CASES[0] (`lv_fixed_launch`, `members_fwd_launch`); a stamp
    shared with another family (kf_chain_fwd's) is put in once;
  * K2f-m/K2b-m (`csrc/kan_chain_block.cuh`, `csrc/rk_fused.cu`): the
    medium flavor's RK step and its adjoint at chip_smoke's MID_CASES
    Burgers K = 1 and 4, 1-D Allen-Cahn K = 1 and the packed K = 34, its
    per-evaluation phases summed over the step's stages; the
    parameter-sum launch as thread 0's own cycles;
  * K2f/K2b (`csrc/rk_fused.cu` and the step routines of
    `csrc/kan_chain.cuh` / `kan_chain_warp.cuh`): the LV RK step and its
    adjoint at K = 34 and 31 rows of chip_smoke's `lv_inputs`, tsit5 (the
    shooting phases' shapes), each stage's evaluation and VJP apart; the
    sums launch of the warp design as thread 0's own cycles;
  * K3f-m/K3b-m (`csrc/rk_fused.cu` with `csrc/kan_chain_block.cuh` or
    `csrc/kan_chain_multistep.cuh`): the medium flavor's multistep and
    its adjoint at chip_smoke's MID_CASES packed n = 34, K = 1 and
    Burgers n = 180, K = 1, the forward's passes summed over its
    evaluations; K3b-m's phases A and B (thread 0 of block 0 of each)
    and phase C1 as thread 0's own cycles (run this family alone on the
    block-a-row design: it adds a stamp to kb_eval, which K2-m's family
    counts in its layer 1);
  * K1f/K1b (`csrc/kan_chain_apply.cu`): the standalone chain and its VJP
    at K = 34 and 1 rows of chip_smoke's `lv_inputs` ([2,10,2] G=5) and,
    in a tree with K1's medium flavor, at the packed [16,80,16] over K =
    1 and 34 rows of MID_CASES' inputs (K1f-m/K1b-m); the sums launch of
    K1b at K > 1 is not stamped.
Thread 0 of block 0 adds the cycles between stamps into its phase's
counter (so a phase inside a loop is thread 0's share of it, and a
barrier's phase is its wait); one JSON line per kernel and case gives the
cycles of each phase (SM clocks, one launch) and their total. Then, per
ROOT, one line with the registers, stack frame and spill bytes that
nvcc's `-Xptxas -v` reports for the family's kernels in ROOT's own
(uninstrumented) build with each kernel's SASS instruction count, and
last the card's name, power limit and top SM clock. A stamp costs ~100
cycles: a few percent of most launches, ~20% of the warp-split K8f's.

Each family knows two designs by the code the stamps go into: the
one-block K5b / K7b of the first port and the four-lane K5b and cluster
K7b that replaced them; the one-thread-a-row K3b / K4b of the first port
and the warp-a-row K3b / K4b that replaced them; the one-thread K4f and
one-block K8b of the first port and the warp-a-row K4f and three-phase
K8b that replaced them; the one-thread K3f and one-block K8f and the
warp-a-row K3f and warp-split K8f that replaced them; the four-phase
K2f-m / K2b-m of the first medium flavor and the two-barrier design that
replaced them; the one-thread K2f / K2b and the warp-a-row K2f (K3f's
kernel at one step) and K2b (K3b's phases at one step) that replaced
them; the block-a-row K3f-m / K3b-m on K2-m's routines and the shorter
K3f-m evaluation with the three-phase K3b-m that replaced them; the
one-thread K1f and one-block K1b and the warp-a-row K1f/K1b with the
block-a-row K1f-m/K1b-m that replaced them. A checkout whose kernels
match neither design of a family raises. The instrumented copy is thrown
away; nothing of ROOT changes. Needs nvcc and a CUDA device.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

from kanodes_tpu_torch.experiments.compare_trees import (ADAPTIVE_INPUTS,
                                                         LV_ADJOINT_INPUTS)

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

# family -> design -> (file -> [(code, code with stamps)],
#                      kernel -> its phase names)
GRAY_WIDE = {
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
        {"K5b": ["load", "rebuild: stage inputs and barrier",
                 "rebuild: operator", "rebuild: phi", "rebuild: barrier",
                 "seeds", "reverse: operator", "reverse: dphi",
                 "reverse: updates", "reverse: dC/dW warp sums",
                 "reverse: barrier after the sums", "outputs"],
         "K7b": ["step input", "rebuild", "seeds", "stage barrier", "m2",
                 "m2 barrier", "t and barrier", "layer-1 VJP"]}),
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
        {"K5b": ["load", "stage inputs", "barrier before the operator",
                 "operator", "phi", "seeds", "reverse barrier",
                 "reverse operator", "reverse dphi and updates",
                 "du and the dC/dW reduction"],
         "K7b": ["step input", "rebuild", "seeds", "stage barrier",
                 "m2 partial and send", "m2 wait",
                 "m2 coefficients and barrier", "t and barrier",
                 "VJP partials", "VJP barrier", "VJP combine"]}),
}


# The LV adjoints K3b and K4b share their chain routines (csrc/kan_chain.cuh)
# with K1, K2 and K8: the stamps there are compiled only in the two
# instrumented files, which define KC_TRACE (the others get empty macros).
KC_MACROS = r"""
#ifdef KC_TRACE
namespace {
__shared__ unsigned long long s_ktr[16];
__shared__ long long s_ktm;
}  // namespace
#define KC_TR_START() do { if (threadIdx.x == 0 && blockIdx.x == 0) { \
  for (int i_ = 0; i_ < 16; ++i_) s_ktr[i_] = 0; s_ktm = clock64(); } \
  } while (0)
#define KC_TR(i) do { if (threadIdx.x == 0 && blockIdx.x == 0) { \
  long long n_ = clock64(); s_ktr[i] += n_ - s_ktm; s_ktm = n_; } \
  } while (0)
#else
#define KC_TR_START() do { } while (0)
#define KC_TR(i) do { } while (0)
#endif
"""


def kc_head(sym: str, header: str = "kan_chain.cuh") -> str:
    return (f'#define KC_TRACE\n#include "{header}"\n\n'
            f"__device__ unsigned long long {sym}[16];\n")


def kc_read(fn: str, sym: str) -> str:
    return (f'extern "C" {{\n\nvoid {fn}(unsigned long long* out) {{\n'
            f"  cudaDeviceSynchronize();\n"
            f"  cudaMemcpyFromSymbol(out, {sym}, sizeof({sym}));\n}}\n")


def kc_write(sym: str) -> str:
    return ("  if (threadIdx.x == 0 && blockIdx.x == 0)\n"
            f"    for (int i = 0; i < 16; ++i) {sym}[i] = s_ktr[i];\n")


LV_PHASES = ["parameter staging", "rebuild", "layer-2 VJP", "layer-1 VJP",
             "record stores", "kbar bookkeeping", "step loads and carry",
             "barrier", "parameter reduction", "seeds"]
# In the chunked design thread 0 rebuilds its share of a chunk's steps with
# their stage Jacobians (phase A), waits for the block ("barrier": the
# other warps' rebuilds), then runs row 0's reverse recursion (phase B).
CHUNKED_PHASES = ["parameter staging", "phase A: rebuild and Jacobians",
                  "stage VJP (J and A2)", "kbar bookkeeping",
                  "record stores", "step loads and carry", "barrier",
                  "parameter reduction", "seeds"]

LV_ADJOINTS = {
    "one-thread K3b and K4b": ({
        "kan_chain.cuh": [
            ("#include <mutex>\n", "#include <mutex>\n" + KC_MACROS),
            ("                  rec + L.swy1);\n",
             "                  rec + L.swy1);\n  KC_TR(2);\n"),
            ("                  rec + L.swx);\n",
             "                  rec + L.swx);\n  KC_TR(3);\n"),
            ("  for (int o = 0; o < d.O; ++o) rec[L.gk + o] = gk[o];\n}\n",
             "  for (int o = 0; o < d.O; ++o) rec[L.gk + o] = gk[o];\n"
             "  KC_TR(4);\n}\n"),
            ("    for (int q = 0; q < d.I; ++q) kbar[s][q] = T.b[s] * gy[q];\n"
             "  }\n",
             "    for (int q = 0; q < d.I; ++q) kbar[s][q] = T.b[s] * gy[q];\n"
             "  }\n  KC_TR(1);\n"),
            ("      for (int q = 0; q < d.I; ++q) kbar[j][q] = kbar[j][q] + "
             "a * dxi[q];\n    }\n",
             "      for (int q = 0; q < d.I; ++q) kbar[j][q] = kbar[j][q] + "
             "a * dxi[q];\n    }\n    KC_TR(5);\n"),
        ],
        "rk_fused.cu": [
            ('#include "kan_chain.cuh"\n', kc_head("g_k3tr")),
            ("                        int n_steps, int n_slots, ChainDims d, "
             "StepTab T) {\n  extern __shared__ float smem[];\n"
             "  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, "
             "smem);\n",
             "                        int n_steps, int n_slots, ChainDims d, "
             "StepTab T) {\n  extern __shared__ float smem[];\n"
             "  KC_TR_START();\n"
             "  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, "
             "smem);\n  KC_TR(0);\n"),
            ("      kc_rk_step_adjoint_row(\n          x_in, xbar, dx,",
             "      KC_TR(6);\n"
             "      kc_rk_step_adjoint_row(\n          x_in, xbar, dx,"),
            ("  __syncthreads();\n  kc_reduce_param_grads(scratch, n_steps * K "
             "* n_slots, d, L, dc1, dw1, dc2,\n                        dw2);\n",
             "  KC_TR(6);\n  __syncthreads();\n  KC_TR(7);\n"
             "  kc_reduce_param_grads(scratch, n_steps * K "
             "* n_slots, d, L, dc1, dw1, dc2,\n                        dw2);\n"
             "  KC_TR(8);\n" + kc_write("g_k3tr")),
            ('extern "C" {\n', kc_read("kc3_trace_read", "g_k3tr")),
        ],
        "rk_adaptive.cu": [
            ('#include "kan_chain.cuh"\n', kc_head("g_k4tr")),
            ("                    AdaptTab tab) {\n"
             "  extern __shared__ float smem[];\n"
             "  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, "
             "smem);\n",
             "                    AdaptTab tab) {\n"
             "  extern __shared__ float smem[];\n  KC_TR_START();\n"
             "  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, "
             "smem);\n  KC_TR(0);\n"),
            ("      kc_adaptive_stages(x_in, rk1 + ((size_t)s * K + r) * I, "
             "dts, tab, d, p,\n                         xs, y1s, ks);\n",
             "      KC_TR(6);\n"
             "      kc_adaptive_stages(x_in, rk1 + ((size_t)s * K + r) * I, "
             "dts, tab, d, p,\n                         xs, y1s, ks);\n"
             "      KC_TR(1);\n"),
            ("      for (int q = 0; q < I; ++q) xnew[q] = xbar[q];\n",
             "      for (int q = 0; q < I; ++q) xnew[q] = xbar[q];\n"
             "      KC_TR(9);\n"),
            ("          for (int w = 0; w < L.width; ++w) rec[w] = 0.0f;\n",
             "          for (int w = 0; w < L.width; ++w) rec[w] = 0.0f;\n"
             "          KC_TR(4);\n"),
            ("          have[j] = true;\n        }\n",
             "          have[j] = true;\n        }\n        KC_TR(5);\n"),
            ("    kc_chain_fwd(xr, d, p, y1s[0], k0);\n",
             "    KC_TR(6);\n    kc_chain_fwd(xr, d, p, y1s[0], k0);\n"
             "    KC_TR(1);\n"),
            ("  __syncthreads();\n  kc_reduce_param_grads(scratch, (n_acc * "
             "(S - 1) + 1) * K, d, L, dc1, dw1,\n"
             "                        dc2, dw2);\n",
             "  KC_TR(6);\n  __syncthreads();\n  KC_TR(7);\n"
             "  kc_reduce_param_grads(scratch, (n_acc * "
             "(S - 1) + 1) * K, d, L, dc1, dw1,\n"
             "                        dc2, dw2);\n  KC_TR(8);\n"
             + kc_write("g_k4tr")),
            ('extern "C" {\n', kc_read("kc4_trace_read", "g_k4tr")),
        ]},
        {"K3b": LV_PHASES, "K4b": LV_PHASES}),
    "warp-a-row K3b and K4b, chunked rebuild with stage Jacobians": ({
        "kan_chain.cuh": [
            ("#include <mutex>\n", "#include <mutex>\n" + KC_MACROS),
        ],
        "kan_chain_warp.cuh": [
            ("  if (lane < O) rec[L.gk + lane] = gk[lane];\n  return dx;\n",
             "  if (lane < O) rec[L.gk + lane] = gk[lane];\n  KC_TR(2);\n"
             "  return dx;\n"),
            ("w.kb[s][lane] = c.b[s] * gy;\n  __syncwarp();\n",
             "w.kb[s][lane] = c.b[s] * gy;\n  __syncwarp();\n  KC_TR(8);\n"),
            ("w.kb[j][lane]);\n    }\n    __syncwarp();\n",
             "w.kb[j][lane]);\n    }\n    __syncwarp();\n    KC_TR(3);\n"),
        ],
        "rk_fused.cu": [
            ('#include "kan_chain_block.cuh"\n',
             kc_head("g_k3tr", "kan_chain_block.cuh")),
            ("  extern __shared__ float smem[];\n  __shared__ WarpConsts c;\n",
             "  extern __shared__ float smem[];\n  __shared__ WarpConsts c;\n"
             "  KC_TR_START();\n"),
            ("  const size_t fstep = (size_t)n_slots * kw_factor_layout(d)."
             "width;\n",
             "  const size_t fstep = (size_t)n_slots * kw_factor_layout(d)."
             "width;\n  KC_TR(0);\n"),
            ("        kw_rk_step_stages(x_in,",
             "        KC_TR(5);\n        kw_rk_step_stages(x_in,"),
            ("n_slots * L.width);\n      }\n      __syncthreads();\n",
             "n_slots * L.width);\n        KC_TR(1);\n      }\n"
             "      __syncthreads();\n      KC_TR(6);\n"),
            ("          xbar = kw_rk_step_reverse(",
             "          KC_TR(5);\n          xbar = kw_rk_step_reverse("),
            ("      __syncthreads();\n    }\n    if (warp < R && lane < I)",
             "      KC_TR(5);\n      __syncthreads();\n      KC_TR(6);\n    }\n"
             "    if (warp < R && lane < I)"),
            ("  kc_reduce_param_grads(scratch, n_steps * K * n_slots, d, L, "
             "dc1, dw1, dc2,\n                        dw2);\n",
             "  KC_TR(5);\n  kc_reduce_param_grads(scratch, n_steps * K * "
             "n_slots, d, L, dc1, dw1, dc2,\n                        dw2);\n"
             "  KC_TR(7);\n" + kc_write("g_k3tr")),
            ('extern "C" {\n', kc_read("kc3_trace_read", "g_k3tr")),
        ],
        "rk_adaptive.cu": [
            ('#include "kan_chain_warp.cuh"\n',
             kc_head("g_k4tr", "kan_chain_warp.cuh")),
            ("  extern __shared__ float smem[];\n  __shared__ WarpConsts c;\n",
             "  extern __shared__ float smem[];\n  __shared__ WarpConsts c;\n"
             "  KC_TR_START();\n"),
            ("  const int n_acc = stats[0], sidx_final = stats[3];\n",
             "  const int n_acc = stats[0], sidx_final = stats[3];\n"
             "  KC_TR(0);\n"),
            ("        kw_adaptive_stages(\n",
             "        KC_TR(5);\n        kw_adaptive_stages(\n"),
            ("            rstride);\n      }\n      __syncthreads();\n",
             "            rstride);\n        KC_TR(1);\n      }\n"
             "      __syncthreads();\n      KC_TR(6);\n"),
            ("          float xnew = xbar;\n          __syncwarp();\n",
             "          float xnew = xbar;\n          __syncwarp();\n"
             "          KC_TR(8);\n"),
            ("rec[q] = 0.0f;\n", "rec[q] = 0.0f;\n              KC_TR(4);\n"),
            ("              have |= 1u << j;\n            }\n"
             "            __syncwarp();\n",
             "              have |= 1u << j;\n            }\n"
             "            __syncwarp();\n            KC_TR(3);\n"),
            ("      __syncthreads();\n    }\n    // the very first k1",
             "      KC_TR(5);\n      __syncthreads();\n      KC_TR(6);\n    }\n"
             "    // the very first k1"),
            ("      kw_chain_fwd(w.xs[0], w.ks[0], fac, rec, d, c, p, L, w, "
             "lane);\n",
             "      KC_TR(5);\n      kw_chain_fwd(w.xs[0], w.ks[0], fac, rec, "
             "d, c, p, L, w, lane);\n      KC_TR(1);\n"),
            ("    __syncthreads();\n  }\n  kc_reduce_param_grads(",
             "    KC_TR(5);\n    __syncthreads();\n    KC_TR(6);\n  }\n"
             "  kc_reduce_param_grads("),
            ("                        dc2, dw2);\n}\n",
             "                        dc2, dw2);\n  KC_TR(7);\n"
             + kc_write("g_k4tr") + "}\n"),
            ('extern "C" {\n', kc_read("kc4_trace_read", "g_k4tr")),
        ]},
        {"K3b": CHUNKED_PHASES, "K4b": CHUNKED_PHASES}),
}


def stamp_head(sym: str, tag: str) -> str:
    """File-scope counters for stamps from any function of one file, by
    thread 0 of block 0: {tag}_START() zeroes them, {tag}(i) adds the
    cycles since the last stamp to phase i plus the offset s_{tag}o (0
    unless the file sets it, so that one routine's phases can be counted
    apart per caller; the index is taken mod 16, so a kernel of the file
    that never zeroed the offset stays in bounds), {tag}_WRITE() copies
    them to the device array sym."""
    return f"""
__device__ unsigned long long {sym}[16];
__shared__ unsigned long long s_{tag}[16];
__shared__ long long s_{tag}t;
__shared__ int s_{tag}o;
#define {tag}_START() do {{ if (threadIdx.x == 0 && blockIdx.x == 0) {{ \\
  for (int i_ = 0; i_ < 16; ++i_) s_{tag}[i_] = 0; \\
  s_{tag}o = 0; s_{tag}t = clock64(); }} }} while (0)
#define {tag}(i) do {{ if (threadIdx.x == 0 && blockIdx.x == 0) {{ \\
  long long n_ = clock64(); s_{tag}[((i) + s_{tag}o) & 15] += \\
  n_ - s_{tag}t; \\
  s_{tag}t = n_; }} }} while (0)
#define {tag}_WRITE() do {{ if (threadIdx.x == 0 && blockIdx.x == 0) \\
  for (int i_ = 0; i_ < 16; ++i_) {sym}[i_] = s_{tag}[i_]; }} while (0)
"""


K4F_PHASES = ["parameter staging", "initial dt and first f(x0)",
              "stages: layer 1", "stages: layer 2",
              "stage inputs and loop top", "solution and error sums",
              "kc_block_sum, controller and barriers",
              "record and save stores", "fill and stats"]
K8B_PHASES = ["set-up and fill cotangent", "record loads",
              "stage rebuild (mb_chain)", "kbar set-up",
              "VJP: features and m2", "VJP: input cotangents", "VJP: m1",
              "VJP: parameter accumulation", "carry", "outputs",
              "final f(x0): rebuild, features and m2",
              "final: input cotangents", "final: m1",
              "final: parameter accumulation"]

ADAPTIVE_FWD_MEMBERS_BWD = {
    "one-thread K4f and one-block K8b": ({
        "rk_adaptive.cu": [
            ("namespace {\n\n// Sum of red[0..n)",
             stamp_head("g_k4ftr", "F4") + "namespace {\n\n// Sum of "
             "red[0..n)"),
            ("    kc_chain_fwd(xs[i], d, p, y1s[i], ks[i]);\n  }\n}\n",
             "    F4(4);\n"
             "    kc_layer_fwd(xs[i], d.I, d.H, p.c1, p.w1, d, y1s[i]);\n"
             "    F4(2);\n"
             "    kc_layer_fwd(y1s[i], d.H, d.O, p.c2, p.w2, d, ks[i]);\n"
             "    F4(3);\n  }\n}\n"),
            ("  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, "
             "smem);\n  float* red",
             "  F4_START();\n"
             "  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, "
             "smem);\n  F4(0);\n  float* red"),
            ("  if (threadIdx.x == 0) {\n    s_t = t0;",
             "  F4(1);\n  if (threadIdx.x == 0) {\n    s_t = t0;"),
            ("    const float sq = kc_block_sum(red, n);\n",
             "    F4(5);\n    const float sq = kc_block_sum(red, n);\n"),
            ("      s_nit += 1;\n    }\n    __syncthreads();\n",
             "      s_nit += 1;\n    }\n    __syncthreads();\n    F4(6);\n"),
            ("          ys[((size_t)s_row * K + r) * I + q] = y1[q];\n    }\n"
             "  }\n",
             "          ys[((size_t)s_row * K + r) * I + q] = y1[q];\n    }\n"
             "    F4(7);\n  }\n"),
            ("    stats[3] = sidx_final;\n  }\n}\n",
             "    stats[3] = sidx_final;\n  }\n  F4(8);\n  F4_WRITE();\n}\n"),
            ('extern "C" {\n', kc_read("k4f_trace_read", "g_k4ftr")),
        ],
        "rk_adaptive_members.cu": [
            ("namespace {\n\nconstexpr int kThreads = 256;\n",
             stamp_head("g_k8btr", "B8")
             + "namespace {\n\nconstexpr int kThreads = 256;\n"),
            ("  __syncthreads();\n  mb_input_cotangent(hid, K, H, d, m2, dy1);\n"
             "  __syncthreads();\n",
             "  __syncthreads();\n  B8(4);\n"
             "  mb_input_cotangent(hid, K, H, d, m2, dy1);\n"
             "  __syncthreads();\n  B8(5);\n"),
            ("    m1[t] = acc;\n  }\n  __syncthreads();\n"
             "  mb_input_cotangent(x, K, I, d, m1, dx);\n",
             "    m1[t] = acc;\n  }\n  __syncthreads();\n  B8(6);\n"
             "  mb_input_cotangent(x, K, I, d, m1, dx);\n  B8(5);\n"),
            ("    grads[q] += acc;\n  }\n  __syncthreads();\n}\n",
             "    grads[q] += acc;\n  }\n  __syncthreads();\n  B8(7);\n}\n"),
            ("  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, "
             "smem);\n  const MbBwd L",
             "  B8_START();\n"
             "  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, "
             "smem);\n  const MbBwd L"),
            ("    k1bar[t] = 0.0f;\n  }\n  __syncthreads();\n",
             "    k1bar[t] = 0.0f;\n  }\n  __syncthreads();\n  B8(0);\n"),
            ("      k[t] = rk1[off + t];\n    }\n    __syncthreads();\n",
             "      k[t] = rk1[off + t];\n    }\n    __syncthreads();\n"
             "    B8(1);\n"),
            ("      mb_chain(xs + i * KI, hid + i * KH, k + i * KI, K, d, p, "
             "feat1, part);\n    }\n",
             "      mb_chain(xs + i * KI, hid + i * KH, k + i * KI, K, d, p, "
             "feat1, part);\n    }\n    B8(2);\n"),
            ("    have[st - 1] = true;\n    __syncthreads();\n",
             "    have[st - 1] = true;\n    __syncthreads();\n    B8(3);\n"),
            ("        if (tab.a[i][j] != 0.0f) have[j] = true;\n"
             "      __syncthreads();\n    }\n",
             "        if (tab.a[i][j] != 0.0f) have[j] = true;\n"
             "      __syncthreads();\n      B8(8);\n    }\n"),
            ("      xbar[t] = xnew[t];\n    }\n    __syncthreads();\n  }\n",
             "      xbar[t] = xnew[t];\n    }\n    __syncthreads();\n"
             "    B8(8);\n  }\n"),
            ("  // the very first k1 was f(x0): one chain VJP at the inputs\n",
             "  if (threadIdx.x == 0) s_B8o = 6;\n"
             "  // the very first k1 was f(x0): one chain VJP at the inputs\n"),
            ("    else dw2[q - n_c1 - n_w1 - n_c2] = grads[q];\n  }\n}\n",
             "    else dw2[q - n_c1 - n_w1 - n_c2] = grads[q];\n  }\n"
             "  if (threadIdx.x == 0) s_B8o = 0;\n  B8(9);\n  B8_WRITE();\n}\n"),
            ('extern "C" {\n', kc_read("k8b_trace_read", "g_k8btr")),
        ]},
        {"K4f": K4F_PHASES, "K8b": K8B_PHASES}),
}

WARP_K4F_PHASES = ["parameters, constants and register slices",
                   "first f(x0) and initial dt: the rest", "stage inputs",
                   "chain: layer-1 terms",
                   "chain: hidden sums and swish products (lane h)",
                   "chain: layer-2 basis and products (lane h*G + g)",
                   "chain: output sums (lanes o, O + o)",
                   "solution and error sums",
                   "kc_block_sum, controller and barriers",
                   "record and save stores", "fill and stats",
                   "first f(x0) and initial dt: layer-1 terms",
                   "first f(x0) and initial dt: hidden sums",
                   "first f(x0) and initial dt: layer-2 products",
                   "first f(x0) and initial dt: output sums"]
# one line for K8b's three kernels: thread 0 of block 0 of each (phase A's
# block 0 rebuilds the first recorded iteration, phase C's sums for hidden
# unit 0)
PHASED_K8B_PHASES = ["A: parameters and record loads", "A: stage inputs",
                     "A: stage rebuild (mb_chain)",
                     "A: features and derivative factors", "A: A2 and A1",
                     "A: J", "B: fill cotangent and first copy",
                     "B: seeds and loads", "B: wait for the staged Jacobians",
                     "B: stage VJPs", "B: carry", "B: final f(x0) and dx0",
                     "C: dy1 of a chunk", "C: [dc1 ; dw1] sums", "C: stores"]
K8B_READ = """extern "C" {

void k8b_trace_read(unsigned long long* out) {
  unsigned long long a[16], b[16], c[16];
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(a, g_k8ta, sizeof(a));
  cudaMemcpyFromSymbol(b, g_k8tb, sizeof(b));
  cudaMemcpyFromSymbol(c, g_k8tc, sizeof(c));
  for (int i = 0; i < 16; ++i)
    out[i] = i < 6 ? a[i] : i < 12 ? b[i - 6] : i < 15 ? c[i - 12] : 0;
}
"""
ADAPTIVE_FWD_MEMBERS_BWD["warp-a-row K4f and three-phase K8b"] = ({
    "kan_chain_warp.cuh": [
        ('#pragma once\n\n#include "kan_chain.cuh"\n',
         '#pragma once\n\n#include "kan_chain.cuh"\n\n#ifdef KF_TRACE\n'
         '#define KF_TR(i) F4(i)\n#else\n#define KF_TR(i) do { } while (0)\n'
         '#endif\n'),
        ("  }\n  __syncwarp();\n  if (lane < H) {\n    float ac = 0.0f;\n",
         "  }\n  __syncwarp();\n  KF_TR(3);\n  if (lane < H) {\n"
         "    float ac = 0.0f;\n"),
        ("  __syncwarp();\n  // two terms a lane at a time",
         "  __syncwarp();\n  KF_TR(4);\n  // two terms a lane at a time"),
        ("  __syncwarp();\n  // lane o adds the basis products",
         "  __syncwarp();\n  KF_TR(5);\n  // lane o adds the basis products"),
        ("  if (lane < O) kout[lane] = __fadd_rn(sum, aw);\n}\n",
         "  if (lane < O) kout[lane] = __fadd_rn(sum, aw);\n  KF_TR(6);\n}\n"),
    ],
    "rk_adaptive.cu": [
        ('#include "kan_chain_warp.cuh"\n',
         "#define KF_TRACE\n" + stamp_head("g_k4ftr", "F4")
         + '#include "kan_chain_warp.cuh"\n'),
        ("  const int all[KC_MAX_STAGES] = {1, 1, 1, 1, 1, 1, 1};\n"
         "  kw_fill_consts(wc, ",
         "  F4_START();\n"
         "  const int all[KC_MAX_STAGES] = {1, 1, 1, 1, 1, 1, 1};\n"
         "  kw_fill_consts(wc, "),
        ("  kf_load_regs(rg, p, d, lane);\n  __syncthreads();\n",
         "  kf_load_regs(rg, p, d, lane);\n  __syncthreads();\n  F4(0);\n"
         "  if (threadIdx.x == 0) s_F4o = 8;\n"),
        ("  if (threadIdx.x == 0) {\n    s_t = t0;",
         "  if (threadIdx.x == 0) s_F4o = 0;\n  F4(1);\n"
         "  if (threadIdx.x == 0) {\n    s_t = t0;"),
        ("        __syncwarp();\n        kf_chain_fwd(xs, ks + i * I, ",
         "        __syncwarp();\n        F4(2);\n"
         "        kf_chain_fwd(xs, ks + i * I, "),
        ("    const float sq = kc_block_sum(red, n);\n",
         "    F4(7);\n    const float sq = kc_block_sum(red, n);\n"),
        ("      s_nit += 1;\n    }\n    __syncthreads();\n",
         "      s_nit += 1;\n    }\n    __syncthreads();\n    F4(8);\n"),
        ("        if (s_saved) ys[((size_t)s_row * K + r) * I + lane] = y;\n"
         "      }\n    }\n  }\n",
         "        if (s_saved) ys[((size_t)s_row * K + r) * I + lane] = y;\n"
         "      }\n    }\n    F4(9);\n  }\n"),
        ("    stats[3] = sidx_final;\n  }\n}\n",
         "    stats[3] = sidx_final;\n  }\n  F4(10);\n  F4_WRITE();\n}\n"),
        ('extern "C" {\n', kc_read("k4f_trace_read", "g_k4ftr")),
    ],
    "rk_adaptive_members.cu": [
        ("namespace {\n\nconstexpr int kThreads = 256;\n",
         stamp_head("g_k8ta", "BA") + stamp_head("g_k8tb", "BB")
         + stamp_head("g_k8tc", "BC")
         + "namespace {\n\nconstexpr int kThreads = 256;\n"),
        ("  if (b < max_steps && b >= nit[0]) return;\n"
         "  extern __shared__ float smem[];\n",
         "  if (b < max_steps && b >= nit[0]) return;\n"
         "  extern __shared__ float smem[];\n  BA_START();\n"),
        ("    k[t] = rk1[(size_t)b * KI + t];\n  }\n  __syncthreads();\n",
         "    k[t] = rk1[(size_t)b * KI + t];\n  }\n  __syncthreads();\n"
         "  BA(0);\n"),
        ("    __syncthreads();\n"
         "    mb_chain(xs, hid, k + i * KI, K, d, p, feat, part);\n",
         "    __syncthreads();\n    BA(1);\n"
         "    mb_chain(xs, hid, k + i * KI, K, d, p, feat, part);\n"
         "    BA(2);\n"),
        ("* slab, L, smem);\n  }\n}\n",
         "* slab, L, smem);\n  }\n  BA_WRITE();\n}\n"),
        ("  __syncthreads();\n  for (int r0 = 0; r0 < K; r0 += L.rc) {\n",
         "  __syncthreads();\n  BA(3);\n"
         "  for (int r0 = 0; r0 < K; r0 += L.rc) {\n"),
        ("    __syncthreads();\n"
         "    for (int t = threadIdx.x; t < RC * O * I; t += blockDim.x) {\n",
         "    __syncthreads();\n    BA(4);\n"
         "    for (int t = threadIdx.x; t < RC * O * I; t += blockDim.x) {\n"),
        ("      rec[(size_t)(r0 + rr) * W + R.j + e] = acc;\n    }\n"
         "    __syncthreads();\n",
         "      rec[(size_t)(r0 + rr) * W + R.j + e] = acc;\n    }\n"
         "    __syncthreads();\n    BA(5);\n"),
        ("  __shared__ float s_a[KC_MAX_STAGES][KC_MAX_STAGES];\n",
         "  __shared__ float s_a[KC_MAX_STAGES][KC_MAX_STAGES];\n"
         "  BB_START();\n"),
        ("    mb_cp_commit();\n    for (int it = n_it - 1; it >= 0; --it) {\n",
         "    mb_cp_commit();\n    BB(0);\n"
         "    for (int it = n_it - 1; it >= 0; --it) {\n"),
        ("      mb_cp_wait<1>();\n      __syncwarp();\n",
         "      BB(1);\n      mb_cp_wait<1>();\n      __syncwarp();\n"
         "      BB(2);\n"),
        ("          kb[j] = (have >> j) & 1u ? kb[j] + contrib : contrib;\n"
         "          have |= 1u << j;\n        }\n      }\n",
         "          kb[j] = (have >> j) & 1u ? kb[j] + contrib : contrib;\n"
         "          have |= 1u << j;\n        }\n        BB(3);\n      }\n"),
        ("      next_sx = nxt2_sx;\n      __syncwarp();",
         "      next_sx = nxt2_sx;\n      BB(4);\n      __syncwarp();"),
        ("      dx0[(size_t)r * I + lane] = (xbar + dxi) + gys[(size_t)r * I + "
         "lane];\n    __syncwarp();\n  }\n}\n",
         "      dx0[(size_t)r * I + lane] = (xbar + dxi) + gys[(size_t)r * I + "
         "lane];\n    __syncwarp();\n    BB(5);\n  }\n  BB_WRITE();\n}\n"),
        ("  __shared__ size_t s_off[kThreads];\n",
         "  __shared__ size_t s_off[kThreads];\n  BC_START();\n"),
        ("        s_off[tid] = off;\n      }\n      __syncthreads();\n",
         "        s_off[tid] = off;\n      }\n      __syncthreads();\n"
         "      BC(0);\n"),
        ("            mb_kahan_add(acc[s], cmp[s], f[u][s] * dy);\n        }\n"
         "      }\n      __syncthreads();\n",
         "            mb_kahan_add(acc[s], cmp[s], f[u][s] * dy);\n        }\n"
         "      }\n      __syncthreads();\n      BC(1);\n"),
        ("      else if (j < J1) dw1[(j - IG) * H + h] = acc[s];\n    }\n"
         "    return;\n",
         "      else if (j < J1) dw1[(j - IG) * H + h] = acc[s];\n    }\n"
         "    BC(2);\n    BC_WRITE();\n    return;\n"),
        ('extern "C" {\n', K8B_READ),
    ]},
    {"K4f": WARP_K4F_PHASES, "K8b": PHASED_K8B_PHASES})

ONE_THREAD_K3F_PHASES = ["parameter staging", "stage inputs", "layer 1",
                         "layer 2", "step sum and stores"]
# thread 0 of the block; every __syncthreads wait goes to "barriers"
ONE_BLOCK_K8F_PHASES = ["parameter staging",
                        "initial dt and first f(x0): the rest",
                        "controller set-up (thread s)", "stage inputs",
                        "chain: layer-1 features",
                        "chain: layer-1 matvec partials",
                        "chain: layer-1 partial combination",
                        "chain: layer-2 features",
                        "chain: layer-2 matvec partials",
                        "chain: layer-2 partial combination",
                        "solution and error terms",
                        "error norm and controller (thread s)",
                        "record stores and done flag", "barriers",
                        "fill and stats"]
K8F_HEAD = stamp_head("g_k8ftr", "F8") + "__shared__ int s_F8L;\n"
LV_FIXED_MEMBERS_FWD = {
    "one-thread K3f and one-block K8f": ({
        "kan_chain.cuh": [
            ("#include <mutex>\n",
             "#include <mutex>\n\n#ifdef K3F_TRACE\n#define K3T(i) F3(i)\n"
             "#else\n#define K3T(i) do { } while (0)\n#endif\n"),
            ("    kc_chain_fwd(xi, d, p, y1, ks[s]);\n  }\n",
             "    K3T(1);\n    kc_layer_fwd(xi, d.I, d.H, p.c1, p.w1, d, y1);\n"
             "    K3T(2);\n"
             "    kc_layer_fwd(y1, d.H, d.O, p.c2, p.w2, d, ks[s]);\n"
             "    K3T(3);\n  }\n"),
        ],
        "rk_fused.cu": [
            ('#include "kan_chain_warp.cuh"\n',
             "#define K3F_TRACE\n" + stamp_head("g_k3ftr", "F3")
             + '#include "kan_chain_warp.cuh"\n'),
            ("  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, "
             "smem);\n  const int r = blockIdx.x * blockDim.x + threadIdx.x;\n"
             "  if (r >= K) return;\n",
             "  F3_START();\n"
             "  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, "
             "smem);\n  F3(0);\n"
             "  const int r = blockIdx.x * blockDim.x + threadIdx.x;\n"
             "  if (r >= K) return;\n"),
            ("      out[q] = y[q];\n      x[q] = y[q];\n    }\n  }\n}\n",
             "      out[q] = y[q];\n      x[q] = y[q];\n    }\n    F3(4);\n"
             "  }\n  F3_WRITE();\n}\n"),
            ('extern "C" {\n', kc_read("k3f_trace_read", "g_k3ftr")),
        ],
        "rk_adaptive_members.cu": [
            ("namespace {\n\nconstexpr int kThreads = 256;\n",
             K8F_HEAD + "namespace {\n\nconstexpr int kThreads = 256;\n"),
            ("    part[t] = acc;\n  }\n  __syncthreads();\n",
             "    part[t] = acc;\n  }\n  F8(s_F8L);\n  __syncthreads();\n"
             "  F8(13);\n"),
            ("    out[t] = acc;\n  }\n  __syncthreads();\n}\n",
             "    out[t] = acc;\n  }\n  F8(s_F8L + 1);\n  __syncthreads();\n"
             "  F8(13);\n}\n"),
            ("  mb_features(xin, K, d.I, d, feat);\n  __syncthreads();\n"
             "  mb_matvec(feat, K, d.I * (d.G + 1), p.c1, d.H, part, hid);\n"
             "  mb_features(hid, K, d.H, d, feat);\n  __syncthreads();\n",
             "  mb_features(xin, K, d.I, d, feat);\n  F8(4);\n"
             "  __syncthreads();\n  F8(13);\n"
             "  if (threadIdx.x == 0) s_F8L = 5;\n"
             "  mb_matvec(feat, K, d.I * (d.G + 1), p.c1, d.H, part, hid);\n"
             "  mb_features(hid, K, d.H, d, feat);\n  F8(7);\n"
             "  __syncthreads();\n  F8(13);\n"
             "  if (threadIdx.x == 0) s_F8L = 8;\n"),
            ("  extern __shared__ float smem[];\n"
             "  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, "
             "smem);\n  const MbFwd L = mb_fwd_layout(d, K, tab.stages);\n",
             "  extern __shared__ float smem[];\n  F8_START();\n"
             "  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, "
             "smem);\n  F8(0);\n"
             "  const MbFwd L = mb_fwd_layout(d, K, tab.stages);\n"),
            ("  if (tid == 0) s_all_done = T_save <= 1;\n  __syncthreads();\n",
             "  if (tid == 0) s_all_done = T_save <= 1;\n  __syncthreads();\n"
             "  F8(1);\n"),
            ("      s_dts[tid] = tdir * dt_used;\n    }\n    __syncthreads();\n",
             "      s_dts[tid] = tdir * dt_used;\n    }\n    F8(2);\n"
             "    __syncthreads();\n    F8(13);\n"),
            ("        xs[t] = v;\n      }\n      __syncthreads();\n"
             "      mb_chain(xs, hid, k + i * KI, K, d, p, feat, part);\n",
             "        xs[t] = v;\n      }\n      F8(3);\n      __syncthreads();\n"
             "      F8(13);\n"
             "      mb_chain(xs, hid, k + i * KI, K, d, p, feat, part);\n"),
            ("      red[t] = v * v;\n    }\n    __syncthreads();\n"
             "    if (tid < S) {\n      const int s = tid;\n",
             "      red[t] = v * v;\n    }\n    F8(10);\n    __syncthreads();\n"
             "    F8(13);\n    if (tid < S) {\n      const int s = tid;\n"),
            ("      s_done[s] = done || s_sidx[s] >= T_save;\n    }\n"
             "    __syncthreads();\n",
             "      s_done[s] = done || s_sidx[s] >= T_save;\n    }\n"
             "    F8(11);\n    __syncthreads();\n    F8(13);\n"),
            ("    ++n_it;\n    __syncthreads();\n  }\n",
             "    ++n_it;\n    F8(12);\n    __syncthreads();\n    F8(13);\n"
             "  }\n"),
            ("  if (tid == 0) nit[0] = n_it;\n}\n",
             "  if (tid == 0) nit[0] = n_it;\n  F8(14);\n  F8_WRITE();\n}\n"),
            ('extern "C" {\n', kc_read("k8f_trace_read", "g_k8ftr")),
        ]},
        {"K3f": ONE_THREAD_K3F_PHASES, "K8f": ONE_BLOCK_K8F_PHASES}),
}

WARP_K3F_PHASES = ["parameters, constants and register slices",
                   "step sum and stores", "stage inputs",
                   "chain: layer-1 terms",
                   "chain: hidden sums and swish products (lane h)",
                   "chain: layer-2 basis and products (lane h*G + g)",
                   "chain: output sums (lanes o, O + o)"]
# thread 0 is lane 0 of group 0 of both layers' splits: it adds chunk 0
# and then all chunks of output 0
SPLIT_K8F_PHASES = ["parameters, tables and state",
                    "initial dt and first f(x0): the rest",
                    "stage-1 input features (block)",
                    "layer 1: chunk sums (lane)",
                    "layer 1: chunks added in order, shuffle",
                    "layer 2's features (group)",
                    "layer 2: chunk sums (lane)",
                    "layer 2: chunks added in order, shuffle",
                    "next stage's input and features, or result and errors "
                    "(group)",
                    "barriers", "controller and next set-up (thread s)",
                    "record stores and done flag", "fill and stats",
                    "a warp-load's set-up (both layers)",
                    "wait at __syncwarp after the chunk sums (both layers)"]
LV_FIXED_MEMBERS_FWD["warp-a-row K3f and warp-split K8f"] = ({
    # the stamps of kf_chain_fwd, as the K4f/K8b family puts them
    "kan_chain_warp.cuh": ADAPTIVE_FWD_MEMBERS_BWD[
        "warp-a-row K4f and three-phase K8b"][0]["kan_chain_warp.cuh"],
    "rk_fused.cu": [
        ('#include "kan_chain_block.cuh"\n',
         "#define KF_TRACE\n" + stamp_head("g_k3ftr", "F3")
         + "#define F4(i) F3(i)\n" + '#include "kan_chain_block.cuh"\n'),
        ("  __shared__ unsigned char s_l2h[KC_MAX_H * KC_MAX_G];\n"
         "  kw_fill_consts(wc, d, T.stages, T.a, T.b, T.needed);\n",
         "  __shared__ unsigned char s_l2h[KC_MAX_H * KC_MAX_G];\n"
         "  F3_START();\n"
         "  kw_fill_consts(wc, d, T.stages, T.a, T.b, T.needed);\n"),
        ("  kf_load_regs(rg, p, d, lane);\n  __syncthreads();\n"
         "  const int r = blockIdx.x * warps + warp;\n",
         "  kf_load_regs(rg, p, d, lane);\n  __syncthreads();\n  F3(0);\n"
         "  const int r = blockIdx.x * warps + warp;\n"),
        ("      __syncwarp();\n"
         "      kf_chain_fwd(xs, ks + i * I, d, wc, s_l2h, p, rg, cw, lane);\n",
         "      __syncwarp();\n      F3(2);\n"
         "      kf_chain_fwd(xs, ks + i * I, d, wc, s_l2h, p, rg, cw, lane);\n"),
        ("      ys[((size_t)s * K + r) * I + lane] = y;\n      x = y;\n    }\n"
         "  }\n}\n",
         "      ys[((size_t)s * K + r) * I + lane] = y;\n      x = y;\n    }\n"
         "    F3(1);\n  }\n  F3_WRITE();\n}\n"),
        ('extern "C" {\n', kc_read("k3f_trace_read", "g_k3ftr")),
    ],
    "rk_adaptive_members.cu": [
        ("namespace {\n\nconstexpr int kThreads = 256;\n",
         K8F_HEAD + "namespace {\n\nconstexpr int kThreads = 256;\n"),
        ("      n = o - r * s.N;\n    }\n",
         "      n = o - r * s.N;\n    }\n    F8(13);\n"),
        ("                    : 0.0f;\n      }\n    }\n    __syncwarp();\n",
         "                    : 0.0f;\n      }\n    }\n    F8(s_F8L);\n"
         "    __syncwarp();\n    F8(14);\n"),
        ("    v = __shfl_sync(0xffffffffu, v, lane - c0);\n"
         "    if (act) tail(r, n, v, c0);\n    __syncwarp();\n",
         "    v = __shfl_sync(0xffffffffu, v, lane - c0);\n    F8(s_F8L + 1);\n"
         "    if (act) tail(r, n, v, c0);\n    __syncwarp();\n"
         "    F8(s_F8L + 2);\n"),
        ("  extern __shared__ float smem[];\n"
         "  const int I = d.I, H = d.H, G = d.G, KI = K * I, dm = I / S;\n",
         "  extern __shared__ float smem[];\n  F8_START();\n"
         "  const int I = d.I, H = d.H, G = d.G, KI = K * I, dm = I / S;\n"),
        ("    x[t] = x0[t];\n    ys[t] = x0[t];\n  }\n  __syncthreads();\n",
         "    x[t] = x0[t];\n    ys[t] = x0[t];\n  }\n  __syncthreads();\n"
         "  F8(0);\n"),
        ("  auto evaluate = [&](float* out, int next) {\n",
         "  auto evaluate = [&](float* out, int next) {\n"
         "    if (tid == 0) s_F8L = 3;\n"),
        ("             });\n    __syncthreads();\n    mb_layer(s2,",
         "             });\n    __syncthreads();\n    F8(9);\n"
         "    if (tid == 0) s_F8L = 6;\n    mb_layer(s2,"),
        ("             });\n    __syncthreads();\n  };\n",
         "             });\n    __syncthreads();\n    F8(9);\n  };\n"),
        ("  if (tid == 0) s_all_done = T_save <= 1;\n  __syncthreads();\n",
         "  if (tid == 0) s_all_done = T_save <= 1;\n  __syncthreads();\n"
         "  F8(1);\n"),
        ("    input_features(1);\n    __syncthreads();\n",
         "    input_features(1);\n    F8(2);\n    __syncthreads();\n"
         "    F8(9);\n"),
        ("    }\n    __syncthreads();\n    const size_t off = (size_t)n_it * KI;\n",
         "    }\n    F8(10);\n    __syncthreads();\n    F8(9);\n"
         "    const size_t off = (size_t)n_it * KI;\n"),
        ("    ++n_it;\n    __syncthreads();\n  }\n",
         "    ++n_it;\n    F8(11);\n    __syncthreads();\n    F8(9);\n"
         "  }\n"),
        ("  if (tid == 0) nit[0] = n_it;\n}\n",
         "  if (tid == 0) nit[0] = n_it;\n  F8(12);\n  F8_WRITE();\n}\n"),
        ('extern "C" {\n', kc_read("k8f_trace_read", "g_k8ftr")),
    ]},
    {"K3f": WARP_K3F_PHASES, "K8f": SPLIT_K8F_PHASES})

# K2f-m / K2b-m (kan_chain_block.cuh, launched from rk_fused.cu): the
# stamps of the block routines go into the header under the tag KB; the
# separate parameter-sum launch keeps thread 0's own cycles in g_kbsum.
KB_HEAD = '#include "kan_chain_warp.cuh"\n' + stamp_head("g_kbtr", "KB")
KB_READ = (kc_read("kbtr_read", "g_kbtr")
           + "\nvoid kbsum_read(unsigned long long* out) {\n"
           "  cudaDeviceSynchronize();\n"
           "  cudaMemcpyFromSymbol(out, g_kbsum, sizeof(g_kbsum));\n"
           "  static const unsigned long long zero[16] = {0};\n"
           "  cudaMemcpyToSymbol(g_kbsum, zero, sizeof(zero));\n}\n")
KB_SUMS = ("  const RecLayout L = kc_rec_layout(d.I, d.H, d.O, d.G);\n"
           "  kb_param_sums(scratch, n_rec, d, L, dc1, dw1, dc2, dw2);\n}\n",
           "  const long long t0_ = clock64();\n"
           "  const RecLayout L = kc_rec_layout(d.I, d.H, d.O, d.G);\n"
           "  kb_param_sums(scratch, n_rec, d, L, dc1, dw1, dc2, dw2);\n"
           "  if (threadIdx.x == 0 && blockIdx.x == 0) g_kbsum[0] = "
           "clock64() - t0_;\n}\n")
FOUR_PHASE_K2FM = ["parameter staging and constants", "state load",
                   "stage input", "layer-1 features", "layer-1 matvec",
                   "layer-2 features", "layer-2 matvec",
                   "step sum and store"]
FOUR_PHASE_K2BM = ["parameter staging and constants", "loads",
                   "rebuild: stage input", "rebuild: layer-1 features",
                   "rebuild: layer-1 matvec", "rebuild: layer-2 features",
                   "rebuild: layer-2 matvec", "seeds",
                   "reverse: layer-2 terms and gk record",
                   "reverse: dy1", "reverse: layer-1 terms",
                   "reverse: dx and kbar", "dx store",
                   "parameter sums (second launch, thread 0)"]
MID_STEP = {
    "four-phase K2f-m and K2b-m": ({
        "kan_chain_block.cuh": [
            ('#include "kan_chain_warp.cuh"\n', KB_HEAD
             + "__device__ unsigned long long g_kbsum[16];\n"),
            ("  __syncthreads();\n  BlockParams p;\n",
             "  __syncthreads();\n  KB(0);\n  BlockParams p;\n"),
            ("  kb_features(x, d.I, d, c, b1);\n  __syncthreads();\n"
             "  kb_matvec_rows(p.c1t, b1, d.H, kb_l1(d), y1);\n"
             "  __syncthreads();\n  kb_features(y1, d.H, d, c, b2);\n"
             "  __syncthreads();\n"
             "  kb_matvec_rows(p.c2t, b2, d.O, kb_l2(d), kout);\n"
             "  __syncthreads();\n}\n",
             "  kb_features(x, d.I, d, c, b1);\n  __syncthreads();\n  KB(3);\n"
             "  kb_matvec_rows(p.c1t, b1, d.H, kb_l1(d), y1);\n"
             "  __syncthreads();\n  KB(4);\n  kb_features(y1, d.H, d, c, b2);\n"
             "  __syncthreads();\n  KB(5);\n"
             "  kb_matvec_rows(p.c2t, b2, d.O, kb_l2(d), kout);\n"
             "  __syncthreads();\n  KB(6);\n}\n"),
            ("    xi[q] = v;\n  }\n  __syncthreads();\n}\n",
             "    xi[q] = v;\n  }\n  __syncthreads();\n  KB(2);\n}\n"),
            ("    y[q] = acc;\n  }\n  __syncthreads();\n}\n",
             "    y[q] = acc;\n  }\n  __syncthreads();\n  KB(7);\n}\n"),
            ("    for (int s = 0; s < stages; ++s) a.kb[s * I + q] = c.b[s] * g;"
             "\n  }\n  __syncthreads();\n",
             "    for (int s = 0; s < stages; ++s) a.kb[s * I + q] = c.b[s] * g;"
             "\n  }\n  __syncthreads();\n  KB(7);\n"),
            ("    for (int o = threadIdx.x; o < O; o += blockDim.x) "
             "r[L.gk + o] = gk[o];\n    __syncthreads();\n",
             "    for (int o = threadIdx.x; o < O; o += blockDim.x) "
             "r[L.gk + o] = gk[o];\n    __syncthreads();\n    KB(8);\n"),
            ("      r[L.dy1 + h] = v;\n    }\n    __syncthreads();\n",
             "      r[L.dy1 + h] = v;\n    }\n    __syncthreads();\n    KB(9);\n"),
            ("    kb_layer_terms(p.c1t, dy1, H, xs, I, d, c, t1, r + L.b1);\n"
             "    __syncthreads();\n",
             "    kb_layer_terms(p.c1t, dy1, H, xs, I, d, c, t1, r + L.b1);\n"
             "    __syncthreads();\n    KB(10);\n"),
            ("a.kb[j * I + q] + aj * v;\n      }\n    }\n    __syncthreads();\n"
             "  }\n}\n",
             "a.kb[j * I + q] + aj * v;\n      }\n    }\n    __syncthreads();\n"
             "    KB(11);\n  }\n}\n"),
        ],
        "rk_fused.cu": [
            ("float* y, ChainDims d,\n                   StepTab T) {\n"
             "  extern __shared__ float smem[];\n",
             "float* y, ChainDims d,\n                   StepTab T) {\n"
             "  extern __shared__ float smem[];\n  KB_START();\n"),
            ("    xr[q] = x[(size_t)r * I + q];\n  __syncthreads();\n"
             "  kb_rk_step(xr, xr, T.stages, d, c, p, xi, ks, ws);\n"
             "  for (int q = threadIdx.x; q < I; q += blockDim.x)\n"
             "    y[(size_t)r * I + q] = xr[q];\n}\n",
             "    xr[q] = x[(size_t)r * I + q];\n  __syncthreads();\n  KB(1);\n"
             "  kb_rk_step(xr, xr, T.stages, d, c, p, xi, ks, ws);\n"
             "  for (int q = threadIdx.x; q < I; q += blockDim.x)\n"
             "    y[(size_t)r * I + q] = xr[q];\n  KB(7);\n  KB_WRITE();\n}\n"),
            ("float* dx, float* scratch, int n_slots, ChainDims d,\n"
             "                   StepTab T) {\n"
             "  extern __shared__ float smem[];\n",
             "float* dx, float* scratch, int n_slots, ChainDims d,\n"
             "                   StepTab T) {\n"
             "  extern __shared__ float smem[];\n  KB_START();\n"),
            ("    a.gy[q] = gy[(size_t)r * I + q];\n  }\n  __syncthreads();\n"
             "  kb_rk_step_adjoint(",
             "    a.gy[q] = gy[(size_t)r * I + q];\n  }\n  __syncthreads();\n"
             "  KB(1);\n  kb_rk_step_adjoint("),
            ("    dx[(size_t)r * I + q] = a.dx[q];\n}\n\n// K3b-m",
             "    dx[(size_t)r * I + q] = a.dx[q];\n  KB(12);\n  KB_WRITE();\n"
             "}\n\n// K3b-m"),
            KB_SUMS,
            ('extern "C" {\n', KB_READ),
        ]},
        {"K2f-m": FOUR_PHASE_K2FM, "K2b-m": FOUR_PHASE_K2BM}),
}

TWO_BARRIER_K2FM = ["set-up: constants, copies issued, walks, state",
                    "staging wait (cp.async, barrier)",
                    "layer 1: stage inputs, terms, partials",
                    "barrier after layer 1",
                    "layer 2: hidden values, terms, partials",
                    "barrier after layer 2", "step sum and store"]
TWO_BARRIER_K2BM = ["set-up: constants, copies issued, walks, loads",
                    "staging wait (cp.async, barrier)",
                    "rebuild: layer 1", "rebuild: barrier after layer 1",
                    "rebuild: layer 2", "rebuild: barrier after layer 2",
                    "seeds", "reverse: layer-2 VJP and gk record",
                    "reverse: barrier after layer 2",
                    "reverse: layer-1 VJP, dx and kbar",
                    "reverse: barrier after layer 1", "dx store",
                    "parameter sums (second launch, thread 0)"]
MID_STEP["two-barrier K2f-m and K2b-m"] = ({
    "kan_chain_block.cuh": [
        ('#include "kan_chain_warp.cuh"\n', KB_HEAD
         + "__device__ unsigned long long g_kbsum[16];\n"),
        ("k.part1, lane);\n  __syncthreads();\n",
         "k.part1, lane);\n  KB(2);\n  __syncthreads();\n  KB(3);\n"),
        ("k.part2, lane);\n  __syncthreads();\n}\n",
         "k.part2, lane);\n  KB(4);\n  __syncthreads();\n"
         "  KB(5);\n}\n"),
        ("    for (int s = 0; s < stages; ++s) a.kb[s * I + q] = c.b[s] * g;\n"
         "  }\n  __syncthreads();\n",
         "    for (int s = 0; s < stages; ++s) a.kb[s * I + q] = c.b[s] * g;\n"
         "  }\n  __syncthreads();\n  KB(6);\n"),
        ("warp, lane);\n    __syncthreads();\n    kb_layer_vjp<kCompact>(k.P1",
         "warp, lane);\n    KB(7);\n    __syncthreads();\n"
         "    KB(8);\n    kb_layer_vjp<kCompact>(k.P1"),
        ("warp, lane);\n    __syncthreads();\n  }\n}\n",
         "warp, lane);\n    KB(9);\n    __syncthreads();\n"
         "    KB(10);\n  }\n}\n"),
    ],
    "rk_fused.cu": [
        ("float* y, ChainDims d,\n                   StepTab T, KbPlan plan) "
         "{\n",
         "float* y, ChainDims d,\n                   StepTab T, KbPlan plan) "
         "{\n  KB_START();\n"),
        ("    kb_acc_set(acc, T.stages, I, q, q < KB_THREADS ? x0 : xr[q]);\n"
         "  kb_stage_wait();\n",
         "    kb_acc_set(acc, T.stages, I, q, q < KB_THREADS ? x0 : xr[q]);\n"
         "  KB(0);\n  kb_stage_wait();\n  KB(1);\n"),
        ("        kb_step_out<kCompact>(acc, k, I, T.stages, last, c, q);\n}\n",
         "        kb_step_out<kCompact>(acc, k, I, T.stages, last, c, q);\n"
         "  KB(6);\n  KB_WRITE();\n}\n"),
        ("                   StepTab T, KbPlan plan) {\n"
         "  // the row's first components load while the block sets up\n"
         "  const float* xr = x + (size_t)blockIdx.x * d.I;\n"
         "  const float* gyr",
         "                   StepTab T, KbPlan plan) {\n  KB_START();\n"
         "  // the row's first components load while the block sets up\n"
         "  const float* xr = x + (size_t)blockIdx.x * d.I;\n"
         "  const float* gyr"),
        ("    a.gy[q] = q < KB_THREADS ? g0 : gyr[q];\n  }\n"
         "  kb_stage_wait();\n",
         "    a.gy[q] = q < KB_THREADS ? g0 : gyr[q];\n  }\n  KB(0);\n"
         "  kb_stage_wait();\n  KB(1);\n"),
        ("    dx[(size_t)r * I + q] = a.dx[q];\n}\n\n// K3b-m",
         "    dx[(size_t)r * I + q] = a.dx[q];\n  KB(11);\n  KB_WRITE();\n"
         "}\n\n// K3b-m"),
        KB_SUMS,
        ('extern "C" {\n', KB_READ),
    ]},
    {"K2f-m": TWO_BARRIER_K2FM, "K2b-m": TWO_BARRIER_K2BM})

# K2f / K2b, the LV RK step and its adjoint (csrc/rk_fused.cu): stamps of
# the tag K2T, put into the step routines of the headers under K2_TRACE,
# which only the instrumented rk_fused.cu defines. A phase "stage s" holds
# stage s's share of thread 0's row (stage inputs apart).
K2_HEAD = "#define K2_TRACE\n" + stamp_head("g_k2tr", "K2T")
K2_MACRO = ("\n#ifdef K2_TRACE\n#define K2S(i) K2T(i)\n#else\n"
            "#define K2S(i) do { } while (0)\n#endif\n")
K2_STAGES = [f"stage {s + 1}" for s in range(7)]
ONE_THREAD_K2F = (["parameter staging", "stage inputs"]
                  + [f"evaluation, {s}" for s in K2_STAGES]
                  + ["step sum and store"])
ONE_THREAD_K2B = (["parameter staging", "rebuild: stage inputs and seeds"]
                  + [f"rebuild: evaluation, {s}" for s in K2_STAGES[:6]]
                  + [f"reverse: VJP and kbar, {s}" for s in K2_STAGES[:6]]
                  + ["barrier (the block's other rows)",
                     "parameter sums (in the launch)"])
STEP = {
    "one-thread K2f and K2b": ({
        "kan_chain.cuh": [
            ("#include <mutex>\n", "#include <mutex>\n" + K2_MACRO),
            ("    kc_chain_fwd(xi, d, p, y1, ks[s]);\n  }\n",
             "    K2S(1);\n    kc_chain_fwd(xi, d, p, y1, ks[s]);\n"
             "    K2S(2 + s);\n  }\n"),
            ("    y[q] = acc;\n  }\n}\n", "    y[q] = acc;\n  }\n  K2S(9);\n}\n"),
            ("    kc_chain_fwd(xs[s], d, p, y1s[s], ks[s]);\n",
             "    K2S(1);\n    kc_chain_fwd(xs[s], d, p, y1s[s], ks[s]);\n"
             "    K2S(2 + s);\n"),
            ("      for (int q = 0; q < d.I; ++q) kbar[j][q] = kbar[j][q] + "
             "a * dxi[q];\n    }\n  }\n}\n",
             "      for (int q = 0; q < d.I; ++q) kbar[j][q] = kbar[j][q] + "
             "a * dxi[q];\n    }\n    K2S(8 + s);\n  }\n}\n"),
        ],
        "rk_fused.cu": [
            ('#include "kan_chain_block.cuh"\n',
             K2_HEAD + '#include "kan_chain_block.cuh"\n'),
            ("  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, smem);\n"
             "  const int r = blockIdx.x * blockDim.x + threadIdx.x;\n"
             "  if (r < K) kc_rk_step_row(x + r * d.I, y + r * d.I, T, d, p);\n"
             "}\n",
             "  K2T_START();\n"
             "  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, smem);\n"
             "  K2T(0);\n"
             "  const int r = blockIdx.x * blockDim.x + threadIdx.x;\n"
             "  if (r < K) kc_rk_step_row(x + r * d.I, y + r * d.I, T, d, p);\n"
             "  K2T_WRITE();\n}\n"),
            ("  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, smem);\n"
             "  const RecLayout L = kc_rec_layout(d.I, d.H, d.O, d.G);\n"
             "  for (int r = threadIdx.x; r < K; r += blockDim.x)\n",
             "  K2T_START();\n"
             "  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, smem);\n"
             "  K2T(0);\n"
             "  const RecLayout L = kc_rec_layout(d.I, d.H, d.O, d.G);\n"
             "  for (int r = threadIdx.x; r < K; r += blockDim.x)\n"),
            ("  __syncthreads();\n  kc_reduce_param_grads(scratch, K * n_slots, "
             "d, L, dc1, dw1, dc2, dw2);\n}\n",
             "  __syncthreads();\n  K2T(14);\n"
             "  kc_reduce_param_grads(scratch, K * n_slots, "
             "d, L, dc1, dw1, dc2, dw2);\n  K2T(15);\n  K2T_WRITE();\n}\n"),
            ('extern "C" {\n', kc_read("k2tr_read", "g_k2tr")),
        ]},
        {"K2f": ONE_THREAD_K2F, "K2b": ONE_THREAD_K2B}),
}

WARP_K2F = (["parameters, constants and register slices", "stage inputs"]
            + [f"evaluation (kf_chain_fwd), {s}" for s in K2_STAGES]
            + ["step sum and store"])
WARP_K2B = (["set-up: parameters, constants, term table, barrier",
             "rebuild: stage inputs"]
            + [f"rebuild: evaluation with Jacobian, {s}"
               for s in K2_STAGES[:6]]
            + [f"reverse: VJP and kbar, {s}" for s in K2_STAGES[:6]]
            + ["seeds and dx store",
               "parameter sums (second launch, thread 0)"])
# K2f is K3f's kernel at one step; K2b's sums launch keeps thread 0's
# own cycles in g_k2sum
K2_SUM_READ = ("\nvoid k2sum_read(unsigned long long* out) {\n"
               "  cudaDeviceSynchronize();\n"
               "  cudaMemcpyFromSymbol(out, g_k2sum, sizeof(g_k2sum));\n}\n")
STEP["warp-a-row K2f (K3f at n = 1) and K2b (K3b's phases at n = 1)"] = ({
    "kan_chain_warp.cuh": [
        ('#pragma once\n\n#include "kan_chain.cuh"\n',
         '#pragma once\n\n#include "kan_chain.cuh"\n'
         + K2_MACRO.replace("K2S", "K2W")),
        ("      w.xs[s][lane] = v;\n    }\n    __syncwarp();\n",
         "      w.xs[s][lane] = v;\n    }\n    __syncwarp();\n    K2W(1);\n"),
        ("    __syncwarp();\n    ++slot;\n",
         "    __syncwarp();\n    K2W(2 + slot);\n    ++slot;\n"),
        ("    if (!c.needed[s]) continue;\n    --slot;\n",
         "    if (!c.needed[s]) continue;\n    --slot;\n"
         "    K2W(slot + 1 < slots ? 9 + slot : 14);\n"),
    ],
    "rk_fused.cu": [
        ('#include "kan_chain_block.cuh"\n',
         K2_HEAD + "__device__ unsigned long long g_k2sum[16];\n"
         + '#include "kan_chain_block.cuh"\n'),
        ("  kw_fill_consts(wc, d, T.stages, T.a, T.b, T.needed);\n",
         "  K2T_START();\n"
         "  kw_fill_consts(wc, d, T.stages, T.a, T.b, T.needed);\n"),
        ("  kf_load_regs(rg, p, d, lane);\n  __syncthreads();\n",
         "  kf_load_regs(rg, p, d, lane);\n  __syncthreads();\n  K2T(0);\n"),
        ("        xs[lane] = v;\n      }\n      __syncwarp();\n",
         "        xs[lane] = v;\n      }\n      __syncwarp();\n"
         "      K2T(1);\n"),
        ("      kf_chain_fwd(xs, ks + i * I, d, wc, s_l2h, p, rg, cw, lane);\n"
         "      __syncwarp();\n    }\n",
         "      kf_chain_fwd(xs, ks + i * I, d, wc, s_l2h, p, rg, cw, lane);\n"
         "      __syncwarp();\n      K2T(2 + i);\n    }\n"),
        ("      ys[((size_t)s * K + r) * I + lane] = y;\n      x = y;\n    }\n",
         "      ys[((size_t)s * K + r) * I + lane] = y;\n      x = y;\n    }\n"
         "    K2T(9);\n"),
        ("}\n\n// K3b: the rows in groups",
         "  K2T_WRITE();\n}\n\n// K3b: the rows in groups"),
        ("                       float* dx, float* scratch, int K, int n_slots,"
         "\n                       ChainDims d, StepTab T) {\n",
         "                       float* dx, float* scratch, int K, int n_slots,"
         "\n                       ChainDims d, StepTab T) {\n  K2T_START();\n"),
        ("  kw_fill_terms(c, d, w, lane);\n  __syncthreads();\n"
         "  const int r = blockIdx.x * warps + warp;\n",
         "  kw_fill_terms(c, d, w, lane);\n  __syncthreads();\n  K2T(0);\n"
         "  const int r = blockIdx.x * warps + warp;\n"),
        ("  xbar = kw_rk_step_reverse(xbar, T.stages, n_slots, d, c, L, w, "
         "lane, fac,\n                            rec);\n",
         "  xbar = kw_rk_step_reverse(xbar, T.stages, n_slots, d, c, L, w, "
         "lane, fac,\n                            rec);\n  K2T(8);\n"),
        ("  if (lane < d.I) dx[(size_t)r * d.I + lane] = xbar;\n}\n",
         "  if (lane < d.I) dx[(size_t)r * d.I + lane] = xbar;\n  K2T(14);\n"
         "  K2T_WRITE();\n}\n"),
        ("  extern __shared__ float srec[];\n",
         "  extern __shared__ float srec[];\n"
         "  const long long t0_ = clock64();\n"),
        ("  if (out != nullptr) *out = acc;\n}\n",
         "  if (out != nullptr) *out = acc;\n"
         "  if (threadIdx.x == 0 && blockIdx.x == 0) "
         "g_k2sum[0] = clock64() - t0_;\n}\n"),
        ('extern "C" {\n', kc_read("k2tr_read", "g_k2tr") + K2_SUM_READ),
    ]},
    {"K2f": WARP_K2F, "K2b": WARP_K2B})

# K3f-m / K3b-m (rk_fused.cu). The block-a-row design runs K2-m's
# routines of kan_chain_block.cuh, so it takes the two-barrier K2-m's
# stamps there (tag KB) and one more after kb_eval's stage-input pass
# (phase 13; with the K2f-m/K2b-m family asked too, K2-m's "layer 1" then
# leaves that pass out). Phase names "unused ..." are dropped.
UNUSED = [f"unused {i}" for i in range(16)]
BLOCK_K3FM = (["set-up: constants, copies issued, walks, state",
               "staging wait (cp.async, barrier)",
               "layer 1: terms and partials", "barrier after layer 1",
               "layer 2: hidden values, terms, partials",
               "barrier after layer 2", "step sum, store and barrier"]
              + UNUSED[7:13] + ["stage-input pass (running sums)"])
BLOCK_K3BM = (["set-up: constants, copies issued, walks",
               "staging wait (cp.async, barrier)",
               "rebuild: layer 1", "rebuild: barrier after layer 1",
               "rebuild: layer 2", "rebuild: barrier after layer 2",
               "seeds", "reverse: layer-2 VJP and gk record",
               "reverse: barrier after layer 2",
               "reverse: layer-1 VJP, dx and kbar",
               "reverse: barrier after layer 1",
               "step loads and barrier", "dx0 store",
               "rebuild: stage-input pass",
               "parameter sums (second launch, thread 0)"])
MID_MULTISTEP = {
    "block-a-row K3f-m and K3b-m (K2-m's routines)": ({
        "kan_chain_block.cuh": MID_STEP["two-barrier K2f-m and K2b-m"][0][
            "kan_chain_block.cuh"] + [
            ("  float* fac = keep && !kCompact\n",
             "  KB(13);\n  float* fac = keep && !kCompact\n")],
        "rk_fused.cu": [
            ("                        int n_steps, ChainDims d, StepTab T, "
             "KbPlan plan) {\n  KB_SETUP(0);\n",
             "                        int n_steps, ChainDims d, StepTab T, "
             "KbPlan plan) {\n  KB_START();\n  KB_SETUP(0);\n"),
            ("    kb_acc_set(acc, T.stages, I, q, x0[(size_t)r * I + q]);\n"
             "  kb_stage_wait();\n",
             "    kb_acc_set(acc, T.stages, I, q, x0[(size_t)r * I + q]);\n"
             "  KB(0);\n  kb_stage_wait();\n  KB(1);\n"),
            ("      kb_acc_set(acc, T.stages, I, q, y);\n    }\n"
             "    __syncthreads();\n  }\n}\n",
             "      kb_acc_set(acc, T.stages, I, q, y);\n    }\n"
             "    __syncthreads();\n    KB(6);\n  }\n  KB_WRITE();\n}\n"),
            ("                        int n_steps, int n_slots, ChainDims d, "
             "StepTab T,\n                        KbPlan plan) {\n",
             "                        int n_steps, int n_slots, ChainDims d, "
             "StepTab T,\n                        KbPlan plan) {\n"
             "  KB_START();\n"),
            ("  for (int q = threadIdx.x; q < I; q += KB_THREADS) a.dx[q] = "
             "0.0f;\n  kb_stage_wait();\n",
             "  for (int q = threadIdx.x; q < I; q += KB_THREADS) a.dx[q] = "
             "0.0f;\n  KB(0);\n  kb_stage_wait();\n  KB(1);\n"),
            ("      a.gy[q] = a.dx[q] + gys[((size_t)s * K + r) * I + q];\n"
             "    }\n    __syncthreads();\n",
             "      a.gy[q] = a.dx[q] + gys[((size_t)s * K + r) * I + q];\n"
             "    }\n    __syncthreads();\n    KB(11);\n"),
            ("    dx0[(size_t)r * I + q] = a.dx[q];\n}\n",
             "    dx0[(size_t)r * I + q] = a.dx[q];\n  KB(12);\n  KB_WRITE();\n"
             "}\n"),
            KB_SUMS,
            ('extern "C" {\n', KB_READ),
        ]},
        {"K3f-m": BLOCK_K3FM, "K3b-m": BLOCK_K3BM}),
}

# The shorter K3f-m evaluation and the three-phase K3b-m
# (kan_chain_multistep.cuh, launched from rk_fused.cu): stamps of the tag
# KMT into g_k3mtr, K3f-m and phase A in 0-9, phase B in 10-13, phase C1
# as thread 0's own cycles in 14 (the parameter sums are K2b's kernel,
# timed by the profiler); k3mtr_read zeroes them after reading.
KMT_HEAD = """
__device__ unsigned long long g_k3mtr[16];
__shared__ unsigned long long s_KMT[16];
__shared__ long long s_KMTt;
#define KMT_START() do { if (threadIdx.x == 0 && blockIdx.x == 0) { \\
  for (int i_ = 0; i_ < 16; ++i_) s_KMT[i_] = 0; s_KMTt = clock64(); } \\
  } while (0)
#define KMT(i) do { if (threadIdx.x == 0 && blockIdx.x == 0) { \\
  long long n_ = clock64(); s_KMT[i] += n_ - s_KMTt; s_KMTt = n_; } \\
  } while (0)
#define KMT_WRITE(lo, hi) do { if (threadIdx.x == 0 && blockIdx.x == 0) \\
  for (int i_ = (lo); i_ < (hi); ++i_) g_k3mtr[i_] = s_KMT[i_]; } while (0)
"""
KMT_READ = ('extern "C" {\n\nvoid k3mtr_read(unsigned long long* out) {\n'
            "  cudaDeviceSynchronize();\n"
            "  cudaMemcpyFromSymbol(out, g_k3mtr, sizeof(g_k3mtr));\n"
            "  static const unsigned long long zero[16] = {0};\n"
            "  cudaMemcpyToSymbol(g_k3mtr, zero, sizeof(zero));\n}\n")
SHORT_K3FM = ["set-up: constants, parameter registers, pads",
              "step start and barrier",
              "stage inputs, running sums, their features, barrier",
              "layer 1: dot products, group reductions, barrier",
              "hidden values' features and barrier",
              "layer 2: dot products, group reductions, barrier"]
THREE_PHASE_K3BM = (["A: " + n for n in SHORT_K3FM]
                    + ["A: stage factors A1, A2 and barrier",
                       "A: Jacobian block stores"] + UNUSED[8:10]
                    + ["B: set-up and first copies",
                       "B: step top: copies, seeds, wait",
                       "B: stage VJPs and kbar updates", "B: dx0 store",
                       "C1: dy1 of the records (thread 0's own cycles)"])
MID_MULTISTEP["three-phase K3b-m and the shorter K3f-m evaluation"] = ({
    "kan_chain_multistep.cuh": [
        ('#include "kan_chain_block.cuh"\n',
         '#include "kan_chain_block.cuh"\n' + KMT_HEAD),
    ],
    "rk_fused.cu": [
        ("               int n_steps, ChainDims d, StepTab T, KmPlan plan) {\n",
         "               int n_steps, ChainDims d, StepTab T, KmPlan plan) {\n"
         "  KMT_START();\n"),
        ("  km_step_start(rw, x0 + (size_t)r * d.I, d, S);\n"
         "  __syncthreads();\n",
         "  KMT(0);\n  km_step_start(rw, x0 + (size_t)r * d.I, d, S);\n"
         "  __syncthreads();\n  KMT(1);\n"),
        ("                               nullptr);\n"
         "      if (prev >= 0) par ^= 1;\n      __syncthreads();\n",
         "                               nullptr);\n"
         "      if (prev >= 0) par ^= 1;\n      __syncthreads();\n"
         "      KMT(2);\n"),
        ("      km_eval_l1(rw, rg, l1, c1, w1, d, plan);\n"
         "      __syncthreads();\n",
         "      km_eval_l1(rw, rg, l1, c1, w1, d, plan);\n"
         "      __syncthreads();\n      KMT(3);\n"),
        ("      km_features<false>(rw.y1, d.H, ft, d, k, rw.f2, nullptr, "
         "nullptr,\n                         nullptr, 0, 0);\n"
         "      __syncthreads();\n",
         "      km_features<false>(rw.y1, d.H, ft, d, k, rw.f2, nullptr, "
         "nullptr,\n                         nullptr, 0, 0);\n"
         "      __syncthreads();\n      KMT(4);\n"),
        ("      km_eval_l2(rw, rg, l2, c2, w2, d, plan);\n"
         "      __syncthreads();\n      prev = i;\n",
         "      km_eval_l2(rw, rg, l2, c2, w2, d, plan);\n"
         "      __syncthreads();\n      KMT(5);\n      prev = i;\n"),
        ("              ys + ((size_t)(n_steps - 1) * K + r) * d.I);\n}\n",
         "              ys + ((size_t)(n_steps - 1) * K + r) * d.I);\n"
         "  KMT_WRITE(0, 8);\n}\n"),
        ("                   StepTab T, KmPlan plan, KmBwdPlan bp) {\n",
         "                   StepTab T, KmPlan plan, KmBwdPlan bp) {\n"
         "  KMT_START();\n"),
        ("  km_step_start(rw, x_in, d, S);\n  __syncthreads();\n",
         "  KMT(0);\n  km_step_start(rw, x_in, d, S);\n"
         "  __syncthreads();\n  KMT(1);\n"),
        ("    km_input_features<true>(rw, par, prev, i, ft, d, k, S, nullptr, "
         "&kp);\n    if (prev >= 0) par ^= 1;\n    __syncthreads();\n",
         "    km_input_features<true>(rw, par, prev, i, ft, d, k, S, nullptr, "
         "&kp);\n    if (prev >= 0) par ^= 1;\n    __syncthreads();\n"
         "    KMT(2);\n"),
        ("    km_eval_l1(rw, rg, l1, c1, w1, d, plan);\n    __syncthreads();\n",
         "    km_eval_l1(rw, rg, l1, c1, w1, d, plan);\n    __syncthreads();\n"
         "    KMT(3);\n"),
        ("                      kp.L.swy1);\n    __syncthreads();\n",
         "                      kp.L.swy1);\n    __syncthreads();\n    KMT(4);\n"),
        ("    km_stage_factors(kp, c1, w1, c2, w2, d, a1, a2);\n"
         "    __syncthreads();\n",
         "    km_stage_factors(kp, c1, w1, c2, w2, d, a1, a2);\n"
         "    __syncthreads();\n    KMT(6);\n"),
        ("jb + (size_t)slot * bp.jw);\n",
         "jb + (size_t)slot * bp.jw);\n    KMT(7);\n"),
        ("    km_eval_l2(rw, rg, l2, c2, w2, d, plan);\n"
         "    __syncthreads();\n  }\n}\n",
         "    km_eval_l2(rw, rg, l2, c2, w2, d, plan);\n"
         "    __syncthreads();\n    KMT(5);\n  }\n  KMT_WRITE(0, 8);\n}\n"),
        ("                      ChainDims d, StepTab T, KmBwdPlan bp) {\n",
         "                      ChainDims d, StepTab T, KmBwdPlan bp) {\n"
         "  KMT_START();\n"),
        ("  float lam = 0.0f;\n  int par = 0;\n",
         "  float lam = 0.0f;\n  KMT(10);\n  int par = 0;\n"),
        ("    km_cp_wait<1>();\n    __syncwarp();\n",
         "    km_cp_wait<1>();\n    __syncwarp();\n    KMT(11);\n"),
        ("    __syncwarp();                  // before a copy refills this "
         "buffer\n",
         "    KMT(12);\n    __syncwarp();                  // before a copy "
         "refills this buffer\n"),
        ("  if (mine) dx0[(size_t)r * I + lane] = lam;\n}\n",
         "  if (mine) dx0[(size_t)r * I + lane] = lam;\n  KMT(13);\n"
         "  KMT_WRITE(10, 14);\n}\n"),
        ("                       ChainDims d, StepTab T, KmBwdPlan bp) {\n",
         "                       ChainDims d, StepTab T, KmBwdPlan bp) {\n"
         "  KMT_START();\n"),
        ("  km_cp_commit();\n  int par = 0;\n",
         "  km_cp_commit();\n  KMT(10);\n  int par = 0;\n"),
        ("    km_cp_wait<1>();\n    const float* base",
         "    km_cp_wait<1>();\n    KMT(11);\n    const float* base"),
        ("    __syncthreads();               // before a copy refills this "
         "step's buffer\n",
         "    KMT(12);\n    __syncthreads();               // before a copy "
         "refills this step's buffer\n"),
        ("  for (int e = tid; e < nx; e += nt) dx0[(size_t)r * I + nt + e] = "
         "xl[e];\n}\n",
         "  for (int e = tid; e < nx; e += nt) dx0[(size_t)r * I + nt + e] = "
         "xl[e];\n  KMT(13);\n  KMT_WRITE(10, 14);\n}\n"),
        ("  const long long e = (long long)blockIdx.x * KM_C_THREADS + "
         "threadIdx.x;\n",
         "  const long long t0_ = clock64();\n"
         "  const long long e = (long long)blockIdx.x * KM_C_THREADS + "
         "threadIdx.x;\n"),
        ("  rec[L.dy1 + h] = s;\n}\n",
         "  rec[L.dy1 + h] = s;\n  if (threadIdx.x == 0 && blockIdx.x == 0) "
         "g_k3mtr[14] = clock64() - t0_;\n}\n"),
        ('extern "C" {\n', KMT_READ),
    ]},
    {"K3f-m": SHORT_K3FM, "K3b-m": THREE_PHASE_K3BM})

# K1f / K1b, the standalone chain and its VJP (csrc/kan_chain_apply.cu):
# stamps of the tag K1T in that file only. The one-thread design's chain
# routines are spelled out at the call, so that its layers count apart.
K1_HEAD = '#include "kan_chain.cuh"\n' + stamp_head("g_k1tr", "K1T")
ONE_THREAD_K1F = ["parameter staging", "layer 1 (kc_layer_fwd)",
                  "layer 2 (kc_layer_fwd)", "y1 and y stores"]
ONE_THREAD_K1B = ["parameter staging", "layer-2 VJP (kc_layer_bwd_dx)",
                  "layer-1 VJP (kc_layer_bwd_dx)", "record stores (dy1, gk)",
                  "barrier (the block's other rows)",
                  "parameter sums (in the launch)"]
CHAIN_APPLY = {
    "one-thread K1f and one-block K1b": ({
        "kan_chain_apply.cu": [
            ('#include "kan_chain.cuh"\n', K1_HEAD),
            ("                       int K, ChainDims d) {\n",
             "                       int K, ChainDims d) {\n  K1T_START();\n"),
            ("  const int r = blockIdx.x * blockDim.x + threadIdx.x;\n"
             "  if (r >= K) return;\n  float h[KC_MAX_H], out[KC_MAX_I];\n"
             "  kc_chain_fwd(x + (size_t)r * d.I, d, p, h, out);\n",
             "  K1T(0);\n"
             "  const int r = blockIdx.x * blockDim.x + threadIdx.x;\n"
             "  if (r >= K) return;\n  float h[KC_MAX_H], out[KC_MAX_I];\n"
             "  kc_layer_fwd(x + (size_t)r * d.I, d.I, d.H, p.c1, p.w1, d, "
             "h);\n  K1T(1);\n"
             "  kc_layer_fwd(h, d.H, d.O, p.c2, p.w2, d, out);\n  K1T(2);\n"),
            ("  for (int o = 0; o < d.O; ++o) y[(size_t)r * d.O + o] = "
             "out[o];\n}\n",
             "  for (int o = 0; o < d.O; ++o) y[(size_t)r * d.O + o] = "
             "out[o];\n  K1T(3);\n  K1T_WRITE();\n}\n"),
            ("                       ChainDims d) {\n",
             "                       ChainDims d) {\n  K1T_START();\n"),
            ("  for (int r = threadIdx.x; r < K; r += blockDim.x)\n"
             "    kc_chain_vjp(x + (size_t)r * d.I, y1 + (size_t)r * d.H,\n"
             "                 gy + (size_t)r * d.O, d, p, L, dx + (size_t)r "
             "* d.I,\n                 scratch + (size_t)r * L.width);\n"
             "  __syncthreads();\n"
             "  kc_reduce_param_grads(scratch, K, d, L, dc1, dw1, dc2, dw2);\n"
             "}\n",
             "  K1T(0);\n"
             "  for (int r = threadIdx.x; r < K; r += blockDim.x) {\n"
             "    float dy1_[KC_MAX_H];\n"
             "    float* rec_ = scratch + (size_t)r * L.width;\n"
             "    kc_layer_bwd_dx(y1 + (size_t)r * d.H, d.H, d.O, p.c2, p.w2, "
             "d,\n                    gy + (size_t)r * d.O, dy1_, rec_ + L.b2,"
             " rec_ + L.swy1);\n    K1T(1);\n"
             "    kc_layer_bwd_dx(x + (size_t)r * d.I, d.I, d.H, p.c1, p.w1, "
             "d, dy1_,\n                    dx + (size_t)r * d.I, rec_ + "
             "L.b1, rec_ + L.swx);\n    K1T(2);\n"
             "    for (int h = 0; h < d.H; ++h) rec_[L.dy1 + h] = dy1_[h];\n"
             "    for (int o = 0; o < d.O; ++o) rec_[L.gk + o] = "
             "gy[(size_t)r * d.O + o];\n    K1T(3);\n  }\n"
             "  __syncthreads();\n  K1T(4);\n"
             "  kc_reduce_param_grads(scratch, K, d, L, dc1, dw1, dc2, dw2);\n"
             "  K1T(5);\n  K1T_WRITE();\n}\n"),
            ('extern "C" {\n', kc_read("k1tr_read", "g_k1tr")),
        ]},
        {"K1f": ONE_THREAD_K1F, "K1b": ONE_THREAD_K1B}),
}
WARP_K1F = ["set-up: x, copies issued, grid, layer-2 table",
            "staging wait (cp.async, barrier)",
            "term table, register slices, barrier",
            "evaluation (kf_chain_fwd) and the y1, y stores"]
WARP_K1B = ["set-up: row loads, copies issued, grid",
            "staging wait (cp.async, barrier)", "term table, barrier",
            "layer-1 terms of x (values, slopes)",
            "layer 2 in lane h: terms of y1 and dy1",
            "layer-1 VJP terms", "dx (lane i)",
            "barrier before the cotangents (K = 1)",
            "cotangents in the launch (K = 1)"]
BLOCK_K1FM = ["set-up: grid, copies issued, walks, x",
              "staging wait (cp.async, barrier)",
              "layer 1: terms and partials", "barrier after layer 1",
              "y1 and layer 2: hidden values, terms, partials",
              "barrier after layer 2", "y stores"]
BLOCK_K1BM = ["set-up: grid, copies issued, walks, row loads",
              "staging wait (cp.async, barrier)",
              "terms of both layers (values, slopes)",
              "barrier after the terms", "layer-2 VJP (dy1)",
              "barrier after layer 2", "layer-1 VJP (dx)"]
# (the sums launch at K > 1, K2b's rk_param_sums_kernel, is not stamped:
# compare_trees times it by kernel)
CHAIN_APPLY["warp-a-row K1f/K1b and block-a-row K1f-m/K1b-m"] = ({
    "kan_chain_apply.cu": [
        ('#include "kan_chain_block.cuh"\n',
         '#include "kan_chain_block.cuh"\n' + stamp_head("g_k1tr", "K1T")),
        ("                       int K, int rows, ChainDims d) {\n",
         "                       int K, int rows, ChainDims d) {\n"
         "  K1T_START();\n"),
        ("  kf_fill_l2(s_l2h, d);\n  kb_stage_wait();\n",
         "  kf_fill_l2(s_l2h, d);\n  K1T(0);\n  kb_stage_wait();\n"
         "  K1T(1);\n"),
        ("  kf_load_regs(rg, p, d, lane);\n  __syncthreads();\n",
         "  kf_load_regs(rg, p, d, lane);\n  __syncthreads();\n  K1T(2);\n"),
        ("                     lane, y1 + (size_t)r * d.H);\n}\n",
         "                     lane, y1 + (size_t)r * d.H);\n  K1T(3);\n"
         "  K1T_WRITE();\n}\n"),
        ("                       int rows, int direct, ChainDims d) {\n",
         "                       int rows, int direct, ChainDims d) {\n"
         "  K1T_START();\n"),
        ("  k1_fill_grid(wc, d);\n  kb_stage_wait();\n"
         "  for (int l = threadIdx.x; l < IG + I; l += blockDim.x) {\n"
         "    wc.term_x[l] = l < IG ? l / G : l - IG;\n",
         "  k1_fill_grid(wc, d);\n  K1T(0);\n  kb_stage_wait();\n  K1T(1);\n"
         "  for (int l = threadIdx.x; l < IG + I; l += blockDim.x) {\n"
         "    wc.term_x[l] = l < IG ? l / G : l - IG;\n"),
        ("  __syncthreads();\n  if (mine) {\n",
         "  __syncthreads();\n  K1T(2);\n  if (mine) {\n"),
        ("    // layer 2 in lane h: its terms of y1_h, then the VJP\n",
         "    K1T(3);\n    // layer 2 in lane h: its terms of y1_h, then the "
         "VJP\n"),
        ("    if (lane < O) rec[L.gk + lane] = g[lane];\n    __syncwarp();\n",
         "    if (lane < O) rec[L.gk + lane] = g[lane];\n    __syncwarp();\n"
         "    K1T(4);\n"),
        ("      tw[l] = l < IG ? m * t1[l] : m;\n    }\n    __syncwarp();\n",
         "      tw[l] = l < IG ? m * t1[l] : m;\n    }\n    __syncwarp();\n"
         "    K1T(5);\n"),
        ("          acc * t1[IG + lane] + tw[IG + lane] * ws[W.dsx + lane];\n"
         "    }\n  }\n  if (!direct) return;\n  __syncthreads();\n"
         "  kc_reduce_param_grads(s_rec, 1, d, L, dc1, dw1, dc2, dw2);\n}\n",
         "          acc * t1[IG + lane] + tw[IG + lane] * ws[W.dsx + lane];\n"
         "    }\n    K1T(6);\n  }\n  if (!direct) {\n    K1T_WRITE();\n"
         "    return;\n  }\n  __syncthreads();\n  K1T(7);\n"
         "  kc_reduce_param_grads(s_rec, 1, d, L, dc1, dw1, dc2, dw2);\n"
         "  K1T(8);\n  K1T_WRITE();\n}\n"),
        ("                           float* y1, ChainDims d, KbPlan plan) {\n",
         "                           float* y1, ChainDims d, KbPlan plan) {\n"
         "  K1T_START();\n"),
        ("    xs[q] = x[(size_t)r * I + q];\n  kb_stage_wait();\n"
         "  kb_layer_fwd(",
         "    xs[q] = x[(size_t)r * I + q];\n  K1T(0);\n  kb_stage_wait();\n"
         "  K1T(1);\n  kb_layer_fwd("),
        ("               k.part1, lane);\n  __syncthreads();\n",
         "               k.part1, lane);\n  K1T(2);\n  __syncthreads();\n"
         "  K1T(3);\n"),
        ("               k.part2, lane);\n  __syncthreads();\n",
         "               k.part2, lane);\n  K1T(4);\n  __syncthreads();\n"
         "  K1T(5);\n"),
        ("    y[(size_t)r * O + o] = kb_part_sum<kCompact>(k.part2, plan.f2.C, "
         "O, o);\n}\n",
         "    y[(size_t)r * O + o] = kb_part_sum<kCompact>(k.part2, plan.f2.C, "
         "O, o);\n  K1T(6);\n  K1T_WRITE();\n}\n"),
        ("                           float* scratch, ChainDims d, KbPlan plan) "
         "{\n",
         "                           float* scratch, ChainDims d, KbPlan plan) "
         "{\n  K1T_START();\n"),
        ("    rec[L.gk + o] = v;\n  }\n  kb_stage_wait();\n",
         "    rec[L.gk + o] = v;\n  }\n  K1T(0);\n  kb_stage_wait();\n"
         "  K1T(1);\n"),
        ("      fac[t] = fc;\n    }\n  }\n  __syncthreads();\n",
         "      fac[t] = fc;\n    }\n  }\n  K1T(2);\n  __syncthreads();\n"
         "  K1T(3);\n"),
        ("                         warp, lane);\n  __syncthreads();\n"
         "  kb_layer_vjp<kCompact>(k.P1",
         "                         warp, lane);\n  K1T(4);\n"
         "  __syncthreads();\n  K1T(5);\n  kb_layer_vjp<kCompact>(k.P1"),
        ("                         [&](int q, float v) { dx[(size_t)r * I + q]"
         " = v; },\n                         warp, lane);\n}\n",
         "                         [&](int q, float v) { dx[(size_t)r * I + q]"
         " = v; },\n                         warp, lane);\n  K1T(6);\n"
         "  K1T_WRITE();\n}\n"),
        ('extern "C" {\n', kc_read("k1tr_read", "g_k1tr")),
    ]},
    {"K1f": WARP_K1F, "K1b": WARP_K1B, "K1f-m": BLOCK_K1FM,
     "K1b-m": BLOCK_K1BM})

FAMILIES = {"K5b/K7b": GRAY_WIDE, "K3b/K4b": LV_ADJOINTS,
            "K4f/K8b": ADAPTIVE_FWD_MEMBERS_BWD,
            "K3f/K8f": LV_FIXED_MEMBERS_FWD, "K2f-m/K2b-m": MID_STEP,
            "K3f-m/K3b-m": MID_MULTISTEP, "K1f/K1b": CHAIN_APPLY,
            "K2f/K2b": STEP}
# family -> the kernels (parts of their names) whose ptxas usage is shown
PTXAS_OF = {"K5b/K7b": ("gb_bwd_kernel", "wd_bwd_kernel"),
            "K3b/K4b": ("rk_multistep_bwd_kernel", "adaptive_bwd_kernel"),
            "K4f/K8b": ("adaptive_fwd_kernel", "members_bwd"),
            "K3f/K8f": ("rk_multistep_fwd_kernel", "members_fwd_kernel"),
            "K2f-m/K2b-m": ("kb_step_fwd_kernel", "kb_step_bwd_kernel",
                            "kb_param_sums_kernel"),
            "K2f/K2b": ("rk_step_fwd_kernel", "rk_step_bwd_kernel",
                        "rk_multistep_fwd_kernel", "rk_step_adjoint_kernel",
                        "rk_param_sums_kernel"),
            "K3f-m/K3b-m": ("kb_multistep_fwd_kernel",
                            "kb_multistep_bwd_kernel", "kb_param_sums_kernel",
                            "k3m_", "rk_param_sums_kernel"),
            "K1f/K1b": ("chain_apply_", "rk_param_sums_kernel")}

RUN = r"""
import ctypes, json, sys
import numpy as np
import torch
import chip_smoke as cs
from kanodes_tpu_torch.ops import _cuda
from kanodes_tpu_torch.ops import graybox_fused as gb
from kanodes_tpu_torch.ops import kdense_pallas as kp
from kanodes_tpu_torch.ops import rk_fused_wide as tw
from kanodes_tpu_torch.utils.precision import set_exact_f32
names = json.loads(sys.argv[1])
set_exact_f32()
lib = _cuda.library()

def read(fn):
    out = (ctypes.c_ulonglong * 16)()
    fn(out)
    return list(out)
""" + LV_ADJOINT_INPUTS + ADAPTIVE_INPUTS + """
def emit(kernel, case, cyc):
    cyc = cyc[:len(names[kernel])]
    print(json.dumps({"kernel": kernel, "case": case,
                      "cycles": {n: c for n, c in zip(names[kernel], cyc)
                                 if not n.startswith("unused")},
                      "total": sum(cyc)}), flush=True)

if "K5b" in names:
    for i in (0, 1, 6, 7):
        case = cs.GRAYBOX_CASES[i]
        spec, kron, u, lap, c, w, gy = cs.graybox_case_inputs(torch, gb,
                                                              case)
        st = (spec, case.solver, case.dt, case.D)
        for _ in range(3):
            gb._launch_bwd(*st, u, lap, c, w, gy, kron)
        emit("K5b", case.label, read(lib.gb_trace_read))
if "K7b" in names:
    for i in (6, 9):
        case = cs.WIDE_CASES[i]
        ws, pp, x0, gys = cs.wide_case_inputs(torch, tw, kp, case)
        k = tw._consts(ws, case.solver, case.dt)
        ys = tw._launch_multistep_fwd(k, case.n, x0, pp)
        tw._launch_multistep_bwd(k, case.n, x0, ys, pp, gys)
        emit("K7b", case.label, read(lib.wd_trace_read))
if "K3b" in names:
    k3b, k4b, stats = lv_adjoint_launches(torch, np, cs)
    for _ in range(3):
        k3b()
    emit("K3b", "n=34 K=1 tsit5 [2,10,2] G=5", read(lib.kc3_trace_read))
    for _ in range(3):
        k4b()
    emit("K4b", f"T=35 K=1 tsit5 LV defaults, seeded init, stats {stats}",
         read(lib.kc4_trace_read))
if "K4f" in names:
    k4f = lv_adaptive_launch(torch, np, cs)
    for _ in range(3):
        k4f()
    emit("K4f", "T=35 K=1 tsit5 LV defaults, seeded init",
         read(lib.k4f_trace_read))
if "K3f" in names:
    k3f = lv_fixed_launch(torch, np, cs, 34)
    for _ in range(3):
        k3f()
    emit("K3f", "n=34 K=1 tsit5 LV defaults, seeded init",
         read(lib.k3f_trace_read))
if "K8f" in names:
    k8f = members_fwd_launch(torch, np, cs)
    for _ in range(3):
        k8f()
    emit("K8f", "MEMBERS_CASES[0]: 8 LV members [16,80,16] G=5 at the "
         "init, T=35", read(lib.k8f_trace_read))
if "K2f-m" in names:
    from kanodes_tpu_torch.ops import rk_fused as rk
    by_label = {c.label: c for c in cs.MID_CASES}
    for label in ("burgers K2 K=1", "allen_cahn K2 K=1", "burgers K2 K=4",
                  "packed K2 K=34"):
        case = by_label[label]
        spec, x, params = cs.mid_case_inputs(torch, kp, case, 90)
        k = rk._consts(spec, "tsit5", case.dt)
        gy = torch.tensor(np.random.default_rng(0).standard_normal(
            tuple(x.shape)), dtype=torch.float32, device="cuda")
        for _ in range(3):
            rk._launch_step_fwd(k, x, params)
        emit("K2f-m", label, read(lib.kbtr_read))
        for _ in range(3):
            rk._launch_step_bwd(k, x, params, gy)
        emit("K2b-m", label, read(lib.kbtr_read)[:len(names["K2b-m"]) - 1]
             + read(lib.kbsum_read)[:1])
if "K3f-m" in names:
    from kanodes_tpu_torch.ops import rk_fused as rk
    by_label = {c.label: c for c in cs.MID_CASES}
    # the block-a-row design counts in K2-m's KB stamps, the three-phase
    # one in its own (k3mtr_read: K3f-m, or K3b-m's phases A and B)
    three = hasattr(lib, "k3mtr_read")
    for label in ("packed K3 n=34 K=1", "burgers K3 n=180 K=1"):
        case = by_label[label]
        spec, x, params = cs.mid_case_inputs(torch, kp, case, 90)
        k = rk._consts(spec, "tsit5", case.dt)
        for _ in range(3):
            ys = rk._launch_multistep_fwd(k, case.n, x, params)
        emit("K3f-m", label, read(lib.k3mtr_read if three else lib.kbtr_read))
        gys = torch.tensor(np.random.default_rng(1).standard_normal(
            tuple(ys.shape)) / case.n, dtype=torch.float32, device="cuda")
        for _ in range(3):
            rk._launch_multistep_bwd(k, case.n, x, ys, params, gys)
        if three:
            cyc = read(lib.k3mtr_read)
        else:
            cyc = read(lib.kbtr_read)[:14] + read(lib.kbsum_read)[:1]
        emit("K3b-m", label, cyc)
if "K2f" in names:
    from kanodes_tpu_torch.models.kdense import KANChain
    from kanodes_tpu_torch.ops import rk_fused as rk
    spec = kp.chain_spec_of(KANChain.mlp_like([2, 10, 2], grid_len=5))
    k = rk._consts(spec, "tsit5", 0.1)
    # the design that sums in a second launch names that phase last
    two = names["K2b"][-1].startswith("parameter sums (second launch")
    for K in (34, 31):
        x, params = cs.lv_inputs(np.random.default_rng(0), torch, K)
        gy = torch.tensor(np.random.default_rng(1).standard_normal((K, 2)),
                          dtype=torch.float32, device="cuda")
        case = f"K={K} tsit5 [2,10,2] G=5, chip_smoke.lv_inputs"
        for _ in range(3):
            rk._launch_step_fwd(k, x, params)
        emit("K2f", case, read(lib.k2tr_read))
        for _ in range(3):
            rk._launch_step_bwd(k, x, params, gy)
        cyc = read(lib.k2tr_read)
        if two:
            cyc = cyc[:15] + read(lib.k2sum_read)[:1]
        emit("K2b", case, cyc)
if "K1f" in names:
    from kanodes_tpu_torch.models.kdense import KANChain
    spec = kp.chain_spec_of(KANChain.mlp_like([2, 10, 2], grid_len=5))
    cases = []
    for K in (34, 1):
        x, params = cs.lv_inputs(np.random.default_rng(0), torch, K)
        cases.append((f"K={K} [2,10,2] G=5 rbf/tanh, chip_smoke.lv_inputs",
                      spec, x, params))
    if "K1f-m" in names:                     # a tree with K1's medium
        case = {c.label: c for c in cs.MID_CASES}["packed K2 K=34"]
        pspec, x, params = cs.mid_case_inputs(torch, kp, case, 90)
        for K in (1, 34):
            cases.append((f"K={K} packed [16,80,16] G=5 iqf/tanh, "
                          f"chip_smoke.mid_case_inputs", pspec,
                          x[:K].contiguous(), params))
    for label, sp, x, params in cases:
        mid = "-m" if "K1f-m" in names and \
            _cuda.chain_apply_flavor(sp) == "medium" else ""
        gy = torch.tensor(np.random.default_rng(1).standard_normal(
            (x.shape[0], sp.out_dims)), dtype=torch.float32, device="cuda")
        for _ in range(3):
            y, y1 = kp._launch_fwd(sp, x, params)
        emit("K1f" + mid, label, read(lib.k1tr_read))
        for _ in range(3):
            kp._launch_bwd(sp, x, y1, params, gy)
        emit("K1b" + mid, label, read(lib.k1tr_read))
if "K8b" in names:
    k8b, n_it = members_bwd_launch(torch, np, cs)
    for _ in range(3):
        k8b()
    emit("K8b", f"MEMBERS_CASES[0]: 8 LV members [16,80,16] G=5 at the "
         f"init, T=35, {n_it} iterations", read(lib.k8b_trace_read))
"""


def instrument(csrc: str, families) -> tuple[list, dict]:
    """Insert, for each family, the stamps of the design whose code csrc
    holds; returns the designs' names and every kernel's phase names."""
    designs, names = [], {}
    for family in families:
        for name, (edits, phases) in FAMILIES[family].items():
            texts = {f: open(os.path.join(csrc, f)).read() for f in edits
                     if os.path.exists(os.path.join(csrc, f))}
            # an edit another family already made (the same stamps in a
            # shared header) is made once
            if len(texts) == len(edits) and all(
                    all(old in t or new in t for old, new in edits[f])
                    for f, t in texts.items()):
                for f, pairs in edits.items():
                    t = texts[f]
                    for old, new in pairs:
                        if new not in t:
                            t = t.replace(old, new, 1)
                    with open(os.path.join(csrc, f), "w") as out:
                        out.write(t)
                designs.append(name)
                names.update(phases)
                break
        else:
            raise SystemExit(f"trace_phases: the {family} kernels in {csrc} "
                             f"match no known design "
                             f"({', '.join(FAMILIES[family])})")
    return designs, names


def trace(root: str, families=tuple(FAMILIES)) -> list[dict]:
    root = os.path.abspath(root)
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(os.path.join(root, "kanodes_tpu_torch"),
                        os.path.join(tmp, "kanodes_tpu_torch"),
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
        designs, names = instrument(
            os.path.join(tmp, "kanodes_tpu_torch", "csrc"), families)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join((tmp, root)))
        proc = subprocess.run([sys.executable, "-c", RUN,
                               json.dumps(names)], cwd=tmp, env=env,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"{root}: traced run failed:\n"
                               f"{proc.stderr[-4000:]}")
    return [dict(json.loads(ln), root=root, designs=designs)
            for ln in proc.stdout.strip().splitlines()]


def build_report(root: str) -> tuple[dict, dict]:
    """ROOT's own (uninstrumented) build: per kernel, the registers, stack
    frame and spill bytes of nvcc's `-Xptxas -v` output with the count of
    its SASS instructions, and a digest of its SASS (`cuobjdump -sass`,
    the instructions' text only)."""
    from kanodes_tpu_torch.ops._cuda import _nvcc, kernel_key, ptxas_usage
    code = ("import json; from kanodes_tpu_torch.ops import _cuda; "
            "path, log = _cuda.build(); print(json.dumps([str(path), log]))")
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(os.path.join(root, "kanodes_tpu_torch"),
                        os.path.join(tmp, "kanodes_tpu_torch"),
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
        proc = subprocess.run([sys.executable, "-c", code], cwd=tmp,
                              env=dict(os.environ, PYTHONPATH=tmp),
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"{root}: build failed:\n"
                               f"{proc.stderr[-4000:]}")
        path, log = json.loads(proc.stdout.strip().splitlines()[-1])
        cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", path],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
    digests, sizes = {}, {}
    for part in sass.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        # the instructions without their addresses and encodings (the
        # encodings carry relocated fields that differ between builds)
        text = "\n".join(
            re.sub(r"^\s*/\*[0-9a-f]+\*/\s*", "", ln).split(";")[0]
            for ln in body.splitlines()
            if re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln))
        digests[kernel_key(name.strip())] = hashlib.sha256(
            text.encode()).hexdigest()[:16]
        sizes[name.strip()] = text.count("\n") + 1
    usage = ptxas_usage(log)
    for k, v in usage.items():
        if k in sizes:
            v["sass_instructions"] = sizes[k]
    return usage, digests


def main(argv: list[str]) -> int:
    families = tuple(FAMILIES)
    roots, report = [], None
    for a in argv:
        if a.startswith("--kernels="):
            families = tuple(a.split("=", 1)[1].split(","))
        elif a.startswith("--report="):
            report = tuple(a.split("=", 1)[1].split(","))
        else:
            roots.append(a)
    if not roots or not set(families) <= set(FAMILIES):
        raise SystemExit(f"usage: trace_phases "
                         f"[--kernels={','.join(FAMILIES)} | "
                         f"--report=NAME[,NAME]] ROOT [ROOT ...]")
    if report is not None:    # no traced run: the builds' report only
        families = ()
    names = report or tuple(n for f in families for n in PTXAS_OF[f])
    reports = {}
    for root in roots:
        for line in trace(root, families) if families else ():
            print(json.dumps(line), flush=True)
        usage, digests = build_report(os.path.abspath(root))
        reports[root] = digests
        print(json.dumps({"root": os.path.abspath(root), "ptxas": {
            k: v for k, v in usage.items() if any(n in k for n in names)}}),
            flush=True)
    if len(roots) > 1:
        # kernels whose SASS differs from the first root's (or is new)
        first = reports[roots[0]]
        for root in roots[1:]:
            print(json.dumps({"root": os.path.abspath(root),
                              "sass_differs_from_first_root": sorted(
                                  k for k, v in reports[root].items()
                                  if first.get(k) != v),
                              "sass_same": sorted(
                                  k for k, v in reports[root].items()
                                  if first.get(k) == v)}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                           "clocks.max.sm", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
