// K2 at medium widths: one explicit RK step over the 2-layer KDense
// chain and its discrete adjoint, with ONE BLOCK ON EACH ROW of the batch,
// for chains past the one-thread / one-warp caps of kan_chain.cuh (I, O
// <= 8, H <= 32): the Burgers and 1-D Allen-Cahn surrogates [41, 10, 41]
// (grid 5 and 10) and the packed 8-member LV ensemble [16, 80, 16] (grid
// 5). rk_fused.cu launches them. K3 at these widths (n steps, and their
// adjoint) runs kan_chain_multistep.cuh, which includes this file.
//
// Computes what `_step_fwd_kernel` and `_step_bwd_kernel`
// (kanodes_tpu/ops/rk_fused.py:144,167) compute, with the chain of
// `_chain_f` / `_chain_vjp` / `_chain_param_gemms` (:70-127).
//
// What bounds it on this card: latency. A row is a chain of s dependent
// chain evaluations a step (tsit5: 6); one evaluation at [41, 10, 41] G = 5
// is ~5e4 flops over 20 KB of parameters, far below a microsecond of the
// card's rates. Rows are few (K <= 34 on the reference paths) and wide, so
// the work of an evaluation is spread over a block of KB_THREADS threads.
// This file's first design spent ~6.7k cycles an evaluation, two thirds
// of it in warps reducing one row at a time (a five-level shuffle tree a
// row, six rounds at 41 rows) between four block barriers, and a sixth of
// a launch in staging the parameters with a division an element (PERF.md,
// the K2f-m/K2b-m trace).
//
// What the design does about it:
//   * staging: the parameters in their own row-major order, rows [I G + I]
//     of [c1 ; w1] and [H G + H] of [c2 ; w2], each row padded to an odd
//     stride so that 32 lanes on 32 consecutive terms hit 32 banks; copied
//     with cp.async a thread an element in order, the next element's row
//     and column stepped without division, while the block sets up;
//   * forward, two block barriers an evaluation: a layer's terms (basis
//     values B((norm(v_i) - grid_g) / h), l = i G + g, then swish(v_i)) are
//     cut into C chunks and its rows into R groups (C R = 8 warps, chosen
//     per layer by kb_split_of). A warp's lanes each take every 32nd term of
//     its chunk, compute the term's value in registers (one exponential and
//     one division for either kind of term, so a warp holding both runs
//     them once; the stage input folded into layer 1's read, the hidden
//     value summed from layer 1's partials in layer 2's), multiply it into
//     16 rows at once, and one transpose-reduce (four exchange levels and
//     a pair sum) gives lanes 2r, 2r + 1 the warp's sum of row r. The warp
//     writes it as the chunk's partial; the layer's consumer adds the C
//     partials as a fixed tree. A stage's k stays as partials; the stage
//     inputs are running sums that take each k once it is complete;
//   * adjoint: the stages rebuilt with the forward's routine (so its stages
//     equal K2f-m's bit for bit), which also keeps each term's value in the
//     stage's record and its VJP factor (B'(u)/h, or swish'(v)) in shared
//     memory; then, per stage from the last, two block barriers: warp w
//     takes the inputs [w per, (w + 1) per) of a layer with their G + 1
//     terms each (unit-major); S lanes share a term, each summing every
//     S-th row of M^T gout, then an xor shuffle, times the term's factor;
//     the warp gathers its terms in shared memory and a lane an input forms
//     dy1 (layer 2) or dx_s (layer 1: dx and the earlier stages' kbar
//     updated by the input's owner). One record a (step, row, stage) holds
//     the operands of the parameter cotangents (kc_rec_layout: b1, swx,
//     dy1, b2, swy1, gk);
//   * shared memory: the reverse sweep's stage cotangents, dy1 and VJP
//     terms take the place of the partials and running stage inputs, which
//     the rebuild no longer needs. A chain whose adjoint does not fit so
//     takes the compact layout (kb_compact, a template argument of the
//     kernels): the parameters at their own row stride, the partials in
//     their C chunks' rows (read under a predicate) and the VJP factors
//     formed again where the sweep reads them (the same operations, so
//     the same bits); every chain that the first design of this file
//     admitted fits one of the two. The padded layout's code tests no
//     flag: a run-time test of the layout made every kernel slower;
//   * the parameter cotangents are the records' sums, each in record order
//     (kb_param_sums: a fixed order, no float atomics, runs repeat bit for
//     bit), in a second launch counted with its parent. The products
//     `_chain_param_gemms` forms on the TPU are these sums. Summing them in
//     the step's own launch took longer on the card at every shape tried
//     (PERF.md, the K2b-m rows).
// Every sum has a fixed order. The features use kan_chain_warp.cuh's
// kf_norm / kf_basis / kf_swish operations, the slopes kan_chain.cuh's; the
// stage inputs, the step sum and the kbar updates are explicit fmaf.

#pragma once

#include "kan_chain_warp.cuh"

// Caps of the medium flavor; the Python wrapper checks every launch
// against them (ops/_cuda.py, `check_block_caps`).
#define KB_THREADS 256        // a block's threads
#define KB_WARPS (KB_THREADS / KW_LANES)
#define KB_MAX_I 1024         // state width I (= chain output width O)
#define KB_MAX_H 256          // hidden width H
// grid length G <= KC_MAX_G, stages <= KC_MAX_STAGES (kan_chain.cuh), and
// the dynamic shared memory of a launch (kb_smem_floats) at most
#define KB_MAX_SMEM (232448 - 4096)
#define KB_NR 16              // rows of a forward tile: one transpose-reduce

__host__ __device__ inline int kb_cdiv(int a, int b) { return (a + b - 1) / b; }

// One layer's forward split over the block's warps: C chunks of its terms
// (Tc terms each) times R groups of its rows (Rg rows each), C R =
// KB_WARPS; warp w takes chunk w / R and group w % R.
struct KbSplit {
  int C, R, Tc, Rg;
};

// One layer's VJP split: warp w takes the inputs [w per, (w + 1) per) and
// their G + 1 terms each; S lanes share a term, each a segment of the rows.
struct KbVjp {
  int S, per;
};

// A term's input i and grid point g in a walk over terms with n a unit
// (G, or G + 1 in the VJP's unit-major order); as a step, (q, r) of its
// length.
struct KbWalk {
  int i, g;
};

__host__ __device__ __forceinline__ KbWalk kb_walk_start(int t, int n) {
  KbWalk w;
  w.i = t / n;
  w.g = t - w.i * n;
  return w;
}

struct KbPlan {
  KbSplit f1, f2;   // the forward of layer 1 (I(G+1) terms, H rows), 2
  KbVjp v1, v2;     // the VJP of layer 1 (I inputs, H rows), 2
  // the walks' steps, divided on the host: 32 terms over G; 32 / S terms
  // of layer 1's and layer 2's VJP over G + 1; KB_THREADS entries of a
  // row of I, H or O
  KbWalk fstep, vstep1, vstep2, cI, cH, cO;
  int compact;      // the compact layout (kb_compact; set by the launcher)
};

// The split with the fewest issue slots for a lane by a rough count: per
// tile of up to KB_NR rows, the lane's terms (~32 for a value, 2 a row for
// its load and multiply-add) and the reduction (~64), and ~4 a chunk for
// the consumer's partial sums. Ties go to fewer chunks.
__host__ __device__ inline KbSplit kb_split_of(int n_terms, int n_rows) {
  KbSplit best = {0, 0, 0, 0};
  int best_cost = 0x7fffffff;
  for (int C = 1; C <= KB_WARPS; C *= 2) {
    const int R = KB_WARPS / C, Tc = kb_cdiv(n_terms, C);
    const int Rg = kb_cdiv(n_rows, R), rows = Rg < KB_NR ? Rg : KB_NR;
    const int cost = kb_cdiv(Rg, KB_NR)
                     * (kb_cdiv(Tc, KW_LANES) * (32 + 2 * rows) + 64) + 4 * C;
    if (cost < best_cost) {
      best_cost = cost;
      best.C = C;
      best.R = R;
      best.Tc = Tc;
      best.Rg = Rg;
    }
  }
  return best;
}

// The VJP split with the shortest dependent chain by a rough count: the
// lane's rounds of terms times its segment's rows, ~8 a shuffle level.
__host__ __device__ inline KbVjp kb_vjp_of(int n_in, int n_rows, int G) {
  KbVjp best;
  best.per = kb_cdiv(n_in, KB_WARPS);
  best.S = 1;
  const int terms = best.per * (G + 1);
  int best_cost = 0x7fffffff;
  for (int S = 1, lg = 0; S <= KW_LANES; S *= 2, ++lg) {
    const int cost = kb_cdiv(terms, KW_LANES / S) * kb_cdiv(n_rows, S)
                     + 8 * lg;
    if (cost < best_cost) {
      best_cost = cost;
      best.S = S;
    }
  }
  return best;
}

__host__ __device__ inline KbPlan kb_plan_of(const ChainDims& d) {
  KbPlan p;
  p.f1 = kb_split_of(d.I * (d.G + 1), d.H);
  p.f2 = kb_split_of(d.H * (d.G + 1), d.O);
  p.v1 = kb_vjp_of(d.I, d.H, d.G);
  p.v2 = kb_vjp_of(d.H, d.O, d.G);
  p.fstep = kb_walk_start(KW_LANES, d.G);
  p.vstep1 = kb_walk_start(KW_LANES / p.v1.S, d.G + 1);
  p.vstep2 = kb_walk_start(KW_LANES / p.v2.S, d.G + 1);
  p.cI = kb_walk_start(KB_THREADS, d.I);
  p.cH = kb_walk_start(KB_THREADS, d.H);
  p.cO = kb_walk_start(KB_THREADS, d.O);
  p.compact = 0;
  return p;
}

// The staged row stride of a layer with n rows: odd, so that lanes on
// consecutive terms read distinct banks; n itself in the compact layout.
__host__ __device__ inline int kb_stride(int n, bool compact) {
  return compact ? n : n | 1;
}

// Floats of the staged parameters: P1 [I(G+1)][s1], P2 [H(G+1)][s2].
__host__ __device__ inline size_t kb_param_smem(const ChainDims& d,
                                                bool compact) {
  return (size_t)d.I * (d.G + 1) * kb_stride(d.H, compact)
         + (size_t)d.H * (d.G + 1) * kb_stride(d.O, compact);
}

// Floats of one warp's VJP terms: its inputs' G + 1 terms at the larger
// of the two layers.
__host__ __device__ inline int kb_vjp_terms(const ChainDims& d) {
  const int per1 = kb_cdiv(d.I, KB_WARPS), per2 = kb_cdiv(d.H, KB_WARPS);
  return (per1 > per2 ? per1 : per2) * (d.G + 1);
}

// Rows of a layer's partial sums: KB_WARPS, so that kb_part_sum reads
// every slot unbranched; its C chunks' in the compact layout.
__host__ __device__ inline int kb_part_rows(int C, bool compact) {
  return compact ? C : KB_WARPS;
}

// Floats of the partial sums of both layers, [rows][H] and [rows][O].
__host__ __device__ inline size_t kb_part_floats(const ChainDims& d,
                                                 const KbPlan& p,
                                                 bool compact) {
  return (size_t)kb_part_rows(p.f1.C, compact) * d.H
         + (size_t)kb_part_rows(p.f2.C, compact) * d.O;
}

// Floats of the adjoint's own rows, between the staged parameters and the
// partials: the output cotangent and dx [I], the stage inputs [S][I], the
// hidden vectors [S][H] and, but in the compact layout, the terms' VJP
// factors [S][(I + H)(G + 1)].
__host__ __device__ inline size_t kb_adj_lead(const ChainDims& d, int stages,
                                              bool compact) {
  return 2 * (size_t)d.I + (size_t)stages * (d.I + d.H)
         + (compact ? 0 : (size_t)stages * (d.I + d.H) * (d.G + 1));
}

// Floats of a launch's dynamic shared memory in a layout: the staged
// parameters; for the adjoint its own rows (kb_adj_lead); then the
// partials and the running stage inputs [S + 1][I] (kb_eval), whose place
// the adjoint's reverse sweep takes for the stage cotangents [S][I], dy1
// [H] and each warp's VJP terms.
__host__ __device__ inline size_t kb_layout_floats(const ChainDims& d,
                                                   int stages, bool backward,
                                                   bool compact) {
  const size_t fwd = kb_part_floats(d, kb_plan_of(d), compact)
                     + (size_t)(stages + 1) * d.I;
  if (!backward) return kb_param_smem(d, compact) + fwd;
  const size_t sweep = (size_t)stages * d.I + d.H
                       + (size_t)KB_WARPS * kb_vjp_terms(d);
  return kb_param_smem(d, compact) + kb_adj_lead(d, stages, compact)
         + (fwd > sweep ? fwd : sweep);
}

// Whether a chain takes the compact layout: its adjoint does not fit the
// padded one with the VJP factors kept. Both directions take the same;
// the kernels take it as a template argument (kCompact).
__host__ __device__ inline bool kb_compact(const ChainDims& d, int stages) {
  return kb_layout_floats(d, stages, true, false) * sizeof(float)
         > KB_MAX_SMEM;
}

// Floats of a launch's dynamic shared memory (the wrapper's
// `block_smem_floats` computes the same).
__host__ __device__ inline size_t kb_smem_floats(const ChainDims& d,
                                                int stages, bool backward) {
  return kb_layout_floats(d, stages, backward, kb_compact(d, stages));
}

// The plan of a launch: kb_plan_of and the layout of its tableau.
__host__ inline KbPlan kb_plan_for(const ChainDims& d, int stages) {
  KbPlan p = kb_plan_of(d);
  p.compact = kb_compact(d, stages) ? 1 : 0;
  return p;
}

__device__ __forceinline__ void kb_walk_step(KbWalk& w, const KbWalk& by,
                                             int n) {
  w.i += by.i;
  w.g += by.g;
  if (w.g >= n) {
    w.g -= n;
    ++w.i;
  }
}

// One layer's forward work of a lane, fixed for a launch: its terms l0,
// l0 + 32, ... < l1 (its chunk's), the rows [r0, r1) of its warp's group,
// the offset of its chunk's partials, and the input and grid point of l0.
struct KbFwdLane {
  int l0, l1, r0, r1, part;
  KbWalk w;
};

// A thread's walks, fixed for a launch (with kb_copy_rows', the only
// integer divisions on the device); their steps are the plan's.
struct KbLanes {
  KbFwdLane f1, f2;
  KbWalk v1, v2;          // the first VJP term (lane / S) over G + 1
  KbWalk q0;              // the thread's first entry (t, q) of [.][I]
};

__device__ __forceinline__ KbFwdLane kb_fwd_lane(
    int n_in, int n_rows, int G, const KbSplit& sp, int warp, int lane) {
  KbFwdLane f;
  const int c = warp / sp.R, grp = warp - c * sp.R;
  const int end = c * sp.Tc + sp.Tc, n_terms = n_in * (G + 1);
  f.l0 = c * sp.Tc + lane;
  f.l1 = end < n_terms ? end : n_terms;
  f.r0 = grp * sp.Rg;
  f.r1 = f.r0 + sp.Rg < n_rows ? f.r0 + sp.Rg : n_rows;
  f.part = c * n_rows;
  f.w = kb_walk_start(f.l0, G);
  return f;
}

__device__ __forceinline__ KbLanes kb_lanes(const ChainDims& d, const KbPlan& p,
                                            int warp, int lane) {
  KbLanes ln;
  ln.f1 = kb_fwd_lane(d.I, d.H, d.G, p.f1, warp, lane);
  ln.f2 = kb_fwd_lane(d.H, d.O, d.G, p.f2, warp, lane);
  ln.v1 = kb_walk_start(lane / p.v1.S, d.G + 1);
  ln.v2 = kb_walk_start(lane / p.v2.S, d.G + 1);
  ln.q0 = kb_walk_start(threadIdx.x, d.I);
  return ln;
}

// The staged parameters and the layers' partial sums of a launch.
struct KbCtx {
  const float* P1;   // [I(G+1)][s1]: rows of c1, then of w1
  const float* P2;   // [H(G+1)][s2]: rows of c2, then of w2
  int s1, s2;
  float* lead;       // the rows between the parameters and the partials
  float* part1;      // [C1][H]
  float* part2;      // [C2][O]
  float* rows;       // the floats after the partials
  KbPlan plan;
};

__device__ __forceinline__ void kb_cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// Copy a row-major [rows][W] global array into shared memory at row
// stride ws: a thread an element in order (coalesced reads), starting at
// e = (tid / W, tid % W), the next element's row and column stepped
// without division.
__device__ __forceinline__ void kb_copy_rows(float* dst, const float* src,
                                             int rows, int W, int ws, KbWalk e,
                                             const KbWalk& step) {
  for (int k = threadIdx.x; k < rows * W; k += KB_THREADS) {
    kb_cp_async4(dst + e.i * ws + e.g, src + k);
    kb_walk_step(e, step, W);
  }
}

// Issue the copies of c1 [I G, H], w1 [I, H], c2 [H G, O], w2 [H, O] into
// smem (kb_param_smem floats) and lay out the partial sums `lead` floats
// after them; the copies land at kb_stage_wait.
__device__ __forceinline__ KbCtx kb_stage(const float* c1, const float* w1,
                                          const float* c2, const float* w2,
                                          const ChainDims& d,
                                          const KbPlan& plan, size_t lead,
                                          float* smem) {
  KbCtx k;
  const int IG = d.I * d.G, HG = d.H * d.G;
  k.s1 = kb_stride(d.H, plan.compact);
  k.s2 = kb_stride(d.O, plan.compact);
  float* p1 = smem;
  float* p2 = p1 + (size_t)(IG + d.I) * k.s1;
  const KbWalk eH = kb_walk_start(threadIdx.x, d.H);
  const KbWalk eO = kb_walk_start(threadIdx.x, d.O);
  kb_copy_rows(p1, c1, IG, d.H, k.s1, eH, plan.cH);
  kb_copy_rows(p1 + (size_t)IG * k.s1, w1, d.I, d.H, k.s1, eH, plan.cH);
  kb_copy_rows(p2, c2, HG, d.O, k.s2, eO, plan.cO);
  kb_copy_rows(p2 + (size_t)HG * k.s2, w2, d.H, d.O, k.s2, eO, plan.cO);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  k.P1 = p1;
  k.P2 = p2;
  k.lead = p2 + (size_t)(HG + d.H) * k.s2;
  k.part1 = k.lead + lead;
  k.part2 = k.part1 + kb_part_rows(plan.f1.C, plan.compact) * d.H;
  k.rows = k.part2 + kb_part_rows(plan.f2.C, plan.compact) * d.O;
  k.plan = plan;
  return k;
}

// The staged parameters and whatever the block wrote before are visible.
__device__ __forceinline__ void kb_stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// One exchange level of kb_sum16: a lane keeps the half of its N + N
// values its lane bit OFF selects and adds its partner's copy of that half.
template <int N, int OFF>
__device__ __forceinline__ void kb_fold(float (&v)[KB_NR], int lane) {
  const bool up = (lane & OFF) != 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float send = up ? v[j] : v[j + N];
    const float keep = up ? v[j + N] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// The sum of v over the warp's lanes for 16 values at once, transposed:
// lanes 2r and 2r + 1 return the warp's total of v[r]. Four exchange
// levels halve the values a lane holds; the fifth adds the pair.
__device__ __forceinline__ float kb_sum16(float (&v)[KB_NR], int lane) {
  kb_fold<8, 16>(v, lane);
  kb_fold<4, 8>(v, lane);
  kb_fold<2, 4>(v, lane);
  kb_fold<1, 2>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// The sum of v[0..N) as a fixed tree: pairs, then pairs of pairs.
template <int N>
__device__ __forceinline__ float kb_tree(float (&v)[N]) {
#pragma unroll
  for (int w = 1; w < N; w *= 2)
#pragma unroll
    for (int c = 0; c + w < N; c += 2 * w) v[c] = v[c] + v[c + w];
  return v[0];
}

// The value of a layer output from its C <= KB_WARPS partials, added as a
// fixed tree over KB_WARPS slots, a slot past C counting as zero (x + 0 =
// x). Every slot is read (the buffer holds KB_WARPS rows), so the loads go
// first, unbranched, and the adds are three deep; in the compact layout
// (C rows) a slot past C is not read.
template <bool kCompact>
__device__ __forceinline__ float kb_part_sum(const float* part, int C,
                                             int n_rows, int row) {
  float p[KB_WARPS];
#pragma unroll
  for (int c = 0; c < KB_WARPS; ++c) {
    if constexpr (kCompact) {
      p[c] = c < C ? part[c * n_rows + row] : 0.0f;
    } else {
      p[c] = part[c * n_rows + row];
      p[c] = c < C ? p[c] : 0.0f;
    }
  }
  return kb_tree(p);
}

// sum_j a[j S] b[j S] over j S < n: eight products at a time (loads
// clamped to the end, a product past it a zero) summed as a kb_tree, the
// eights added in order. The chain is a tree's depth an eight, not eight
// dependent multiply-adds.
__device__ __forceinline__ float kb_dot(const float* a, const float* b, int n,
                                        int S) {
  float acc = 0.0f;
  for (int r = 0; r < n; r += 8 * S) {
    float p[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = r + u * S < n ? r + u * S : n - 1;
      p[u] = a[j] * b[j];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) p[u] = r + u * S < n ? p[u] : 0.0f;
    acc = acc + kb_tree(p);
  }
  return acc;
}

// One layer's partial sums: the lane's terms (feat(input, g, swish) gives
// a term's value) times the rows of its warp's group, KB_NR rows a tile,
// reduced over the warp into part[chunk][row].
template <typename Feature>
__device__ __forceinline__ void kb_layer_fwd(const float* P, int ps, int nG,
                                             const KbFwdLane& f,
                                             const KbWalk& step, int G,
                                             Feature feat, float* part,
                                             int lane) {
  for (int rt = f.r0; rt < f.r1; rt += KB_NR) {
    const int nr = f.r1 - rt < KB_NR ? f.r1 - rt : KB_NR;
    float acc[KB_NR];
#pragma unroll
    for (int r = 0; r < KB_NR; ++r) acc[r] = 0.0f;
    KbWalk w = f.w;
    for (int l = f.l0; l < f.l1; l += KW_LANES) {
      const bool sw = l >= nG;
      const float v = feat(sw ? l - nG : w.i, w.g, sw, rt == 0);
      // all KB_NR columns: past the group's rows (nr) they read the next
      // row, which shared memory always holds, into sums never stored
      const float* row = P + (size_t)l * ps + rt;
#pragma unroll
      for (int r = 0; r < KB_NR; ++r) acc[r] = fmaf(v, row[r], acc[r]);
      kb_walk_step(w, step, G);
    }
    const float s = kb_sum16(acc, lane);
    if ((lane & 1) == 0 && (lane >> 1) < nr)
      part[f.part + rt + (lane >> 1)] = s;
  }
}

// (norm(v) - grid_g) / h, a basis term's argument.
__device__ __forceinline__ float kb_u(float v, int g, const ChainDims& d,
                                      const WarpConsts& c) {
  return kf_u(kf_norm(v, d.normalizer), c.grid[g], d.inv_h);
}

// A term's value: the basis value B(u), or swish(v). For rbf and iqf one
// exponential and one division serve either kind, so a warp holding both
// kinds runs them once; the operations, and so the bits, are kf_basis's
// and kf_swish's.
__device__ __forceinline__ float kb_value(float v, float u, bool swish,
                                          int basis) {
  if (basis == 2) return swish ? kf_swish(v) : kf_basis(u, basis);
  const float uu = __fmul_rn(u, u);
  const float e = expf(swish ? -v : -uu);
  const float r = __fdiv_rn(1.0f, __fadd_rn(1.0f, swish || basis == 0 ? e
                                                                      : uu));
  return swish ? __fmul_rn(v, r) : basis == 0 ? e : r;
}

// The basis value of input v at grid point g, or its swish.
__device__ __forceinline__ float kb_term(float v, int g, bool swish,
                                         const ChainDims& d,
                                         const WarpConsts& c) {
  return kb_value(v, kb_u(v, g, d, c), swish, d.basis);
}

// kb_value, and the term's VJP factor in fac: B'(u)/h (basis) or
// swish'(v) (swish), as kc_basis_du and kc_dswish form them (for rbf and
// iqf the swish's sigmoid is kb_value's r, its very bits).
__device__ __forceinline__ float kb_value_fac(
    float v, float u, bool swish, int basis, float inv_h, float& fac) {
  if (basis == 2) {
    if (swish) {
      fac = kc_dswish(v);
      return kf_swish(v);
    }
    const float B = kf_basis(u, basis);
    fac = kc_basis_du(u, B, basis) * inv_h;
    return B;
  }
  const float uu = __fmul_rn(u, u);
  const float e = expf(swish ? -v : -uu);
  const float r = __fdiv_rn(1.0f, __fadd_rn(1.0f, swish || basis == 0 ? e
                                                                      : uu));
  const float B = basis == 0 ? e : r;
  fac = swish ? r * (1.0f + v * (1.0f - r))
              : kc_basis_du(u, B, basis) * inv_h;
  return swish ? __fmul_rn(v, r) : B;
}

// A term's VJP factor as kb_value_fac forms it, from the term's input v
// and grid point g (any g for the swish term).
__device__ __forceinline__ float kb_fac(float v, int g, bool swish,
                                        const ChainDims& d,
                                        const WarpConsts& c) {
  float fac;
  kb_value_fac(v, kb_u(v, g, d, c), swish, d.basis, d.inv_h, fac);
  return fac;
}

// What the adjoint's rebuild keeps of a step (kb_rk_stages): per stage s
// its input xs[s], its hidden vector y1s[s] and, but in the compact
// layout, each term's VJP factor fac[s] (layer 1's I(G+1) terms, then
// layer 2's H(G+1)); in the stage's record (slot: rank among the needed
// stages) the term values b1, swx, b2, swy1.
struct KbKeep {
  float* xs;    // [S][I]
  float* y1s;   // [S][H]
  float* fac;   // [S][(I + H)(G + 1)], or null (compact)
  float* rec;   // [n_slots][L.width]
  RecLayout L;
};


// The stage inputs as running sums: acc [S + 1][I] holds, for each stage
// t, x + sum_j (dt a_tj) k_j over the stages j evaluated so far but the
// last, and in row S the same for the step's result with dt b_j; each k_j
// is added once it is complete, in increasing j, as `_step_fwd_kernel`
// adds them. The caller sets every row to x (shared memory, visible)
// before a step. v + (dt a) k_prev for k_prev from its partials:
template <bool kCompact>
__device__ __forceinline__ float kb_plus(float v, float a, const KbCtx& k,
                                         int I, int q) {
  return a != 0.0f
             ? fmaf(a, kb_part_sum<kCompact>(k.part2, k.plan.f2.C, I, q), v)
             : v;
}

// One chain evaluation, stage s of the block's row: k_s into k.part2 as
// partial sums; its input is acc[s] plus stage prev's k (the stage
// evaluated last, or -1) from its partials. First stage prev's k goes into
// the later stages' rows of acc. In the adjoint's rebuild (keep given)
// the stage's input, hidden vector, term values and VJP factors are kept
// (KbKeep; a term's by the one lane of group 0's first tile that has it).
// Two block barriers; every thread calls it. kCompact: the layout (no
// factors kept).
template <bool kCompact>
__device__ __forceinline__ void kb_eval(const KbCtx& k, const KbLanes& ln,
                                        float* acc, int stages, int s, int prev,
                                        const KbKeep* keep, int slot,
                                        const ChainDims& d, const WarpConsts& c,
                                        int lane) {
  const int I = d.I, H = d.H, G = d.G;
  const float ap = prev >= 0 ? c.a[s][prev] : 0.0f;
  const float* xin = acc + s * I;
  float* xs_out = keep ? keep->xs + s * I : nullptr;
  if (prev >= 0 || xs_out) {
    // rows t = s..S of acc, a thread an entry (t, q)
    KbWalk e = ln.q0;
#pragma unroll 1
    for (int n = threadIdx.x; n < (stages + 1 - s) * I; n += KB_THREADS) {
      const int t = s + e.i, q = e.g;
      if (t == s) {
        if (xs_out) xs_out[q] = kb_plus<kCompact>(xin[q], ap, k, I, q);
      } else if (prev >= 0) {
        const float a = t < stages ? c.a[t][prev] : c.b[prev];
        acc[t * I + q] = kb_plus<kCompact>(acc[t * I + q], a, k, I, q);
      }
      kb_walk_step(e, k.plan.cI, I);
    }
  }
  float* fac = keep && !kCompact
                   ? keep->fac + (size_t)s * (I + H) * (G + 1) : nullptr;
  float* rec = keep ? keep->rec + (size_t)slot * keep->L.width : nullptr;
  // a term's value, and in the rebuild its record value and VJP factor
  auto value = [&](float x, int i, int g, bool sw, bool first, int n_in,
                   float* f_fac, int rb, int rsw) {
    if (!keep) return kb_term(x, g, sw, d, c);
    if constexpr (kCompact) {
      const float f = kb_term(x, g, sw, d, c);
      if (first) rec[sw ? rsw + i : rb + i * G + g] = f;
      return f;
    }
    float fc;
    const float f = kb_value_fac(x, kb_u(x, g, d, c), sw, d.basis, d.inv_h,
                                 fc);
    if (first) {
      f_fac[sw ? n_in * G + i : i * G + g] = fc;
      rec[sw ? rsw + i : rb + i * G + g] = f;
    }
    return f;
  };
  kb_layer_fwd(k.P1, k.s1, I * G, ln.f1, k.plan.fstep, G,
               [&](int i, int g, bool sw, bool first) {
                 return value(kb_plus<kCompact>(xin[i], ap, k, I, i), i, g,
                              sw, first,
                              I, fac, keep ? keep->L.b1 : 0,
                              keep ? keep->L.swx : 0);
               },
               k.part1, lane);
  __syncthreads();
  if (keep)
    for (int h = threadIdx.x; h < H; h += KB_THREADS)
      keep->y1s[s * H + h] =
          kb_part_sum<kCompact>(k.part1, k.plan.f1.C, H, h);
  kb_layer_fwd(k.P2, k.s2, H * G, ln.f2, k.plan.fstep, G,
               [&](int h, int g, bool sw, bool first) {
                 return value(kb_part_sum<kCompact>(k.part1, k.plan.f1.C, H,
                                                    h), h, g,
                              sw, first, H, fac ? fac + I * (G + 1) : nullptr,
                              keep ? keep->L.b2 : 0,
                              keep ? keep->L.swy1 : 0);
               },
               k.part2, lane);
  __syncthreads();
}

// The needed stages of one RK step from acc (every row the step input,
// visible), in increasing order; returns the last one evaluated, whose k
// stays in k.part2 (the others' are in acc[S]). keep (may be null): what
// the adjoint's rebuild keeps (KbKeep).
template <bool kCompact>
__device__ __forceinline__ int kb_rk_stages(const KbCtx& k, const KbLanes& ln,
                                            float* acc, const KbKeep* keep,
                                            int stages, const ChainDims& d,
                                            const WarpConsts& c, int lane) {
  int prev = -1, slot = 0;
  for (int s = 0; s < stages; ++s) {
    if (!c.needed[s]) continue;
    kb_eval<kCompact>(k, ln, acc, stages, s, prev, keep, slot++, d, c,
                      lane);
    prev = s;
  }
  return prev;
}

// Component q of the step's result y = x + sum_i (dt b_i) k_i: acc[S]
// plus the last stage's k from its partials.
template <bool kCompact>
__device__ __forceinline__ float kb_step_out(const float* acc, const KbCtx& k,
                                             int I, int stages, int last,
                                             const WarpConsts& c, int q) {
  return kb_plus<kCompact>(acc[stages * I + q], c.b[last], k, I, q);
}

// Set every row of acc [S + 1][I] to x[q] for the thread's components q.
__device__ __forceinline__ void kb_acc_set(float* acc, int stages, int I, int q,
                                           float x) {
  for (int t = 0; t <= stages; ++t) acc[t * I + q] = x;
}

// The shared-memory rows of the adjoint (kb_layout_floats, backward): its
// own rows after the staged parameters (kb_adj_lead), then, after the
// partials, the running stage inputs; the reverse sweep's rows take the
// partials' and the running inputs' place once the rebuild is done.
struct BlockAdjRows {
  float* gy;     // the step's output cotangent [I]
  float* dx;     // the step input's cotangent [I]
  float* xs;     // stage inputs [S][I]
  float* y1s;    // hidden vectors [S][H]
  float* fac;    // the terms' VJP factors [S][(I + H)(G + 1)] (KbKeep), or
                 // null (compact)
  float* acc;    // the running stage inputs [S + 1][I] (kb_eval)
  float* kb;     // stage cotangents [S][I]          } the reverse sweep,
  float* dy1;    // the hidden cotangent of the stage } over the partials
  float* tw;     // the warps' VJP terms [KB_WARPS][kb_vjp_terms]
};

// compact: the layout's, a compile-time constant of the kernel, so that
// the padded layout's code reads its kept factors with no test.
__device__ __forceinline__ BlockAdjRows kb_adj_rows(
    const KbCtx& k, const ChainDims& d, int stages, bool compact) {
  BlockAdjRows a;
  a.gy = k.lead;
  a.dx = a.gy + d.I;
  a.xs = a.dx + d.I;
  a.y1s = a.xs + stages * d.I;
  a.fac = compact ? nullptr : a.y1s + stages * d.H;
  a.acc = k.rows;
  a.kb = k.part1;
  a.dy1 = a.kb + stages * d.I;
  a.tw = a.dy1 + d.H;
  return a;
}

// One layer's VJP over the warp's inputs [w per, (w + 1) per), unit-major
// (an input's G basis terms, then its swish term): for each term, S lanes
// sum a segment each of m = sum_r gout[r] P[term][r] and an xor shuffle
// adds them; t = m fac (basis: fac = B'(u)/h, kept by the rebuild) or m
// (swish) goes to the warp's tw; then the lane of input i calls out(i,
// norm'(v_i) sum_g t_g + swish'(v_i) t_sw), swish'(v_i) the swish term's
// fac. fac: the layer's factors at the stage [n_in (G + 1)], or null
// (compact: kb_fac forms them from v); w0 / step: the lane's first term
// and its step.
template <bool kCompact, typename Out>
__device__ __forceinline__ void kb_layer_vjp(const float* P, int ps, int n_in,
                                             int n_rows, const float* gout,
                                             const float* v, const KbVjp& vp,
                                             const KbWalk& w0,
                                             const KbWalk& step,
                                             const ChainDims& d,
                                             const WarpConsts& c,
                                             const float* fac, float* tw,
                                             Out out, int warp, int lane) {
  const int G = d.G, G1 = G + 1, nG = n_in * G;
  const int i0 = warp * vp.per;
  const int ni = n_in - i0 < vp.per ? n_in - i0 : vp.per;
  if (ni <= 0) return;
  const int S = vp.S, slots = KW_LANES / S, seg = lane & (S - 1);
  const int terms = ni * G1, rounds = kb_cdiv(terms, slots);
  KbWalk w = w0;
  for (int j = 0; j < rounds; ++j) {
    const int tau = lane / S + j * slots;
    const bool act = tau < terms, sw = w.g == G;
    const int i = i0 + w.i, l = sw ? nG + i : i * G + w.g;
    float m = 0.0f, f = 0.0f;
    if (act) {
      if constexpr (kCompact) f = sw ? 0.0f : kb_fac(v[i], w.g, false, d, c);
      else f = fac[l];
      m = kb_dot(gout + seg, P + (size_t)l * ps + seg, n_rows - seg, S);
    }
    for (int off = S >> 1; off > 0; off >>= 1)
      m += __shfl_xor_sync(0xffffffffu, m, off);
    if (act && seg == 0) tw[tau] = sw ? m : m * f;
    kb_walk_step(w, step, G1);
  }
  __syncwarp();
  for (int q = lane; q < ni; q += KW_LANES) {
    const float* t = tw + q * G1;
    float tv[KC_MAX_G];
#pragma unroll
    for (int g = 0; g < KC_MAX_G; ++g) tv[g] = g < G ? t[g < G ? g : 0] : 0.0f;
    const float acc = kb_tree(tv);
    const float vi = v[i0 + q];
    float fsw;
    if constexpr (kCompact) fsw = kb_fac(vi, 0, true, d, c);
    else fsw = fac[nG + i0 + q];
    out(i0 + q, acc * kc_dnorm(vi, d.normalizer) + t[G] * fsw);
  }
}

// The discrete adjoint of one RK step of the block's row
// (`_step_bwd_kernel`'s recursion): rebuilds the stages from a.acc with
// the forward's routine, sets kbar_i = (dt b_i) gy, then for i = s-1..0 runs
// the chain VJP with kbar_i, adds its dx into a.dx (which starts at gy)
// and passes (dt a_ij) dx_i to the earlier stages. Writes one record a
// needed stage at rec + slot * L.width (slot: rank among the needed
// stages): the rebuild its term values, the reverse sweep dy1 and gk.
// Every row of a.acc must hold the step input and a.gy its
// cotangent, visible (a __syncthreads), before the call; ends in
// __syncthreads with a.dx and the records complete.
template <bool kCompact>
__device__ __forceinline__ void kb_rk_step_adjoint(
    const KbCtx& k, const KbLanes& ln, const BlockAdjRows& a, int stages,
    int n_slots, const ChainDims& d, const WarpConsts& c, const RecLayout& L,
    float* rec, int warp, int lane) {
  const int I = d.I, H = d.H, O = d.O;
  const KbKeep keep = {a.xs, a.y1s, a.fac, rec, L};
  kb_rk_stages<kCompact>(k, ln, a.acc, &keep, stages, d, c, lane);
  for (int q = threadIdx.x; q < I; q += KB_THREADS) {
    const float g = a.gy[q];
    a.dx[q] = g;
    for (int s = 0; s < stages; ++s) a.kb[s * I + q] = c.b[s] * g;
  }
  __syncthreads();
  float* tw = a.tw + warp * kb_vjp_terms(d);
  int slot = n_slots;
  for (int s = stages - 1; s >= 0; --s) {
    if (!c.needed[s]) continue;
    float* r = rec + (size_t)(--slot) * L.width;
    const float* gk = a.kb + s * I;
    for (int o = threadIdx.x; o < O; o += KB_THREADS) r[L.gk + o] = gk[o];
    const float* fs =
        a.fac ? a.fac + (size_t)s * (I + H) * (d.G + 1) : nullptr;
    kb_layer_vjp<kCompact>(k.P2, k.s2, H, O, gk, a.y1s + s * H, k.plan.v2,
                 ln.v2, k.plan.vstep2, d, c,
                 fs ? fs + I * (d.G + 1) : nullptr, tw,
                 [&](int h, float v) {
                   a.dy1[h] = v;
                   r[L.dy1 + h] = v;
                 },
                 warp, lane);
    __syncthreads();
    kb_layer_vjp<kCompact>(k.P1, k.s1, I, H, a.dy1, a.xs + s * I, k.plan.v1, ln.v1,
                 k.plan.vstep1, d, c, fs, tw,
                 [&](int q, float v) {
                   a.dx[q] = a.dx[q] + v;
                   // the loads unbranched: a row j >= s is discarded
                   // (never written) and may read the rows after kb, in
                   // shared memory all the same (U holds the partials'
                   // KB_WARPS rows); the compact layout reads row 0
                   float av[KC_MAX_STAGES - 1], kv[KC_MAX_STAGES - 1];
#pragma unroll
                   for (int j = 0; j < KC_MAX_STAGES - 1; ++j) {
                     av[j] = c.a[s][j];
                     kv[j] = a.kb[(kCompact && j >= s ? 0 : j) * I + q];
                   }
#pragma unroll
                   for (int j = 0; j < KC_MAX_STAGES - 1; ++j)
                     if (j < s && av[j] != 0.0f)
                       a.kb[j * I + q] = fmaf(av[j], v, kv[j]);
                 },
                 warp, lane);
    __syncthreads();
  }
}

// The parameter cotangent p from n_rec records (kc_rec_layout), summed in
// record order: dc1 = b1^T dy1, dw1 = swx^T dy1, dc2 = b2^T gk, dw2 =
// swy1^T gk. A thread a parameter over the grid's blocks.
__device__ inline void kb_param_sums(const float* rec, int n_rec,
                                     const ChainDims& d, const RecLayout& L,
                                     float* dc1, float* dw1, float* dc2,
                                     float* dw2) {
  const int I = d.I, H = d.H, O = d.O, G = d.G;
  const int n_c1 = I * G * H, n_w1 = I * H, n_c2 = H * G * O, n_w2 = H * O;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_c1 + n_w1 + n_c2 + n_w2) return;
  int a_off, b_off;
  float* out;
  if (p < n_c1) {                       // dc1[ig, h] = b1[ig] dy1[h]
    a_off = L.b1 + p / H;
    b_off = L.dy1 + p % H;
    out = dc1 + p;
  } else if (p < n_c1 + n_w1) {         // dw1[i, h] = swx[i] dy1[h]
    const int q = p - n_c1;
    a_off = L.swx + q / H;
    b_off = L.dy1 + q % H;
    out = dw1 + q;
  } else if (p < n_c1 + n_w1 + n_c2) {  // dc2[hg, o] = b2[hg] gk[o]
    const int q = p - n_c1 - n_w1;
    a_off = L.b2 + q / O;
    b_off = L.gk + q % O;
    out = dc2 + q;
  } else {                              // dw2[h, o] = swy1[h] gk[o]
    const int q = p - n_c1 - n_w1 - n_c2;
    a_off = L.swy1 + q / O;
    b_off = L.gk + q % O;
    out = dw2 + q;
  }
  const float* ra = rec + a_off;
  const float* rb = rec + b_off;
  float acc = 0.0f;
#pragma unroll 8
  for (int r = 0; r < n_rec; ++r)
    acc = fmaf(ra[(size_t)r * L.width], rb[(size_t)r * L.width], acc);
  *out = acc;
}
