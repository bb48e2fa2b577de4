// K3 at medium widths: n explicit RK steps over the 2-layer KDense chain
// (K3f-m) and their discrete adjoint (K3b-m), for chains past the
// one-warp caps of kan_chain.cuh (I, O <= 8, H <= 32): the packed 8-member
// LV ensemble [16, 80, 16] (grid 5) and the Burgers / 1-D Allen-Cahn
// surrogates [41, 10, 41] on a uniform step grid. rk_fused.cu launches them.
//
// Computes what `_multistep_fwd_kernel` and `_multistep_bwd_kernel`
// (kanodes_tpu/ops/rk_fused.py:311,346) compute, with the chain of
// `_chain_f` / `_chain_vjp` / `_chain_param_gemms` (:70-127).
//
// What bounds it on this card: latency. A row's trajectory is a chain of
// n s dependent chain evaluations (tsit5: s = 6); one evaluation at the
// packed chain is ~1.5e4 multiply-adds over 60 KB of parameters, far below
// a microsecond of the card's rates, and the fixed-step loss has ONE row.
// K2-m's block routines (kan_chain_block.cuh), which K3-m ran before, took
// ~5.6k cycles an evaluation at the packed chain (layer 1 2.5k, layer 2
// 1.9k, the stage-input pass 0.7k, two barriers) and ~3.6k at Burgers; the
// adjoint ran in one block a row, rebuilding each step's stages (51% of
// its time) and then running a block-wide VJP a stage (44%), one step
// after the other on one SM (PERF.md, the K3f-m/K3b-m trace).
//
// What the design does about it:
//   * forward, a shorter evaluation (KM_THREADS threads a row), four block
//     barriers, each between two passes in which every warp with work has
//     a full share of it: (1) each input term's feature once, a thread a
//     term (km_input_features: the basis values and the swish of the
//     stage input; the thread forms that input itself from the running
//     sums and the last stage's value, and the threads of a unit write the
//     next running sums, a row each); (2) layer 1, each hidden output's
//     dot product in one group of lp lanes of one warp (lp a power of two,
//     as many lanes as the block holds for the layer's outputs:
//     km_split_of), a lane over quads of terms, each one 16-byte shared
//     load, its quads' parameters in registers for the whole launch (the
//     first KM_QREG quads; the rest, and outputs past one round, from
//     global memory, out of line), then an xor-shuffle tree in the group;
//     (3) the hidden values' features, a thread a term; (4) layer 2 as
//     layer 1. No partials, no pass over (S + 1 - s) I running sums on
//     the dependent chain;
//   * adjoint in three phases (the design of K8b, csrc/rk_adaptive_members
//     .cu): A, a block per (step, row) rebuilds the step from its stored
//     input with the forward's routines (so the stages it differentiates
//     are K3f-m's bit for bit) and stores, per needed stage, the record's
//     forward operands (kc_rec_layout: b1, swx, b2, swy1), A2 = dk/dy1 and
//     either J = dk/dx (stored as J^T [I][O]) or its factor A1 = dy1/dx [H]
//     [I], whichever is smaller (km_dense: I O <= H (I + O)); B, the
//     reverse recursion, a warp a row where I <= 32 and J is dense (K3b's
//     and K8b's: a stage's VJP is dx_q = sum_o J[o][q] kbar_o, lane q's row
//     of J^T and kbar read a quad at a time from shared memory, the next
//     step's rows copied into the warp's other buffer by cp.async
//     meanwhile), else a block a row (with the factors: t = A2^T kbar in
//     groups of lanes, then dx = A1^T t); it stores each stage's gk (and,
//     with the factors, dy1 = t); C, dy1 = A2^T gk of every record at once
//     (dense J), then the parameter sums of K2b (rk_param_sums_kernel:
//     records copied into shared memory, each sum in record order with
//     fused multiply-adds). Only phase B's recursion is sequential; phases
//     A and C run on as many SMs as there are steps and records.
// Every sum has a fixed order and no float atomics, so a launch repeats
// bit for bit. The features use kan_chain_warp.cuh's kf_norm / kf_u and
// kan_chain_block.cuh's kb_value (kf_basis's and kf_swish's bits), the
// slopes kan_chain.cuh's; the stage inputs, the step sum and the kbar
// updates are explicit fmaf.

#pragma once

#include "kan_chain_block.cuh"

#define KM_THREADS 512            // a K3f-m / phase-A block's threads
#define KM_QREG 6                 // quads of a layer's parameters in registers
#define KM_SWEEP_THREADS 256      // a phase-B block (a block a row)
#define KM_SWEEP_MAX_WARPS 8      // a phase-B block (a warp a row)
#define KM_C_THREADS 256          // a phase-C1 block

__host__ __device__ inline int km_cdiv(int a, int b) { return (a + b - 1) / b; }

// One layer's split over the block: N outputs in groups of lp = 1 << lg
// lanes (N lp <= KM_THREADS where lp >= 2 allows), `groups` of them, an
// output n in group n % groups at round n / groups; lane c of a group
// takes the quads of terms c, c + lp, ... (mq of them, the layer's T terms
// padded with zeros to Tp = 4 lp mq).
struct KmSplit {
  int lg, groups, rounds, mq, Tp;
};

__host__ __device__ inline KmSplit km_split_of(int N, int T) {
  KmSplit s;
  s.lg = 5;
  while (s.lg > 0 && (N << s.lg) > KM_THREADS) --s.lg;
  s.groups = KM_THREADS >> s.lg;
  s.rounds = km_cdiv(N, s.groups);
  s.mq = km_cdiv(T, 4 << s.lg);
  s.Tp = (4 << s.lg) * s.mq;
  return s;
}

// The forward's plan: layer 1 (H outputs over I (G + 1) terms, input i's
// terms i (G + 1) + g: its G basis values, then its swish), layer 2 (O
// outputs over H (G + 1) terms).
struct KmPlan {
  KmSplit l1, l2;
};

__host__ __device__ inline KmPlan km_plan_of(const ChainDims& d) {
  KmPlan p;
  p.l1 = km_split_of(d.H, d.I * (d.G + 1));
  p.l2 = km_split_of(d.O, d.H * (d.G + 1));
  return p;
}

// Floats of K3f-m's dynamic shared memory: the features of both layers
// [Tp1], [Tp2], the hidden values [H], the stage's value [I] and two
// copies of the running stage inputs [2][S + 1][I].
__host__ __device__ inline size_t km_fwd_floats(const ChainDims& d,
                                                const KmPlan& p, int stages) {
  return (size_t)p.l1.Tp + p.l2.Tp + d.H + d.I
         + 2 * (size_t)(stages + 1) * d.I;
}

// The stride of a row of n floats read down a column: odd.
__host__ __device__ inline int km_odd(int n) { return n | 1; }

// Floats of phase A's: K3f-m's, then the stage's derivative factors D1
// [Tp1] (B'(u)/h, then swish'(x)) and norm'(x) [I], D2 [Tp2] and norm'(y1)
// [H], then A1 [H][I | 1] and A2 [O][H | 1].
__host__ __device__ inline size_t km_rebuild_floats(const ChainDims& d,
                                                    const KmPlan& p,
                                                    int stages) {
  return km_fwd_floats(d, p, stages) + p.l1.Tp + d.I + p.l2.Tp + d.H
         + (size_t)d.H * km_odd(d.I) + (size_t)d.O * km_odd(d.H);
}

// The stage Jacobian's form: J = dk/dx [O][I] where I O <= H (I + O), else
// its factors (A1 = dy1/dx [H][I]).
__host__ __device__ inline bool km_dense(const ChainDims& d) {
  return d.I * d.O <= d.H * (d.I + d.O);
}

// The adjoint's plan (the wrapper's `multistep_bwd_mid_plan` computes the
// same): a (step, row, stage) record of kc_rec_layout's `width` floats in
// the scratch's first part [n_rec][width] (rounded up to 4 floats), then
// its Jacobian block of jw floats (a multiple of 4): dense, J^T [I][O]
// then A2^T [H][O]; else A2^T [H][O] then A1 [H][I]. Phase B reads `span`
// floats of it a stage.
struct KmBwdPlan {
  int dense, width, jw, span, a2_off;
  long long rec_floats, scratch_floats;
  int rebuild_smem;                 // phase A's dynamic shared memory, bytes
  int warp_rows;                    // phase B a warp a row: rows a block;
                                    // 0: a block a row
  int sweep_blocks, sweep_threads, sweep_smem, staged;
  int dy1_blocks;                   // phase C1's (0: B writes dy1)
};

// The shared-memory row stride of J^T [I][O] in phase B a warp a row: O
// rounded up to 4, and 4 more where that is an even number of quads, so
// that eight lanes reading their rows' quads at once hit distinct banks.
__host__ __device__ inline int km_jt_stride(int O) {
  const int q = (O + 3) / 4;
  return 4 * (q % 2 == 0 ? q + 1 : q);
}

// Floats of a phase-B block a row: the staged Jacobians of two steps
// (staged), the current stage's cotangent [2][I], t [H], and lambda and
// kbar [KC_MAX_STAGES] of each component past the block's threads.
__host__ __device__ inline size_t km_sweep_block_floats(const ChainDims& d,
                                                        int slots, int span,
                                                        bool staged) {
  const int nx = d.I > KM_SWEEP_THREADS ? d.I - KM_SWEEP_THREADS : 0;
  return (staged ? 2 * (size_t)slots * span : 0) + 2 * (size_t)d.I + d.H
         + (size_t)(KC_MAX_STAGES + 1) * nx;
}

__host__ __device__ inline KmBwdPlan km_bwd_plan_of(const ChainDims& d,
                                                    int K, int stages,
                                                    int n_steps, int slots) {
  KmBwdPlan b;
  const int I = d.I, H = d.H, O = d.O;
  b.dense = km_dense(d) ? 1 : 0;
  b.width = kc_rec_layout(I, H, O, d.G).width;
  const int jw = b.dense ? O * I + H * O : H * O + H * I;
  b.jw = (jw + 3) / 4 * 4;
  b.span = b.dense ? O * I : H * O + H * I;
  b.a2_off = b.dense ? O * I : 0;
  const long long n_rec = (long long)n_steps * K * slots;
  b.rec_floats = (n_rec * b.width + 3) / 4 * 4;
  b.scratch_floats = b.rec_floats + n_rec * b.jw;
  b.rebuild_smem =
      (int)(km_rebuild_floats(d, km_plan_of(d), stages) * sizeof(float));
  const int cap = KB_MAX_SMEM / (int)sizeof(float);
  if (b.dense && I <= KW_LANES) {
    // a warp a row, two steps of its Jacobians a warp, J^T's rows padded
    // to km_jt_stride
    const int per = 2 * slots * I * km_jt_stride(O);
    int fit = cap / per;
    fit = fit < KM_SWEEP_MAX_WARPS ? fit : KM_SWEEP_MAX_WARPS;
    fit = fit < K ? fit : K;
    b.sweep_blocks = km_cdiv(K, fit);
    b.warp_rows = km_cdiv(K, b.sweep_blocks);
    b.sweep_threads = KW_LANES * b.warp_rows;
    b.sweep_smem = (int)((size_t)b.warp_rows * per * sizeof(float));
    b.staged = 1;
  } else {
    b.warp_rows = 0;
    b.sweep_blocks = K;
    b.sweep_threads = KM_SWEEP_THREADS;
    b.staged = km_sweep_block_floats(d, slots, b.span, true) <= (size_t)cap;
    b.sweep_smem = (int)(km_sweep_block_floats(d, slots, b.span, b.staged)
                         * sizeof(float));
  }
  b.dy1_blocks =
      b.dense ? (int)((n_rec * H + KM_C_THREADS - 1) / KM_C_THREADS) : 0;
  return b;
}

// The tableau in shared memory: a (zero for a stage j no output needs),
// b, needed, and each stage's next needed stage (-1: the step's end); the
// grid.
struct KmConsts {
  float a[KC_MAX_STAGES][KC_MAX_STAGES];
  float b[KC_MAX_STAGES];
  int needed[KC_MAX_STAGES];
  int next[KC_MAX_STAGES];
  int first;
  float grid[KC_MAX_G];
};

// Thread 0 fills c; a __syncthreads must follow.
__device__ inline void km_fill_consts(KmConsts& c, const ChainDims& d,
                                      const StepTab& T) {
  if (threadIdx.x != 0) return;
#pragma unroll
  for (int i = 0; i < KC_MAX_STAGES; ++i) {
#pragma unroll
    for (int j = 0; j < KC_MAX_STAGES; ++j)
      c.a[i][j] = i < T.stages && j < i && T.needed[j] ? T.a[i][j] : 0.0f;
    c.b[i] = i < T.stages ? T.b[i] : 0.0f;
    c.needed[i] = i < T.stages && T.needed[i];
  }
  int nxt = -1;
  for (int i = KC_MAX_STAGES - 1; i >= 0; --i) {
    c.next[i] = nxt;
    if (c.needed[i]) nxt = i;
  }
  c.first = nxt;
#pragma unroll
  for (int g = 0; g < KC_MAX_G; ++g) c.grid[g] = d.grid[g];
}

// Parameter (output n, term t) of layer 1 (n = h; t = i (G + 1) + g: c1
// [(i G + g), h], or w1 [i, h] for g = G) or layer 2 (n = o over hidden
// h's terms), from global memory; 0 past the terms.
// The unit t / (G + 1) is taken in float: (t + 1/2) / (G + 1) lies at
// least 1 / (2 (G + 1)) from an integer, far above its rounding error for
// t < 2^20.
__device__ __forceinline__ float km_param(const float* c, const float* w,
                                          int N, int T, int G, int n,
                                          int t) {
  if (t >= T || n >= N) return 0.0f;
  const int i = (int)(((float)t + 0.5f) * __frcp_rn((float)(G + 1)));
  const int g = t - i * (G + 1);
  return g < G ? c[(size_t)(i * G + g) * N + n] : w[(size_t)i * N + n];
}

// A lane's parameters for the whole launch: its first KM_QREG quads of
// each layer at round 0 (zero past the terms or outputs).
struct KmRegs {
  float p1[4 * KM_QREG];
  float p2[4 * KM_QREG];
};

__device__ inline void km_load_regs(KmRegs& r, const float* c1,
                                    const float* w1, const float* c2,
                                    const float* w2, const ChainDims& d,
                                    const KmPlan& p) {
  const int T1 = d.I * (d.G + 1), T2 = d.H * (d.G + 1);
  const int lp1 = 1 << p.l1.lg, lp2 = 1 << p.l2.lg;
  const int n1 = threadIdx.x >> p.l1.lg, q1 = threadIdx.x & (lp1 - 1);
  const int n2 = threadIdx.x >> p.l2.lg, q2 = threadIdx.x & (lp2 - 1);
#pragma unroll
  for (int m = 0; m < KM_QREG; ++m)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      r.p1[4 * m + u] =
          km_param(c1, w1, d.H, T1, d.G, n1, 4 * (q1 + lp1 * m) + u);
      r.p2[4 * m + u] =
          km_param(c2, w2, d.O, T2, d.G, n2, 4 * (q2 + lp2 * m) + u);
    }
}

// A thread's place in a layer's split, fixed for a launch (taken once, so
// that the evaluation's loops hold no index arithmetic): its first quad of
// the layer's features, lanes a group, lane c and first output n, and
// whether its warp holds an output at round 0.
struct KmLane {
  const float4* q;
  int lp, c, n;
  bool run;
};

__device__ __forceinline__ KmLane km_lane(const float* f, const KmSplit& sp,
                                          int N) {
  KmLane l;
  l.lp = 1 << sp.lg;
  l.c = threadIdx.x & (l.lp - 1);
  l.n = threadIdx.x >> sp.lg;
  l.q = reinterpret_cast<const float4*>(f) + l.c;
  l.run = (int)((threadIdx.x & ~(KW_LANES - 1)) >> sp.lg) < N;
  return l;
}

// The sum of y over the group's lanes, an xor-shuffle tree (every lane of
// the group gets the same bits); the whole warp calls it.
__device__ __forceinline__ float km_group_sum(float y, int lp) {
#pragma unroll
  for (int off = KW_LANES / 2; off > 0; off >>= 1)
    if (off < lp) y = __fadd_rn(y, __shfl_xor_sync(0xffffffffu, y, off));
  return y;
}

// The quads m0 .. mq - 1 of a lane's dot product with their parameters
// from global memory (past the register-held quads, or past round 0): out
// of line, off the main paths' code.
__device__ __noinline__ void km_dot_global(const float4* q, int lp, int c,
                                           int m0, int mq, const float* gc,
                                           const float* gw, int N, int T,
                                           int G, int n, float& a0,
                                           float& a1, float& a2, float& a3) {
  for (int m = m0; m < mq; ++m) {
    const float4 w = q[lp * m];
    const int t = 4 * (c + lp * m);
    a0 = fmaf(w.x, km_param(gc, gw, N, T, G, n, t), a0);
    a1 = fmaf(w.y, km_param(gc, gw, N, T, G, n, t + 1), a1);
    a2 = fmaf(w.z, km_param(gc, gw, N, T, G, n, t + 2), a2);
    a3 = fmaf(w.w, km_param(gc, gw, N, T, G, n, t + 3), a3);
  }
}

// One layer: for each output n of the thread's group, the dot product of
// the features (shared memory, 16-byte aligned) with its parameters, four
// partial sums (one a lane of the quad) added as a pair of pairs, then
// km_group_sum; consume(n, y, c, lp) for a real output (every lane of the
// group, the same y). Round 0's first KM_QREG quads are loaded at once
// (past mq, zeros) and take their parameters from registers; the rest from
// global memory. A warp with no output skips the layer (it takes no issue
// slots from the others).
template <typename Consume>
__device__ __forceinline__ void km_layer(const KmLane& ln, const KmSplit& sp,
                                         int N, int T, int G,
                                         const float (&pr)[4 * KM_QREG],
                                         const float* gc, const float* gw,
                                         Consume consume) {
  if (!ln.run) return;
  const int lp = ln.lp, c = ln.c;
  float4 v[KM_QREG];
#pragma unroll
  for (int m = 0; m < KM_QREG; ++m) {
    v[m] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (m < sp.mq) v[m] = ln.q[lp * m];
  }
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
  for (int m = 0; m < KM_QREG; ++m) {
    a0 = fmaf(v[m].x, pr[4 * m], a0);
    a1 = fmaf(v[m].y, pr[4 * m + 1], a1);
    a2 = fmaf(v[m].z, pr[4 * m + 2], a2);
    a3 = fmaf(v[m].w, pr[4 * m + 3], a3);
  }
  for (int j = 0; j < sp.rounds; ++j) {
    const int n = ln.n + j * sp.groups;
    if (j > 0) {
      if (n - ln.n + (int)((threadIdx.x & ~(KW_LANES - 1)) >> sp.lg) >= N)
        break;
      a0 = a1 = a2 = a3 = 0.0f;
    }
    const int m0 = j > 0 ? 0 : KM_QREG;
    if (m0 < sp.mq)
      km_dot_global(ln.q, lp, c, m0, sp.mq, gc, gw, N, T, G, n, a0, a1, a2,
                    a3);
    const float y =
        km_group_sum(__fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3)), lp);
    if (n < N) consume(n, y, c, lp);
  }
}

// What phase A keeps of a stage besides its values: the derivative
// factors (shared memory) and the record (global).
struct KmKeep {
  float* D1;    // [Tp1]: B'(u_ig)/h at i (G + 1) + g, swish'(x_i) at g = G
  float* n1;    // [I]: norm'(x_i)
  float* D2;    // [Tp2]: the same for the hidden values
  float* n2;    // [H]
  float* rec;   // the stage's record (kc_rec_layout)
  RecLayout L;
};

// The shared-memory rows of K3f-m and phase A.
struct KmRows {
  float* f1;    // [Tp1] layer 1's features
  float* f2;    // [Tp2] layer 2's features
  float* y1;    // [H] the hidden values
  float* k;     // [I] the stage's value
  float* acc;   // [2][S + 1][I] the running stage inputs (row S: the step's
                // sum), two copies: a stage reads one and writes the other
};

__device__ __forceinline__ KmRows km_rows(float* smem, const KmPlan& p,
                                          const ChainDims& d) {
  KmRows r;
  r.f1 = smem;
  r.f2 = r.f1 + p.l1.Tp;
  r.y1 = r.f2 + p.l2.Tp;
  r.k = r.y1 + d.H;
  r.acc = r.k + d.I;
  return r;
}

// Zero the features' padding; a __syncthreads must follow.
__device__ inline void km_zero_pads(const KmRows& r, const ChainDims& d,
                                    const KmPlan& p) {
  const int T1 = d.I * (d.G + 1), T2 = d.H * (d.G + 1);
  for (int t = T1 + threadIdx.x; t < p.l1.Tp; t += blockDim.x) r.f1[t] = 0.0f;
  for (int t = T2 + threadIdx.x; t < p.l2.Tp; t += blockDim.x) r.f2[t] = 0.0f;
}

// A thread's first feature of each layer, fixed for a launch: unit and
// grid point of term threadIdx.x (u = t / (G + 1)), taken once.
struct KmFeat {
  int u, g;
};

__device__ __forceinline__ KmFeat km_feat_of(int t, int G) {
  KmFeat f;
  f.u = t / (G + 1);
  f.g = t - f.u * (G + 1);
  return f;
}

// Term t = u (G + 1) + g of unit u's input value x into f[t]: the basis
// value B((norm(x) - grid_g) / h) for g < G, swish(x) for g = G (kb_value:
// one exponential and one division serve either kind, so a warp holding
// both runs them once; the bits are kf_basis's and kf_swish's). kKeep:
// also the derivative factor into D[t] (B'(u)/h, or swish'(x)), norm'(x)
// into nd[u] (g = 0) and the record's values (basis at rb + u G + g,
// swish at rsw + u).
template <bool kKeep>
__device__ __forceinline__ void km_feature(float x, KmFeat e, int t,
                                           const ChainDims& d,
                                           const KmConsts& k, float* f,
                                           const KmKeep* keep, float* D,
                                           float* nd, int rb, int rsw) {
  const int G = d.G;
  const bool sw = e.g == G;
  const float u =
      kf_u(kf_norm(x, d.normalizer), k.grid[sw ? 0 : e.g], d.inv_h);
  const float val = kb_value(x, u, sw, d.basis);
  f[t] = val;
  if (kKeep) {
    D[t] = sw ? kc_dswish(x) : kc_basis_du(u, val, d.basis) * d.inv_h;
    keep->rec[sw ? rsw + e.u : rb + e.u * G + e.g] = val;
    if (e.g == 0) nd[e.u] = kc_dnorm(x, d.normalizer);
  }
}

// The features of a layer's inputs v [n_units] (shared memory), a thread a
// term (km_feature); first: the thread's first term's (u, g). A
// __syncthreads must follow.
template <bool kKeep>
__device__ __forceinline__ void km_features(const float* v, int n_units,
                                            KmFeat first, const ChainDims& d,
                                            const KmConsts& k, float* f,
                                            const KmKeep* keep, float* D,
                                            float* nd, int rb, int rsw) {
  const int T = n_units * (d.G + 1);
  KmFeat e = first;
  for (int t = threadIdx.x; t < T; t += KM_THREADS) {
    if (t != threadIdx.x) e = km_feat_of(t, d.G);
    km_feature<kKeep>(v[e.u], e, t, d, k, f, keep, D, nd, rb, rsw);
  }
}

// The step's start: every running-sum row of acc[0] set to x. A
// __syncthreads must follow.
__device__ inline void km_step_start(const KmRows& rw, const float* x,
                                     const ChainDims& d, int stages) {
  for (int u = threadIdx.x; u < d.I; u += KM_THREADS) {
    const float v = x[u];
    for (int t = 0; t <= stages; ++t) rw.acc[t * d.I + u] = v;
  }
}

// The features of stage cur's input into f1 (km_feature), each thread
// forming the input of its unit u from the running sums A = acc[par] and
// rw.k, the value of the stage evaluated last (prev), as
// `_step_fwd_kernel` adds them: x = A[cur] + (dt a_cur,prev) k_u; where
// prev ended a step, x = y = A[S] + (dt b_prev) k_u, the new step's input.
// The threads of unit u write the next running sums into B = acc[par ^ 1],
// thread (u, g) the rows t = g mod (G + 1): the rows t > prev with (dt
// a_t,prev) k_u (row S: dt b_prev) added, in increasing prev as the stages
// complete; at a step's end every row = y, and y into y_out[u] (g = 0, if
// y_out is not null). prev < 0: x = A[cur] and nothing is written (the
// caller then keeps par). A __syncthreads must follow.
template <bool kKeep>
__device__ __forceinline__ void km_input_features(
    const KmRows& rw, int par, int prev, int cur, KmFeat first,
    const ChainDims& d, const KmConsts& k, int stages, float* y_out,
    const KmKeep* keep) {
  const int I = d.I, G = d.G, T = I * (G + 1), rows = (stages + 1) * I;
  const float* A = rw.acc + par * rows;
  float* B = rw.acc + (par ^ 1) * rows;
  const bool end = prev >= 0 && k.next[prev] < 0;
  const int row = end ? stages : cur;
  const float a = prev < 0 ? 0.0f : end ? k.b[prev] : k.a[cur][prev];
  KmFeat e = first;
  for (int t = threadIdx.x; t < T; t += KM_THREADS) {
    if (t != threadIdx.x) e = km_feat_of(t, G);
    const int u = e.u;
    const float ku = prev >= 0 ? rw.k[u] : 0.0f;
    float x = A[row * I + u];
    if (a != 0.0f) x = fmaf(a, ku, x);
    if (prev >= 0) {
      // at most (KC_MAX_STAGES + 1) / 3 rows a thread (G >= 2)
#pragma unroll
      for (int j = 0; j < (KC_MAX_STAGES + 3) / 3; ++j) {
        const int r = e.g + j * (G + 1);
        if (r > stages || (!end && r <= prev)) continue;
        float v = x;
        if (!end) {
          const float ar = r < stages ? k.a[r][prev] : k.b[prev];
          v = A[r * I + u];
          if (ar != 0.0f) v = fmaf(ar, ku, v);
        }
        B[r * I + u] = v;
      }
      if (end && e.g == 0 && y_out != nullptr) y_out[u] = x;
    }
    km_feature<kKeep>(x, e, t, d, k, rw.f1, keep,
                      kKeep ? keep->D1 : nullptr, kKeep ? keep->n1 : nullptr,
                      keep ? keep->L.b1 : 0, keep ? keep->L.swx : 0);
  }
}

// The last step's result y = A[S] + (dt b_prev) k into y_out. Needs the
// last layer 2's barrier before it.
__device__ inline void km_step_out(const KmRows& rw, int par, int prev,
                                   const ChainDims& d, const KmConsts& k,
                                   int stages, float* y_out) {
  const float* A = rw.acc + par * (stages + 1) * d.I;
  for (int u = threadIdx.x; u < d.I; u += KM_THREADS) {
    float y = A[stages * d.I + u];
    if (k.b[prev] != 0.0f) y = fmaf(k.b[prev], rw.k[u], y);
    y_out[u] = y;
  }
}

// Layer 1 of a stage evaluation: the hidden values y1 from f1, lane 0 of
// each group storing its own. A __syncthreads must follow.
__device__ __forceinline__ void km_eval_l1(const KmRows& rw, const KmRegs& rg,
                                           const KmLane& ln,
                                           const float* c1, const float* w1,
                                           const ChainDims& d,
                                           const KmPlan& p) {
  km_layer(ln, p.l1, d.H, d.I * (d.G + 1), d.G, rg.p1, c1, w1,
           [&](int h, float y, int c, int lp) {
             if (c == 0) rw.y1[h] = y;
           });
}

// Layer 2 of a stage evaluation: the stage's value k from f2, lane 0 of
// each group storing its own. A __syncthreads must follow.
__device__ __forceinline__ void km_eval_l2(const KmRows& rw, const KmRegs& rg,
                                           const KmLane& ln,
                                           const float* c2, const float* w2,
                                           const ChainDims& d,
                                           const KmPlan& p) {
  km_layer(ln, p.l2, d.O, d.H * (d.G + 1), d.G, rg.p2, c2, w2,
           [&](int o, float ks, int c, int lp) {
             if (c == 0) rw.k[o] = ks;
           });
}

// sum_m a[m sa] b[m sb] over m < n in four partial sums (m mod 4), added
// as a pair of pairs: a fixed order.
__device__ __forceinline__ float km_dot4(const float* a, int sa,
                                         const float* b, int n, int sb = 1) {
  float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;
  int m = 0;
  for (; m + 4 <= n; m += 4) {
    p0 = fmaf(a[(size_t)m * sa], b[(size_t)m * sb], p0);
    p1 = fmaf(a[(size_t)(m + 1) * sa], b[(size_t)(m + 1) * sb], p1);
    p2 = fmaf(a[(size_t)(m + 2) * sa], b[(size_t)(m + 2) * sb], p2);
    p3 = fmaf(a[(size_t)(m + 3) * sa], b[(size_t)(m + 3) * sb], p3);
  }
  if (m < n) p0 = fmaf(a[(size_t)m * sa], b[(size_t)m * sb], p0);
  if (m + 1 < n) p1 = fmaf(a[(size_t)(m + 1) * sa], b[(size_t)(m + 1) * sb], p1);
  if (m + 2 < n) p2 = fmaf(a[(size_t)(m + 2) * sa], b[(size_t)(m + 2) * sb], p2);
  return __fadd_rn(__fadd_rn(p0, p1), __fadd_rn(p2, p3));
}

// One entry of a layer's Jacobian: norm' sum_g c[g stride] D[g] + w D[G]
// (the parameters from global memory).
__device__ __forceinline__ float km_factor_entry(const float* c, int stride,
                                                 const float* D, int G,
                                                 float dn, float w) {
  float s = 0.0f;
  for (int g = 0; g < G; ++g) s = fmaf(c[(size_t)g * stride], D[g], s);
  return fmaf(dn, s, w * D[G]);
}

// Phase A: the stage's Jacobian from its derivative factors, in shared
// memory: A1[h][i] = norm'(x_i) sum_g c1[ig, h] B'(u_ig)/h + swish'(x_i)
// w1[i, h] into a1 [H][I | 1] and A2[o][h] likewise into a2 [O][H | 1],
// the parameters read from global memory (a thread an entry, the output
// fastest, so that the reads coalesce). A __syncthreads must follow.
__device__ inline void km_stage_factors(const KmKeep& kp, const float* c1,
                                        const float* w1, const float* c2,
                                        const float* w2, const ChainDims& d,
                                        float* a1, float* a2) {
  const int I = d.I, H = d.H, O = d.O, G = d.G;
  const int sI = km_odd(I), sH = km_odd(H);
  for (int e = threadIdx.x; e < H * I; e += blockDim.x) {
    const int i = e / H, h = e - i * H;
    a1[h * sI + i] = km_factor_entry(c1 + (size_t)i * G * H + h, H,
                                     kp.D1 + i * (G + 1), G, kp.n1[i],
                                     w1[(size_t)i * H + h]);
  }
  for (int e = threadIdx.x; e < O * H; e += blockDim.x) {
    const int h = e / O, o = e - h * O;
    a2[o * sH + h] = km_factor_entry(c2 + (size_t)h * G * O + o, O,
                                     kp.D2 + h * (G + 1), G, kp.n2[h],
                                     w2[(size_t)h * O + o]);
  }
}

// Phase A: the stage's Jacobian block jb (KmBwdPlan): dense, J^T[i][o] =
// sum_h A2[o][h] A1[h][i] (in h order) then A2^T [H][O]; else A2^T [H][O]
// then A1 [H][I].
__device__ inline void km_stage_jacobian(const float* a1, const float* a2,
                                         const ChainDims& d, bool dense,
                                         float* jb) {
  const int I = d.I, H = d.H, O = d.O;
  const int sI = km_odd(I), sH = km_odd(H);
  float* a2t = jb + (dense ? O * I : 0);
  if (dense) {
    for (int e = threadIdx.x; e < O * I; e += blockDim.x) {
      const int i = e / O, o = e - i * O;
      jb[e] = km_dot4(a2 + o * sH, 1, a1 + i, H, sI);
    }
  } else {
    for (int e = threadIdx.x; e < H * I; e += blockDim.x) {
      const int h = e / I, i = e - h * I;
      jb[H * O + e] = a1[h * sI + i];
    }
  }
  for (int e = threadIdx.x; e < H * O; e += blockDim.x) {
    const int h = e / O, o = e - h * O;
    a2t[e] = a2[o * sH + h];
  }
}

__device__ __forceinline__ void km_cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void km_cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void km_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's copy groups are in flight
template <int n>
__device__ __forceinline__ void km_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Issue the copies of `slots` blocks of `rows` <= 32 rows of `cols` floats
// each (contiguous in global memory, at stride jw a block) to dst at row
// stride rs (a multiple of 4): lane q of a warp copies row q, 16 bytes a
// copy where cols and jw are multiples of 4.
__device__ __forceinline__ void km_fetch_rows(float* dst, const float* src,
                                              int slots, int rows, int cols,
                                              int jw, int rs, int lane) {
  if (lane >= rows) return;
  const bool vec = cols % 4 == 0 && jw % 4 == 0;
  for (int sl = 0; sl < slots; ++sl) {
    const float* s = src + (size_t)sl * jw + lane * cols;
    float* t = dst + ((size_t)sl * rows + lane) * rs;
    if (vec)
      for (int m = 0; m < cols; m += 4) km_cp_async16(t + m, s + m);
    else
      for (int m = 0; m < cols; ++m) km_cp_async4(t + m, s + m);
  }
}

// Issue the copies of `slots` blocks of `span` floats, at stride jw in
// global memory, to dst at stride span: thread `tid` of `nt`; 16 bytes a
// copy where span and jw are multiples of 4 (the blocks then are 16-byte
// aligned at both ends).
__device__ __forceinline__ void km_fetch(float* dst, const float* src,
                                         int slots, int span, int jw, int tid,
                                         int nt) {
  const bool vec = span % 4 == 0 && jw % 4 == 0;
  for (int sl = 0; sl < slots; ++sl) {
    const float* s = src + (size_t)sl * jw;
    float* t = dst + (size_t)sl * span;
    if (vec)
      for (int q = 4 * tid; q < span; q += 4 * nt) km_cp_async16(t + q, s + q);
    else
      for (int q = tid; q < span; q += nt) km_cp_async4(t + q, s + q);
  }
}

