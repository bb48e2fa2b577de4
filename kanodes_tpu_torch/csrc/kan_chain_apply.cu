// The standalone 2-layer KDense chain and its VJP, for Hopper (sm_90a),
// with a plain C interface loaded through ctypes
// (kanodes_tpu_torch/ops/_cuda.py builds it with nvcc).
//
// Replaces the Pallas kernels of kanodes_tpu/ops/kdense_pallas.py:
//   kc_chain_apply_fwd <- _chain_fwd_kernel  (kan_chain_apply)
//   kc_chain_apply_bwd <- _chain_bwd_kernel  (_kca_bwd)
// each in two flavors (below).
// The forward also writes the hidden output y1 [K, H], which the backward
// takes back (as the Pallas forward does): given y1, both layers' basis
// terms are rebuilt from the inputs alone, with no forward sum.
//
// What bounds them on this card: latency. At the LV shapes (K = 1 or 34
// rows, widths 2-10-2, G = 5) one call is ~1e4 flops on ~1 KB of
// parameters, at the packed 8-member ensemble [16, 80, 16] ~3e4 flops a
// row on 60 KB; the bound from bytes or flops is well under a microsecond.
// The first port ran a thread a row (K1f), its per-row arrays indexed at
// run time on the stack, ~15 us a chain evaluation, and the backward in
// one block of which K threads worked (PERF.md, the K1f/K1b trace).
//
// Two flavors, picked on the host (`_cuda.chain_apply_flavor`, the
// library's `k1_plan` mirrors the plan):
//   * small, within kan_chain.cuh's caps (I, O <= 8, H <= 32, G <= 16):
//     a warp a row, rows over as many blocks as they need, each block of
//     K1_STAGE_WARPS warps at least; every thread issues its share of the
//     parameters' copies with cp.async at once (a copy loop an array ran
//     ~3.8k cycles at K = 34, half the first warp design's forward).
//     K1f: K4f's kf_chain_fwd (kan_chain_warp.cuh), lane h's slices of the
//     parameters in registers, lane h also storing y1_h (its kY1 argument).
//     K1b: in the row's warp, layer 1's terms (lanes over the I G + I terms
//     of x) and layer 2's (lane h over its G terms of y1_h), which do not
//     depend on each other; then the one dependent chain, gy -> dy1_h
//     (lane h) -> dx_i: lanes over layer 1's terms form sum_h dy1_h P[l][h]
//     times the term's slope, lane i adds its G + 1 of them;
//   * medium, past those caps (I, O <= KB_MAX_I, H <= KB_MAX_H, the shared
//     memory within KB_MAX_SMEM): a block of KB_THREADS a row on K2-m's
//     routines (kan_chain_block.cuh). K1f-m: kb_stage, then kb_layer_fwd
//     for each layer, two block barriers. K1b-m: a thread a term rebuilds
//     both layers' term values and slopes, then kb_layer_vjp for layer 2
//     (dy1) and layer 1 (dx), two barriers. A chain whose backward does
//     not fit the padded layout takes the compact one (kCompact).
// Each row's parameter-cotangent operands form one record (kc_rec_layout).
// The records go to the scratch and K2b's rk_param_sums_kernel
// (rk_fused.cu) sums them in record order from shared memory, a second
// launch counted with the first; but at K = 1 in the small flavor the
// cotangents are the record's outer products, written by the block in the
// same launch from the record in shared memory (`direct`): faster than
// the second launch at LV width, slower for the packed ensemble's 15,360
// products on one block (PERF.md, the K1 findings). A fixed order and no
// float atomics, so a launch repeats bit for bit. Launches go on the
// caller's stream; nothing here allocates or syncs.

#include "kan_chain_block.cuh"

// rk_fused.cu: K2b's parameter sums (rk_param_sums_kernel) over n_rec
// records, launched on st.
cudaError_t kc_launch_param_sums(const float* scratch, int n_rec,
                                 const ChainDims& d, float* dc1, float* dw1,
                                 float* dc2, float* dw2, cudaStream_t st);

namespace {

// The launch plan of a call over K rows (`chain_apply_plan` in
// ops/_cuda.py computes the same; k1_plan exports it).
struct K1Plan {
  int medium;       // 0: a warp a row; 1: a block a row
  int compact;      // medium: the compact layout
  int fwd_rows;     // small K1f: rows a block, a warp each
  int fwd_warps;    // small K1f: warps a block (at least K1_STAGE_WARPS)
  int fwd_blocks;
  int bwd_rows;     // small K1b: rows a block, a warp each
  int bwd_warps;    // small K1b: warps a block (KW_MAX_WARPS)
  int bwd_blocks;
  int fwd_smem;     // dynamic shared memory, bytes
  int bwd_smem;
};

// A small-flavor block's warps at least: the parameters' copies, and at
// K = 1 the cotangents, spread over this many warps whatever the rows.
#define K1_STAGE_WARPS 8

__host__ __device__ inline bool k1_small(const ChainDims& d) {
  return d.I >= 1 && d.I <= KC_MAX_I && d.O >= 1 && d.O <= KC_MAX_I
         && d.H >= 1 && d.H <= KC_MAX_H && d.G >= 2 && d.G <= KC_MAX_G;
}

// Floats of a small K1f warp's workspace: its row's input [I] and
// kf_chain_fwd's.
__host__ __device__ inline int k1f_warp_floats(const ChainDims& d) {
  return d.I + kf_chain_ws_floats(d);
}

// A small K1b warp's workspace (shared memory, floats from its base).
struct K1bWarp {
  int x, y1, gy, t1, dsx, dy1, tw, width;
};

__host__ __device__ inline K1bWarp k1b_warp_layout(const ChainDims& d) {
  const int T1 = d.I * d.G + d.I;
  K1bWarp w;
  w.x = 0;                // x [I]
  w.y1 = w.x + d.I;       // y1 [H]
  w.gy = w.y1 + d.H;      // gy [O]
  w.t1 = w.gy + d.O;      // layer 1: B'(u_ig)/h, then norm'(x_i) [IG + I]
  w.dsx = w.t1 + T1;      // swish'(x_i) [I]
  w.dy1 = w.dsx + d.I;    // [H]
  w.tw = w.dy1 + d.H;     // layer 1's VJP terms [IG + I]
  w.width = w.tw + T1;
  return w;
}

// Floats of the medium K1b's own rows after the staged parameters: x [I],
// y1 [H], gy [O], dy1 [H], but compact the terms' slopes [(I + H)(G + 1)],
// and the warps' VJP terms [KB_WARPS][kb_vjp_terms]. (Its record is in
// the scratch, also at K = 1: in shared memory it would narrow the caps.)
__host__ __device__ inline size_t k1m_bwd_lead(const ChainDims& d,
                                               bool compact) {
  return (size_t)d.I + 2 * d.H + d.O
         + (compact ? 0 : (size_t)(d.I + d.H) * (d.G + 1))
         + (size_t)KB_WARPS * kb_vjp_terms(d);
}

__host__ __device__ inline size_t k1m_smem_floats(const ChainDims& d,
                                                  bool backward,
                                                  bool compact) {
  if (backward) return kb_param_smem(d, compact) + k1m_bwd_lead(d, compact);
  return kb_param_smem(d, compact) + kb_part_floats(d, kb_plan_of(d), compact)
         + d.I;
}

// (warps a block, blocks) for K rows a warp each: as few blocks as `cap`
// warps a block allow, then as few warps a block as carry the rows.
__host__ __device__ inline void k1_rows_over_blocks(int K, int cap,
                                                    int& warps,
                                                    int& blocks) {
  blocks = kb_cdiv(K, K < cap ? K : cap);
  warps = kb_cdiv(K, blocks);
}

__host__ inline K1Plan k1_plan_of(const ChainDims& d, int K) {
  K1Plan p = {};
  const int cap = KB_MAX_SMEM / (int)sizeof(float);
  const int width = kc_rec_layout(d.I, d.H, d.O, d.G).width;
  if (k1_small(d)) {
    const int params = kc_param_floats(d);
    const int fwd = k1f_warp_floats(d), bwd = k1b_warp_layout(d).width;
    int fit = (cap - params) / fwd;
    k1_rows_over_blocks(K, fit < KF_MAX_WARPS ? fit : KF_MAX_WARPS,
                        p.fwd_rows, p.fwd_blocks);
    p.fwd_warps = p.fwd_rows > K1_STAGE_WARPS ? p.fwd_rows : K1_STAGE_WARPS;
    fit = (cap - params - width) / bwd;
    k1_rows_over_blocks(K, fit < KW_MAX_WARPS ? fit : KW_MAX_WARPS,
                        p.bwd_rows, p.bwd_blocks);
    p.bwd_warps = KW_MAX_WARPS;
    p.fwd_smem = (int)sizeof(float) * (params + p.fwd_rows * fwd);
    p.bwd_smem = (int)sizeof(float) * (params + width + p.bwd_rows * bwd);
    return p;
  }
  p.medium = 1;
  p.compact = k1m_smem_floats(d, true, false) * sizeof(float) > KB_MAX_SMEM;
  p.fwd_blocks = p.bwd_blocks = K;
  p.fwd_smem = (int)(k1m_smem_floats(d, false, p.compact) * sizeof(float));
  p.bwd_smem = (int)(k1m_smem_floats(d, true, p.compact) * sizeof(float));
  return p;
}

// The grid into c (thread 0, compile-time offsets of the kernel's
// parameters only); visible after the block's next barrier.
__device__ inline void k1_fill_grid(WarpConsts& c, const ChainDims& d) {
  if (threadIdx.x != 0) return;
#pragma unroll
  for (int g = 0; g < KC_MAX_G; ++g) c.grid[g] = d.grid[g];
}

// Issue the copies of c1 | w1 | c2 | w2 into smem in kc_stage_params'
// layout, a thread a float of the four in turn, with cp.async, so that
// every load is in flight at once; they land at kb_stage_wait.
__device__ inline ChainParams k1_stage_params(const float* c1,
                                              const float* w1,
                                              const float* c2,
                                              const float* w2,
                                              const ChainDims& d,
                                              float* smem) {
  const int n1 = d.I * d.G * d.H, n2 = n1 + d.I * d.H;
  const int n3 = n2 + d.H * d.G * d.O, n4 = n3 + d.H * d.O;
  for (int k = threadIdx.x; k < n4; k += blockDim.x)
    kb_cp_async4(smem + k, k < n1   ? c1 + k
                           : k < n2 ? w1 + (k - n1)
                           : k < n3 ? c2 + (k - n2)
                                    : w2 + (k - n3));
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  ChainParams p;
  p.c1 = smem;
  p.w1 = smem + n1;
  p.c2 = smem + n2;
  p.w2 = smem + n3;
  return p;
}

// ---------------------------------------------------------------------------
// small: a warp a row
// ---------------------------------------------------------------------------

// K1f: row blockIdx.x * rows + warp (warp < rows); the chain over the
// lanes by kf_chain_fwd, y written by lanes o < O, y1 by lanes h < H.
__global__ void __launch_bounds__(KW_LANES * KF_MAX_WARPS)
chain_apply_fwd_kernel(const float* x, const float* c1, const float* w1,
                       const float* c2, const float* w2, float* y, float* y1,
                       int K, int rows, ChainDims d) {
  extern __shared__ float smem[];
  __shared__ WarpConsts wc;
  __shared__ unsigned char s_l2h[KC_MAX_H * KC_MAX_G];
  const int warp = threadIdx.x / KW_LANES, lane = threadIdx.x % KW_LANES;
  const int I = d.I, IG = I * d.G;
  const int r = blockIdx.x * rows + warp;
  const bool mine = warp < rows && r < K;
  float* xs = smem + kc_param_floats(d) + (size_t)warp * k1f_warp_floats(d);
  if (mine && lane < I) xs[lane] = x[(size_t)r * I + lane];
  const ChainParams p = k1_stage_params(c1, w1, c2, w2, d, smem);
  k1_fill_grid(wc, d);
  kf_fill_l2(s_l2h, d);
  kb_stage_wait();
  for (int l = threadIdx.x; l < IG + I; l += blockDim.x) {
    wc.term_x[l] = l < IG ? l / d.G : l - IG;
    wc.term_c[l] = l < IG ? wc.grid[l % d.G] : 0.0f;
  }
  KfRegs rg;
  kf_load_regs(rg, p, d, lane);
  __syncthreads();
  if (!mine) return;
  kf_chain_fwd<true>(xs, y + (size_t)r * d.O, d, wc, s_l2h, p, rg, xs + I,
                     lane, y1 + (size_t)r * d.H);
}

// K1b: row blockIdx.x * rows + warp (warp < rows), its record at rec
// (scratch + r * width; with `direct`, K = 1, the block's record in shared
// memory, whose outer products the block then writes as the cotangents).
// Warps past the rows help with the copies and the cotangents.
__global__ void __launch_bounds__(KW_LANES * KW_MAX_WARPS)
chain_apply_bwd_kernel(const float* x, const float* y1, const float* gy,
                       const float* c1, const float* w1, const float* c2,
                       const float* w2, float* dx, float* dc1, float* dw1,
                       float* dc2, float* dw2, float* scratch, int K,
                       int rows, int direct, ChainDims d) {
  extern __shared__ float smem[];
  __shared__ WarpConsts wc;
  const int warp = threadIdx.x / KW_LANES, lane = threadIdx.x % KW_LANES;
  const int I = d.I, H = d.H, O = d.O, G = d.G, IG = I * G;
  const RecLayout L = kc_rec_layout(I, H, O, G);
  const K1bWarp W = k1b_warp_layout(d);
  float* s_rec = smem + kc_param_floats(d);
  float* ws = s_rec + L.width + (size_t)warp * W.width;
  const int r = blockIdx.x * rows + warp;
  const bool mine = warp < rows && r < K;
  // the row's inputs load while the block sets up
  if (mine) {
    if (lane < I) ws[W.x + lane] = x[(size_t)r * I + lane];
    if (lane < H) ws[W.y1 + lane] = y1[(size_t)r * H + lane];
    if (lane < O) ws[W.gy + lane] = gy[(size_t)r * O + lane];
  }
  const ChainParams p = k1_stage_params(c1, w1, c2, w2, d, smem);
  k1_fill_grid(wc, d);
  kb_stage_wait();
  for (int l = threadIdx.x; l < IG + I; l += blockDim.x) {
    wc.term_x[l] = l < IG ? l / G : l - IG;
    wc.term_c[l] = l < IG ? wc.grid[l % G] : 0.0f;
  }
  __syncthreads();
  if (mine) {
    float* rec = direct ? s_rec : scratch + (size_t)r * L.width;
    const float* xr = ws + W.x;
    float* t1 = ws + W.t1;
    // layer 1's terms of x: values into the record, slopes kept
    for (int l = lane; l < IG + I; l += KW_LANES) {
      const float xv = xr[wc.term_x[l]];
      if (l < IG) {
        const float u = (kc_norm(xv, d.normalizer) - wc.term_c[l]) * d.inv_h;
        const float B = kc_basis(u, d.basis);
        t1[l] = kc_basis_du(u, B, d.basis) * d.inv_h;
        rec[L.b1 + l] = B;
      } else {
        const int i = l - IG;
        t1[l] = kc_dnorm(xv, d.normalizer);
        ws[W.dsx + i] = kc_dswish(xv);
        rec[L.swx + i] = kc_swish(xv);
      }
    }
    // layer 2 in lane h: its terms of y1_h, then the VJP
    // dy1_h = norm'(y1_h) sum_g B'(u_hg)/h m_hg + swish'(y1_h) sum_o gy_o
    // w2[h, o], m_hg = sum_o gy_o c2[hg, o]
    const float* g = ws + W.gy;
    if (lane < H) {
      const float yv = ws[W.y1 + lane];
      const float yn = kc_norm(yv, d.normalizer);
      float acc = 0.0f;
      for (int gi = 0; gi < G; ++gi) {
        const float u = (yn - wc.grid[gi]) * d.inv_h;
        const float B = kc_basis(u, d.basis);
        rec[L.b2 + lane * G + gi] = B;
        const float* row = p.c2 + (lane * G + gi) * O;
        float m = 0.0f;
        for (int o = 0; o < O; ++o) m = fmaf(g[o], row[o], m);
        acc = fmaf(m, kc_basis_du(u, B, d.basis) * d.inv_h, acc);
      }
      float gw = 0.0f;
      for (int o = 0; o < O; ++o) gw = fmaf(g[o], p.w2[lane * O + o], gw);
      const float dy = acc * kc_dnorm(yv, d.normalizer)
                       + gw * kc_dswish(yv);
      ws[W.dy1 + lane] = dy;
      rec[L.dy1 + lane] = dy;
      rec[L.swy1 + lane] = kc_swish(yv);
    }
    if (lane < O) rec[L.gk + lane] = g[lane];
    __syncwarp();
    // layer 1's VJP: term l's sum_h dy1_h [c1 ; w1][l][h] (w1's rows follow
    // c1's in shared memory) times its slope (basis terms)
    const float* dy1 = ws + W.dy1;
    float* tw = ws + W.tw;
    for (int l = lane; l < IG + I; l += KW_LANES) {
      const float* row = p.c1 + l * H;
      float m = 0.0f;
      for (int h = 0; h < H; ++h) m = fmaf(dy1[h], row[h], m);
      tw[l] = l < IG ? m * t1[l] : m;
    }
    __syncwarp();
    if (lane < I) {
      float acc = 0.0f;
      for (int gi = 0; gi < G; ++gi) acc += tw[lane * G + gi];
      dx[(size_t)r * I + lane] =
          acc * t1[IG + lane] + tw[IG + lane] * ws[W.dsx + lane];
    }
  }
  if (!direct) return;
  __syncthreads();
  kc_reduce_param_grads(s_rec, 1, d, L, dc1, dw1, dc2, dw2);
}

// ---------------------------------------------------------------------------
// medium: a block a row (kan_chain_block.cuh's routines)
// ---------------------------------------------------------------------------

// K1f-m: row blockIdx.x; kCompact: the layout (K1Plan.compact).
template <bool kCompact>
__global__ void __launch_bounds__(KB_THREADS)
chain_apply_fwd_mid_kernel(const float* x, const float* c1, const float* w1,
                           const float* c2, const float* w2, float* y,
                           float* y1, ChainDims d, KbPlan plan) {
  extern __shared__ float smem[];
  __shared__ WarpConsts wc;
  const WarpConsts& c = wc;
  const int r = blockIdx.x, I = d.I, H = d.H, O = d.O, G = d.G;
  k1_fill_grid(wc, d);
  const KbCtx k = kb_stage(c1, w1, c2, w2, d, plan, 0, smem);
  const int warp = threadIdx.x / KW_LANES, lane = threadIdx.x % KW_LANES;
  const KbLanes ln = kb_lanes(d, plan, warp, lane);
  float* xs = k.rows;                               // [I]
  for (int q = threadIdx.x; q < I; q += KB_THREADS)
    xs[q] = x[(size_t)r * I + q];
  kb_stage_wait();
  kb_layer_fwd(k.P1, k.s1, I * G, ln.f1, plan.fstep, G,
               [&](int i, int g, bool sw, bool) {
                 return kb_term(xs[i], g, sw, d, c);
               },
               k.part1, lane);
  __syncthreads();
  for (int h = threadIdx.x; h < H; h += KB_THREADS)
    y1[(size_t)r * H + h] = kb_part_sum<kCompact>(k.part1, plan.f1.C, H, h);
  kb_layer_fwd(k.P2, k.s2, H * G, ln.f2, plan.fstep, G,
               [&](int h, int g, bool sw, bool) {
                 return kb_term(kb_part_sum<kCompact>(k.part1, plan.f1.C, H,
                                                      h),
                                g, sw, d, c);
               },
               k.part2, lane);
  __syncthreads();
  for (int o = threadIdx.x; o < O; o += KB_THREADS)
    y[(size_t)r * O + o] = kb_part_sum<kCompact>(k.part2, plan.f2.C, O, o);
}

// K1b-m: row blockIdx.x, its record at scratch + r * width. A thread a
// term rebuilds both layers' term values (into the record) and, but
// compact, their slopes; then layer 2's VJP (dy1, into the record and
// shared memory) and layer 1's (dx). The sums are K2b's launch, also at
// K = 1: the packed ensemble's 15,360 outer products in this block took
// longer than that launch (PERF.md, the K1 findings).
template <bool kCompact>
__global__ void __launch_bounds__(KB_THREADS)
chain_apply_bwd_mid_kernel(const float* x, const float* y1, const float* gy,
                           const float* c1, const float* w1, const float* c2,
                           const float* w2, float* dx,
                           float* scratch, ChainDims d, KbPlan plan) {
  extern __shared__ float smem[];
  __shared__ WarpConsts wc;
  const WarpConsts& c = wc;
  const int r = blockIdx.x, I = d.I, H = d.H, O = d.O, G = d.G, G1 = G + 1;
  k1_fill_grid(wc, d);
  const KbCtx k = kb_stage(c1, w1, c2, w2, d, plan, 0, smem);
  const int warp = threadIdx.x / KW_LANES, lane = threadIdx.x % KW_LANES;
  const KbLanes ln = kb_lanes(d, plan, warp, lane);
  const RecLayout L = kc_rec_layout(I, H, O, G);
  float* xs = k.lead;                               // [I]
  float* ys = xs + I;                               // [H]
  float* gs = ys + H;                               // [O]
  float* dy1 = gs + O;                              // [H]
  float* fac = dy1 + H;          // [(I + H)(G + 1)]: layer 1's, then 2's
  float* tw = fac + (kCompact ? 0 : (size_t)(I + H) * G1);
  float* rec = scratch + (size_t)r * L.width;
  for (int q = threadIdx.x; q < I; q += KB_THREADS)
    xs[q] = x[(size_t)r * I + q];
  for (int h = threadIdx.x; h < H; h += KB_THREADS)
    ys[h] = y1[(size_t)r * H + h];
  for (int o = threadIdx.x; o < O; o += KB_THREADS) {
    const float v = gy[(size_t)r * O + o];
    gs[o] = v;
    rec[L.gk + o] = v;
  }
  kb_stage_wait();
  // the terms: layer 1's I G basis terms (i G + g), its I swish terms,
  // then layer 2's H G and H, each as kb_eval keeps them
  const int T1 = I * G1;
  for (int t = threadIdx.x; t < (I + H) * G1; t += KB_THREADS) {
    const bool two = t >= T1;
    const int l = two ? t - T1 : t, n = two ? H : I, nG = n * G;
    const bool sw = l >= nG;
    const int i = sw ? l - nG : l / G, g = sw ? 0 : l - i * G;
    const float v = two ? ys[i] : xs[i];
    const int at = sw ? (two ? L.swy1 : L.swx) + i
                      : (two ? L.b2 : L.b1) + l;
    if constexpr (kCompact) {
      rec[at] = kb_term(v, g, sw, d, c);
    } else {
      float fc;
      rec[at] = kb_value_fac(v, kb_u(v, g, d, c), sw, d.basis, d.inv_h, fc);
      fac[t] = fc;
    }
  }
  __syncthreads();
  float* twp = tw + warp * kb_vjp_terms(d);
  kb_layer_vjp<kCompact>(k.P2, k.s2, H, O, gs, ys, plan.v2, ln.v2,
                         plan.vstep2, d, c, kCompact ? nullptr : fac + T1,
                         twp,
                         [&](int h, float v) {
                           dy1[h] = v;
                           rec[L.dy1 + h] = v;
                         },
                         warp, lane);
  __syncthreads();
  kb_layer_vjp<kCompact>(k.P1, k.s1, I, H, dy1, xs, plan.v1, ln.v1,
                         plan.vstep1, d, c, kCompact ? nullptr : fac, twp,
                         [&](int q, float v) { dx[(size_t)r * I + q] = v; },
                         warp, lane);
}

// Refuse a chain or rows the plan's flavor does not take (the wrapper
// checks them first).
bool k1_admits(const ChainDims& d, int K, const K1Plan& p) {
  if (K < 1) return false;
  if (!p.medium) return true;
  return d.I >= 1 && d.I <= KB_MAX_I && d.O >= 1 && d.O <= KB_MAX_I
         && d.H >= 1 && d.H <= KB_MAX_H && d.G >= 2 && d.G <= KC_MAX_G
         && p.fwd_smem <= KB_MAX_SMEM && p.bwd_smem <= KB_MAX_SMEM;
}

}  // namespace

extern "C" {

// K1's launch plan over K rows (the wrapper's `chain_apply_plan` computes
// the same): out[0..9] = medium, compact, fwd_rows, fwd_warps, fwd_blocks,
// bwd_rows, bwd_warps, bwd_blocks, fwd_smem, bwd_smem.
void k1_plan(const ChainDims* d, int K, int* out) {
  const K1Plan p = k1_plan_of(*d, K);
  const int v[10] = {p.medium,     p.compact,  p.fwd_rows, p.fwd_warps,
                     p.fwd_blocks, p.bwd_rows, p.bwd_warps, p.bwd_blocks,
                     p.fwd_smem,   p.bwd_smem};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
}

// K1f over K rows in the plan's flavor.
int kc_chain_apply_fwd(const float* x, const float* c1, const float* w1,
                       const float* c2, const float* w2, float* y, float* y1,
                       int K, const ChainDims* d, void* stream) {
  const K1Plan p = k1_plan_of(*d, K);
  if (!k1_admits(*d, K, p)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (!p.medium) {
    err = kc_smem_opt_in(chain_apply_fwd_kernel, p.fwd_smem);
    if (err != cudaSuccess) return (int)err;
    chain_apply_fwd_kernel<<<p.fwd_blocks, p.fwd_warps * KW_LANES,
                             p.fwd_smem, st>>>(x, c1, w1, c2, w2, y, y1, K,
                                               p.fwd_rows, *d);
    return (int)cudaGetLastError();
  }
  KbPlan plan = kb_plan_of(*d);
  plan.compact = p.compact;
  const auto kernel = p.compact ? chain_apply_fwd_mid_kernel<true>
                                : chain_apply_fwd_mid_kernel<false>;
  err = kc_smem_opt_in(kernel, p.fwd_smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<K, KB_THREADS, p.fwd_smem, st>>>(x, c1, w1, c2, w2, y, y1, *d,
                                            plan);
  return (int)cudaGetLastError();
}

// K1b over K rows in the plan's flavor. direct (K = 1, small flavor only):
// the cotangents as the record's outer products in the same launch; else
// the K records into scratch (K * kc_rec_layout width floats) and K2b's
// parameter sums as a second launch.
int kc_chain_apply_bwd(const float* x, const float* y1, const float* gy,
                       const float* c1, const float* w1, const float* c2,
                       const float* w2, float* dx, float* dc1, float* dw1,
                       float* dc2, float* dw2, float* scratch, int K,
                       int direct, const ChainDims* d, void* stream) {
  const K1Plan p = k1_plan_of(*d, K);
  if (!k1_admits(*d, K, p) || (direct && (K != 1 || p.medium)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (!p.medium) {
    err = kc_smem_opt_in(chain_apply_bwd_kernel, p.bwd_smem);
    if (err != cudaSuccess) return (int)err;
    chain_apply_bwd_kernel<<<p.bwd_blocks, p.bwd_warps * KW_LANES,
                             p.bwd_smem, st>>>(
        x, y1, gy, c1, w1, c2, w2, dx, dc1, dw1, dc2, dw2, scratch, K,
        p.bwd_rows, direct, *d);
  } else {
    KbPlan plan = kb_plan_of(*d);
    plan.compact = p.compact;
    const auto kernel = p.compact ? chain_apply_bwd_mid_kernel<true>
                                  : chain_apply_bwd_mid_kernel<false>;
    err = kc_smem_opt_in(kernel, p.bwd_smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<K, KB_THREADS, p.bwd_smem, st>>>(x, y1, gy, c1, w1, c2, w2, dx,
                                              scratch, *d, plan);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || direct) return (int)err;
  return (int)kc_launch_param_sums(scratch, K, *d, dc1, dw1, dc2, dw2, st);
}

}  // extern "C"
