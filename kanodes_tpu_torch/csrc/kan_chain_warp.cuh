// The discrete adjoint of explicit RK steps over the 2-layer KDense chain
// with a warp on each row of the batch: the LV adjoint sweeps K3b
// (rk_fused.cu) and K4b (rk_adaptive.cu), and at one step the LV step
// adjoint K2b (rk_fused.cu). The same math as one thread a row running
// each layer's forward (inputs i, then basis g, a sum per output) and its
// VJP on both layers.
// At the end of the file, the chain forward of K4f (rk_adaptive.cu), which
// K3f, K2f and K1f also run, on a warp, bit for bit the one-thread chain's.
//
// Why: one thread per row ran each chain evaluation as a dependent chain
// of ~3 * 10^4 cycles, its run-time-indexed per-row arrays on the stack,
// so that every accumulation was a local load and store (PERF.md, the
// K3b/K4b trace).
//
// Two phases over a chunk of steps, split by the host's launch plan
// (`warp_adjoint_plan`, ops/_cuda.py), each ending in a __syncthreads:
//   A. every warp of the block takes (row, step) items in turn and
//      rebuilds the step's stages from the stored step input. With each
//      chain evaluation it stores the record fields that no cotangent
//      enters (b1, swx, b2, swy1 of kc_rec_layout) and the evaluation's
//      Jacobian in factors (the "factors", in shared memory): A2[h][o] =
//      dk_o/dy1_h, A1[i][h] = dy1_h/dx_i and J[o][i] = sum_h A2[h][o]
//      A1[i][h]. Steps do not depend on each other here, so the rebuild,
//      half of a one-warp sweep's time, runs 8 steps at a time;
//   B. the warp of each row runs the reverse recursion over the chunk's
//      steps. A stage's VJP is then dx_i = sum_o J[o][i] gk_o in lane i,
//      and, for the record only, dy1_h = sum_o A2[h][o] gk_o in lane h:
//      a few multiply-adds on the dependent chain instead of a chain
//      evaluation.
// Lane map (H <= 32, one warp holds a row): layer-1 term l = i*G + g
// (l < I*G) or the swish term of input l - I*G in lane l % 32; hidden unit
// h in lane h; output o (layer-2 sums in h order) and state component q
// in lanes o, q < I. Every sum has a fixed order, so a launch repeats bit
// for bit. Per-lane values live in registers (arrays only with
// compile-time indices); the row's stage vectors, terms and partials in
// the warp's WarpRow, the factors in the chunk's buffer, the
// run-time-indexed constants in the block's WarpConsts (shared memory
// all); the ChainDims scalars are read from the kernel's parameters.
// Nothing is on the stack. Multiply-adds in the chain are explicit fmaf:
// it rounds alike in both files, whatever their -fmad flag.

#pragma once

#include "kan_chain.cuh"

#define KW_LANES 32
#define KW_MAX_WARPS 8      // a block's warps at most
#define KW_TERMS (KC_MAX_I * KC_MAX_G + KC_MAX_I)

// One warp's workspace (shared memory).
struct WarpRow {
  float xs[KC_MAX_STAGES][KC_MAX_I];   // stage inputs
  float ks[KC_MAX_STAGES][KC_MAX_I];   // stage values (ks[0]: FSAL k1)
  float kb[KC_MAX_STAGES][KC_MAX_I];   // stage cotangents
  float b[KW_TERMS];                   // layer 1: B(u_ig), then swish(x_i)
  float t[KW_TERMS];                   // B'(u_ig)/h, then norm'(x_i)
  float dsx[KC_MAX_I];                 // swish'(x_i)
  float part[KC_MAX_I][KC_MAX_H];      // layer-2 partials, one a lane
};

// The block's run-time-indexed constants (shared memory): the tableau
// (a[i][j] zero where a fixed-step stage j is not needed), the grid, and
// for layer-1 term l its input index and basis center.
struct WarpConsts {
  float a[KC_MAX_STAGES][KC_MAX_STAGES];
  float b[KC_MAX_STAGES];
  int needed[KC_MAX_STAGES];
  float grid[KC_MAX_G];
  int term_x[KW_TERMS];
  float term_c[KW_TERMS];
};

// The factors of one chain evaluation: A2 [H][O], A1 [I][H], J [O][I].
struct FactorLayout {
  int a2, a1, j, width;
};

__host__ __device__ inline FactorLayout kw_factor_layout(const ChainDims& d) {
  FactorLayout f;
  f.a2 = 0;
  f.a1 = f.a2 + d.H * d.O;
  f.j = f.a1 + d.I * d.H;
  f.width = f.j + d.O * d.I;
  return f;
}

// Dynamic shared memory of a launch, in floats: the parameters, one
// WarpRow a warp, and the factors of `chunk` steps of `slots` chain
// evaluations for each of `row_warps` rows.
__host__ __device__ inline size_t kw_smem_floats(const ChainDims& d,
                                                int warps, int row_warps,
                                                int chunk, int slots) {
  return kc_param_floats(d) + (size_t)warps * (sizeof(WarpRow) / 4)
         + (size_t)row_warps * chunk * slots * kw_factor_layout(d).width;
}

// Thread 0 copies the grid and a tableau (a, b, needed; a stage j with
// needed[j] = 0 gets a zero column) into c, reading the kernel's
// parameters at compile-time offsets only (a run-time index would copy
// them to the stack). Every thread then calls kw_fill_terms after a
// __syncthreads.
__device__ inline void kw_fill_consts(
    WarpConsts& c, const ChainDims& d, int stages,
    const float (&a)[KC_MAX_STAGES][KC_MAX_STAGES],
    const float (&b)[KC_MAX_STAGES], const int (&needed)[KC_MAX_STAGES]) {
  if (threadIdx.x != 0) return;
#pragma unroll
  for (int i = 0; i < KC_MAX_STAGES; ++i) {
#pragma unroll
    for (int j = 0; j < KC_MAX_STAGES; ++j)
      c.a[i][j] = i < stages && j < i && needed[j] ? a[i][j] : 0.0f;
    c.b[i] = i < stages ? b[i] : 0.0f;
    c.needed[i] = i < stages && needed[i];
  }
#pragma unroll
  for (int g = 0; g < KC_MAX_G; ++g) c.grid[g] = d.grid[g];
}

// The layer-1 term table from c.grid; every thread zeroes its warp's
// stage values (a stage no output needs is never written, yet enters the
// unrolled stage sums with a zero coefficient). Every thread of the block
// calls it; a __syncthreads must follow.
__device__ inline void kw_fill_terms(WarpConsts& c, const ChainDims& d,
                                     WarpRow& w, int lane) {
  const int IG = d.I * d.G;
  for (int l = threadIdx.x; l < IG + d.I; l += blockDim.x) {
    c.term_x[l] = l < IG ? l / d.G : l - IG;
    c.term_c[l] = l < IG ? c.grid[l % d.G] : 0.0f;
  }
  for (int q = lane; q < KC_MAX_STAGES * KC_MAX_I; q += KW_LANES)
    (&w.ks[0][0])[q] = 0.0f;
}

// Chain forward at the warp-uniform input x (shared memory, d.I values):
// lane o < O writes kout[o]; the evaluation's Jacobian factors go to fac
// (shared memory, kw_factor_layout) and its record fields b1, swx, b2,
// swy1 to rec. Uses w.b, w.t, w.dsx and w.part; the caller syncs the
// warp before kout or fac is read.
__device__ inline void kw_chain_fwd(const float* x, float* kout, float* fac,
                                    float* rec, const ChainDims& d,
                                    const WarpConsts& c,
                                    const ChainParams& p, const RecLayout& L,
                                    WarpRow& w, int lane) {
  const int I = d.I, H = d.H, O = d.O, G = d.G, IG = I * G;
  const FactorLayout F = kw_factor_layout(d);
  for (int l = lane; l < IG + I; l += KW_LANES) {
    const float xv = x[c.term_x[l]];
    if (l < IG) {
      const float u = (kc_norm(xv, d.normalizer) - c.term_c[l]) * d.inv_h;
      const float B = kc_basis(u, d.basis);
      w.b[l] = B;
      w.t[l] = kc_basis_du(u, B, d.basis) * d.inv_h;
      rec[L.b1 + l] = B;
    } else {
      const int i = l - IG;
      const float sw = kc_swish(xv);
      w.b[l] = sw;
      w.t[l] = kc_dnorm(xv, d.normalizer);
      w.dsx[i] = kc_dswish(xv);
      rec[L.swx + i] = sw;
    }
  }
  __syncwarp();
  if (lane < H) {
    float ac = 0.0f, aw = 0.0f;
    for (int l = 0; l < IG; ++l) ac = fmaf(w.b[l], p.c1[l * H + lane], ac);
    for (int i = 0; i < I; ++i)
      aw = fmaf(w.b[IG + i], p.w1[i * H + lane], aw);
    const float y = ac + aw;
    const float yn = kc_norm(y, d.normalizer);
    float part[KC_MAX_I], a2[KC_MAX_I];
#pragma unroll
    for (int o = 0; o < KC_MAX_I; ++o) part[o] = a2[o] = 0.0f;
    for (int g = 0; g < G; ++g) {
      const float u = (yn - c.grid[g]) * d.inv_h;
      const float B = kc_basis(u, d.basis);
      const float P = kc_basis_du(u, B, d.basis) * d.inv_h;
      rec[L.b2 + lane * G + g] = B;
      const float* row = p.c2 + (lane * G + g) * O;
#pragma unroll
      for (int o = 0; o < KC_MAX_I; ++o) {
        if (o < O) {
          part[o] = fmaf(B, row[o], part[o]);
          a2[o] = fmaf(P, row[o], a2[o]);
        }
      }
    }
    const float sw = kc_swish(y);
    const float dn = kc_dnorm(y, d.normalizer), ds = kc_dswish(y);
    rec[L.swy1 + lane] = sw;
#pragma unroll
    for (int o = 0; o < KC_MAX_I; ++o) {
      if (o < O) {
        const float wv = p.w2[lane * O + o];
        w.part[o][lane] = fmaf(sw, wv, part[o]);
        fac[F.a2 + lane * O + o] = fmaf(a2[o], dn, wv * ds);
      }
    }
    // A1[i][h] = norm'(x_i) sum_g c1[ig, h] B'_ig/h + swish'(x_i) w1[i, h]
    for (int i = 0; i < I; ++i) {
      float a = 0.0f;
      for (int g = 0; g < G; ++g)
        a = fmaf(p.c1[(i * G + g) * H + lane], w.t[i * G + g], a);
      fac[F.a1 + i * H + lane] =
          fmaf(a, w.t[IG + i], p.w1[i * H + lane] * w.dsx[i]);
    }
  }
  __syncwarp();
  if (lane < O) {
    float k = 0.0f;
    for (int h = 0; h < H; ++h) k += w.part[lane][h];
    kout[lane] = k;
  }
  // J[o][i] = sum_h A2[h][o] A1[i][h], one entry a lane
  for (int e = lane; e < O * I; e += KW_LANES) {
    const int o = e / I, i = e - o * I;
    float jv = 0.0f;
    for (int h = 0; h < H; ++h)
      jv = fmaf(fac[F.a2 + h * O + o], fac[F.a1 + i * H + h], jv);
    fac[F.j + e] = jv;
  }
}

// Chain VJP with cotangent gk (shared memory, O values) from the factors
// fac of the evaluation (kw_chain_fwd): returns dx[lane] = sum_o J[o][lane]
// gk_o in lanes < I (0 elsewhere) and writes the record fields dy1 (sum_o
// A2[h][o] gk_o) and gk at rec.
__device__ inline float kw_chain_vjp(const float* gk, const float* fac,
                                     float* rec, const ChainDims& d,
                                     const RecLayout& L, int lane) {
  const int I = d.I, H = d.H, O = d.O;
  const FactorLayout F = kw_factor_layout(d);
  float dx = 0.0f;
  if (lane < I)
    for (int o = 0; o < O; ++o) dx = fmaf(fac[F.j + o * I + lane], gk[o], dx);
  if (lane < H) {
    float dy = 0.0f;
    for (int o = 0; o < O; ++o)
      dy = fmaf(fac[F.a2 + lane * O + o], gk[o], dy);
    rec[L.dy1 + lane] = dy;
  }
  if (lane < O) rec[L.gk + lane] = gk[lane];
  return dx;
}

// Phase A of a fixed-step RK step for one row: the stages from the step
// input x (global) with c.a = dt a_ij; one chain evaluation a needed
// stage, its factors at fac + slot * F.width and its record at rec +
// slot * L.width (slot = rank among the needed stages).
__device__ inline void kw_rk_step_stages(const float* x, int stages,
                                         const ChainDims& d,
                                         const WarpConsts& c,
                                         const ChainParams& p,
                                         const RecLayout& L, WarpRow& w,
                                         int lane, float* fac, float* rec) {
  const int fw = kw_factor_layout(d).width;
  const bool mine = lane < d.I;
  const float xq = mine ? x[lane] : 0.0f;
  int slot = 0;
  for (int s = 0; s < stages; ++s) {
    if (!c.needed[s]) continue;
    if (mine) {
      float v = xq;
#pragma unroll
      for (int j = 0; j < KC_MAX_STAGES - 1; ++j)
        if (j < s) v = fmaf(c.a[s][j], w.ks[j][lane], v);
      w.xs[s][lane] = v;
    }
    __syncwarp();
    kw_chain_fwd(w.xs[s], w.ks[s], fac + slot * fw, rec + slot * L.width, d,
                 c, p, L, w, lane);
    __syncwarp();
    ++slot;
  }
}

// Phase B of a fixed-step RK step for one row (the recursion of
// `_step_bwd_kernel`, kanodes_tpu/ops/rk_fused.py): kbar_i = dt b_i gy,
// then for i = s-1..0 the chain VJP with kbar_i from the step's factors,
// its dx added into the state cotangent and (dt a_ij) dx_i passed to the
// earlier stages. gy and the returned dx
// are lane q's component (lanes < I).
__device__ inline float kw_rk_step_reverse(float gy, int stages, int slots,
                                           const ChainDims& d,
                                           const WarpConsts& c,
                                           const RecLayout& L, WarpRow& w,
                                           int lane, const float* fac,
                                           float* rec) {
  const int fw = kw_factor_layout(d).width;
  const bool mine = lane < d.I;
  if (mine)
    for (int s = 0; s < stages; ++s) w.kb[s][lane] = c.b[s] * gy;
  __syncwarp();
  float dx = gy;
  int slot = slots;
  for (int s = stages - 1; s >= 0; --s) {
    if (!c.needed[s]) continue;
    --slot;
    const float dxi = kw_chain_vjp(w.kb[s], fac + slot * fw,
                                   rec + slot * L.width, d, L, lane);
    if (mine) {
      dx = dx + dxi;
#pragma unroll
      for (int j = 0; j < KC_MAX_STAGES - 1; ++j)
        if (j < s) w.kb[j][lane] = fmaf(c.a[s][j], dxi, w.kb[j][lane]);
    }
    __syncwarp();
  }
  return dx;
}

// ---------------------------------------------------------------------------
// The chain FORWARD of one row by one warp, bit for bit what one thread
// gives that sums each layer's terms per output (inputs i, then basis g,
// then the swish terms) in a file built with -fmad=false: K4f
// (rk_adaptive.cu) runs it, and K3f can take it. Every product and sum is
// an explicit __fmul_rn / __fadd_rn (and the elementwise functions below
// spell theirs out the same way), so it rounds alike whatever the -fmad
// flag of the file that includes it.
//
// Lane map: layer-1 term l = i*G + g, or the swish term of input l - I*G,
// in lane l % 32; hidden unit h in lane h, which sums layer 1 for h in the
// one-thread order (i then g, then the swish terms), normalizes y1_h and
// forms the swish products swish(y1_h) w2[h, o]; layer-2 term m = h*G + g
// in lane m % 32, which forms B(u_hg) c2[hg, o]; output o in lane o, which
// adds the basis products up in the one-thread order (h then g) while lane
// O + o adds the swish products (h), then lane o adds the two. A product
// rounds the same whichever lane forms it, so only the order of each sum
// matters, and it is kept.
// ---------------------------------------------------------------------------

#define KF_REG 16           // layer-1 terms whose c1 entry a lane keeps in
                            // registers (the rest: shared memory)
#define KF_MAX_WARPS 16     // a K4f block's warps at most

__device__ __forceinline__ float kf_norm(float x, int kind) {
  return kind == 0 ? tanhf(x) : __fdiv_rn(x, __fadd_rn(1.0f, fabsf(x)));
}

__device__ __forceinline__ float kf_basis(float u, int kind) {
  if (kind == 0) return expf(-__fmul_rn(u, u));
  if (kind == 1) return __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(u, u)));
  const float t = tanhf(u);
  return __fsub_rn(1.0f, __fmul_rn(t, t));
}

__device__ __forceinline__ float kf_swish(float x) {
  return __fmul_rn(x, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x))));
}

// (norm(x) - c) / h as the one-thread layer forms it
__device__ __forceinline__ float kf_u(float xn, float c, float inv_h) {
  return __fmul_rn(__fsub_rn(xn, c), inv_h);
}

// acc + v[0] + v[stride] + ... + v[(n-1) stride], added in that order; the
// loads go ahead of the adds eight at a time
__device__ __forceinline__ float kf_sum_in_order(float acc, const float* v,
                                                 int n, int stride) {
  int m = 0;
  for (; m + 8 <= n; m += 8) {
    float t[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) t[u] = v[(m + u) * stride];
#pragma unroll
    for (int u = 0; u < 8; ++u) acc = __fadd_rn(acc, t[u]);
  }
  for (; m < n; ++m) acc = __fadd_rn(acc, v[m * stride]);
  return acc;
}

// Lane h's slices of the parameters, kept in registers for a whole solve
// (compile-time indices only): the first KF_REG entries of its column of
// c1, its column of w1 and its row of w2.
struct KfRegs {
  float c1[KF_REG];
  float w1[KC_MAX_I];
  float w2[KC_MAX_I];
};

__device__ inline void kf_load_regs(KfRegs& r, const ChainParams& p,
                                    const ChainDims& d, int lane) {
  const int h = lane < d.H ? lane : 0;      // lanes >= H never use them
#pragma unroll
  for (int l = 0; l < KF_REG; ++l)
    r.c1[l] = l < d.I * d.G ? p.c1[l * d.H + h] : 0.0f;
#pragma unroll
  for (int i = 0; i < KC_MAX_I; ++i) {
    r.w1[i] = i < d.I ? p.w1[i * d.H + h] : 0.0f;
    r.w2[i] = i < d.O ? p.w2[h * d.O + i] : 0.0f;
  }
}

// The hidden unit of layer-2 term m = h*G + g (shared memory, filled once
// by every thread of the block; a __syncthreads must follow).
__device__ inline void kf_fill_l2(unsigned char* l2h, const ChainDims& d) {
  for (int m = threadIdx.x; m < d.H * d.G; m += blockDim.x)
    l2h[m] = (unsigned char)(m / d.G);
}

// Floats of one warp's forward workspace: the basis and swish terms of
// layer 1 [I*G + I], the normalized hidden values [H], then layer 2's
// products [H*G + H][O].
__host__ __device__ inline int kf_chain_ws_floats(const ChainDims& d) {
  return d.I * d.G + d.I + d.H + (d.H * d.G + d.H) * d.O;
}

// k = layer2(layer1(x)) for the warp-uniform input x (shared memory, d.I
// values): lane o < O writes kout[o]. c holds the grid and the layer-1
// term table (kw_fill_consts, then the terms), l2h the layer-2 term table
// (kf_fill_l2), ws the warp's workspace of kf_chain_ws_floats(d) floats.
// The caller syncs the warp before kout is read and before x or ws is
// written again. kY1 (K1f, kan_chain_apply.cu): lane h < H also writes the
// hidden output y1_h (layer 1's sum, before normalizing) to y1[h]; the
// other callers keep the default, whose code is the same as without it.
template <bool kY1 = false>
__device__ inline void kf_chain_fwd(const float* x, float* kout,
                                    const ChainDims& d, const WarpConsts& c,
                                    const unsigned char* l2h,
                                    const ChainParams& p, const KfRegs& rg,
                                    float* ws, int lane,
                                    float* y1 = nullptr) {
  const int I = d.I, H = d.H, O = d.O, G = d.G, IG = I * G, HG = H * G;
  float* b1 = ws;                  // [IG + I]
  float* yn = b1 + IG + I;         // [H]
  float* p2 = yn + H;              // [HG + H][O]
  for (int l = lane; l < IG + I; l += KW_LANES) {
    if (l < IG) {
      const float xn = kf_norm(x[c.term_x[l]], d.normalizer);
      b1[l] = kf_basis(kf_u(xn, c.term_c[l], d.inv_h), d.basis);
    } else {
      b1[l] = kf_swish(x[l - IG]);
    }
  }
  __syncwarp();
  if (lane < H) {
    float ac = 0.0f;
#pragma unroll
    for (int l = 0; l < KF_REG; ++l)
      if (l < IG) ac = __fadd_rn(ac, __fmul_rn(b1[l], rg.c1[l]));
    for (int l = KF_REG; l < IG; ++l)
      ac = __fadd_rn(ac, __fmul_rn(b1[l], p.c1[l * H + lane]));
    float aw = 0.0f;
#pragma unroll
    for (int i = 0; i < KC_MAX_I; ++i)
      if (i < I) aw = __fadd_rn(aw, __fmul_rn(b1[IG + i], rg.w1[i]));
    const float y = __fadd_rn(ac, aw);
    if constexpr (kY1) y1[lane] = y;
    yn[lane] = kf_norm(y, d.normalizer);
    const float sw = kf_swish(y);
    float* out = p2 + (HG + lane) * O;
#pragma unroll
    for (int o = 0; o < KC_MAX_I; ++o)
      if (o < O) out[o] = __fmul_rn(sw, rg.w2[o]);
  }
  __syncwarp();
  // two terms a lane at a time, so that their basis functions overlap
  for (int m = lane; m < HG; m += 2 * KW_LANES) {
    const int m2 = m + KW_LANES < HG ? m + KW_LANES : m;
    const int h = l2h[m], h2 = l2h[m2];
    const float B = kf_basis(kf_u(yn[h], c.grid[m - h * G], d.inv_h),
                             d.basis);
    const float B2 = kf_basis(kf_u(yn[h2], c.grid[m2 - h2 * G], d.inv_h),
                              d.basis);
    float v[KC_MAX_I], v2[KC_MAX_I];
#pragma unroll
    for (int o = 0; o < KC_MAX_I; ++o) {
      v[o] = o < O ? __fmul_rn(B, p.c2[m * O + o]) : 0.0f;
      v2[o] = o < O ? __fmul_rn(B2, p.c2[m2 * O + o]) : 0.0f;
    }
#pragma unroll
    for (int o = 0; o < KC_MAX_I; ++o)
      if (o < O) {
        p2[m * O + o] = v[o];
        p2[m2 * O + o] = v2[o];
      }
  }
  __syncwarp();
  // lane o adds the basis products, lane O + o the swish products (one
  // code path, different lengths)
  float sum = 0.0f;
  if (lane < 2 * O)
    sum = kf_sum_in_order(0.0f, p2 + (lane < O ? lane : HG * O + lane - O),
                          lane < O ? HG : H, O);
  const float aw = __shfl_down_sync(0xffffffffu, sum, O);
  if (lane < O) kout[lane] = __fadd_rn(sum, aw);
}
