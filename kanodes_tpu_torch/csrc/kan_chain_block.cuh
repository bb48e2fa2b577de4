// K2 and K3 at medium widths: one explicit RK step over the 2-layer
// KDense chain, n such steps, and their discrete adjoints, with ONE BLOCK
// ON EACH ROW of the batch, for chains past the one-thread / one-warp
// caps of kan_chain.cuh (I, O <= 8, H <= 32): the Burgers and 1-D
// Allen-Cahn surrogates [41, 10, 41] (grid 5 and 10) and the packed
// 8-member LV ensemble [16, 80, 16] (grid 5). rk_fused.cu launches them.
//
// Computes what `_step_fwd_kernel`, `_step_bwd_kernel`,
// `_multistep_fwd_kernel` and `_multistep_bwd_kernel`
// (kanodes_tpu/ops/rk_fused.py:144,167,311,346) compute, with the chain of
// `_chain_f` / `_chain_vjp` (:70-117).
//
// What bounds it on this card: latency. A row is a chain of s dependent
// chain evaluations a step (tsit5: 6); one evaluation at [41, 10, 41] G = 5
// is ~5e4 flops over 20 KB of parameters, far below a microsecond of the
// card's rates. Rows are few (K <= 34 on the reference paths) and wide, so
// a thread or a warp a row cannot hold a row's state and the work of an
// evaluation has to be spread.
//
// What the design does about it: a block of KB_THREADS threads a row; the
// parameters are staged once per launch in shared memory (20, 36 and 62
// KB at the three reference chains: above 48 KB opted in), transposed so
// that layer 1's rows are [c1 ; w1] columns C1T[h][l] (l < I*G basis
// terms, then I swish terms) and layer 2's C2T[o][m] (m < H*G, then H).
//   * forward: the layer's features (basis and swish values) one a thread;
//     then warps over the hidden units (layer 1) or outputs (layer 2),
//     whose lanes take every 32nd term and add their partials in a fixed
//     xor-shuffle tree. Block barriers only, between the phases;
//   * backward: the stages rebuilt from the step input with the forward's
//     routine (stage inputs, values and hidden vectors in shared memory),
//     then the reverse recursion: for each stage from the last, a thread a
//     layer-2 term (its row of C2T^T gk), a thread a hidden unit (dy1), a
//     thread a layer-1 term (its row of C1T^T dy1) and a thread a state
//     component (dx, and dt a_ij dx passed to the earlier stages). It
//     writes one record a (step, row, stage) of the operands of the
//     parameter cotangents (kc_rec_layout: b1, swx, dy1, b2, swy1, gk);
//     a second launch, counted with its parent, sums them a thread a
//     parameter over as many blocks as the parameters need, each in record
//     order: a fixed order, no float atomics, so runs repeat bit for bit.
//     The products `_chain_param_gemms` forms on the TPU are these sums.
// Every sum has a fixed order. The features use kan_chain_warp.cuh's
// kf_norm / kf_basis / kf_swish, the slopes kan_chain.cuh's.

#pragma once

#include "kan_chain_warp.cuh"

// Caps of the medium flavor; the Python wrapper checks every launch
// against them (ops/_cuda.py, `check_block_caps`).
#define KB_THREADS 256        // a block's threads (8 warps)
#define KB_MAX_I 1024         // state width I (= chain output width O)
#define KB_MAX_H 256          // hidden width H
// grid length G <= KC_MAX_G, stages <= KC_MAX_STAGES (kan_chain.cuh), and
// the dynamic shared memory of a launch (kb_smem_floats) at most
#define KB_MAX_SMEM (232448 - 4096)

// The parameters as staged in shared memory: C1T [H][I*G + I], C2T
// [O][H*G + H].
struct BlockParams {
  const float* c1t;
  const float* c2t;
};

__host__ __device__ inline int kb_l1(const ChainDims& d) {
  return d.I * d.G + d.I;
}

__host__ __device__ inline int kb_l2(const ChainDims& d) {
  return d.H * d.G + d.H;
}

// One evaluation's workspace: layer-1 features (or, in the adjoint, their
// cotangent terms) [L1], the hidden vector [H], layer-2 features [L2].
__host__ __device__ inline int kb_ws_floats(const ChainDims& d) {
  return kb_l1(d) + d.H + kb_l2(d);
}

// Floats of a launch's dynamic shared memory: the parameters, then for
// the forward the state, the stage input and the stage values [S][I]; for
// the adjoint the step input, its cotangent and the running dx, the stage
// inputs, values and cotangents [S][I] and hidden vectors [S][H]; then the
// workspace.
__host__ __device__ inline size_t kb_smem_floats(const ChainDims& d,
                                                int stages, bool backward) {
  const size_t rows = backward
      ? 3 * (size_t)d.I + (size_t)stages * (3 * d.I + d.H)
      : 2 * (size_t)d.I + (size_t)stages * d.I;
  return kc_param_floats(d) + rows + kb_ws_floats(d);
}

// Copy c1 [I*G, H], w1 [I, H], c2 [H*G, O], w2 [H, O] (global, row-major)
// into shared memory as C1T | C2T. Ends in __syncthreads: every thread of
// the block calls it.
__device__ inline BlockParams kb_stage_params(const float* c1, const float* w1,
                                              const float* c2, const float* w2,
                                              const ChainDims& d,
                                              float* smem) {
  const int H = d.H, O = d.O, IG = d.I * d.G, HG = H * d.G;
  const int L1 = kb_l1(d), L2 = kb_l2(d);
  float* c1t = smem;
  float* c2t = c1t + H * L1;
  // global reads in order (coalesced); the transposed writes are strided
  for (int e = threadIdx.x; e < IG * H; e += blockDim.x)
    c1t[(e % H) * L1 + e / H] = c1[e];
  for (int e = threadIdx.x; e < d.I * H; e += blockDim.x)
    c1t[(e % H) * L1 + IG + e / H] = w1[e];
  for (int e = threadIdx.x; e < HG * O; e += blockDim.x)
    c2t[(e % O) * L2 + e / O] = c2[e];
  for (int e = threadIdx.x; e < H * O; e += blockDim.x)
    c2t[(e % O) * L2 + HG + e / O] = w2[e];
  __syncthreads();
  BlockParams p;
  p.c1t = c1t;
  p.c2t = c2t;
  return p;
}

// The sum of v over the warp's lanes, in a fixed order (every lane gets it).
__device__ __forceinline__ float kb_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows[r] . f for r = warp, warp + warps, ... < n_rows, each row of length
// n: the lanes take every 32nd term, then the warp's shuffle tree; lane 0
// writes out[r].
__device__ inline void kb_matvec_rows(const float* rows, const float* f,
                                      int n_rows, int n, float* out) {
  const int lane = threadIdx.x % KW_LANES, warp = threadIdx.x / KW_LANES;
  const int warps = blockDim.x / KW_LANES;
  for (int r = warp; r < n_rows; r += warps) {
    const float* row = rows + (size_t)r * n;
    float acc = 0.0f;
    for (int l = lane; l < n; l += KW_LANES) acc = fmaf(f[l], row[l], acc);
    acc = kb_warp_sum(acc);
    if (lane == 0) out[r] = acc;
  }
}

// The features of a layer on n_in inputs v: term l < n_in*G is the basis
// value B((norm(v_i) - grid_g) / h), l = i*G + g; term n_in*G + i is
// swish(v_i).
__device__ inline void kb_features(const float* v, int n_in,
                                   const ChainDims& d, const WarpConsts& c,
                                   float* f) {
  const int G = d.G, nG = n_in * G;
  for (int l = threadIdx.x; l < nG + n_in; l += blockDim.x) {
    if (l < nG) {
      const int i = l / G;
      const float xn = kf_norm(v[i], d.normalizer);
      f[l] = kf_basis(kf_u(xn, c.grid[l - i * G], d.inv_h), d.basis);
    } else {
      f[l] = kf_swish(v[l - nG]);
    }
  }
}

// k = layer2(layer1(x)) for the block's row: x (shared memory, I values)
// -> kout [O] and the hidden vector y1 [H] (shared memory). ws: the
// workspace of kb_ws_floats(d) floats. Every thread calls it; it ends in
// __syncthreads.
__device__ inline void kb_chain_fwd(const float* x, float* kout, float* y1,
                                    const ChainDims& d, const WarpConsts& c,
                                    const BlockParams& p, float* ws) {
  float* b1 = ws;
  float* b2 = ws + kb_l1(d) + d.H;
  kb_features(x, d.I, d, c, b1);
  __syncthreads();
  kb_matvec_rows(p.c1t, b1, d.H, kb_l1(d), y1);
  __syncthreads();
  kb_features(y1, d.H, d, c, b2);
  __syncthreads();
  kb_matvec_rows(p.c2t, b2, d.O, kb_l2(d), kout);
  __syncthreads();
}

// The input of stage s: xi[q] = x[q] + sum_{j < s} (dt a_sj) ks[j][q]
// (c.a is zero past the stage and for a stage no output needs), over
// increasing j as `_step_fwd_kernel` adds them. A thread a component;
// ends in __syncthreads.
__device__ inline void kb_stage_input(const float* x, const float* ks, int s,
                                      const ChainDims& d, const WarpConsts& c,
                                      float* xi) {
  const int I = d.I;
  for (int q = threadIdx.x; q < I; q += blockDim.x) {
    float v = x[q];
    for (int j = 0; j < s; ++j) {
      const float a = c.a[s][j];
      if (a != 0.0f) v = v + a * ks[j * I + q];
    }
    xi[q] = v;
  }
  __syncthreads();
}

// One explicit RK step of the block's row: y = x + sum_i (dt b_i) k_i,
// stages in increasing order (x, y, xi, ks: shared memory; y may be x).
// Ends in __syncthreads.
__device__ inline void kb_rk_step(const float* x, float* y, int stages,
                                  const ChainDims& d, const WarpConsts& c,
                                  const BlockParams& p, float* xi, float* ks,
                                  float* ws) {
  const int I = d.I;
  float* y1 = ws + kb_l1(d);
  for (int s = 0; s < stages; ++s) {
    if (!c.needed[s]) continue;
    kb_stage_input(x, ks, s, d, c, xi);
    kb_chain_fwd(xi, ks + s * I, y1, d, c, p, ws);
  }
  for (int q = threadIdx.x; q < I; q += blockDim.x) {
    float acc = x[q];
    for (int s = 0; s < stages; ++s)
      if (c.b[s] != 0.0f) acc = acc + c.b[s] * ks[s * I + q];
    y[q] = acc;
  }
  __syncthreads();
}

// The shared-memory rows of the adjoint (kb_smem_floats, backward).
struct BlockAdjRows {
  float* x;      // step input [I]
  float* gy;     // its output cotangent [I]
  float* dx;     // the step input's cotangent [I]
  float* xs;     // stage inputs [S][I]
  float* ks;     // stage values [S][I]
  float* kb;     // stage cotangents [S][I]
  float* y1s;    // hidden vectors [S][H]
  float* ws;     // the workspace
};

__device__ inline BlockAdjRows kb_adj_rows(float* base, const ChainDims& d,
                                           int stages) {
  BlockAdjRows a;
  a.x = base;
  a.gy = a.x + d.I;
  a.dx = a.gy + d.I;
  a.xs = a.dx + d.I;
  a.ks = a.xs + stages * d.I;
  a.kb = a.ks + stages * d.I;
  a.y1s = a.kb + stages * d.I;
  a.ws = a.y1s + stages * d.H;
  return a;
}

// One layer's VJP terms for the cotangent gout of its output: for each
// term l (a thread a term) t[l] = (M^T gout)[l] times B'(u)/h for a basis
// term, as is for a swish term, where M is the layer's transposed rows
// (n_out rows of length n_in*(G+1)); the term's feature (basis or swish
// value of the input v) goes to rec[l].
__device__ inline void kb_layer_terms(const float* rows, const float* gout,
                                      int n_out, const float* v, int n_in,
                                      const ChainDims& d, const WarpConsts& c,
                                      float* t, float* rec) {
  const int G = d.G, nG = n_in * G, n = nG + n_in;
  for (int l = threadIdx.x; l < n; l += blockDim.x) {
    float m = 0.0f;
    for (int o = 0; o < n_out; ++o) m = fmaf(gout[o], rows[(size_t)o * n + l], m);
    if (l < nG) {
      const int i = l / G;
      const float xn = kf_norm(v[i], d.normalizer);
      const float u = kf_u(xn, c.grid[l - i * G], d.inv_h);
      const float B = kf_basis(u, d.basis);
      rec[l] = B;
      t[l] = m * (kc_basis_du(u, B, d.basis) * d.inv_h);
    } else {
      rec[l] = kf_swish(v[l - nG]);
      t[l] = m;
    }
  }
}

// The input cotangent of one layer from its terms t (kb_layer_terms): for
// input i, norm'(v_i) sum_g t[i*G + g] + swish'(v_i) t[n_in*G + i].
__device__ __forceinline__ float kb_layer_dx(const float* t, const float* v,
                                             int i, int n_in,
                                             const ChainDims& d) {
  const int G = d.G;
  float acc = 0.0f;
  for (int g = 0; g < G; ++g) acc += t[i * G + g];
  return acc * kc_dnorm(v[i], d.normalizer)
         + t[n_in * G + i] * kc_dswish(v[i]);
}

// The discrete adjoint of one RK step of the block's row
// (`_step_bwd_kernel`'s recursion): rebuilds the stages from a.x, sets
// kbar_i = (dt b_i) gy, then for i = s-1..0 runs the chain VJP with kbar_i,
// adds its dx into a.dx (which starts at gy) and passes (dt a_ij) dx_i to
// the earlier stages. Writes one record a needed stage at rec + slot *
// L.width (slot: rank among the needed stages). a.x and a.gy must be set
// and visible (a __syncthreads) before the call; ends in __syncthreads
// with a.dx holding the result.
__device__ inline void kb_rk_step_adjoint(const BlockAdjRows& a, int stages,
                                          int n_slots, const ChainDims& d,
                                          const WarpConsts& c,
                                          const BlockParams& p,
                                          const RecLayout& L, float* rec) {
  const int I = d.I, H = d.H, O = d.O, L1 = kb_l1(d);
  for (int s = 0; s < stages; ++s) {
    if (!c.needed[s]) continue;
    kb_stage_input(a.x, a.ks, s, d, c, a.xs + s * I);
    kb_chain_fwd(a.xs + s * I, a.ks + s * I, a.y1s + s * H, d, c, p, a.ws);
  }
  for (int q = threadIdx.x; q < I; q += blockDim.x) {
    const float g = a.gy[q];
    a.dx[q] = g;
    for (int s = 0; s < stages; ++s) a.kb[s * I + q] = c.b[s] * g;
  }
  __syncthreads();
  float* t1 = a.ws;                 // layer-1 terms [L1]
  float* dy1 = t1 + L1;             // [H]
  float* t2 = dy1 + H;              // layer-2 terms [L2]
  int slot = n_slots;
  for (int s = stages - 1; s >= 0; --s) {
    if (!c.needed[s]) continue;
    float* r = rec + (size_t)(--slot) * L.width;
    const float* gk = a.kb + s * I;
    const float* xs = a.xs + s * I;
    const float* y1 = a.y1s + s * H;
    // layer 2: its terms, features b2 | swy1, and gk into the record
    kb_layer_terms(p.c2t, gk, O, y1, H, d, c, t2, r + L.b2);
    for (int o = threadIdx.x; o < O; o += blockDim.x) r[L.gk + o] = gk[o];
    __syncthreads();
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      const float v = kb_layer_dx(t2, y1, h, H, d);
      dy1[h] = v;
      r[L.dy1 + h] = v;
    }
    __syncthreads();
    // layer 1: its terms and features b1 | swx
    kb_layer_terms(p.c1t, dy1, H, xs, I, d, c, t1, r + L.b1);
    __syncthreads();
    for (int q = threadIdx.x; q < I; q += blockDim.x) {
      const float v = kb_layer_dx(t1, xs, q, I, d);
      a.dx[q] = a.dx[q] + v;
      for (int j = 0; j < s; ++j) {
        const float aj = c.a[s][j];
        if (aj != 0.0f) a.kb[j * I + q] = a.kb[j * I + q] + aj * v;
      }
    }
    __syncthreads();
  }
}

// The parameter cotangents from n_rec records (kc_rec_layout), a thread a
// parameter over the grid's blocks, each summed in record order:
//   dc1 = b1^T dy1, dw1 = swx^T dy1, dc2 = b2^T gk, dw2 = swy1^T gk.
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
