// Per-row device math of the 2-layer KDense chain and of one explicit RK
// step over it, shared by every kernel of csrc/ (rk_fused.cu,
// kan_chain_apply.cu, rk_adaptive.cu).
//
// Computes what `_layer_fwd` / `_layer_bwd` (kanodes_tpu/ops/
// kdense_pallas.py:173-206) and `_chain_f` / `_chain_vjp_collect`
// (kanodes_tpu/ops/rk_fused.py:70-117) compute, for ONE row of the batch,
// in one thread. The basis is indexed as row i*G+g directly: the Pallas
// kernels' constant 0/1 expand/collapse GEMMs exist only because Mosaic
// cannot reshape, and have no counterpart here.
//
// Precision: f32 throughout with expf/tanhf (no fast-math intrinsics),
// the tolerance class of XLA's CPU math.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

// Compile-time caps; the Python wrapper checks every launch against them.
#define KC_MAX_I 8          // state width I (= chain output width O)
#define KC_MAX_H 32         // hidden width H
#define KC_MAX_G 16         // grid length G
#define KC_MAX_STAGES 7     // explicit RK stages
#define KC_MAX_ADAPT_ROWS 256  // rows K of the adaptive solve (one block)

// normalizer: 0 tanh, 1 softsign. basis: 0 rbf, 1 iqf, 2 rswaf.
struct ChainDims {
  int I, H, O, G;
  int normalizer, basis;
  float inv_h;              // 1/h, folded on the host in f64 then rounded
  float grid[KC_MAX_G];     // basis centers
};

// Chain parameters as staged in shared memory: c1 [I*G, H], w1 [I, H],
// c2 [H*G, O], w2 [H, O], all row-major.
struct ChainParams {
  const float* c1;
  const float* w1;
  const float* c2;
  const float* w2;
};

// A fixed-step tableau with dt folded in: a[i][j] = f32(dt * a_ij),
// b[i] = f32(dt * b_i), both folded in f64 on the host as JAX folds
// them; needed[i] = 0 for a stage no output consumes (Tsit5's FSAL stage).
struct StepTab {
  int stages;
  float a[KC_MAX_STAGES][KC_MAX_STAGES];
  float b[KC_MAX_STAGES];
  int needed[KC_MAX_STAGES];
};

// Per (row, stage) operands of the parameter cotangents, stored by the
// VJP and summed by kc_reduce_param_grads:
//   dc1 = b1^T dy1, dw1 = swx^T dy1, dc2 = b2^T gk, dw2 = swy1^T gk.
struct RecLayout {
  int b1, swx, dy1, b2, swy1, gk, width;
};

__host__ __device__ inline RecLayout kc_rec_layout(int I, int H, int O,
                                                   int G) {
  RecLayout r;
  r.b1 = 0;
  r.swx = r.b1 + I * G;
  r.dy1 = r.swx + I;
  r.b2 = r.dy1 + H;
  r.swy1 = r.b2 + H * G;
  r.gk = r.swy1 + H;
  r.width = r.gk + O;
  return r;
}

__device__ __forceinline__ float kc_norm(float x, int kind) {
  return kind == 0 ? tanhf(x) : x / (1.0f + fabsf(x));
}

__device__ __forceinline__ float kc_dnorm(float x, int kind) {
  if (kind == 0) {
    float t = tanhf(x);
    return 1.0f - t * t;
  }
  float d = 1.0f + fabsf(x);
  return 1.0f / (d * d);
}

__device__ __forceinline__ float kc_basis(float u, int kind) {
  if (kind == 0) return expf(-(u * u));
  if (kind == 1) return 1.0f / (1.0f + u * u);
  float t = tanhf(u);
  return 1.0f - t * t;
}

__device__ __forceinline__ float kc_basis_du(float u, float B, int kind) {
  if (kind == 0) return -2.0f * u * B;
  if (kind == 1) return -2.0f * u * B * B;
  return -2.0f * tanhf(u) * B;
}

__device__ __forceinline__ float kc_sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float kc_swish(float x) {
  return x * kc_sigmoid(x);
}

__device__ __forceinline__ float kc_dswish(float x) {
  float s = kc_sigmoid(x);
  return s * (1.0f + x * (1.0f - s));
}

// One layer forward for one row:
//   y[o] = sum_{i,g} B(u_ig) c[(i*G+g), o] + sum_i swish(x_i) w[i, o],
//   u_ig = (norm(x_i) - grid_g) / h.
__device__ inline void kc_layer_fwd(const float* x, int n_in, int n_out,
                                    const float* c, const float* w,
                                    const ChainDims& d, float* y) {
  float acc_c[KC_MAX_H];
  float acc_w[KC_MAX_H];
  for (int o = 0; o < n_out; ++o) {
    acc_c[o] = 0.0f;
    acc_w[o] = 0.0f;
  }
  for (int i = 0; i < n_in; ++i) {
    const float xn = kc_norm(x[i], d.normalizer);
    for (int g = 0; g < d.G; ++g) {
      const float B = kc_basis((xn - d.grid[g]) * d.inv_h, d.basis);
      const float* row = c + (i * d.G + g) * n_out;
      for (int o = 0; o < n_out; ++o) acc_c[o] += B * row[o];
    }
    const float sw = kc_swish(x[i]);
    for (int o = 0; o < n_out; ++o) acc_w[o] += sw * w[i * n_out + o];
  }
  for (int o = 0; o < n_out; ++o) y[o] = acc_c[o] + acc_w[o];
}

// The dx path of one layer's backward for one row, storing the basis row
// and swish(x) for the deferred parameter cotangents.
__device__ inline void kc_layer_bwd_dx(const float* x, int n_in, int n_out,
                                       const float* c, const float* w,
                                       const ChainDims& d, const float* gy,
                                       float* dx, float* b_out,
                                       float* sw_out) {
  for (int i = 0; i < n_in; ++i) {
    const float xn = kc_norm(x[i], d.normalizer);
    float acc = 0.0f;
    for (int g = 0; g < d.G; ++g) {
      const float u = (xn - d.grid[g]) * d.inv_h;
      const float B = kc_basis(u, d.basis);
      b_out[i * d.G + g] = B;
      const float* row = c + (i * d.G + g) * n_out;
      float m = 0.0f;
      for (int o = 0; o < n_out; ++o) m += gy[o] * row[o];
      acc += m * kc_basis_du(u, B, d.basis) * d.inv_h;
    }
    float gw = 0.0f;
    for (int o = 0; o < n_out; ++o) gw += gy[o] * w[i * n_out + o];
    dx[i] = acc * kc_dnorm(x[i], d.normalizer) + gw * kc_dswish(x[i]);
    sw_out[i] = kc_swish(x[i]);
  }
}

// Chain forward: k = layer2(layer1(x)); y1 = layer1(x) is kept.
__device__ inline void kc_chain_fwd(const float* x, const ChainDims& d,
                                    const ChainParams& p, float* y1,
                                    float* k) {
  kc_layer_fwd(x, d.I, d.H, p.c1, p.w1, d, y1);
  kc_layer_fwd(y1, d.H, d.O, p.c2, p.w2, d, k);
}

// Chain VJP at x (y1 = layer1(x)) for the cotangent gk; writes dx and one
// record of parameter-cotangent operands.
__device__ inline void kc_chain_vjp(const float* x, const float* y1,
                                    const float* gk, const ChainDims& d,
                                    const ChainParams& p, const RecLayout& L,
                                    float* dx, float* rec) {
  float dy1[KC_MAX_H];
  kc_layer_bwd_dx(y1, d.H, d.O, p.c2, p.w2, d, gk, dy1, rec + L.b2,
                  rec + L.swy1);
  kc_layer_bwd_dx(x, d.I, d.H, p.c1, p.w1, d, dy1, dx, rec + L.b1,
                  rec + L.swx);
  for (int h = 0; h < d.H; ++h) rec[L.dy1 + h] = dy1[h];
  for (int o = 0; o < d.O; ++o) rec[L.gk + o] = gk[o];
}

// One explicit RK step for one row: y = x + sum_i (dt b_i) k_i, stages in
// increasing order, each stage input accumulated over increasing j, as
// `_step_fwd_kernel` (kanodes_tpu/ops/rk_fused.py:144-164) does.
__device__ inline void kc_rk_step_row(const float* x, float* y,
                                      const StepTab& T, const ChainDims& d,
                                      const ChainParams& p) {
  float ks[KC_MAX_STAGES][KC_MAX_I];
  float xi[KC_MAX_I];
  float y1[KC_MAX_H];
  for (int s = 0; s < T.stages; ++s) {
    if (!T.needed[s]) continue;
    for (int q = 0; q < d.I; ++q) xi[q] = x[q];
    for (int j = 0; j < s; ++j) {
      const float a = T.a[s][j];
      if (a == 0.0f || !T.needed[j]) continue;
      for (int q = 0; q < d.I; ++q) xi[q] = xi[q] + a * ks[j][q];
    }
    kc_chain_fwd(xi, d, p, y1, ks[s]);
  }
  for (int q = 0; q < d.I; ++q) {
    float acc = x[q];
    for (int s = 0; s < T.stages; ++s)
      if (T.b[s] != 0.0f) acc = acc + T.b[s] * ks[s][q];
    y[q] = acc;
  }
}

// Discrete adjoint of one RK step for one row (the recursion of
// `_step_bwd_kernel`, kanodes_tpu/ops/rk_fused.py:167-223): rebuilds the
// stages from the step input x, then for i = s-1..0 runs the chain VJP
// with kbar_i, adds its dx into the state cotangent and passes
// (dt a_ij) dx_i to the earlier stages. Writes dx and one record per
// needed stage (slot = rank among the needed stages) at rec.
__device__ inline void kc_rk_step_adjoint_row(const float* x, const float* gy,
                                              float* dx, const StepTab& T,
                                              const ChainDims& d,
                                              const ChainParams& p,
                                              const RecLayout& L,
                                              float* rec) {
  float xs[KC_MAX_STAGES][KC_MAX_I];
  float ks[KC_MAX_STAGES][KC_MAX_I];
  float y1s[KC_MAX_STAGES][KC_MAX_H];
  float kbar[KC_MAX_STAGES][KC_MAX_I];
  int slot[KC_MAX_STAGES];
  int n_slots = 0;
  for (int s = 0; s < T.stages; ++s) {
    if (!T.needed[s]) continue;
    slot[s] = n_slots++;
    for (int q = 0; q < d.I; ++q) xs[s][q] = x[q];
    for (int j = 0; j < s; ++j) {
      const float a = T.a[s][j];
      if (a == 0.0f || !T.needed[j]) continue;
      for (int q = 0; q < d.I; ++q) xs[s][q] = xs[s][q] + a * ks[j][q];
    }
    kc_chain_fwd(xs[s], d, p, y1s[s], ks[s]);
    for (int q = 0; q < d.I; ++q) kbar[s][q] = T.b[s] * gy[q];
  }
  for (int q = 0; q < d.I; ++q) dx[q] = gy[q];
  float dxi[KC_MAX_I];
  for (int s = T.stages - 1; s >= 0; --s) {
    if (!T.needed[s]) continue;
    kc_chain_vjp(xs[s], y1s[s], kbar[s], d, p, L, dxi,
                 rec + slot[s] * L.width);
    for (int q = 0; q < d.I; ++q) dx[q] = dx[q] + dxi[q];
    for (int j = 0; j < s; ++j) {
      const float a = T.a[s][j];
      if (a == 0.0f || !T.needed[j]) continue;
      for (int q = 0; q < d.I; ++q) kbar[j][q] = kbar[j][q] + a * dxi[q];
    }
  }
}

__host__ __device__ inline int kc_param_floats(const ChainDims& d) {
  return d.I * d.G * d.H + d.I * d.H + d.H * d.G * d.O + d.H * d.O;
}

// Copy the chain parameters into shared memory at smem (layout
// c1 | w1 | c2 | w2, kc_param_floats(d) floats) and return views of them.
// Ends in __syncthreads: every thread of the block must call it.
__device__ inline ChainParams kc_stage_params(const float* c1, const float* w1,
                                              const float* c2, const float* w2,
                                              const ChainDims& d,
                                              float* smem) {
  const int n_c1 = d.I * d.G * d.H, n_w1 = d.I * d.H;
  const int n_c2 = d.H * d.G * d.O, n_w2 = d.H * d.O;
  float* s_c1 = smem;
  float* s_w1 = s_c1 + n_c1;
  float* s_c2 = s_w1 + n_w1;
  float* s_w2 = s_c2 + n_c2;
  for (int i = threadIdx.x; i < n_c1; i += blockDim.x) s_c1[i] = c1[i];
  for (int i = threadIdx.x; i < n_w1; i += blockDim.x) s_w1[i] = w1[i];
  for (int i = threadIdx.x; i < n_c2; i += blockDim.x) s_c2[i] = c2[i];
  for (int i = threadIdx.x; i < n_w2; i += blockDim.x) s_w2[i] = w2[i];
  __syncthreads();
  ChainParams p;
  p.c1 = s_c1;
  p.w1 = s_w1;
  p.c2 = s_c2;
  p.w2 = s_w2;
  return p;
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename Kernel>
cudaError_t kc_smem_opt_in(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Parameter cotangents from n_rec records, summed in record order by the
// thread that owns each parameter: a fixed order, so runs repeat bit for
// bit (no float atomics). Records must be visible to the whole block
// (__syncthreads before the call).
__device__ inline void kc_reduce_param_grads(const float* rec, int n_rec,
                                             const ChainDims& d,
                                             const RecLayout& L, float* dc1,
                                             float* dw1, float* dc2,
                                             float* dw2) {
  const int I = d.I, H = d.H, O = d.O, G = d.G;
  const int n_c1 = I * G * H, n_w1 = I * H, n_c2 = H * G * O, n_w2 = H * O;
  const int total = n_c1 + n_w1 + n_c2 + n_w2;
  for (int p = threadIdx.x; p < total; p += blockDim.x) {
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
    float acc = 0.0f;
    for (int r = 0; r < n_rec; ++r) {
      const float* rr = rec + (size_t)r * L.width;
      acc += rr[a_off] * rr[b_off];
    }
    *out = acc;
  }
}
