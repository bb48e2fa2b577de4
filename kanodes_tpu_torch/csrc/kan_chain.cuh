// Per-row device math of the 2-layer KDense chain, shared by every kernel
// of csrc/ (rk_fused.cu, kan_chain_apply.cu, rk_adaptive.cu,
// rk_adaptive_members.cu, kdense_single.cu: its caps, ChainDims, and the
// elementwise functions below).
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

#include <mutex>

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

// The adaptive solves (K4 in rk_adaptive.cu, K8 in rk_adaptive_members.cu):
// an FSAL embedded pair with raw f32 coefficients (dt is applied on the
// device): a[i][j], b[i], e[i] = b_err[i].
struct AdaptTab {
  int stages;
  float a[KC_MAX_STAGES][KC_MAX_STAGES];
  float b[KC_MAX_STAGES];
  float e[KC_MAX_STAGES];
};

// Tolerances and the step controller, each constant rounded to f32 as the
// JAX kernel's weak-typed Python floats are.
struct AdaptCtrl {
  float rtol, atol;
  float safety, min_factor, max_factor, dt_min;
  float err_exp;    // -(icoeff + pcoeff) / order
  float prev_exp;   // pcoeff / order
  int use_prev;     // pcoeff != 0 (PI control)
  float dt0;        // the initial step when has_dt0
  int has_dt0;
  float idt_exp;    // 1 / (order + 1), the initial-dt heuristic
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

// Shared memory above the 48 KB default (static and dynamic together)
// needs an opt-in per kernel and device; every kernel here keeps its static
// arrays within 4 KB. Each (kernel, device) is opted in once to the
// largest size asked of it so far: the attribute call costs host time on
// every launch otherwise.
template <typename Kernel>
cudaError_t kc_smem_opt_in(Kernel kernel, size_t bytes) {
  if (bytes <= 44 * 1024) return cudaSuccess;
  struct OptIn {
    const void* kernel;
    int device;
    size_t bytes;
  };
  static OptIn known[32];
  static int n_known = 0;
  static std::mutex mu;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  int i = 0;
  while (i < n_known && !(known[i].kernel == (const void*)kernel
                          && known[i].device == device))
    ++i;
  if (i < n_known && known[i].bytes >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  if (i < n_known) known[i].bytes = bytes;
  else if (n_known < 32) known[n_known++] = {(const void*)kernel, device,
                                             bytes};
  return cudaSuccess;
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
