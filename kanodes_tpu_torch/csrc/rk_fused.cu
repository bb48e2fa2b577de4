// Whole-RK-step and multistep kernels over the 2-layer KDense chain, for
// Hopper (sm_90a), with a plain C interface loaded through ctypes
// (kanodes_tpu_torch/ops/_cuda.py builds this file with nvcc).
//
// Replaces the Pallas kernels of kanodes_tpu/ops/rk_fused.py:
//   kc_rk_step_fwd      <- _step_fwd_kernel       (fused_rk_step)
//   kc_rk_step_bwd      <- _step_bwd_kernel       (_frs_bwd)
//   kc_rk_multistep_fwd <- _multistep_fwd_kernel  (fused_rk_multistep)
//   kc_rk_multistep_bwd <- _multistep_bwd_kernel  (_frm_bwd)
//
// What bounds them on this card: latency and launch count, not bytes or
// FLOPs. At the LV shapes (K <= 34 rows, widths 2-10-2, G = 5) one RK
// step is ~10^4 flops on a few KB of parameters; the forward over 140
// steps is a chain of ~840 dependent chain evaluations. Tensor-core
// tiles do not apply at these widths.
//
// What the design does about it:
//   * one launch per RK step (K2) or per whole trajectory (K3), and one
//     more for the backward, as on the TPU, so the host makes 2 launches
//     per training iteration instead of one per op;
//   * one thread per batch row runs all stages (and, in K3, all steps)
//     with its state in registers/local memory, parameters and grid
//     constants staged once in shared memory;
//   * the backward recomputes each step's stages from the stored step
//     inputs, runs the reverse-RK recursion per row, stores the per
//     (step, row, stage) operands of the parameter cotangents in a
//     scratch buffer the wrapper allocates, then every thread of the
//     block sums the cotangents of the parameters it owns in record
//     order: a fixed order, no float atomics, so results repeat bit for
//     bit. The TPU kernel's `_bwd_window` GEMM batching is a TPU latency
//     trick and is not ported; only the gradients must match.
// Launches go on the caller's stream; nothing here allocates or syncs.

#include "kan_chain.cuh"

namespace {

constexpr int kFwdThreads = 128;
constexpr int kBwdThreads = 256;

__global__ void __launch_bounds__(kFwdThreads)
rk_step_fwd_kernel(const float* x, const float* c1, const float* w1,
                   const float* c2, const float* w2, float* y, int K,
                   ChainDims d, StepTab T) {
  extern __shared__ float smem[];
  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, smem);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < K) kc_rk_step_row(x + r * d.I, y + r * d.I, T, d, p);
}

__global__ void __launch_bounds__(kBwdThreads)
rk_step_bwd_kernel(const float* x, const float* gy, const float* c1,
                   const float* w1, const float* c2, const float* w2,
                   float* dx, float* dc1, float* dw1, float* dc2, float* dw2,
                   float* scratch, int K, int n_slots, ChainDims d,
                   StepTab T) {
  extern __shared__ float smem[];
  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, smem);
  const RecLayout L = kc_rec_layout(d.I, d.H, d.O, d.G);
  for (int r = threadIdx.x; r < K; r += blockDim.x)
    kc_rk_step_adjoint_row(x + r * d.I, gy + r * d.I, dx + r * d.I, T, d, p,
                           L, scratch + (size_t)r * n_slots * L.width);
  __syncthreads();
  kc_reduce_param_grads(scratch, K * n_slots, d, L, dc1, dw1, dc2, dw2);
}

__global__ void __launch_bounds__(kFwdThreads)
rk_multistep_fwd_kernel(const float* x0, const float* c1, const float* w1,
                        const float* c2, const float* w2, float* ys, int K,
                        int n_steps, ChainDims d, StepTab T) {
  extern __shared__ float smem[];
  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, smem);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= K) return;
  float x[KC_MAX_I], y[KC_MAX_I];
  for (int q = 0; q < d.I; ++q) x[q] = x0[r * d.I + q];
  for (int s = 0; s < n_steps; ++s) {
    kc_rk_step_row(x, y, T, d, p);
    float* out = ys + ((size_t)s * K + r) * d.I;
    for (int q = 0; q < d.I; ++q) {
      out[q] = y[q];
      x[q] = y[q];
    }
  }
}

__global__ void __launch_bounds__(kBwdThreads)
rk_multistep_bwd_kernel(const float* x0, const float* ys, const float* gys,
                        const float* c1, const float* w1, const float* c2,
                        const float* w2, float* dx0, float* dc1, float* dw1,
                        float* dc2, float* dw2, float* scratch, int K,
                        int n_steps, int n_slots, ChainDims d, StepTab T) {
  extern __shared__ float smem[];
  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, smem);
  const RecLayout L = kc_rec_layout(d.I, d.H, d.O, d.G);
  for (int r = threadIdx.x; r < K; r += blockDim.x) {
    float xbar[KC_MAX_I], dx[KC_MAX_I];
    for (int q = 0; q < d.I; ++q) xbar[q] = 0.0f;
    for (int s = n_steps - 1; s >= 0; --s) {
      const float* g = gys + ((size_t)s * K + r) * d.I;
      for (int q = 0; q < d.I; ++q) xbar[q] = xbar[q] + g[q];
      // input state of step s: ys[s-1] (x0 for the first step)
      const float* x_in =
          s == 0 ? x0 + r * d.I : ys + ((size_t)(s - 1) * K + r) * d.I;
      kc_rk_step_adjoint_row(
          x_in, xbar, dx, T, d, p, L,
          scratch + ((size_t)s * K + r) * n_slots * L.width);
      for (int q = 0; q < d.I; ++q) xbar[q] = dx[q];
    }
    for (int q = 0; q < d.I; ++q) dx0[r * d.I + q] = xbar[q];
  }
  __syncthreads();
  kc_reduce_param_grads(scratch, n_steps * K * n_slots, d, L, dc1, dw1, dc2,
                        dw2);
}

}  // namespace

extern "C" {

// The compile-time caps, for the wrapper to check its own copy against:
// out[0..4] = KC_MAX_I, KC_MAX_H, KC_MAX_G, KC_MAX_STAGES,
// KC_MAX_ADAPT_ROWS.
void kc_caps(int* out) {
  out[0] = KC_MAX_I;
  out[1] = KC_MAX_H;
  out[2] = KC_MAX_G;
  out[3] = KC_MAX_STAGES;
  out[4] = KC_MAX_ADAPT_ROWS;
}

const char* kc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Each launcher takes device pointers, the host-side ChainDims/StepTab
// structs and the CUDA stream, and returns cudaGetLastError() (0 = ok).

int kc_rk_step_fwd(const float* x, const float* c1, const float* w1,
                   const float* c2, const float* w2, float* y, int K,
                   const ChainDims* d, const StepTab* T, void* stream) {
  const size_t smem = kc_param_floats(*d) * sizeof(float);
  cudaError_t err = kc_smem_opt_in(rk_step_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (K + kFwdThreads - 1) / kFwdThreads;
  rk_step_fwd_kernel<<<blocks, kFwdThreads, smem, (cudaStream_t)stream>>>(
      x, c1, w1, c2, w2, y, K, *d, *T);
  return (int)cudaGetLastError();
}

int kc_rk_step_bwd(const float* x, const float* gy, const float* c1,
                   const float* w1, const float* c2, const float* w2,
                   float* dx, float* dc1, float* dw1, float* dc2, float* dw2,
                   float* scratch, int K, int n_slots, const ChainDims* d,
                   const StepTab* T, void* stream) {
  const size_t smem = kc_param_floats(*d) * sizeof(float);
  cudaError_t err = kc_smem_opt_in(rk_step_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  rk_step_bwd_kernel<<<1, kBwdThreads, smem, (cudaStream_t)stream>>>(
      x, gy, c1, w1, c2, w2, dx, dc1, dw1, dc2, dw2, scratch, K, n_slots, *d,
      *T);
  return (int)cudaGetLastError();
}

int kc_rk_multistep_fwd(const float* x0, const float* c1, const float* w1,
                        const float* c2, const float* w2, float* ys, int K,
                        int n_steps, const ChainDims* d, const StepTab* T,
                        void* stream) {
  const size_t smem = kc_param_floats(*d) * sizeof(float);
  cudaError_t err = kc_smem_opt_in(rk_multistep_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (K + kFwdThreads - 1) / kFwdThreads;
  rk_multistep_fwd_kernel<<<blocks, kFwdThreads, smem,
                            (cudaStream_t)stream>>>(x0, c1, w1, c2, w2, ys, K,
                                                    n_steps, *d, *T);
  return (int)cudaGetLastError();
}

int kc_rk_multistep_bwd(const float* x0, const float* ys, const float* gys,
                        const float* c1, const float* w1, const float* c2,
                        const float* w2, float* dx0, float* dc1, float* dw1,
                        float* dc2, float* dw2, float* scratch, int K,
                        int n_steps, int n_slots, const ChainDims* d,
                        const StepTab* T, void* stream) {
  const size_t smem = kc_param_floats(*d) * sizeof(float);
  cudaError_t err = kc_smem_opt_in(rk_multistep_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  rk_multistep_bwd_kernel<<<1, kBwdThreads, smem, (cudaStream_t)stream>>>(
      x0, ys, gys, c1, w1, c2, w2, dx0, dc1, dw1, dc2, dw2, scratch, K,
      n_steps, n_slots, *d, *T);
  return (int)cudaGetLastError();
}

}  // extern "C"
