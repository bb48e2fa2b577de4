// The standalone 2-layer KDense chain and its VJP, for Hopper (sm_90a),
// with a plain C interface loaded through ctypes
// (kanodes_tpu_torch/ops/_cuda.py builds it with nvcc).
//
// Replaces the Pallas kernels of kanodes_tpu/ops/kdense_pallas.py:
//   kc_chain_apply_fwd <- _chain_fwd_kernel  (kan_chain_apply)
//   kc_chain_apply_bwd <- _chain_bwd_kernel  (_kca_bwd)
//
// What bounds them on this card: launch latency. At the LV shapes (K = 1
// or 34 rows, widths 2-10-2, G = 5) one call is ~1e4 flops on ~1 KB of
// parameters; the bound from bytes or flops is well under a microsecond.
//
// What the design does about it: one launch per call, as on the TPU; one
// thread per row with the parameters staged once in shared memory; the
// forward also writes the hidden activations y1 [K, H], which the
// backward takes back (as the Pallas forward does) and recomputes both
// basis tensors from. The backward runs in one block: each row's VJP
// stores its parameter-cotangent operands in a scratch buffer, then the
// thread that owns each parameter sums them in row order. A fixed order
// and no float atomics, so results repeat bit for bit.
// Launches go on the caller's stream; nothing here allocates or syncs.

#include "kan_chain.cuh"

namespace {

constexpr int kFwdThreads = 128;
constexpr int kBwdThreads = 256;

__global__ void __launch_bounds__(kFwdThreads)
chain_apply_fwd_kernel(const float* x, const float* c1, const float* w1,
                       const float* c2, const float* w2, float* y, float* y1,
                       int K, ChainDims d) {
  extern __shared__ float smem[];
  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, smem);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= K) return;
  float h[KC_MAX_H], out[KC_MAX_I];
  kc_chain_fwd(x + (size_t)r * d.I, d, p, h, out);
  for (int j = 0; j < d.H; ++j) y1[(size_t)r * d.H + j] = h[j];
  for (int o = 0; o < d.O; ++o) y[(size_t)r * d.O + o] = out[o];
}

__global__ void __launch_bounds__(kBwdThreads)
chain_apply_bwd_kernel(const float* x, const float* y1, const float* gy,
                       const float* c1, const float* w1, const float* c2,
                       const float* w2, float* dx, float* dc1, float* dw1,
                       float* dc2, float* dw2, float* scratch, int K,
                       ChainDims d) {
  extern __shared__ float smem[];
  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, smem);
  const RecLayout L = kc_rec_layout(d.I, d.H, d.O, d.G);
  for (int r = threadIdx.x; r < K; r += blockDim.x)
    kc_chain_vjp(x + (size_t)r * d.I, y1 + (size_t)r * d.H,
                 gy + (size_t)r * d.O, d, p, L, dx + (size_t)r * d.I,
                 scratch + (size_t)r * L.width);
  __syncthreads();
  kc_reduce_param_grads(scratch, K, d, L, dc1, dw1, dc2, dw2);
}

}  // namespace

extern "C" {

int kc_chain_apply_fwd(const float* x, const float* c1, const float* w1,
                       const float* c2, const float* w2, float* y, float* y1,
                       int K, const ChainDims* d, void* stream) {
  const size_t smem = kc_param_floats(*d) * sizeof(float);
  cudaError_t err = kc_smem_opt_in(chain_apply_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (K + kFwdThreads - 1) / kFwdThreads;
  chain_apply_fwd_kernel<<<blocks, kFwdThreads, smem,
                           (cudaStream_t)stream>>>(x, c1, w1, c2, w2, y, y1,
                                                   K, *d);
  return (int)cudaGetLastError();
}

int kc_chain_apply_bwd(const float* x, const float* y1, const float* gy,
                       const float* c1, const float* w1, const float* c2,
                       const float* w2, float* dx, float* dc1, float* dw1,
                       float* dc2, float* dw2, float* scratch, int K,
                       const ChainDims* d, void* stream) {
  const size_t smem = kc_param_floats(*d) * sizeof(float);
  cudaError_t err = kc_smem_opt_in(chain_apply_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  chain_apply_bwd_kernel<<<1, kBwdThreads, smem, (cudaStream_t)stream>>>(
      x, y1, gy, c1, w1, c2, w2, dx, dc1, dw1, dc2, dw2, scratch, K, *d);
  return (int)cudaGetLastError();
}

}  // extern "C"
