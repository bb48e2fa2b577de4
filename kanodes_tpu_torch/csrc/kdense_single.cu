// One KDense layer and its VJP, for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (kanodes_tpu_torch/ops/_cuda.py builds
// it with nvcc).
//
// Replaces the Pallas kernels of kanodes_tpu/ops/kdense_pallas.py:
//   kd_single_fwd <- _single_fwd_kernel  (kdense_single_apply)
//   kd_single_bwd <- _single_bwd_kernel  (_ksa_bwd)
// As there, the basis is always rbf: the Pallas kernel never passes
// spec.basis, so the wrapper sets ChainDims.basis to rbf whatever the
// spec says.
//
// What bounds them on this card: launch latency. A layer of the shapes
// its callers give it (1->1 over 26-1024 grid nodes, [2->10] over 34
// rows) is 1e3-1e5 flops on under 1 KB of parameters, well under a
// microsecond of bytes or flops.
//
// What the design does about it: one launch per call, one thread per row
// on the per-row layer math of kan_chain.cuh (kc_layer_fwd,
// kc_layer_bwd_dx), the parameters staged once per block in shared
// memory. The backward runs in one block: each row stores its basis row
// and swish(x) in a scratch buffer, and after a barrier the thread that
// owns each parameter sums its cotangent over the rows in row order. A
// fixed order and no float atomics, so results repeat bit for bit.
// Launches go on the caller's stream; nothing here allocates or syncs.
//
// Caps (the wrapper checks them and raises with them in the message):
// in_dims <= KD_MAX_I, out_dims <= KC_MAX_H (the per-row accumulators of
// kc_layer_fwd), 2 <= G <= KC_MAX_G.

#include "kan_chain.cuh"

#define KD_MAX_I 32

namespace {

constexpr int kFwdThreads = 128;
constexpr int kBwdThreads = 256;

// c [I*G, O] and w [I, O] into shared memory (c then w); ends in a barrier.
__device__ inline void kd_stage(const float* c, const float* w,
                                const ChainDims& d, float* smem) {
  const int n_c = d.I * d.G * d.O, n_w = d.I * d.O;
  for (int i = threadIdx.x; i < n_c; i += blockDim.x) smem[i] = c[i];
  for (int i = threadIdx.x; i < n_w; i += blockDim.x) smem[n_c + i] = w[i];
  __syncthreads();
}

__global__ void __launch_bounds__(kFwdThreads)
single_fwd_kernel(const float* x, const float* c, const float* w, float* y,
                  int K, ChainDims d) {
  extern __shared__ float smem[];
  kd_stage(c, w, d, smem);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= K) return;
  float out[KC_MAX_H];
  kc_layer_fwd(x + (size_t)r * d.I, d.I, d.O, smem, smem + d.I * d.G * d.O,
               d, out);
  for (int o = 0; o < d.O; ++o) y[(size_t)r * d.O + o] = out[o];
}

// scratch: K records of I*G basis values then I swish values.
__global__ void __launch_bounds__(kBwdThreads)
single_bwd_kernel(const float* x, const float* gy, const float* c,
                  const float* w, float* dx, float* dc, float* dw,
                  float* scratch, int K, ChainDims d) {
  extern __shared__ float smem[];
  kd_stage(c, w, d, smem);
  const int IG = d.I * d.G, width = IG + d.I;
  const int n_c = IG * d.O, n_w = d.I * d.O;
  for (int r = threadIdx.x; r < K; r += blockDim.x) {
    float* rec = scratch + (size_t)r * width;
    kc_layer_bwd_dx(x + (size_t)r * d.I, d.I, d.O, smem, smem + n_c, d,
                    gy + (size_t)r * d.O, dx + (size_t)r * d.I, rec,
                    rec + IG);
  }
  __syncthreads();
  // dc[ig, o] = sum_r b[r, ig] gy[r, o];  dw[i, o] = sum_r sw[r, i] gy[r, o]
  for (int p = threadIdx.x; p < n_c + n_w; p += blockDim.x) {
    const int q = p < n_c ? p : p - n_c;
    const int a_off = (p < n_c ? 0 : IG) + q / d.O;
    const int o = q % d.O;
    float acc = 0.0f;
    for (int r = 0; r < K; ++r)
      acc += scratch[(size_t)r * width + a_off] * gy[(size_t)r * d.O + o];
    (p < n_c ? dc : dw)[q] = acc;
  }
}

size_t kd_smem(const ChainDims& d) {
  return (size_t)(d.I * d.G * d.O + d.I * d.O) * sizeof(float);
}

}  // namespace

extern "C" {

void kd_caps(int* out) {
  out[0] = KD_MAX_I;
  out[1] = KC_MAX_H;
  out[2] = KC_MAX_G;
}

int kd_single_fwd(const float* x, const float* c, const float* w, float* y,
                  int K, const ChainDims* d, void* stream) {
  const size_t smem = kd_smem(*d);
  cudaError_t err = kc_smem_opt_in(single_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (K + kFwdThreads - 1) / kFwdThreads;
  single_fwd_kernel<<<blocks, kFwdThreads, smem, (cudaStream_t)stream>>>(
      x, c, w, y, K, *d);
  return (int)cudaGetLastError();
}

int kd_single_bwd(const float* x, const float* gy, const float* c,
                  const float* w, float* dx, float* dc, float* dw,
                  float* scratch, int K, const ChainDims* d, void* stream) {
  const size_t smem = kd_smem(*d);
  cudaError_t err = kc_smem_opt_in(single_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  single_bwd_kernel<<<1, kBwdThreads, smem, (cudaStream_t)stream>>>(
      x, gy, c, w, dx, dc, dw, scratch, K, *d);
  return (int)cudaGetLastError();
}

}  // extern "C"
