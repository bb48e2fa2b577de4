// One whole explicit RK step of the gray-box right-hand side
//     du/dt = D * known(u) + phi(u),   phi = the pointwise 1->1 rbf KDense
//     phi(u) = W swish(u) + sum_g C[g] exp(-((norm(u) - z_g) / h)^2)
// and its discrete adjoint, for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (kanodes_tpu_torch/ops/_cuda.py builds it).
//
// Replaces the Pallas kernels of kanodes_tpu/ops/graybox_fused.py:
//   gb_step_fwd <- _gb_fwd_kernel  (fused_graybox_rk_step)
//   gb_step_bwd <- _gb_bwd_kernel  (_fgb_bwd)
// known(u) is u @ lap for K row states u [K, N] and a dense [N, N]
// operator (the 1-D cyclic Laplacian), or with `kron` the Kronecker-sum
// Laplacian of one 2-D field U [n, n], applied factored as
// lap @ U + U @ lap with lap the 1-D [n, n] operator. Both are
// self-adjoint for the symmetric operators they are given, so the VJP
// applies the same map to the cotangent, as the Pallas kernel does.
// D may be negative (Allen-Cahn's sign convention).
//
// What bounds them on this card: latency. The operator couples every node
// of the field, so a step is one problem: up to six dependent stages, each
// a dot of length N (or two of length n) and ten exponentials per node,
// over 26-1024 nodes. Bytes and flops are well under a microsecond.
//
// What the design does about it: one block per launch. Threads run over
// the nodes (and loop when there are more nodes than threads). The
// operator, the state and the stage values live in shared memory, with a
// barrier between stages; the known operator is computed in the kernel's
// body from shared memory. phi is unrolled over the grid centers. The
// backward rebuilds the needed stage inputs us[i] and derivatives ks[i]
// in shared memory, turns the ks buffers into the stage cotangents kbar,
// and runs the reverse sweep of _gb_bwd_kernel. dC[g] and dW are summed
// over the nodes once per stage, in stage order, each sum by one warp
// (lanes over nodes in a fixed stride, then a fixed shuffle tree): a
// fixed order and no float atomics, so results repeat bit for bit.
//
// Constants arrive folded on the host in float64 and rounded to float32
// (dt a_ij, dt b_i, the centers, 1/h, D), as the JAX kernel gets them.
// Precision: float32 with expf/tanhf, no fast-math intrinsics.
// Launches go on the caller's stream; nothing here allocates or syncs.
//
// Caps (the wrapper checks them and raises with them in the message):
// nodes (K*N, or n*n with kron) <= GB_MAX_NODES, N <= GB_MAX_N,
// G <= GB_MAX_G. Shared memory: the backward takes
// (N^2 + nodes * (2 * needed stages + 1) + 2 (G + 1)) floats, 57 KB at
// the 2-D default n = 32 (tsit5: six needed stages), so both kernels opt
// in above the 48 KB default.

#include "kan_chain.cuh"

#define GB_MAX_STAGES 7
#define GB_MAX_G 16
#define GB_MAX_NODES 2048
#define GB_MAX_N 64
#define GB_MAX_THREADS 1024

// A fixed-step tableau with dt folded in, the stage bookkeeping and the
// constants of one gray-box step.
//   needed[i]: an output consumes stage i (pruned otherwise);
//   active[i]: stage i gets a cotangent in the reverse sweep (kbar_i is
//              not None in _gb_bwd_kernel);
//   slot[i]:   rank of stage i among the needed stages (its buffer).
struct GrayTab {
  int stages, n_slots;
  float a[GB_MAX_STAGES][GB_MAX_STAGES];
  float b[GB_MAX_STAGES];
  int needed[GB_MAX_STAGES];
  int active[GB_MAX_STAGES];
  int slot[GB_MAX_STAGES];
  int nodes;       // K*N, or n*n with kron
  int N;           // operator side
  int kron;
  int G, normalizer;   // normalizer: 0 tanh, 1 softsign
  float D, inv_h;
  float centers[GB_MAX_G];
};

namespace {

// known(s) at node p: D * (s @ lap)[p], or D * (lap @ S + S @ lap)[p].
__device__ inline float gb_known(const float* s, const float* lap, int p,
                                 const GrayTab& T) {
  const int N = T.N;
  if (T.kron) {
    const int i = p / N, j = p % N;
    float left = 0.0f, right = 0.0f;
    for (int k = 0; k < N; ++k) left += lap[i * N + k] * s[k * N + j];
    for (int k = 0; k < N; ++k) right += s[i * N + k] * lap[k * N + j];
    return T.D * (left + right);
  }
  const int r = p / N, m = p % N;
  const float* row = s + r * N;
  float acc = 0.0f;
  for (int k = 0; k < N; ++k) acc += row[k] * lap[k * N + m];
  return T.D * acc;
}

__device__ __forceinline__ float gb_z(float un, int g, const GrayTab& T) {
  return (un - T.centers[g]) * T.inv_h;
}

// phi(u) = W swish(u) + sum_g C[g] exp(-z_g^2), summed in g order
// (`_phi`); cw = C[0..G-1], W.
__device__ inline float gb_phi(float u, const float* cw, const GrayTab& T) {
  const float un = kc_norm(u, T.normalizer);
  float y = cw[T.G] * kc_swish(u);
#pragma unroll 16
  for (int g = 0; g < T.G; ++g) {
    const float z = gb_z(un, g, T);
    y = y + cw[g] * expf(-(z * z));
  }
  return y;
}

// d phi / du times the cotangent gy (the du of `_phi_vjp`).
__device__ inline float gb_phi_du(float u, float gy, const float* cw,
                                  const GrayTab& T) {
  const float un = kc_norm(u, T.normalizer);
  float dun = 0.0f;
#pragma unroll 16
  for (int g = 0; g < T.G; ++g) {
    const float z = gb_z(un, g, T);
    const float b = expf(-(z * z));
    dun = dun + cw[g] * (-2.0f * z * T.inv_h) * b;
  }
  return gy * dun * kc_dnorm(u, T.normalizer) + cw[T.G] * gy * kc_dswish(u);
}

// The stage input of stage s at node p: u + sum_j (dt a_sj) k_j, j in
// increasing order, over the needed stages with a nonzero coefficient.
__device__ inline float gb_stage_input(float u, const float* ks, int s,
                                       int p, const GrayTab& T) {
  float x = u;
  for (int j = 0; j < s; ++j) {
    const float a = T.a[s][j];
    if (a == 0.0f || !T.needed[j]) continue;
    x = x + a * ks[T.slot[j] * T.nodes + p];
  }
  return x;
}

__global__ void __launch_bounds__(GB_MAX_THREADS)
gb_fwd_kernel(const float* u, const float* lap, const float* c,
              const float* w, float* y, GrayTab T) {
  extern __shared__ float smem[];
  const int nodes = T.nodes, NN = T.N * T.N;
  float* s_lap = smem;                     // [N, N]
  float* s_u = s_lap + NN;                 // [nodes]
  float* s_x = s_u + nodes;                // [nodes] current stage input
  float* s_k = s_x + nodes;                // [n_slots, nodes]
  float* s_cw = s_k + T.n_slots * nodes;   // C[0..G-1], W
  for (int i = threadIdx.x; i < NN; i += blockDim.x) s_lap[i] = lap[i];
  for (int i = threadIdx.x; i < nodes; i += blockDim.x) s_u[i] = u[i];
  for (int i = threadIdx.x; i < T.G; i += blockDim.x) s_cw[i] = c[i];
  if (threadIdx.x == 0) s_cw[T.G] = w[0];
  __syncthreads();
  for (int s = 0; s < T.stages; ++s) {
    if (!T.needed[s]) continue;
    for (int p = threadIdx.x; p < nodes; p += blockDim.x)
      s_x[p] = gb_stage_input(s_u[p], s_k, s, p, T);
    __syncthreads();
    float* ks = s_k + T.slot[s] * nodes;
    for (int p = threadIdx.x; p < nodes; p += blockDim.x)
      ks[p] = gb_known(s_x, s_lap, p, T) + gb_phi(s_x[p], s_cw, T);
    __syncthreads();
  }
  for (int p = threadIdx.x; p < nodes; p += blockDim.x) {
    float acc = s_u[p];
    for (int s = 0; s < T.stages; ++s)
      if (T.b[s] != 0.0f) acc = acc + T.b[s] * s_k[T.slot[s] * nodes + p];
    y[p] = acc;
  }
}

__global__ void __launch_bounds__(GB_MAX_THREADS)
gb_bwd_kernel(const float* u, const float* lap, const float* c,
              const float* w, const float* gy, float* du, float* dc,
              float* dw, GrayTab T) {
  extern __shared__ float smem[];
  const int nodes = T.nodes, NN = T.N * T.N, G = T.G;
  float* s_lap = smem;                      // [N, N]
  float* s_us = s_lap + NN;                 // [n_slots, nodes] stage inputs
  float* s_kb = s_us + T.n_slots * nodes;   // [n_slots, nodes] ks, then kbar
  float* s_ub = s_kb + T.n_slots * nodes;   // [nodes] state cotangent
  float* s_cw = s_ub + nodes;               // C[0..G-1], W
  float* s_dp = s_cw + G + 1;               // dC[0..G-1], dW
  for (int i = threadIdx.x; i < NN; i += blockDim.x) s_lap[i] = lap[i];
  for (int i = threadIdx.x; i < G; i += blockDim.x) s_cw[i] = c[i];
  for (int i = threadIdx.x; i <= G; i += blockDim.x) s_dp[i] = 0.0f;
  if (threadIdx.x == 0) s_cw[G] = w[0];
  __syncthreads();

  // rebuild the needed stages from the step input
  for (int s = 0; s < T.stages; ++s) {
    if (!T.needed[s]) continue;
    float* us = s_us + T.slot[s] * nodes;
    for (int p = threadIdx.x; p < nodes; p += blockDim.x)
      us[p] = gb_stage_input(u[p], s_kb, s, p, T);
    __syncthreads();
    float* ks = s_kb + T.slot[s] * nodes;
    for (int p = threadIdx.x; p < nodes; p += blockDim.x)
      ks[p] = gb_known(us, s_lap, p, T) + gb_phi(us[p], s_cw, T);
    __syncthreads();
  }

  // seeds: ubar = gy, kbar_i = (dt b_i) gy (0 where b_i = 0); each node's
  // ks are read by its own thread only, so no barrier before the overwrite
  for (int p = threadIdx.x; p < nodes; p += blockDim.x) {
    const float g = gy[p];
    s_ub[p] = g;
    for (int s = 0; s < T.stages; ++s)
      if (T.needed[s])
        s_kb[T.slot[s] * nodes + p] = T.b[s] != 0.0f ? T.b[s] * g : 0.0f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  for (int s = T.stages - 1; s >= 0; --s) {
    if (!T.active[s]) continue;
    const float* kb = s_kb + T.slot[s] * nodes;
    const float* us = s_us + T.slot[s] * nodes;
    // du_i = D known(kbar_i) + dphi(us_i)^T kbar_i, into ubar and the
    // cotangents of the earlier stages
    for (int p = threadIdx.x; p < nodes; p += blockDim.x) {
      const float dui = gb_known(kb, s_lap, p, T)
                        + gb_phi_du(us[p], kb[p], s_cw, T);
      s_ub[p] = s_ub[p] + dui;
      for (int j = 0; j < s; ++j) {
        const float a = T.a[s][j];
        if (a == 0.0f || !T.needed[j]) continue;
        float* kj = s_kb + T.slot[j] * nodes;
        kj[p] = kj[p] + a * dui;
      }
    }
    // dC[g] += sum_p kbar_i B_g(us_i), dW += sum_p kbar_i swish(us_i):
    // one warp per sum
    for (int q = warp; q <= G; q += n_warps) {
      float acc = 0.0f;
      for (int p = lane; p < nodes; p += 32) {
        const float x = us[p];
        float v;
        if (q < G) {
          const float z = gb_z(kc_norm(x, T.normalizer), q, T);
          v = expf(-(z * z));
        } else {
          v = kc_swish(x);
        }
        acc += kb[p] * v;
      }
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, off);
      if (lane == 0) s_dp[q] = s_dp[q] + acc;
    }
    __syncthreads();
  }

  for (int p = threadIdx.x; p < nodes; p += blockDim.x) du[p] = s_ub[p];
  for (int i = threadIdx.x; i < G; i += blockDim.x) dc[i] = s_dp[i];
  if (threadIdx.x == 0) dw[0] = s_dp[G];
}

int gb_threads(int n) {
  const int t = ((n + 31) / 32) * 32;
  return t < GB_MAX_THREADS ? t : GB_MAX_THREADS;
}

}  // namespace

extern "C" {

void gb_caps(int* out) {
  out[0] = GB_MAX_NODES;
  out[1] = GB_MAX_N;
  out[2] = GB_MAX_G;
  out[3] = GB_MAX_STAGES;
}

int gb_step_fwd(const float* u, const float* lap, const float* c,
                const float* w, float* y, const GrayTab* T, void* stream) {
  const size_t smem = (size_t)(T->N * T->N + T->nodes * (2 + T->n_slots)
                               + T->G + 1) * sizeof(float);
  cudaError_t err = kc_smem_opt_in(gb_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  gb_fwd_kernel<<<1, gb_threads(T->nodes), smem, (cudaStream_t)stream>>>(
      u, lap, c, w, y, *T);
  return (int)cudaGetLastError();
}

int gb_step_bwd(const float* u, const float* lap, const float* c,
                const float* w, const float* gy, float* du, float* dc,
                float* dw, const GrayTab* T, void* stream) {
  const size_t smem = (size_t)(T->N * T->N + T->nodes * (2 * T->n_slots + 1)
                               + 2 * (T->G + 1)) * sizeof(float);
  cudaError_t err = kc_smem_opt_in(gb_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  // at least one warp per parameter sum
  const int n = T->nodes > 32 * (T->G + 1) ? T->nodes : 32 * (T->G + 1);
  gb_bwd_kernel<<<1, gb_threads(n), smem, (cudaStream_t)stream>>>(
      u, lap, c, w, gy, du, dc, dw, *T);
  return (int)cudaGetLastError();
}

}  // extern "C"
