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
//   * K2f and K2b: one thread per batch row runs all stages with its
//     state in registers/local memory, parameters and grid constants
//     staged once in shared memory;
//   * K3f: a warp a row, up to KF_MAX_WARPS rows a block and as many
//     blocks as the rows need (`multistep_fwd_plan` in ops/_cuda.py); the
//     row's n steps run in its warp with no block barrier, each chain
//     evaluation spread over the lanes by K4f's kf_chain_fwd
//     (kan_chain_warp.cuh), lane h's slices of the parameters in
//     registers for the whole trajectory, the stage vectors in the warp's
//     shared memory. One thread a row took ~34k cycles an evaluation, 71%
//     of it layer 2, in an 800-byte stack frame (PERF.md, the K3f/K8f
//     trace). Its products and sums round as a -fmad=false build's do;
//     the stage inputs and the step's sum are explicit fmaf, as this
//     file's default contraction made of the one-thread loops;
//   * K3b: every warp of the block rebuilds steps from the stored step
//     inputs, several at a time, with each stage's Jacobian, then a warp
//     a row runs the reverse recursion, where a stage's VJP is a few
//     multiply-adds (kan_chain_warp.cuh; chunks from the host's launch
//     plan, `warp_adjoint_plan` in ops/_cuda.py); one thread a row took
//     ~15 us a chain evaluation, mostly local-memory traffic on its
//     dependent chain (PERF.md, the K3b/K4b trace);
//   * the backwards recompute each step's stages from the stored step
//     inputs, run the reverse-RK recursion per row, store the per
//     (step, row, stage) operands of the parameter cotangents in a
//     scratch buffer the wrapper allocates, then every thread of the
//     block sums the cotangents of the parameters it owns in record
//     order: a fixed order, no float atomics, so results repeat bit for
//     bit. The TPU kernel's `_bwd_window` GEMM batching is a TPU latency
//     trick and is not ported; only the gradients must match.
//   * chains past those kernels' caps (I, O <= 8, H <= 32: the Burgers and
//     1-D Allen-Cahn surrogates, the packed LV ensemble) take the medium
//     flavor, a block a row (kan_chain_block.cuh): kb_rk_step_fwd (K2f-m),
//     kb_rk_step_bwd (K2b-m), kb_rk_multistep_fwd (K3f-m) and
//     kb_rk_multistep_bwd (K3b-m); each backward is two launches, the
//     rows' reverse recursion and the parameter sums.
// Launches go on the caller's stream; nothing here allocates or syncs.

#include "kan_chain_block.cuh"

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

// Floats of K3f's dynamic shared memory: the parameters and, for each
// warp, its row's stage input [I], stage values [S][I] and kf_chain_fwd's
// workspace.
__host__ __device__ inline size_t k3f_smem_floats(const ChainDims& d,
                                                  int stages, int warps) {
  return kc_param_floats(d)
         + (size_t)warps * (d.I + stages * d.I + kf_chain_ws_floats(d));
}

// K3f: a warp a row (row blockIdx.x * warps + warp), the row's n steps
// in the warp with no block barrier; state component q in lane q < I,
// each chain evaluation spread over the lanes by kf_chain_fwd, lane h's
// slices of the parameters in registers for the whole trajectory.
__global__ void __launch_bounds__(KW_LANES * KF_MAX_WARPS)
rk_multistep_fwd_kernel(const float* x0, const float* c1, const float* w1,
                        const float* c2, const float* w2, float* ys, int K,
                        int n_steps, ChainDims d, StepTab T) {
  extern __shared__ float smem[];
  __shared__ WarpConsts wc;
  __shared__ unsigned char s_l2h[KC_MAX_H * KC_MAX_G];
  kw_fill_consts(wc, d, T.stages, T.a, T.b, T.needed);
  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, smem);
  const int I = d.I, S = T.stages, IG = I * d.G;
  for (int l = threadIdx.x; l < IG + I; l += blockDim.x) {
    wc.term_x[l] = l < IG ? l / d.G : l - IG;
    wc.term_c[l] = l < IG ? wc.grid[l % d.G] : 0.0f;
  }
  kf_fill_l2(s_l2h, d);
  const int warp = threadIdx.x / KW_LANES, lane = threadIdx.x % KW_LANES;
  const int warps = blockDim.x / KW_LANES;
  float* xs = smem + kc_param_floats(d)
              + (size_t)warp * (I + S * I + kf_chain_ws_floats(d));
  float* ks = xs + I;                             // stage values [S][I]
  float* cw = ks + S * I;                         // kf_chain_fwd's
  KfRegs rg;
  kf_load_regs(rg, p, d, lane);
  __syncthreads();
  const int r = blockIdx.x * warps + warp;
  if (r >= K) return;
  const bool mine = lane < I;                     // lane q: component q
  float x = mine ? x0[(size_t)r * I + lane] : 0.0f;
  for (int s = 0; s < n_steps; ++s) {
    for (int i = 0; i < S; ++i) {
      if (!wc.needed[i]) continue;
      if (mine) {
        // the loads first (wc.a[i][j] is zero for j >= i and for a stage
        // j no output needs; ks[j] of such a stage, or past the stages in
        // the warp's workspace, is never used)
        float av[KC_MAX_STAGES - 1], kv[KC_MAX_STAGES - 1];
#pragma unroll
        for (int j = 0; j < KC_MAX_STAGES - 1; ++j) {
          av[j] = wc.a[i][j];
          kv[j] = ks[j * I + lane];
        }
        float v = x;
#pragma unroll
        for (int j = 0; j < KC_MAX_STAGES - 1; ++j)
          if (av[j] != 0.0f) v = fmaf(av[j], kv[j], v);
        xs[lane] = v;
      }
      __syncwarp();
      kf_chain_fwd(xs, ks + i * I, d, wc, s_l2h, p, rg, cw, lane);
      __syncwarp();
    }
    if (mine) {
      float y = x;
#pragma unroll
      for (int i = 0; i < KC_MAX_STAGES; ++i)
        if (i < S && wc.b[i] != 0.0f) y = fmaf(wc.b[i], ks[i * I + lane], y);
      ys[((size_t)s * K + r) * I + lane] = y;
      x = y;
    }
  }
}

// K3b: the rows in groups of up to `warps` (one warp a row), the steps
// of a group in chunks of `chunk` from the last; per chunk phase A over
// every (row, step) by every warp, then phase B by the row warps
// (kan_chain_warp.cuh); then the block's parameter sums.
__global__ void __launch_bounds__(KW_LANES * KW_MAX_WARPS)
rk_multistep_bwd_kernel(const float* x0, const float* ys, const float* gys,
                        const float* c1, const float* w1, const float* c2,
                        const float* w2, float* dx0, float* dc1, float* dw1,
                        float* dc2, float* dw2, float* scratch, int K,
                        int n_steps, int n_slots, int chunk, ChainDims d,
                        StepTab T) {
  extern __shared__ float smem[];
  __shared__ WarpConsts c;
  const int warp = threadIdx.x / KW_LANES, lane = threadIdx.x % KW_LANES;
  const int warps = blockDim.x / KW_LANES;
  WarpRow* rows = reinterpret_cast<WarpRow*>(smem + kc_param_floats(d));
  WarpRow& w = rows[warp];
  float* fac_all = reinterpret_cast<float*>(rows + warps);
  kw_fill_consts(c, d, T.stages, T.a, T.b, T.needed);
  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, smem);
  kw_fill_terms(c, d, w, lane);
  __syncthreads();
  const RecLayout L = kc_rec_layout(d.I, d.H, d.O, d.G);
  const int I = d.I;
  const size_t fstep = (size_t)n_slots * kw_factor_layout(d).width;
  for (int r0 = 0; r0 < K; r0 += warps) {
    const int R = K - r0 < warps ? K - r0 : warps;
    float xbar = 0.0f;             // row warps, lane q < I: component q
    for (int hi = n_steps - 1; hi >= 0; hi -= chunk) {
      const int lo = hi - chunk + 1 > 0 ? hi - chunk + 1 : 0;
      // A: rebuild every (row, step) of the chunk
      for (int it = warp; it < R * (hi - lo + 1); it += warps) {
        const int ri = it % R, s = lo + it / R, r = r0 + ri;
        // input state of step s: ys[s-1] (x0 for the first step)
        const float* x_in =
            s == 0 ? x0 + r * I : ys + ((size_t)(s - 1) * K + r) * I;
        kw_rk_step_stages(x_in, T.stages, d, c, p, L, w, lane,
                          fac_all + ((size_t)ri * chunk + (s - lo)) * fstep,
                          scratch + ((size_t)s * K + r) * n_slots * L.width);
      }
      __syncthreads();
      // B: the reverse recursion, a warp a row
      if (warp < R) {
        const int r = r0 + warp;
        for (int s = hi; s >= lo; --s) {
          if (lane < I) xbar = xbar + gys[((size_t)s * K + r) * I + lane];
          xbar = kw_rk_step_reverse(
              xbar, T.stages, n_slots, d, c, L, w, lane,
              fac_all + ((size_t)warp * chunk + (s - lo)) * fstep,
              scratch + ((size_t)s * K + r) * n_slots * L.width);
        }
      }
      __syncthreads();
    }
    if (warp < R && lane < I) dx0[(r0 + warp) * I + lane] = xbar;
  }
  kc_reduce_param_grads(scratch, n_steps * K * n_slots, d, L, dc1, dw1, dc2,
                        dw2);
}

// ---------------------------------------------------------------------------
// The medium flavor: a block a row (kan_chain_block.cuh)
// ---------------------------------------------------------------------------

// K2f-m: one RK step of row blockIdx.x.
__global__ void __launch_bounds__(KB_THREADS)
kb_step_fwd_kernel(const float* x, const float* c1, const float* w1,
                   const float* c2, const float* w2, float* y, ChainDims d,
                   StepTab T) {
  extern __shared__ float smem[];
  __shared__ WarpConsts c;
  kw_fill_consts(c, d, T.stages, T.a, T.b, T.needed);
  const BlockParams p = kb_stage_params(c1, w1, c2, w2, d, smem);
  const int I = d.I, r = blockIdx.x;
  float* xr = smem + kc_param_floats(d);
  float* xi = xr + I;
  float* ks = xi + I;
  float* ws = ks + T.stages * I;
  for (int q = threadIdx.x; q < I; q += blockDim.x)
    xr[q] = x[(size_t)r * I + q];
  __syncthreads();
  kb_rk_step(xr, xr, T.stages, d, c, p, xi, ks, ws);
  for (int q = threadIdx.x; q < I; q += blockDim.x)
    y[(size_t)r * I + q] = xr[q];
}

// K3f-m: n_steps RK steps of row blockIdx.x, every post-step state stored
// at ys [n_steps, K, I].
__global__ void __launch_bounds__(KB_THREADS)
kb_multistep_fwd_kernel(const float* x0, const float* c1, const float* w1,
                        const float* c2, const float* w2, float* ys, int K,
                        int n_steps, ChainDims d, StepTab T) {
  extern __shared__ float smem[];
  __shared__ WarpConsts c;
  kw_fill_consts(c, d, T.stages, T.a, T.b, T.needed);
  const BlockParams p = kb_stage_params(c1, w1, c2, w2, d, smem);
  const int I = d.I, r = blockIdx.x;
  float* xr = smem + kc_param_floats(d);
  float* xi = xr + I;
  float* ks = xi + I;
  float* ws = ks + T.stages * I;
  for (int q = threadIdx.x; q < I; q += blockDim.x)
    xr[q] = x0[(size_t)r * I + q];
  __syncthreads();
  for (int s = 0; s < n_steps; ++s) {
    kb_rk_step(xr, xr, T.stages, d, c, p, xi, ks, ws);
    for (int q = threadIdx.x; q < I; q += blockDim.x)
      ys[((size_t)s * K + r) * I + q] = xr[q];
  }
}

// K2b-m, its first launch: the step adjoint of row blockIdx.x; dx and the
// row's n_slots records at scratch + r * n_slots * width.
__global__ void __launch_bounds__(KB_THREADS)
kb_step_bwd_kernel(const float* x, const float* gy, const float* c1,
                   const float* w1, const float* c2, const float* w2,
                   float* dx, float* scratch, int n_slots, ChainDims d,
                   StepTab T) {
  extern __shared__ float smem[];
  __shared__ WarpConsts c;
  kw_fill_consts(c, d, T.stages, T.a, T.b, T.needed);
  const BlockParams p = kb_stage_params(c1, w1, c2, w2, d, smem);
  const RecLayout L = kc_rec_layout(d.I, d.H, d.O, d.G);
  const int I = d.I, r = blockIdx.x;
  const BlockAdjRows a = kb_adj_rows(smem + kc_param_floats(d), d, T.stages);
  for (int q = threadIdx.x; q < I; q += blockDim.x) {
    a.x[q] = x[(size_t)r * I + q];
    a.gy[q] = gy[(size_t)r * I + q];
  }
  __syncthreads();
  kb_rk_step_adjoint(a, T.stages, n_slots, d, c, p, L,
                     scratch + (size_t)r * n_slots * L.width);
  for (int q = threadIdx.x; q < I; q += blockDim.x)
    dx[(size_t)r * I + q] = a.dx[q];
}

// K3b-m, its first launch: the reverse sweep of row blockIdx.x over the
// stored states, the cotangent gys[s] of every stored state folded in;
// the records of step s at scratch + (s * K + r) * n_slots * width.
__global__ void __launch_bounds__(KB_THREADS)
kb_multistep_bwd_kernel(const float* x0, const float* ys, const float* gys,
                        const float* c1, const float* w1, const float* c2,
                        const float* w2, float* dx0, float* scratch, int K,
                        int n_steps, int n_slots, ChainDims d, StepTab T) {
  extern __shared__ float smem[];
  __shared__ WarpConsts c;
  kw_fill_consts(c, d, T.stages, T.a, T.b, T.needed);
  const BlockParams p = kb_stage_params(c1, w1, c2, w2, d, smem);
  const RecLayout L = kc_rec_layout(d.I, d.H, d.O, d.G);
  const int I = d.I, r = blockIdx.x;
  const BlockAdjRows a = kb_adj_rows(smem + kc_param_floats(d), d, T.stages);
  for (int q = threadIdx.x; q < I; q += blockDim.x) a.dx[q] = 0.0f;
  for (int s = n_steps - 1; s >= 0; --s) {
    // input state of step s: ys[s-1] (x0 for the first step)
    const float* x_in = s == 0 ? x0 + (size_t)r * I
                               : ys + ((size_t)(s - 1) * K + r) * I;
    for (int q = threadIdx.x; q < I; q += blockDim.x) {
      a.x[q] = x_in[q];
      a.gy[q] = a.dx[q] + gys[((size_t)s * K + r) * I + q];
    }
    __syncthreads();
    kb_rk_step_adjoint(a, T.stages, n_slots, d, c, p, L,
                       scratch + ((size_t)s * K + r) * n_slots * L.width);
  }
  for (int q = threadIdx.x; q < I; q += blockDim.x)
    dx0[(size_t)r * I + q] = a.dx[q];
}

// The second launch of K2b-m and K3b-m: the parameter cotangents from the
// n_rec records, a thread a parameter.
__global__ void __launch_bounds__(KB_THREADS)
kb_param_sums_kernel(const float* scratch, int n_rec, ChainDims d,
                     float* dc1, float* dw1, float* dc2, float* dw2) {
  const RecLayout L = kc_rec_layout(d.I, d.H, d.O, d.G);
  kb_param_sums(scratch, n_rec, d, L, dc1, dw1, dc2, dw2);
}

// Launch the parameter sums over n_rec records.
cudaError_t kb_launch_param_sums(const float* scratch, int n_rec,
                                 const ChainDims& d, float* dc1, float* dw1,
                                 float* dc2, float* dw2, cudaStream_t st) {
  const int n = kc_param_floats(d);
  kb_param_sums_kernel<<<(n + KB_THREADS - 1) / KB_THREADS, KB_THREADS, 0,
                         st>>>(scratch, n_rec, d, dc1, dw1, dc2, dw2);
  return cudaGetLastError();
}

// Opt a medium-flavor kernel in to its shared memory; refuse a chain past
// the caps (the wrapper checks them first).
template <typename Kernel>
cudaError_t kb_prepare(Kernel kernel, const ChainDims& d, int stages,
                       bool backward, size_t* smem) {
  *smem = kb_smem_floats(d, stages, backward) * sizeof(float);
  if (d.I < 1 || d.I > KB_MAX_I || d.O != d.I || d.H < 1 || d.H > KB_MAX_H
      || d.G < 2 || d.G > KC_MAX_G || stages < 1 || stages > KC_MAX_STAGES
      || *smem > KB_MAX_SMEM)
    return cudaErrorInvalidValue;
  return kc_smem_opt_in(kernel, *smem);
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
                        int n_steps, int warps, const ChainDims* d,
                        const StepTab* T, void* stream) {
  if (warps < 1 || warps > KF_MAX_WARPS || K < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = k3f_smem_floats(*d, T->stages, warps) * sizeof(float);
  cudaError_t err = kc_smem_opt_in(rk_multistep_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (K + warps - 1) / warps;
  rk_multistep_fwd_kernel<<<blocks, warps * KW_LANES, smem,
                            (cudaStream_t)stream>>>(x0, c1, w1, c2, w2, ys, K,
                                                    n_steps, *d, *T);
  return (int)cudaGetLastError();
}

// K3f's dynamic shared memory for `warps` warps (the wrapper's
// multistep_fwd_plan computes the same).
int kc_multistep_fwd_smem_bytes(const ChainDims* d, int stages, int warps) {
  return (int)(k3f_smem_floats(*d, stages, warps) * sizeof(float));
}

int kc_rk_multistep_bwd(const float* x0, const float* ys, const float* gys,
                        const float* c1, const float* w1, const float* c2,
                        const float* w2, float* dx0, float* dc1, float* dw1,
                        float* dc2, float* dw2, float* scratch, int K,
                        int n_steps, int n_slots, int warps, int chunk,
                        const ChainDims* d, const StepTab* T, void* stream) {
  if (warps < 1 || warps > KW_MAX_WARPS || chunk < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = kw_smem_floats(*d, warps, K < warps ? K : warps,
                                     chunk, n_slots) * sizeof(float);
  cudaError_t err = kc_smem_opt_in(rk_multistep_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  rk_multistep_bwd_kernel<<<1, warps * KW_LANES, smem,
                            (cudaStream_t)stream>>>(
      x0, ys, gys, c1, w1, c2, w2, dx0, dc1, dw1, dc2, dw2, scratch, K,
      n_steps, n_slots, chunk, *d, *T);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of K3b and K4b: K rows, `warps` warps, chunks of
// `chunk` steps of `slots` chain evaluations (the Python launch plan
// computes the same).
int kw_smem_bytes(const ChainDims* d, int K, int warps, int chunk,
                  int slots) {
  return (int)(kw_smem_floats(*d, warps, K < warps ? K : warps, chunk,
                              slots) * sizeof(float));
}

// The medium flavor's caps, for the wrapper to check its own copy
// against: out[0..4] = KB_MAX_I, KB_MAX_H, KC_MAX_G, KC_MAX_STAGES,
// KB_MAX_SMEM.
void kb_caps(int* out) {
  out[0] = KB_MAX_I;
  out[1] = KB_MAX_H;
  out[2] = KC_MAX_G;
  out[3] = KC_MAX_STAGES;
  out[4] = KB_MAX_SMEM;
}

// The dynamic shared memory of a medium-flavor launch (the wrapper's
// `block_smem_floats` computes the same).
int kb_smem_bytes(const ChainDims* d, int stages, int backward) {
  return (int)(kb_smem_floats(*d, stages, backward != 0) * sizeof(float));
}

int kb_rk_step_fwd(const float* x, const float* c1, const float* w1,
                   const float* c2, const float* w2, float* y, int K,
                   const ChainDims* d, const StepTab* T, void* stream) {
  size_t smem;
  cudaError_t err = kb_prepare(kb_step_fwd_kernel, *d, T->stages, false,
                               &smem);
  if (err != cudaSuccess) return (int)err;
  if (K < 1) return (int)cudaErrorInvalidValue;
  kb_step_fwd_kernel<<<K, KB_THREADS, smem, (cudaStream_t)stream>>>(
      x, c1, w1, c2, w2, y, *d, *T);
  return (int)cudaGetLastError();
}

int kb_rk_step_bwd(const float* x, const float* gy, const float* c1,
                   const float* w1, const float* c2, const float* w2,
                   float* dx, float* dc1, float* dw1, float* dc2, float* dw2,
                   float* scratch, int K, int n_slots, const ChainDims* d,
                   const StepTab* T, void* stream) {
  size_t smem;
  cudaError_t err = kb_prepare(kb_step_bwd_kernel, *d, T->stages, true,
                               &smem);
  if (err != cudaSuccess) return (int)err;
  if (K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  kb_step_bwd_kernel<<<K, KB_THREADS, smem, st>>>(
      x, gy, c1, w1, c2, w2, dx, scratch, n_slots, *d, *T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)kb_launch_param_sums(scratch, K * n_slots, *d, dc1, dw1, dc2,
                                   dw2, st);
}

int kb_rk_multistep_fwd(const float* x0, const float* c1, const float* w1,
                        const float* c2, const float* w2, float* ys, int K,
                        int n_steps, const ChainDims* d, const StepTab* T,
                        void* stream) {
  size_t smem;
  cudaError_t err = kb_prepare(kb_multistep_fwd_kernel, *d, T->stages, false,
                               &smem);
  if (err != cudaSuccess) return (int)err;
  if (K < 1 || n_steps < 1) return (int)cudaErrorInvalidValue;
  kb_multistep_fwd_kernel<<<K, KB_THREADS, smem, (cudaStream_t)stream>>>(
      x0, c1, w1, c2, w2, ys, K, n_steps, *d, *T);
  return (int)cudaGetLastError();
}

int kb_rk_multistep_bwd(const float* x0, const float* ys, const float* gys,
                        const float* c1, const float* w1, const float* c2,
                        const float* w2, float* dx0, float* dc1, float* dw1,
                        float* dc2, float* dw2, float* scratch, int K,
                        int n_steps, int n_slots, const ChainDims* d,
                        const StepTab* T, void* stream) {
  size_t smem;
  cudaError_t err = kb_prepare(kb_multistep_bwd_kernel, *d, T->stages, true,
                               &smem);
  if (err != cudaSuccess) return (int)err;
  if (K < 1 || n_steps < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  kb_multistep_bwd_kernel<<<K, KB_THREADS, smem, st>>>(
      x0, ys, gys, c1, w1, c2, w2, dx0, scratch, K, n_steps, n_slots, *d,
      *T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)kb_launch_param_sums(scratch, n_steps * K * n_slots, *d, dc1,
                                   dw1, dc2, dw2, st);
}

}  // extern "C"
