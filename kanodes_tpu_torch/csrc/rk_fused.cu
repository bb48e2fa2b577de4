// Whole-RK-step and multistep kernels over the 2-layer KDense chain, for
// Hopper (sm_90a), with a plain C interface loaded through ctypes
// (kanodes_tpu_torch/ops/_cuda.py builds this file with nvcc).
//
// Replaces the Pallas kernels of kanodes_tpu/ops/rk_fused.py:
//   kc_rk_multistep_fwd <- _step_fwd_kernel       (fused_rk_step; n = 1)
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
//   * K2f: K3f's kernel launched at one step, its ys[0] the step's y;
//   * K2b: K3b's two phases at one step, a warp a row and the rows over
//     as many blocks as they need (`step_bwd_plan` in ops/_cuda.py): the
//     row's warp rebuilds the stages with each stage's Jacobian, then runs
//     the reverse recursion with no block barrier between; the parameter
//     sums are a second launch. One thread a row took ~3 * 10^4 cycles a
//     chain evaluation on a dependent chain through its stack (PERF.md,
//     the K2f/K2b trace);
//   * K3f: a warp a row, up to KF_MAX_WARPS rows a block and as many
//     blocks as the rows need (`multistep_fwd_plan` in ops/_cuda.py); the
//     row's n steps run in its warp with no block barrier, each chain
//     evaluation spread over the lanes by K4f's kf_chain_fwd
//     (kan_chain_warp.cuh), lane h's slices of the parameters in
//     registers for the whole trajectory, the stage vectors in the warp's
//     shared memory. One thread a row took ~34k cycles an evaluation, 71%
//     of it layer 2, in an 800-byte stack frame (PERF.md, the K3f/K8f
//     trace). Its products and sums round as a -fmad=false build's do;
//     the stage inputs and the step's sum are explicit fmaf;
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
//     scratch buffer the wrapper allocates, then one thread a parameter
//     sums its cotangent in record order (K3b in its block, K2b in its
//     second launch from shared memory, the same fused multiply-adds): a
//     fixed order, no float atomics, so results repeat bit for bit. The
//     TPU kernel's `_bwd_window` GEMM batching is a TPU latency trick and
//     is not ported; only the gradients must match.
//   * chains past those kernels' caps (I, O <= 8, H <= 32: the Burgers and
//     1-D Allen-Cahn surrogates, the packed LV ensemble) take the medium
//     flavor: kb_rk_step_fwd (K2f-m) and kb_rk_step_bwd (K2b-m, two
//     launches: the rows' adjoint and the parameter sums), a block a row
//     (kan_chain_block.cuh); kb_rk_multistep_fwd (K3f-m, KM_THREADS threads
//     a row) and kb_rk_multistep_bwd (K3b-m: a block a step rebuilds it
//     with its stage Jacobians, a warp or a block a row runs the
//     recursion, then the records' dy1 and the parameter sums:
//     kan_chain_multistep.cuh).
// Launches go on the caller's stream; nothing here allocates or syncs.

#include "kan_chain_block.cuh"
#include "kan_chain_multistep.cuh"

namespace {

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

// K2b: the adjoint of one RK step, a warp a row (row blockIdx.x * warps +
// warp): K3b's phases at n = 1 in the row's own warp, so no block barrier
// follows the set-up; the row's records at scratch + r * n_slots * width,
// where K3b puts step 0's. Its parameter sums are the second launch.
__global__ void __launch_bounds__(KW_LANES * KW_MAX_WARPS)
rk_step_adjoint_kernel(const float* x, const float* gy, const float* c1,
                       const float* w1, const float* c2, const float* w2,
                       float* dx, float* scratch, int K, int n_slots,
                       ChainDims d, StepTab T) {
  extern __shared__ float smem[];
  __shared__ WarpConsts c;
  const int warp = threadIdx.x / KW_LANES, lane = threadIdx.x % KW_LANES;
  const int warps = blockDim.x / KW_LANES;
  WarpRow* rows = reinterpret_cast<WarpRow*>(smem + kc_param_floats(d));
  WarpRow& w = rows[warp];
  float* fac = reinterpret_cast<float*>(rows + warps)
               + (size_t)warp * n_slots * kw_factor_layout(d).width;
  kw_fill_consts(c, d, T.stages, T.a, T.b, T.needed);
  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, smem);
  kw_fill_terms(c, d, w, lane);
  __syncthreads();
  const int r = blockIdx.x * warps + warp;
  if (r >= K) return;
  const RecLayout L = kc_rec_layout(d.I, d.H, d.O, d.G);
  float* rec = scratch + (size_t)r * n_slots * L.width;
  kw_rk_step_stages(x + (size_t)r * d.I, T.stages, d, c, p, L, w, lane, fac,
                    rec);
  float xbar = 0.0f;                // K3b folds gys[0] into a zero
  if (lane < d.I) xbar = xbar + gy[(size_t)r * d.I + lane];
  xbar = kw_rk_step_reverse(xbar, T.stages, n_slots, d, c, L, w, lane, fac,
                            rec);
  if (lane < d.I) dx[(size_t)r * d.I + lane] = xbar;
}

// Issue the copies of m floats from src to dst (shared memory, 16-byte
// aligned): 16 bytes a copy while src is 16-byte aligned, the tail (or
// all, if src is not) 4 bytes a copy; they land at cp.async.wait_all.
__device__ inline void rk_copy_async(float* dst, const float* src, int m) {
  const int m4 = (reinterpret_cast<size_t>(src) & 15) == 0 ? m / 4 : 0;
  for (int k = threadIdx.x; k < m4; k += blockDim.x) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst + 4 * k);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src + 4 * k)
                 : "memory");
  }
  for (int k = 4 * m4 + threadIdx.x; k < m; k += blockDim.x)
    kb_cp_async4(dst + k, src + k);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The operands of parameter p's cotangent (kc_rec_layout): the two record
// fields whose products it sums, at a_off and b_off, and its output
// (nullptr past the parameters), as kb_param_sums decodes them.
__device__ inline float* rk_param_operands(int p, const ChainDims& d,
                                           const RecLayout& L, float* dc1,
                                           float* dw1, float* dc2,
                                           float* dw2, int& a_off,
                                           int& b_off) {
  const int I = d.I, H = d.H, O = d.O, G = d.G;
  const int n_c1 = I * G * H, n_w1 = I * H, n_c2 = H * G * O, n_w2 = H * O;
  if (p >= n_c1 + n_w1 + n_c2 + n_w2) return nullptr;
  if (p < n_c1) {                       // dc1[ig, h] = b1[ig] dy1[h]
    a_off = L.b1 + p / H;
    b_off = L.dy1 + p % H;
    return dc1 + p;
  }
  if (p < n_c1 + n_w1) {                // dw1[i, h] = swx[i] dy1[h]
    const int q = p - n_c1;
    a_off = L.swx + q / H;
    b_off = L.dy1 + q % H;
    return dw1 + q;
  }
  if (p < n_c1 + n_w1 + n_c2) {         // dc2[hg, o] = b2[hg] gk[o]
    const int q = p - n_c1 - n_w1;
    a_off = L.b2 + q / O;
    b_off = L.gk + q % O;
    return dc2 + q;
  }
  const int q = p - n_c1 - n_w1 - n_c2; // dw2[h, o] = swy1[h] gk[o]
  a_off = L.swy1 + q / O;
  b_off = L.gk + q % O;
  return dw2 + q;
}

// K2b's second launch: the parameter cotangents from n_rec records, a
// thread a parameter, in record order with kb_param_sums' fused
// multiply-adds (K3b's bits at one step). The block first copies `chunk`
// records at a time (a multiple of 4) into shared memory, so that each
// thread's chain of n_rec multiply-adds reads shared memory: from L2,
// across the launch boundary, the chain took 33k cycles at K = 34
// (PERF.md, the K2f/K2b trace).
__global__ void __launch_bounds__(KB_THREADS)
rk_param_sums_kernel(const float* scratch, int n_rec, int chunk, ChainDims d,
                     float* dc1, float* dw1, float* dc2, float* dw2) {
  extern __shared__ float srec[];
  const RecLayout L = kc_rec_layout(d.I, d.H, d.O, d.G);
  int a_off = 0, b_off = 0;
  float* out = rk_param_operands(blockIdx.x * blockDim.x + threadIdx.x, d,
                                 L, dc1, dw1, dc2, dw2, a_off, b_off);
  float acc = 0.0f;
  for (int r0 = 0; r0 < n_rec; r0 += chunk) {
    const int n = n_rec - r0 < chunk ? n_rec - r0 : chunk;
    rk_copy_async(srec, scratch + (size_t)r0 * L.width, n * L.width);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (out != nullptr) {
      const float* ra = srec + a_off;
      const float* rb = srec + b_off;
#pragma unroll 8
      for (int r = 0; r < n; ++r)
        acc = fmaf(ra[r * L.width], rb[r * L.width], acc);
    }
    __syncthreads();              // the chunk is read before the next lands
  }
  if (out != nullptr) *out = acc;
}

// Launch K2b's parameter sums over n_rec records: chunks of as many
// records as KB_MAX_SMEM holds, a multiple of 4, at most n_rec rounded up.
cudaError_t rk_launch_param_sums(const float* scratch, int n_rec,
                                 const ChainDims& d, float* dc1, float* dw1,
                                 float* dc2, float* dw2, cudaStream_t st) {
  const int width = kc_rec_layout(d.I, d.H, d.O, d.G).width;
  const int fit = KB_MAX_SMEM / (int)(4 * sizeof(float) * width) * 4;
  const int need = (n_rec + 3) / 4 * 4;
  const int chunk = need < fit ? need : fit;
  const size_t smem = (size_t)chunk * width * sizeof(float);
  cudaError_t err = kc_smem_opt_in(rk_param_sums_kernel, smem);
  if (err != cudaSuccess) return err;
  const int n = kc_param_floats(d);
  rk_param_sums_kernel<<<(n + KB_THREADS - 1) / KB_THREADS, KB_THREADS, smem,
                         st>>>(scratch, n_rec, chunk, d, dc1, dw1, dc2, dw2);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The medium flavor: a block a row (kan_chain_block.cuh)
// ---------------------------------------------------------------------------

// Every medium-flavor kernel starts alike: the tableau's constants, the
// parameters' copies issued, the partials `lead` floats after them, the
// thread's walks (their divisions overlap the copies); the caller then
// loads its rows and calls kb_stage_wait.
#define KB_SETUP(lead)                                               \
  extern __shared__ float smem[];                                    \
  __shared__ WarpConsts c;                                           \
  kw_fill_consts(c, d, T.stages, T.a, T.b, T.needed);                \
  const KbCtx k = kb_stage(c1, w1, c2, w2, d, plan, lead, smem);     \
  const int warp = threadIdx.x / KW_LANES, lane = threadIdx.x % KW_LANES; \
  const KbLanes ln = kb_lanes(d, plan, warp, lane);                  \
  const int I = d.I, r = blockIdx.x

// K2f-m: one RK step of row blockIdx.x. kCompact: the layout
// (plan.compact, kb_compact).
template <bool kCompact>
__global__ void __launch_bounds__(KB_THREADS)
kb_step_fwd_kernel(const float* x, const float* c1, const float* w1,
                   const float* c2, const float* w2, float* y, ChainDims d,
                   StepTab T, KbPlan plan) {
  // the row's first components load while the block sets up
  const float* xr = x + (size_t)blockIdx.x * d.I;
  const float x0 = threadIdx.x < d.I ? xr[threadIdx.x] : 0.0f;
  KB_SETUP(0);
  float* acc = k.rows;                            // [S + 1][I]
  for (int q = threadIdx.x; q < I; q += KB_THREADS)
    kb_acc_set(acc, T.stages, I, q, q < KB_THREADS ? x0 : xr[q]);
  kb_stage_wait();
  const int last =
      kb_rk_stages<kCompact>(k, ln, acc, nullptr, T.stages, d, c, lane);
  for (int q = threadIdx.x; q < I; q += KB_THREADS)
    y[(size_t)r * I + q] =
        kb_step_out<kCompact>(acc, k, I, T.stages, last, c, q);
}

// K3f-m: n_steps RK steps of row blockIdx.x by KM_THREADS threads (the
// evaluation of kan_chain_multistep.cuh), every post-step state stored at
// ys [n_steps, K, I].
__global__ void __launch_bounds__(KM_THREADS, 1)
k3m_fwd_kernel(const float* x0, const float* c1, const float* w1,
               const float* c2, const float* w2, float* ys, int K,
               int n_steps, ChainDims d, StepTab T, KmPlan plan) {
  extern __shared__ __align__(16) float km_smem[];
  __shared__ KmConsts k;
  km_fill_consts(k, d, T);
  const KmRows rw = km_rows(km_smem, plan, d);
  KmRegs rg;
  km_load_regs(rg, c1, w1, c2, w2, d, plan);
  km_zero_pads(rw, d, plan);
  const KmFeat ft = km_feat_of(threadIdx.x, d.G);
  const KmLane l1 = km_lane(rw.f1, plan.l1, d.H);
  const KmLane l2 = km_lane(rw.f2, plan.l2, d.O);
  const int r = blockIdx.x, S = T.stages;
  km_step_start(rw, x0 + (size_t)r * d.I, d, S);
  __syncthreads();
  int prev = -1, par = 0;
  for (int s = 0; s < n_steps; ++s) {
    // the previous step's result, stored as its inputs' features are taken
    float* y_prev = s > 0 ? ys + ((size_t)(s - 1) * K + r) * d.I : nullptr;
    for (int i = k.first; i >= 0; i = k.next[i]) {
      km_input_features<false>(rw, par, prev, i, ft, d, k, S, y_prev,
                               nullptr);
      if (prev >= 0) par ^= 1;
      __syncthreads();
      km_eval_l1(rw, rg, l1, c1, w1, d, plan);
      __syncthreads();
      km_features<false>(rw.y1, d.H, ft, d, k, rw.f2, nullptr, nullptr,
                         nullptr, 0, 0);
      __syncthreads();
      km_eval_l2(rw, rg, l2, c2, w2, d, plan);
      __syncthreads();
      prev = i;
    }
  }
  km_step_out(rw, par, prev, d, k, S,
              ys + ((size_t)(n_steps - 1) * K + r) * d.I);
}

// K2b-m, its first launch: the step adjoint of row blockIdx.x; dx, and
// its n_slots records at scratch + r * n_slots * width. kCompact: the
// layout (plan.compact).
template <bool kCompact>
__global__ void __launch_bounds__(KB_THREADS)
kb_step_bwd_kernel(const float* x, const float* gy, const float* c1,
                   const float* w1, const float* c2, const float* w2,
                   float* dx, float* scratch, int n_slots, ChainDims d,
                   StepTab T, KbPlan plan) {
  // the row's first components load while the block sets up
  const float* xr = x + (size_t)blockIdx.x * d.I;
  const float* gyr = gy + (size_t)blockIdx.x * d.I;
  const float x0 = threadIdx.x < d.I ? xr[threadIdx.x] : 0.0f;
  const float g0 = threadIdx.x < d.I ? gyr[threadIdx.x] : 0.0f;
  KB_SETUP(kb_adj_lead(d, T.stages, kCompact));
  const RecLayout L = kc_rec_layout(d.I, d.H, d.O, d.G);
  const BlockAdjRows a = kb_adj_rows(k, d, T.stages, kCompact);
  for (int q = threadIdx.x; q < I; q += KB_THREADS) {
    kb_acc_set(a.acc, T.stages, I, q, q < KB_THREADS ? x0 : xr[q]);
    a.gy[q] = q < KB_THREADS ? g0 : gyr[q];
  }
  kb_stage_wait();
  kb_rk_step_adjoint<kCompact>(k, ln, a, T.stages, n_slots, d, c, L,
                               scratch + (size_t)r * n_slots * L.width, warp,
                               lane);
  for (int q = threadIdx.x; q < I; q += KB_THREADS)
    dx[(size_t)r * I + q] = a.dx[q];
}

// K3b-m phase A: block s K + r rebuilds step s of row r from its input
// (ys[s-1], x0 for s = 0) with K3f-m's evaluation and stores, per needed
// stage (slot), the record's forward operands and the Jacobian block
// (KmBwdPlan) of record (s K + r) n_slots + slot.
__global__ void __launch_bounds__(KM_THREADS, 1)
k3m_rebuild_kernel(const float* x0, const float* ys, const float* c1,
                   const float* w1, const float* c2, const float* w2,
                   float* recs, float* jac, int K, int n_slots, ChainDims d,
                   StepTab T, KmPlan plan, KmBwdPlan bp) {
  extern __shared__ __align__(16) float km_smem[];
  __shared__ KmConsts k;
  km_fill_consts(k, d, T);
  const int I = d.I, H = d.H, S = T.stages;
  const KmRows rw = km_rows(km_smem, plan, d);
  KmKeep kp;
  kp.D1 = rw.acc + 2 * (S + 1) * I;
  kp.n1 = kp.D1 + plan.l1.Tp;
  kp.D2 = kp.n1 + I;
  kp.n2 = kp.D2 + plan.l2.Tp;
  float* a1 = kp.n2 + H;                      // [H][I | 1]
  float* a2 = a1 + H * km_odd(I);             // [O][H | 1]
  kp.L = kc_rec_layout(I, H, d.O, d.G);
  const int s = blockIdx.x / K, r = blockIdx.x - s * K;
  const size_t e0 = ((size_t)s * K + r) * n_slots;
  float* rec = recs + e0 * bp.width;
  float* jb = jac + e0 * bp.jw;
  KmRegs rg;
  km_load_regs(rg, c1, w1, c2, w2, d, plan);
  km_zero_pads(rw, d, plan);
  const KmFeat ft = km_feat_of(threadIdx.x, d.G);
  const KmLane l1 = km_lane(rw.f1, plan.l1, H);
  const KmLane l2 = km_lane(rw.f2, plan.l2, d.O);
  const float* x_in = s == 0 ? x0 + (size_t)r * I
                             : ys + ((size_t)(s - 1) * K + r) * I;
  km_step_start(rw, x_in, d, S);
  __syncthreads();
  int slot = 0, prev = -1, par = 0;
  for (int i = k.first; i >= 0; prev = i, i = k.next[i], ++slot) {
    kp.rec = rec + (size_t)slot * bp.width;
    km_input_features<true>(rw, par, prev, i, ft, d, k, S, nullptr, &kp);
    if (prev >= 0) par ^= 1;
    __syncthreads();
    km_eval_l1(rw, rg, l1, c1, w1, d, plan);
    __syncthreads();
    km_features<true>(rw.y1, H, ft, d, k, rw.f2, &kp, kp.D2, kp.n2, kp.L.b2,
                      kp.L.swy1);
    __syncthreads();
    km_stage_factors(kp, c1, w1, c2, w2, d, a1, a2);
    __syncthreads();
    km_stage_jacobian(a1, a2, d, bp.dense, jb + (size_t)slot * bp.jw);
    if (k.next[i] < 0) break;         // the step's sum is not needed here
    km_eval_l2(rw, rg, l2, c2, w2, d, plan);
    __syncthreads();
  }
}

// K3b-m phase B, a warp a row (dense J, I <= 32): row blockIdx.x * warps +
// warp, component q in lane q, the stage cotangents in registers; from the
// last step, lambda = dx + gys[s], kbar_i = (dt b_i) lambda, then per
// needed stage from the last: gk = kbar_i into its record, dx_q = sum_o
// J[o][q] kbar_o (kbar through shared memory, lane q's row of J^T and the
// vector read a quad at a time, four partial sums over o mod 4), lambda +=
// dx, kbar_j += (dt a_ij) dx for j < i. The next step's J^T rows are
// copied into the warp's other buffer meanwhile.
__global__ void __launch_bounds__(KW_LANES * KM_SWEEP_MAX_WARPS, 1)
k3m_sweep_warp_kernel(const float* gys, float* dx0, float* recs,
                      const float* jac, int K, int n_steps, int n_slots,
                      ChainDims d, StepTab T, KmBwdPlan bp) {
  extern __shared__ __align__(16) float km_jsm[];
  __shared__ KmConsts k;
  __shared__ __align__(16) float skb[KM_SWEEP_MAX_WARPS][2][KW_LANES];
  km_fill_consts(k, d, T);
  const int warp = threadIdx.x / KW_LANES, lane = threadIdx.x % KW_LANES;
  const int I = d.I, O = d.O, rs = km_jt_stride(O), nq = (O + 3) / 4;
  const int blk = I * rs, step = n_slots * blk;
  float* buf = km_jsm + (size_t)warp * 2 * step;
  // the rows' padding reads as zero
  for (int e = lane; e < 2 * step; e += KW_LANES) buf[e] = 0.0f;
  __syncthreads();
  const int r = blockIdx.x * (blockDim.x / KW_LANES) + warp;
  if (r >= K) return;
  const int gk_off = kc_rec_layout(I, d.H, O, d.G).gk;
  const bool mine = lane < I;
  // the tableau in registers (compile-time indices only)
  float cb[KC_MAX_STAGES], ca[KC_MAX_STAGES][KC_MAX_STAGES - 1];
  bool need[KC_MAX_STAGES];
#pragma unroll
  for (int i = 0; i < KC_MAX_STAGES; ++i) {
    cb[i] = k.b[i];
    need[i] = k.needed[i] != 0;
#pragma unroll
    for (int j = 0; j < KC_MAX_STAGES - 1; ++j)
      ca[i][j] = j < i ? k.a[i][j] : 0.0f;
  }
  const size_t row_jac = (size_t)n_slots * bp.jw;
  const float* jrow = jac + (size_t)r * row_jac;
  km_fetch_rows(buf + ((n_steps - 1) & 1) * step,
                jrow + (size_t)(n_steps - 1) * K * row_jac, n_slots, I, O,
                bp.jw, rs, lane);
  km_cp_commit();
  float gnext = mine ? gys[((size_t)(n_steps - 1) * K + r) * I + lane] : 0.0f;
  float lam = 0.0f;
  int par = 0;
  for (int s = n_steps - 1; s >= 0; --s) {
    if (s > 0)
      km_fetch_rows(buf + ((s - 1) & 1) * step,
                    jrow + (size_t)(s - 1) * K * row_jac, n_slots, I, O,
                    bp.jw, rs, lane);
    km_cp_commit();
    const float g = gnext;
    if (s > 0 && mine) gnext = gys[((size_t)(s - 1) * K + r) * I + lane];
    lam = lam + g;
    float kb[KC_MAX_STAGES];
#pragma unroll
    for (int i = 0; i < KC_MAX_STAGES; ++i) kb[i] = cb[i] * lam;
    km_cp_wait<1>();
    __syncwarp();
    const float* Jb = buf + (s & 1) * step;
    float* gk = recs + ((size_t)s * K + r) * n_slots * bp.width + gk_off;
    int slot = n_slots;
#pragma unroll
    for (int i = KC_MAX_STAGES - 1; i >= 0; --i) {
      if (!need[i]) continue;
      --slot;
      if (mine) gk[(size_t)slot * bp.width + lane] = kb[i];
      float* kv = skb[warp][par];
      par ^= 1;
      kv[lane] = kb[i];                // zero past I
      __syncwarp();
      const float4* jt = reinterpret_cast<const float4*>(
          Jb + slot * blk + (mine ? lane : 0) * rs);
      const float4* k4 = reinterpret_cast<const float4*>(kv);
      float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;
      for (int m = 0; m < nq; ++m) {
        const float4 a = jt[m], b = k4[m];
        p0 = fmaf(a.x, b.x, p0);
        p1 = fmaf(a.y, b.y, p1);
        p2 = fmaf(a.z, b.z, p2);
        p3 = fmaf(a.w, b.w, p3);
      }
      const float dx =
          mine ? __fadd_rn(__fadd_rn(p0, p1), __fadd_rn(p2, p3)) : 0.0f;
      lam = lam + dx;
#pragma unroll
      for (int j = 0; j < KC_MAX_STAGES - 1; ++j)
        if (j < i && ca[i][j] != 0.0f) kb[j] = fmaf(ca[i][j], dx, kb[j]);
    }
    __syncwarp();                  // before a copy refills this buffer
  }
  km_cp_wait<0>();
  if (mine) dx0[(size_t)r * I + lane] = lam;
}

// Phase B a block a row: the components past the block's threads (I >
// KM_SWEEP_THREADS), their lambda and kbar in shared memory. Out of line:
// inlined into the kernel's unrolled stage loop they slowed the common
// case, one component a thread.
__device__ __noinline__ void km_extra_seed(float* xl, float* xk, int nx,
                                           const float* g, const float* b,
                                           int tid, int nt) {
  for (int e = tid; e < nx; e += nt) {
    const float l = xl[e] + g[e];
    xl[e] = l;
    for (int i = 0; i < KC_MAX_STAGES; ++i) xk[i * nx + e] = b[i] * l;
  }
}

__device__ __noinline__ void km_extra_store(const float* xki, float* kv,
                                            float* gk, int nx, int tid,
                                            int nt) {
  for (int e = tid; e < nx; e += nt) {
    const float v = xki[e];
    kv[e] = v;
    gk[e] = v;
  }
}

__device__ __noinline__ void km_extra_update(const float* A, int as, int aq,
                                             const float* tv, int n,
                                             float* xl, float* xk, int nx,
                                             const float* ai, int i, int tid,
                                             int nt) {
  for (int e = tid; e < nx; e += nt) {
    const float dx = km_dot4(A + (size_t)e * aq, as, tv, n);
    xl[e] = xl[e] + dx;
    for (int j = 0; j < i; ++j)
      if (ai[j] != 0.0f) xk[j * nx + e] = fmaf(ai[j], dx, xk[j * nx + e]);
  }
}

// K3b-m phase B, a block a row (row blockIdx.x; the factors, or I > 32):
// the same recursion, the thread of component q = tid keeping lambda_q and
// the stage cotangents kbar_.q in registers and storing the current
// stage's into kv (two buffers, by stage parity, so that one barrier a
// stage suffices with J dense); a component past the block's threads (I >
// KM_SWEEP_THREADS, q = tid + j nt) keeps them in shared memory instead,
// with the same arithmetic. Dense: dx_q = sum_o J[o][q] kbar_o; factors:
// t_h = sum_o A2^T[h][o] kbar_o in a group of lanes an h (an xor-shuffle
// tree; t is the record's dy1), a barrier, then dx_q = sum_h A1[h][q] t_h.
// The next step's blocks are copied into shared memory meanwhile where two
// steps fit (bp.staged), else read from global memory.
__global__ void __launch_bounds__(KM_SWEEP_THREADS, 1)
k3m_sweep_block_kernel(const float* gys, float* dx0, float* recs,
                       const float* jac, int K, int n_steps, int n_slots,
                       ChainDims d, StepTab T, KmBwdPlan bp) {
  extern __shared__ __align__(16) float km_jsm[];
  __shared__ KmConsts k;
  km_fill_consts(k, d, T);
  __syncthreads();
  const int I = d.I, H = d.H, O = d.O, r = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int span = bp.span, step = n_slots * span;
  const RecLayout L = kc_rec_layout(I, H, O, d.G);
  float* buf = km_jsm;
  float* kv = km_jsm + (bp.staged ? 2 * step : 0);      // [2][I]
  float* tb = kv + 2 * I;                               // [H]
  // the components past the threads: lambda [nx], kbar [KC_MAX_STAGES][nx]
  const int nx = I > nt ? I - nt : 0;
  float* xl = tb + H;
  float* xk = xl + nx;
  float cb[KC_MAX_STAGES], ca[KC_MAX_STAGES][KC_MAX_STAGES - 1];
  bool need[KC_MAX_STAGES];
#pragma unroll
  for (int i = 0; i < KC_MAX_STAGES; ++i) {
    cb[i] = k.b[i];
    need[i] = k.needed[i] != 0;
#pragma unroll
    for (int j = 0; j < KC_MAX_STAGES - 1; ++j)
      ca[i][j] = j < i ? k.a[i][j] : 0.0f;
  }
  int lg = 5;                                           // t: lp lanes an h
  while (lg > 0 && (H << lg) > nt) --lg;
  const int lp = 1 << lg, c = tid & (lp - 1), h0 = tid >> lg;
  const size_t row_jac = (size_t)n_slots * bp.jw;
  const float* jrow = jac + (size_t)r * row_jac;
  const bool mine = tid < I;
  float lam = 0.0f, kb[KC_MAX_STAGES];
  for (int e = tid; e < nx; e += nt) xl[e] = 0.0f;
  if (bp.staged)
    km_fetch(buf + ((n_steps - 1) & 1) * step,
             jrow + (size_t)(n_steps - 1) * K * row_jac, n_slots, span, bp.jw,
             tid, nt);
  km_cp_commit();
  int par = 0;
  for (int s = n_steps - 1; s >= 0; --s) {
    if (bp.staged && s > 0)
      km_fetch(buf + ((s - 1) & 1) * step,
               jrow + (size_t)(s - 1) * K * row_jac, n_slots, span, bp.jw, tid,
               nt);
    km_cp_commit();
    const float* gs = gys + ((size_t)s * K + r) * I;
    if (mine) lam = lam + gs[tid];
#pragma unroll
    for (int i = 0; i < KC_MAX_STAGES; ++i) kb[i] = cb[i] * lam;
    if (nx) km_extra_seed(xl, xk, nx, gs + nt, k.b, tid, nt);
    km_cp_wait<1>();
    const float* base = bp.staged
                            ? buf + (s & 1) * step
                            : jrow + (size_t)s * K * row_jac;
    const int stride = bp.staged ? span : bp.jw;
    float* rs = recs + ((size_t)s * K + r) * n_slots * bp.width;
    int slot = n_slots;
#pragma unroll
    for (int i = KC_MAX_STAGES - 1; i >= 0; --i) {
      if (!need[i]) continue;
      --slot;
      float* kvp = kv + par * I;
      par ^= 1;
      float* rec = rs + (size_t)slot * bp.width;
      if (mine) {
        kvp[tid] = kb[i];
        rec[L.gk + tid] = kb[i];
      }
      if (nx) km_extra_store(xk + i * nx, kvp + nt, rec + L.gk + nt, nx, tid,
                             nt);
      __syncthreads();
      const float* F = base + (size_t)slot * stride;
      const float* A = F;                    // dense: J^T [I][O]
      const float* tv = kvp;                 // its cotangent, [O]
      int n = O, as = 1, aq = O;             // A's strides over o and q
      if (!bp.dense) {
        float t = 0.0f;
        if (h0 < H)
          for (int o = c; o < O; o += lp)
            t = fmaf(F[(size_t)h0 * O + o], kvp[o], t);
        for (int off = lp >> 1; off > 0; off >>= 1)
          t = __fadd_rn(t, __shfl_xor_sync(0xffffffffu, t, off));
        if (h0 < H && c == 0) {
          tb[h0] = t;
          rec[L.dy1 + h0] = t;
        }
        __syncthreads();
        A = F + (size_t)H * O;               // A1 [H][I]
        tv = tb;
        n = H;
        as = I;
        aq = 1;
      }
      if (mine) {
        const float dx = km_dot4(A + (size_t)tid * aq, as, tv, n);
        lam = lam + dx;
#pragma unroll
        for (int j = 0; j < KC_MAX_STAGES - 1; ++j)
          if (j < i && ca[i][j] != 0.0f) kb[j] = fmaf(ca[i][j], dx, kb[j]);
      }
      if (nx) km_extra_update(A + (size_t)nt * aq, as, aq, tv, n, xl, xk, nx,
                              k.a[i], i, tid, nt);
    }
    __syncthreads();               // before a copy refills this step's buffer
  }
  km_cp_wait<0>();
  if (mine) dx0[(size_t)r * I + tid] = lam;
  for (int e = tid; e < nx; e += nt) dx0[(size_t)r * I + nt + e] = xl[e];
}

// K3b-m phase C1 (dense J): dy1_h = sum_o A2[o][h] gk_o of every record,
// a thread a (record, h), into the record.
__global__ void __launch_bounds__(KM_C_THREADS)
k3m_dy1_kernel(float* recs, const float* jac, long long n_rec, ChainDims d,
               KmBwdPlan bp) {
  const long long e = (long long)blockIdx.x * KM_C_THREADS + threadIdx.x;
  if (e >= n_rec * d.H) return;
  const long long rc = e / d.H;
  const int h = (int)(e - rc * d.H);
  const RecLayout L = kc_rec_layout(d.I, d.H, d.O, d.G);
  const float* a2t = jac + rc * bp.jw + bp.a2_off + (size_t)h * d.O;
  float* rec = recs + rc * bp.width;
  float s = 0.0f;
  for (int o = 0; o < d.O; ++o) s = fmaf(a2t[o], rec[L.gk + o], s);
  rec[L.dy1 + h] = s;
}

// The second launch of K2b-m: the parameter cotangents from the n_rec
// records, a thread a parameter.
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

// Opt a medium-flavor kernel in to its shared memory (kb_smem_floats);
// refuse a chain past the caps (the wrapper checks them first).
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

// Opt a K3-m kernel in to `smem` bytes of dynamic shared memory; refuse a
// chain past the medium flavor's caps (the wrapper checks them first).
template <typename Kernel>
cudaError_t km_prepare(Kernel kernel, const ChainDims& d, int stages,
                       size_t smem) {
  if (d.I < 1 || d.I > KB_MAX_I || d.O != d.I || d.H < 1 || d.H > KB_MAX_H
      || d.G < 2 || d.G > KC_MAX_G || stages < 1 || stages > KC_MAX_STAGES
      || smem > KB_MAX_SMEM)
    return cudaErrorInvalidValue;
  return kc_smem_opt_in(kernel, smem);
}

}  // namespace

// K2b's parameter sums for K1b's launches (kan_chain_apply.cu): the records'
// sums in record order by rk_param_sums_kernel, on st.
cudaError_t kc_launch_param_sums(const float* scratch, int n_rec,
                                 const ChainDims& d, float* dc1, float* dw1,
                                 float* dc2, float* dw2, cudaStream_t st) {
  return rk_launch_param_sums(scratch, n_rec, d, dc1, dw1, dc2, dw2, st);
}

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

// K2b over K rows, `warps` rows a block (the wrapper's step_bwd_plan),
// then the parameter sums over the K * n_slots records in scratch.
int kc_rk_step_bwd(const float* x, const float* gy, const float* c1,
                   const float* w1, const float* c2, const float* w2,
                   float* dx, float* dc1, float* dw1, float* dc2, float* dw2,
                   float* scratch, int K, int n_slots, int warps,
                   const ChainDims* d, const StepTab* T, void* stream) {
  if (warps < 1 || warps > KW_MAX_WARPS || K < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      kw_smem_floats(*d, warps, warps, 1, n_slots) * sizeof(float);
  cudaError_t err = kc_smem_opt_in(rk_step_adjoint_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  rk_step_adjoint_kernel<<<(K + warps - 1) / warps, warps * KW_LANES, smem,
                           st>>>(x, gy, c1, w1, c2, w2, dx, scratch, K,
                                 n_slots, *d, *T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)rk_launch_param_sums(scratch, K * n_slots, *d, dc1, dw1, dc2,
                                   dw2, st);
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

// The medium flavor's work split for a chain (the wrapper's `block_plan`
// computes the same): out[0..11] = f1's C, R, Tc, Rg, f2's, v1's S, per,
// v2's.
void kb_plan(const ChainDims* d, int* out) {
  const KbPlan p = kb_plan_of(*d);
  const KbSplit f[2] = {p.f1, p.f2};
  const KbVjp v[2] = {p.v1, p.v2};
  for (int i = 0; i < 2; ++i) {
    out[4 * i] = f[i].C;
    out[4 * i + 1] = f[i].R;
    out[4 * i + 2] = f[i].Tc;
    out[4 * i + 3] = f[i].Rg;
    out[8 + 2 * i] = v[i].S;
    out[9 + 2 * i] = v[i].per;
  }
}

int kb_rk_step_fwd(const float* x, const float* c1, const float* w1,
                   const float* c2, const float* w2, float* y, int K,
                   const ChainDims* d, const StepTab* T, void* stream) {
  const KbPlan plan = kb_plan_for(*d, T->stages);
  const auto kernel =
      plan.compact ? kb_step_fwd_kernel<true> : kb_step_fwd_kernel<false>;
  size_t smem;
  cudaError_t err = kb_prepare(kernel, *d, T->stages, false, &smem);
  if (err != cudaSuccess) return (int)err;
  if (K < 1) return (int)cudaErrorInvalidValue;
  kernel<<<K, KB_THREADS, smem, (cudaStream_t)stream>>>(x, c1, w1, c2, w2, y,
                                                        *d, *T, plan);
  return (int)cudaGetLastError();
}

// scratch: K * n_slots records.
int kb_rk_step_bwd(const float* x, const float* gy, const float* c1,
                   const float* w1, const float* c2, const float* w2,
                   float* dx, float* dc1, float* dw1, float* dc2, float* dw2,
                   float* scratch, int K, int n_slots, const ChainDims* d,
                   const StepTab* T, void* stream) {
  if (K < 1) return (int)cudaErrorInvalidValue;
  const KbPlan plan = kb_plan_for(*d, T->stages);
  const auto kernel =
      plan.compact ? kb_step_bwd_kernel<true> : kb_step_bwd_kernel<false>;
  size_t smem;
  cudaError_t err = kb_prepare(kernel, *d, T->stages, true, &smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  kernel<<<K, KB_THREADS, smem, st>>>(x, gy, c1, w1, c2, w2, dx, scratch,
                                      n_slots, *d, *T, plan);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)kb_launch_param_sums(scratch, K * n_slots, *d, dc1, dw1, dc2,
                                   dw2, st);
}

// K3f-m's plan (the wrapper's `multistep_fwd_mid_plan` computes the same):
// out[0..4] = layer 1's lg, groups, rounds, mq, Tp, out[5..9] layer 2's,
// out[10] the dynamic shared memory in bytes.
void k3m_fwd_plan(const ChainDims* d, int stages, int* out) {
  const KmPlan p = km_plan_of(*d);
  const KmSplit sp[2] = {p.l1, p.l2};
  for (int i = 0; i < 2; ++i) {
    out[5 * i] = sp[i].lg;
    out[5 * i + 1] = sp[i].groups;
    out[5 * i + 2] = sp[i].rounds;
    out[5 * i + 3] = sp[i].mq;
    out[5 * i + 4] = sp[i].Tp;
  }
  out[10] = (int)(km_fwd_floats(*d, p, stages) * sizeof(float));
}

// K3b-m's plan (the wrapper's `multistep_bwd_mid_plan` computes the same):
// out[0..13] = dense, width, jw, span, a2_off, rec_floats, scratch_floats,
// rebuild_smem, warp_rows, sweep_blocks, sweep_threads, sweep_smem, staged,
// dy1_blocks.
void k3m_bwd_plan(const ChainDims* d, int K, int stages, int n_steps,
                  int slots, long long* out) {
  const KmBwdPlan b = km_bwd_plan_of(*d, K, stages, n_steps, slots);
  const long long v[14] = {b.dense,      b.width,          b.jw,
                           b.span,       b.a2_off,         b.rec_floats,
                           b.scratch_floats, b.rebuild_smem, b.warp_rows,
                           b.sweep_blocks, b.sweep_threads, b.sweep_smem,
                           b.staged,     b.dy1_blocks};
  for (int i = 0; i < 14; ++i) out[i] = v[i];
}

int kb_rk_multistep_fwd(const float* x0, const float* c1, const float* w1,
                        const float* c2, const float* w2, float* ys, int K,
                        int n_steps, const ChainDims* d, const StepTab* T,
                        void* stream) {
  const KmPlan plan = km_plan_of(*d);
  const size_t smem = km_fwd_floats(*d, plan, T->stages) * sizeof(float);
  cudaError_t err = km_prepare(k3m_fwd_kernel, *d, T->stages, smem);
  if (err != cudaSuccess) return (int)err;
  if (K < 1 || n_steps < 1) return (int)cudaErrorInvalidValue;
  k3m_fwd_kernel<<<K, KM_THREADS, smem, (cudaStream_t)stream>>>(
      x0, c1, w1, c2, w2, ys, K, n_steps, *d, *T, plan);
  return (int)cudaGetLastError();
}

// K3b-m: phase A (a block a step and row), phase B (a warp or a block a
// row), phase C1 (dense J: dy1 of every record) and the parameter sums;
// scratch: KmBwdPlan's scratch_floats, the records then their Jacobian
// blocks.
int kb_rk_multistep_bwd(const float* x0, const float* ys, const float* gys,
                        const float* c1, const float* w1, const float* c2,
                        const float* w2, float* dx0, float* dc1, float* dw1,
                        float* dc2, float* dw2, float* scratch, int K,
                        int n_steps, int n_slots, const ChainDims* d,
                        const StepTab* T, void* stream) {
  if (K < 1 || n_steps < 1 || n_slots < 1) return (int)cudaErrorInvalidValue;
  const KmPlan plan = km_plan_of(*d);
  const KmBwdPlan bp = km_bwd_plan_of(*d, K, T->stages, n_steps, n_slots);
  cudaError_t err =
      km_prepare(k3m_rebuild_kernel, *d, T->stages, bp.rebuild_smem);
  if (err != cudaSuccess) return (int)err;
  err = bp.warp_rows
            ? km_prepare(k3m_sweep_warp_kernel, *d, T->stages, bp.sweep_smem)
            : km_prepare(k3m_sweep_block_kernel, *d, T->stages,
                         bp.sweep_smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  float* recs = scratch;
  float* jac = scratch + bp.rec_floats;
  k3m_rebuild_kernel<<<n_steps * K, KM_THREADS, bp.rebuild_smem, st>>>(
      x0, ys, c1, w1, c2, w2, recs, jac, K, n_slots, *d, *T, plan, bp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (bp.warp_rows)
    k3m_sweep_warp_kernel<<<bp.sweep_blocks, bp.sweep_threads, bp.sweep_smem,
                            st>>>(gys, dx0, recs, jac, K, n_steps, n_slots,
                                  *d, *T, bp);
  else
    k3m_sweep_block_kernel<<<bp.sweep_blocks, bp.sweep_threads, bp.sweep_smem,
                             st>>>(gys, dx0, recs, jac, K, n_steps, n_slots,
                                   *d, *T, bp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n_rec = (long long)n_steps * K * n_slots;
  if (bp.dy1_blocks) {
    k3m_dy1_kernel<<<bp.dy1_blocks, KM_C_THREADS, 0, st>>>(recs, jac, n_rec,
                                                           *d, bp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)rk_launch_param_sums(recs, (int)n_rec, *d, dc1, dw1, dc2, dw2,
                                   st);
}

}  // extern "C"
