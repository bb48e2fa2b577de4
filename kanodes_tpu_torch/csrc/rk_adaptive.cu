// The whole bounded adaptive solve over the 2-layer KDense chain, and its
// discrete adjoint, for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (kanodes_tpu_torch/ops/_cuda.py builds it with nvcc,
// with -fmad=false: see "Numbers" below).
//
// Replaces the Pallas kernels of kanodes_tpu/ops/rk_adaptive_fused.py:
//   kc_adaptive_fwd <- _adaptive_fwd_kernel  (fused_adaptive_odeint)
//   kc_adaptive_bwd <- _adaptive_bwd_kernel  (_fao_bwd)
//
// What it computes (the JAX kernel's semantics, not its Mosaic layout):
// forward, an FSAL embedded RK pair (tsit5/dopri5/bs3) with ONE step
// controller for the whole batch x0 [K, I]: every iteration runs all
// stages, the Hairer norm over all K*I entries, the I/PI controller and
// the save-point clipping of ode/integrate._adaptive_step (dense=False),
// and records (x_in, k1_in, signed dt, save index or -1) of each accepted
// step; rows the solve never reached get the final state. Backward, the
// accepted steps replayed in reverse: the "direct" adjoint w.r.t. x0 and
// the chain parameters (step sizes are gradient constants, rejected steps
// are gradient-transparent).
//
// What bounds it on this card: the serial chain of controller
// iterations, each s-1 dependent chain evaluations (tsit5: 6) plus a
// block-wide reduction, and within an evaluation the latency of its
// transcendental functions and of its ordered sums. Bytes and flops are
// far below a microsecond at the LV shapes (K = 1, widths 2-10-2, G = 5).
//
// What the design does about it: the whole solve is ONE launch (and the
// adjoint one more), as on the TPU, with no host round trip per
// iteration: the accepted-step count stays on the device and the backward
// reads it there. The forward (K4f) runs a warp a row (rows in turn when
// K exceeds the block's warps, ops/_cuda.adaptive_fwd_plan) and spreads
// each chain evaluation over the warp's lanes (kf_chain_fwd,
// kan_chain_warp.cuh): the basis functions of both layers run in
// parallel lanes, and each sum keeps the one-thread order, so K4f's
// results are the bits of the one-thread kernel it replaced, which took
// ~30k cycles an evaluation (PERF.md, the K4f/K8b trace). Lane h keeps its
// slices of the parameters in registers, the row's stage vectors sit in
// the warp's shared memory, nothing is on the stack. What bounds it now:
// an evaluation is a chain of dependent phases (basis functions, lane h's
// ordered sum, layer 2's basis functions, lane o's ordered sum of H*G + H
// products), ~4k cycles. The controller is block-uniform: each row writes
// its squared scaled errors to shared memory, thread 0 sums them in index
// order and updates the controller scalars in shared memory, and after a
// __syncthreads every thread reads the same accept/save/done decisions,
// so every thread takes the same branches and loop count (the early exit
// is a uniform break). The backward (K4b) needs no block-wide decision:
// every warp of the block rebuilds accepted steps from their records,
// several at a time, with each stage's Jacobian; then a warp a row
// replays the row's steps in reverse (kan_chain_warp.cuh: the steps do not
// depend on each other in the rebuild, and a stage's VJP is then a few
// multiply-adds); it stores its parameter-cotangent operands per (step,
// stage), and the thread owning each parameter sums them in record order
// (bitwise repeatable, no float atomics). One thread a row ran K4b at ~30k
// cycles a chain evaluation (PERF.md, the K3b/K4b trace).
//
// Numbers: accept/reject is a threshold at err == 1, so a one-ulp change
// can change the step sequence. The file is built with -fmad=false, so
// no multiply and add contract into an FMA and every stage sum rounds as
// the plain PyTorch version's does; the stage increments are formed on
// the device as (dts * a_ij) * k_j in the JAX kernel's order, since dt
// changes every iteration. expf/logf/sqrtf are the IEEE-mode library
// functions (no fast-math). K4f's chain (kf_chain_fwd) writes every
// product and sum as __fmul_rn / __fadd_rn, which round the same under
// any flag. K4b's chain multiply-adds are explicit fmaf (the flag leaves
// them alone); it decides nothing.

#include "kan_chain_warp.cuh"

namespace {

// Sum of red[0..n) in index order, by thread 0, returned to every thread.
// Every thread of the block must call it.
__device__ float kc_block_sum(const float* red, int n) {
  __shared__ float total;
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.0f;
    for (int i = 0; i < n; ++i) acc += red[i];
    total = acc;
  }
  __syncthreads();
  return total;
}

// Floats of K4f's dynamic shared memory: the parameters, the K*I squared
// scaled errors, each row's state (x, k1, the step's result y and its
// last stage) and each warp's workspace (the stage input, the S stage
// values and kf_chain_fwd's).
__host__ __device__ inline size_t kf_smem_floats(const ChainDims& d, int K,
                                                 int stages, int warps) {
  const int I = d.I;
  return kc_param_floats(d) + (size_t)K * I + (size_t)K * 4 * I
         + (size_t)warps * (I + stages * I + kf_chain_ws_floats(d));
}

// K4f: a warp a row (rows r = warp, warp + warps, ... in turn), each chain
// evaluation spread over the warp's lanes by kf_chain_fwd; state component
// q in lane q < I. The controller stays block-uniform: thread 0 sums the
// squared scaled errors in index order and decides, every thread reads the
// decisions after a __syncthreads.
__global__ void __launch_bounds__(KW_LANES * KF_MAX_WARPS)
adaptive_fwd_kernel(const float* x0, const float* ts, int T_save,
                    const float* c1, const float* w1, const float* c2,
                    const float* w2, float* ys, float* rx, float* rk1,
                    float* rdt, int* rsx, int* stats, int K, int max_steps,
                    ChainDims d, AdaptTab tab, AdaptCtrl c) {
  extern __shared__ float smem[];
  __shared__ WarpConsts wc;
  __shared__ float s_e[KC_MAX_STAGES];
  __shared__ unsigned char s_l2h[KC_MAX_H * KC_MAX_G];
  __shared__ float s_t, s_dt, s_err_prev;
  __shared__ int s_sidx, s_done, s_nacc, s_nrej, s_nit;
  __shared__ int s_accept, s_saved, s_slot, s_row;
  const int all[KC_MAX_STAGES] = {1, 1, 1, 1, 1, 1, 1};
  kw_fill_consts(wc, d, tab.stages, tab.a, tab.b, all);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < KC_MAX_STAGES; ++i)
      s_e[i] = i < tab.stages ? tab.e[i] : 0.0f;
  }
  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, smem);
  const int I = d.I, n = K * I, S = tab.stages, IG = I * d.G;
  for (int l = threadIdx.x; l < IG + I; l += blockDim.x) {
    wc.term_x[l] = l < IG ? l / d.G : l - IG;
    wc.term_c[l] = l < IG ? wc.grid[l % d.G] : 0.0f;
  }
  kf_fill_l2(s_l2h, d);
  const int warp = threadIdx.x / KW_LANES, lane = threadIdx.x % KW_LANES;
  const int warps = blockDim.x / KW_LANES;
  float* red = smem + kc_param_floats(d);        // K*I squared scaled errors
  float* rows = red + n;                          // [K][x | k1 | y | klast]
  float* ws = rows + (size_t)K * 4 * I
              + (size_t)warp * (I + S * I + kf_chain_ws_floats(d));
  float* xs = ws;                                 // the stage input [I]
  float* ks = xs + I;                             // stage values [S][I]
  float* cw = ks + S * I;                         // kf_chain_fwd's
  KfRegs rg;
  kf_load_regs(rg, p, d, lane);
  __syncthreads();
  const bool mine = lane < I;                     // lane q: component q
  const float t0 = ts[0];
  const float tdir = ts[T_save - 1] >= t0 ? 1.0f : -1.0f;
  for (int r = warp; r < K; r += warps) {
    float* row = rows + (size_t)r * 4 * I;
    if (mine) {
      const float v = x0[(size_t)r * I + lane];
      row[lane] = v;
      ys[(size_t)r * I + lane] = v;
      xs[lane] = v;
    }
    __syncwarp();
    kf_chain_fwd(xs, row + I, d, wc, s_l2h, p, rg, cw, lane);
    __syncwarp();
  }

  float dt = c.dt0;
  if (!c.has_dt0) {
    // integrate.initial_dt, single-leaf form (_initial_dt_inkernel)
    for (int r = warp; r < K; r += warps)
      if (mine) {
        const float x = rows[(size_t)r * 4 * I + lane];
        const float v = x / (c.atol + c.rtol * fabsf(x));
        red[r * I + lane] = v * v;
      }
    const float d0 = sqrtf(kc_block_sum(red, n) / (float)n);
    for (int r = warp; r < K; r += warps)
      if (mine) {
        const float* row = rows + (size_t)r * 4 * I;
        const float v = row[I + lane] / (c.atol + c.rtol * fabsf(row[lane]));
        red[r * I + lane] = v * v;
      }
    const float d1 = sqrtf(kc_block_sum(red, n) / (float)n);
    const float h0 = (d0 < 1e-5f || d1 < 1e-5f) ? 1e-6f : 0.01f * d0 / d1;
    for (int r = warp; r < K; r += warps) {
      const float* row = rows + (size_t)r * 4 * I;
      if (mine) xs[lane] = row[lane] + (tdir * h0) * row[I + lane];
      __syncwarp();
      kf_chain_fwd(xs, ks, d, wc, s_l2h, p, rg, cw, lane);
      __syncwarp();
      if (mine) {
        const float v = (ks[lane] - row[I + lane])
                        / (c.atol + c.rtol * fabsf(row[lane]));
        red[r * I + lane] = v * v;
      }
    }
    const float d2 = sqrtf(kc_block_sum(red, n) / (float)n) / h0;
    const float dmax = fmaxf(d1, d2);
    const float h1 = dmax <= 1e-15f ? fmaxf(1e-6f, h0 * 1e-3f)
                                    : expf(c.idt_exp * logf(0.01f / dmax));
    dt = fminf(100.0f * h0, h1);
  }
  if (threadIdx.x == 0) {
    s_t = t0;
    s_dt = dt;
    s_err_prev = 1.0f;
    s_sidx = 1;
    s_done = T_save <= 1;
    s_nacc = s_nrej = s_nit = 0;
  }
  __syncthreads();

  for (int it = 0; it < max_steps; ++it) {
    if (s_done) break;                      // block-uniform early exit
    const float t = s_t, dtv = s_dt;
    const int sidx = s_sidx;
    const float t_save = ts[sidx];
    const float remaining = (t_save - t) * tdir;
    const bool hit = dtv >= remaining;
    const float dt_used = hit ? remaining : dtv;
    const float dts = tdir * dt_used;
    for (int r = warp; r < K; r += warps) {
      float* row = rows + (size_t)r * 4 * I;
      const float xq = mine ? row[lane] : 0.0f;
      if (mine) ks[lane] = row[I + lane];
      for (int i = 1; i < S; ++i) {
        if (mine) {
          // the loads first (wc.a[i][j] is zero for j >= i; ks[j] past the
          // stages lies in the warp's workspace and is never used)
          float av[KC_MAX_STAGES - 1], kv[KC_MAX_STAGES - 1];
#pragma unroll
          for (int j = 0; j < KC_MAX_STAGES - 1; ++j) {
            av[j] = wc.a[i][j];
            kv[j] = ks[j * I + lane];
          }
          float v = xq;
#pragma unroll
          for (int j = 0; j < KC_MAX_STAGES - 1; ++j)
            if (av[j] != 0.0f) v = v + (dts * av[j]) * kv[j];
          xs[lane] = v;
        }
        __syncwarp();
        kf_chain_fwd(xs, ks + i * I, d, wc, s_l2h, p, rg, cw, lane);
        __syncwarp();
      }
      if (mine) {
        float acc = xq, err = 0.0f;
#pragma unroll
        for (int i = 0; i < KC_MAX_STAGES; ++i) {
          if (i >= S) break;
          const float ki = ks[i * I + lane];
          if (wc.b[i] != 0.0f) acc = acc + (dts * wc.b[i]) * ki;
          if (s_e[i] != 0.0f) err = err + (dts * s_e[i]) * ki;
        }
        row[2 * I + lane] = acc;
        row[3 * I + lane] = ks[(S - 1) * I + lane];
        const float scale = c.atol + c.rtol * fmaxf(fabsf(xq), fabsf(acc));
        const float v = err / scale;
        red[r * I + lane] = v * v;
      }
      __syncwarp();
    }
    const float sq = kc_block_sum(red, n);
    if (threadIdx.x == 0) {
      const float err_nrm = sqrtf(sq / (float)n);
      const bool accept = (err_nrm <= 1.0f) || (dt_used <= c.dt_min);
      // StepController.factor with pow as exp/log (_ctrl_factor)
      float fac = c.safety * expf(c.err_exp * logf(fmaxf(err_nrm, 1e-12f)));
      if (c.use_prev)
        fac = fac * expf(c.prev_exp * logf(fmaxf(s_err_prev, 1e-12f)));
      fac = fminf(fmaxf(fac, c.min_factor), c.max_factor);
      const bool saved = accept && hit;
      s_accept = accept;
      s_saved = saved;
      s_slot = s_nacc;
      s_row = sidx;
      if (accept) {
        rdt[s_nacc] = dts;
        rsx[s_nacc] = saved ? sidx : -1;
        s_t = hit ? t_save : t + dts;
        s_err_prev = fmaxf(err_nrm, 1e-12f);
      }
      s_dt = fmaxf(dt_used * fac, c.dt_min);
      s_sidx = sidx + (saved ? 1 : 0);
      s_done = s_sidx >= T_save;
      s_nacc += accept ? 1 : 0;
      s_nrej += accept ? 0 : 1;
      s_nit += 1;
    }
    __syncthreads();
    if (mine) {
      for (int r = warp; r < K; r += warps) {
        float* row = rows + (size_t)r * 4 * I;
        const float y = row[2 * I + lane];
        if (s_accept) {
          const size_t off = ((size_t)s_slot * K + r) * I + lane;
          rx[off] = row[lane];
          rk1[off] = row[I + lane];
          row[lane] = y;
          row[I + lane] = row[3 * I + lane];   // FSAL: the last stage
        }
        if (s_saved) ys[((size_t)s_row * K + r) * I + lane] = y;
      }
    }
  }

  // unreached save rows get the final state (integrate._fill_unreached)
  const int sidx_final = s_sidx;
  if (mine)
    for (int r = warp; r < K; r += warps)
      for (int i = sidx_final; i < T_save; ++i)
        ys[((size_t)i * K + r) * I + lane] = rows[(size_t)r * 4 * I + lane];
  if (threadIdx.x == 0) {
    stats[0] = s_nacc;
    stats[1] = s_nrej;
    stats[2] = s_nit;
    stats[3] = sidx_final;
  }
}

// Phase A of one accepted step for one row: the stages i = 1..S-1 from
// the step input x and the FSAL value k1 (global) with signed step dts,
// as kc_adaptive_stages forms them; evaluation i's factors at fac + (i -
// 1) * F.width and its record at rec + (i - 1) * rec_stride.
__device__ inline void kw_adaptive_stages(const float* x, const float* k1,
                                          float dts, int S,
                                          const ChainDims& d,
                                          const WarpConsts& c,
                                          const ChainParams& p,
                                          const RecLayout& L, WarpRow& w,
                                          int lane, float* fac, float* rec,
                                          size_t rec_stride) {
  const int fw = kw_factor_layout(d).width;
  const bool mine = lane < d.I;
  const float xq = mine ? x[lane] : 0.0f;
  if (mine) w.ks[0][lane] = k1[lane];
  for (int i = 1; i < S; ++i) {
    if (mine) {
      float v = xq;
#pragma unroll
      for (int j = 0; j < KC_MAX_STAGES - 1; ++j)
        if (j < i && c.a[i][j] != 0.0f)
          v = v + (dts * c.a[i][j]) * w.ks[j][lane];
      w.xs[i][lane] = v;
    }
    __syncwarp();
    kw_chain_fwd(w.xs[i], w.ks[i], fac + (i - 1) * fw,
                 rec + (i - 1) * rec_stride, d, c, p, L, w, lane);
    __syncwarp();
  }
}

// K4b: the rows in groups of up to `warps` (one warp a row), the accepted
// steps of a group in chunks of `chunk` from the last; per chunk phase A
// over every (row, step) by every warp, then phase B by the row warps
// (kan_chain_warp.cuh); then the block's parameter sums.
__global__ void __launch_bounds__(KW_LANES * KW_MAX_WARPS)
adaptive_bwd_kernel(const float* x0, const float* c1, const float* w1,
                    const float* c2, const float* w2, const float* rx,
                    const float* rk1, const float* rdt, const int* rsx,
                    const int* stats, const float* gys, int T_save,
                    float* dx0, float* dc1, float* dw1, float* dc2,
                    float* dw2, float* scratch, int K, int chunk,
                    ChainDims d, AdaptTab tab) {
  extern __shared__ float smem[];
  __shared__ WarpConsts c;
  const int warp = threadIdx.x / KW_LANES, lane = threadIdx.x % KW_LANES;
  const int warps = blockDim.x / KW_LANES;
  WarpRow* rows = reinterpret_cast<WarpRow*>(smem + kc_param_floats(d));
  WarpRow& w = rows[warp];
  float* fac_all = reinterpret_cast<float*>(rows + warps);
  const int all[KC_MAX_STAGES] = {1, 1, 1, 1, 1, 1, 1};
  kw_fill_consts(c, d, tab.stages, tab.a, tab.b, all);
  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, smem);
  kw_fill_terms(c, d, w, lane);
  __syncthreads();
  const RecLayout L = kc_rec_layout(d.I, d.H, d.O, d.G);
  const int I = d.I, S = tab.stages;
  const int fw = kw_factor_layout(d).width;
  const size_t fstep = (size_t)(S - 1) * fw;
  const size_t rstride = (size_t)K * L.width;   // stage to stage
  const int n_acc = stats[0], sidx_final = stats[3];
  const bool mine = lane < I;               // lane q: component q
  for (int r0 = 0; r0 < K; r0 += warps) {
    const int R = K - r0 < warps ? K - r0 : warps;
    const int r = r0 + warp;                 // the row of a row warp
    // cotangent of the final state from the unreached fill
    float xbar = 0.0f, k1bar = 0.0f;
    if (warp < R && mine)
      for (int i = sidx_final > 1 ? sidx_final : 1; i < T_save; ++i)
        xbar = xbar + gys[((size_t)i * K + r) * I + lane];
    for (int hi = n_acc - 1; hi >= 0; hi -= chunk) {
      const int lo = hi - chunk + 1 > 0 ? hi - chunk + 1 : 0;
      // A: rebuild every (row, step) of the chunk
      for (int it = warp; it < R * (hi - lo + 1); it += warps) {
        const int ri = it % R, s = lo + it / R;
        const size_t row = ((size_t)s * K + r0 + ri) * I;
        kw_adaptive_stages(
            rx + row, rk1 + row, rdt[s], S, d, c, p, L, w, lane,
            fac_all + ((size_t)ri * chunk + (s - lo)) * fstep,
            scratch + ((size_t)s * (S - 1) * K + r0 + ri) * L.width,
            rstride);
      }
      __syncthreads();
      // B: the accepted steps replayed in reverse, a warp a row
      if (warp < R) {
        for (int s = hi; s >= lo; --s) {
          const float dts = rdt[s];
          const int sx = rsx[s];
          if (mine && sx >= 0)
            xbar = xbar + gys[((size_t)sx * K + r) * I + lane];
          const float* fac =
              fac_all + ((size_t)warp * chunk + (s - lo)) * fstep;
          // seeds; have: the stages with a cotangent (warp-uniform bits)
          unsigned have = 0;
          for (int i = 0; i < S; ++i) {
            if (c.b[i] == 0.0f) continue;
            have |= 1u << i;
            if (mine) w.kb[i][lane] = (dts * c.b[i]) * xbar;
          }
          // FSAL carry-out: the next step's k1 was this step's last stage
          if (mine)
            w.kb[S - 1][lane] = (have >> (S - 1)) & 1u
                                    ? w.kb[S - 1][lane] + k1bar : k1bar;
          have |= 1u << (S - 1);
          float xnew = xbar;
          __syncwarp();
          for (int i = S - 1; i >= 1; --i) {
            float* rec = scratch + (((size_t)s * (S - 1) + (i - 1)) * K + r) *
                                       L.width;
            if (!((have >> i) & 1u)) {
              for (int q = lane; q < L.width; q += KW_LANES) rec[q] = 0.0f;
              continue;
            }
            const float dxi = kw_chain_vjp(w.kb[i], fac + (i - 1) * fw, rec,
                                           d, L, lane);
            if (mine) xnew = xnew + dxi;
#pragma unroll
            for (int j = 0; j < KC_MAX_STAGES - 1; ++j) {
              if (j >= i || c.a[i][j] == 0.0f) continue;
              if (mine) {
                const float contrib = (dts * c.a[i][j]) * dxi;
                w.kb[j][lane] = (have >> j) & 1u ? w.kb[j][lane] + contrib
                                                 : contrib;
              }
              have |= 1u << j;
            }
            __syncwarp();
          }
          // stage 1 is the carried FSAL value: its cotangent goes back
          if (mine) k1bar = have & 1u ? w.kb[0][lane] : 0.0f;
          xbar = xnew;
        }
      }
      __syncthreads();
    }
    // the very first k1 was f(x0): one chain VJP at the inputs, its
    // factors in the row's first slot of the (now free) buffer
    if (warp < R) {
      float* fac = fac_all + (size_t)warp * chunk * fstep;
      float* rec = scratch + ((size_t)n_acc * (S - 1) * K + r) * L.width;
      if (mine) {
        w.xs[0][lane] = x0[(size_t)r * I + lane];
        w.kb[0][lane] = k1bar;
      }
      __syncwarp();
      kw_chain_fwd(w.xs[0], w.ks[0], fac, rec, d, c, p, L, w, lane);
      __syncwarp();
      const float dxi = kw_chain_vjp(w.kb[0], fac, rec, d, L, lane);
      if (mine)
        dx0[(size_t)r * I + lane] =
            (xbar + dxi) + gys[(size_t)r * I + lane];
    }
    __syncthreads();
  }
  kc_reduce_param_grads(scratch, (n_acc * (S - 1) + 1) * K, d, L, dc1, dw1,
                        dc2, dw2);
}

}  // namespace

extern "C" {

// Each launcher takes device pointers, the host-side structs and the
// CUDA stream, and returns cudaGetLastError() (0 = ok). Records: rx, rk1
// [max_steps, K, I], rdt [max_steps] (signed dt), rsx [max_steps] (save
// index or -1), stats [4] = n_accept, n_reject, n_iter, final save index.

int kc_adaptive_fwd(const float* x0, const float* ts, int T_save,
                    const float* c1, const float* w1, const float* c2,
                    const float* w2, float* ys, float* rx, float* rk1,
                    float* rdt, int* rsx, int* stats, int K, int max_steps,
                    int warps, const ChainDims* d, const AdaptTab* tab,
                    const AdaptCtrl* ctrl, void* stream) {
  if (warps < 1 || warps > KF_MAX_WARPS || warps > K)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      kf_smem_floats(*d, K, tab->stages, warps) * sizeof(float);
  cudaError_t err = kc_smem_opt_in(adaptive_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  adaptive_fwd_kernel<<<1, warps * KW_LANES, smem, (cudaStream_t)stream>>>(
      x0, ts, T_save, c1, w1, c2, w2, ys, rx, rk1, rdt, rsx, stats, K,
      max_steps, *d, *tab, *ctrl);
  return (int)cudaGetLastError();
}

// K4f's dynamic shared memory for `warps` warps (the wrapper's
// adaptive_fwd_plan computes the same).
int kf_smem_bytes(const ChainDims* d, int K, int stages, int warps) {
  return (int)(kf_smem_floats(*d, K, stages, warps) * sizeof(float));
}

int kc_adaptive_bwd(const float* x0, const float* c1, const float* w1,
                    const float* c2, const float* w2, const float* rx,
                    const float* rk1, const float* rdt, const int* rsx,
                    const int* stats, const float* gys, int T_save,
                    float* dx0, float* dc1, float* dw1, float* dc2,
                    float* dw2, float* scratch, int K, int warps, int chunk,
                    const ChainDims* d, const AdaptTab* tab, void* stream) {
  if (warps < 1 || warps > KW_MAX_WARPS || chunk < 1 || tab->stages < 2)
    return (int)cudaErrorInvalidValue;
  const size_t smem = kw_smem_floats(*d, warps, K < warps ? K : warps,
                                     chunk, tab->stages - 1) * sizeof(float);
  cudaError_t err = kc_smem_opt_in(adaptive_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  adaptive_bwd_kernel<<<1, warps * KW_LANES, smem, (cudaStream_t)stream>>>(
      x0, c1, w1, c2, w2, rx, rk1, rdt, rsx, stats, gys, T_save, dx0, dc1,
      dw1, dc2, dw2, scratch, K, chunk, *d, *tab);
  return (int)cudaGetLastError();
}

}  // extern "C"
