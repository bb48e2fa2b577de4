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
// block-wide reduction. Bytes and flops are far below a microsecond at
// the LV shapes (K = 1, widths 2-10-2, G = 5).
//
// What the design does about it: the whole solve is ONE launch (and the
// adjoint one more), as on the TPU, with no host round trip per
// iteration: the accepted-step count stays on the device and the backward
// reads it there. One block; one thread per row keeps its state, FSAL
// carry and stages in registers; parameters sit in shared memory. The
// controller is block-uniform: each row writes its squared scaled errors
// to shared memory, thread 0 sums them in index order and updates the
// controller scalars in shared memory, and after a __syncthreads every
// thread reads the same accept/save/done decisions, so every thread takes
// the same branches and loop count (the early exit is a uniform break).
// The backward needs no block-wide decision: each row replays its own
// records, stores its parameter-cotangent operands per (step, stage), and
// the thread owning each parameter sums them in record order (bitwise
// repeatable, no float atomics).
//
// Numbers: accept/reject is a threshold at err == 1, so a one-ulp change
// can change the step sequence. The file is built with -fmad=false, so
// no multiply and add contract into an FMA and every stage sum rounds as
// the plain PyTorch version's does; the stage increments are formed on
// the device as (dts * a_ij) * k_j in the JAX kernel's order, since dt
// changes every iteration. expf/logf/sqrtf are the IEEE-mode library
// functions (no fast-math).

#include "kan_chain.cuh"

// A FSAL embedded pair with raw f32 coefficients (dt is applied on the
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

namespace {

constexpr int kBwdThreads = 256;

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

// The stages of one step from the step input x with signed step dts and
// the FSAL value k1: ks[0] = k1, xs[i] / y1s[i] the inputs and hidden
// activations of the chain evaluation of stage i >= 1.
__device__ inline void kc_adaptive_stages(const float* x, const float* k1,
                                          float dts, const AdaptTab& T,
                                          const ChainDims& d,
                                          const ChainParams& p,
                                          float xs[][KC_MAX_I],
                                          float y1s[][KC_MAX_H],
                                          float ks[][KC_MAX_I]) {
  for (int q = 0; q < d.I; ++q) ks[0][q] = k1[q];
  for (int i = 1; i < T.stages; ++i) {
    for (int q = 0; q < d.I; ++q) xs[i][q] = x[q];
    for (int j = 0; j < i; ++j) {
      if (T.a[i][j] == 0.0f) continue;
      const float c = dts * T.a[i][j];
      for (int q = 0; q < d.I; ++q) xs[i][q] = xs[i][q] + c * ks[j][q];
    }
    kc_chain_fwd(xs[i], d, p, y1s[i], ks[i]);
  }
}

__global__ void __launch_bounds__(KC_MAX_ADAPT_ROWS)
adaptive_fwd_kernel(const float* x0, const float* ts, int T_save,
                    const float* c1, const float* w1, const float* c2,
                    const float* w2, float* ys, float* rx, float* rk1,
                    float* rdt, int* rsx, int* stats, int K, int max_steps,
                    ChainDims d, AdaptTab tab, AdaptCtrl c) {
  extern __shared__ float smem[];
  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, smem);
  float* red = smem + kc_param_floats(d);   // K*I squared scaled entries
  __shared__ float s_t, s_dt, s_err_prev;
  __shared__ int s_sidx, s_done, s_nacc, s_nrej, s_nit;
  __shared__ int s_accept, s_saved, s_slot, s_row;

  const int I = d.I, n = K * I, S = tab.stages;
  const int r = threadIdx.x;
  const bool row = r < K;
  float x[KC_MAX_I], k1[KC_MAX_I], y1[KC_MAX_I];
  float xs[KC_MAX_STAGES][KC_MAX_I], ks[KC_MAX_STAGES][KC_MAX_I];
  float y1s[KC_MAX_STAGES][KC_MAX_H];
  const float t0 = ts[0];
  const float tdir = ts[T_save - 1] >= t0 ? 1.0f : -1.0f;
  if (row) {
    for (int q = 0; q < I; ++q) {
      x[q] = x0[(size_t)r * I + q];
      ys[(size_t)r * I + q] = x[q];
    }
    kc_chain_fwd(x, d, p, y1s[0], k1);
  }

  float dt = c.dt0;
  if (!c.has_dt0) {
    // integrate.initial_dt, single-leaf form (_initial_dt_inkernel)
    float sc[KC_MAX_I];
    if (row)
      for (int q = 0; q < I; ++q) {
        sc[q] = c.atol + c.rtol * fabsf(x[q]);
        const float v = x[q] / sc[q];
        red[r * I + q] = v * v;
      }
    const float d0 = sqrtf(kc_block_sum(red, n) / (float)n);
    if (row)
      for (int q = 0; q < I; ++q) {
        const float v = k1[q] / sc[q];
        red[r * I + q] = v * v;
      }
    const float d1 = sqrtf(kc_block_sum(red, n) / (float)n);
    const float h0 = (d0 < 1e-5f || d1 < 1e-5f) ? 1e-6f : 0.01f * d0 / d1;
    if (row) {
      float xh[KC_MAX_I], f1[KC_MAX_I];
      for (int q = 0; q < I; ++q) xh[q] = x[q] + (tdir * h0) * k1[q];
      kc_chain_fwd(xh, d, p, y1s[0], f1);
      for (int q = 0; q < I; ++q) {
        const float v = (f1[q] - k1[q]) / sc[q];
        red[r * I + q] = v * v;
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
    if (row) {
      kc_adaptive_stages(x, k1, dts, tab, d, p, xs, y1s, ks);
      for (int q = 0; q < I; ++q) {
        float acc = x[q], err = 0.0f;
        for (int i = 0; i < S; ++i) {
          if (tab.b[i] != 0.0f) acc = acc + (dts * tab.b[i]) * ks[i][q];
          if (tab.e[i] != 0.0f) err = err + (dts * tab.e[i]) * ks[i][q];
        }
        y1[q] = acc;
        const float scale = c.atol + c.rtol * fmaxf(fabsf(x[q]), fabsf(acc));
        const float v = err / scale;
        red[r * I + q] = v * v;
      }
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
    if (row) {
      if (s_accept) {
        const size_t off = ((size_t)s_slot * K + r) * I;
        for (int q = 0; q < I; ++q) {
          rx[off + q] = x[q];
          rk1[off + q] = k1[q];
          x[q] = y1[q];
          k1[q] = ks[S - 1][q];             // FSAL: the last stage
        }
      }
      if (s_saved)
        for (int q = 0; q < I; ++q)
          ys[((size_t)s_row * K + r) * I + q] = y1[q];
    }
  }

  // unreached save rows get the final state (integrate._fill_unreached)
  const int sidx_final = s_sidx;
  if (row)
    for (int i = sidx_final; i < T_save; ++i)
      for (int q = 0; q < I; ++q) ys[((size_t)i * K + r) * I + q] = x[q];
  if (threadIdx.x == 0) {
    stats[0] = s_nacc;
    stats[1] = s_nrej;
    stats[2] = s_nit;
    stats[3] = sidx_final;
  }
}

__global__ void __launch_bounds__(kBwdThreads)
adaptive_bwd_kernel(const float* x0, const float* c1, const float* w1,
                    const float* c2, const float* w2, const float* rx,
                    const float* rk1, const float* rdt, const int* rsx,
                    const int* stats, const float* gys, int T_save,
                    float* dx0, float* dc1, float* dw1, float* dc2,
                    float* dw2, float* scratch, int K, ChainDims d,
                    AdaptTab tab) {
  extern __shared__ float smem[];
  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, smem);
  const RecLayout L = kc_rec_layout(d.I, d.H, d.O, d.G);
  const int I = d.I, S = tab.stages;
  const int n_acc = stats[0], sidx_final = stats[3];
  for (int r = threadIdx.x; r < K; r += blockDim.x) {
    float xbar[KC_MAX_I], k1bar[KC_MAX_I], xnew[KC_MAX_I], dxi[KC_MAX_I];
    float xs[KC_MAX_STAGES][KC_MAX_I], ks[KC_MAX_STAGES][KC_MAX_I];
    float y1s[KC_MAX_STAGES][KC_MAX_H], kbar[KC_MAX_STAGES][KC_MAX_I];
    bool have[KC_MAX_STAGES];
    // cotangent of the final state from the unreached fill
    for (int q = 0; q < I; ++q) {
      xbar[q] = 0.0f;
      k1bar[q] = 0.0f;
    }
    for (int i = sidx_final > 1 ? sidx_final : 1; i < T_save; ++i)
      for (int q = 0; q < I; ++q)
        xbar[q] = xbar[q] + gys[((size_t)i * K + r) * I + q];
    for (int s = n_acc - 1; s >= 0; --s) {
      const float* x_in = rx + ((size_t)s * K + r) * I;
      const float dts = rdt[s];
      const int sx = rsx[s];
      if (sx >= 0)
        for (int q = 0; q < I; ++q)
          xbar[q] = xbar[q] + gys[((size_t)sx * K + r) * I + q];
      kc_adaptive_stages(x_in, rk1 + ((size_t)s * K + r) * I, dts, tab, d, p,
                         xs, y1s, ks);
      for (int i = 0; i < S; ++i) {
        have[i] = tab.b[i] != 0.0f;
        if (have[i])
          for (int q = 0; q < I; ++q) kbar[i][q] = (dts * tab.b[i]) * xbar[q];
      }
      // FSAL carry-out: the next step's k1 was this step's last stage
      for (int q = 0; q < I; ++q)
        kbar[S - 1][q] = have[S - 1] ? kbar[S - 1][q] + k1bar[q] : k1bar[q];
      have[S - 1] = true;
      for (int q = 0; q < I; ++q) xnew[q] = xbar[q];
      for (int i = S - 1; i >= 1; --i) {
        float* rec = scratch + (((size_t)s * (S - 1) + (i - 1)) * K + r) *
                                   L.width;
        if (!have[i]) {
          for (int w = 0; w < L.width; ++w) rec[w] = 0.0f;
          continue;
        }
        kc_chain_vjp(xs[i], y1s[i], kbar[i], d, p, L, dxi, rec);
        for (int q = 0; q < I; ++q) xnew[q] = xnew[q] + dxi[q];
        for (int j = 0; j < i; ++j) {
          if (tab.a[i][j] == 0.0f) continue;
          const float c = dts * tab.a[i][j];
          for (int q = 0; q < I; ++q) {
            const float contrib = c * dxi[q];
            kbar[j][q] = have[j] ? kbar[j][q] + contrib : contrib;
          }
          have[j] = true;
        }
      }
      // stage 1 is the carried FSAL value: its cotangent goes back a step
      for (int q = 0; q < I; ++q) {
        k1bar[q] = have[0] ? kbar[0][q] : 0.0f;
        xbar[q] = xnew[q];
      }
    }
    // the very first k1 was f(x0): one chain VJP at the inputs
    const float* xr = x0 + (size_t)r * I;
    float k0[KC_MAX_I];
    kc_chain_fwd(xr, d, p, y1s[0], k0);
    kc_chain_vjp(xr, y1s[0], k1bar, d, p, L, dxi,
                 scratch + ((size_t)n_acc * (S - 1) * K + r) * L.width);
    for (int q = 0; q < I; ++q)
      dx0[(size_t)r * I + q] = (xbar[q] + dxi[q]) + gys[(size_t)r * I + q];
  }
  __syncthreads();
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
                    const ChainDims* d, const AdaptTab* tab,
                    const AdaptCtrl* ctrl, void* stream) {
  const size_t smem = (kc_param_floats(*d) + (size_t)K * d->I) * sizeof(float);
  cudaError_t err = kc_smem_opt_in(adaptive_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = (K + 31) / 32 * 32;
  adaptive_fwd_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      x0, ts, T_save, c1, w1, c2, w2, ys, rx, rk1, rdt, rsx, stats, K,
      max_steps, *d, *tab, *ctrl);
  return (int)cudaGetLastError();
}

int kc_adaptive_bwd(const float* x0, const float* c1, const float* w1,
                    const float* c2, const float* w2, const float* rx,
                    const float* rk1, const float* rdt, const int* rsx,
                    const int* stats, const float* gys, int T_save,
                    float* dx0, float* dc1, float* dw1, float* dc2,
                    float* dw2, float* scratch, int K, const ChainDims* d,
                    const AdaptTab* tab, void* stream) {
  const size_t smem = kc_param_floats(*d) * sizeof(float);
  cudaError_t err = kc_smem_opt_in(adaptive_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  adaptive_bwd_kernel<<<1, kBwdThreads, smem, (cudaStream_t)stream>>>(
      x0, c1, w1, c2, w2, rx, rk1, rdt, rsx, stats, gys, T_save, dx0, dc1,
      dw1, dc2, dw2, scratch, K, *d, *tab);
  return (int)cudaGetLastError();
}

}  // extern "C"
