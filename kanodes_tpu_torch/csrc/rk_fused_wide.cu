// Whole-RK-step and multistep kernels over a WIDE 2-layer KDense chain
// [I -> H -> I] (I in the hundreds to thousands, H small), for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (kanodes_tpu_torch/ops/_cuda.py builds this file with nvcc).
//
// Replaces the Pallas kernels of kanodes_tpu/ops/rk_fused_wide.py:
//   wd_multistep_fwd    <- _wide_multistep_fwd_kernel     (K7f)
//   wd_multistep_bwd    <- _wide_multistep_bwd_kernel     (K7b)
//   wd_multistep_bwd_lr <- _wide_multistep_bwd_kernel_lr  (K10, K == 1)
//   wd_multistep_fwd, n_steps = 1 <- _wide_step_fwd_kernel  (K6f)
//   wd_multistep_bwd, n_steps = 1 <- _wide_step_bwd_kernel  (K6b)
// K6 is one step of K7's device code: the wrapper of the single step
// calls the same entry points with n_steps = 1 (no stored state is read
// then: step 0 starts from x0).
//
// Layout (WideSpec.pad_params): the state is padded to Ipad columns; c1p
// [G*Ipad, H] is grouped by grid node (row g*Ipad + i), w1p [Ipad, H],
// c2p [H*G, Ipad] (row h*G + g), w2p [H, Ipad]. The kernels loop over the
// I real columns only and write zeros to the pad lanes of ys, dx and the
// parameter cotangents.
//
// What bounds them on this card: latency. A step is up to six dependent
// chain evaluations, each a contraction over G*I (4020-10240 terms) into
// H hidden sums and a fan-out back to I columns: ~10^5 flops on 0.2-0.4
// MB of weights that sit in L2, far under a microsecond of arithmetic or
// bytes, repeated over 20-300 dependent steps.
//
// What the design does about it:
//   * forward: one block per state row, threads over the wide axis, the
//     loop over stages and steps inside the kernel. Layer 1: each thread
//     forms the basis values and swish of its columns and its partial of
//     the H hidden sums; the block reduces them in a fixed order (shuffle
//     tree, then the warps' partials in warp order). Layer 2: the H*G
//     basis values of the hidden vector are formed once in shared memory,
//     then one thread per output column runs a dot of length H*G + H down
//     the columns of c2p / w2p (coalesced across threads). State, stage
//     inputs and stage values live in shared memory; the weights are read
//     from global memory (c1p alone is 0.2-0.4 MB, more than a block's
//     shared memory).
//   * backward (K7b, K6b): one block per row sweeps the steps in reverse.
//     Per step it rebuilds the stage inputs from the stored state, runs
//     the stage adjoints in reverse (gy . [c2|w2]^T with one warp per
//     row of the weights, then the column-local layer-1 VJP), and stores
//     per (step, row, stage) the stage input, the stage cotangent kbar,
//     y1 and its cotangent dy1 in scratch the wrapper allocates.
//   * parameter cotangents: two further kernels over many blocks turn
//     those records into dc1p/dw1p and dc2p/dw2p. Each thread owns the
//     parameters of one column and sums over the records in record order:
//     a fixed order and no float atomics, so gradients repeat bit for bit.
//   * K10 (K == 1): the step Jacobian is I + U Ds (I - L)^{-1} V with
//     U = [A_1 .. A_S] (A_i = dk_i/dy1, [I, H]), V = [B_1^T; ..; B_S^T]
//     (B_i^T = dy1/dx at stage i, [H, I]) and L_ji = dt a_ji B_j^T A_i
//     strictly block-lower. The factors depend on the stored states only,
//     so phase A builds A_i^T, B_i^T and L for EVERY step at once, one
//     block per step over all SMs. Phase B, one block, is the only serial
//     part: per step s = a.U (one reduction per factor row), the
//     block-triangular solve z (I - L) = s Ds by back-substitution (the
//     same z as s Ds (I + L + .. + L^{S-1}); forming T is a device of the
//     TPU's batched GEMMs), xbar = a + z V, and the stage cotangents
//     kbar_i = dt b_i a + sum_{j>i} dt a_ji z_j B_j^T for the parameter
//     kernels above.
//
// Constants arrive folded on the host in float64 and rounded to float32
// (dt a_ij, dt b_i, the grid, 1/h), as the JAX kernel gets them.
// Precision: float32 with expf/tanhf, no fast-math intrinsics.
// Launches go on the caller's stream; nothing here allocates or syncs.
//
// Caps (the wrapper checks them and raises with them in the message):
// I <= WD_MAX_I, H <= WD_MAX_H, G <= WD_MAX_G, stages <= WD_MAX_STAGES.
// Shared memory: the backward sweep takes (2 * needed stages + 1) * I
// floats plus small vectors, 53 KB at I = 1024 with tsit5, so the kernels
// opt in above the 48 KB default.

#include "kan_chain.cuh"

#define WD_MAX_I 2048
#define WD_MAX_H 16
#define WD_MAX_G 16
#define WD_MAX_STAGES 7
#define WD_MAX_THREADS 1024
#define WD_PARAM_THREADS 128
#define WD_PARAM_CHUNK 64

// The chain, the grid and a fixed-step tableau with dt folded in.
//   needed[i]: an output consumes stage i (pruned otherwise);
//   slot[i]:   rank of stage i among the needed stages (its buffer).
struct WideTab {
  int I, Ipad, H, G;
  int normalizer, basis;   // 0 tanh, 1 softsign; 0 rbf, 1 iqf, 2 rswaf
  float inv_h;
  float grid[WD_MAX_G];
  int stages, n_slots;
  float a[WD_MAX_STAGES][WD_MAX_STAGES];
  float b[WD_MAX_STAGES];
  int needed[WD_MAX_STAGES];
  int slot[WD_MAX_STAGES];
};

namespace {

struct WideParams {
  const float* c1p;
  const float* w1p;
  const float* c2p;
  const float* w2p;
};

__device__ __forceinline__ float wd_warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Block-wide chain evaluation kout = f(xi) for one state row held in
// shared memory (xi, kout: [I]); y1_out [H] gets layer 1's output when
// not null. s_part: [n_warps * H], s_b2: [H*G + H]. Every thread of the
// block must call it; on return each thread may read its own columns of
// kout (other columns after a barrier).
__device__ void wd_chain_fwd(const float* xi, float* kout, float* y1_out,
                             const WideParams& p, const WideTab& T,
                             float* s_part, float* s_b2) {
  const int I = T.I, H = T.H, G = T.G, Ipad = T.Ipad;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  float acc[WD_MAX_H];
#pragma unroll
  for (int h = 0; h < WD_MAX_H; ++h) acc[h] = 0.0f;
  for (int x = threadIdx.x; x < I; x += blockDim.x) {
    const float v = xi[x];
    const float xn = kc_norm(v, T.normalizer);
    const float sw = kc_swish(v);
    const float* wrow = p.w1p + (size_t)x * H;
#pragma unroll
    for (int h = 0; h < WD_MAX_H; ++h)
      if (h < H) acc[h] += sw * wrow[h];
    for (int g = 0; g < G; ++g) {
      const float B = kc_basis((xn - T.grid[g]) * T.inv_h, T.basis);
      const float* crow = p.c1p + ((size_t)g * Ipad + x) * H;
#pragma unroll
      for (int h = 0; h < WD_MAX_H; ++h)
        if (h < H) acc[h] += B * crow[h];
    }
  }
#pragma unroll
  for (int h = 0; h < WD_MAX_H; ++h) {
    if (h < H) {
      const float s = wd_warp_sum(acc[h]);
      if (lane == 0) s_part[warp * H + h] = s;
    }
  }
  __syncthreads();
  // y1[h] = the warps' partials in warp order; then the basis values and
  // swish of the hidden vector, once for the block
  const int HG = H * G;
  for (int t = threadIdx.x; t < HG + H; t += blockDim.x) {
    const int h = t < HG ? t / G : t - HG;
    float y1 = 0.0f;
    for (int w = 0; w < n_warps; ++w) y1 += s_part[w * H + h];
    if (t < HG) {
      const float yn = kc_norm(y1, T.normalizer);
      s_b2[t] = kc_basis((yn - T.grid[t % G]) * T.inv_h, T.basis);
    } else {
      s_b2[t] = kc_swish(y1);
      if (y1_out) y1_out[h] = y1;
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < I; o += blockDim.x) {
    float kc = 0.0f, kw = 0.0f;
    for (int r = 0; r < HG; ++r) kc += s_b2[r] * p.c2p[(size_t)r * Ipad + o];
    for (int h = 0; h < H; ++h)
      kw += s_b2[HG + h] * p.w2p[(size_t)h * Ipad + o];
    kout[o] = kc + kw;
  }
}

// The needed stages of one step from the step input x_in (global, [I]
// real columns used): stage inputs into s_xs [n_slots, I], stage values
// into s_ks [n_slots, I], layer-1 outputs into s_y1 [n_slots, H] (when
// not null). Each thread reads and writes its own columns of s_xs / s_ks;
// s_y1 is readable after a barrier.
__device__ void wd_rebuild(const float* x_in, float* s_xs, float* s_ks,
                           float* s_y1, const WideParams& p, const WideTab& T,
                           float* s_part, float* s_b2) {
  const int I = T.I;
  for (int st = 0; st < T.stages; ++st) {
    if (!T.needed[st]) continue;
    float* xs = s_xs + T.slot[st] * I;
    for (int x = threadIdx.x; x < I; x += blockDim.x) {
      float v = x_in[x];
      for (int j = 0; j < st; ++j) {
        const float a = T.a[st][j];
        if (a == 0.0f || !T.needed[j]) continue;
        v = v + a * s_ks[T.slot[j] * I + x];
      }
      xs[x] = v;
    }
    wd_chain_fwd(xs, s_ks + T.slot[st] * I,
                 s_y1 ? s_y1 + T.slot[st] * T.H : nullptr, p, T, s_part,
                 s_b2);
  }
}

// K7f / K6f: n_steps whole RK steps of row blockIdx.x, every post-step
// state written to ys [n_steps, K, Ipad].
__global__ void __launch_bounds__(WD_MAX_THREADS)
wd_fwd_kernel(const float* x0, WideParams p, float* ys, int K, int n_steps,
              WideTab T) {
  extern __shared__ float smem[];
  const int I = T.I, Ipad = T.Ipad;
  const int row = blockIdx.x;
  float* s_x = smem;                           // [I] the state
  float* s_xs = s_x + I;                       // [n_slots, I] stage inputs
  float* s_ks = s_xs + T.n_slots * I;          // [n_slots, I] stage values
  float* s_part = s_ks + T.n_slots * I;        // [32 * H]
  float* s_b2 = s_part + 32 * T.H;             // [H*G + H]
  for (int x = threadIdx.x; x < I; x += blockDim.x)
    s_x[x] = x0[(size_t)row * Ipad + x];
  for (int s = 0; s < n_steps; ++s) {
    wd_rebuild(s_x, s_xs, s_ks, nullptr, p, T, s_part, s_b2);
    float* y = ys + ((size_t)s * K + row) * Ipad;
    for (int x = threadIdx.x; x < Ipad; x += blockDim.x) {
      if (x >= I) {
        y[x] = 0.0f;
        continue;
      }
      float acc = s_x[x];
      for (int st = 0; st < T.stages; ++st)
        if (T.b[st] != 0.0f) acc = acc + T.b[st] * s_ks[T.slot[st] * I + x];
      s_x[x] = acc;
      y[x] = acc;
    }
  }
}

// K7b / K6b: the reverse sweep of row blockIdx.x. Writes dx0 and, per
// record r = (step * K + row) * n_slots + slot, the stage input XS[r]
// [I], the stage cotangent KB[r] [I], y1 Y1[r] [H] and its cotangent
// TT[r] [H], from which wd_param*_kernel form the parameter cotangents.
__global__ void __launch_bounds__(WD_MAX_THREADS)
wd_bwd_kernel(const float* x0, const float* ys, const float* gys,
              WideParams p, float* dx0, float* XS, float* KB, float* Y1,
              float* TT, int K, int n_steps, WideTab T) {
  extern __shared__ float smem[];
  const int I = T.I, Ipad = T.Ipad, H = T.H, G = T.G, HG = H * G;
  const int row = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  float* s_xs = smem;                          // [n_slots, I]
  float* s_kb = s_xs + T.n_slots * I;          // [n_slots, I] ks, then kbar
  float* s_xbar = s_kb + T.n_slots * I;        // [I]
  float* s_y1 = s_xbar + I;                    // [n_slots, H]
  float* s_t = s_y1 + T.n_slots * H;           // [H] dy1 of the stage
  float* s_m2 = s_t + H;                       // [H*G + H]
  float* s_part = s_m2 + HG + H;               // [32 * H]
  float* s_b2 = s_part + 32 * H;               // [H*G + H]
  for (int x = threadIdx.x; x < I; x += blockDim.x) s_xbar[x] = 0.0f;
  for (int s = n_steps - 1; s >= 0; --s) {
    const float* x_in = s == 0 ? x0 + (size_t)row * Ipad
                               : ys + ((size_t)(s - 1) * K + row) * Ipad;
    wd_rebuild(x_in, s_xs, s_kb, s_y1, p, T, s_part, s_b2);
    // seeds: a = xbar + gys[s]; kbar_i = (dt b_i) a (0 where b_i = 0).
    // Each column's ks are read by its own thread only.
    const float* g_in = gys + ((size_t)s * K + row) * Ipad;
    for (int x = threadIdx.x; x < I; x += blockDim.x) {
      const float a = s_xbar[x] + g_in[x];
      s_xbar[x] = a;
      for (int st = 0; st < T.stages; ++st)
        if (T.needed[st])
          s_kb[T.slot[st] * I + x] = T.b[st] != 0.0f ? T.b[st] * a : 0.0f;
    }
    const size_t r0 = ((size_t)s * K + row) * T.n_slots;
    for (int st = T.stages - 1; st >= 0; --st) {
      if (!T.needed[st]) continue;
      const int sl = T.slot[st];
      float* kb = s_kb + sl * I;
      const float* xs = s_xs + sl * I;
      __syncthreads();                         // kbar_st is complete
      // m2 = kbar . [c2p | w2p]^T: one warp per weight row
      for (int r = warp; r < HG + H; r += n_warps) {
        const float* wrow = r < HG ? p.c2p + (size_t)r * Ipad
                                   : p.w2p + (size_t)(r - HG) * Ipad;
        float acc = 0.0f;
        for (int o = lane; o < I; o += 32) acc += kb[o] * wrow[o];
        acc = wd_warp_sum(acc);
        if (lane == 0) s_m2[r] = acc;
      }
      __syncthreads();
      for (int h = threadIdx.x; h < H; h += blockDim.x) {
        const float y1 = s_y1[sl * H + h];
        const float yn = kc_norm(y1, T.normalizer);
        float acc = 0.0f;
        for (int g = 0; g < G; ++g) {
          const float u = (yn - T.grid[g]) * T.inv_h;
          const float B = kc_basis(u, T.basis);
          acc += s_m2[h * G + g] * kc_basis_du(u, B, T.basis) * T.inv_h;
        }
        const float t = acc * kc_dnorm(y1, T.normalizer)
                        + s_m2[HG + h] * kc_dswish(y1);
        s_t[h] = t;
        TT[(r0 + sl) * H + h] = t;
        Y1[(r0 + sl) * H + h] = y1;
      }
      __syncthreads();
      // the column-local layer-1 VJP, into xbar and the earlier stages
      for (int x = threadIdx.x; x < I; x += blockDim.x) {
        const float v = xs[x];
        const float xn = kc_norm(v, T.normalizer);
        float accn = 0.0f;
        for (int g = 0; g < G; ++g) {
          const float u = (xn - T.grid[g]) * T.inv_h;
          const float B = kc_basis(u, T.basis);
          const float* crow = p.c1p + ((size_t)g * Ipad + x) * H;
          float m = 0.0f;
          for (int h = 0; h < H; ++h) m += s_t[h] * crow[h];
          accn += m * kc_basis_du(u, B, T.basis) * T.inv_h;
        }
        const float* wrow = p.w1p + (size_t)x * H;
        float mw = 0.0f;
        for (int h = 0; h < H; ++h) mw += s_t[h] * wrow[h];
        const float dxi = accn * kc_dnorm(v, T.normalizer)
                          + mw * kc_dswish(v);
        XS[(r0 + sl) * I + x] = v;
        KB[(r0 + sl) * I + x] = kb[x];
        s_xbar[x] = s_xbar[x] + dxi;
        for (int j = 0; j < st; ++j) {
          const float a = T.a[st][j];
          if (a == 0.0f || !T.needed[j]) continue;
          s_kb[T.slot[j] * I + x] = s_kb[T.slot[j] * I + x] + a * dxi;
        }
      }
    }
  }
  for (int x = threadIdx.x; x < Ipad; x += blockDim.x)
    dx0[(size_t)row * Ipad + x] = x < I ? s_xbar[x] : 0.0f;
}

// dc1p[(g*Ipad + x), h] = sum_r B_g(XS[r][x]) TT[r][h]  (blockIdx.y = g)
// dw1p[x, h]            = sum_r swish(XS[r][x]) TT[r][h] (blockIdx.y = G)
// One thread per column x, records in order; zeros on the pad lanes.
__global__ void __launch_bounds__(WD_PARAM_THREADS)
wd_param1_kernel(const float* XS, const float* TT, float* dc1p, float* dw1p,
                 int R, WideTab T) {
  __shared__ float s_t[WD_PARAM_CHUNK * WD_MAX_H];
  const int I = T.I, Ipad = T.Ipad, H = T.H, G = T.G;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = blockIdx.y;
  float acc[WD_MAX_H];
#pragma unroll
  for (int h = 0; h < WD_MAX_H; ++h) acc[h] = 0.0f;
  for (int r0 = 0; r0 < R; r0 += WD_PARAM_CHUNK) {
    const int n = R - r0 < WD_PARAM_CHUNK ? R - r0 : WD_PARAM_CHUNK;
    for (int i = threadIdx.x; i < n * H; i += blockDim.x)
      s_t[i] = TT[(size_t)r0 * H + i];
    __syncthreads();
    if (x < I) {
      for (int rr = 0; rr < n; ++rr) {
        const float v = XS[(size_t)(r0 + rr) * I + x];
        const float coef =
            g < G ? kc_basis((kc_norm(v, T.normalizer) - T.grid[g]) * T.inv_h,
                             T.basis)
                  : kc_swish(v);
#pragma unroll
        for (int h = 0; h < WD_MAX_H; ++h)
          if (h < H) acc[h] += coef * s_t[rr * H + h];
      }
    }
    __syncthreads();
  }
  if (x < Ipad) {
    float* out = g < G ? dc1p + ((size_t)g * Ipad + x) * H
                       : dw1p + (size_t)x * H;
#pragma unroll
    for (int h = 0; h < WD_MAX_H; ++h)
      if (h < H) out[h] = x < I ? acc[h] : 0.0f;
  }
}

// dc2p[(h*G + g), o] = sum_r B_g(Y1[r][h]) KB[r][o]   (blockIdx.y = h)
// dw2p[h, o]         = sum_r swish(Y1[r][h]) KB[r][o]
// One thread per column o, records in order; zeros on the pad lanes.
__global__ void __launch_bounds__(WD_PARAM_THREADS)
wd_param2_kernel(const float* Y1, const float* KB, float* dc2p, float* dw2p,
                 int R, WideTab T) {
  __shared__ float s_c[WD_PARAM_CHUNK * (WD_MAX_G + 1)];
  const int I = T.I, Ipad = T.Ipad, H = T.H, G = T.G, G1 = T.G + 1;
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = blockIdx.y;
  float acc[WD_MAX_G + 1];
#pragma unroll
  for (int g = 0; g <= WD_MAX_G; ++g) acc[g] = 0.0f;
  for (int r0 = 0; r0 < R; r0 += WD_PARAM_CHUNK) {
    const int n = R - r0 < WD_PARAM_CHUNK ? R - r0 : WD_PARAM_CHUNK;
    for (int i = threadIdx.x; i < n * G1; i += blockDim.x) {
      const int rr = i / G1, g = i % G1;
      const float y1 = Y1[(size_t)(r0 + rr) * H + h];
      s_c[i] = g < G ? kc_basis((kc_norm(y1, T.normalizer) - T.grid[g])
                                    * T.inv_h, T.basis)
                     : kc_swish(y1);
    }
    __syncthreads();
    if (o < I) {
      for (int rr = 0; rr < n; ++rr) {
        const float kb = KB[(size_t)(r0 + rr) * I + o];
#pragma unroll
        for (int g = 0; g <= WD_MAX_G; ++g)
          if (g < G1) acc[g] += s_c[rr * G1 + g] * kb;
      }
    }
    __syncthreads();
  }
  if (o < Ipad) {
#pragma unroll
    for (int g = 0; g <= WD_MAX_G; ++g) {
      if (g < G)
        dc2p[((size_t)h * G + g) * Ipad + o] = o < I ? acc[g] : 0.0f;
      else if (g == G)
        dw2p[(size_t)h * Ipad + o] = o < I ? acc[g] : 0.0f;
    }
  }
}

// K10 phase A, one block per step s (K == 1): rebuilds the step's stages
// and writes the records XS, Y1 and the factors AT [S*H, I] (rows
// A_i[:, h]^T), V [S*H, I] (rows of B_i^T) and L [S*H, S*H] of the step
// Jacobian I + U Ds (I - L)^{-1} V.
__global__ void __launch_bounds__(WD_MAX_THREADS)
wd_lr_factor_kernel(const float* x0, const float* ys, WideParams p,
                    float* XS, float* Y1, float* AT, float* V, float* L,
                    WideTab T) {
  extern __shared__ float smem[];
  const int I = T.I, Ipad = T.Ipad, H = T.H, G = T.G, G1 = T.G + 1;
  const int S = T.n_slots, SH = S * H;
  const int s = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  float* s_xs = smem;                          // [S, I]
  float* s_ks = s_xs + S * I;                  // [S, I]
  float* s_y1 = s_ks + S * I;                  // [S, H]
  float* s_d2 = s_y1 + SH;                     // [S, H, G + 1]
  float* s_part = s_d2 + SH * G1;              // [32 * H]
  float* s_b2 = s_part + 32 * H;               // [H*G + H]
  int st_of[WD_MAX_STAGES];
  for (int st = 0; st < T.stages; ++st)
    if (T.needed[st]) st_of[T.slot[st]] = st;
  const float* x_in = s == 0 ? x0 : ys + (size_t)(s - 1) * Ipad;
  float* Ls = L + (size_t)s * SH * SH;
  for (int i = threadIdx.x; i < SH * SH; i += blockDim.x) Ls[i] = 0.0f;
  wd_rebuild(x_in, s_xs, s_ks, s_y1, p, T, s_part, s_b2);
  __syncthreads();
  const size_t r0 = (size_t)s * S;
  for (int i = threadIdx.x; i < SH; i += blockDim.x) Y1[r0 * H + i] = s_y1[i];
  // dk/dy1 coefficients of every stage: D2[sl][h][g] = B'(u2) / h *
  // norm'(y1), and swish'(y1) in the last place
  for (int i = threadIdx.x; i < SH * G1; i += blockDim.x) {
    const int g = i % G1;
    const float y1 = s_y1[i / G1];
    if (g < G) {
      const float u = (kc_norm(y1, T.normalizer) - T.grid[g]) * T.inv_h;
      s_d2[i] = kc_basis_du(u, kc_basis(u, T.basis), T.basis) * T.inv_h
                * kc_dnorm(y1, T.normalizer);
    } else {
      s_d2[i] = kc_dswish(y1);
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < I; x += blockDim.x) {
    // A_i[x, h] for every stage: one pass down column x of c2p / w2p
    for (int h = 0; h < H; ++h) {
      float acc[WD_MAX_STAGES];
#pragma unroll
      for (int sl = 0; sl < WD_MAX_STAGES; ++sl) acc[sl] = 0.0f;
      for (int g = 0; g <= G; ++g) {
        const float c = g < G ? p.c2p[((size_t)h * G + g) * Ipad + x]
                              : p.w2p[(size_t)h * Ipad + x];
#pragma unroll
        for (int sl = 0; sl < WD_MAX_STAGES; ++sl)
          if (sl < S) acc[sl] += c * s_d2[(sl * H + h) * G1 + g];
      }
#pragma unroll
      for (int sl = 0; sl < WD_MAX_STAGES; ++sl)
        if (sl < S) AT[((r0 + sl) * H + h) * I + x] = acc[sl];
    }
    // B_i^T[h, x] per stage: the column-local layer-1 Jacobian
    for (int sl = 0; sl < S; ++sl) {
      const float v = s_xs[sl * I + x];
      XS[(r0 + sl) * I + x] = v;
      const float xn = kc_norm(v, T.normalizer);
      const float dn = kc_dnorm(v, T.normalizer);
      const float ds = kc_dswish(v);
      float vv[WD_MAX_H];
      const float* wrow = p.w1p + (size_t)x * H;
#pragma unroll
      for (int h = 0; h < WD_MAX_H; ++h) vv[h] = h < H ? ds * wrow[h] : 0.0f;
      for (int g = 0; g < G; ++g) {
        const float u = (xn - T.grid[g]) * T.inv_h;
        const float dB = kc_basis_du(u, kc_basis(u, T.basis), T.basis)
                         * T.inv_h * dn;
        const float* crow = p.c1p + ((size_t)g * Ipad + x) * H;
#pragma unroll
        for (int h = 0; h < WD_MAX_H; ++h)
          if (h < H) vv[h] += dB * crow[h];
      }
#pragma unroll
      for (int h = 0; h < WD_MAX_H; ++h)
        if (h < H) V[((r0 + sl) * H + h) * I + x] = vv[h];
    }
  }
  __syncthreads();      // the factors (global) are visible to the block
  // L[(j, h), (i, h')] = dt a_ji * B_j^T[h, :] . A_i[:, h'], slots j > i:
  // one warp per (j, i, h), lanes over the columns
  const int n_items = S * S * H;
  for (int item = warp; item < n_items; item += n_warps) {
    const int pj = item / (S * H), pi = (item / H) % S, h = item % H;
    if (pi >= pj) continue;
    const float a = T.a[st_of[pj]][st_of[pi]];
    if (a == 0.0f) continue;
    const float* vrow = V + ((r0 + pj) * H + h) * I;
    const float* arow = AT + (r0 + pi) * H * I;
    float acc[WD_MAX_H];
#pragma unroll
    for (int q = 0; q < WD_MAX_H; ++q) acc[q] = 0.0f;
    for (int x = lane; x < I; x += 32) {
      const float vj = vrow[x];
#pragma unroll
      for (int q = 0; q < WD_MAX_H; ++q)
        if (q < H) acc[q] += vj * arow[(size_t)q * I + x];
    }
#pragma unroll
    for (int q = 0; q < WD_MAX_H; ++q) {
      if (q < H) {
        const float v = wd_warp_sum(acc[q]);
        if (lane == 0) Ls[(pj * H + h) * SH + pi * H + q] = a * v;
      }
    }
  }
}

// K10 phase B, one block: the serial reverse chain over the steps on the
// factors of phase A. Writes dx0 and the records KB (stage cotangents)
// and TT (z, the hidden cotangents dy1bar).
__global__ void __launch_bounds__(WD_MAX_THREADS)
wd_lr_chain_kernel(const float* gys, const float* AT, const float* V,
                   const float* L, float* dx0, float* KB, float* TT,
                   int n_steps, WideTab T) {
  extern __shared__ float smem[];
  const int I = T.I, Ipad = T.Ipad, H = T.H;
  const int S = T.n_slots, SH = S * H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  float* s_a = smem;                           // [I]
  float* s_xb = s_a + I;                       // [I]
  float* s_L = s_xb + I;                       // [SH, SH]
  float* s_sv = s_L + SH * SH;                 // [SH]
  float* s_z = s_sv + SH;                      // [SH]
  int st_of[WD_MAX_STAGES];
  for (int st = 0; st < T.stages; ++st)
    if (T.needed[st]) st_of[T.slot[st]] = st;
  for (int x = threadIdx.x; x < I; x += blockDim.x) s_xb[x] = 0.0f;
  for (int s = n_steps - 1; s >= 0; --s) {
    const size_t r0 = (size_t)s * S;
    const float* Ls = L + (size_t)s * SH * SH;
    for (int x = threadIdx.x; x < I; x += blockDim.x)
      s_a[x] = s_xb[x] + gys[(size_t)s * Ipad + x];
    for (int i = threadIdx.x; i < SH * SH; i += blockDim.x) s_L[i] = Ls[i];
    __syncthreads();
    // s = a . U: one warp per factor row
    for (int r = warp; r < SH; r += n_warps) {
      const float* arow = AT + (r0 * H + r) * I;
      float acc = 0.0f;
      for (int x = lane; x < I; x += 32) acc += s_a[x] * arow[x];
      acc = wd_warp_sum(acc);
      if (lane == 0) s_sv[r] = acc;
    }
    __syncthreads();
    // z (I - L) = s Ds by back-substitution from the last stage, warp 0
    if (warp == 0) {
      for (int pi = S - 1; pi >= 0; --pi) {
        const float dtb = T.b[st_of[pi]];
        for (int h = lane; h < H; h += 32) {
          float z = dtb * s_sv[pi * H + h];
          for (int r = (pi + 1) * H; r < SH; ++r)
            z += s_z[r] * s_L[r * SH + pi * H + h];
          s_z[pi * H + h] = z;
        }
        __syncwarp();
      }
    }
    __syncthreads();
    for (int r = threadIdx.x; r < SH; r += blockDim.x)
      TT[r0 * H + r] = s_z[r];
    // xbar = a + z V and the stage cotangents, column-local
    for (int x = threadIdx.x; x < I; x += blockDim.x) {
      const float a = s_a[x];
      float dxj[WD_MAX_STAGES];
      float xb = a;
#pragma unroll
      for (int pj = 0; pj < WD_MAX_STAGES; ++pj) {
        float d = 0.0f;
        if (pj < S) {
          for (int h = 0; h < H; ++h)
            d += s_z[pj * H + h] * V[((r0 + pj) * H + h) * I + x];
          xb = xb + d;
        }
        dxj[pj] = d;
      }
      s_xb[x] = xb;
#pragma unroll
      for (int pi = 0; pi < WD_MAX_STAGES; ++pi) {
        if (pi < S) {
          float kb = T.b[st_of[pi]] * a;
#pragma unroll
          for (int pj = 0; pj < WD_MAX_STAGES; ++pj)
            if (pj > pi && pj < S)
              kb = kb + T.a[st_of[pj]][st_of[pi]] * dxj[pj];
          KB[(r0 + pi) * I + x] = kb;
        }
      }
    }
    __syncthreads();      // before s_a, s_L and s_z are overwritten
  }
  for (int x = threadIdx.x; x < Ipad; x += blockDim.x)
    dx0[x] = x < I ? s_xb[x] : 0.0f;
}

int wd_threads(int n) {
  int t = ((n + 31) / 32) * 32;
  if (t < 128) t = 128;
  return t < WD_MAX_THREADS ? t : WD_MAX_THREADS;
}

size_t wd_small_floats(const WideTab& T) {      // s_part and s_b2
  return (size_t)32 * T.H + T.H * T.G + T.H;
}

cudaError_t wd_launch_fwd(const float* x0, const WideParams& p, float* ys,
                          int K, int n_steps, const WideTab& T,
                          cudaStream_t stream) {
  const size_t smem = ((size_t)(1 + 2 * T.n_slots) * T.I
                       + wd_small_floats(T)) * sizeof(float);
  cudaError_t err = kc_smem_opt_in(wd_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  wd_fwd_kernel<<<K, wd_threads(T.I), smem, stream>>>(x0, p, ys, K, n_steps,
                                                       T);
  return cudaGetLastError();
}

cudaError_t wd_launch_params(const float* XS, const float* KB,
                             const float* Y1, const float* TT, float* dc1p,
                             float* dw1p, float* dc2p, float* dw2p, int R,
                             const WideTab& T, cudaStream_t stream) {
  const int nb = (T.Ipad + WD_PARAM_THREADS - 1) / WD_PARAM_THREADS;
  wd_param1_kernel<<<dim3(nb, T.G + 1), WD_PARAM_THREADS, 0, stream>>>(
      XS, TT, dc1p, dw1p, R, T);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wd_param2_kernel<<<dim3(nb, T.H), WD_PARAM_THREADS, 0, stream>>>(
      Y1, KB, dc2p, dw2p, R, T);
  return cudaGetLastError();
}

cudaError_t wd_launch_bwd(const float* x0, const float* ys, const float* gys,
                          const WideParams& p, float* dx0, float* dc1p,
                          float* dw1p, float* dc2p, float* dw2p, float* XS,
                          float* KB, float* Y1, float* TT, int K, int n_steps,
                          const WideTab& T, cudaStream_t stream) {
  const size_t smem = ((size_t)(1 + 2 * T.n_slots) * T.I + T.n_slots * T.H
                       + T.H + T.H * T.G + T.H + wd_small_floats(T))
                      * sizeof(float);
  cudaError_t err = kc_smem_opt_in(wd_bwd_kernel, smem);
  if (err != cudaSuccess) return err;
  wd_bwd_kernel<<<K, wd_threads(T.I), smem, stream>>>(
      x0, ys, gys, p, dx0, XS, KB, Y1, TT, K, n_steps, T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return wd_launch_params(XS, KB, Y1, TT, dc1p, dw1p, dc2p, dw2p,
                          n_steps * K * T.n_slots, T, stream);
}

}  // namespace

extern "C" {

void wd_caps(int* out) {
  out[0] = WD_MAX_I;
  out[1] = WD_MAX_H;
  out[2] = WD_MAX_G;
  out[3] = WD_MAX_STAGES;
}

// Each launcher takes device pointers, the host-side WideTab and the CUDA
// stream, and returns the first CUDA error of its launches (0 = ok).

int wd_multistep_fwd(const float* x0, const float* c1p, const float* w1p,
                     const float* c2p, const float* w2p, float* ys, int K,
                     int n_steps, const WideTab* T, void* stream) {
  const WideParams p = {c1p, w1p, c2p, w2p};
  return (int)wd_launch_fwd(x0, p, ys, K, n_steps, *T, (cudaStream_t)stream);
}

int wd_multistep_bwd(const float* x0, const float* ys, const float* gys,
                     const float* c1p, const float* w1p, const float* c2p,
                     const float* w2p, float* dx0, float* dc1p, float* dw1p,
                     float* dc2p, float* dw2p, float* XS, float* KB,
                     float* Y1, float* TT, int K, int n_steps,
                     const WideTab* T, void* stream) {
  const WideParams p = {c1p, w1p, c2p, w2p};
  return (int)wd_launch_bwd(x0, ys, gys, p, dx0, dc1p, dw1p, dc2p, dw2p, XS,
                            KB, Y1, TT, K, n_steps, *T,
                            (cudaStream_t)stream);
}

int wd_multistep_bwd_lr(const float* x0, const float* ys, const float* gys,
                        const float* c1p, const float* w1p, const float* c2p,
                        const float* w2p, float* dx0, float* dc1p,
                        float* dw1p, float* dc2p, float* dw2p, float* XS,
                        float* KB, float* Y1, float* TT, float* AT, float* V,
                        float* L, int n_steps, const WideTab* T,
                        void* stream) {
  const WideParams p = {c1p, w1p, c2p, w2p};
  const cudaStream_t st = (cudaStream_t)stream;
  const int S = T->n_slots, SH = S * T->H;
  const size_t smem_a = ((size_t)2 * S * T->I + SH + SH * (T->G + 1)
                         + wd_small_floats(*T)) * sizeof(float);
  cudaError_t err = kc_smem_opt_in(wd_lr_factor_kernel, smem_a);
  if (err != cudaSuccess) return (int)err;
  wd_lr_factor_kernel<<<n_steps, wd_threads(T->I), smem_a, st>>>(
      x0, ys, p, XS, Y1, AT, V, L, *T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem_b = ((size_t)2 * T->I + (size_t)SH * SH + 2 * SH)
                        * sizeof(float);
  err = kc_smem_opt_in(wd_lr_chain_kernel, smem_b);
  if (err != cudaSuccess) return (int)err;
  wd_lr_chain_kernel<<<1, wd_threads(T->I), smem_b, st>>>(
      gys, AT, V, L, dx0, KB, TT, n_steps, *T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)wd_launch_params(XS, KB, Y1, TT, dc1p, dw1p, dc2p, dw2p,
                               n_steps * S, *T, st);
}

}  // extern "C"
