// The bounded adaptive solve of a PACKED ensemble, one step controller per
// member, over the 2-layer KDense chain, and its discrete adjoint, for
// Hopper (sm_90a), with a plain C interface loaded through ctypes
// (kanodes_tpu_torch/ops/_cuda.py builds it with nvcc, with -fmad=false
// as rk_adaptive.cu: see "Numbers" there).
//
// Replaces the Pallas kernels of kanodes_tpu/ops/rk_adaptive_fused.py:
//   mb_adaptive_fwd <- _adaptive_members_fwd_kernel  (K8f,
//                      fused_adaptive_members_odeint)
//   mb_adaptive_bwd <- _adaptive_members_bwd_kernel  (K8b, _fam_bwd)
//
// What it computes (the JAX kernel's semantics, not its Mosaic layout):
// x0 [K, I] is a member-major packed batch, member s owning the columns
// [s*d, (s+1)*d), d = I / S. Forward: an FSAL embedded RK pair whose
// every member runs its own save-clipped I/PI controller: its own t, dt,
// save index, done flag and PI memory, an error norm over its own (K, d)
// block, accept/reject decisions that never couple members. The save
// time is clamped at T-1; only accepted steps of unfinished members move
// t, the state, k1, the saves and the PI memory; dt is frozen for the
// members already done before the iteration; the body stops once every
// member is done, so the records hold only active iterations. Rows a
// member never reached get that member's final state. Every active
// iteration is recorded: x_in, k1 [K, I] and per member the signed dt,
// accepted-and-unfinished (0/1) and the save row or -1. Backward: the
// records replayed in reverse, the per-member "direct" adjoint w.r.t. x0
// and the chain parameters (step sizes are gradient constants, rejected
// members pass their k1 cotangent through).
//
// The chain is evaluated DENSE over the packed width, as the TPU kernel's
// GEMMs run over all S*I columns: the kernel never assumes the weights
// block-diagonal, and its raw parameter cotangents are non-zero off the
// blocks (models/packed.apply_mask zeroes them outside the kernel).
//
// What bounds it on this card: latency. An iteration is s-1 dependent
// chain evaluations (tsit5: 6) of ~3e4 flops each at 8 packed LV members
// ([16, 80, 16], G = 5), and its adjoint six more and six VJPs: bytes and
// flops are far below a microsecond, the chain of barriers is not.
//
// What the design does about it: the whole solve is ONE launch and its
// adjoint one more, with no host round trip per iteration (the iteration
// count stays on the device). One block of 256 threads, the parameters
// (60 KB at S = 8, above the 48 KB default: opted in) in shared memory.
// The packed state is too wide for K4's one thread a row, so the threads
// run over the packed width: the basis values of a layer's inputs are
// computed once per evaluation into shared memory, then each output (row,
// column) is a contraction over [basis | swish] x [C ; W] split into
// chunks across threads and summed chunk by chunk in a fixed order.
// Per-member controller state lives in shared memory, member s's
// decisions made by thread s; every thread takes the same branches, so
// barriers and the early exit are block-uniform. The adjoint keeps the
// parameter cotangents in shared memory, each entry owned by one thread
// and summed in record order: bitwise repeatable, no float atomics.
//
// Caps (checked by the wrapper, _cuda.check_members_caps): I <= 32 (so
// S <= 32), G <= KC_MAX_G, stages <= KC_MAX_STAGES, and the dynamic
// shared memory of mb_smem_bytes within MB_MAX_SMEM. At [16, 80, 16],
// G = 5 (S = 8) that admits K <= 8 rows.

#include "kan_chain.cuh"

#define MB_MAX_I 32              // packed state width, so members S <= 32
#define MB_MAX_MEMBERS MB_MAX_I
// dynamic shared memory a block may take: the H100's 227 KB less 4 KB
// for the kernels' static per-member arrays
#define MB_MAX_SMEM (232448 - 4096)

namespace {

constexpr int kThreads = 256;

__host__ __device__ inline int mb_max(int a, int b) { return a > b ? a : b; }

// floats of one [basis | swish] feature buffer: K rows of the wider layer
__host__ __device__ inline int mb_feat_floats(const ChainDims& d, int K) {
  return K * mb_max(d.I, d.H) * (d.G + 1);
}

// floats of the chunk partial sums of mb_matvec
__host__ __device__ inline int mb_part_floats(const ChainDims& d, int K) {
  return mb_max(kThreads, K * mb_max(d.H, d.O));
}

// Shared-memory layout of the forward (offsets in floats, after the
// staged parameters c1 | w1 | c2 | w2).
struct MbFwd {
  int x, k, xs, y1, red, hid, feat, part, floats;
};

__host__ __device__ inline MbFwd mb_fwd_layout(const ChainDims& d, int K,
                                               int stages) {
  const int KI = K * d.I;
  MbFwd L;
  L.x = kc_param_floats(d);
  L.k = L.x + KI;              // stage derivatives; k[0] is the FSAL k1
  L.xs = L.k + stages * KI;    // the stage input being evaluated
  L.y1 = L.xs + KI;            // the step's result
  L.red = L.y1 + KI;           // squared scaled errors
  L.hid = L.red + KI;          // layer 1's output
  L.feat = L.hid + K * d.H;
  L.part = L.feat + mb_feat_floats(d, K);
  L.floats = L.part + mb_part_floats(d, K);
  return L;
}

// Shared-memory layout of the backward (after the staged parameters).
struct MbBwd {
  int grads, xs, k, hid, kbar, xbar, k1bar, xnew, dxi, dy1, feat1, feat2,
      m1, m2, part, floats;
};

__host__ __device__ inline MbBwd mb_bwd_layout(const ChainDims& d, int K,
                                               int stages) {
  const int KI = K * d.I, KH = K * d.H, F = mb_feat_floats(d, K);
  MbBwd L;
  L.grads = kc_param_floats(d);        // parameter cotangents, c1|w1|c2|w2
  L.xs = L.grads + kc_param_floats(d); // stage inputs; xs[0] = x_in
  L.k = L.xs + stages * KI;            // stage derivatives; k[0] = k1_in
  L.hid = L.k + stages * KI;           // layer-1 outputs per stage
  L.kbar = L.hid + stages * KH;
  L.xbar = L.kbar + stages * KI;
  L.k1bar = L.xbar + KI;
  L.xnew = L.k1bar + KI;
  L.dxi = L.xnew + KI;
  L.dy1 = L.dxi + KI;
  L.feat1 = L.dy1 + KH;
  L.feat2 = L.feat1 + F;
  L.m1 = L.feat2 + F;
  L.m2 = L.m1 + F;
  L.part = L.m2 + F;
  L.floats = L.part + mb_part_floats(d, K);
  return L;
}

// feat [K, n_in*(G+1)]: the basis of each input (column i*G+g) and its
// swish (column n_in*G+i), the rows of [C ; W] they multiply.
__device__ void mb_features(const float* xin, int K, int n_in,
                            const ChainDims& d, float* feat) {
  const int G = d.G, J = n_in * (G + 1);
  for (int t = threadIdx.x; t < K * J; t += blockDim.x) {
    const int r = t / J, j = t % J;
    if (j < n_in * G) {
      const float xn = kc_norm(xin[r * n_in + j / G], d.normalizer);
      feat[t] = kc_basis((xn - d.grid[j % G]) * d.inv_h, d.basis);
    } else {
      feat[t] = kc_swish(xin[r * n_in + (j - n_in * G)]);
    }
  }
}

// out [K, N] = feat [K, J] x M [J, N]. Each (row, column) sum is cut into
// P chunks of j, one thread a chunk, and the chunks are added in order.
// Starts after and ends in __syncthreads.
__device__ void mb_matvec(const float* feat, int K, int J, const float* M,
                          int N, float* part, float* out) {
  const int KN = K * N;
  int P = blockDim.x / KN;
  P = P < 1 ? 1 : (P > J ? J : P);
  const int chunk = (J + P - 1) / P;
  for (int t = threadIdx.x; t < KN * P; t += blockDim.x) {
    const int n = t % N, r = (t / N) % K, c = t / KN;
    const int j1 = min(J, (c + 1) * chunk);
    const float* f = feat + r * J;
    float acc = 0.0f;
    for (int j = c * chunk; j < j1; ++j) acc += f[j] * M[j * N + n];
    part[t] = acc;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < KN; t += blockDim.x) {
    float acc = part[t];
    for (int c = 1; c < P; ++c) acc += part[c * KN + t];
    out[t] = acc;
  }
  __syncthreads();
}

// The chain on xin [K, I]: hid [K, H] = layer 1, out [K, O] = layer 2.
// xin must be visible to the block; ends in __syncthreads.
__device__ void mb_chain(const float* xin, float* hid, float* out, int K,
                         const ChainDims& d, const ChainParams& p,
                         float* feat, float* part) {
  mb_features(xin, K, d.I, d, feat);
  __syncthreads();
  mb_matvec(feat, K, d.I * (d.G + 1), p.c1, d.H, part, hid);
  mb_features(hid, K, d.H, d, feat);
  __syncthreads();
  mb_matvec(feat, K, d.H * (d.G + 1), p.c2, d.O, part, out);
}

// The cotangent of a layer's input xin [K, n] from m = gy [C ; W]^T
// [K, n*(G+1)] (kc_layer_bwd_dx's arithmetic).
__device__ void mb_input_cotangent(const float* xin, int K, int n,
                                   const ChainDims& d, const float* m,
                                   float* dx) {
  const int J = n * (d.G + 1);
  for (int t = threadIdx.x; t < K * n; t += blockDim.x) {
    const int r = t / n, i = t % n;
    const float xv = xin[t];
    const float xn = kc_norm(xv, d.normalizer);
    const float* mr = m + r * J;
    float acc = 0.0f;
    for (int g = 0; g < d.G; ++g) {
      const float u = (xn - d.grid[g]) * d.inv_h;
      const float B = kc_basis(u, d.basis);
      acc += mr[i * d.G + g] * kc_basis_du(u, B, d.basis) * d.inv_h;
    }
    dx[t] = acc * kc_dnorm(xv, d.normalizer) + mr[n * d.G + i] * kc_dswish(xv);
  }
}

// VJP of the chain at x [K, I] (hid = layer 1's output) for the cotangent
// gk [K, O]: writes dx [K, I] and adds the parameter cotangents into
// grads (c1|w1|c2|w2), each entry by the one thread that owns it, summed
// over the rows in order. Inputs visible to the block; ends in
// __syncthreads.
__device__ void mb_chain_vjp(const float* x, const float* hid, const float* gk,
                             float* dx, float* grads, const ChainParams& p,
                             int K, const ChainDims& d, float* feat1,
                             float* feat2, float* m1, float* m2, float* dy1) {
  const int I = d.I, H = d.H, O = d.O;
  const int J1 = I * (d.G + 1), J2 = H * (d.G + 1);
  mb_features(x, K, I, d, feat1);
  mb_features(hid, K, H, d, feat2);
  for (int t = threadIdx.x; t < K * J2; t += blockDim.x) {
    const int r = t / J2, j = t % J2;
    const float* g = gk + r * O;
    const float* row = p.c2 + (size_t)j * O;
    float acc = 0.0f;
    for (int o = 0; o < O; ++o) acc += g[o] * row[o];
    m2[t] = acc;
  }
  __syncthreads();
  mb_input_cotangent(hid, K, H, d, m2, dy1);
  __syncthreads();
  for (int t = threadIdx.x; t < K * J1; t += blockDim.x) {
    const int r = t / J1, j = t % J1;
    const float* g = dy1 + r * H;
    const float* row = p.c1 + (size_t)j * H;
    float acc = 0.0f;
    for (int h = 0; h < H; ++h) acc += g[h] * row[h];
    m1[t] = acc;
  }
  __syncthreads();
  mb_input_cotangent(x, K, I, d, m1, dx);
  const int P1 = J1 * H, P2 = J2 * O;
  for (int q = threadIdx.x; q < P1 + P2; q += blockDim.x) {
    float acc = 0.0f;
    if (q < P1) {                          // [dc1 ; dw1] = feat1^T dy1
      const int j = q / H, h = q % H;
      for (int r = 0; r < K; ++r) acc += feat1[r * J1 + j] * dy1[r * H + h];
    } else {                               // [dc2 ; dw2] = feat2^T gk
      const int j = (q - P1) / O, o = (q - P1) % O;
      for (int r = 0; r < K; ++r) acc += feat2[r * J2 + j] * gk[r * O + o];
    }
    grads[q] += acc;
  }
  __syncthreads();
}

// Member s's sum of red [K, I] over its own block, rows then columns.
__device__ inline float mb_member_sum(const float* red, int K, int I, int dm,
                                      int s) {
  float acc = 0.0f;
  for (int r = 0; r < K; ++r)
    for (int q = s * dm; q < (s + 1) * dm; ++q) acc += red[r * I + q];
  return acc;
}

// StepController.factor with pow as exp/log (rk_adaptive.cu's arithmetic)
__device__ inline float mb_factor(const AdaptCtrl& c, float err_nrm,
                                  float err_prev) {
  float fac = c.safety * expf(c.err_exp * logf(fmaxf(err_nrm, 1e-12f)));
  if (c.use_prev)
    fac = fac * expf(c.prev_exp * logf(fmaxf(err_prev, 1e-12f)));
  return fminf(fmaxf(fac, c.min_factor), c.max_factor);
}

__global__ void __launch_bounds__(kThreads)
members_fwd_kernel(const float* x0, const float* ts, int T_save,
                   const float* c1, const float* w1, const float* c2,
                   const float* w2, float* ys, float* rx, float* rk1,
                   float* rdt, int* racc, int* rsx, int* mstats, int* nit,
                   int K, int S, int max_steps, ChainDims d, AdaptTab tab,
                   AdaptCtrl c) {
  extern __shared__ float smem[];
  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, smem);
  const MbFwd L = mb_fwd_layout(d, K, tab.stages);
  float* x = smem + L.x;
  float* k = smem + L.k;
  float* xs = smem + L.xs;
  float* y1 = smem + L.y1;
  float* red = smem + L.red;
  float* hid = smem + L.hid;
  float* feat = smem + L.feat;
  float* part = smem + L.part;
  // per-member controller state, member s's entries written by thread s
  __shared__ float s_t[MB_MAX_MEMBERS], s_dt[MB_MAX_MEMBERS];
  __shared__ float s_ep[MB_MAX_MEMBERS], s_dts[MB_MAX_MEMBERS];
  __shared__ float s_dtu[MB_MAX_MEMBERS], s_tsave[MB_MAX_MEMBERS];
  __shared__ float s_h0[MB_MAX_MEMBERS], s_d1[MB_MAX_MEMBERS];
  __shared__ int s_sidx[MB_MAX_MEMBERS], s_done[MB_MAX_MEMBERS];
  __shared__ int s_nacc[MB_MAX_MEMBERS], s_nrej[MB_MAX_MEMBERS];
  __shared__ int s_nitv[MB_MAX_MEMBERS], s_hit[MB_MAX_MEMBERS];
  __shared__ int s_ok[MB_MAX_MEMBERS], s_saved[MB_MAX_MEMBERS];
  __shared__ int s_row[MB_MAX_MEMBERS];
  __shared__ int s_all_done;

  const int I = d.I, KI = K * I, dm = I / S, st = tab.stages;
  const int tid = threadIdx.x;
  const float n_blk = (float)(K * dm);
  const float t0 = ts[0];
  const float tdir = ts[T_save - 1] >= t0 ? 1.0f : -1.0f;
  for (int t = tid; t < KI; t += blockDim.x) {
    x[t] = x0[t];
    ys[t] = x0[t];
  }
  __syncthreads();
  mb_chain(x, hid, k, K, d, p, feat, part);           // k1 = f(x0)

  if (!c.has_dt0) {
    // integrate._initial_dt_members, every norm over the member's block
    for (int t = tid; t < KI; t += blockDim.x) {
      const float v = x[t] / (c.atol + c.rtol * fabsf(x[t]));
      red[t] = v * v;
    }
    __syncthreads();
    if (tid < S) s_h0[tid] = sqrtf(mb_member_sum(red, K, I, dm, tid) / n_blk);
    __syncthreads();
    for (int t = tid; t < KI; t += blockDim.x) {
      const float v = k[t] / (c.atol + c.rtol * fabsf(x[t]));
      red[t] = v * v;
    }
    __syncthreads();
    if (tid < S) {
      const float d0 = s_h0[tid];
      const float d1 = sqrtf(mb_member_sum(red, K, I, dm, tid) / n_blk);
      s_d1[tid] = d1;
      s_h0[tid] = (d0 < 1e-5f || d1 < 1e-5f) ? 1e-6f : 0.01f * d0 / d1;
    }
    __syncthreads();
    for (int t = tid; t < KI; t += blockDim.x)
      xs[t] = x[t] + (tdir * s_h0[(t % I) / dm]) * k[t];
    __syncthreads();
    mb_chain(xs, hid, y1, K, d, p, feat, part);
    for (int t = tid; t < KI; t += blockDim.x) {
      const float v = (y1[t] - k[t]) / (c.atol + c.rtol * fabsf(x[t]));
      red[t] = v * v;
    }
    __syncthreads();
    if (tid < S) {
      const float h0 = s_h0[tid];
      const float d2 = sqrtf(mb_member_sum(red, K, I, dm, tid) / n_blk) / h0;
      const float dmax = fmaxf(s_d1[tid], d2);
      const float h1 = dmax <= 1e-15f ? fmaxf(1e-6f, h0 * 1e-3f)
                                      : expf(c.idt_exp * logf(0.01f / dmax));
      s_dt[tid] = fminf(100.0f * h0, h1);
    }
  } else if (tid < S) {
    s_dt[tid] = c.dt0;
  }
  if (tid < S) {
    s_t[tid] = t0;
    s_ep[tid] = 1.0f;
    s_sidx[tid] = 1;
    s_done[tid] = T_save <= 1;
    s_nacc[tid] = s_nrej[tid] = s_nitv[tid] = 0;
  }
  if (tid == 0) s_all_done = T_save <= 1;
  __syncthreads();

  int n_it = 0;                                // active iterations
  for (int it = 0; it < max_steps; ++it) {
    if (s_all_done) break;                     // block-uniform early exit
    if (tid < S) {
      const int row = min(s_sidx[tid], T_save - 1);
      const float t_save = ts[row];
      const float remaining = (t_save - s_t[tid]) * tdir;
      const bool hit = s_dt[tid] >= remaining;
      const float dt_used = hit ? remaining : s_dt[tid];
      s_row[tid] = row;
      s_tsave[tid] = t_save;
      s_hit[tid] = hit;
      s_dtu[tid] = dt_used;
      s_dts[tid] = tdir * dt_used;
    }
    __syncthreads();
    for (int i = 1; i < st; ++i) {
      for (int t = tid; t < KI; t += blockDim.x) {
        const float dts = s_dts[(t % I) / dm];
        float v = x[t];
        for (int j = 0; j < i; ++j)
          if (tab.a[i][j] != 0.0f) v = v + (dts * tab.a[i][j]) * k[j * KI + t];
        xs[t] = v;
      }
      __syncthreads();
      mb_chain(xs, hid, k + i * KI, K, d, p, feat, part);
    }
    for (int t = tid; t < KI; t += blockDim.x) {
      const float dts = s_dts[(t % I) / dm];
      float acc = x[t], err = 0.0f;
      for (int i = 0; i < st; ++i) {
        const float ki = k[i * KI + t];
        if (tab.b[i] != 0.0f) acc = acc + (dts * tab.b[i]) * ki;
        if (tab.e[i] != 0.0f) err = err + (dts * tab.e[i]) * ki;
      }
      y1[t] = acc;
      const float v = err / (c.atol + c.rtol * fmaxf(fabsf(x[t]), fabsf(acc)));
      red[t] = v * v;
    }
    __syncthreads();
    if (tid < S) {
      const int s = tid;
      const float err_nrm = sqrtf(mb_member_sum(red, K, I, dm, s) / n_blk);
      const float dt_used = s_dtu[s];
      const bool accept = (err_nrm <= 1.0f) || (dt_used <= c.dt_min);
      const float fac = mb_factor(c, err_nrm, s_ep[s]);
      const bool done = s_done[s];
      const bool ok = accept && !done, saved = ok && s_hit[s];
      const size_t rec = (size_t)n_it * S + s;
      rdt[rec] = s_dts[s];
      racc[rec] = ok;
      rsx[rec] = saved ? s_row[s] : -1;
      if (ok) {
        s_t[s] = s_hit[s] ? s_tsave[s] : s_t[s] + s_dts[s];
        s_ep[s] = fmaxf(err_nrm, 1e-12f);
      }
      if (!done) s_dt[s] = fmaxf(dt_used * fac, c.dt_min);
      s_ok[s] = ok;
      s_saved[s] = saved;
      s_nacc[s] += ok;
      s_nrej[s] += !accept && !done;
      s_nitv[s] += !done;
      s_sidx[s] += saved;
      s_done[s] = done || s_sidx[s] >= T_save;
    }
    __syncthreads();
    const size_t off = (size_t)n_it * KI;
    for (int t = tid; t < KI; t += blockDim.x) {
      const int m = (t % I) / dm;
      rx[off + t] = x[t];
      rk1[off + t] = k[t];
      if (s_ok[m]) {
        x[t] = y1[t];
        k[t] = k[(st - 1) * KI + t];             // FSAL: the last stage
      }
      if (s_saved[m]) ys[(size_t)s_row[m] * KI + t] = y1[t];
    }
    if (tid == 0) {
      int all = 1;
      for (int s = 0; s < S; ++s) all &= s_done[s];
      s_all_done = all;
    }
    ++n_it;
    __syncthreads();
  }

  // rows a member never reached get its final state
  for (int e = tid; e < (T_save - 1) * KI; e += blockDim.x) {
    const int i = 1 + e / KI, t = e % KI;
    if (s_sidx[(t % I) / dm] <= i) ys[(size_t)i * KI + t] = x[t];
  }
  if (tid < S) {
    mstats[tid] = s_nacc[tid];
    mstats[S + tid] = s_nrej[tid];
    mstats[2 * S + tid] = s_nitv[tid];
    mstats[3 * S + tid] = s_sidx[tid];
  }
  if (tid == 0) nit[0] = n_it;
}

__global__ void __launch_bounds__(kThreads)
members_bwd_kernel(const float* x0, const float* c1, const float* w1,
                   const float* c2, const float* w2, const float* rx,
                   const float* rk1, const float* rdt, const int* racc,
                   const int* rsx, const int* mstats, const int* nit,
                   const float* gys, int T_save, float* dx0, float* dc1,
                   float* dw1, float* dc2, float* dw2, int K, int S,
                   ChainDims d, AdaptTab tab) {
  extern __shared__ float smem[];
  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, smem);
  const MbBwd L = mb_bwd_layout(d, K, tab.stages);
  float* grads = smem + L.grads;
  float* xs = smem + L.xs;
  float* k = smem + L.k;
  float* hid = smem + L.hid;
  float* kbar = smem + L.kbar;
  float* xbar = smem + L.xbar;
  float* k1bar = smem + L.k1bar;
  float* xnew = smem + L.xnew;
  float* dxi = smem + L.dxi;
  float* dy1 = smem + L.dy1;
  float* feat1 = smem + L.feat1;
  float* feat2 = smem + L.feat2;
  float* m1 = smem + L.m1;
  float* m2 = smem + L.m2;
  float* part = smem + L.part;
  __shared__ float s_dts[MB_MAX_MEMBERS], s_acc[MB_MAX_MEMBERS];
  __shared__ int s_sx[MB_MAX_MEMBERS];

  const int I = d.I, KI = K * I, KH = K * d.H, dm = I / S, st = tab.stages;
  const int tid = threadIdx.x, n_par = kc_param_floats(d);
  const int n_it = nit[0];
  for (int q = tid; q < n_par; q += blockDim.x) grads[q] = 0.0f;
  // the fill's cotangent: rows i >= member s's final save index were fed
  // its final state
  for (int t = tid; t < KI; t += blockDim.x) {
    const int sf = mstats[3 * S + (t % I) / dm];
    float acc = 0.0f;
    for (int i = sf > 1 ? sf : 1; i < T_save; ++i)
      acc = acc + gys[(size_t)i * KI + t];
    xbar[t] = acc;
    k1bar[t] = 0.0f;
  }
  __syncthreads();

  for (int it = n_it - 1; it >= 0; --it) {
    if (tid < S) {
      s_dts[tid] = rdt[(size_t)it * S + tid];
      s_acc[tid] = racc[(size_t)it * S + tid] ? 1.0f : 0.0f;
      s_sx[tid] = rsx[(size_t)it * S + tid];
    }
    __syncthreads();
    const size_t off = (size_t)it * KI;
    for (int t = tid; t < KI; t += blockDim.x) {
      const int sx = s_sx[(t % I) / dm];
      if (sx >= 0) xbar[t] = xbar[t] + gys[(size_t)sx * KI + t];
      xs[t] = rx[off + t];
      k[t] = rk1[off + t];
    }
    __syncthreads();
    // the step's stages again, from its records
    for (int i = 1; i < st; ++i) {
      for (int t = tid; t < KI; t += blockDim.x) {
        const float dts = s_dts[(t % I) / dm];
        float v = xs[t];
        for (int j = 0; j < i; ++j)
          if (tab.a[i][j] != 0.0f) v = v + (dts * tab.a[i][j]) * k[j * KI + t];
        xs[i * KI + t] = v;
      }
      __syncthreads();
      mb_chain(xs + i * KI, hid + i * KH, k + i * KI, K, d, p, feat1, part);
    }
    // stage cotangents from the result (accepted members only) and the
    // FSAL carry-out of the next step's k1
    bool have[KC_MAX_STAGES];
    for (int i = 0; i < st; ++i) have[i] = tab.b[i] != 0.0f;
    for (int t = tid; t < KI; t += blockDim.x) {
      const int m = (t % I) / dm;
      const float dts = s_dts[m], acc = s_acc[m];
      const float xm = xbar[t] * acc;
      for (int i = 0; i < st; ++i)
        if (have[i]) kbar[i * KI + t] = (dts * tab.b[i]) * xm;
      const float fsal = k1bar[t] * acc;
      const int l = (st - 1) * KI + t;
      kbar[l] = have[st - 1] ? kbar[l] + fsal : fsal;
      xnew[t] = xbar[t];        // the identity path, accepted and rejected
    }
    have[st - 1] = true;
    __syncthreads();
    for (int i = st - 1; i >= 1; --i) {
      if (!have[i]) continue;
      mb_chain_vjp(xs + i * KI, hid + i * KH, kbar + i * KI, dxi, grads, p,
                   K, d, feat1, feat2, m1, m2, dy1);
      for (int t = tid; t < KI; t += blockDim.x) {
        const float dts = s_dts[(t % I) / dm];
        xnew[t] = xnew[t] + dxi[t];
        for (int j = 0; j < i; ++j) {
          if (tab.a[i][j] == 0.0f) continue;
          const float contrib = (dts * tab.a[i][j]) * dxi[t];
          kbar[j * KI + t] = have[j] ? kbar[j * KI + t] + contrib : contrib;
        }
      }
      for (int j = 0; j < i; ++j)
        if (tab.a[i][j] != 0.0f) have[j] = true;
      __syncthreads();
    }
    // stage 1 is the carried k1: its cotangent goes back a step; rejected
    // members pass theirs through
    for (int t = tid; t < KI; t += blockDim.x) {
      float kb = k1bar[t] * (1.0f - s_acc[(t % I) / dm]);
      if (have[0]) kb = kb + kbar[t];
      k1bar[t] = kb;
      xbar[t] = xnew[t];
    }
    __syncthreads();
  }

  // the very first k1 was f(x0): one chain VJP at the inputs
  for (int t = tid; t < KI; t += blockDim.x) xs[t] = x0[t];
  __syncthreads();
  mb_chain(xs, hid, k, K, d, p, feat1, part);
  mb_chain_vjp(xs, hid, k1bar, dxi, grads, p, K, d, feat1, feat2, m1, m2,
               dy1);
  for (int t = tid; t < KI; t += blockDim.x)
    dx0[t] = (xbar[t] + dxi[t]) + gys[t];
  const int n_c1 = I * d.G * d.H, n_w1 = I * d.H, n_c2 = d.H * d.G * d.O;
  for (int q = tid; q < n_par; q += blockDim.x) {
    if (q < n_c1) dc1[q] = grads[q];
    else if (q < n_c1 + n_w1) dw1[q - n_c1] = grads[q];
    else if (q < n_c1 + n_w1 + n_c2) dc2[q - n_c1 - n_w1] = grads[q];
    else dw2[q - n_c1 - n_w1 - n_c2] = grads[q];
  }
}

}  // namespace

extern "C" {

// MB_MAX_I, KC_MAX_G, KC_MAX_STAGES, MB_MAX_SMEM (the wrapper's caps)
void mb_caps(int* out) {
  out[0] = MB_MAX_I;
  out[1] = KC_MAX_G;
  out[2] = KC_MAX_STAGES;
  out[3] = MB_MAX_SMEM;
}

// Dynamic shared memory of one launch: the forward's (backward = 0) or
// the backward's.
int mb_smem_bytes(const ChainDims* d, int K, int stages, int backward) {
  const int floats = backward ? mb_bwd_layout(*d, K, stages).floats
                              : mb_fwd_layout(*d, K, stages).floats;
  return floats * (int)sizeof(float);
}

// Each launcher takes device pointers, the host-side structs and the CUDA
// stream, and returns cudaGetLastError() (0 = ok). Records: rx, rk1
// [max_steps, K, I], per member rdt (signed dt), racc (1: accepted and
// unfinished) and rsx (save row or -1), each [max_steps, S]; mstats [4, S]
// = n_accept, n_reject, n_iter, final save index; nit [1] = the active
// iterations recorded.

int mb_adaptive_fwd(const float* x0, const float* ts, int T_save,
                    const float* c1, const float* w1, const float* c2,
                    const float* w2, float* ys, float* rx, float* rk1,
                    float* rdt, int* racc, int* rsx, int* mstats, int* nit,
                    int K, int S, int max_steps, const ChainDims* d,
                    const AdaptTab* tab, const AdaptCtrl* ctrl,
                    void* stream) {
  const size_t smem = mb_smem_bytes(d, K, tab->stages, 0);
  cudaError_t err = kc_smem_opt_in(members_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  members_fwd_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      x0, ts, T_save, c1, w1, c2, w2, ys, rx, rk1, rdt, racc, rsx, mstats,
      nit, K, S, max_steps, *d, *tab, *ctrl);
  return (int)cudaGetLastError();
}

int mb_adaptive_bwd(const float* x0, const float* c1, const float* w1,
                    const float* c2, const float* w2, const float* rx,
                    const float* rk1, const float* rdt, const int* racc,
                    const int* rsx, const int* mstats, const int* nit,
                    const float* gys, int T_save, float* dx0, float* dc1,
                    float* dw1, float* dc2, float* dw2, int K, int S,
                    const ChainDims* d, const AdaptTab* tab, void* stream) {
  const size_t smem = mb_smem_bytes(d, K, tab->stages, 1);
  cudaError_t err = kc_smem_opt_in(members_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  members_bwd_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      x0, c1, w1, c2, w2, rx, rk1, rdt, racc, rsx, mstats, nit, gys, T_save,
      dx0, dc1, dw1, dc2, dw2, K, S, *d, *tab);
  return (int)cudaGetLastError();
}

}  // extern "C"
