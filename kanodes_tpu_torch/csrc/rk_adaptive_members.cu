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
// adjoint one call of three launches, with no host round trip per
// iteration (the iteration count stays on the device). The forward (K8f)
// is one block of 256 threads, the parameters (60 KB at S = 8, above the
// 48 KB default: opted in) in shared memory. The packed state is too wide
// for one thread a row, so the threads run over the packed width: the
// basis values of a layer's inputs are computed once per evaluation into
// shared memory, then each output (row, column) is a contraction over
// [basis | swish] x [C ; W] split into chunks across threads and summed
// chunk by chunk in a fixed order. Per-member controller state lives in shared memory,
// member s's decisions made by thread s; every thread takes the same
// branches, so barriers and the early exit are block-uniform.
//
// The backward (K8b) ran in that one block too, each iteration's six
// rebuilds and six VJPs in turn, half of its time adding every VJP's
// parameter cotangents (PERF.md, the K4f/K8b trace). A recorded
// iteration's rebuild needs nothing of another iteration, so it runs in
// three phases: A, a block per recorded iteration (and one for the first
// f(x0)) rebuilds the stages from K8f's records with K8f's own chain
// routine (so they round as K8f's did) and stores per chain evaluation and
// row the layers' input features, A2 = dk/dy1 and the Jacobian J = dk/dx;
// B, one block, a warp a row, runs the reverse recursion with a stage's
// VJP as dx = J^T kbar (the Jacobians of the next iteration copied into
// shared memory meanwhile) and stores each evaluation's cotangent; C, many
// blocks, forms dy1 = A2 gk and the parameter cotangents, each entry summed
// by one thread in a fixed order: bitwise repeatable, no float atomics.
// What bounds it now: phase B's dependent chain, six stage VJPs an
// iteration, and phase A's six dependent chain evaluations.
//
// Caps (checked by the wrapper, _cuda.check_members_caps): I <= 32 (so
// S <= 32), G <= KC_MAX_G, stages <= KC_MAX_STAGES, and the dynamic
// shared memory of mb_smem_bytes within MB_MAX_SMEM. At [16, 80, 16],
// G = 5 (S = 8) that admits K <= 28 rows (phase A binds).

#include "kan_chain.cuh"

#define MB_MAX_I 32              // packed state width, so members S <= 32
#define MB_MAX_MEMBERS MB_MAX_I
#define MB_LANES 32
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

// K8b's record of one (chain evaluation, row), offsets in floats: the
// features of the layer inputs, [basis | swish] of x [I*(G+1)] and of the
// hidden values [H*(G+1)] (phase A), the Jacobian factors A2[h][o] =
// dk_o/dy1_h [H*O] and J[o][i] = dk_o/dx_i [O*I] (phase A), and the
// evaluation's cotangent gk [O] (phase B).
struct MbRec {
  int f1, f2, a2, j, gk, width;
};

__host__ __device__ inline MbRec mb_rec_layout(const ChainDims& d) {
  MbRec r;
  r.f1 = 0;
  r.f2 = r.f1 + d.I * (d.G + 1);
  r.a2 = r.f2 + d.H * (d.G + 1);
  r.j = r.a2 + d.H * d.O;
  r.gk = r.j + d.O * d.I;
  r.width = r.gk + d.O;
  return r;
}

// Shared-memory layout of phase A (after the staged parameters): K8f's
// buffers, A2 [rc, H, O] and A1 [rc, H, I] of a chunk of rc rows over
// K8f's feature and partial-sum buffers (free once the chain is
// evaluated; the region grows past them only for a chunk of one row, by
// less than the parameters' floats, so phase A never takes more than the
// one-block backward it replaced), then the derivative factors of the two
// layers' inputs.
struct MbRebuild {
  int x, k, xs, hid, feat, part, a2, a1, rc, tp1, tp2, dv1, dv2, floats;
};

__host__ __device__ inline MbRebuild mb_rebuild_layout(const ChainDims& d,
                                                       int K, int stages) {
  const int KI = K * d.I, KH = K * d.H;
  MbRebuild L;
  L.x = kc_param_floats(d);
  L.k = L.x + KI;                  // stage values; k[0] is the record's k1
  L.xs = L.k + stages * KI;        // the stage input being evaluated
  L.hid = L.xs + KI;               // layer 1's output
  L.feat = L.hid + KH;
  L.part = L.feat + mb_feat_floats(d, K);
  // rows a chunk: as many as the feature and partial-sum buffers hold (at
  // most G + 1, at least one)
  const int per_row = d.H * (d.O + d.I);
  const int fit = (mb_feat_floats(d, K) + mb_part_floats(d, K)) / per_row;
  L.rc = fit < K ? fit : K;
  L.rc = L.rc < d.G + 1 ? L.rc : d.G + 1;
  L.rc = L.rc < 1 ? 1 : L.rc;
  L.a2 = L.feat;
  L.a1 = L.a2 + L.rc * d.H * d.O;
  L.tp1 = mb_max(L.part + mb_part_floats(d, K),
                 L.a1 + L.rc * d.H * d.I);  // B'(u)/h of layer 1 [K, I*G]
  L.tp2 = L.tp1 + KI * d.G;               // of layer 2 [K, H*G]
  L.dv1 = L.tp2 + KH * d.G;               // norm'(x), swish'(x) [K, I, 2]
  L.dv2 = L.dv1 + 2 * KI;                 // of the hidden values [K, H, 2]
  L.floats = L.dv2 + 2 * KH;
  return L;
}

// Phase B: the warps of its block (a warp a row, rows in turn), and the
// floats of one warp's shared memory: two buffers of an iteration's S-1
// Jacobians [S-1][O*I] (the next one staged while the current one runs).
#define MB_SWEEP_MAX_WARPS 8

__host__ __device__ inline int mb_sweep_warp_floats(const ChainDims& d,
                                                    int stages) {
  return 2 * (stages - 1) * d.O * d.I;
}

__host__ __device__ inline int mb_sweep_warps(const ChainDims& d, int K,
                                              int stages) {
  const int fit = (MB_MAX_SMEM / 4) / mb_sweep_warp_floats(d, stages);
  int w = K < MB_SWEEP_MAX_WARPS ? K : MB_SWEEP_MAX_WARPS;
  w = w < fit ? w : fit;
  return w < 1 ? 1 : w;
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

// Phase A's factors of one chain evaluation at xin [K, I] (hid [K, H]
// its layer-1 output, both visible to the block): into each row's record
// at rec (stride R.width) the features of xin and hid, A2[h][o] =
// norm'(y_h) sum_g c2[hg, o] B'(u_hg)/h + swish'(y_h) w2[h, o] and J[o][i]
// = sum_h A2[h][o] A1[i][h], A1[i][h] = dy1_h/dx_i (the same form over
// layer 1), both factors of a chunk of L.rc rows in shared memory. Ends
// in __syncthreads.
__device__ void mb_jacobians(const float* xin, const float* hid, int K,
                             const ChainDims& d, const ChainParams& p,
                             const MbRec& R, float* rec, const MbRebuild& L,
                             float* smem) {
  const int I = d.I, H = d.H, O = d.O, G = d.G;
  const int J1 = I * (G + 1), J2 = H * (G + 1), W = R.width;
  float* tp1 = smem + L.tp1;
  float* tp2 = smem + L.tp2;
  float* dv1 = smem + L.dv1;
  float* dv2 = smem + L.dv2;
  float* a2s = smem + L.a2;
  float* a1s = smem + L.a1;
  for (int t = threadIdx.x; t < K * (J1 + J2); t += blockDim.x) {
    const bool first = t < K * J1;
    const int n = first ? I : H, J = first ? J1 : J2;
    const int q = first ? t : t - K * J1, r = q / J, j = q % J;
    const float* v = first ? xin : hid;
    float* feat = rec + (size_t)r * W + (first ? R.f1 : R.f2);
    float* tp = first ? tp1 : tp2;
    float* dv = first ? dv1 : dv2;
    if (j < n * G) {
      const float xv = v[r * n + j / G];
      const float u = (kc_norm(xv, d.normalizer) - d.grid[j % G]) * d.inv_h;
      const float B = kc_basis(u, d.basis);
      feat[j] = B;
      tp[r * n * G + j] = kc_basis_du(u, B, d.basis) * d.inv_h;
    } else {
      const int i = j - n * G;
      const float xv = v[r * n + i];
      feat[j] = kc_swish(xv);
      dv[(r * n + i) * 2] = kc_dnorm(xv, d.normalizer);
      dv[(r * n + i) * 2 + 1] = kc_dswish(xv);
    }
  }
  __syncthreads();
  for (int r0 = 0; r0 < K; r0 += L.rc) {
    const int RC = K - r0 < L.rc ? K - r0 : L.rc;
    for (int t = threadIdx.x; t < RC * H * (O + I); t += blockDim.x) {
      if (t < RC * H * O) {              // A2[h][o], to the record too
        const int rr = t / (H * O), e = t % (H * O), h = e / O, o = e % O;
        const int r = r0 + rr;
        const float* tr = tp2 + (r * H + h) * G;
        float acc = 0.0f;
        for (int g = 0; g < G; ++g) acc += p.c2[(h * G + g) * O + o] * tr[g];
        const float* dv = dv2 + (r * H + h) * 2;
        const float a = acc * dv[0] + p.w2[h * O + o] * dv[1];
        a2s[t] = a;
        rec[(size_t)r * W + R.a2 + e] = a;
      } else {                           // A1[i][h], stored [h][i]
        const int q = t - RC * H * O;
        const int rr = q / (H * I), e = q % (H * I), h = e / I, i = e % I;
        const int r = r0 + rr;
        const float* tr = tp1 + (r * I + i) * G;
        float acc = 0.0f;
        for (int g = 0; g < G; ++g) acc += p.c1[(i * G + g) * H + h] * tr[g];
        const float* dv = dv1 + (r * I + i) * 2;
        a1s[q] = acc * dv[0] + p.w1[i * H + h] * dv[1];
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < RC * O * I; t += blockDim.x) {
      const int rr = t / (O * I), e = t % (O * I), o = e / I, i = e % I;
      const float* a2 = a2s + rr * H * O + o;
      const float* a1 = a1s + rr * H * I + i;
      float acc = 0.0f;
      for (int h = 0; h < H; ++h) acc += a2[h * O] * a1[h * I];
      rec[(size_t)(r0 + rr) * W + R.j + e] = acc;
    }
    __syncthreads();
  }
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

// K8b phase A: block b < max_steps rebuilds recorded iteration b (blocks
// at or past the recorded count return at once), block max_steps the
// first f(x0); each stores its chain evaluations' records.
__global__ void __launch_bounds__(kThreads)
members_bwd_rebuild_kernel(const float* x0, const float* c1, const float* w1,
                           const float* c2, const float* w2, const float* rx,
                           const float* rk1, const float* rdt, const int* nit,
                           float* scratch, int K, int S, int max_steps,
                           ChainDims d, AdaptTab tab) {
  const int b = blockIdx.x;
  if (b < max_steps && b >= nit[0]) return;
  extern __shared__ float smem[];
  __shared__ float s_dts[MB_MAX_MEMBERS];
  const ChainParams p = kc_stage_params(c1, w1, c2, w2, d, smem);
  const MbRebuild L = mb_rebuild_layout(d, K, tab.stages);
  const MbRec R = mb_rec_layout(d);
  float* x = smem + L.x;
  float* k = smem + L.k;
  float* xs = smem + L.xs;
  float* hid = smem + L.hid;
  float* feat = smem + L.feat;
  float* part = smem + L.part;
  const int I = d.I, KI = K * I, dm = I / S, st = tab.stages;
  const int tid = threadIdx.x;
  const size_t slab = (size_t)K * R.width;       // one evaluation's records
  if (b == max_steps) {                          // the first k1 = f(x0)
    for (int t = tid; t < KI; t += blockDim.x) xs[t] = x0[t];
    __syncthreads();
    mb_chain(xs, hid, k, K, d, p, feat, part);
    mb_jacobians(xs, hid, K, d, p, R,
                 scratch + (size_t)max_steps * (st - 1) * slab, L, smem);
    return;
  }
  if (tid < S) s_dts[tid] = rdt[(size_t)b * S + tid];
  for (int t = tid; t < KI; t += blockDim.x) {
    x[t] = rx[(size_t)b * KI + t];
    k[t] = rk1[(size_t)b * KI + t];
  }
  __syncthreads();
  // the iteration's stages, formed exactly as K8f forms them
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
    mb_jacobians(xs, hid, K, d, p, R,
                 scratch + ((size_t)b * (st - 1) + i - 1) * slab, L, smem);
  }
}

__device__ __forceinline__ void mb_cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void mb_cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// Copy iteration it's S-1 Jacobians of one row (records at rrow) into buf
// [S-1][II]: 16 bytes a copy where the records keep them 16-byte aligned.
__device__ __forceinline__ void mb_stage_jacobians(float* buf,
                                                   const float* rrow,
                                                   int it, int ns, int II,
                                                   size_t slab, int j_off,
                                                   bool vec, int lane) {
  for (int i = 0; i < ns; ++i) {
    const float* src = rrow + ((size_t)it * ns + i) * slab + j_off;
    float* dst = buf + i * II;
    if (vec)
      for (int q = 4 * lane; q < II; q += 4 * MB_LANES)
        mb_cp_async16(dst + q, src + q);
    else
      for (int q = lane; q < II; q += MB_LANES) mb_cp_async4(dst + q, src + q);
  }
}

__device__ __forceinline__ void mb_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's copy groups are in flight
template <int n>
__device__ __forceinline__ void mb_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// K8b phase B: the reverse recursion over the recorded iterations, a warp
// a row (rows in turn), component q in lane q < I, its stage cotangents
// in registers. A stage's VJP is dx_q = sum_o J[o][q] gk_o, the J from
// the record, gk_o shuffled from lane o; the next iteration's Jacobians
// are copied into the warp's other buffer (cp.async) while the current
// one runs, and its step sizes, accept flags and save cotangents are
// read an iteration ahead. Stores each evaluation's gk (zero where no
// cotangent reaches it) and dx0.
__global__ void __launch_bounds__(MB_LANES * MB_SWEEP_MAX_WARPS)
members_bwd_sweep_kernel(const float* rdt, const int* racc, const int* rsx,
                         const int* mstats, const int* nit, const float* gys,
                         int T_save, float* dx0, float* scratch, int K, int S,
                         int max_steps, ChainDims d, AdaptTab tab) {
  extern __shared__ __align__(16) float mb_sweep_smem[];
  __shared__ float s_a[KC_MAX_STAGES][KC_MAX_STAGES];
  __shared__ float s_b[KC_MAX_STAGES];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < KC_MAX_STAGES; ++i) {
#pragma unroll
      for (int j = 0; j < KC_MAX_STAGES; ++j)
        s_a[i][j] = i < tab.stages && j < i ? tab.a[i][j] : 0.0f;
      s_b[i] = i < tab.stages ? tab.b[i] : 0.0f;
    }
  }
  __syncthreads();
  const int warp = threadIdx.x / MB_LANES, lane = threadIdx.x % MB_LANES;
  const int warps = blockDim.x / MB_LANES;
  const int I = d.I, st = tab.stages, ns = st - 1, II = d.O * I;
  const int dm = I / S, n_it = nit[0];
  const MbRec R = mb_rec_layout(d);
  const size_t slab = (size_t)K * R.width;
  float* jbuf = mb_sweep_smem + (size_t)warp * mb_sweep_warp_floats(d, st);
  const bool mine = lane < I;
  const int m = mine ? lane / dm : 0;            // lane q's member
  // 16-byte copies: records, J and the warps' buffers 16-byte aligned
  const bool vec = R.width % 4 == 0 && R.j % 4 == 0 && II % 4 == 0;
  for (int r = warp; r < K; r += warps) {
    const float* rrow = scratch + (size_t)r * R.width;
    // the fill's cotangent: rows i >= the member's final save index were
    // fed its final state
    float xbar = 0.0f, k1bar = 0.0f;
    if (mine) {
      const int sf = mstats[3 * S + m];
      for (int i = sf > 1 ? sf : 1; i < T_save; ++i)
        xbar = xbar + gys[((size_t)i * K + r) * I + lane];
    }
    // iteration it's step, accept flag and save cotangent (cur_*), read
    // an iteration ahead (the save row two ahead), off the recursion
    float cur_dts = 0.0f, cur_acc = 0.0f, cur_g = 0.0f;
    int cur_sx = -1, next_sx = -1;
    if (mine && n_it > 0) {
      const size_t rm = (size_t)(n_it - 1) * S + m;
      cur_dts = rdt[rm];
      cur_acc = racc[rm] ? 1.0f : 0.0f;
      cur_sx = rsx[rm];
      if (cur_sx >= 0) cur_g = gys[((size_t)cur_sx * K + r) * I + lane];
      if (n_it > 1) next_sx = rsx[rm - S];
    }
    if (n_it > 0)
      mb_stage_jacobians(jbuf + ((n_it - 1) & 1) * ns * II, rrow, n_it - 1,
                         ns, II, slab, R.j, vec, lane);
    mb_cp_commit();
    for (int it = n_it - 1; it >= 0; --it) {
      if (it > 0)
        mb_stage_jacobians(jbuf + ((it - 1) & 1) * ns * II, rrow, it - 1, ns,
                           II, slab, R.j, vec, lane);
      mb_cp_commit();
      float nxt_dts = 0.0f, nxt_acc = 0.0f, nxt_g = 0.0f;
      int nxt2_sx = -1;
      if (mine && it > 0) {
        const size_t rm = (size_t)(it - 1) * S + m;
        nxt_dts = rdt[rm];
        nxt_acc = racc[rm] ? 1.0f : 0.0f;
        if (next_sx >= 0) nxt_g = gys[((size_t)next_sx * K + r) * I + lane];
        if (it > 1) nxt2_sx = rsx[rm - S];
      }
      const float* J = jbuf + (it & 1) * ns * II;
      const float dts = cur_dts, acc = cur_acc;
      if (cur_sx >= 0) xbar = xbar + cur_g;
      // stage cotangents from the result (accepted members only) and the
      // FSAL carry-out of the next step's k1, lane q's in registers; have:
      // the stages with one
      const float xm = xbar * acc;
      const float fsal = k1bar * acc;
      float kb[KC_MAX_STAGES];
      unsigned have = 0;
#pragma unroll
      for (int i = 0; i < KC_MAX_STAGES; ++i) {
        kb[i] = 0.0f;
        if (i < st && s_b[i] != 0.0f) {
          have |= 1u << i;
          kb[i] = (dts * s_b[i]) * xm;
        }
        if (i == st - 1) kb[i] = (have >> i) & 1u ? kb[i] + fsal : fsal;
      }
      have |= 1u << (st - 1);
      float xnew = xbar;               // the identity path, every member
      mb_cp_wait<1>();
      __syncwarp();
#pragma unroll
      for (int i = KC_MAX_STAGES - 1; i >= 1; --i) {
        if (i >= st) continue;
        float* gk = scratch + ((size_t)it * ns + i - 1) * slab
                    + (size_t)r * R.width + R.gk;
        if (!((have >> i) & 1u)) {
          if (mine) gk[lane] = 0.0f;
          continue;
        }
        if (mine) gk[lane] = kb[i];
        // dx_q = sum_o J[o][q] kbar_o, kbar_o from lane o, in four
        // partial sums over o mod 4 (a fixed order)
        const float* Ji = J + (i - 1) * II + lane;
        float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;
        for (int o = 0; o < I; o += 4) {
          const float g0 = __shfl_sync(0xffffffffu, kb[i], o);
          const float g1 = __shfl_sync(0xffffffffu, kb[i], o + 1);
          const float g2 = __shfl_sync(0xffffffffu, kb[i], o + 2);
          const float g3 = __shfl_sync(0xffffffffu, kb[i], o + 3);
          if (mine) {
            p0 = p0 + Ji[o * I] * g0;
            if (o + 1 < I) p1 = p1 + Ji[(o + 1) * I] * g1;
            if (o + 2 < I) p2 = p2 + Ji[(o + 2) * I] * g2;
            if (o + 3 < I) p3 = p3 + Ji[(o + 3) * I] * g3;
          }
        }
        const float dxi = (p0 + p1) + (p2 + p3);
        xnew = xnew + dxi;
#pragma unroll
        for (int j = 0; j < KC_MAX_STAGES - 1; ++j) {
          if (j >= i) break;
          const float a = s_a[i][j];
          if (a == 0.0f) continue;
          const float contrib = (dts * a) * dxi;
          kb[j] = (have >> j) & 1u ? kb[j] + contrib : contrib;
          have |= 1u << j;
        }
      }
      // stage 1 is the carried k1: its cotangent goes back an iteration;
      // rejected members pass theirs through
      float kbq = k1bar * (1.0f - acc);
      if (have & 1u) kbq = kbq + kb[0];
      k1bar = kbq;
      xbar = xnew;
      cur_dts = nxt_dts;
      cur_acc = nxt_acc;
      cur_g = nxt_g;
      cur_sx = next_sx;
      next_sx = nxt2_sx;
      __syncwarp();                    // before a copy refills J's buffer
    }
    mb_cp_wait<0>();
    __syncwarp();
    // the very first k1 was f(x0): its VJP from the last slot's record
    const float* r0 = rrow + (size_t)max_steps * ns * slab;
    if (mine)
      scratch[(size_t)max_steps * ns * slab + (size_t)r * R.width + R.gk
              + lane] = k1bar;
    float dxi = 0.0f;
    for (int o = 0; o < I; ++o) {
      const float g = __shfl_sync(0xffffffffu, k1bar, o);
      dxi = dxi + (mine ? r0[R.j + o * I + lane] : 0.0f) * g;
    }
    if (mine)
      dx0[(size_t)r * I + lane] = (xbar + dxi) + gys[(size_t)r * I + lane];
    __syncwarp();
  }
}

// entries of [dc1 ; dw1] a thread of phase C sums (I*(G+1) <= 32*17), and
// the items whose operands it loads ahead of their multiply-adds
#define MB_PARAM_SLOTS ((MB_MAX_I * (KC_MAX_G + 1) + kThreads - 1) / kThreads)
#define MB_BATCH 8

// sum += x with Kahan's compensation c (the file does not reassociate)
__device__ __forceinline__ void mb_kahan_add(float& sum, float& c, float x) {
  const float y = x - c;
  const float t = sum + y;
  c = (t - sum) - y;
  sum = t;
}

// K8b phase C: the parameter cotangents over every recorded evaluation and
// row, each entry summed by one thread in a fixed order (item q = e*K +
// r, e counting the evaluations from the last recorded one back, the
// first f(x0) last: the order a reverse sweep meets them) with Kahan's
// compensation, so that over the ~200 evaluations of a solve the sum's
// own rounding stays below that of a plain f32 sum. Bitwise repeatable,
// no float atomics. Block h < H: dy1_h = sum_o A2[h][o] gk_o of a chunk
// of items into shared memory, then [dc1 ; dw1][j, h] += feat1[j] dy1_h
// by thread j. Blocks from H on: [dc2 ; dw2][j, o] = sum feat2[j] gk_o, a
// thread an entry.
__global__ void __launch_bounds__(kThreads)
members_bwd_params_kernel(const float* scratch, const int* nit, float* dc1,
                          float* dw1, float* dc2, float* dw2, int K,
                          int max_steps, ChainDims d, int stages) {
  __shared__ float s_dy[kThreads];
  __shared__ size_t s_off[kThreads];
  const int I = d.I, H = d.H, O = d.O, G = d.G;
  const int IG = I * G, HG = H * G, J1 = IG + I, J2 = HG + H;
  const MbRec R = mb_rec_layout(d);
  const int ns = stages - 1, n_ev = nit[0] * ns;
  const int items = (n_ev + 1) * K;
  const size_t slab = (size_t)K * R.width;
  const int tid = threadIdx.x;
  if ((int)blockIdx.x < H) {
    const int h = blockIdx.x;
    float acc[MB_PARAM_SLOTS], cmp[MB_PARAM_SLOTS];
#pragma unroll
    for (int s = 0; s < MB_PARAM_SLOTS; ++s) acc[s] = cmp[s] = 0.0f;
    for (int q0 = 0; q0 < items; q0 += kThreads) {
      const int q = q0 + tid;
      if (q < items) {
        const int e = q / K, r = q % K;
        const size_t off =
            (size_t)(e < n_ev ? n_ev - 1 - e : max_steps * ns) * slab
            + (size_t)r * R.width;
        const float* a2 = scratch + off + R.a2 + h * O;
        const float* gk = scratch + off + R.gk;
        float dy = 0.0f;
        for (int o = 0; o < O; ++o) dy += a2[o] * gk[o];
        s_dy[tid] = dy;
        s_off[tid] = off;
      }
      __syncthreads();
      const int nq = items - q0 < kThreads ? items - q0 : kThreads;
      for (int q1 = 0; q1 < nq; q1 += MB_BATCH) {
        float f[MB_BATCH][MB_PARAM_SLOTS];   // the loads go first
#pragma unroll
        for (int u = 0; u < MB_BATCH; ++u) {
          const float* f1 = scratch + s_off[q1 + u < nq ? q1 + u : q1]
                            + R.f1;
#pragma unroll
          for (int s = 0; s < MB_PARAM_SLOTS; ++s) {
            const int j = tid + s * kThreads;
            f[u][s] = j < J1 ? f1[j] : 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < MB_BATCH; ++u) {
          if (q1 + u >= nq) break;
          const float dy = s_dy[q1 + u];
#pragma unroll
          for (int s = 0; s < MB_PARAM_SLOTS; ++s)
            mb_kahan_add(acc[s], cmp[s], f[u][s] * dy);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int s = 0; s < MB_PARAM_SLOTS; ++s) {
      const int j = tid + s * kThreads;
      if (j < IG) dc1[j * H + h] = acc[s];
      else if (j < J1) dw1[(j - IG) * H + h] = acc[s];
    }
    return;
  }
  const int q = (blockIdx.x - H) * kThreads + tid;   // entry of [dc2 ; dw2]
  if (q >= J2 * O) return;
  const int j = q / O, o = q % O;
  float acc = 0.0f, cmp = 0.0f;
  int e = 0, r = 0;                    // item q1's evaluation and row
  for (int q1 = 0; q1 < items; q1 += MB_BATCH) {
    float a[MB_BATCH], b[MB_BATCH];    // the loads go first
#pragma unroll
    for (int u = 0; u < MB_BATCH; ++u) {
      const float* rec =
          scratch + (size_t)(e < n_ev ? n_ev - 1 - e : max_steps * ns) * slab
          + (size_t)r * R.width;
      const bool in = q1 + u < items;
      a[u] = in ? rec[R.f2 + j] : 0.0f;
      b[u] = in ? rec[R.gk + o] : 0.0f;
      if (++r == K) {
        r = 0;
        ++e;
      }
    }
#pragma unroll
    for (int u = 0; u < MB_BATCH; ++u) {
      if (q1 + u >= items) break;
      mb_kahan_add(acc, cmp, a[u] * b[u]);
    }
  }
  if (j < HG) dc2[j * O + o] = acc;
  else dw2[(j - HG) * O + o] = acc;
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
// the largest of the backward's three (phase A's or phase B's; phase C
// takes only static shared memory).
int mb_smem_bytes(const ChainDims* d, int K, int stages, int backward) {
  if (!backward)
    return mb_fwd_layout(*d, K, stages).floats * (int)sizeof(float);
  const int a = mb_rebuild_layout(*d, K, stages).floats;
  const int b =
      mb_sweep_warps(*d, K, stages) * mb_sweep_warp_floats(*d, stages);
  return (a > b ? a : b) * (int)sizeof(float);
}

// K8b's plan (the wrapper's members_bwd_plan computes the same): out =
// [record width, phase A's shared bytes, phase B's warps, phase B's shared
// bytes, phase C's blocks]; returns 0.
int mb_bwd_plan(const ChainDims* d, int K, int stages, int* out) {
  out[0] = mb_rec_layout(*d).width;
  out[1] = mb_rebuild_layout(*d, K, stages).floats * (int)sizeof(float);
  out[2] = mb_sweep_warps(*d, K, stages);
  out[3] = out[2] * mb_sweep_warp_floats(*d, stages) * (int)sizeof(float);
  out[4] = d->H + (d->H * (d->G + 1) * d->O + kThreads - 1) / kThreads;
  return 0;
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

// K8b: three launches on the stream, phase A (a block an iteration, and
// one for the first f(x0)), phase B (one block), phase C (the parameter
// sums). scratch: the records [max_steps * (S-1) + 1][K][mb_rec_layout
// width] (evaluation e = iteration * (S-1) + stage - 1, the first f(x0)
// last).
int mb_adaptive_bwd(const float* x0, const float* c1, const float* w1,
                    const float* c2, const float* w2, const float* rx,
                    const float* rk1, const float* rdt, const int* racc,
                    const int* rsx, const int* mstats, const int* nit,
                    const float* gys, int T_save, float* dx0, float* dc1,
                    float* dw1, float* dc2, float* dw2, float* scratch,
                    int K, int S, int max_steps, const ChainDims* d,
                    const AdaptTab* tab, void* stream) {
  if (tab->stages < 2 || max_steps < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem_a =
      mb_rebuild_layout(*d, K, tab->stages).floats * sizeof(float);
  cudaError_t err = kc_smem_opt_in(members_bwd_rebuild_kernel, smem_a);
  if (err != cudaSuccess) return (int)err;
  members_bwd_rebuild_kernel<<<max_steps + 1, kThreads, smem_a, st>>>(
      x0, c1, w1, c2, w2, rx, rk1, rdt, nit, scratch, K, S, max_steps, *d,
      *tab);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int warps = mb_sweep_warps(*d, K, tab->stages);
  const size_t smem_b =
      (size_t)warps * mb_sweep_warp_floats(*d, tab->stages) * sizeof(float);
  err = kc_smem_opt_in(members_bwd_sweep_kernel, smem_b);
  if (err != cudaSuccess) return (int)err;
  members_bwd_sweep_kernel<<<1, warps * MB_LANES, smem_b, st>>>(
      rdt, racc, rsx, mstats, nit, gys, T_save, dx0, scratch, K, S,
      max_steps, *d, *tab);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks =
      d->H + (d->H * (d->G + 1) * d->O + kThreads - 1) / kThreads;
  members_bwd_params_kernel<<<blocks, kThreads, 0, st>>>(
      scratch, nit, dc1, dw1, dc2, dw2, K, max_steps, *d, tab->stages);
  return (int)cudaGetLastError();
}

}  // extern "C"
