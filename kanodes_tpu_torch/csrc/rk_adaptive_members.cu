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
// is one block of MB_FWD_WARPS warps, the parameters (60 KB at S = 8,
// above the 48 KB default: opted in) in shared memory, each output's
// column of [C ; W] stored as a row. The packed state is too wide for one
// thread a row, so the threads run over the packed width: each output
// (row, column) is a contraction over [basis | swish] x [C ; W] cut into
// the chunks of the one-block forward K8f was (256 threads, mb_matvec),
// each chunk added in order, the chunks added in order. That forward
// spent ~12k cycles an evaluation: features with run-time divisions,
// chunk sums whose loads waited one by one, six barriers (PERF.md, the
// K3f/K8f trace). Now an output's chunks sit in one group of lanes of one
// warp (mb_split), so adding them needs no block barrier; that group then
// forms the next layer's features of the output's value: layer 2's from a
// hidden value, or the next stage's input and its layer-1 features from a
// stage value. An evaluation is two such warp-local phases and two
// barriers. Features and the columns of M are stored chunk by chunk with
// a skew that puts a group's lanes on distinct banks; where each warp has
// one warp-load, a lane keeps its chunk of M in registers for the whole
// solve. Every product and sum, and the stage, error and controller
// arithmetic, is the one-block forward's, so K8f returns its bits.
// Per-member controller state lives in shared memory, member s's
// decisions made by thread s, which sets up the next iteration at once;
// every thread takes the same branches, so barriers and the early exit
// are block-uniform.
//
// The backward (K8b) ran in that one block too, each iteration's six
// rebuilds and six VJPs in turn, half of its time adding every VJP's
// parameter cotangents (PERF.md, the K4f/K8b trace). A recorded
// iteration's rebuild needs nothing of another iteration, so it runs in
// three phases: A, a block per recorded iteration (and one for the first
// f(x0)) rebuilds the stages from K8f's records with the one-block chain
// routine mb_chain (whose bits K8f keeps) and stores per chain evaluation and
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
// the threads of the one-block K8f, whose chunk boundaries K8f keeps;
// K8b's phase A runs kThreads = as many, so its mb_matvec cuts the same
#define MB_CHUNK_THREADS 256
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

// K8f runs MB_FWD_WARPS warps; the chunk boundaries of its output sums
// are those of the one-block forward it replaced, which ran
// MB_CHUNK_THREADS threads (mb_matvec at that blockDim.x, as K8b's phase A
// still runs it).
#define MB_FWD_WARPS 8
#define MB_REG 32     // chunk terms of M a lane keeps in registers

// How K8f splits one layer's output sums out [K, N] = feat [K, J] x M [J,
// N]: each sum in P chunks, P = MB_CHUNK_THREADS / (K N) clamped to [1,
// J], of `chunk` = ceil(J / P) terms, added in order (mb_matvec's
// boundaries); an output's chunks in one warp, in a group of lp = min(P,
// 32) lanes, lane c0 taking chunks c0, c0 + lp, ...; opw = 32 / lp groups
// a warp-load, `slots` warp-loads in all. A row of features, and the
// column of M of one output, is stored chunk by chunk with sk floats after
// each chunk (sk makes chunk + sk odd), row stride rs: the lanes of a group
// then read distinct banks (a chunk of 32 terms put them all in one bank
// otherwise); without the skew (sk = 0) the row is the plain one, rs = J.
struct MbSplit {
  int J, N, KN, P, chunk, lp, opw, slots, sk, rs;
  unsigned mg;  // ceil(2^32 / chunk) (chunk >= 2): j / chunk as a product
};

__host__ __device__ inline MbSplit mb_split(int K, int J, int N, bool skew) {
  MbSplit s;
  s.J = J;
  s.N = N;
  s.KN = K * N;
  const int P = MB_CHUNK_THREADS / s.KN;
  s.P = P < 1 ? 1 : (P > J ? J : P);
  s.chunk = (J + s.P - 1) / s.P;
  s.lp = s.P < MB_LANES ? s.P : MB_LANES;
  s.opw = MB_LANES / s.lp;
  s.slots = (s.KN + s.opw - 1) / s.opw;
  s.sk = skew ? (s.chunk % 2 == 0 ? 1 : 2) : 0;
  s.rs = skew ? s.P * (s.chunk + s.sk) : J;
  s.mg = s.chunk > 1 ? 0xFFFFFFFFu / (unsigned)s.chunk + 1u : 0u;
  return s;
}

// where column j of a row sits in the chunked layout (j / chunk as the
// high word of j * mg, exact while j * chunk < 2^32)
__device__ __forceinline__ int mb_col(const MbSplit& s, int j) {
  if (!s.sk) return j;
  const int c = s.chunk > 1 ? (int)__umulhi((unsigned)j, s.mg) : j;
  return j + c * s.sk;
}

// Shared-memory layout of K8f (offsets in floats): the parameters as
// [c1 ; w1]^T [H][rs1] and [c2 ; w2]^T [O][rs2] (each output's column of
// M as a chunked row), the state, the stage values, the step's result,
// the squared scaled errors, both layers' features [K][rs] and the chunk
// partials.
struct MbFwd {
  int m1, m2, x, k, y1, red, feat1, feat2, part, floats;
};

__host__ __device__ inline MbFwd mb_fwd_layout(const ChainDims& d, int K,
                                               int stages, bool skew) {
  const int KI = K * d.I, J1 = d.I * (d.G + 1), J2 = d.H * (d.G + 1);
  const MbSplit s1 = mb_split(K, J1, d.H, skew);
  const MbSplit s2 = mb_split(K, J2, d.O, skew);
  MbFwd L;
  L.m1 = 0;
  L.m2 = L.m1 + d.H * s1.rs;
  L.x = L.m2 + d.O * s2.rs;
  L.k = L.x + KI;              // stage derivatives; k[0] is the FSAL k1
  L.y1 = L.k + stages * KI;    // the step's result
  L.red = L.y1 + KI;           // squared scaled errors
  L.feat1 = L.red + KI;        // [K][rs1]
  L.feat2 = L.feat1 + K * s1.rs;
  L.part = L.feat2 + K * s2.rs;
  L.floats = L.part + mb_max(s1.KN * s1.P, s2.KN * s2.P);
  return L;
}

// K8f skews its rows where that layout fits MB_MAX_SMEM.
__host__ __device__ inline bool mb_fwd_skew(const ChainDims& d, int K,
                                            int stages) {
  return mb_fwd_layout(d, K, stages, true).floats * 4 <= MB_MAX_SMEM;
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

// Shared-memory layout of phase A (after the staged parameters): the
// one-block chain's buffers (mb_chain: stage vectors, hidden values,
// features, partial sums), A2 [rc, H, O] and A1 [rc, H, I] of a chunk of
// rc rows over the feature and partial-sum buffers (free once the chain is
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

// The one-block chain of K8b's phase A, whose bits K8f keeps: mb_features,
// mb_matvec (at blockDim.x = MB_CHUNK_THREADS), mb_chain.
//
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

// v[0] * m[0] + v[1] * m[1] + ... over n terms, added to 0 in that order
// (mul, then add: the file is built with -fmad=false), as mb_matvec adds
// a chunk; the loads go ahead of the arithmetic eight at a time
__device__ __forceinline__ float mb_dot_in_order(const float* v,
                                                 const float* m, int n) {
  float acc = 0.0f;
  int j = 0;
  for (; j + 8 <= n; j += 8) {
    float a[8], b[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      a[u] = v[j + u];
      b[u] = m[j + u];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) acc += a[u] * b[u];
  }
  for (; j < n; ++j) acc += v[j] * m[j];
  return acc;
}

// p[0] + p[1] + ... + p[n-1], added in that order, the loads eight ahead
__device__ __forceinline__ float mb_sum_in_order(const float* p, int n) {
  float acc = p[0];
  int c = 1;
  for (; c + 8 <= n; c += 8) {
    float a[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) a[u] = p[c + u];
#pragma unroll
    for (int u = 0; u < 8; ++u) acc += a[u];
  }
  for (; c < n; ++c) acc += p[c];
  return acc;
}

// Features q = c0, c0 + step, ... <= G of the value v of unit u of a
// layer with n_in inputs, into its chunked row of features f (split s):
// the basis (column u*G + q, q < G) and the swish (column n_in*G + u), as
// mb_features forms them.
__device__ __forceinline__ void mb_unit_features(float v, int u, int n_in,
                                                 int c0, int step,
                                                 const ChainDims& d,
                                                 const float* grid,
                                                 const MbSplit& s, float* f) {
  const float xn = kc_norm(v, d.normalizer);
  for (int q = c0; q <= d.G; q += step) {
    if (q < d.G)
      f[mb_col(s, u * d.G + q)] = kc_basis((xn - grid[q]) * d.inv_h, d.basis);
    else
      f[mb_col(s, n_in * d.G + u)] = kc_swish(v);
  }
}

// x + (dts a[0]) k[0] + ... + (dts a[ns-1]) k[ns-1] over the nonzero
// a[j] (a row of s_a), added in that order as the one-block K8f formed a
// stage input, with k[j] = ks[j * KI] for j < ns - 1 and k[ns - 1] = kl;
// the loads go first
__device__ __forceinline__ float mb_stage_input(float x, float dts,
                                                const float* a, int ns,
                                                const float* ks, int KI,
                                                float kl) {
  float av[KC_MAX_STAGES - 1], kv[KC_MAX_STAGES - 1];
#pragma unroll
  for (int j = 0; j < KC_MAX_STAGES - 1; ++j) {
    av[j] = j < ns ? a[j] : 0.0f;
    kv[j] = j == ns - 1 ? kl : ks[j * KI];
  }
#pragma unroll
  for (int j = 0; j < KC_MAX_STAGES - 1; ++j)
    if (av[j] != 0.0f) x = x + (dts * av[j]) * kv[j];
  return x;
}

// Whether each warp has one warp-load of split s at most and each lane
// one chunk of at most MB_REG terms: the lanes then keep their chunk of M
// in registers for the whole solve (mb_slice).
__device__ __forceinline__ bool mb_in_registers(const MbSplit& s,
                                                int warps) {
  return s.slots <= warps && s.P <= MB_LANES && s.chunk <= MB_REG;
}

// Lane (g, c0)'s chunk of M^T (Mt [N][s.rs]) for its warp's warp-load,
// zero past the chunk, where mb_in_registers holds (else untouched).
__device__ __forceinline__ void mb_slice(const MbSplit& s, const float* Mt,
                                         bool reg, int warp, int g, int c0,
                                         float (&mr)[MB_REG]) {
  const int o = warp * s.opw + g;
  const bool act = reg && g < s.opw && o < s.KN;
  const int n = act ? o % s.N : 0;
  const int len = act ? min(s.chunk, s.J - c0 * s.chunk) : 0;
  const float* m = Mt + (size_t)n * s.rs + c0 * (s.chunk + s.sk);
#pragma unroll
  for (int u = 0; u < MB_REG; ++u) mr[u] = u < len ? m[u] : 0.0f;
}

// One layer's output sums by the split s (feat [K][s.rs], Mt [N][s.rs], or
// the lane's chunk of M in registers mr where reg): each lane adds its
// chunks, the group's first lane adds the chunks in order, and every lane
// of the group then runs tail(r, n, value, c0) for output (r, n).
// Warp-synchronous: no block barrier inside; (g, c0) is the lane's group
// and place in it.
template <typename Tail>
__device__ inline void mb_layer(const MbSplit& s, const float* feat,
                                const float* Mt, bool reg,
                                const float (&mr)[MB_REG], float* part,
                                int warp, int warps, int lane, int g, int c0,
                                Tail tail) {
  for (int sl = warp; sl < s.slots; sl += warps) {
    const int o = sl * s.opw + g;
    const bool act = g < s.opw && o < s.KN;
    int r = 0, n = o;
    if (act && s.KN != s.N) {
      r = o / s.N;
      n = o - r * s.N;
    }
    if (act && reg) {
      // the warp's one warp-load, the lane's one chunk (c0)
      const int len = min(s.chunk, s.J - c0 * s.chunk);
      const float* f = feat + (size_t)r * s.rs + c0 * (s.chunk + s.sk);
      // every term past the chunk is 0 * 0: adding +0 to a sum begun at
      // +0 changes no bit, and no load leaves the chunk
      float fv[MB_REG];
#pragma unroll
      for (int u = 0; u < MB_REG; ++u) fv[u] = u < len ? f[u] : 0.0f;
      float acc = 0.0f;
#pragma unroll
      for (int u = 0; u < MB_REG; ++u) acc += fv[u] * mr[u];
      part[o * s.P + c0] = acc;
    } else if (act) {
      const float* f = feat + (size_t)r * s.rs;
      const float* m = Mt + (size_t)n * s.rs;
      for (int c = c0; c < s.P; c += s.lp) {
        const int len = min(s.chunk, s.J - c * s.chunk);
        const int off = c * (s.chunk + s.sk);
        part[o * s.P + c] = len > 0 ? mb_dot_in_order(f + off, m + off, len)
                                    : 0.0f;
      }
    }
    __syncwarp();
    float v = 0.0f;
    if (act && c0 == 0) v = mb_sum_in_order(part + o * s.P, s.P);
    v = __shfl_sync(0xffffffffu, v, lane - c0);
    if (act) tail(r, n, v, c0);
    __syncwarp();
  }
}

// Member s's controller set-up for the iteration ahead: the save row, the
// step and whether it hits the save time; its signed step also into
// s_dtc[q] for each of its dm state components q.
__device__ inline void mb_setup(int s, int dm, const float* ts, int T_save,
                                float tdir, const float* s_t,
                                const float* s_dt, const int* s_sidx,
                                int* s_row, float* s_tsave, int* s_hit,
                                float* s_dtu, float* s_dts, float* s_dtc) {
  const int row = min(s_sidx[s], T_save - 1);
  const float t_save = ts[row];
  const float remaining = (t_save - s_t[s]) * tdir;
  const bool hit = s_dt[s] >= remaining;
  const float dt_used = hit ? remaining : s_dt[s];
  s_row[s] = row;
  s_tsave[s] = t_save;
  s_hit[s] = hit;
  s_dtu[s] = dt_used;
  s_dts[s] = tdir * dt_used;
  for (int q = s * dm; q < (s + 1) * dm; ++q) s_dtc[q] = s_dts[s];
}

// K8f: MB_FWD_WARPS warps, one block. An evaluation is two warp-local
// phases, each ending in the block's barrier: layer 1's sums (each
// output's chunks in one warp, mb_split), whose groups then form layer 2's
// features of their hidden value; layer 2's sums, whose groups then form
// the next stage's input and its layer-1 features (or, after the last
// stage, the step's result and error terms). Member s's controller in
// thread s, which also sets up the next iteration right after deciding.
__global__ void __launch_bounds__(MB_FWD_WARPS * MB_LANES)
members_fwd_kernel(const float* x0, const float* ts, int T_save,
                   const float* c1, const float* w1, const float* c2,
                   const float* w2, float* ys, float* rx, float* rk1,
                   float* rdt, int* racc, int* rsx, int* mstats, int* nit,
                   int K, int S, int max_steps, int skew, ChainDims d,
                   AdaptTab tab, AdaptCtrl c) {
  extern __shared__ float smem[];
  const int I = d.I, H = d.H, G = d.G, KI = K * I, dm = I / S;
  const int st = tab.stages, J1 = I * (G + 1), J2 = H * (G + 1);
  const MbFwd L = mb_fwd_layout(d, K, st, skew);
  float* m1 = smem + L.m1;
  float* m2 = smem + L.m2;
  float* x = smem + L.x;
  float* k = smem + L.k;
  float* y1 = smem + L.y1;
  float* red = smem + L.red;
  float* feat1 = smem + L.feat1;
  float* feat2 = smem + L.feat2;
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
  __shared__ int s_row[MB_MAX_MEMBERS], s_srow[MB_MAX_MEMBERS];
  __shared__ float s_dtc[MB_MAX_I];      // s_dts of state component q
  __shared__ int s_all_done;
  __shared__ float s_a[KC_MAX_STAGES][KC_MAX_STAGES];
  __shared__ float s_grid[KC_MAX_G];

  const int tid = threadIdx.x, nt = blockDim.x;
  const float n_blk = (float)(K * dm);
  const int warp = tid / MB_LANES, lane = tid % MB_LANES;
  const int warps = nt / MB_LANES;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < KC_MAX_STAGES; ++i)
#pragma unroll
      for (int j = 0; j < KC_MAX_STAGES; ++j) s_a[i][j] = tab.a[i][j];
#pragma unroll
    for (int g = 0; g < KC_MAX_G; ++g) s_grid[g] = d.grid[g];
  }
  const MbSplit s1 = mb_split(K, J1, H, skew), s2 = mb_split(K, J2, I, skew);
  // the parameters: [c1 ; w1][j, h] at m1 + h*rs1 + col(j), [c2 ; w2][j,
  // o] at m2 + o*rs2 + col(j)
  for (int e = tid; e < J1 * H; e += nt) {
    const int j = e / H, h = e - j * H;
    m1[h * s1.rs + mb_col(s1, j)] = j < I * G ? c1[e] : w1[e - I * G * H];
  }
  for (int e = tid; e < J2 * I; e += nt) {
    const int j = e / I, o = e - j * I;
    m2[o * s2.rs + mb_col(s2, j)] = j < H * G ? c2[e] : w2[e - H * G * I];
  }
  const int g1 = lane / s1.lp, c01 = lane - g1 * s1.lp;
  const int g2 = lane / s2.lp, c02 = lane - g2 * s2.lp;
  const bool reg1 = mb_in_registers(s1, warps);
  const bool reg2 = mb_in_registers(s2, warps);
  const float t0 = ts[0];
  const float tdir = ts[T_save - 1] >= t0 ? 1.0f : -1.0f;
  for (int t = tid; t < KI; t += nt) {
    x[t] = x0[t];
    ys[t] = x0[t];
  }
  __syncthreads();
  float mr1[MB_REG], mr2[MB_REG];
  mb_slice(s1, m1, reg1, warp, g1, c01, mr1);
  mb_slice(s2, m2, reg2, warp, g2, c02, mr2);

  // Layer-1 features of the chain input of every row, by the block: x
  // (stage 0), x + (tdir h0) k1 (stage -1: the initial-dt probe) or the
  // input of stage `stage` >= 1, each formed as K8f's one-block loop
  // formed it.
  auto input_features = [&](int stage) {
    for (int u = tid; u < K * I * (G + 1); u += nt) {
      const int q = u % (G + 1), ri = u / (G + 1);
      const int t = ri, i = ri % I;
      float v = x[t];
      if (stage < 0)
        v = x[t] + (tdir * s_h0[i / dm]) * k[t];
      else if (stage > 0)
        v = mb_stage_input(x[t], s_dtc[i], s_a[stage], stage, k + t, KI,
                           k[(stage - 1) * KI + t]);
      mb_unit_features(v, i, I, q, G + 1, d, s_grid, s1,
                       feat1 + (size_t)(ri / I) * s1.rs);
    }
  };
  // One chain evaluation, its layer-1 features in feat1 (visible to the
  // block): out [K, I] = the chain's value. next >= 1: the groups of layer
  // 2 form stage next's input and its layer-1 features; next == st: the
  // step's result y1 and squared scaled errors red. Ends in __syncthreads.
  auto evaluate = [&](float* out, int next) {
    mb_layer(s1, feat1, m1, reg1, mr1, part, warp, warps, lane, g1, c01,
             [&](int r, int h, float v, int c0) {
               mb_unit_features(v, h, H, c0, s1.lp, d, s_grid, s2,
                                feat2 + (size_t)r * s2.rs);
             });
    __syncthreads();
    mb_layer(s2, feat2, m2, reg2, mr2, part, warp, warps, lane, g2, c02,
             [&](int r, int n, float v, int c0) {
               const int t = r * I + n;
               if (c0 == 0) out[t] = v;
               if (next >= 1 && next < st) {
                 // stage next's input, stage next - 1's value from v (its
                 // store above is this lane's, not yet the group's)
                 const float xv = mb_stage_input(x[t], s_dtc[n], s_a[next],
                                                 next, k + t, KI, v);
                 mb_unit_features(xv, n, I, c0, s2.lp, d, s_grid, s1,
                                  feat1 + (size_t)r * s1.rs);
               } else if (next == st && c0 == 0) {
                 const float dts = s_dtc[n];
                 float acc = x[t], err = 0.0f;
                 for (int i = 0; i < st; ++i) {
                   const float ki = i == st - 1 ? v : k[i * KI + t];
                   if (tab.b[i] != 0.0f) acc = acc + (dts * tab.b[i]) * ki;
                   if (tab.e[i] != 0.0f) err = err + (dts * tab.e[i]) * ki;
                 }
                 y1[t] = acc;
                 const float e =
                     err / (c.atol + c.rtol * fmaxf(fabsf(x[t]), fabsf(acc)));
                 red[t] = e * e;
               }
             });
    __syncthreads();
  };

  input_features(0);
  __syncthreads();
  evaluate(k, 0);                                     // k1 = f(x0)

  if (!c.has_dt0) {
    // integrate._initial_dt_members, every norm over the member's block
    for (int t = tid; t < KI; t += nt) {
      const float v = x[t] / (c.atol + c.rtol * fabsf(x[t]));
      red[t] = v * v;
    }
    __syncthreads();
    if (tid < S) s_h0[tid] = sqrtf(mb_member_sum(red, K, I, dm, tid) /
                                   n_blk);
    __syncthreads();
    for (int t = tid; t < KI; t += nt) {
      const float v = k[t] / (c.atol + c.rtol * fabsf(x[t]));
      red[t] = v * v;
    }
    __syncthreads();
    if (tid < S) {
      const float d0 = s_h0[tid];
      const float d1 =
          sqrtf(mb_member_sum(red, K, I, dm, tid) / n_blk);
      s_d1[tid] = d1;
      s_h0[tid] = (d0 < 1e-5f || d1 < 1e-5f) ? 1e-6f : 0.01f * d0 / d1;
    }
    __syncthreads();
    input_features(-1);
    __syncthreads();
    evaluate(y1, 0);
    for (int t = tid; t < KI; t += nt) {
      const float v = (y1[t] - k[t]) / (c.atol + c.rtol * fabsf(x[t]));
      red[t] = v * v;
    }
    __syncthreads();
    if (tid < S) {
      const float h0 = s_h0[tid];
      const float d2 =
          sqrtf(mb_member_sum(red, K, I, dm, tid) / n_blk) / h0;
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
    mb_setup(tid, dm, ts, T_save, tdir, s_t, s_dt, s_sidx, s_row, s_tsave,
             s_hit, s_dtu, s_dts, s_dtc);
  }
  if (tid == 0) s_all_done = T_save <= 1;
  __syncthreads();

  int n_it = 0;                                // active iterations
  for (int it = 0; it < max_steps; ++it) {
    if (s_all_done) break;                     // block-uniform early exit
    input_features(1);
    __syncthreads();
    for (int i = 1; i < st; ++i) evaluate(k + i * KI, i + 1);
    if (tid < S) {
      const int s = tid;
      const float err_nrm =
          sqrtf(mb_member_sum(red, K, I, dm, s) / n_blk);
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
      s_srow[s] = s_row[s];
      s_nacc[s] += ok;
      s_nrej[s] += !accept && !done;
      s_nitv[s] += !done;
      s_sidx[s] += saved;
      s_done[s] = done || s_sidx[s] >= T_save;
      mb_setup(s, dm, ts, T_save, tdir, s_t, s_dt, s_sidx, s_row, s_tsave,
               s_hit, s_dtu, s_dts, s_dtc);
    }
    __syncthreads();
    const size_t off = (size_t)n_it * KI;
    for (int t = tid; t < KI; t += nt) {
      const int m = (t % I) / dm;
      rx[off + t] = x[t];
      rk1[off + t] = k[t];
      if (s_ok[m]) {
        x[t] = y1[t];
        k[t] = k[(st - 1) * KI + t];             // FSAL: the last stage
      }
      if (s_saved[m]) ys[(size_t)s_srow[m] * KI + t] = y1[t];
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
  for (int e = tid; e < (T_save - 1) * KI; e += nt) {
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
    return mb_fwd_layout(*d, K, stages, mb_fwd_skew(*d, K, stages)).floats
           * (int)sizeof(float);
  const int a = mb_rebuild_layout(*d, K, stages).floats;
  const int b =
      mb_sweep_warps(*d, K, stages) * mb_sweep_warp_floats(*d, stages);
  return (a > b ? a : b) * (int)sizeof(float);
}

// K8f's plan (the wrapper's members_fwd_plan computes the same): out =
// [threads, skew, shared bytes, then per layer P, chunk, lp, opw, slots,
// sk, rs]; returns 0.
int mb_fwd_plan(const ChainDims* d, int K, int stages, int* out) {
  const bool skew = mb_fwd_skew(*d, K, stages);
  out[0] = MB_FWD_WARPS * MB_LANES;
  out[1] = skew;
  out[2] = mb_fwd_layout(*d, K, stages, skew).floats * (int)sizeof(float);
  const MbSplit s[2] = {mb_split(K, d->I * (d->G + 1), d->H, skew),
                        mb_split(K, d->H * (d->G + 1), d->O, skew)};
  for (int l = 0; l < 2; ++l) {
    int* o = out + 3 + 7 * l;
    o[0] = s[l].P;
    o[1] = s[l].chunk;
    o[2] = s[l].lp;
    o[3] = s[l].opw;
    o[4] = s[l].slots;
    o[5] = s[l].sk;
    o[6] = s[l].rs;
  }
  return 0;
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
  const bool skew = mb_fwd_skew(*d, K, tab->stages);
  const size_t smem =
      mb_fwd_layout(*d, K, tab->stages, skew).floats * sizeof(float);
  auto kernel = members_fwd_kernel;
  cudaError_t err = kc_smem_opt_in(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, MB_FWD_WARPS * MB_LANES, smem, (cudaStream_t)stream>>>(
      x0, ts, T_save, c1, w1, c2, w2, ys, rx, rk1, rdt, racc, rsx, mstats,
      nit, K, S, max_steps, skew, *d, *tab, *ctrl);
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
