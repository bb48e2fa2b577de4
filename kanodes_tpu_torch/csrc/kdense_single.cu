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
// What it computes. Each input i of a row gives G + 1 features (F = I (G
// + 1) a row): its G basis values B((norm(x_i) - grid_g) / h), then
// swish(x_i); the rows of P = [C; W] pair with them (C's row i G + g, W's
// row i). The layer and its VJP are three products with one operand made
// on the fly:
//   K9f  y [K, O]  = A [K, F] P [F, O]            (A: the rows' features)
//   K9b  M [K, F]  = gy [K, O] P^T,  dx[r, i] from M's G + 1 entries of i:
//                    sum_g M dB/du(u_g) / h * norm'(x) + M_G swish'(x)
//        [dC; dW]  = A^T gy                        (A rebuilt from x)
// The JAX kernel's 0/1 expand/collapse matrices are Mosaic's way to
// reshape; the features are indexed here instead.
//
// What bounds them on this card: latency. At the reference shapes (the
// surrogates' [41 -> 10] to [1024 -> 10] and back, over 1 to 158 rows;
// the 1 -> 1 source layer over 26-1024 rows) a launch is 1e3-2e7 flops on
// at most 450 KB of parameters, under a microsecond of either at the
// card's rates; a block's dependent chain (a global load, the features'
// exps, barriers, the sums) and the copies' issue rate set the time.
//
// What the design does about it: every product is tiled the same way
// (struct K9Role), planned on the host by _cuda.single_plan, which picks
// the least of a cycle count fitted to roles timed on the card
// (experiments/k9_sweep.py). A tile of TM x TN outputs is summed over its
// k range by SK blocks of one thread-block cluster. Each block stages its
// range in chunks of KC, double-buffered: Q's rows by cp.async, or, where
// a chunk is contiguous both in global and in shared memory (whole rows),
// by one bulk (TMA) copy on an mbarrier; P's features made by the block's
// threads once a chunk for the whole output tile. Its threads are NK k
// lanes x NR x NO, each an MR x MO register tile (a kernel instance per
// tile) over every NK-th k of a chunk, summed plainly eight terms at a
// time and then with a compensated (Kahan) sum, so that a long reduction
// stays near the exact sum (the plain f32 version is the one that drifts:
// chip_smoke holds both to float64). The k lanes' partials are summed in
// lane order in shared memory, then the cluster's in rank order through
// distributed shared memory, every rank's load issued first. K9b runs its
// two products (dx's, and the parameter cotangents') as the two halves of
// one kernel's blocks, on one register tile. A fixed order everywhere and
// no atomics, so results repeat bit for bit. Launches go on the caller's
// stream; nothing here allocates or syncs.
//
// Caps: 2 <= G <= KC_MAX_G (ChainDims.grid); the wrapper keeps every
// array's element count under 2^31, and the features I (G + 1) and each
// launch's blocks under 2^22 (k9_div). No other cap on I, O or K.

#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>

#include "kan_chain.cuh"

namespace cg = cooperative_groups;

#define K9_THREADS 256            // threads a block at most
#define K9_MAX_MR 4               // rows of a thread's register tile
#define K9_MAX_MO 4               // columns of it
#define K9_MAX_CLUSTER 8          // blocks a cluster (the portable most)
#define K9_MAX_SMEM (44 * 1024)   // dynamic shared memory a block
#define K9_GROUP 8                // terms summed plainly before (s, c)

// One tiled product out[M, N] = sum_k P[m, k] Q[k, n] (mirrored by
// _cuda.K9Role). Thread t is (kq, mq, nq) = (t / (NO NR), t / NO % NR,
// t % NO): rows mq MR + [0, MR) and columns nq MO + [0, MO) of its tile,
// over k = kq (mod NK) of each chunk. Block b of the role is rank b % SK
// of tile b / SK (tile m-major: m_tiles of TM, n_tiles of TN); its k range
// is [rank KR, rank KR + KR). Chunks of KC k in shared memory, Q copied
// `vec` floats at a time: K9f's and the dB half's k-major, [k][TMp] and
// [k][TNp] (KCp = KC); the dx half's k-minor, [TMp][KCp] and [TNp][KCp]
// (KCp odd: the rows of gy and of [C; W] copied as they lie, read with
// no bank conflict). `bulk`: chunks of whole rows, laid in shared memory
// as in global memory (K9f's and the dB half's Q of one tile of all N
// columns, TNp = TN = N; the dx half's chunks of all O columns, KCp = KC
// = O), so each part of a chunk (C's rows, W's, gy's) is one bulk (TMA)
// copy where its ends are 16-byte aligned.
struct K9Role {
  int MR, NR, MO, NO, NK;
  int TM, TN, TMp, TNp;
  int KC, SK, KR;
  int m_tiles, n_tiles, blocks, vec, KCp, bulk;
};

namespace {

enum { kFwd = 0, kDx = 1, kDb = 2 };

struct K9Args {
  const float* x;    // [K, I]
  const float* gy;   // [K, O] (K9b)
  const float* c;    // [I G, O]
  const float* w;    // [I, O]
  float* y;          // [K, O] (K9f)
  float* dx;         // [K, I]
  float* dc;         // [I G, O]
  float* dw;         // [I, O]
  int K;
};

__host__ __device__ inline int k9_cdiv(int a, int b) { return (a + b - 1) / b; }

// a / b for 0 <= a < 2^22, b >= 1: the fast float quotient is within one
// of the true one there, and one step corrects it. A run-time integer
// division is a long dependent chain; every index here is that small
// (the wrapper caps the features, I (G + 1), below 2^22).
__device__ __forceinline__ int k9_div(int a, int b) {
  const int q = __float2int_rz(__fdividef((float)a, (float)b));
  const int r = a - q * b;
  return q + (r >= b) - (r < 0);
}

// Q's and P's chunks twice (2 KCp TNp floats, then from a 16-byte boundary
// 2 KCp TMp), or the k lanes' partials [NK][TM][TN] in their place; then
// the tile's sums [TM][TN].
__host__ __device__ inline int k9_p_offset(const K9Role& r) {
  return (2 * r.KCp * r.TNp + 3) & ~3;
}

__host__ __device__ inline int k9_region(const K9Role& r) {
  const int ops = k9_p_offset(r) + 2 * r.KCp * r.TMp,
            red = r.NK * r.TM * r.TN;
  return ops > red ? ops : red;
}

// ... then two mbarriers (the chunks' bulk copies), 8-byte aligned.
__host__ __device__ inline int k9_bar_offset(const K9Role& r) {
  return (k9_region(r) + r.TM * r.TN + 1) & ~1;
}

__host__ __device__ inline int k9_smem_floats(const K9Role& r) {
  return k9_bar_offset(r) + 4;
}

__host__ __device__ inline int k9_threads(const K9Role& r) {
  return k9_cdiv(r.NK * r.NR * r.NO, 32) * 32;
}

__device__ __forceinline__ void k9_cp(float* dst, const float* src,
                                      int vec) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (vec == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src) : "memory");
  else if (vec == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src) : "memory");
}

__device__ __forceinline__ void k9_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void k9_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned k9_saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// an mbarrier of one arrival a phase
__device__ __forceinline__ void k9_mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(k9_saddr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// `bytes` of bulk copies to come in the current phase
__device__ __forceinline__ void k9_mbar_expect(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;"
               ::"r"(k9_saddr(bar)), "r"(bytes) : "memory");
}

// the phase's one arrival, after its copies are announced
__device__ __forceinline__ void k9_mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               ::"r"(k9_saddr(bar)) : "memory");
}

__device__ __forceinline__ void k9_mbar_wait(uint64_t* bar,
                                             unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(k9_saddr(bar)), "r"(parity) : "memory");
  }
}

// global -> shared, `bytes` a multiple of 16 and both ends 16-byte
// aligned; completion counted on `bar`
__device__ __forceinline__ void k9_bulk(float* dst, const float* src,
                                        unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(k9_saddr(dst)), "l"(src), "r"(bytes), "r"(k9_saddr(bar))
      : "memory");
}

// Compensated (Kahan) summation: s + x into (s, c), the sum being s - c.
// nvcc keeps the order of these operations (no fast-math), so the low
// part that s loses is carried in c.
__device__ __forceinline__ void k9_add(float& s, float& c, float x) {
  const float y = x - c, t = s + y;
  c = (t - s) - y;
  s = t;
}


// The G rbf values of one input value x at dst + g * stride, its swish at
// *sw (the basis is rbf whatever ChainDims.basis says, as the JAX kernel).
// The grid is indexed only by unrolled constants: a run-time index into a
// kernel parameter sends every access to it through memory.
__device__ __forceinline__ void k9_features(float x, const ChainDims& d,
                                            float* dst, int stride,
                                            float* sw) {
  const float xn = kc_norm(x, d.normalizer);
#pragma unroll
  for (int g = 0; g < KC_MAX_G; ++g)
    if (g < d.G) {
      const float u = (xn - d.grid[g]) * d.inv_h;
      dst[g * stride] = expf(-(u * u));
    }
  *sw = kc_swish(x);
}

// Rows [0, rows) of a chunk, columns [0, ncols) in copies of `vec` floats
// from row src(r): thread t copies column group t % lanes of every
// (T / lanes)-th row from t / lanes.
template <typename Src>
__device__ __forceinline__ void k9_copy_rows(float* dst, int pitch, int rows,
                                             int ncols, int vec, Src src) {
  const int nv = (ncols + vec - 1) >> (vec >> 1), T = blockDim.x,
            t = threadIdx.x;
  const int lanes = min(nv, T), rs = k9_div(T, lanes), r0 = k9_div(t, lanes);
  if (r0 >= rs) return;
  for (int r = r0; r < rows; r += rs) {
    const float* s = src(r);
    for (int v = t - r0 * lanes; v < nv; v += lanes)
      k9_cp(dst + r * pitch + v * vec, s + v * vec, vec);
  }
}

// `rows` rows of `len` floats from src + r * stride to dst + r * pitch:
// with `bulk`, if the rows are contiguous at both ends (pitch = stride =
// len) and start and length are multiples of 16 bytes, one bulk copy on
// `bar` that thread 0 announces and issues (returns true: the caller
// arrives), else cp.async copies of `vec` floats.
__device__ __forceinline__ bool k9_rows(float* dst, int pitch,
                                        const float* src, int stride,
                                        int rows, int len, int vec,
                                        bool bulk, uint64_t* bar) {
  if (rows <= 0) return false;
  const unsigned bytes = 4u * rows * len;
  if (bulk && pitch == len && stride == len
      && (((uintptr_t)src | (uintptr_t)dst | bytes) % 16) == 0) {
    if (threadIdx.x == 0) {
      k9_mbar_expect(bar, bytes);
      k9_bulk(dst, src, bytes, bar);
    }
    return true;
  }
  k9_copy_rows(dst, pitch, rows, len, vec,
               [&](int r) { return src + (size_t)r * stride; });
  return false;
}

// Within a chunk of inputs [i0, i0 + ni) (K9f's k, the other two's tile
// of features), the features are laid C first, then W: entry j < ni G is
// C's row i0 G + j (input i0 + j / G, basis g = j % G), entry ni G + ii is
// W's row i0 + ii. Both parameter parts of a chunk are then contiguous
// rows.

// Issue the copies of chunk [kb, kb + kc): Q (and, for dx, P), the C and
// W parts of a chunk of features each its own rows. Returns whether bulk
// copies on `bar` are part of it (thread 0 has then arrived on `bar`).
template <int ROLE>
__device__ __forceinline__ bool k9_load(const K9Args& a, const ChainDims& d,
                                        const K9Role& R, int m0, int n0,
                                        int kb, int kc, float* Qb,
                                        float* Pb, uint64_t* bar) {
  const int G = d.G, G1 = d.G + 1, I = d.I, O = d.O;
  const bool bulk = R.bulk;
  bool used = false;
  if (ROLE == kFwd) {          // [C; W]'s rows of inputs kb / G1.., cols n0..
    const int i0 = k9_div(kb, G1), ni = k9_div(kc, G1);
    const int nc = min(R.TN, O - n0);
    used |= k9_rows(Qb, R.TNp, a.c + (size_t)i0 * G * O + n0, O, ni * G, nc,
                    R.vec, bulk, bar);
    used |= k9_rows(Qb + ni * G * R.TNp, R.TNp, a.w + (size_t)i0 * O + n0, O,
                    ni, nc, R.vec, bulk, bar);
  } else if (ROLE == kDb) {    // gy's rows kb.., columns n0..
    used |= k9_rows(Qb, R.TNp, a.gy + (size_t)kb * O + n0, O, kc,
                    min(R.TN, O - n0), R.vec, bulk, bar);
  } else {                     // Q[n][k] = [C; W][n][kb + k]; P[m][k] = gy
    const int i0 = k9_div(n0, G1), ti = k9_div(R.TN, G1);
    used |= k9_rows(Qb, R.KCp, a.c + (size_t)i0 * G * O + kb, O,
                    min(ti, I - i0) * G, kc, 1, bulk, bar);
    used |= k9_rows(Qb + ti * G * R.KCp, R.KCp, a.w + (size_t)i0 * O + kb, O,
                    min(ti, I - i0), kc, 1, bulk, bar);
    used |= k9_rows(Pb, R.KCp, a.gy + (size_t)m0 * O + kb, O,
                    min(R.TM, a.K - m0), kc, 1, bulk, bar);
  }
  if (used && threadIdx.x == 0) k9_mbar_arrive(bar);
  return used;
}

// P of chunk [kb, kb + kc) made from x: K9f's features of rows m0.. of
// inputs kb / G1.. ([k][m], consecutive threads on consecutive rows); the
// dB half's of rows kb.. of the tile's inputs m0 / G1.. ([k][m],
// consecutive threads on consecutive inputs).
template <int ROLE>
__device__ __forceinline__ void k9_gen(const K9Args& a, const ChainDims& d,
                                       const K9Role& R, int m0, int kb,
                                       int kc, float* Pb) {
  const int G = d.G, G1 = d.G + 1, I = d.I, T = blockDim.x,
            t = threadIdx.x;
  if (ROLE == kFwd) {
    const int i0 = k9_div(kb, G1), ni = k9_div(kc, G1),
              nm = min(R.TM, a.K - m0);
    const int lanes = min(nm, T), is = k9_div(T, lanes),
              q = k9_div(t, lanes);
    if (q >= is) return;
    for (int ii = q; ii < ni; ii += is)
      for (int m = t - q * lanes; m < nm; m += lanes)
        k9_features(a.x[(size_t)(m0 + m) * I + i0 + ii], d,
                    Pb + ii * G * R.TMp + m, R.TMp,
                    Pb + (ni * G + ii) * R.TMp + m);
  } else if (ROLE == kDb) {
    const int i0 = k9_div(m0, G1), ti = k9_div(R.TM, G1),
              ni = min(ti, I - i0);
    const int lanes = min(ni, T), ks = k9_div(T, lanes),
              q = k9_div(t, lanes);
    if (q >= ks) return;
    for (int k = q; k < kc; k += ks)
      for (int ii = t - q * lanes; ii < ni; ii += lanes)
        k9_features(a.x[(size_t)(kb + k) * I + i0 + ii], d,
                    Pb + k * R.TMp + ii * G, 1, Pb + k * R.TMp + ti * G + ii);
  }
}

template <int N>
__device__ __forceinline__ void k9_ld(const float* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (N == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

// The thread's register tile over the chunk's k = kq (mod NK): rows mq MR
// + [0, MR), columns nq MO + [0, MO), each loaded as one vector from
// k-major chunks; one float at a time from k-minor ones (KMIN).
template <int MR, int MO, bool KMIN>
__device__ __forceinline__ void k9_fma_tile(const float* P, const float* Q,
                                            int kc, int kq, int mq, int nq,
                                            const K9Role& R,
                                            float (&s)[MR][MO],
                                            float (&c)[MR][MO]) {
  const int NK = R.NK, KCp = R.KCp;
  const int pk = KMIN ? 1 : R.TMp, qk = KMIN ? 1 : R.TNp;   // k strides
  const float* p = P + kq * pk + mq * MR * (KMIN ? KCp : 1);
  const float* q = Q + kq * qk + nq * MO * (KMIN ? KCp : 1);
  for (int k = kq; k < kc;) {   // groups of K9_GROUP terms, then (s, c)
    float g[MR][MO];
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int j = 0; j < MO; ++j) g[i][j] = 0.0f;
#pragma unroll 4
    for (int u = 0; u < K9_GROUP && k < kc;
         ++u, k += NK, p += NK * pk, q += NK * qk) {
      float av[MR], bv[MO];
      if constexpr (KMIN) {
#pragma unroll
        for (int i = 0; i < MR; ++i) av[i] = p[i * KCp];
#pragma unroll
        for (int j = 0; j < MO; ++j) bv[j] = q[j * KCp];
      } else {
        k9_ld<MR>(p, av);
        k9_ld<MO>(q, bv);
      }
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int j = 0; j < MO; ++j) g[i][j] = fmaf(av[i], bv[j], g[i][j]);
    }
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int j = 0; j < MO; ++j) k9_add(s[i][j], c[i][j], g[i][j]);
  }
}

// The tile's outputs from the sums `sum(e)` of its entries over the SK
// ranks; rank kr takes every SK-th unit of blockDim.x. The dx half's unit
// is (row, input): its G + 1 sums M give dx.
template <int ROLE, typename Sum>
__device__ __forceinline__ void k9_epilogue(const K9Args& a,
                                            const ChainDims& d,
                                            const K9Role& R, int m0, int n0,
                                            int kr, Sum sum) {
  const int G = d.G, G1 = d.G + 1, I = d.I, O = d.O;
  const int stride = R.SK * blockDim.x, start = kr * blockDim.x + threadIdx.x;
  if (ROLE == kDx) {
    const int ti = k9_div(R.TN, G1), i0 = k9_div(n0, G1);
    const int dm = k9_div(stride, ti), di = stride - dm * ti;
    int m = k9_div(start, ti), ii = start - m * ti;
    for (; m < R.TM; m += dm, ii += di) {
      if (ii >= ti) ii -= ti, ++m;
      if (m >= R.TM) break;
      const int r = m0 + m, i = i0 + ii;
      if (r >= a.K || i >= I) continue;
      const int e = m * R.TN + ii * G;
      float Ms[KC_MAX_G];             // the G sums M first: their loads
#pragma unroll                        // (other ranks' too) issue together
      for (int g = 0; g < KC_MAX_G; ++g) Ms[g] = g < G ? sum(e + g) : 0.0f;
      const float Mw = sum(m * R.TN + ti * G + ii);
      const float x = a.x[(size_t)r * I + i], xn = kc_norm(x, d.normalizer);
      float s = 0.0f, c = 0.0f;
#pragma unroll
      for (int g = 0; g < KC_MAX_G; ++g) {
        if (g >= G) break;
        const float u = (xn - d.grid[g]) * d.inv_h;
        const float B = expf(-(u * u));
        k9_add(s, c, Ms[g] * (-2.0f * u * B) * d.inv_h);
      }
      const float w = Mw * kc_dswish(x);
      a.dx[(size_t)r * I + i] = (s - c) * kc_dnorm(x, d.normalizer) + w;
    }
    return;
  }
  const int ti = k9_div(R.TM, G1), i0 = k9_div(m0, G1);
  const int dm = k9_div(stride, R.TN), dn = stride - dm * R.TN;
  int m = k9_div(start, R.TN), n = start - m * R.TN;
  for (; m < R.TM; m += dm, n += dn) {
    if (n >= R.TN) n -= R.TN, ++m;
    if (m >= R.TM) break;
    const int e = m * R.TN + n, o = n0 + n;
    if (o >= O) continue;
    if (ROLE == kFwd) {
      if (m0 + m < a.K) a.y[(size_t)(m0 + m) * O + o] = sum(e);
    } else if (m < ti * G) {
      if (i0 * G + m < I * G) a.dc[(size_t)(i0 * G + m) * O + o] = sum(e);
    } else if (i0 + m - ti * G < I) {
      a.dw[(size_t)(i0 + m - ti * G) * O + o] = sum(e);
    }
  }
}

// Block b of a role (see K9Role). Every block of a cluster whose role
// splits k (SK > 1) reaches both cluster barriers, idle ones too.
template <int ROLE, int MR, int MO>
__device__ __forceinline__ void k9_role(const K9Args& a, const ChainDims& d,
                                        const K9Role& R, int b,
                                        float* smem) {
  const int G1 = d.G + 1;
  const int M = ROLE == kDb ? d.I * G1 : a.K;
  const int Kt = ROLE == kFwd ? d.I * G1 : (ROLE == kDx ? d.O : a.K);
  const int tile = k9_div(b, R.SK), kr = b - tile * R.SK;
  const bool live = tile < R.m_tiles * R.n_tiles;
  const int nt = k9_div(tile, R.m_tiles);
  const int m0 = (tile - nt * R.m_tiles) * R.TM, n0 = nt * R.TN;
  const int k0 = min(kr * R.KR, Kt), k1 = min(k0 + R.KR, Kt);
  const int t = threadIdx.x, tq = k9_div(t, R.NO), nq = t - tq * R.NO,
            kq = k9_div(tq, R.NR), mq = tq - kq * R.NR;
  const int n_chunks = live && M > m0 ? k9_div(k1 - k0 + R.KC - 1, R.KC) : 0;
  float* Qs = smem;                       // two chunks of KCp TNp
  float* Ps = smem + k9_p_offset(R);      // two chunks of KCp TMp
  float* part = smem + k9_region(R);      // [TM][TN]
  float acc[MR][MO], cmp[MR][MO];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int j = 0; j < MO; ++j) acc[i][j] = cmp[i][j] = 0.0f;

  // the bulk copies' mbarriers, one a buffer, and the phase each awaits
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + k9_bar_offset(R));
  unsigned phase[2] = {0, 0};
  bool pending[2] = {false, false};
  if (R.bulk) {
    if (t == 0) {
      k9_mbar_init(bars);
      k9_mbar_init(bars + 1);
    }
    __syncthreads();
  }
  if (n_chunks > 0) {
    pending[0] = k9_load<ROLE>(a, d, R, m0, n0, k0, min(R.KC, k1 - k0), Qs,
                               Ps, bars);
    k9_commit();
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int kb = k0 + ch * R.KC, kc = min(R.KC, k1 - kb), buf = ch & 1;
    float* Qb = Qs + buf * R.KCp * R.TNp;
    float* Pb = Ps + buf * R.KCp * R.TMp;
    if (ch + 1 < n_chunks) {
      const int kn = kb + R.KC;
      pending[buf ^ 1] = k9_load<ROLE>(
          a, d, R, m0, n0, kn, min(R.KC, k1 - kn),
          Qs + (buf ^ 1) * R.KCp * R.TNp, Ps + (buf ^ 1) * R.KCp * R.TMp,
          bars + (buf ^ 1));
      k9_commit();
      k9_gen<ROLE>(a, d, R, m0, kb, kc, Pb);
      k9_wait<1>();
    } else {
      k9_gen<ROLE>(a, d, R, m0, kb, kc, Pb);
      k9_wait<0>();
    }
    if (pending[buf]) {
      k9_mbar_wait(bars + buf, phase[buf]);
      phase[buf] ^= 1;
    }
    __syncthreads();
    if (kq < R.NK)
      k9_fma_tile<MR, MO, ROLE == kDx>(Pb, Qb, kc, kq, mq, nq, R, acc, cmp);
    __syncthreads();
  }
  // the k lanes' partials (over the chunks' buffers), summed in lane order
  float* red = smem;
  const int TT = R.TM * R.TN;
  if (live && kq < R.NK) {
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int j = 0; j < MO; ++j) {
        const int m = mq * MR + i, n = nq * MO + j;
        if (m < R.TM && n < R.TN)
          red[(kq * R.TM + m) * R.TN + n] = acc[i][j] - cmp[i][j];
      }
  }
  __syncthreads();
  if (live)
    for (int e = t; e < TT; e += blockDim.x) {
      float s = red[e], c = 0.0f;
      for (int q = 1; q < R.NK; ++q) k9_add(s, c, red[q * TT + e]);
      part[e] = s - c;
    }
  if (R.SK > 1) {   // the tile's SK ranks' sums, in rank order
    cg::cluster_group cl = cg::this_cluster();
    const unsigned base = cl.block_rank() - kr;
    // entry e over the ranks: every rank's load issued, then summed
    auto total = [&](int e) {
      float v[K9_MAX_CLUSTER];
#pragma unroll
      for (int j = 0; j < K9_MAX_CLUSTER; ++j)
        v[j] = j < R.SK ? *cl.map_shared_rank(part + e, base + j) : 0.0f;
      float s = v[0], c = 0.0f;
#pragma unroll
      for (int j = 1; j < K9_MAX_CLUSTER; ++j)
        if (j < R.SK) k9_add(s, c, v[j]);
      return s - c;
    };
    cl.sync();
    if (ROLE == kDx) {
      // a dx unit needs G + 1 entries: each rank first totals a contiguous
      // share of the tile's entries into its own (now free) chunk buffers,
      // then the units read each total once from its rank
      float* tot = smem;
      const int share = k9_div(TT + R.SK - 1, R.SK);
      if (live)
        for (int e = kr * share + t; e < min(TT, (kr + 1) * share);
             e += blockDim.x)
          tot[e] = total(e);
      cl.sync();
      if (live)
        k9_epilogue<ROLE>(a, d, R, m0, n0, kr, [&](int e) {
          return *cl.map_shared_rank(tot + e, base + k9_div(e, share));
        });
    } else if (live) {
      k9_epilogue<ROLE>(a, d, R, m0, n0, kr, total);
    }
    cl.sync();   // the ranks' sums stay until every rank has read them
  } else {
    __syncthreads();
    if (live)
      k9_epilogue<ROLE>(a, d, R, m0, n0, kr, [&](int e) { return part[e]; });
  }
}

// One kernel for each register tile MR x MO (each sized to its tile).
template <int MR, int MO>
__global__ void __launch_bounds__(K9_THREADS)
k9_fwd_kernel(K9Args a, ChainDims d, K9Role R) {
  extern __shared__ float4 k9_smem[];
  k9_role<kFwd, MR, MO>(a, d, R, blockIdx.x,
                        reinterpret_cast<float*>(k9_smem));
}

// K9b: blocks [0, Rx.blocks) compute dx, the rest the parameter
// cotangents; each cluster lies in one half. Both halves use one tile.
template <int MR, int MO>
__global__ void __launch_bounds__(K9_THREADS)
k9_bwd_kernel(K9Args a, ChainDims d, K9Role Rx, K9Role Rb) {
  extern __shared__ float4 k9_smem[];
  float* smem = reinterpret_cast<float*>(k9_smem);
  if ((int)blockIdx.x < Rx.blocks)
    k9_role<kDx, MR, MO>(a, d, Rx, blockIdx.x, smem);
  else
    k9_role<kDb, MR, MO>(a, d, Rb, blockIdx.x - Rx.blocks, smem);
}

// The kernel of a register tile MR x MO (each of 1, 2, 4); null otherwise.
#define K9_TILES(K)                                                    \
  switch (MR * 8 + MO) {                                               \
    case 9: return K<1, 1>;                                            \
    case 10: return K<1, 2>;                                           \
    case 12: return K<1, 4>;                                           \
    case 17: return K<2, 1>;                                           \
    case 18: return K<2, 2>;                                           \
    case 20: return K<2, 4>;                                           \
    case 33: return K<4, 1>;                                           \
    case 34: return K<4, 2>;                                           \
    case 36: return K<4, 4>;                                           \
    default: return nullptr;                                           \
  }

using K9FwdKernel = void (*)(K9Args, ChainDims, K9Role);
using K9BwdKernel = void (*)(K9Args, ChainDims, K9Role, K9Role);

K9FwdKernel k9_fwd_pick(int MR, int MO) { K9_TILES(k9_fwd_kernel) }
K9BwdKernel k9_bwd_pick(int MR, int MO) { K9_TILES(k9_bwd_kernel) }

// A role the kernels can run: its fields within the caps and each other,
// whole clusters, the shared memory within K9_MAX_SMEM, a Q row's copies
// (`vec` floats from `base`, O a multiple) aligned; k-major chunks
// (KCp = KC) of 16-byte aligned rows, k-minor ones (`kmin`) of floats.
bool k9_valid(const K9Role& r, int cluster, const ChainDims& d,
              const void* base, bool kmin) {
  if (kmin ? r.KCp < r.KC || r.vec != 1
           : r.KCp != r.KC || r.TMp % r.MR != 0 || r.TNp % r.MO != 0
                 || (!r.bulk && r.TNp % 4 != 0))
    return false;
  if (r.vec > 1 && (d.O % r.vec != 0 || (r.TN % r.vec != 0 && r.n_tiles > 1)
                    || (uintptr_t)base % (4 * r.vec) != 0))
    return false;
  return k9_fwd_pick(r.MR, r.MO) != nullptr
      && r.NR >= 1 && r.NO >= 1 && r.NK >= 1
      && r.NK * r.NR * r.NO <= K9_THREADS && r.TM >= 1 && r.TN >= 1
      && r.TM <= r.NR * r.MR && r.TN <= r.NO * r.MO && r.TMp >= r.NR * r.MR
      && r.TNp >= r.NO * r.MO && (r.vec == 1 || r.vec == 2 || r.vec == 4)
      && r.KC >= 1 && r.SK >= 1 && r.KR >= 1
      && cluster >= 1 && cluster <= K9_MAX_CLUSTER && cluster % r.SK == 0
      && r.blocks >= r.m_tiles * r.n_tiles * r.SK && r.blocks % cluster == 0
      && 4 * k9_smem_floats(r) <= K9_MAX_SMEM;
}

// `blocks` blocks of `threads`, in clusters of `cluster` blocks.
template <typename... Params, typename... Args>
cudaError_t k9_launch(void (*kernel)(Params...), int blocks, int threads,
                      size_t smem, int cluster, cudaStream_t stream,
                      Args... args) {
  cudaError_t err = kc_smem_opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  if (cluster == 1) {
    kernel<<<blocks, threads, smem, stream>>>(args...);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

void kd_caps(int* out) {
  out[0] = K9_THREADS;
  out[1] = K9_MAX_MR;
  out[2] = K9_MAX_MO;
  out[3] = K9_MAX_CLUSTER;
  out[4] = K9_MAX_SMEM;
  out[5] = KC_MAX_G;
}

int kd_smem_bytes(const K9Role* r) { return 4 * k9_smem_floats(*r); }

int kd_single_fwd(const float* x, const float* c, const float* w, float* y,
                  int K, const ChainDims* d, const K9Role* R, int cluster,
                  void* stream) {
  if (!k9_valid(*R, cluster, *d, c, false)
      || !k9_valid(*R, cluster, *d, w, false) || R->SK != cluster)
    return (int)cudaErrorInvalidValue;
  K9Args a = {x, nullptr, c, w, y, nullptr, nullptr, nullptr, K};
  return (int)k9_launch(k9_fwd_pick(R->MR, R->MO), R->blocks, k9_threads(*R),
                        4 * (size_t)k9_smem_floats(*R), cluster,
                        (cudaStream_t)stream, a, *d, *R);
}

int kd_single_bwd(const float* x, const float* gy, const float* c,
                  const float* w, float* dx, float* dc, float* dw, int K,
                  const ChainDims* d, const K9Role* Rx, const K9Role* Rb,
                  int cluster, void* stream) {
  if (!k9_valid(*Rx, cluster, *d, c, true)
      || !k9_valid(*Rb, cluster, *d, gy, false) || Rx->MR != Rb->MR
      || Rx->MO != Rb->MO)
    return (int)cudaErrorInvalidValue;
  K9Args a = {x, gy, c, w, nullptr, dx, dc, dw, K};
  const int threads = std::max(k9_threads(*Rx), k9_threads(*Rb));
  const int smem = std::max(k9_smem_floats(*Rx), k9_smem_floats(*Rb));
  return (int)k9_launch(k9_bwd_pick(Rx->MR, Rx->MO), Rx->blocks + Rb->blocks,
                        threads,
                        4 * (size_t)smem, cluster, (cudaStream_t)stream, a,
                        *d, *Rx, *Rb);
}

}  // extern "C"
