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
// What the design does about it: one block per launch, the operator, the
// state and the stage values in shared memory. The field is cut into TT x TT
// tiles of nodes (GrayTab.tile, chosen on the host by gray_plan in
// ops/graybox_fused.py: TT = 2 for a 2-D field of even side up to 32, else
// 1), and four lanes of a warp share a tile (one lane where four a tile would
// not fit 1024 threads, as for 64 rows of 26 nodes): each sums a quarter of
// the operator's terms, and the four partials are summed in lane order by an
// xor butterfly that leaves the same bits in every lane. On the 2-D field a
// tile's rows are i = ti + a n/TT and its columns j = tj + b n/TT, and every
// field and the operator are kept with a row stride of n + 1, so a term reads
// TT values of a row of lap, TT of a row of U and TT of two columns, each a
// conflict-free shared load: half the loads per multiply-add of one output
// per thread (traced, a one-output-per-thread product took 39% of K5b's time
// at [32, 32]), over 1024 threads. Then each lane owns one node of a 2-D
// tile, and on a single-node tile (the 1-D rows) the four lanes take phi's
// four chains of grid terms (g mod 4), summed in order: the one-warp 1-D
// launch waits on a quarter of each chain. A node's lane alone writes it, so
// the only barrier of a stage evaluation is the one before the operator
// product, which reads the whole field. The forward and the backward's
// rebuild run the same stage routine (gb_stages). The backward turns the ks
// buffers into the stage cotangents kbar and runs the reverse sweep of
// _gb_bwd_kernel; dC[g] and dW are folded into it: the lane that evaluates
// B_g(us) for dphi/du adds kbar B_g(us) (and kbar swish(us)) into its own
// running sums (slots in shared memory, over its nodes and the stages, in a
// fixed order), and one fixed-order block reduction (a shuffle tree per warp,
// then the warps in order) ends the launch: no float atomics, so results
// repeat bit for bit. The loops' code is kept short (the tile loop not
// unrolled): a one-warp launch waits on every instruction fetch.
//
// Constants arrive folded on the host in float64 and rounded to float32
// (dt a_ij, dt b_i, the centers, 1/h, D), as the JAX kernel gets them.
// Precision: float32 with expf/tanhf, no fast-math intrinsics.
// Launches go on the caller's stream; nothing here allocates or syncs.
//
// Caps (the wrapper checks them and raises with them in the message):
// nodes (K*N, or n*n with kron) <= GB_MAX_NODES, N <= GB_MAX_N,
// G <= GB_MAX_G. Shared memory (gb_smem_floats): the operator and
// 1 + 2 * needed stages fields of the padded layout, C and W, and in the
// backward each thread's and each warp's G + 1 sums; 59 KB forward and
// 103 KB backward at the 2-D default n = 32 with tsit5, so the kernels opt
// in above the 48 KB default (once per kernel, size and device).

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
  // the launch plan (gray_plan): TT of the tiles, lanes a tile, threads a
  // block
  int tile, lanes, threads;
};

namespace {

// The padded layout of one launch: every field (state, stage input, stage
// value, cotangent) and the operator are [rows, ld] in shared memory.
struct GbGeom {
  int ld;        // row stride: N + 1 with kron (conflict-free columns), N
  int F;         // floats of one field
  int per_dim;   // tiles along each axis of the field (N / TT)
  int items;     // tiles of the field
};

__host__ __device__ inline GbGeom gb_geom(const GrayTab& T) {
  GbGeom g;
  g.ld = T.kron ? T.N + 1 : T.N;
  g.F = (T.kron ? T.N : T.nodes / T.N) * g.ld;
  g.per_dim = T.N / T.tile;
  g.items = T.kron ? g.per_dim * g.per_dim : T.nodes;
  return g;
}

// Shared memory of a launch, in floats: the operator, the state, the
// needed stages' inputs and values, C and W, and (backward) each
// thread's and each warp's G + 1 parameter sums. gray_plan mirrors it.
__host__ __device__ inline size_t gb_smem_floats(const GrayTab& T,
                                                 int backward) {
  const GbGeom g = gb_geom(T);
  size_t f = (size_t)T.N * g.ld + (size_t)g.F * (1 + 2 * T.n_slots) + T.G
             + 1;
  if (backward) f += (size_t)(T.threads + T.threads / 32) * (T.G + 1);
  return f;
}

// A thread's place: tile group grp (LN = GrayTab.lanes consecutive lanes
// of one warp share a tile: 4, or 1 where four lanes a tile would not fit
// a block), its lane q in the group, the group's lane mask, and the
// coordinates (ti0, tj0) of the group's first tile, found once a launch
// (integer division is a long dependent chain, and a one-warp launch
// waits on every one).
struct GbLane {
  int grp, q, n_grp, ti0, tj0;
  unsigned mask;
};

template <int LN>
__device__ __forceinline__ GbLane gb_lane(const GbGeom& g) {
  GbLane L;
  L.grp = threadIdx.x / LN;
  L.q = threadIdx.x % LN;
  L.n_grp = blockDim.x / LN;
  L.ti0 = L.grp / g.per_dim;
  L.tj0 = L.grp % g.per_dim;
  L.mask = ((1u << LN) - 1u) << ((threadIdx.x % 32) & ~(LN - 1));
  return L;
}

// the coordinates of tile `it` (one of the group's tiles it = grp + m
// n_grp), in units of tiles
__device__ __forceinline__ void gb_tile(const GbLane& L, const GbGeom& g,
                                        int it, int& ti, int& tj) {
  if (it == L.grp) {
    ti = L.ti0;
    tj = L.tj0;
  } else {
    ti = it / g.per_dim;
    tj = it % g.per_dim;
  }
}

// Node n = a*TT + b of the tile at (ti, tj): row ti + a*per_dim, column
// tj + b*per_dim; its shared-memory offset and its dense index (row-major
// [rows, N], the layout of the tensors). At TT = 1 without kron the tile
// is one node (per_dim = N, ld = N).
template <int TT>
__device__ __forceinline__ void gb_node(int ti, int tj, int n,
                                        const GrayTab& T, const GbGeom& g,
                                        int& o, int& d) {
  const int i = ti + (n / TT) * g.per_dim, j = tj + (n % TT) * g.per_dim;
  o = i * g.ld + j;
  d = i * T.N + j;
}

// The sum of the group's lanes' values in a fixed order, ((v0 + v1) +
// (v2 + v3)) for four, left in every lane of the group with the same bits
// (an xor butterfly: addition commutes exactly).
template <int LN>
__device__ __forceinline__ float gb_group_sum(float v, unsigned mask) {
  if (LN > 1) v += __shfl_xor_sync(mask, v, 1);
  if (LN > 2) v += __shfl_xor_sync(mask, v, 2);
  return v;
}

// known(x) on the nodes of the tile at (ti, tj): D * (x @ lap) for row
// states, or D * (lap @ X + X @ lap) on the 2-D field, x and lap in the
// padded layout. Lane q sums the terms k of its share of [0, N) (lap's
// row and column and the field's, all conflict-free shared loads), the
// group's partials are summed in lane order, and every lane gets the
// tile's TT x TT values.
template <int TT, int LN>
__device__ __forceinline__ void gb_known_tile(const float* x, const float* A,
                                              int ti, int tj,
                                              const GbLane& L,
                                              const GrayTab& T,
                                              const GbGeom& g,
                                              float (&out)[TT * TT]) {
  const int N = T.N, ld = g.ld, pd = g.per_dim;
  const int kq = (N + LN - 1) / LN;
  const int k0 = L.q * kq, k1 = k0 + kq < N ? k0 + kq : N;
  if (TT > 1 || T.kron) {
    float left[TT * TT], right[TT * TT];
#pragma unroll
    for (int n = 0; n < TT * TT; ++n) left[n] = right[n] = 0.0f;
    for (int k = k0; k < k1; ++k) {
      float ak[TT], xk[TT], xr[TT], ar[TT];
#pragma unroll
      for (int a = 0; a < TT; ++a) {
        ak[a] = A[(ti + a * pd) * ld + k];     // lap[i][k]
        xk[a] = x[(ti + a * pd) * ld + k];     // X[i][k]
      }
#pragma unroll
      for (int b = 0; b < TT; ++b) {
        xr[b] = x[k * ld + tj + b * pd];       // X[k][j]
        ar[b] = A[k * ld + tj + b * pd];       // lap[k][j]
      }
#pragma unroll
      for (int a = 0; a < TT; ++a)
#pragma unroll
        for (int b = 0; b < TT; ++b) {
          left[a * TT + b] += ak[a] * xr[b];
          right[a * TT + b] += xk[a] * ar[b];
        }
    }
#pragma unroll
    for (int n = 0; n < TT * TT; ++n)
      out[n] = T.D * gb_group_sum<LN>(left[n] + right[n], L.mask);
  } else {
    // row ti of the state against column tj of the operator
    const float* row = x + ti * ld;
    float acc = 0.0f;
    for (int k = k0; k < k1; ++k) acc += row[k] * A[k * ld + tj];
    out[0] = T.D * gb_group_sum<LN>(acc, L.mask);
  }
}

__device__ __forceinline__ float gb_z(float un, int g, const GrayTab& T) {
  return (un - T.centers[g]) * T.inv_h;
}

// sum over g = g0, g0 + 4, .. < G of C[g] exp(-z_g^2), in g order: one of
// phi's four chains (`_phi` sums the grid terms; here g mod 4 picks the
// chain, and the chains are summed in order).
__device__ __forceinline__ float gb_phi_chain(float un, int g0,
                                              const float* cw,
                                              const GrayTab& T) {
  float p = 0.0f;
#pragma unroll
  for (int k = 0; k < GB_MAX_G / 4; ++k) {
    const int g = g0 + 4 * k;
    if (g < T.G) {
      const float z = gb_z(un, g, T);
      p += cw[g] * expf(-(z * z));
    }
  }
  return p;
}

// One chain of d phi / dnorm(u) (`_phi_vjp`'s dun), g = g0, g0 + 4, ..,
// adding gy B_g(u) into dp[g] (the dC term; dp: the calling thread's own
// slots in shared memory).
__device__ __forceinline__ float gb_dphi_chain(float un, float gy, int g0,
                                               const float* cw,
                                               const GrayTab& T, float* dp) {
  float p = 0.0f;
#pragma unroll
  for (int k = 0; k < GB_MAX_G / 4; ++k) {
    const int g = g0 + 4 * k;
    if (g < T.G) {
      const float z = gb_z(un, g, T);
      const float b = expf(-(z * z));
      p += cw[g] * (-2.0f * z * T.inv_h) * b;
      dp[g] += gy * b;
    }
  }
  return p;
}

// d phi/du gy from the four chains' sum dun (`_phi_vjp`'s du), adding gy
// swish(u) into dp[G] (the dW term).
__device__ __forceinline__ float gb_dphi_from(float u, float gy, float dun,
                                              const float* cw,
                                              const GrayTab& T, float* dp) {
  dp[T.G] += gy * kc_swish(u);
  return gy * dun * kc_dnorm(u, T.normalizer) + cw[T.G] * gy * kc_dswish(u);
}

// dst[(i / N) * ld + i % N] = src[i] for i < n: eight loads in flight a
// thread, the row and column of i carried from one element to the next
// rather than divided out.
__device__ __forceinline__ void gb_copy_padded(float* dst,
                                               const float* __restrict__ src,
                                               int n, int N, int ld) {
  const int dr = blockDim.x / N, dc = blockDim.x % N;
  int r = threadIdx.x / N, c = threadIdx.x % N;
  for (int i0 = threadIdx.x; i0 < n; i0 += 8 * blockDim.x) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * blockDim.x;
      v[u] = i < n ? src[i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (i0 + u * blockDim.x < n) dst[r * ld + c] = v[u];
      r += dr;
      c += dc;
      if (c >= N) {
        c -= N;
        ++r;
      }
    }
  }
}

// The operator (padded), the state (padded), C and W into shared memory;
// ends in a barrier.
__device__ inline void gb_load(const float* u, const float* lap,
                               const float* c, const float* w, float* s_lap,
                               float* s_u, float* s_cw, const GrayTab& T,
                               const GbGeom& g) {
  gb_copy_padded(s_lap, lap, T.N * T.N, T.N, g.ld);
  gb_copy_padded(s_u, u, T.nodes, T.N, g.ld);
  for (int i = threadIdx.x; i < T.G; i += blockDim.x) s_cw[i] = c[i];
  if (threadIdx.x == 0) s_cw[T.G] = w[0];
  __syncthreads();
}

// v[n] for a lane's node n, by selects (no indexed register array)
template <int TT>
__device__ __forceinline__ float gb_pick(const float (&v)[TT * TT], int n) {
  float r = v[0];
#pragma unroll
  for (int i = 1; i < TT * TT; ++i)
    if (n == i) r = v[i];
  return r;
}

// Every needed stage of the step from the state s_u: stage inputs into
// s_xs [n_slots, F], stage values into s_ks [n_slots, F]. The forward
// and the backward's rebuild. Node n of a tile belongs to lane n of its
// group (at TT = 1: lane 0), which alone writes it. One barrier a stage
// (before the operator reads the stage input of every node). On 2-D
// tiles each lane then evaluates phi of its own node; on single-node
// tiles the four lanes take phi's four chains. On return each lane may
// read its own nodes of s_xs / s_ks.
template <int TT, int LN>
__device__ __forceinline__ void gb_stages(const float* s_u, float* s_xs,
                                          float* s_ks, const float* s_lap,
                                          const float* s_cw, const GrayTab& T,
                                          const GbGeom& g, const GbLane& L) {
  for (int s = 0; s < T.stages; ++s) {
    if (!T.needed[s]) continue;
    float* xs = s_xs + T.slot[s] * g.F;
    float* ks = s_ks + T.slot[s] * g.F;
    if (L.q < TT * TT) {
#pragma unroll 1
      for (int it = L.grp; it < g.items; it += L.n_grp) {
        int ti, tj, o, d;
        gb_tile(L, g, it, ti, tj);
        gb_node<TT>(ti, tj, L.q, T, g, o, d);
        float v = s_u[o];
        for (int j = 0; j < s; ++j) {
          const float a = T.a[s][j];
          if (a == 0.0f || !T.needed[j]) continue;
          v = v + a * s_ks[T.slot[j] * g.F + o];
        }
        xs[o] = v;
      }
    }
    __syncthreads();                 // the stage input is complete
#pragma unroll 1
    for (int it = L.grp; it < g.items; it += L.n_grp) {
      int ti, tj, o, d;
      gb_tile(L, g, it, ti, tj);
      gb_node<TT>(ti, tj, TT > 1 ? L.q : 0, T, g, o, d);
      const float xv = xs[o];
      float kn[TT * TT];
      gb_known_tile<TT, LN>(xs, s_lap, ti, tj, L, T, g, kn);
      const float un = kc_norm(xv, T.normalizer);
      float chains;
      if (TT > 1 || LN == 1) {
        chains = (gb_phi_chain(un, 0, s_cw, T) + gb_phi_chain(un, 1, s_cw, T))
                 + (gb_phi_chain(un, 2, s_cw, T)
                    + gb_phi_chain(un, 3, s_cw, T));
      } else {
        chains = gb_group_sum<LN>(gb_phi_chain(un, L.q, s_cw, T), L.mask);
      }
      const float knv = TT > 1 ? gb_pick<TT>(kn, L.q) : kn[0];
      // phi(u) = W swish(u) + the four chains in order (`_phi`)
      if (TT > 1 || L.q == 0)
        ks[o] = knv + (s_cw[T.G] * kc_swish(xv) + chains);
    }
  }
}

template <int TT, int LN>
__global__ void __launch_bounds__(GB_MAX_THREADS)
gb_fwd_kernel(const float* u, const float* lap, const float* c,
              const float* w, float* y, GrayTab T) {
  extern __shared__ float smem[];
  const GbGeom g = gb_geom(T);
  const GbLane L = gb_lane<LN>(g);
  float* s_lap = smem;                       // [N, ld]
  float* s_u = s_lap + T.N * g.ld;           // [F]
  float* s_xs = s_u + g.F;                   // [n_slots, F] stage inputs
  float* s_ks = s_xs + T.n_slots * g.F;      // [n_slots, F] stage values
  float* s_cw = s_ks + T.n_slots * g.F;      // C[0..G-1], W
  gb_load(u, lap, c, w, s_lap, s_u, s_cw, T, g);
  gb_stages<TT, LN>(s_u, s_xs, s_ks, s_lap, s_cw, T, g, L);
  if (L.q >= TT * TT) return;
#pragma unroll 1
  for (int it = L.grp; it < g.items; it += L.n_grp) {
    int ti, tj, o, d;
    gb_tile(L, g, it, ti, tj);
    gb_node<TT>(ti, tj, L.q, T, g, o, d);
    float acc = s_u[o];
    for (int s = 0; s < T.stages; ++s)
      if (T.b[s] != 0.0f) acc = acc + T.b[s] * s_ks[T.slot[s] * g.F + o];
    y[d] = acc;
  }
}

template <int TT, int LN>
__global__ void __launch_bounds__(GB_MAX_THREADS)
gb_bwd_kernel(const float* u, const float* lap, const float* c,
              const float* w, const float* gy, float* du, float* dc,
              float* dw, GrayTab T) {
  extern __shared__ float smem[];
  const GbGeom g = gb_geom(T);
  const GbLane L = gb_lane<LN>(g);
  const int G = T.G;
  float* s_lap = smem;                       // [N, ld]
  float* s_u = s_lap + T.N * g.ld;           // [F] the state, then ubar
  float* s_us = s_u + g.F;                   // [n_slots, F] stage inputs
  float* s_kb = s_us + T.n_slots * g.F;      // [n_slots, F] ks, then kbar
  float* s_cw = s_kb + T.n_slots * g.F;      // C[0..G-1], W
  float* s_red = s_cw + G + 1;               // [n_warps, G + 1]
  float* dp = s_red + (blockDim.x / 32) * (G + 1)
              + threadIdx.x * (G + 1);       // this thread's dC, dW sums
  for (int q = 0; q <= G; ++q) dp[q] = 0.0f;
  gb_load(u, lap, c, w, s_lap, s_u, s_cw, T, g);
  gb_stages<TT, LN>(s_u, s_us, s_kb, s_lap, s_cw, T, g, L);

  // seeds, on each lane's own nodes (no other lane reads them before the
  // next barrier): ubar = gy over the state, which no stage reads again;
  // kbar_i = (dt b_i) gy (0 where b_i = 0) over the ks
  if (L.q < TT * TT) {
#pragma unroll 1
    for (int it = L.grp; it < g.items; it += L.n_grp) {
      int ti, tj, o, d;
      gb_tile(L, g, it, ti, tj);
      gb_node<TT>(ti, tj, L.q, T, g, o, d);
      const float gv = gy[d];
      s_u[o] = gv;
      for (int s = 0; s < T.stages; ++s)
        if (T.needed[s])
          s_kb[T.slot[s] * g.F + o] = T.b[s] != 0.0f ? T.b[s] * gv : 0.0f;
    }
  }

  // the reverse sweep; dC and dW summed on the fly in each thread's slots
  for (int s = T.stages - 1; s >= 0; --s) {
    if (!T.active[s]) continue;
    const float* kb = s_kb + T.slot[s] * g.F;
    const float* us = s_us + T.slot[s] * g.F;
    __syncthreads();                 // kbar_s is complete
    // du_s = D known(kbar_s) + dphi(us_s)^T kbar_s, into ubar and the
    // cotangents of the earlier stages (each node by its lane)
#pragma unroll 1
    for (int it = L.grp; it < g.items; it += L.n_grp) {
      int ti, tj, o, d;
      gb_tile(L, g, it, ti, tj);
      gb_node<TT>(ti, tj, TT > 1 ? L.q : 0, T, g, o, d);
      const float kv = kb[o], uv = us[o];
      float kn[TT * TT];
      gb_known_tile<TT, LN>(kb, s_lap, ti, tj, L, T, g, kn);
      const float un = kc_norm(uv, T.normalizer);
      float dun;
      if (TT > 1 || LN == 1) {
        dun = (gb_dphi_chain(un, kv, 0, s_cw, T, dp)
               + gb_dphi_chain(un, kv, 1, s_cw, T, dp))
              + (gb_dphi_chain(un, kv, 2, s_cw, T, dp)
                 + gb_dphi_chain(un, kv, 3, s_cw, T, dp));
      } else {
        dun = gb_group_sum<LN>(gb_dphi_chain(un, kv, L.q, s_cw, T, dp),
                               L.mask);
      }
      if (TT > 1 || L.q == 0) {
        const float dui = (TT > 1 ? gb_pick<TT>(kn, L.q) : kn[0])
                          + gb_dphi_from(uv, kv, dun, s_cw, T, dp);
        s_u[o] = s_u[o] + dui;
        for (int j = 0; j < s; ++j) {
          const float a = T.a[s][j];
          if (a == 0.0f || !T.needed[j]) continue;
          float* kj = s_kb + T.slot[j] * g.F;
          kj[o] = kj[o] + a * dui;
        }
      }
    }
  }
  if (L.q < TT * TT) {
#pragma unroll 1
    for (int it = L.grp; it < g.items; it += L.n_grp) {
      int ti, tj, o, d;
      gb_tile(L, g, it, ti, tj);
      gb_node<TT>(ti, tj, L.q, T, g, o, d);
      du[d] = s_u[o];
    }
  }

  // dC[g] and dW: each warp's shuffle tree over its threads' slots, then
  // the warps in order
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  for (int q = 0; q <= G; ++q) {
    float v = dp[q];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) s_red[warp * (G + 1) + q] = v;
  }
  __syncthreads();
  if (threadIdx.x <= G) {
    float v = 0.0f;
    for (int wi = 0; wi < n_warps; ++wi)
      v += s_red[wi * (G + 1) + threadIdx.x];
    if (threadIdx.x < G) dc[threadIdx.x] = v;
    else dw[0] = v;
  }
}

// The plan's tile and threads must be ones the kernels were built for.
bool gb_plan_ok(const GrayTab& T) {
  if (T.threads < 32 || T.threads % 32 || T.threads > GB_MAX_THREADS)
    return false;
  if (T.tile == 2) return T.kron && T.N % 2 == 0 && T.lanes == 4;
  return T.tile == 1 && (T.lanes == 4 || T.lanes == 1);
}

template <typename Kernel, typename... Args>
cudaError_t gb_launch(Kernel kernel, size_t smem, const GrayTab& T,
                      cudaStream_t stream, Args... args) {
  cudaError_t err = kc_smem_opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<1, T.threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

void gb_caps(int* out) {
  out[0] = GB_MAX_NODES;
  out[1] = GB_MAX_N;
  out[2] = GB_MAX_G;
  out[3] = GB_MAX_STAGES;
}

// Dynamic shared memory of the forward (which = 0) and the backward
// (which = 1) for the plan in T, in bytes.
int gb_smem_bytes(const GrayTab* T, int which) {
  return (int)(gb_smem_floats(*T, which) * sizeof(float));
}

int gb_step_fwd(const float* u, const float* lap, const float* c,
                const float* w, float* y, const GrayTab* T, void* stream) {
  if (!gb_plan_ok(*T)) return (int)cudaErrorInvalidValue;
  const size_t smem = gb_smem_floats(*T, 0) * sizeof(float);
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(T->tile == 2
      ? gb_launch(gb_fwd_kernel<2, 4>, smem, *T, st, u, lap, c, w, y, *T)
      : T->lanes == 4
      ? gb_launch(gb_fwd_kernel<1, 4>, smem, *T, st, u, lap, c, w, y, *T)
      : gb_launch(gb_fwd_kernel<1, 1>, smem, *T, st, u, lap, c, w, y, *T));
}

int gb_step_bwd(const float* u, const float* lap, const float* c,
                const float* w, const float* gy, float* du, float* dc,
                float* dw, const GrayTab* T, void* stream) {
  if (!gb_plan_ok(*T)) return (int)cudaErrorInvalidValue;
  const size_t smem = gb_smem_floats(*T, 1) * sizeof(float);
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(T->tile == 2
      ? gb_launch(gb_bwd_kernel<2, 4>, smem, *T, st, u, lap, c, w, gy, du,
                  dc, dw, *T)
      : T->lanes == 4
      ? gb_launch(gb_bwd_kernel<1, 4>, smem, *T, st, u, lap, c, w, gy, du,
                  dc, dw, *T)
      : gb_launch(gb_bwd_kernel<1, 1>, smem, *T, st, u, lap, c, w, gy, du,
                  dc, dw, *T));
}

}  // extern "C"
