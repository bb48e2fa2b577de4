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
//   * forward (K7f, K6f): one thread-block CLUSTER of C blocks per state
//     row (C <= 8, chosen on the host by WideSpec.cluster_plan and passed
//     in WideTab), the loop over stages and steps inside the kernel.
//     Block r owns the contiguous column slice [r*W, (r+1)*W) of the
//     padded row (W = Ipad / C, a multiple of 32). At launch it copies its
//     slice of c1p/w1p (its rows) and c2p/w2p (its columns of each of the
//     H*G + H rows) into its shared memory once, with bulk (TMA) copies on
//     an mbarrier, so no stage reads a weight from L2. Every quantity but
//     the H hidden sums of layer 1 is local to a column: per chain
//     evaluation each warp reduces its threads' partial sums in a fixed
//     order (the threads' terms, a shuffle tree, the warps in order) and
//     stores the H sums into the shared memory of EVERY block of the
//     cluster (distributed shared memory, slot `rank`) with st.async,
//     which counts the bytes on the receiver's mbarrier. Each block waits
//     on its own mbarrier and sums the C slots from its own shared memory
//     in rank order. So y1 is bit-identical in every block and a forward
//     repeats bit for bit; no block waits on a remote load, and no
//     cluster-wide barrier (which compiles to a GPU-scope fence and an L1
//     invalidation) runs inside the loop. Each block forms the H*G + H
//     basis values of y1 itself and runs layer 2 for its own columns. The
//     slots and mbarriers are double-buffered by evaluation parity: a
//     block sends evaluation e + 2 only after every block's evaluation
//     e + 1 reached it, so no slot is overwritten before it is read. Threads: Q groups of the slice's
//     real columns; group q takes the layer-1 terms j = q mod Q (grid
//     nodes, then swish) and the layer-2 rows r = q mod Q, summed over q
//     in order. A row at most 128 lanes
//     wide is a cluster of one. Where a slice of the weights does not fit
//     a block's shared memory (large H * G), the same kernel reads them
//     from global memory instead (WideTab.smem_weights = 0).
//   * backward (K7b, K6b): the same cluster of C blocks per row over the
//     same column slices, the weight slice in shared memory where it fits
//     beside the sweep's buffers (WideTab.smem_weights_bwd), sweeps the
//     steps in reverse. Per step each block rebuilds its columns of the
//     stages with K7f's stage loop (wd_cluster_stages, y1 kept), seeds
//     kbar, and runs the stage adjoints in reverse: its partial of the
//     H*G + H sums m2 = kbar . [c2p|w2p]^T over its columns (two threads a
//     row, a rotated column order that keeps the reads conflict-free),
//     pushed into every block with st.async on the same mbarriers as the
//     chain's exchange (one count of exchanges orders both); every block
//     sums the C partials in rank order, forms dy1 = t[h] itself and runs
//     the column-local layer-1 VJP on its columns (Q thread groups over
//     the terms, summed in order). It stores per (step, row, stage) the
//     stage input, the stage cotangent kbar (its columns), y1 and dy1
//     (rank 0) in scratch the wrapper allocates. Why this layout: a
//     per-phase trace of a one-block-per-row sweep put the rebuild at 39%,
//     m2 at 29% and the VJP at 27% of its cycles at Schrodinger K = 7
//     (PERF.md).
//   * parameter cotangents: two further kernels over many blocks turn
//     those records into dc1p/dw1p and dc2p/dw2p. Each thread owns the
//     parameters of one column and sums over the records in record order:
//     a fixed order and no float atomics, so gradients repeat bit for bit.
//   * K10 (K == 1): the step Jacobian is I + U Ds (I - L)^{-1} V with
//     U = [A_1 .. A_S] (A_i = dk_i/dy1, [I, H]), V = [B_1^T; ..; B_S^T]
//     (B_i^T = dy1/dx at stage i, [H, I]) and L_ji = dt a_ji B_j^T A_i
//     strictly block-lower. The factors depend on the stored states only,
//     so phase A builds A_i^T, B_i^T for EVERY step at once, one cluster
//     of C blocks per step over K7f's column slices (the weight slice in
//     shared memory where it fits): it rebuilds the step's stages with
//     K7f's stage loop, so its records are K7b's bit for bit and K10 and
//     K7b differ only in the adjoint itself, and writes the column-local
//     factors of its columns; a second kernel, one block per step, forms
//     the coupling L from them (dots over all columns, one warp each).
//     Phase B is the only serial part, one
//     cluster of C blocks over the same column slices as K7f: per step
//     each block forms a = xbar + gys[s] and its partial of s = a.U (one
//     sum per factor row) on its columns and stores it into every block
//     (st.async on the receiver's mbarrier, as K7f); each block sums the C
//     partials in rank order and solves the block-triangular z (I - L) = s Ds itself, one
//     warp, right-looking (once z_j is final, every earlier stage adds its
//     share z_j L_ji; the same z as s Ds (I + L + .. + L^{S-1}); forming T
//     is a device of the TPU's batched GEMMs), then xbar = a + z V and the
//     stage cotangents kbar_i = dt b_i a + sum_{j>i} dt a_ji z_j B_j^T on
//     its columns, for the parameter kernels above. While warp 0 solves
//     step s, the other warps copy the block's slice of step s-1's A^T
//     and V rows and the step's L into a second shared buffer with
//     cp.async (WideTab.smem_factors; where the two buffers do not fit,
//     the chain reads the factors from global memory).
//
// Constants arrive folded on the host in float64 and rounded to float32
// (dt a_ij, dt b_i, the grid, 1/h), as the JAX kernel gets them.
// Precision: float32 with expf/tanhf, no fast-math intrinsics.
// Launches go on the caller's stream; nothing here allocates or syncs.
//
// Caps (the wrapper checks them and raises with them in the message):
// I <= WD_MAX_I, H <= WD_MAX_H, G <= WD_MAX_G, stages <= WD_MAX_STAGES.
// Shared memory: K7f holds its weight slice (62 KB a block at
// Schrodinger, 122 KB at 2-D Allen-Cahn, all of it included), K7b the
// same slice and its sweep's buffers (71 / 131 KB) and K10's chain two
// factor buffers (96 / 158 KB), so the kernels opt in above the 48 KB
// default (wd_fwd_smem_bytes, wd_bwd_smem_bytes, wd_lr_smem_bytes).

#include <cooperative_groups.h>
#include <stdint.h>

#include <mutex>

#include "kan_chain.cuh"

namespace cg = cooperative_groups;

#define WD_MAX_I 2048
#define WD_MAX_H 16
#define WD_MAX_G 16
#define WD_MAX_STAGES 7
#define WD_MAX_CLUSTER 8
#define WD_SMEM_BYTES 232448     // dynamic shared memory a block may take
#define WD_CLUSTER_THREADS 256   // block size cap of the cluster kernels
#define WD_PARAM_THREADS 128
#define WD_COUPLING_THREADS 1024
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
  // the cluster plan of K7f/K6f, K7b/K6b and K10's chain
  // (WideSpec.cluster_plan): C blocks per row, threads per block, and
  // whether the weight slice (K7f), the double-buffered factor slices (K10)
  // and the weight slice beside the reverse sweep's buffers (K7b; K10's
  // phase A too, where its own buffers leave the room) sit in shared
  // memory
  int cluster, threads, smem_weights, smem_factors, smem_weights_bwd;
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

// ---- Hopper pieces: mbarrier, bulk (TMA) copies, cp.async -----------------

__device__ __forceinline__ unsigned wd_saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// an mbarrier of one arrival per phase (followed by a fence that makes
// the initialisation visible to the cluster)
__device__ __forceinline__ void wd_mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(wd_saddr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// the shared::cluster address of `p` (this block's shared memory) in the
// block of rank `rank`
__device__ __forceinline__ unsigned wd_mapa(const void* p, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(wd_saddr(p)), "r"(rank));
  return out;
}

// store v into another block's shared memory (shared::cluster address),
// counting its 4 bytes on that block's mbarrier `bar`: the receiver waits
// on its own mbarrier, with no cluster-wide barrier or fence
__device__ __forceinline__ void wd_st_async(unsigned addr, float v,
                                            unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
      "[%0], %1, [%2];"
      ::"r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

// one arrival that also announces `bytes` of bulk copies to come
__device__ __forceinline__ void wd_mbar_expect(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(wd_saddr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void wd_mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(wd_saddr(bar)), "r"(parity) : "memory");
  }
}

// global -> this block's shared memory, `bytes` a multiple of 16 and both
// addresses 16-byte aligned; completion is counted on `bar`
__device__ __forceinline__ void wd_bulk_load(float* dst, const float* src,
                                             unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(wd_saddr(dst)), "l"(src), "r"(bytes), "r"(wd_saddr(bar))
      : "memory");
}

__device__ __forceinline__ void wd_cp_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               ::"r"(wd_saddr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void wd_cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void wd_cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// ---- K7f / K6f: one cluster per state row --------------------------------

// A block's view of its column slice [c0, c0 + W) of the weights: layer-1
// term j < G at c1 + j*s1 + c*H (j == G, swish: w1 + c*H), layer-2 row
// r < H*G at c2 + r*s2 + c (r >= H*G: w2 + (r - H*G)*s2 + c). In shared
// memory (s1 = W*H, s2 = W; the layer-2 rows are one array there,
// `rows2`) or, where the slice does not fit, in global memory (s1 =
// Ipad*H, s2 = Ipad).
struct WideSlice {
  const float* c1;
  const float* w1;
  const float* c2;
  const float* w2;
  size_t s1, s2;
  bool rows2;      // w2 follows c2: row r of either at c2 + r*s2
};

// Thread roles of a cluster kernel: Q groups of Wt threads over the W
// columns of the slice (Wt covers the slice's real columns, at most
// min(W, I)); thread (q, col) takes columns col, col + Wt, ..
struct WideRoles {
  int W, c0, Wt, Q, col, q;
};

__device__ __forceinline__ WideRoles wd_roles(const WideTab& T, int rank) {
  WideRoles R;
  R.W = T.Ipad / T.cluster;
  R.c0 = rank * R.W;
  const int real = R.W < T.I ? R.W : T.I;
  R.Wt = ((real + 31) / 32) * 32;
  if (R.Wt > (int)blockDim.x) R.Wt = blockDim.x;
  R.Q = blockDim.x / R.Wt;
  R.col = threadIdx.x % R.Wt;
  R.q = threadIdx.x / R.Wt;
  return R;
}

// sum_h a[h] b[h] over WD_MAX_H (zeros past H) in four chains (h mod
// 4), summed in a fixed order: a quarter of the dependent adds
__device__ __forceinline__ float wd_dot16(const float (&a)[WD_MAX_H],
                                          const float (&b)[WD_MAX_H]) {
  float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < WD_MAX_H; ++h) p[h & 3] += a[h] * b[h];
  return (p[0] + p[1]) + (p[2] + p[3]);
}

// Sum of the C partials x[k * stride] of the cluster's ranks, in rank
// order (all loads issued first): the same bits in every block.
__device__ __forceinline__ float wd_rank_sum(const float* x, int C,
                                             int stride) {
  float v[WD_MAX_CLUSTER];
#pragma unroll
  for (int k = 0; k < WD_MAX_CLUSTER; ++k) v[k] = k < C ? x[k * stride] : 0.0f;
  float y = v[0];
#pragma unroll
  for (int k = 1; k < WD_MAX_CLUSTER; ++k)
    if (k < C) y += v[k];
  return y;
}

// One chain evaluation kout = f(xs) on the block's columns (xs, kout:
// [W], slice-local). Every thread of every block of the cluster calls it
// with the same evaluation count `e`. The block reduces its columns'
// partial hidden sums in a fixed order (the threads' terms, a shuffle
// tree in each warp, the warps in order) and stores them into every block
// of the cluster (s_xch [2, C, H], this block's at its rank) with
// st.async, so each block waits on its own mbarrier (s_xbar [2]) and
// reads its own shared memory. s_part [n_warps, H], s_l2 [Q, W], s_b2
// [H*G + H]; y1_out [H], where not null, gets layer 1's output (readable
// by the block on return). On return thread (0, col) may read its own
// columns of kout.
__device__ __forceinline__ void wd_cluster_chain(const float* xs,
                                                 float* kout, float* y1_out,
                                 const WideSlice& w, const WideTab& T,
                                 const WideRoles& R, int rank, int e,
                                 float* s_part, float* s_l2, float* s_b2,
                                 float* s_xch, uint64_t* s_xbar) {
  const int I = T.I, H = T.H, G = T.G, HG = H * G, C = T.cluster;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  float acc[WD_MAX_H];
#pragma unroll
  for (int h = 0; h < WD_MAX_H; ++h) acc[h] = 0.0f;
  for (int c = R.col; c < R.W && R.c0 + c < I; c += R.Wt) {
    const float v = xs[c];
    const float xn = kc_norm(v, T.normalizer);
    for (int j = R.q; j <= G; j += R.Q) {
      const float coef = j < G
          ? kc_basis((xn - T.grid[j]) * T.inv_h, T.basis) : kc_swish(v);
      const float* wrow = j < G ? w.c1 + j * w.s1 + (size_t)c * H
                                : w.w1 + (size_t)c * H;
      // all H weights first, then the products (zeros past H): straight-
      // line code the scheduler can overlap, no branch per hidden unit
      float wv[WD_MAX_H];
#pragma unroll
      for (int h = 0; h < WD_MAX_H; ++h) wv[h] = h < H ? wrow[h] : 0.0f;
#pragma unroll
      for (int h = 0; h < WD_MAX_H; ++h) acc[h] += coef * wv[h];
    }
  }
  // the warp's shuffle trees for every hidden unit, level by level, so the
  // WD_MAX_H chains interleave (acc is 0 past H)
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int h = 0; h < WD_MAX_H; ++h)
      acc[h] += __shfl_down_sync(0xffffffffu, acc[h], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < WD_MAX_H; ++h)
      if (h < H) s_part[warp * H + h] = acc[h];
  }
  __syncthreads();
  // the block's partial (its warps in order) into slot `rank` of every
  // block's exchange buffer of parity e & 1, counted on that block's
  // mbarrier of the same parity; this block expects C*H floats on its own
  const int par = e & 1;
  float* xch = s_xch + par * C * H;
  uint64_t* bar = s_xbar + par;
  if (threadIdx.x == 0) wd_mbar_expect(bar, (unsigned)(C * H * 4));
  for (int i = threadIdx.x; i < C * H; i += blockDim.x) {
    const int k = i / H, h = i % H;
    float y = 0.0f;
#pragma unroll 8
    for (int wi = 0; wi < n_warps; ++wi) y += s_part[wi * H + h];
    wd_st_async(wd_mapa(xch + rank * H + h, k), y, wd_mapa(bar, k));
  }
  wd_mbar_wait(bar, (e >> 1) & 1);
  // y1[h] = the ranks' partials in rank order, then the basis values and
  // swish of the hidden vector
  for (int t = threadIdx.x; t < HG + H; t += blockDim.x) {
    const int h = t < HG ? t / G : t - HG;
    const float y1 = wd_rank_sum(xch + h, C, H);
    if (t < HG) {
      const float yn = kc_norm(y1, T.normalizer);
      s_b2[t] = kc_basis((yn - T.grid[t % G]) * T.inv_h, T.basis);
    } else {
      s_b2[t] = kc_swish(y1);
      if (y1_out) y1_out[h] = y1;
    }
  }
  __syncthreads();
  // layer 2: thread (q, col) takes the rows r = q, q + Q, .. four at a
  // time (loads first), in four chains summed in order
  const int R2 = HG + H;
  for (int c = R.col; c < R.W && R.c0 + c < I; c += R.Wt) {
    float k4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int r = R.q; r < R2; r += 4 * R.Q) {
      float b[4], wv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int ru = r + u * R.Q;
        b[u] = ru < R2 ? s_b2[ru] : 0.0f;
        if (w.rows2)
          wv[u] = ru < R2 ? w.c2[ru * w.s2 + c] : 0.0f;
        else
          wv[u] = ru < R2 ? (ru < HG ? w.c2[ru * w.s2 + c]
                                     : w.w2[(ru - HG) * w.s2 + c]) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) k4[u] += b[u] * wv[u];
    }
    const float k = (k4[0] + k4[1]) + (k4[2] + k4[3]);
    if (R.Q == 1) kout[c] = k;
    else s_l2[R.q * R.W + c] = k;
  }
  if (R.Q > 1) {
    __syncthreads();
    if (R.q == 0) {
      for (int c = R.col; c < R.W && R.c0 + c < I; c += R.Wt) {
        float k = s_l2[c];
        for (int qq = 1; qq < R.Q; ++qq) k += s_l2[qq * R.W + c];
        kout[c] = k;
      }
    }
  }
}

// The needed stages of one step from the block's slice s_x of the step
// input: stage inputs into s_xs [S, W], stage values into s_ks [S, W]
// and, where y1 is not null, layer 1's outputs into y1 [S, H]. e counts
// the cluster's exchanges so far; returns it after these. Thread (0, col)
// owns its columns of s_x, s_xs and s_ks. K7f's steps and K7b's rebuild.
__device__ __forceinline__ int wd_cluster_stages(
    const WideSlice& w, const WideTab& T, const WideRoles& R, int rank,
    int e, const float* s_x, float* s_xs, float* s_ks, float* y1,
    float* s_part, float* s_l2, float* s_b2, float* s_xch,
    uint64_t* s_xbar) {
  const int I = T.I, W = R.W;
  for (int st = 0; st < T.stages; ++st) {
    if (!T.needed[st]) continue;
    float* xs = s_xs + T.slot[st] * W;
    if (R.q == 0) {
      for (int c = R.col; c < W && R.c0 + c < I; c += R.Wt) {
        float v = s_x[c];
        for (int j = 0; j < st; ++j) {
          const float a = T.a[st][j];
          if (a == 0.0f || !T.needed[j]) continue;
          v = v + a * s_ks[T.slot[j] * W + c];
        }
        xs[c] = v;
      }
    }
    __syncthreads();                 // the stage input is complete
    wd_cluster_chain(xs, s_ks + T.slot[st] * W,
                     y1 ? y1 + T.slot[st] * T.H : nullptr, w, T, R, rank,
                     e++, s_part, s_l2, s_b2, s_xch, s_xbar);
  }
  return e;
}

// The step loop of K7f / K6f over the weight slice w. Inlined once per
// placement of the weights (shared or global memory), so that each copy
// reads them with the loads of that memory: a pointer that may be either
// compiles to generic loads, which cost a shared-memory slice an L2 trip.
__device__ __forceinline__ void wd_fwd_steps(
    const WideSlice& w, float* ys, int K, int n_steps, int row,
    const WideTab& T, const WideRoles& R, int rank, float* s_x,
    float* s_xs, float* s_ks, float* s_part, float* s_l2, float* s_b2,
    float* s_xch, uint64_t* s_xbar) {
  const int I = T.I, Ipad = T.Ipad, W = R.W;
  int e = 0;                           // chain evaluations so far
  for (int s = 0; s < n_steps; ++s) {
    e = wd_cluster_stages(w, T, R, rank, e, s_x, s_xs, s_ks, nullptr,
                          s_part, s_l2, s_b2, s_xch, s_xbar);
    if (R.q == 0) {
      float* y = ys + ((size_t)s * K + row) * Ipad + R.c0;
      for (int c = R.col; c < W; c += R.Wt) {
        if (R.c0 + c >= I) {
          y[c] = 0.0f;
          continue;
        }
        float acc = s_x[c];
        for (int st = 0; st < T.stages; ++st)
          if (T.b[st] != 0.0f) acc = acc + T.b[st] * s_ks[T.slot[st] * W + c];
        s_x[c] = acc;
        y[c] = acc;
      }
    }
  }
}

// The block's weight slice (G + 1 chunks [W, H] of layer 1, then H*G + H
// rows [W] of layer 2: (2G + 2) H W floats) copied into s_w with bulk
// copies counted on s_bar, waited for; returns its view.
__device__ __forceinline__ WideSlice wd_copy_weights(const WideParams& p,
                                                     const WideTab& T,
                                                     const WideRoles& R,
                                                     float* s_w,
                                                     uint64_t* s_bar) {
  const int Ipad = T.Ipad, H = T.H, G = T.G, HG = H * G, W = R.W;
  const size_t n_w1 = (size_t)(G + 1) * W * H;
  const size_t n_w = n_w1 + (size_t)(HG + H) * W;
  if (threadIdx.x == 0) wd_mbar_expect(s_bar, (unsigned)(n_w * 4));
  const int n_copies = G + 1 + HG + H;
  for (int i = threadIdx.x; i < n_copies; i += blockDim.x) {
    if (i <= G) {
      const float* src = i < G ? p.c1p + ((size_t)i * Ipad + R.c0) * H
                               : p.w1p + (size_t)R.c0 * H;
      wd_bulk_load(s_w + (size_t)i * W * H, src, W * H * 4, s_bar);
    } else {
      const int r = i - G - 1;
      const float* src = r < HG ? p.c2p + (size_t)r * Ipad + R.c0
                                : p.w2p + (size_t)(r - HG) * Ipad + R.c0;
      wd_bulk_load(s_w + n_w1 + (size_t)r * W, src, W * 4, s_bar);
    }
  }
  wd_mbar_wait(s_bar, 0);
  return {s_w, s_w + (size_t)G * W * H, s_w + n_w1,
          s_w + n_w1 + (size_t)HG * W, (size_t)W * H, (size_t)W, true};
}

// The block's weight slice where it stays in global memory.
__device__ __forceinline__ WideSlice wd_global_slice(const WideParams& p,
                                                     const WideTab& T,
                                                     const WideRoles& R) {
  return {p.c1p + (size_t)R.c0 * T.H, p.w1p + (size_t)R.c0 * T.H,
          p.c2p + R.c0, p.w2p + R.c0, (size_t)T.Ipad * T.H, (size_t)T.Ipad,
          false};
}

// K7f / K6f: n_steps whole RK steps of row blockIdx.x / C, every post-step
// state written to ys [n_steps, K, Ipad]; block r of the cluster computes
// the columns of its slice.
__global__ void __launch_bounds__(WD_CLUSTER_THREADS)
wd_fwd_kernel(const float* x0, WideParams p, float* ys, int K, int n_steps,
              WideTab T) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int row = blockIdx.x / T.cluster;
  const int I = T.I, Ipad = T.Ipad, H = T.H, G = T.G, HG = H * G;
  const int S = T.n_slots;
  const WideRoles R = wd_roles(T, rank);
  const int W = R.W;
  // 32 bytes of mbarriers: the weight copy, the exchange of each parity
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(smem);
  uint64_t* s_xbar = s_bar + 1;
  float* s_w = smem + 8;
  const size_t n_w1 = (size_t)(G + 1) * W * H;   // c1 chunks, then w1
  const size_t n_w = n_w1 + (size_t)(HG + H) * W;  // c2 rows, then w2
  float* s_x = s_w + (T.smem_weights ? n_w : 0);  // [W] the state
  float* s_xs = s_x + W;                           // [S, W] stage inputs
  float* s_ks = s_xs + S * W;                      // [S, W] stage values
  float* s_l2 = s_ks + S * W;                      // [Q, W]
  float* s_part = s_l2 + R.Q * W;                  // [n_warps, H]
  float* s_b2 = s_part + (blockDim.x / 32) * H;    // [H*G + H]
  float* s_xch = s_b2 + HG + H;                    // [2, C, H]
  if (R.q == 0)
    for (int c = R.col; c < W; c += R.Wt)
      s_x[c] = R.c0 + c < I ? x0[(size_t)row * Ipad + R.c0 + c] : 0.0f;
  if (threadIdx.x == 0)
    for (int i = 0; i < 3; ++i) wd_mbar_init(s_bar + i);
  __syncthreads();
  if (T.smem_weights) {
    const WideSlice w = wd_copy_weights(p, T, R, s_w, s_bar);
    cl.sync();     // every block's mbarriers are ready: partials may land
    wd_fwd_steps(w, ys, K, n_steps, row, T, R, rank, s_x, s_xs, s_ks,
                 s_part, s_l2, s_b2, s_xch, s_xbar);
  } else {
    cl.sync();
    wd_fwd_steps(wd_global_slice(p, T, R), ys, K, n_steps, row, T, R, rank,
                 s_x, s_xs, s_ks, s_part, s_l2, s_b2, s_xch, s_xbar);
  }
  cl.sync();       // no block leaves while another may store into it
}

// Row r < H*G + H of layer 2's weights ([c2p; w2p]) over the block's
// slice.
__device__ __forceinline__ const float* wd_row2(const WideSlice& w, int r,
                                                int HG) {
  if (w.rows2 || r < HG) return w.c2 + r * w.s2;
  return w.w2 + (r - HG) * w.s2;
}

// sum_t kb[c_t] row[c_t] over the positions t in [lo, hi) of the rotated
// column order c_t = (start + t) mod n, in four chains (t mod 4 within
// the run) summed in a fixed order.
__device__ __forceinline__ float wd_rot_dot(const float* kb, const float* row,
                                            int n, int start, int lo,
                                            int hi) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int c = start + lo;
  if (c >= n) c -= n;
  int t = lo;
  for (; t + 4 <= hi; t += 4) {
    float kv[4], wv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      int cu = c + u;
      if (cu >= n) cu -= n;
      kv[u] = kb[cu];
      wv[u] = row[cu];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[u] += kv[u] * wv[u];
    c += 4;
    if (c >= n) c -= n;
  }
  for (; t < hi; ++t) {
    acc[0] += kb[c] * row[c];
    if (++c == n) c = 0;
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// The buffers of K7b's reverse sweep in a block's shared memory (W
// columns, S needed stages, Q thread groups, R2 = H*G + H rows of layer 2).
struct WideBwdBufs {
  float* x;      // [W] the step input
  float* xs;     // [S, W] stage inputs
  float* kb;     // [S, W] stage values, then the stage cotangents kbar
  float* xb;     // [W] the state cotangent xbar
  float* l2;     // [2Q, W] K7f's layer-2 partials; the VJP's group partials
  float* part;   // [n_warps, H]
  float* b2;     // [H*G + H]
  float* xch;    // [2, C, H] the chain's exchange
  float* m2x;    // [2, C, R2] the exchange of m2's partials
  float* tm;     // [R2] m2 times dk/dy1's coefficient of each row
  float* y1;     // [S, H] layer 1's outputs of the step's stages
  float* t;      // [H] dy1 of the stage
  uint64_t* bar;  // [2] the exchanges' mbarriers, by parity
};

// The reverse sweep of K7b / K6b for row `row` over the weight slice w
// (inlined once per placement of the weights, as wd_fwd_steps). Per step
// the block rebuilds its columns of the stages with K7f's stage loop,
// seeds kbar, and per stage in reverse: its partial of m2 = kbar .
// [c2p; w2p]^T over its columns into every block (st.async, as the chain
// exchanges y1), the C partials summed in rank order in every block, dy1 =
// t[h] formed by every block itself, and the layer-1 VJP on its columns.
__device__ __forceinline__ void wd_bwd_steps(
    const WideSlice& w, const float* x0, const float* ys, const float* gys,
    float* dx0, float* XS, float* KB, float* Y1, float* TT, int K,
    int n_steps, int row, const WideTab& T, const WideRoles& R, int rank,
    const WideBwdBufs& B) {
  const int I = T.I, Ipad = T.Ipad, H = T.H, G = T.G, HG = H * G;
  const int R2 = HG + H, C = T.cluster, S = T.n_slots, W = R.W;
  const int Q = R.Q;
  const int ncols = I - R.c0 < W ? (I - R.c0 > 0 ? I - R.c0 : 0) : W;
  int e = 0;                           // the cluster's exchanges so far
  if (R.q == 0)
    for (int c = R.col; c < W; c += R.Wt) B.xb[c] = 0.0f;
  for (int s = n_steps - 1; s >= 0; --s) {
    const float* x_in = (s == 0 ? x0 + (size_t)row * Ipad
                                : ys + ((size_t)(s - 1) * K + row) * Ipad)
                        + R.c0;
    if (R.q == 0)
      for (int c = R.col; c < ncols; c += R.Wt) B.x[c] = x_in[c];
    e = wd_cluster_stages(w, T, R, rank, e, B.x, B.xs, B.kb, B.y1, B.part,
                          B.l2, B.b2, B.xch, B.bar);
    // seeds: a = xbar + gys[s]; kbar_i = (dt b_i) a (0 where b_i = 0),
    // over the ks, each column by its owner
    const float* g_in = gys + ((size_t)s * K + row) * Ipad + R.c0;
    if (R.q == 0) {
      for (int c = R.col; c < ncols; c += R.Wt) {
        const float a = B.xb[c] + g_in[c];
        B.xb[c] = a;
        for (int st = 0; st < T.stages; ++st)
          if (T.needed[st])
            B.kb[T.slot[st] * W + c] = T.b[st] != 0.0f ? T.b[st] * a : 0.0f;
      }
    }
    const size_t r0 = ((size_t)s * K + row) * S;
    for (int st = T.stages - 1; st >= 0; --st) {
      if (!T.needed[st]) continue;
      const int sl = T.slot[st];
      const float* kb = B.kb + sl * W;
      const float* xs = B.xs + sl * W;
      const float* y1 = B.y1 + sl * H;
      __syncthreads();                 // kbar_st is complete
      // this block's partial of m2[r] = kbar . row r of [c2p; w2p] over
      // its columns, in the rotated order of wd_rot_dot from column 2r:
      // where 2 R2 threads fit, threads 2r and 2r + 1 take the first L0
      // and the remaining positions (L0 odd, so the pair and the warp's
      // rows read distinct banks) and the halves are summed in order (a
      // shuffle); else one thread a row. Into slot `rank` of every
      // block's buffer of parity e & 1.
      const int par = e & 1;
      float* m2x = B.m2x + par * C * R2;
      uint64_t* bar = B.bar + par;
      if (threadIdx.x == 0) wd_mbar_expect(bar, (unsigned)(C * R2 * 4));
      if (2 * R2 <= (int)blockDim.x) {
        const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
        const int L0 = (ncols / 2) | 1;
        float v = 0.0f;
        if (r < R2 && ncols > 0)
          v = wd_rot_dot(kb, wd_row2(w, r, HG), ncols, (2 * r) % ncols,
                         half ? (L0 < ncols ? L0 : ncols) : 0,
                         half ? ncols : (L0 < ncols ? L0 : ncols));
        v += __shfl_down_sync(0xffffffffu, v, 1);
        if (r < R2 && half == 0)
          for (int k = 0; k < C; ++k)
            wd_st_async(wd_mapa(m2x + rank * R2 + r, k), v, wd_mapa(bar, k));
      } else {
        for (int r = threadIdx.x; r < R2; r += blockDim.x) {
          const float v = ncols > 0
              ? wd_rot_dot(kb, wd_row2(w, r, HG), ncols, (2 * r) % ncols, 0,
                           ncols)
              : 0.0f;
          for (int k = 0; k < C; ++k)
            wd_st_async(wd_mapa(m2x + rank * R2 + r, k), v, wd_mapa(bar, k));
        }
      }
      wd_mbar_wait(bar, (e >> 1) & 1);
      ++e;
      // m2 = the ranks' partials in rank order, times the row's dk/dy1
      // coefficient: B_g'(u2) / h (then norm'(y1) below), or swish'(y1)
      for (int r = threadIdx.x; r < R2; r += blockDim.x) {
        const float m = wd_rank_sum(m2x + r, C, R2);
        if (r < HG) {
          const float yv = y1[r / G];
          const float u = (kc_norm(yv, T.normalizer) - T.grid[r % G])
                          * T.inv_h;
          B.tm[r] = m * kc_basis_du(u, kc_basis(u, T.basis), T.basis)
                    * T.inv_h;
        } else {
          B.tm[r] = m * kc_dswish(y1[r - HG]);
        }
      }
      __syncthreads();
      for (int h = threadIdx.x; h < H; h += blockDim.x) {
        const float yv = y1[h];
        float acc = 0.0f;
        for (int g = 0; g < G; ++g) acc += B.tm[h * G + g];
        const float t = acc * kc_dnorm(yv, T.normalizer) + B.tm[HG + h];
        B.t[h] = t;
        if (rank == 0) {
          TT[(r0 + sl) * H + h] = t;
          Y1[(r0 + sl) * H + h] = yv;
        }
      }
      __syncthreads();
      // the layer-1 VJP on the block's columns: thread (q, col) takes the
      // terms j = q, q + Q, .. (grid nodes, then swish) of its columns
      float tv[WD_MAX_H];
#pragma unroll
      for (int h = 0; h < WD_MAX_H; ++h) tv[h] = h < H ? B.t[h] : 0.0f;
      for (int c = R.col; c < ncols; c += R.Wt) {
        const float v = xs[c];
        const float xn = kc_norm(v, T.normalizer);
        float pn = 0.0f, pw = 0.0f;
        for (int j = R.q; j <= G; j += Q) {
          const float* wrow = j < G ? w.c1 + j * w.s1 + (size_t)c * H
                                    : w.w1 + (size_t)c * H;
          float wv[WD_MAX_H];
#pragma unroll
          for (int h = 0; h < WD_MAX_H; ++h) wv[h] = h < H ? wrow[h] : 0.0f;
          const float m = wd_dot16(tv, wv);
          if (j < G) {
            const float u = (xn - T.grid[j]) * T.inv_h;
            pn += m * kc_basis_du(u, kc_basis(u, T.basis), T.basis)
                  * T.inv_h;
          } else {
            pw = m;
          }
        }
        B.l2[R.q * W + c] = pn;
        B.l2[(Q + R.q) * W + c] = pw;
      }
      __syncthreads();
      // each column's owner: the groups' partials in order, dx_i into xbar
      // and the earlier stages' kbar, and the records
      if (R.q == 0) {
        for (int c = R.col; c < ncols; c += R.Wt) {
          const float v = xs[c];
          float pn = B.l2[c], pw = B.l2[Q * W + c];
          for (int qq = 1; qq < Q; ++qq) {
            pn += B.l2[qq * W + c];
            pw += B.l2[(Q + qq) * W + c];
          }
          const float dxi = pn * kc_dnorm(v, T.normalizer)
                            + pw * kc_dswish(v);
          XS[(r0 + sl) * I + R.c0 + c] = v;
          KB[(r0 + sl) * I + R.c0 + c] = kb[c];
          B.xb[c] = B.xb[c] + dxi;
          for (int j = 0; j < st; ++j) {
            const float a = T.a[st][j];
            if (a == 0.0f || !T.needed[j]) continue;
            B.kb[T.slot[j] * W + c] = B.kb[T.slot[j] * W + c] + a * dxi;
          }
        }
      }
    }
  }
  if (R.q == 0)
    for (int c = R.col; c < W; c += R.Wt)
      dx0[(size_t)row * Ipad + R.c0 + c] = c < ncols ? B.xb[c] : 0.0f;
}

// K7b / K6b: the reverse sweep of row blockIdx.x / C, one cluster of C
// blocks over the column slices of K7f. Writes dx0 and, per record r =
// (step * K + row) * n_slots + slot, the stage input XS[r] [I], the stage
// cotangent KB[r] [I], y1 Y1[r] [H] and its cotangent TT[r] [H] (rank 0
// writes those two), from which wd_param*_kernel form the parameter
// cotangents.
__global__ void __launch_bounds__(WD_CLUSTER_THREADS)
wd_bwd_kernel(const float* x0, const float* ys, const float* gys,
              WideParams p, float* dx0, float* XS, float* KB, float* Y1,
              float* TT, int K, int n_steps, WideTab T) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int row = blockIdx.x / T.cluster;
  const int H = T.H, G = T.G, HG = H * G, R2 = HG + H, C = T.cluster;
  const int S = T.n_slots;
  const WideRoles R = wd_roles(T, rank);
  const int W = R.W;
  // 32 bytes of mbarriers: the weight copy, the exchange of each parity
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(smem);
  float* s_w = smem + 8;
  const size_t n_w = (size_t)(2 * G + 2) * H * W;
  WideBwdBufs B;
  B.bar = s_bar + 1;
  B.x = s_w + (T.smem_weights_bwd ? n_w : 0);
  B.xs = B.x + W;
  B.kb = B.xs + S * W;
  B.xb = B.kb + S * W;
  B.l2 = B.xb + W;
  B.part = B.l2 + 2 * R.Q * W;
  B.b2 = B.part + (blockDim.x / 32) * H;
  B.xch = B.b2 + HG + H;
  B.m2x = B.xch + 2 * C * H;
  B.tm = B.m2x + 2 * C * R2;
  B.y1 = B.tm + R2;
  B.t = B.y1 + S * H;
  if (threadIdx.x == 0)
    for (int i = 0; i < 3; ++i) wd_mbar_init(s_bar + i);
  __syncthreads();
  if (T.smem_weights_bwd) {
    const WideSlice w = wd_copy_weights(p, T, R, s_w, s_bar);
    cl.sync();     // every block's mbarriers are ready: partials may land
    wd_bwd_steps(w, x0, ys, gys, dx0, XS, KB, Y1, TT, K, n_steps, row, T, R,
                 rank, B);
  } else {
    cl.sync();
    wd_bwd_steps(wd_global_slice(p, T, R), x0, ys, gys, dx0, XS, KB, Y1, TT,
                 K, n_steps, row, T, R, rank, B);
  }
  cl.sync();       // no block leaves while another may store into it
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

// K10 phase A, one cluster per step s (K == 1) over K7f's column slices:
// rebuilds the step's stages with K7f's stage loop (so its records are
// K7b's, bit for bit) and writes, on each block's columns, the record XS
// (Y1 from rank 0) and the factors AT [S*H, I] (rows A_i[:, h]^T) and V
// [S*H, I] (rows of B_i^T) of the step Jacobian I + U Ds (I - L)^{-1} V.
// Inlined once per placement of the weights, as wd_fwd_steps.
__device__ __forceinline__ void wd_lr_factor_steps(
    const WideSlice& w, const float* x0, const float* ys, float* XS,
    float* Y1, float* AT, float* V, int s, const WideTab& T,
    const WideRoles& R, int rank, float* s_x, float* s_xs, float* s_ks,
    float* s_y1, float* s_d2, float* s_part, float* s_l2, float* s_b2,
    float* s_xch, uint64_t* s_xbar) {
  const int I = T.I, Ipad = T.Ipad, H = T.H, G = T.G, G1 = T.G + 1;
  const int HG = H * G, S = T.n_slots, SH = S * H, W = R.W;
  const int ncols = I - R.c0 < W ? (I - R.c0 > 0 ? I - R.c0 : 0) : W;
  const float* x_in = (s == 0 ? x0 : ys + (size_t)(s - 1) * Ipad) + R.c0;
  if (R.q == 0)
    for (int c = R.col; c < ncols; c += R.Wt) s_x[c] = x_in[c];
  wd_cluster_stages(w, T, R, rank, 0, s_x, s_xs, s_ks, s_y1, s_part, s_l2,
                    s_b2, s_xch, s_xbar);
  __syncthreads();      // every column's stage inputs and y1 are in place
  const size_t r0 = (size_t)s * S;
  if (rank == 0)
    for (int i = threadIdx.x; i < SH; i += blockDim.x)
      Y1[r0 * H + i] = s_y1[i];
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
  for (int c = threadIdx.x; c < ncols; c += blockDim.x) {
    const int x = R.c0 + c;
    // A_i[x, h] for every stage: one pass down column x of c2p / w2p
    for (int h = 0; h < H; ++h) {
      float acc[WD_MAX_STAGES];
#pragma unroll
      for (int sl = 0; sl < WD_MAX_STAGES; ++sl) acc[sl] = 0.0f;
      for (int g = 0; g <= G; ++g) {
        const float cv = wd_row2(w, g < G ? h * G + g : HG + h, HG)[c];
#pragma unroll
        for (int sl = 0; sl < WD_MAX_STAGES; ++sl)
          if (sl < S) acc[sl] += cv * s_d2[(sl * H + h) * G1 + g];
      }
#pragma unroll
      for (int sl = 0; sl < WD_MAX_STAGES; ++sl)
        if (sl < S) AT[((r0 + sl) * H + h) * I + x] = acc[sl];
    }
    // B_i^T[h, x] per stage: the column-local layer-1 Jacobian
    for (int sl = 0; sl < S; ++sl) {
      const float v = s_xs[sl * W + c];
      XS[(r0 + sl) * I + x] = v;
      const float xn = kc_norm(v, T.normalizer);
      const float dn = kc_dnorm(v, T.normalizer);
      const float ds = kc_dswish(v);
      float vv[WD_MAX_H];
      const float* wrow = w.w1 + (size_t)c * H;
#pragma unroll
      for (int h = 0; h < WD_MAX_H; ++h) vv[h] = h < H ? ds * wrow[h] : 0.0f;
      for (int g = 0; g < G; ++g) {
        const float u = (xn - T.grid[g]) * T.inv_h;
        const float dB = kc_basis_du(u, kc_basis(u, T.basis), T.basis)
                         * T.inv_h * dn;
        const float* crow = w.c1 + g * w.s1 + (size_t)c * H;
#pragma unroll
        for (int h = 0; h < WD_MAX_H; ++h)
          if (h < H) vv[h] += dB * crow[h];
      }
#pragma unroll
      for (int h = 0; h < WD_MAX_H; ++h)
        if (h < H) V[((r0 + sl) * H + h) * I + x] = vv[h];
    }
  }
}

__global__ void __launch_bounds__(WD_CLUSTER_THREADS)
wd_lr_factor_kernel(const float* x0, const float* ys, WideParams p,
                    float* XS, float* Y1, float* AT, float* V, WideTab T) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int s = blockIdx.x / T.cluster;
  const int H = T.H, G = T.G, C = T.cluster, S = T.n_slots;
  const WideRoles R = wd_roles(T, rank);
  const int W = R.W;
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(smem);
  float* s_w = smem + 8;
  float* s_x = s_w + (T.smem_weights_bwd ? (size_t)(2 * G + 2) * H * W : 0);
  float* s_xs = s_x + W;                       // [S, W]
  float* s_ks = s_xs + S * W;                  // [S, W]
  float* s_l2 = s_ks + S * W;                  // [Q, W]
  float* s_part = s_l2 + R.Q * W;              // [n_warps, H]
  float* s_b2 = s_part + (blockDim.x / 32) * H;  // [H*G + H]
  float* s_xch = s_b2 + H * G + H;             // [2, C, H]
  float* s_y1 = s_xch + 2 * C * H;             // [S, H]
  float* s_d2 = s_y1 + S * H;                  // [S, H, G + 1]
  if (threadIdx.x == 0)
    for (int i = 0; i < 3; ++i) wd_mbar_init(s_bar + i);
  __syncthreads();
  if (T.smem_weights_bwd) {
    const WideSlice w = wd_copy_weights(p, T, R, s_w, s_bar);
    cl.sync();     // every block's mbarriers are ready: partials may land
    wd_lr_factor_steps(w, x0, ys, XS, Y1, AT, V, s, T, R, rank, s_x, s_xs,
                       s_ks, s_y1, s_d2, s_part, s_l2, s_b2, s_xch, s_bar + 1);
  } else {
    cl.sync();
    wd_lr_factor_steps(wd_global_slice(p, T, R), x0, ys, XS, Y1, AT, V, s, T,
                       R, rank, s_x, s_xs, s_ks, s_y1, s_d2, s_part, s_l2,
                       s_b2, s_xch, s_bar + 1);
  }
  cl.sync();       // no block leaves while another may store into it
}

// K10 phase A, the coupling: L [S*H, S*H] of step blockIdx.x from its
// factors in global memory, L[(j, h), (i, h')] = dt a_ji * B_j^T[h, :] .
// A_i[:, h'] for slots j > i (0 elsewhere): one warp per (j, i, h), lanes
// over the columns, one shuffle tree.
__global__ void __launch_bounds__(WD_COUPLING_THREADS)
wd_lr_coupling_kernel(const float* AT, const float* V, float* L, WideTab T) {
  const int I = T.I, H = T.H, S = T.n_slots, SH = S * H;
  const int s = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  int st_of[WD_MAX_STAGES];
  for (int st = 0; st < T.stages; ++st)
    if (T.needed[st]) st_of[T.slot[st]] = st;
  const size_t r0 = (size_t)s * S;
  float* Ls = L + (size_t)s * SH * SH;
  for (int i = threadIdx.x; i < SH * SH; i += blockDim.x) Ls[i] = 0.0f;
  __syncthreads();
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

// K10 phase B, one cluster over the column slices of K7f: the serial
// reverse chain over the steps on the factors of phase A. Writes dx0 and
// the records KB (stage cotangents) and TT (z, the hidden cotangents
// dy1bar; rank 0 writes them). kSmem: the factors are copied into shared
// memory ahead of use (WideTab.smem_factors), else read where they are;
// one instantiation each, so that every load names its memory.
template <bool kSmem>
__global__ void __launch_bounds__(WD_CLUSTER_THREADS)
wd_lr_chain_kernel(const float* gys, const float* AT, const float* V,
                   const float* L, float* dx0, float* KB, float* TT,
                   int n_steps, WideTab T) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int I = T.I, Ipad = T.Ipad, H = T.H, C = T.cluster;
  const int S = T.n_slots, SH = S * T.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const WideRoles R = wd_roles(T, rank);
  const int W = R.W, c0 = R.c0;
  const int n_cols = I - c0 < W ? (I - c0 > 0 ? I - c0 : 0) : W;  // real
  const int NG = blockDim.x / SH;        // column groups of s = a . U
  // a buffer: A^T transposed [W, SH], V [SH, W], L [SH, SH]
  const size_t buf = (size_t)2 * SH * W + (size_t)SH * SH;
  uint64_t* s_xbar = reinterpret_cast<uint64_t*>(smem);  // [2] exchange
  float* s_f = smem + 4;                 // [2, buf] if smem_factors
  float* s_a = s_f + (kSmem ? 2 * buf : 0);   // [W]
  float* s_xb = s_a + W;                               // [W]
  float* s_part = s_xb + W;                            // [NG, SH]
  float* s_xch = s_part + NG * SH;                     // [2, C, SH]
  float* s_z = s_xch + 2 * C * SH;                     // [SH]
  // the tableau by slot: dt b of slot i, dt a between slots j > i
  __shared__ float s_db[WD_MAX_STAGES];
  __shared__ float s_da[WD_MAX_STAGES][WD_MAX_STAGES];
  if (threadIdx.x == 0) {
    int st_of[WD_MAX_STAGES];
    for (int st = 0; st < T.stages; ++st)
      if (T.needed[st]) st_of[T.slot[st]] = st;
    for (int i = 0; i < S; ++i) {
      s_db[i] = T.b[st_of[i]];
      for (int j = 0; j < S; ++j) s_da[j][i] = j > i ? T.a[st_of[j]][st_of[i]]
                                                     : 0.0f;
    }
  }
  // step s's factor slices into buffer s & 1 (cp.async, one group), by
  // the threads of warps first..: A^T transposed so that the dot of
  // s = a . U reads consecutive rows. Element i = r * n_cols + c, walked
  // in strides of nt with (r, c) carried, not divided out per element.
  auto prefetch = [&](int s, int first) {
    const int t0 = threadIdx.x - first * 32, nt = blockDim.x - first * 32;
    float* dst = s_f + (s & 1) * buf;
    const size_t base = (size_t)s * SH * I + c0;
    if (n_cols > 0) {
      const int dr = nt / n_cols, dc = nt % n_cols;
      int r = t0 / n_cols, c = t0 % n_cols;
      for (; r < SH; r += dr, c += dc) {
        if (c >= n_cols) c -= n_cols, ++r;
        if (r >= SH) break;
        wd_cp_async(dst + (size_t)c * SH + r, AT + base + (size_t)r * I + c);
        wd_cp_async(dst + (size_t)SH * W + (size_t)r * W + c,
                    V + base + (size_t)r * I + c);
      }
    }
    const float* Ls = L + (size_t)s * SH * SH;
    for (int i = t0; i < SH * SH; i += nt)
      wd_cp_async(dst + 2 * (size_t)SH * W + i, Ls + i);
    wd_cp_async_commit();
  };
  for (int c = threadIdx.x; c < W; c += blockDim.x) s_xb[c] = 0.0f;
  if (kSmem) prefetch(n_steps - 1, 0);
  if (threadIdx.x == 0)
    for (int i = 0; i < 2; ++i) wd_mbar_init(s_xbar + i);
  // the stage slot of each entry e = lane + 32 i warp 0 owns in the
  // solve (S, i.e. none, past SH)
  int pe[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    pe[i] = lane + 32 * i < SH ? (lane + 32 * i) / H : S;
  cl.sync();       // every block's mbarriers are ready: partials may land
  int done = 0;    // steps so far
  for (int s = n_steps - 1; s >= 0; --s) {
    const size_t r0 = (size_t)s * S;
    // element (r, c) of A^T at at[r * ar + c * ac], of V at vv[r * ld + c]
    const float *at, *vv, *ls;
    size_t ar, ac, ld;
    if (kSmem) {
      wd_cp_async_wait_all();
      at = s_f + (s & 1) * buf;
      vv = at + (size_t)SH * W;
      ls = at + 2 * (size_t)SH * W;
      ar = 1, ac = SH, ld = W;
    } else {
      at = AT + (size_t)s * SH * I + c0;
      vv = V + (size_t)s * SH * I + c0;
      ls = L + (size_t)s * SH * SH;
      ar = I, ac = 1, ld = I;
    }
    for (int c = threadIdx.x; c < n_cols; c += blockDim.x)
      s_a[c] = s_xb[c] + gys[(size_t)s * Ipad + c0 + c];
    __syncthreads();        // step s's factors and a are in place
    // s = a . U over the block's columns: thread (g, r) sums the columns
    // c = g mod NG of row r, then the NG partials in order
    if (threadIdx.x < NG * SH) {
      const int g = threadIdx.x / SH, r = threadIdx.x % SH;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};     // four chains, in order
      for (int c = g; c < n_cols; c += 4 * NG) {
        float av[4], uv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int cu = c + u * NG;
          av[u] = cu < n_cols ? s_a[cu] : 0.0f;
          uv[u] = cu < n_cols ? at[r * ar + cu * ac] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u] += av[u] * uv[u];
      }
      s_part[g * SH + r] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
    __syncthreads();
    // the block's partial into slot `rank` of every block (st.async on
    // the receiver's mbarrier of parity done & 1), as K7f exchanges y1
    const int par = done & 1;
    float* xch = s_xch + par * C * SH;
    uint64_t* bar = s_xbar + par;
    if (threadIdx.x == 0) wd_mbar_expect(bar, (unsigned)(C * SH * 4));
    for (int i = threadIdx.x; i < C * SH; i += blockDim.x) {
      const int k = i / SH, r = i % SH;
      float v = s_part[r];
      for (int g = 1; g < NG; ++g) v += s_part[g * SH + r];
      wd_st_async(wd_mapa(xch + rank * SH + r, k), v, wd_mapa(bar, k));
    }
    wd_mbar_wait(bar, (done >> 1) & 1);
    if (warp == 0) {
      // z (I - L) = s Ds, right-looking from the last stage: lane l owns
      // entries e = l + 32 i; once z of stage pj is final, every earlier
      // entry adds its L-weighted share of it
      float acc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = lane + 32 * i;
        acc[i] = e < SH ? s_db[pe[i]] * wd_rank_sum(xch + e, C, SH) : 0.0f;
      }
      for (int pj = S - 1; pj >= 0; --pj) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (pe[i] == pj) s_z[lane + 32 * i] = acc[i];
        __syncwarp();
        float zj[WD_MAX_H];
#pragma unroll
        for (int h = 0; h < WD_MAX_H; ++h) zj[h] = h < H ? s_z[pj * H + h] : 0.0f;
        const float* lrow = ls + (size_t)pj * H * SH;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = lane + 32 * i;
          if (pe[i] < pj) {
            float lv[WD_MAX_H];
#pragma unroll
            for (int h = 0; h < WD_MAX_H; ++h)
              lv[h] = h < H ? lrow[(size_t)h * SH + e] : 0.0f;
            acc[i] += wd_dot16(zj, lv);
          }
        }
      }
    } else if (kSmem && s > 0) {
      prefetch(s - 1, 1);   // the other warps, while warp 0 solves
    }
    __syncthreads();
    if (rank == 0)
      for (int r = threadIdx.x; r < SH; r += blockDim.x)
        TT[r0 * H + r] = s_z[r];
    // xbar = a + z V and the stage cotangents, column-local
    for (int c = threadIdx.x; c < n_cols; c += blockDim.x) {
      const float a = s_a[c];
      float dxj[WD_MAX_STAGES];
      float xb = a;
#pragma unroll
      for (int pj = 0; pj < WD_MAX_STAGES; ++pj) {
        float d = 0.0f;
        if (pj < S) {
          float vh[WD_MAX_H], zh[WD_MAX_H];
#pragma unroll
          for (int h = 0; h < WD_MAX_H; ++h) {
            vh[h] = h < H ? vv[(size_t)(pj * H + h) * ld + c] : 0.0f;
            zh[h] = h < H ? s_z[pj * H + h] : 0.0f;
          }
          d = wd_dot16(zh, vh);
          xb = xb + d;
        }
        dxj[pj] = d;
      }
      s_xb[c] = xb;
#pragma unroll
      for (int pi = 0; pi < WD_MAX_STAGES; ++pi) {
        if (pi < S) {
          float kb = s_db[pi] * a;
#pragma unroll
          for (int pj = 0; pj < WD_MAX_STAGES; ++pj)
            if (pj > pi && pj < S) kb = kb + s_da[pj][pi] * dxj[pj];
          KB[(r0 + pi) * I + c0 + c] = kb;
        }
      }
    }
    ++done;
  }
  for (int c = threadIdx.x; c < W; c += blockDim.x)
    dx0[c0 + c] = c < n_cols ? s_xb[c] : 0.0f;
  cl.sync();       // no block leaves while another may store into it
}



// Dynamic shared memory of K7f (32 bytes for its mbarriers, the weight
// slice when it sits there, the state slices and small vectors), of K7b
// (the same, with the sweep's slices, the m2 exchange and the stages' y1)
// and of K10's chain (two factor buffers when they sit there, the slices
// of a and xbar, the partials); WideSpec.cluster_plan mirrors all three.
size_t wd_fwd_smem_bytes(const WideTab& T) {
  const size_t W = T.Ipad / T.cluster, H = T.H, G = T.G, C = T.cluster;
  const size_t real = W < (size_t)T.I ? W : (size_t)T.I;
  size_t Wt = ((real + 31) / 32) * 32;
  if (Wt > (size_t)T.threads) Wt = T.threads;
  const size_t Q = T.threads / Wt;
  size_t floats = 8 + (1 + 2 * (size_t)T.n_slots + Q) * W
                  + (T.threads / 32) * H + H * G + H + 2 * C * H;
  if (T.smem_weights) floats += (2 * G + 2) * H * W;
  return floats * sizeof(float);
}

size_t wd_bwd_smem_bytes(const WideTab& T) {
  const size_t W = T.Ipad / T.cluster, H = T.H, G = T.G, C = T.cluster;
  const size_t S = T.n_slots, R2 = H * G + H;
  const size_t real = W < (size_t)T.I ? W : (size_t)T.I;
  size_t Wt = ((real + 31) / 32) * 32;
  if (Wt > (size_t)T.threads) Wt = T.threads;
  const size_t Q = T.threads / Wt;
  size_t floats = 8 + (2 + 2 * S + 2 * Q) * W + (T.threads / 32) * H + R2
                  + 2 * C * H + 2 * C * R2 + R2 + S * H + H;
  if (T.smem_weights_bwd) floats += (2 * G + 2) * H * W;
  return floats * sizeof(float);
}

// K10's phase A: K7f's slices and small vectors, the stages' y1 and the
// dk/dy1 coefficients, and the weight slice where T.smem_weights_bwd.
size_t wd_lr_factor_smem_bytes(const WideTab& T) {
  const size_t W = T.Ipad / T.cluster, H = T.H, G = T.G, C = T.cluster;
  const size_t S = T.n_slots;
  const size_t real = W < (size_t)T.I ? W : (size_t)T.I;
  size_t Wt = ((real + 31) / 32) * 32;
  if (Wt > (size_t)T.threads) Wt = T.threads;
  const size_t Q = T.threads / Wt;
  size_t floats = 8 + (1 + 2 * S + Q) * W + (T.threads / 32) * H + H * G + H
                  + 2 * C * H + S * H + S * H * (G + 1);
  if (T.smem_weights_bwd) floats += (2 * G + 2) * H * W;
  return floats * sizeof(float);
}

size_t wd_lr_smem_bytes(const WideTab& T) {
  const size_t W = T.Ipad / T.cluster, SH = (size_t)T.n_slots * T.H;
  const size_t NG = T.threads / SH;
  size_t floats = 4 + 2 * W + NG * SH + 2 * (size_t)T.cluster * SH + SH;
  if (T.smem_factors) floats += 2 * (2 * SH * W + SH * SH);
  return floats * sizeof(float);
}

// Whether one cluster of `kernel` at this shared memory, cluster size and
// block size can be resident (cudaOccupancyMaxActiveClusters), asked once
// per configuration: the query costs host time on every launch otherwise.
cudaError_t wd_cluster_fits(const void* kernel, const cudaLaunchConfig_t& cfg,
                            int cluster) {
  struct Fit {
    const void* kernel;
    size_t smem;
    int cluster, threads;
  };
  static Fit known[32];
  static int n_known = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_known; ++i)
    if (known[i].kernel == kernel && known[i].smem == cfg.dynamicSmemBytes
        && known[i].cluster == cluster
        && known[i].threads == (int)cfg.blockDim.x)
      return cudaSuccess;
  int fits = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&fits, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (fits < 1) return cudaErrorLaunchOutOfResources;
  if (n_known < 32)
    known[n_known++] = {kernel, cfg.dynamicSmemBytes, cluster,
                        (int)cfg.blockDim.x};
  return cudaSuccess;
}

// Launch `kernel` as n_clusters clusters of T.cluster blocks of T.threads
// threads; fails (and launches nothing) if one cluster cannot be resident.
template <typename... Params, typename... Args>
cudaError_t wd_launch_cluster(void (*kernel)(Params...), int n_clusters,
                              size_t smem, const WideTab& T,
                              cudaStream_t stream, Args... args) {
  cudaError_t err = kc_smem_opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = T.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_clusters * T.cluster);
  cfg.blockDim = dim3(T.threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = wd_cluster_fits((const void*)kernel, cfg, T.cluster);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t wd_launch_fwd(const float* x0, const WideParams& p, float* ys,
                          int K, int n_steps, const WideTab& T,
                          cudaStream_t stream) {
  return wd_launch_cluster(wd_fwd_kernel, K, wd_fwd_smem_bytes(T), T, stream,
                           x0, p, ys, K, n_steps, T);
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
  cudaError_t err = wd_launch_cluster(wd_bwd_kernel, K, wd_bwd_smem_bytes(T),
                                      T, stream, x0, ys, gys, p, dx0, XS, KB,
                                      Y1, TT, K, n_steps, T);
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

// Dynamic shared memory per block of K7f (which = 0), K10's chain
// (which = 1) and K7b (which = 2) for the plan in T.
int wd_smem_bytes(const WideTab* T, int which) {
  return (int)(which == 0 ? wd_fwd_smem_bytes(*T)
               : which == 1 ? wd_lr_smem_bytes(*T) : wd_bwd_smem_bytes(*T));
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
  const int S = T->n_slots;
  // phase A: one cluster a step, the weight slice in shared memory where
  // K7b's is and phase A's own buffers leave room for it
  WideTab Ta = *T;
  Ta.smem_weights_bwd = T->smem_weights_bwd
      && wd_lr_factor_smem_bytes(*T) <= (size_t)WD_SMEM_BYTES;
  cudaError_t err = wd_launch_cluster(wd_lr_factor_kernel, n_steps,
                                      wd_lr_factor_smem_bytes(Ta), Ta, st,
                                      x0, ys, p, XS, Y1, AT, V, Ta);
  if (err != cudaSuccess) return (int)err;
  wd_lr_coupling_kernel<<<n_steps, WD_COUPLING_THREADS, 0, st>>>(AT, V, L,
                                                                 *T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = T->smem_factors
      ? wd_launch_cluster(wd_lr_chain_kernel<true>, 1, wd_lr_smem_bytes(*T),
                          *T, st, gys, AT, V, L, dx0, KB, TT, n_steps, *T)
      : wd_launch_cluster(wd_lr_chain_kernel<false>, 1, wd_lr_smem_bytes(*T),
                          *T, st, gys, AT, V, L, dx0, KB, TT, n_steps, *T);
  if (err != cudaSuccess) return (int)err;
  return (int)wd_launch_params(XS, KB, Y1, TT, dc1p, dw1p, dc2p, dw2p,
                               n_steps * S, *T, st);
}

}  // extern "C"
