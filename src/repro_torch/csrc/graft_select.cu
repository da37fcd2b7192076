// The GRAFT selection refresh and its two stages, for Hopper (sm_90a).
//
// Three kernels share the device routines of this file, so one build serves
// all three:
//
//   graft_select_kernel      replaces `fused_graft_select_pallas` and, with
//                            grid=(B,), `fused_graft_select_batched_pallas`
//                            (`_fused_kernel` / `_fused_kernel_batched` ->
//                            `_fused_body`, src/repro/kernels/graft_select.py):
//     1. Fast MaxVol over V (K, R): for each column j, the argmax of
//        |W[i, j]| over the rows still available (first index on ties), the
//        safe-pivot guard, the rank-1 elimination with the pivot row kept,
//        and logvol += log|pivot|;
//     2. the exact gather G_sel[:, j] = G[:, pivots[j]];
//     3. the prefix projection errors of G_sel against g_hat = g_bar/|g_bar|
//        by two classical Gram-Schmidt passes per column (CGS2: all
//        coefficients of a pass come from the same q, q <- q - Q (Q^T q)),
//        errors[j] = clip(1 - sum_{k<=j} (q_k . g_hat)^2, 0, 1).
//   fast_maxvol_kernel       stage 1 alone; replaces `fast_maxvol_pallas`
//                            (`_fast_maxvol_kernel`, src/repro/kernels/fast_maxvol.py).
//   projection_sweep_kernel  stage 3 alone over all R columns of a (d, R) G;
//                            replaces `projection_sweep_pallas`
//                            (`_projection_sweep_kernel`,
//                            src/repro/kernels/projection_sweep.py).
//
// What bounds them on this card: at the training path's shapes (K=16, R=8,
// rank 8, d=2304 for minicpm-2b and 4096 for rwkv6-7b) the refresh moves
// about 0.23 MB (0.41 MB at d 4096) and 0.63 MFLOP (1.1), which an H100
// could do in well under a microsecond. The work is a chain of `rank`
// dependent pivot steps and `2 * rank` dependent Gram-Schmidt passes, each
// ending in a reduction, so the kernels are bound by latency: the launch,
// then one barrier round trip and one pass over the block's rows per link
// of the chain, not bytes or FLOPs.
//
// What the design does about it: a whole refresh runs in ONE thread block
// (blockIdx.x is the batch index, so a stack of B refreshes is one launch of
// B blocks), so the three stages cost one launch instead of three and
// nothing round-trips through the host. The TPU kept V and G resident in a
// 12 MB VMEM block; a Hopper block has at most 227 KB of shared memory, so
// the chain is kept on chip where it fits, and each link of it is short:
//   * MaxVol. For K <= 32 and R <= 8 (the training path's 16 x 8) warp 0
//     runs it alone with V's rows in registers, a lane a row: the argmax is
//     one warp reduction of a key that orders scores as `better` does, the
//     pivot row reaches the other lanes by shuffles, and no block barrier
//     is crossed. Meanwhile the other warps sum |g_bar|^2, meet at a named
//     barrier and write g_hat. Otherwise the whole block runs it on a
//     working copy W of V, four barriers a pivot step, W with its per-row
//     and per-column scratch in shared memory when it fits (the "shared" W
//     plan) and otherwise in a global scratch that the wrapper allocates
//     (the "global" W plan).
//   * The gather. Each warp reads its 32-row chunks of G whole, with
//     coalesced loads issued three chunks ahead (their latency, not their
//     bytes, bounds this stage), its first three before MaxVol, through a
//     padded tile in shared memory, and copies each row's pivot columns
//     from there into the basis and into G_sel: G is read once. Rows of
//     more than 16 floats are read straight from global memory.
//   * The basis. Q, stored transposed (rank rows of d), and g_hat, one more
//     row, live in shared memory when they fit beside the rest (the
//     "shared" basis plan: Q^T 73.7 KB and g_hat 9.2 KB at d 2304, 147 KB in
//     all at d 4096, up to d ~ 5900 at rank 8 and K 16) and otherwise in a
//     global scratch (the "global" basis plan). Row j is column j's q,
//     built in place.
//   * The sweep. Every thread owns the same d-rows of every basis row, so
//     only the reductions need barriers. For up to 9 columns the work of a
//     column is pipelined into three reductions of one round each: (A)
//     normalise the previous column and sum its dot with g_hat, together
//     with the first Gram-Schmidt pass's coefficients; (B) the first
//     update, together with the second pass's coefficients, each basis row
//     read once for both; (C) the second update and |q|^2. The number of
//     coefficients is a template parameter, so they live in registers and
//     a warp reduces them together, their butterflies interleaved;
//     reductions alternate between two scratch slots, so each costs one
//     barrier. Wider sweeps take one pass a reduction, 8 coefficients at a
//     time.
//   At the slice a refresh crosses 24 block barriers, 93 before this
//   design: 1 after MaxVol, 1 for column 0's norm, 3 for each of columns 1
//   to 7 and 1 for the last column's dot.
//   * The standalone sweep stages G's columns the same way into its basis,
//     which stays in a global scratch, and runs the same routines, so its
//     errors are bit-equal to the fused kernel's.
// Both plans of either kind run the same code on another pointer, so their
// outputs are bit-equal; the wrapper picks them from the shape.
// Only columns j+1.. of W are eliminated at pivot step j: column j is never
// read again and the columns before it never were, so the pivots and logvol
// are those of the full update (the reference updates every column).
//
// Rounding: past the true rank of V the residual columns are rounding noise
// and the argmax picks among it, so the elimination must round exactly as
// the reference does. XLA compiles the JAX reference's `W - f * p` for the
// CPU as a fused multiply-add, so the kernels write it as
// __fmaf_rn(-f, p, W) (one rounding, never left to the compiler's
// contraction) after an IEEE division __fdiv_rn; the plain PyTorch version
// forms the product exactly in float64 and rounds the difference once
// (core/maxvol.py). The log-volume is summed in pivot order by one thread.
// The projection sweep sums in another order than PyTorch, so its errors
// agree to a tolerance, not bit for bit: each value of a reduction is
// summed over a thread's rows r = tid, tid + 256, ... in order, then by a
// xor butterfly over the warp's lanes (16, 8, 4, 2, 1), then over the
// block's 8 warps in warp order.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;             // Gram-Schmidt coefficients a thread holds at once
constexpr int kTileCols = 16;         // widest G row staged through a warp's tile
constexpr int kAhead = 3;             // chunks of G a warp has in flight
constexpr int kRegCols = 8;           // widest V whose rows MaxVol keeps in registers
constexpr size_t kSmemLimit = 232448; // what one Hopper block can address (227 KB)
constexpr unsigned kFull = 0xffffffffu;
constexpr float kPivotEps = 1e-12f;   // core/numerics.py PIVOT_EPS
constexpr float kEps = 1e-12f;        // core/projection.py _EPS

// MaxVol's working set: W (K*R), factor (K), pivot row (R), avail (K).
__host__ __device__ inline size_t work_words(int K, int R) {
  return (size_t)K * R + 2 * (size_t)K + R;
}

// The basis of n columns of length d: Q^T (n rows) and g_hat (one more row).
__host__ __device__ inline size_t basis_words(int d, int n) {
  return ((size_t)n + 1) * d;
}

// The refresh's shared scratch, in words: red[2 slots * kWarps * rank],
// coef[rank], fscratch[kWarps], pivot value[1], iscratch[kWarps],
// piv[rank], pivot index[1].
__host__ __device__ inline size_t scratch_words(int rank) {
  return (size_t)(2 * kWarps + 2) * rank + 2 * kWarps + 2;
}

// The warps' staging tiles for rows of `cols` <= kTileCols floats: 32 rows
// of cols + 1 floats a warp (the padding keeps a lane's row reads free of
// bank conflicts); wider rows are read straight from global memory.
__host__ __device__ inline size_t tile_words(int cols) {
  return cols <= kTileCols ? (size_t)kThreads * (cols + 1) : 0;
}

// Dynamic shared memory of graft_select_kernel and fast_maxvol_kernel
// (which runs with global_q and leaves the tiles unused), in 4-byte words
// (analysis/smem.py graft_select_smem() computes the same sums): the basis
// (shared basis plan only), the working set (shared W plan only), the
// scratch and G's staging tiles.
__host__ __device__ inline size_t smem_words(int K, int R, int d, int rank, int global_w,
                                             int global_q) {
  return (global_q ? 0 : basis_words(d, rank)) + (global_w ? 0 : work_words(K, R)) +
         scratch_words(rank) + tile_words(K);
}

// projection_sweep_kernel: red[2 slots * kWarps * R] and coef[R], in shared
// memory unless `global_red`, then G's staging tiles.
__host__ __device__ inline size_t sweep_red_words(int R) {
  return (size_t)(2 * kWarps + 1) * R;
}
__host__ __device__ inline size_t sweep_smem_words(int R, int global_red) {
  return (global_red ? 0 : sweep_red_words(R)) + tile_words(R);
}

struct Work {
  float* W;
  float* factor;
  float* prow;
  int* avail;
};

__device__ inline Work carve_work(float* base, int K, int R) {
  Work w;
  w.W = base;
  w.factor = w.W + (size_t)K * R;
  w.prow = w.factor + K;
  w.avail = reinterpret_cast<int*>(w.prow + R);
  return w;
}

struct Scratch {
  float* red;
  float* coef;
  float* fscratch;
  float* s_pv;
  int* iscratch;
  int* piv;
  int* s_pj;
  float* tiles;  // G's staging tiles, after the scratch
};

__device__ inline Scratch carve_scratch(float* base, int rank) {
  Scratch s;
  s.red = base;
  s.coef = s.red + 2 * kWarps * rank;
  s.fscratch = s.coef + rank;
  s.s_pv = s.fscratch + kWarps;
  s.iscratch = reinterpret_cast<int*>(s.s_pv + 1);
  s.piv = s.iscratch + kWarps;
  s.s_pj = s.piv + rank;
  s.tiles = reinterpret_cast<float*>(s.s_pj + 1);
  return s;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The total of value k over the warps' partials part[warp * stride + k],
// in warp order: every thread that calls it gets the same value.
__device__ __forceinline__ float warps_total(const float* part, int stride, int k) {
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += part[w * stride + k];
  return total;
}

// The warp sums of M values at once, each by a xor butterfly (16, 8, 4, 2,
// 1), the M butterflies interleaved.
template <int M>
__device__ __forceinline__ void warp_sums(float (&v)[M]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < M; ++k) v[k] += __shfl_xor_sync(kFull, v[k], o);
  }
}

// Block-wide sum through one reduction slot (kWarps * stride words): one
// barrier. The slot may be written again only after the block's next
// barrier, so callers alternate between two slots.
__device__ __forceinline__ float block_sum(float v, float* slot, int stride) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) slot[(threadIdx.x >> 5) * stride] = v;
  __syncthreads();
  return warps_total(slot, stride, 0);
}

// Warp w's part of |g_bar|^2 (its threads' rows r = 32 w + lane + kThreads
// i, each thread's in order, then warp-summed) into slot[w * stride], by
// whichever warp calls it; the caller's next barrier publishes it.
__device__ __forceinline__ void gbar_partial(const float* __restrict__ gbar, int d, int w,
                                             float* slot, int stride) {
  const int lane = threadIdx.x & 31;
  float part = 0.f;
  for (int r = 32 * w + lane; r < d; r += kThreads) part += gbar[r] * gbar[r];
  part = warp_sum(part);
  if (lane == 0) slot[w * stride] = part;
}

// x / den rounded as __fdiv_rn rounds it, from inv = __frcp_rn(den) taken
// once for many x: the rounded product corrected by its exact residual,
// which gives the correctly rounded quotient whenever nothing under- or
// overflows (Markstein's theorem), with no branch per division.
__device__ __forceinline__ float div_by(float x, float den, float inv) {
  const float q = __fmul_rn(x, inv);
  return __fmaf_rn(__fmaf_rn(-q, den, x), inv, q);
}

// argmax order, torch.argmax's and jnp.argmax's: NaN above every number,
// then larger score first, lower row index on ties (NaN ties NaN)
__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  const bool sn = s != s, bn = bs != bs;
  if (sn != bn) return sn;
  return s > bs || ((s == bs || sn) && i < bi);
}

// Stage 1 on the whole block, for any K: Fast MaxVol over V (K, R) on the
// working set w (shared or global memory). Leaves the pivots in s.piv and
// returns the log-volume in thread 0.
__device__ __forceinline__ float maxvol_block(const float* __restrict__ V, Work w,
                                              Scratch s, int K, int R, int rank) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  float* W = w.W;
  for (int e = tid; e < K * R; e += kThreads) W[e] = V[e];
  for (int i = tid; i < K; i += kThreads) w.avail[i] = 1;
  __syncthreads();

  float lv = 0.f;  // running log-volume, kept by thread 0
  for (int j = 0; j < rank; ++j) {
    float bs = -CUDART_INF_F;
    int bi = INT_MAX;
    for (int i = tid; i < K; i += kThreads) {
      const float sc = w.avail[i] ? fabsf(W[i * R + j]) : -1.0f;
      if (better(sc, i, bs, bi)) { bs = sc; bi = i; }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float os = __shfl_xor_sync(kFull, bs, o);
      const int oi = __shfl_xor_sync(kFull, bi, o);
      if (better(os, oi, bs, bi)) { bs = os; bi = oi; }
    }
    if (lane == 0) { s.fscratch[warp] = bs; s.iscratch[warp] = bi; }
    __syncthreads();
    if (tid == 0) {
      float sc = s.fscratch[0];
      int i = s.iscratch[0];
      for (int v = 1; v < kWarps; ++v)
        if (better(s.fscratch[v], s.iscratch[v], sc, i)) { sc = s.fscratch[v]; i = s.iscratch[v]; }
      const float x = W[i * R + j];
      const float pv = fabsf(x) < kPivotEps ? (x >= 0.f ? kPivotEps : -kPivotEps) : x;
      *s.s_pj = i;
      *s.s_pv = pv;
      s.piv[j] = i;
      w.avail[i] = 0;
      lv += logf(fabsf(pv));
    }
    __syncthreads();
    const int rest = R - j - 1;  // columns still to be pivoted on
    if (rest == 0) continue;
    const int pj = *s.s_pj;
    const float pv = *s.s_pv;
    for (int i = tid; i < K; i += kThreads)
      w.factor[i] = __fdiv_rn(W[i * R + j], pv);
    for (int c = j + 1 + tid; c < R; c += kThreads) w.prow[c] = W[pj * R + c];
    __syncthreads();
    for (int e = tid; e < K * rest; e += kThreads) {
      const int i = e / rest;
      const int c = j + 1 + (e - i * rest);
      if (i != pj) {
        float* x = W + i * R + c;
        *x = __fmaf_rn(-w.factor[i], w.prow[c], *x);
      }
    }
    __syncthreads();
  }
  return lv;
}

// Stage 1 for K <= 32 and R <= kRegCols, run by warp 0 alone: lane i holds
// row i of V in registers and its availability, the argmax is one warp
// reduction, the pivot row comes to the other lanes by shuffles, and
// nothing waits on a barrier. The same arithmetic and the same argmax as
// maxvol_block, so the same pivots and logvol. Leaves the pivots in piv
// (lane 0 writes them) and returns the log-volume in lane 0.
__device__ __forceinline__ float maxvol_warp(const float* __restrict__ V, int* piv, int K,
                                             int R, int rank) {
  const int lane = threadIdx.x & 31;
  float w[kRegCols];
#pragma unroll
  for (int c = 0; c < kRegCols; ++c) w[c] = lane < K && c < R ? V[lane * R + c] : 0.f;
  bool avail = lane < K;
  float lv = 0.f;
#pragma unroll
  for (int j = 0; j < kRegCols; ++j) {
    if (j == rank) break;
    const float x = w[j];
    // `better`'s order as an unsigned key: all ones for an available NaN,
    // the bits of |x| + 2 for another available row (monotonic for |x| >=
    // +0, below the NaN key even at +inf), 1 for a row already pivoted on
    // (score -1 whatever it holds), 0 for lanes >= K; ties go to the
    // lowest row, as in `better`
    const float a = fabsf(x);
    const unsigned key = lane >= K ? 0u : !avail ? 1u : a != a ? ~0u : __float_as_uint(a) + 2u;
    const unsigned best = __reduce_max_sync(kFull, key);
    const int pj = __ffs(__ballot_sync(kFull, key == best)) - 1;
    const float px = __shfl_sync(kFull, x, pj);  // W[pj * R + j]
    const float pv = fabsf(px) < kPivotEps ? (px >= 0.f ? kPivotEps : -kPivotEps) : px;
    lv += logf(fabsf(pv));
    if (lane == 0) piv[j] = pj;
    if (lane == pj) avail = false;
    const float f = __fdiv_rn(x, pv);
    const bool eliminate = lane < K && lane != pj;
#pragma unroll
    for (int c = j + 1; c < kRegCols; ++c) {
      const float p = __shfl_sync(kFull, w[c], pj);  // the pivot row, W[pj * R + c]
      if (eliminate && c < R) w[c] = __fmaf_rn(-f, p, w[c]);
    }
  }
  return lv;
}

// Stage 1: the pivots land in s.piv, visible to the block after the
// caller's next __syncthreads; the log-volume is returned in thread 0.
// Small V runs on warp 0 alone (the other warps return at once).
__device__ __forceinline__ bool maxvol_on_warp(int K, int R) {
  return K <= 32 && R <= kRegCols;
}
__device__ __forceinline__ float maxvol_stage(const float* __restrict__ V, Work w,
                                              Scratch s, int K, int R, int rank) {
  if (maxvol_on_warp(K, R)) return threadIdx.x < 32 ? maxvol_warp(V, s.piv, K, R, rank) : 0.f;
  return maxvol_block(V, w, s, K, R, rank);
}

// g_hat = g_bar / gnorm, rows first, first + stride, ... (row n of the basis)
__device__ __forceinline__ void ghat_rows(const float* __restrict__ gbar, float gnorm,
                                          float* ghat, int d, int first, int stride) {
  for (int r = first; r < d; r += stride) ghat[r] = __fdiv_rn(gbar[r], gnorm);
}

// Stage 2 and the basis: one pass over the rows of src (d rows of `cols`
// floats, row-major) that copies n of its columns, column j = src[:, idx ?
// idx[j] : j], into rows 0..n-1 of Qt (transposed) and, when gsel is given,
// into gsel (d, n). Warp w takes rows 32 w + kThreads i + lane, lane by lane
// the rows a thread owns in the sweep. Rows of at most kTileCols floats come
// through the warp's tile in shared memory, read from src as whole 32-row
// chunks with coalesced loads (each float once), kAhead chunks in flight
// in registers while an earlier one is copied out (the loads' latency, not
// their bytes, bounds this stage); wider rows are read straight from
// global memory.
struct Stager {
  const float* __restrict__ src;
  int cols, d;
  float buf[kAhead][kTileCols];  // this lane's part of the chunks in flight

  __device__ __forceinline__ Stager(const float* __restrict__ src_, int cols_, int d_)
      : src(src_), cols(cols_), d(d_) {}
  __device__ __forceinline__ bool tiled() const { return cols <= kTileCols; }
  __device__ __forceinline__ int first_row() const { return 32 * (threadIdx.x >> 5); }

  // issue the loads of the chunk of rows base .. base + 31 into buf[a]:
  // float lane + 32 t of the chunk into buf[a][t]
  __device__ __forceinline__ void load(int a, int base) {
    const int lane = threadIdx.x & 31;
    const int count = min(32, d - base) * cols;
    const float* chunk = src + (size_t)base * cols;
#pragma unroll
    for (int t = 0; t < kTileCols; ++t)
      if (lane + 32 * t < count) buf[a][t] = chunk[lane + 32 * t];
  }
  // the first kAhead chunks, to be issued early (before MaxVol)
  __device__ __forceinline__ void prefetch() {
#pragma unroll
    for (int a = 0; a < kAhead; ++a)
      if (tiled() && first_row() + a * kThreads < d) load(a, first_row() + a * kThreads);
  }

  __device__ __forceinline__ void run(const int* idx, float* Qt, float* __restrict__ gsel,
                                      int n, float* tiles) {
    const int lane = threadIdx.x & 31;
    const int pitch = cols + 1;
    float* tile = tiles + (threadIdx.x >> 5) * 32 * pitch;
    const bool vec_sel = gsel != nullptr && (n & 3) == 0;  // G_sel's rows are 16-byte aligned
    // buf[t] is tile row i_t, column c_t; from t to t + 1 the row steps by
    // 32 / cols and the column by 32 % cols
    const int step = tiled() ? 32 / cols : 0, carry = tiled() ? 32 % cols : 0;
    const int i0 = tiled() ? lane / cols : 0, c0 = tiled() ? lane % cols : 0;
    int col[kRegCols];  // the first kRegCols column indices, loaded once
#pragma unroll
    for (int j = 0; j < kRegCols; ++j) col[j] = j < n ? (idx ? idx[j] : j) : 0;
    // columns j .. j + 3 of row r, column j + t at row[column(t)]
    auto copy4 = [&](int r, const float* row, int j, auto column) {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (j + t < n) v[t] = row[column(t)];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (j + t < n) Qt[(j + t) * d + r] = v[t];
      float* srow = gsel ? gsel + (size_t)r * n : nullptr;
      if (vec_sel) {
        *reinterpret_cast<float4*>(srow + j) = make_float4(v[0], v[1], v[2], v[3]);
      } else if (srow) {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (j + t < n) srow[j + t] = v[t];
      }
    };
    auto copy_row = [&](int r, const float* row) {
#pragma unroll
      for (int j = 0; j < kRegCols; j += 4)
        if (j < n) copy4(r, row, j, [&](int t) { return col[j + t]; });
      for (int j = kRegCols; j < n; j += 4)
        copy4(r, row, j, [&](int t) { return idx ? idx[j + t] : j + t; });
    };
    for (int base0 = first_row(); base0 < d; base0 += kAhead * kThreads) {
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {  // buf[a] holds the chunk at base
        const int base = base0 + a * kThreads;
        if (base >= d) break;
        const int r = base + lane;
        if (tiled()) {  // rows base .. base + 31 into the tile, then reload buf[a]
          const int count = min(32, d - base) * cols;
          int i = i0, c = c0;
#pragma unroll
          for (int t = 0; t < kTileCols; ++t) {
            if (lane + 32 * t < count) tile[i * pitch + c] = buf[a][t];
            i += step;
            c += carry;
            if (c >= cols) { c -= cols; ++i; }
          }
          __syncwarp();
          if (base + kAhead * kThreads < d) load(a, base + kAhead * kThreads);
          if (r < d) copy_row(r, tile + lane * pitch);  // shared loads
        } else if (r < d) {
          copy_row(r, src + (size_t)r * cols);
        }
        __syncwarp();  // the tile is refilled next
      }
    }
  }
};

// One CGS2 pass for column q against the j basis rows before it, for the
// sweeps of more than kChunk + 1 columns: every thread accumulates the
// coefficients Q^T q over its rows (r = tid, tid + kThreads, ... in order),
// kChunk at a time, the warp reduces each chunk together and lane 0 writes
// it to `slot` (kWarps * n words); after a barrier threads k < j total
// coefficient k over the warps in warp order into coef, and after a second
// one q <- q - Q coef over the thread's rows. Returns the thread's part of
// |q|^2 after the update.
__device__ __forceinline__ float cgs_pass(const float* Qt, float* q, int d, int j, int n,
                                          float* slot, float* coef) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  for (int k0 = 0; k0 < j; k0 += kChunk) {
    float part[kChunk];
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) part[kk] = 0.f;
    for (int r = tid; r < d; r += kThreads) {
      const float qr = q[r];
#pragma unroll
      for (int kk = 0; kk < kChunk; ++kk)
        if (k0 + kk < j) part[kk] += Qt[(k0 + kk) * d + r] * qr;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int kk = 0; kk < kChunk; ++kk)
        if (k0 + kk < j) part[kk] += __shfl_xor_sync(kFull, part[kk], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int kk = 0; kk < kChunk; ++kk)
        if (k0 + kk < j) slot[warp * n + k0 + kk] = part[kk];
    }
  }
  __syncthreads();
  for (int k = tid; k < j; k += kThreads) coef[k] = warps_total(slot, n, k);
  __syncthreads();
  float nsq = 0.f;
  for (int r = tid; r < d; r += kThreads) {
    float proj = 0.f;
    for (int k = 0; k < j; ++k) proj += Qt[k * d + r] * coef[k];
    const float v = q[r] - proj;
    q[r] = v;
    nsq += v * v;
  }
  return nsq;
}

// Columns of the pipelined sweep (n <= kChunk + 1 columns, J = 1 .. n - 1
// known at compile time). On entry column J - 1 is orthogonalised and its
// norm is `nrm`; column J is as staged. Three reductions, one barrier each:
//   A. normalise column J - 1 and sum its dot with g_hat, together with the
//      first pass's coefficients of column J (the one against column J - 1
//      from the value just normalised);
//   B. the first update of column J, together with the second pass's
//      coefficients from the updated values (each basis row read once);
//   C. the second update and |q|^2, which leaves column J's norm in `nrm`.
// Every sum is the one the unpipelined passes take, in the same order
// (a thread's rows in order, the xor butterfly, the warps in order), so
// the results are the same bits.
template <int J>
__device__ __forceinline__ void pipelined_column(float* Qt, const float* ghat,
                                                 float* __restrict__ errors, int d, int n,
                                                 float* red, int& slot, float& nrm,
                                                 float& captured) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  float* prev = Qt + (J - 1) * d;
  float* q = Qt + J * d;
  const bool keep = nrm > 1e-8f;
  const float den = nrm + kEps, inv = __frcp_rn(den);
  // A: coefficients 0 .. J-1 of the first pass, then column J - 1's dot
  float part[J + 1];
#pragma unroll
  for (int k = 0; k <= J; ++k) part[k] = 0.f;
  for (int r = tid; r < d; r += kThreads) {
    const float v = keep ? div_by(prev[r], den, inv) : 0.f;
    prev[r] = v;
    part[J] += v * ghat[r];
    const float qr = q[r];
#pragma unroll
    for (int k = 0; k < J - 1; ++k) part[k] += Qt[k * d + r] * qr;
    part[J - 1] += v * qr;
  }
  float* s = red + slot * kWarps * n;
  warp_sums<J + 1>(part);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k <= J; ++k) s[warp * n + k] = part[k];  // J <= n - 1
  }
  __syncthreads();
  const float dot = warps_total(s, n, J);
  captured += dot * dot;
  if (tid == 0) errors[J - 1] = fminf(fmaxf(1.f - captured, 0.f), 1.f);
  float c[J];
  float mine = lane < J ? warps_total(s, n, lane) : 0.f;
#pragma unroll
  for (int k = 0; k < J; ++k) c[k] = __shfl_sync(kFull, mine, k);
  slot ^= 1;
  // B: q <- q - Q c, and the second pass's coefficients from the new q
  float part2[J];
#pragma unroll
  for (int k = 0; k < J; ++k) part2[k] = 0.f;
  for (int r = tid; r < d; r += kThreads) {
    float b[J];
#pragma unroll
    for (int k = 0; k < J; ++k) b[k] = Qt[k * d + r];
    float proj = 0.f;
#pragma unroll
    for (int k = 0; k < J; ++k) proj += b[k] * c[k];
    const float v = q[r] - proj;
    q[r] = v;
#pragma unroll
    for (int k = 0; k < J; ++k) part2[k] += b[k] * v;
  }
  s = red + slot * kWarps * n;
  warp_sums<J>(part2);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < J; ++k) s[warp * n + k] = part2[k];
  }
  __syncthreads();
  mine = lane < J ? warps_total(s, n, lane) : 0.f;
#pragma unroll
  for (int k = 0; k < J; ++k) c[k] = __shfl_sync(kFull, mine, k);
  slot ^= 1;
  // C: q <- q - Q c again, and |q|^2
  float nsq = 0.f;
  for (int r = tid; r < d; r += kThreads) {
    float proj = 0.f;
#pragma unroll
    for (int k = 0; k < J; ++k) proj += Qt[k * d + r] * c[k];
    const float v = q[r] - proj;
    q[r] = v;
    nsq += v * v;
  }
  nrm = sqrtf(block_sum(nsq, red + slot * kWarps * n, n));
  slot ^= 1;
}

// Column j's normalisation (q = Qt row j, its norm nrm) and dot with
// g_hat, and its error.
__device__ __forceinline__ void finish_column(float* q, int j, const float* ghat,
                                              float* __restrict__ errors, int d, int n,
                                              float* red, int& slot, float nrm,
                                              float& captured) {
  const bool keep = nrm > 1e-8f;
  const float den = nrm + kEps, inv = __frcp_rn(den);
  float dot = 0.f;
  for (int r = threadIdx.x; r < d; r += kThreads) {
    const float v = keep ? div_by(q[r], den, inv) : 0.f;
    q[r] = v;
    dot += v * ghat[r];
  }
  dot = block_sum(dot, red + slot * kWarps * n, n);
  slot ^= 1;
  captured += dot * dot;
  if (threadIdx.x == 0) errors[j] = fminf(fmaxf(1.f - captured, 0.f), 1.f);
}

// Stage 3: the CGS2 prefix projection errors of the n columns staged in Qt
// (row j of Qt is column j; row n is g_hat) into errors[j], written by
// thread 0. red holds two reduction slots of kWarps * n words, coef n
// words; `slot` is the slot that the caller's last reduction did not use.
__device__ __forceinline__ void sweep_stage(float* Qt, float* __restrict__ errors, int d,
                                            int n, float* red, float* coef, int slot) {
  const int tid = threadIdx.x;
  const float* ghat = Qt + n * d;
  float captured = 0.f;  // identical in every thread
  if (n <= kChunk + 1) {  // pipelined: 3 barriers a column after the first
    float nsq = 0.f;
    for (int r = tid; r < d; r += kThreads) nsq += Qt[r] * Qt[r];
    float nrm = sqrtf(block_sum(nsq, red + slot * kWarps * n, n));
    slot ^= 1;
    for (int j = 1; j < n; ++j) {
#define GS_COLUMN(J) pipelined_column<J>(Qt, ghat, errors, d, n, red, slot, nrm, captured)
      switch (j) {
        case 1: GS_COLUMN(1); break;
        case 2: GS_COLUMN(2); break;
        case 3: GS_COLUMN(3); break;
        case 4: GS_COLUMN(4); break;
        case 5: GS_COLUMN(5); break;
        case 6: GS_COLUMN(6); break;
        case 7: GS_COLUMN(7); break;
        default: GS_COLUMN(8);
      }
#undef GS_COLUMN
    }
    finish_column(Qt + (n - 1) * d, n - 1, ghat, errors, d, n, red, slot, nrm, captured);
    return;
  }
  for (int j = 0; j < n; ++j) {
    float* q = Qt + j * d;  // row j of Q^T is the column being built
    float nsq = 0.f;        // this thread's part of |q|^2
    if (j == 0) {
      for (int r = tid; r < d; r += kThreads) nsq += q[r] * q[r];
    }
    for (int pass = 0; pass < 2 && j > 0; ++pass) {
      nsq = cgs_pass(Qt, q, d, j, n, red + slot * kWarps * n, coef);
      slot ^= 1;
    }
    const float nrm = sqrtf(block_sum(nsq, red + slot * kWarps * n, n));
    slot ^= 1;
    finish_column(q, j, ghat, errors, d, n, red, slot, nrm, captured);
  }
}

// Index arithmetic inside a block is 32-bit: the launchers refuse operands
// of more than INT_MAX elements (the wrappers' guards stay far below).
bool too_large(long long a, long long b) { return a * b > (long long)INT_MAX; }

// The refresh's working set and scratch: W in shared memory after `smem`,
// or in this block's slice of the global scratch `wglobal`; the scratch in
// shared memory in both plans.
struct Plan {
  Work w;
  Scratch s;
};

__device__ __forceinline__ Plan carve(float* smem, float* wglobal, int K, int R,
                                      int rank, int global_w) {
  Plan p;
  if (global_w) {
    p.w = carve_work(wglobal + blockIdx.x * work_words(K, R), K, R);
    p.s = carve_scratch(smem, rank);
  } else {
    p.w = carve_work(smem, K, R);
    p.s = carve_scratch(smem + work_words(K, R), rank);
  }
  return p;
}

__global__ void __launch_bounds__(kThreads, 1)
graft_select_kernel(const float* __restrict__ V, const float* __restrict__ G,
                    const float* __restrict__ gbar, int32_t* __restrict__ pivots,
                    float* __restrict__ errors, float* __restrict__ logvol,
                    float* __restrict__ gsel, float* qglobal, float* wglobal, int K,
                    int R, int d, int rank, int global_w, int global_q) {
  extern __shared__ float smem[];
  const size_t onchip = global_q ? 0 : basis_words(d, rank);
  const Plan p = carve(smem + onchip, wglobal, K, R, rank, global_w);
  const Scratch& s = p.s;

  // one block per refresh: offset every operand to this batch's slice
  const size_t b = blockIdx.x;
  V += b * K * R;
  G += b * (size_t)d * K;
  gbar += b * d;
  pivots += b * rank;
  errors += b * rank;
  logvol += b;
  gsel += b * (size_t)d * rank;

  float* Qt = global_q ? qglobal + b * basis_words(d, rank) : smem;
  float* ghat = Qt + rank * d;
  const int warp = threadIdx.x >> 5;
  Stager stager(G, K, d);
  stager.prefetch();  // each warp's first chunk of G, in flight during MaxVol
  float lv = 0.f;     // kept by thread 0
  if (maxvol_on_warp(K, R)) {
    // warp 0 runs MaxVol while the others sum |g_bar|^2 (warp 1 also warp
    // 0's part) into reduction slot 0, meet at a named barrier and write g_hat
    if (warp == 0) {
      lv = maxvol_stage(V, p.w, s, K, R, rank);
    } else {
      gbar_partial(gbar, d, warp, s.red, rank);
      if (warp == 1) gbar_partial(gbar, d, 0, s.red, rank);
      asm volatile("bar.sync 1, %0;" ::"n"(kThreads - 32));
      const float gnorm = sqrtf(warps_total(s.red, rank, 0) + kEps);
      ghat_rows(gbar, gnorm, ghat, d, threadIdx.x - 32, kThreads - 32);
    }
    __syncthreads();
  } else {
    lv = maxvol_stage(V, p.w, s, K, R, rank);
    gbar_partial(gbar, d, warp, s.red, rank);
    __syncthreads();
    const float gnorm = sqrtf(warps_total(s.red, rank, 0) + kEps);
    ghat_rows(gbar, gnorm, ghat, d, threadIdx.x, kThreads);
  }
  // the same routines on the shared or the global basis; two call sites so
  // that the shared one compiles to shared-memory loads and stores
  if (global_q) {
    stager.run(s.piv, Qt, gsel, rank, s.tiles);
    sweep_stage(Qt, errors, d, rank, s.red, s.coef, 1);
  } else {
    stager.run(s.piv, smem, gsel, rank, s.tiles);
    sweep_stage(smem, errors, d, rank, s.red, s.coef, 1);
  }
  if (threadIdx.x == 0) *logvol = lv;
  for (int j = threadIdx.x; j < rank; j += kThreads) pivots[j] = s.piv[j];
}

__global__ void __launch_bounds__(kThreads)
fast_maxvol_kernel(const float* __restrict__ V, int32_t* __restrict__ pivots,
                   float* __restrict__ logvol, float* wglobal, int K, int R,
                   int rank, int global_w) {
  extern __shared__ float smem[];
  const Plan p = carve(smem, wglobal, K, R, rank, global_w);
  const float lv = maxvol_stage(V, p.w, p.s, K, R, rank);
  __syncthreads();
  if (threadIdx.x == 0) *logvol = lv;
  for (int j = threadIdx.x; j < rank; j += kThreads) pivots[j] = p.s.piv[j];
}

__global__ void __launch_bounds__(kThreads, 1)
projection_sweep_kernel(const float* __restrict__ G, const float* __restrict__ gbar,
                        float* __restrict__ errors, float* __restrict__ Qt,
                        float* rglobal, int d, int R, int global_red) {
  extern __shared__ float smem[];
  float* red = global_red ? rglobal : smem;
  float* coef = red + 2 * kWarps * R;
  float* tiles = global_red ? smem : smem + sweep_red_words(R);
  Stager stager(G, R, d);
  stager.prefetch();
  gbar_partial(gbar, d, threadIdx.x >> 5, red, R);  // reduction slot 0
  __syncthreads();
  const float gnorm = sqrtf(warps_total(red, R, 0) + kEps);
  ghat_rows(gbar, gnorm, Qt + R * d, d, threadIdx.x, kThreads);
  stager.run(nullptr, Qt, nullptr, R, tiles);
  sweep_stage(Qt, errors, d, R, red, coef, 1);
}

cudaError_t set_smem(const void* kernel, size_t smem_bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes);
}

}  // namespace

extern "C" {

// The dynamic shared memory, in bytes, of one refresh block under the given
// plans (analysis/smem.py graft_select_smem() mirrors it); -1 above what a block can
// address.
int graft_select_smem_bytes(int K, int R, int d, int rank, int global_w, int global_q) {
  const size_t bytes = 4 * smem_words(K, R, d, rank, global_w, global_q);
  return bytes > kSmemLimit ? -1 : (int)bytes;
}

// The dynamic shared memory, in bytes, of the fast_maxvol block that
// fast_maxvol_launch sizes; -1 above what a block can address.
int fast_maxvol_smem_bytes(int K, int R, int rank, int global_w) {
  const size_t bytes = 4 * smem_words(K, R, 0, rank, global_w, 1);
  return bytes > kSmemLimit ? -1 : (int)bytes;
}

// The dynamic shared memory, in bytes, of the projection_sweep block that
// projection_sweep_launch sizes; -1 above what a block can address.
int projection_sweep_smem_bytes(int R, int global_red) {
  const size_t bytes = 4 * sweep_smem_words(R, global_red);
  return bytes > kSmemLimit ? -1 : (int)bytes;
}

// Launch B refreshes, one thread block each, on `stream`. Pointers are
// device pointers to contiguous float32 / int32 buffers laid out as
// V (B,K,R), G (B,d,K), gbar (B,d), pivots (B,rank), errors (B,rank),
// logvol (B,) and gsel (B,d,rank). With `global_q` the basis lives in the
// scratch `Qt`, B * (rank+1) * d floats, else in shared memory and `Qt` is
// unused. With `global_w` MaxVol's working set lives in `wscratch`,
// B * work_words(K,R) floats, else in shared memory and `wscratch` is
// unused. Returns a cudaError_t code: nonzero if the arguments are refused
// (the plans' shared memory above 227 KB among them) or the launch fails.
int graft_select_launch(const void* V, const void* G, const void* gbar,
                        void* pivots, void* errors, void* logvol, void* gsel,
                        void* Qt, void* wscratch, int B, int K, int R, int d,
                        int rank, int global_w, int global_q, void* stream) {
  if (B < 1 || B > 65535 || K < 1 || R < 1 || d < 1 || rank < 1 || rank > K || rank > R)
    return (int)cudaErrorInvalidValue;
  if (too_large(K, R) || too_large(d, K) || too_large(d, rank + 1))
    return (int)cudaErrorInvalidValue;
  if ((global_w && wscratch == nullptr) || (global_q && Qt == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem_bytes = 4 * smem_words(K, R, d, rank, global_w, global_q);
  if (smem_bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem((const void*)graft_select_kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  graft_select_kernel<<<B, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)V, (const float*)G, (const float*)gbar, (int32_t*)pivots,
      (float*)errors, (float*)logvol, (float*)gsel, (float*)Qt,
      (float*)wscratch, K, R, d, rank, global_w, global_q);
  return (int)cudaGetLastError();
}

// Fast MaxVol alone for one V (K,R): pivots (rank,) int32, logvol (1,).
// `global_w` and `wscratch` (work_words(K,R) floats) as above.
int fast_maxvol_launch(const void* V, void* pivots, void* logvol, void* wscratch,
                       int K, int R, int rank, int global_w, void* stream) {
  if (K < 1 || R < 1 || rank < 1 || rank > K || rank > R || too_large(K, R))
    return (int)cudaErrorInvalidValue;
  if (global_w && wscratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem_bytes = 4 * smem_words(K, R, 0, rank, global_w, 1);
  if (smem_bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem((const void*)fast_maxvol_kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  fast_maxvol_kernel<<<1, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)V, (int32_t*)pivots, (float*)logvol, (float*)wscratch, K, R,
      rank, global_w);
  return (int)cudaGetLastError();
}

// The projection sweep alone for one G (d,R) and gbar (d,): errors (R,),
// the basis scratch Qt ((R+1) * d floats). With `global_red` the reduction
// scratch lives in `rscratch`, sweep_red_words(R) floats; otherwise in
// shared memory.
int projection_sweep_launch(const void* G, const void* gbar, void* errors, void* Qt,
                            void* rscratch, int d, int R, int global_red, void* stream) {
  if (d < 1 || R < 1 || too_large(d, R + 1)) return (int)cudaErrorInvalidValue;
  if (global_red && rscratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem_bytes = 4 * sweep_smem_words(R, global_red);
  if (smem_bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem((const void*)projection_sweep_kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  projection_sweep_kernel<<<1, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)G, (const float*)gbar, (float*)errors, (float*)Qt,
      (float*)rscratch, d, R, global_red);
  return (int)cudaGetLastError();
}

}  // extern "C"
