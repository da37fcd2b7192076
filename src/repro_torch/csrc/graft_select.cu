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
// d=2304, rank 8) the refresh moves about 0.23 MB and does about 0.7 MFLOP,
// which an H100 could do in well under a microsecond. The work is a chain of
// `rank` dependent pivot steps and `2 * rank` dependent Gram-Schmidt passes,
// each ending in a block-wide reduction, so the kernels are bound by
// latency: launch latency plus one barrier round trip per step, not by
// bytes or FLOPs.
//
// What the design does about it: a whole refresh runs in ONE thread block
// (blockIdx.x is the batch index, so a stack of B refreshes is one launch of
// B blocks), so the three stages cost one launch instead of three and
// nothing round-trips through the host. The TPU kept V and G resident in a
// 12 MB VMEM block; a Hopper block has at most 227 KB of shared memory, so:
//   * MaxVol's working copy W of V, with its per-row (factor, avail) and
//     per-column (pivot row) scratch, lives in shared memory when it fits
//     (the "shared" plan) and otherwise in a global scratch that the
//     wrapper allocates (the "global" plan), where it sits in the 50 MB L2.
//     Both plans run the same code on a different pointer, so their pivots
//     and logvol are bit-equal. The wrapper picks the plan from the shape.
//   * G is read from global memory (L2) for the gather.
//   * the Gram-Schmidt basis Q is a global scratch, stored transposed
//     (n, d) so that every pass reads it coalesced; each thread owns the
//     same d-rows of q and Q in every pass, so the sweep needs barriers
//     only around its reductions, and d is limited by nothing but the
//     wrapper's guard. The standalone sweep keeps its per-column reduction
//     scratch in shared memory when it fits, else in a global scratch.
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
// (core/maxvol.py). The projection sweep sums in another order than
// PyTorch, so its errors agree to a tolerance, not bit for bit; the fused
// and the standalone sweep run the same routine with the same block, so
// they agree with each other bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kPivotEps = 1e-12f;   // core/numerics.py PIVOT_EPS
constexpr float kEps = 1e-12f;        // core/projection.py _EPS

// MaxVol's working set: W (K*R), factor (K), pivot row (R), avail (K).
__host__ __device__ inline size_t work_words(int K, int R) {
  return (size_t)K * R + 2 * (size_t)K + R;
}

// Dynamic shared memory of graft_select_kernel and fast_maxvol_kernel, in
// 4-byte words (the Python wrapper's smem_bytes() computes the same sums):
//   the working set (shared plan only), red[kWarps*rank], coef[rank],
//   fscratch[kWarps], pivot value[1], iscratch[kWarps], piv[rank],
//   pivot index[1].
__host__ __device__ inline size_t smem_words(int K, int R, int rank, int global_w) {
  return (global_w ? 0 : work_words(K, R)) + (size_t)(kWarps + 2) * rank +
         2 * kWarps + 2;
}

// projection_sweep_kernel: red[kWarps*R] and coef[R] (shared plan only),
// fscratch[kWarps].
__host__ __device__ inline size_t sweep_red_words(int R) {
  return (size_t)(kWarps + 1) * R;
}
__host__ __device__ inline size_t sweep_smem_words(int R, int global_red) {
  return (global_red ? 0 : sweep_red_words(R)) + kWarps;
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

// The refresh's shared-memory scratch, after the working set when it is
// there too.
struct Scratch {
  float* red;
  float* coef;
  float* fscratch;
  float* s_pv;
  int* iscratch;
  int* piv;
  int* s_pj;
};

__device__ inline Scratch carve_scratch(float* base, int rank) {
  Scratch s;
  s.red = base;
  s.coef = s.red + kWarps * rank;
  s.fscratch = s.coef + rank;
  s.s_pv = s.fscratch + kWarps;
  s.iscratch = reinterpret_cast<int*>(s.s_pv + 1);
  s.piv = s.iscratch + kWarps;
  s.s_pj = s.piv + rank;
  return s;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Block-wide sum. Every thread adds the warp partials in the same order, so
// every thread gets the same value.
__device__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += scratch[w];
  __syncthreads();  // scratch may be reused as soon as this returns
  return total;
}

// argmax order: larger score first, lower row index on ties
__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

// Stage 1: Fast MaxVol over V (K, R) on the working set w (shared or
// global memory). Leaves the pivots in s.piv (visible to the whole block on
// return) and returns the log-volume in thread 0.
__device__ __forceinline__ float maxvol_stage(const float* __restrict__ V, Work w,
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

// Stage 3: the CGS2 prefix projection errors of n columns against g_hat.
// Column j is src[r * ld + (cols ? cols[j] : j)], r < d. Qt is the (n, d)
// global scratch of the basis; red (kWarps * n) and coef (n) the reduction
// scratch; errors[j] is written by thread 0.
__device__ void sweep_stage(const float* __restrict__ src, int ld,
                            const int* cols, const float* __restrict__ gbar,
                            float* __restrict__ Qt, float* __restrict__ errors,
                            int d, int n, float* red, float* coef, float* fscratch) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  float part = 0.f;
  for (int r = tid; r < d; r += kThreads) part += gbar[r] * gbar[r];
  const float gnorm = sqrtf(block_sum(part, fscratch) + kEps);
  float captured = 0.f;  // identical in every thread
  for (int j = 0; j < n; ++j) {
    float* q = Qt + (size_t)j * d;  // row j of Q^T is the column being built
    const int col = cols ? cols[j] : j;
    for (int r = tid; r < d; r += kThreads) q[r] = src[(size_t)r * ld + col];
    for (int pass = 0; pass < 2 && j > 0; ++pass) {
      // coefficients Q^T q, all taken from the same q
      for (int k = 0; k < j; ++k) {
        const float* qk = Qt + (size_t)k * d;
        float sum = 0.f;
        for (int r = tid; r < d; r += kThreads) sum += qk[r] * q[r];
        sum = warp_sum(sum);
        if (lane == 0) red[(size_t)warp * n + k] = sum;
      }
      __syncthreads();
      for (int k = tid; k < j; k += kThreads) {
        float c = 0.f;
        for (int v = 0; v < kWarps; ++v) c += red[(size_t)v * n + k];
        coef[k] = c;
      }
      __syncthreads();
      // q <- q - Q coef; each thread owns the same rows r of q and Q
      for (int r = tid; r < d; r += kThreads) {
        float proj = 0.f;
        for (int k = 0; k < j; ++k) proj += Qt[(size_t)k * d + r] * coef[k];
        q[r] = q[r] - proj;
      }
    }
    part = 0.f;
    for (int r = tid; r < d; r += kThreads) part += q[r] * q[r];
    const float nrm = sqrtf(block_sum(part, fscratch));
    const bool keep = nrm > 1e-8f;
    float dot = 0.f;
    for (int r = tid; r < d; r += kThreads) {
      const float v = keep ? __fdiv_rn(q[r], nrm + kEps) : 0.f;
      q[r] = v;
      dot += v * __fdiv_rn(gbar[r], gnorm);
    }
    dot = block_sum(dot, fscratch);
    captured += dot * dot;
    if (tid == 0) errors[j] = fminf(fmaxf(1.f - captured, 0.f), 1.f);
  }
}

// Index arithmetic inside a block is 32-bit: the launchers refuse operands
// of more than INT_MAX elements (the wrappers' guards stay far below).
bool too_large(long long a, long long b) { return a * b > (long long)INT_MAX; }

// The refresh's working set and scratch: everything in shared memory, or
// the working set in this block's slice of the global scratch `wglobal`.
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

__global__ void __launch_bounds__(kThreads)
graft_select_kernel(const float* __restrict__ V, const float* __restrict__ G,
                    const float* __restrict__ gbar, int32_t* __restrict__ pivots,
                    float* __restrict__ errors, float* __restrict__ logvol,
                    float* __restrict__ gsel, float* __restrict__ Qt,
                    float* wglobal, int K, int R, int d, int rank, int global_w) {
  extern __shared__ float smem[];
  const Plan p = carve(smem, wglobal, K, R, rank, global_w);
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
  Qt += b * (size_t)rank * d;

  const float lv = maxvol_stage(V, p.w, s, K, R, rank);

  // stage 2: exact gather of the pivot columns of G
  const int tid = threadIdx.x;
  for (int e = tid; e < d * rank; e += kThreads) {
    const int r = e / rank;
    gsel[e] = G[r * K + s.piv[e - r * rank]];
  }

  sweep_stage(G, K, s.piv, gbar, Qt, errors, d, rank, s.red, s.coef, s.fscratch);
  if (tid == 0) *logvol = lv;
  for (int j = tid; j < rank; j += kThreads) pivots[j] = s.piv[j];
}

__global__ void __launch_bounds__(kThreads)
fast_maxvol_kernel(const float* __restrict__ V, int32_t* __restrict__ pivots,
                   float* __restrict__ logvol, float* wglobal, int K, int R,
                   int rank, int global_w) {
  extern __shared__ float smem[];
  const Plan p = carve(smem, wglobal, K, R, rank, global_w);
  const float lv = maxvol_stage(V, p.w, p.s, K, R, rank);
  if (threadIdx.x == 0) *logvol = lv;
  for (int j = threadIdx.x; j < rank; j += kThreads) pivots[j] = p.s.piv[j];
}

__global__ void __launch_bounds__(kThreads)
projection_sweep_kernel(const float* __restrict__ G, const float* __restrict__ gbar,
                        float* __restrict__ errors, float* __restrict__ Qt,
                        float* rglobal, int d, int R, int global_red) {
  extern __shared__ float smem[];
  float* red = global_red ? rglobal : smem;
  float* coef = red + (size_t)kWarps * R;
  float* fscratch = global_red ? smem : coef + R;
  sweep_stage(G, R, nullptr, gbar, Qt, errors, d, R, red, coef, fscratch);
}

cudaError_t set_smem(const void* kernel, int smem_bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes);
}

}  // namespace

extern "C" {

// Launch B refreshes, one thread block each, on `stream`. Pointers are
// device pointers to contiguous float32 / int32 buffers laid out as
// V (B,K,R), G (B,d,K), gbar (B,d), pivots (B,rank), errors (B,rank),
// logvol (B,), gsel (B,d,rank) and the scratch Qt (B,rank,d). With
// `global_w` MaxVol's working set lives in `wscratch`, B * work_words(K,R)
// floats; otherwise in shared memory and `wscratch` is unused.
// `smem_bytes` is the dynamic shared memory the caller sized. Returns a
// cudaError_t code: nonzero if the arguments are refused or the launch fails.
int graft_select_launch(const void* V, const void* G, const void* gbar,
                        void* pivots, void* errors, void* logvol, void* gsel,
                        void* Qt, void* wscratch, int B, int K, int R, int d,
                        int rank, int global_w, int smem_bytes, void* stream) {
  if (B < 1 || B > 65535 || K < 1 || R < 1 || d < 1 || rank < 1 || rank > K || rank > R)
    return (int)cudaErrorInvalidValue;
  if (too_large(K, R) || too_large(d, K) || too_large(d, rank))
    return (int)cudaErrorInvalidValue;
  if (global_w && wscratch == nullptr) return (int)cudaErrorInvalidValue;
  if (smem_bytes < 0 || (size_t)smem_bytes < 4 * smem_words(K, R, rank, global_w))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem((const void*)graft_select_kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  graft_select_kernel<<<B, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)V, (const float*)G, (const float*)gbar, (int32_t*)pivots,
      (float*)errors, (float*)logvol, (float*)gsel, (float*)Qt,
      (float*)wscratch, K, R, d, rank, global_w);
  return (int)cudaGetLastError();
}

// Fast MaxVol alone for one V (K,R): pivots (rank,) int32, logvol (1,).
// `global_w` and `wscratch` (work_words(K,R) floats) as above.
int fast_maxvol_launch(const void* V, void* pivots, void* logvol, void* wscratch,
                       int K, int R, int rank, int global_w, int smem_bytes,
                       void* stream) {
  if (K < 1 || R < 1 || rank < 1 || rank > K || rank > R || too_large(K, R))
    return (int)cudaErrorInvalidValue;
  if (global_w && wscratch == nullptr) return (int)cudaErrorInvalidValue;
  if (smem_bytes < 0 || (size_t)smem_bytes < 4 * smem_words(K, R, rank, global_w))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem((const void*)fast_maxvol_kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  fast_maxvol_kernel<<<1, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)V, (int32_t*)pivots, (float*)logvol, (float*)wscratch, K, R,
      rank, global_w);
  return (int)cudaGetLastError();
}

// The projection sweep alone for one G (d,R) and gbar (d,): errors (R,),
// the basis scratch Qt (R,d). With `global_red` the reduction scratch lives
// in `rscratch`, sweep_red_words(R) floats; otherwise in shared memory.
int projection_sweep_launch(const void* G, const void* gbar, void* errors, void* Qt,
                            void* rscratch, int d, int R, int global_red,
                            int smem_bytes, void* stream) {
  if (d < 1 || R < 1 || too_large(d, R)) return (int)cudaErrorInvalidValue;
  if (global_red && rscratch == nullptr) return (int)cudaErrorInvalidValue;
  if (smem_bytes < 0 || (size_t)smem_bytes < 4 * sweep_smem_words(R, global_red))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem((const void*)projection_sweep_kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  projection_sweep_kernel<<<1, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)G, (const float*)gbar, (float*)errors, (float*)Qt,
      (float*)rscratch, d, R, global_red);
  return (int)cudaGetLastError();
}

}  // extern "C"
