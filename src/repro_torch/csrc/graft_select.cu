// One whole GRAFT selection refresh in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_graft_select_pallas` (`_fused_kernel` ->
// `_fused_body`) in src/repro/kernels/graft_select.py. It computes the same
// function:
//   1. Fast MaxVol over V (K, R): for each column j, the argmax of |W[i, j]|
//      over the rows still available (first index on ties), the safe-pivot
//      guard, the rank-1 elimination with the pivot row kept, and
//      logvol += log|pivot|;
//   2. the exact gather G_sel[:, j] = G[:, pivots[j]];
//   3. the prefix projection errors of G_sel against g_hat = g_bar / |g_bar|
//      by two classical Gram-Schmidt passes per column (CGS2: all
//      coefficients of a pass come from the same q, q <- q - Q (Q^T q)),
//      errors[j] = clip(1 - sum_{k<=j} (q_k . g_hat)^2, 0, 1).
//
// What bounds it on this card: at the training path's shapes (K=16, R=8,
// d=2304, rank 8) the function moves about 0.23 MB and does about 0.7 MFLOP,
// which an H100 could do in well under a microsecond. The work is a chain of
// `rank` dependent pivot steps and `2 * rank` dependent Gram-Schmidt passes,
// each ending in a block-wide reduction, so the kernel is bound by latency:
// launch latency plus one barrier round trip per step, not by bytes or FLOPs.
//
// What the design does about it: the whole refresh runs in ONE thread block
// (blockIdx.x is the batch index, so the grid=(B,) variant needs only a new
// wrapper), so the three stages cost one launch instead of three and
// nothing round-trips through the host. The TPU kept V and G resident in a
// 12 MB VMEM block; a Hopper block has at most 227 KB of shared memory, so
// only V's working copy W lives in shared memory (the wrapper refuses shapes
// whose K*R*4 bytes do not fit), G is read from global memory (L2) for the
// gather, and the Gram-Schmidt basis Q is a global scratch that the wrapper
// allocates, stored transposed (rank, d) so that every pass reads it
// coalesced. Each thread owns the same d-rows of q and Q in every pass, so
// the sweep needs barriers only around its reductions.
//
// Rounding: past the true rank of V the residual columns are rounding noise
// and the argmax picks among it, so the elimination must round exactly as
// the reference does. XLA compiles the JAX reference's `W - f * p` for the
// CPU as a fused multiply-add, so the kernel writes it as __fmaf_rn(-f, p, W)
// (one rounding, never left to the compiler's contraction) after an IEEE
// division __fdiv_rn; the plain PyTorch version forms the product exactly in
// float64 and rounds the difference once (core/maxvol.py). The projection
// sweep sums in another order than PyTorch, so its errors agree to a
// tolerance, not bit for bit.

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

// Dynamic shared memory, in 4-byte words (the Python wrapper's
// smem_bytes() computes the same sum):
//   floats: W[K*R], factor[K], prow[R], red[kWarps*rank], coef[rank],
//           fscratch[kWarps], pivot value[1]
//   ints:   iscratch[kWarps], avail[K], piv[rank], pivot index[1]
__host__ __device__ inline size_t smem_words(int K, int R, int rank) {
  return (size_t)K * R + 2 * (size_t)K + R + (size_t)(kWarps + 2) * rank +
         2 * kWarps + 2;
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

__global__ void __launch_bounds__(kThreads)
graft_select_kernel(const float* __restrict__ V, const float* __restrict__ G,
                    const float* __restrict__ gbar, int32_t* __restrict__ pivots,
                    float* __restrict__ errors, float* __restrict__ logvol,
                    float* __restrict__ gsel, float* __restrict__ Qt,
                    int K, int R, int d, int rank) {
  extern __shared__ float smem[];
  float* W = smem;
  float* factor = W + (size_t)K * R;
  float* prow = factor + K;
  float* red = prow + R;
  float* coef = red + kWarps * rank;
  float* fscratch = coef + rank;
  float* s_pv = fscratch + kWarps;
  int* iscratch = reinterpret_cast<int*>(s_pv + 1);
  int* avail = iscratch + kWarps;
  int* piv = avail + K;
  int* s_pj = piv + rank;

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

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  for (int e = tid; e < K * R; e += kThreads) W[e] = V[e];
  for (int i = tid; i < K; i += kThreads) avail[i] = 1;
  __syncthreads();

  // ---- stage 1: Fast MaxVol on the shared-memory copy W of V ----
  float lv = 0.f;  // running log-volume, kept by thread 0
  for (int j = 0; j < rank; ++j) {
    float bs = -CUDART_INF_F;
    int bi = INT_MAX;
    for (int i = tid; i < K; i += kThreads) {
      const float s = avail[i] ? fabsf(W[i * R + j]) : -1.0f;
      if (better(s, i, bs, bi)) { bs = s; bi = i; }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float os = __shfl_xor_sync(kFull, bs, o);
      const int oi = __shfl_xor_sync(kFull, bi, o);
      if (better(os, oi, bs, bi)) { bs = os; bi = oi; }
    }
    if (lane == 0) { fscratch[warp] = bs; iscratch[warp] = bi; }
    __syncthreads();
    if (tid == 0) {
      float s = fscratch[0];
      int i = iscratch[0];
      for (int w = 1; w < kWarps; ++w)
        if (better(fscratch[w], iscratch[w], s, i)) { s = fscratch[w]; i = iscratch[w]; }
      const float x = W[i * R + j];
      const float pv = fabsf(x) < kPivotEps ? (x >= 0.f ? kPivotEps : -kPivotEps) : x;
      *s_pj = i;
      *s_pv = pv;
      piv[j] = i;
      avail[i] = 0;
      lv += logf(fabsf(pv));
    }
    __syncthreads();
    const int pj = *s_pj;
    const float pv = *s_pv;
    for (int i = tid; i < K; i += kThreads) factor[i] = __fdiv_rn(W[i * R + j], pv);
    for (int c = tid; c < R; c += kThreads) prow[c] = W[pj * R + c];
    __syncthreads();
    for (int e = tid; e < K * R; e += kThreads) {
      const int i = e / R;
      if (i != pj) W[e] = __fmaf_rn(-factor[i], prow[e - i * R], W[e]);
    }
    __syncthreads();
  }

  // ---- stage 2: exact gather of the pivot columns of G ----
  for (int e = tid; e < d * rank; e += kThreads) {
    const int r = e / rank;
    gsel[e] = G[(size_t)r * K + piv[e - r * rank]];
  }

  // ---- stage 3: CGS2 prefix projection sweep against g_hat ----
  float part = 0.f;
  for (int r = tid; r < d; r += kThreads) part += gbar[r] * gbar[r];
  const float gnorm = sqrtf(block_sum(part, fscratch) + kEps);
  float captured = 0.f;  // identical in every thread
  for (int j = 0; j < rank; ++j) {
    float* q = Qt + (size_t)j * d;  // row j of Q^T is the column being built
    const int pcol = piv[j];
    for (int r = tid; r < d; r += kThreads) q[r] = G[(size_t)r * K + pcol];
    for (int pass = 0; pass < 2 && j > 0; ++pass) {
      // coefficients Q^T q, all taken from the same q
      for (int k = 0; k < j; ++k) {
        const float* qk = Qt + (size_t)k * d;
        float s = 0.f;
        for (int r = tid; r < d; r += kThreads) s += qk[r] * q[r];
        s = warp_sum(s);
        if (lane == 0) red[warp * rank + k] = s;
      }
      __syncthreads();
      for (int k = tid; k < j; k += kThreads) {
        float c = 0.f;
        for (int w = 0; w < kWarps; ++w) c += red[w * rank + k];
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
  if (tid == 0) *logvol = lv;
  for (int j = tid; j < rank; j += kThreads) pivots[j] = piv[j];
}

}  // namespace

extern "C" {

// Launch B refreshes, one thread block each, on `stream`. Pointers are
// device pointers to contiguous float32 / int32 buffers laid out as
// V (B,K,R), G (B,d,K), gbar (B,d), pivots (B,rank), errors (B,rank),
// logvol (B,), gsel (B,d,rank) and the scratch Qt (B,rank,d).
// `smem_bytes` is the dynamic shared memory the caller sized. Returns a
// cudaError_t code: nonzero if the arguments are refused or the launch fails.
int graft_select_launch(const void* V, const void* G, const void* gbar,
                        void* pivots, void* errors, void* logvol, void* gsel,
                        void* Qt, int B, int K, int R, int d, int rank,
                        int smem_bytes, void* stream) {
  if (B < 1 || K < 1 || R < 1 || d < 1 || rank < 1 || rank > K || rank > R)
    return (int)cudaErrorInvalidValue;
  if (smem_bytes < 0 || (size_t)smem_bytes < 4 * smem_words(K, R, rank))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      graft_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  graft_select_kernel<<<B, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)V, (const float*)G, (const float*)gbar, (int32_t*)pivots,
      (float*)errors, (float*)logvol, (float*)gsel, (float*)Qt, K, R, d, rank);
  return (int)cudaGetLastError();
}

}  // extern "C"
