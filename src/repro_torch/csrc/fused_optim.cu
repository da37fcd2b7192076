// The optimizer step's two passes over the train state, for Hopper (sm_90a).
//
// What they replace. The JAX package has no TPU kernel here: XLA fuses its
// jitted optimizer (src/repro/optim/optimizers.py). Two kernels take its place:
//   A  fused_norm_kernel + norm_finish_kernel: `global_norm` and the factor of
//      `clip_by_global_norm` (optimizers.py:43-52): norm = sqrt(sum g^2) in
//      float32 over every gradient leaf, scale = min(1, c / (norm + 1e-9)).
//   B  fused_update_kernel<rule>: one read-modify-write of p, m (and v) per
//      element for AdamW (optimizers.py:83-107), SGD + momentum (:117-133) or
//      Lion (:143-161), with the clipped gradient rounded to its dtype in
//      registers: gc = g_dtype(float(g) * scale), JAX's
//      `(g.astype(f32) * scale).astype(g.dtype)`.
//
// What bounds them on this card: bytes. A reads each gradient once (2 B a
// bf16 element) and does 1 multiply-add an element; B reads p, g, m, v and
// writes p, m, v (22 B an element for bf16 params with float32 moments) for
// ~15 float32 operations. Both sit far below the 20 FLOP a byte where the
// float32 cores (67 TFLOP/s) would take over from HBM (3.35 TB/s). At
// minicpm-2b (2.725 B bf16 parameters, float32 moments) that is 1.63 ms for A
// and 17.9 ms for B.
//
// Design.
//   * One launch walks every leaf. The wrapper uploads a leaf table (one
//     `Leaf` row of int64 per leaf: the device addresses, the length, the
//     index of the leaf's first chunk and flags), because the gradients are
//     new tensors every step. Leaves are cut into chunks of kChunk elements;
//     a block takes chunks c = blockIdx.x, + gridDim.x, ... and finds each
//     chunk's leaf by a binary search over the table's chunk starts. A chunk
//     never spans two leaves, so its addresses are contiguous.
//   * kChunk is a multiple of 8, so a chunk of a leaf whose addresses are all
//     16-byte aligned starts aligned too: its threads move 8 elements a unit
//     (one 16-byte load of bf16, two of float32), consecutive threads on
//     consecutive units, and finish the chunk's last len % 8 elements one by
//     one. A leaf with an address off 16 bytes runs element by element.
//   * B launches once for each (parameter dtype, state dtype) group of leaves,
//     a template instance each; the count of launches does not grow with the
//     count of leaves.
//   * B rounds where the plain PyTorch code rounds, in its order, with no FMA
//     contraction (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), and with the
//     scalars PyTorch uses on the card: each Python float as its float32 value
//     and a division by a Python float (the bias corrections) as a multiply by
//     the float32 reciprocal, as PyTorch's CUDA `div` by a scalar does. Given
//     the same scale it is bit-equal to the plain version on the card.
//   * A sums x^2 in float32 (fmaf) per thread over its chunks, then over the
//     block by a xor butterfly and the 8 warps in order, into the block's own
//     slot; a one-block pass adds the slots in slot order and writes norm and
//     scale. No float atomics, so reruns are bit-equal.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4096;       // elements a chunk; a multiple of 8
constexpr int kFinishThreads = 1024;
constexpr int kBlocksPerSm = 8;

enum Rule { kAdamW = 0, kSgd = 1, kLion = 2 };

// One row of the leaf table (7 int64, row-major, built by the wrapper).
struct Leaf {
  long long p, g, m, v;   // device addresses; 0 where the rule has no such tensor
  long long n;            // elements
  long long chunk0;       // index of the leaf's first chunk in this launch
  long long flags;        // bit 0: every address 16-byte aligned; bit 1: bf16 (A)
};

// The float32 scalars of one step (the host computes them from the config).
struct Hyper {
  float lr, b1, omb1, b2, omb2, inv_bc1, inv_bc2, eps, wd, mom;
};

template <typename T>
struct Io;

template <>
struct Io<float> {
  __device__ static __forceinline__ float get(const float* p, long long i) { return p[i]; }
  __device__ static __forceinline__ void put(float* p, long long i, float x) { p[i] = x; }
  __device__ static __forceinline__ float round(float x) { return x; }
  __device__ static __forceinline__ void load8(const float* p, float (&x)[8]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
  __device__ static __forceinline__ void store8(float* p, const float (&x)[8]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
};

template <>
struct Io<__nv_bfloat16> {
  __device__ static __forceinline__ float get(const __nv_bfloat16* p, long long i) {
    return __bfloat162float(p[i]);
  }
  __device__ static __forceinline__ void put(__nv_bfloat16* p, long long i, float x) {
    p[i] = __float2bfloat16_rn(x);
  }
  __device__ static __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ static __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      x[2 * k] = f.x;
      x[2 * k + 1] = f.y;
    }
  }
  __device__ static __forceinline__ void store8(__nv_bfloat16* p, const float (&x)[8]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      h[k] = __halves2bfloat162(__float2bfloat16_rn(x[2 * k]), __float2bfloat16_rn(x[2 * k + 1]));
    }
    *reinterpret_cast<uint4*>(p) = u;
  }
};

// The leaf that holds chunk c: the last row whose chunk0 <= c.
__device__ __forceinline__ int find_leaf(const Leaf* __restrict__ table, int n_leaves,
                                         long long c) {
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(&table[mid].chunk0) <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// ---------------------------------------------------------------------------
// B: the update rules, each rounding where the plain version rounds
// ---------------------------------------------------------------------------

template <int R>
__device__ __forceinline__ void apply_rule(const Hyper& h, float g, float& p, float& m,
                                           float& v) {
  if (R == kAdamW) {
    // m' = b1 m + (1-b1) g;  v' = b2 v + ((1-b2) g) g
    const float m_new = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
    const float v_new = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
    // (m'/bc1) / (sqrt(v'/bc2) + eps) + wd p
    float u = __fdiv_rn(__fmul_rn(m_new, h.inv_bc1),
                        __fadd_rn(__fsqrt_rn(__fmul_rn(v_new, h.inv_bc2)), h.eps));
    u = __fadd_rn(u, __fmul_rn(h.wd, p));
    p = __fsub_rn(p, __fmul_rn(h.lr, u));
    m = m_new;
    v = v_new;
  } else if (R == kSgd) {
    // m' = mom m + g;  p - lr (m' + wd p)
    const float m_new = __fadd_rn(__fmul_rn(h.mom, m), g);
    p = __fsub_rn(p, __fmul_rn(h.lr, __fadd_rn(m_new, __fmul_rn(h.wd, p))));
    m = m_new;
  } else {
    // c = b1 m + (1-b1) g;  p - lr (sign(c) + wd p);  m' = b2 m + (1-b2) g
    const float c = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
    const float s = (float)((c > 0.0f) - (c < 0.0f));   // torch.sign: 0 at 0
    p = __fsub_rn(p, __fmul_rn(h.lr, __fadd_rn(s, __fmul_rn(h.wd, p))));
    m = __fadd_rn(__fmul_rn(h.b2, m), __fmul_rn(h.omb2, g));
  }
}

template <int R, typename PT, typename ST>
__device__ __forceinline__ void update_one(const Hyper& h, bool clip, float scale, PT* p,
                                           const PT* g, ST* m, ST* v, long long i) {
  float gf = Io<PT>::get(g, i);
  if (clip) gf = Io<PT>::round(__fmul_rn(gf, scale));
  float pf = Io<PT>::get(p, i), mf = Io<ST>::get(m, i);
  float vf = (R == kAdamW) ? Io<ST>::get(v, i) : 0.0f;
  apply_rule<R>(h, gf, pf, mf, vf);
  Io<PT>::put(p, i, pf);
  Io<ST>::put(m, i, mf);
  if (R == kAdamW) Io<ST>::put(v, i, vf);
}

template <int R, typename PT, typename ST>
__global__ void __launch_bounds__(kThreads)
fused_update_kernel(const Leaf* __restrict__ table, int n_leaves, long long n_chunks,
                    const float* __restrict__ scale_ptr, Hyper h) {
  const bool clip = scale_ptr != nullptr;
  const float scale = clip ? __ldg(scale_ptr) : 1.0f;
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Leaf* L = &table[find_leaf(table, n_leaves, c)];
    PT* p = reinterpret_cast<PT*>(__ldg(&L->p));
    const PT* g = reinterpret_cast<const PT*>(__ldg(&L->g));
    ST* m = reinterpret_cast<ST*>(__ldg(&L->m));
    ST* v = reinterpret_cast<ST*>(__ldg(&L->v));
    const long long off = (c - __ldg(&L->chunk0)) * kChunk;
    const long long rest = __ldg(&L->n) - off;
    const int len = rest < kChunk ? (int)rest : kChunk;
    int done = 0;
    if (__ldg(&L->flags) & 1) {
      const int units = len / 8;
      for (int u = threadIdx.x; u < units; u += kThreads) {
        const long long i = off + 8LL * u;
        float pf[8], gf[8], mf[8], vf[8];
        Io<PT>::load8(p + i, pf);
        Io<PT>::load8(g + i, gf);
        Io<ST>::load8(m + i, mf);
        if (R == kAdamW) Io<ST>::load8(v + i, vf);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float gk = clip ? Io<PT>::round(__fmul_rn(gf[k], scale)) : gf[k];
          float vk = (R == kAdamW) ? vf[k] : 0.0f;
          apply_rule<R>(h, gk, pf[k], mf[k], vk);
          vf[k] = vk;
        }
        Io<PT>::store8(p + i, pf);
        Io<ST>::store8(m + i, mf);
        if (R == kAdamW) Io<ST>::store8(v + i, vf);
      }
      done = units * 8;
    }
    for (int j = done + threadIdx.x; j < len; j += kThreads) {
      update_one<R, PT, ST>(h, clip, scale, p, g, m, v, off + j);
    }
  }
}

// ---------------------------------------------------------------------------
// A: sum of squares, then norm and clip factor
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ float chunk_sumsq(const T* g, long long off, int len, bool aligned,
                                             float acc) {
  int done = 0;
  if (aligned) {
    const int units = len / 8;
    for (int u = threadIdx.x; u < units; u += kThreads) {
      float x[8];
      Io<T>::load8(g + off + 8LL * u, x);
      float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
      for (int k = 0; k < 8; k += 2) {
        a0 = fmaf(x[k], x[k], a0);
        a1 = fmaf(x[k + 1], x[k + 1], a1);
      }
      acc += a0 + a1;
    }
    done = units * 8;
  }
  for (int j = done + threadIdx.x; j < len; j += kThreads) {
    const float x = Io<T>::get(g, off + j);
    acc = fmaf(x, x, acc);
  }
  return acc;
}

// Sum over the block's threads in a fixed order: a xor butterfly in each
// warp, then the warps in order by thread 0. Returns the sum in thread 0.
template <int kBlockWarps>
__device__ __forceinline__ float block_sum(float x, float* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) smem[warp] = x;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kBlockWarps; ++w) total += smem[w];
  }
  return total;
}

__global__ void __launch_bounds__(kThreads)
fused_norm_kernel(const Leaf* __restrict__ table, int n_leaves, long long n_chunks,
                  float* __restrict__ partials) {
  __shared__ float smem[kWarps];
  float acc = 0.0f;
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Leaf* L = &table[find_leaf(table, n_leaves, c)];
    const long long off = (c - __ldg(&L->chunk0)) * kChunk;
    const long long rest = __ldg(&L->n) - off;
    const int len = rest < kChunk ? (int)rest : kChunk;
    const long long flags = __ldg(&L->flags);
    const long long g = __ldg(&L->g);
    if (flags & 2) {
      acc = chunk_sumsq(reinterpret_cast<const __nv_bfloat16*>(g), off, len, flags & 1, acc);
    } else {
      acc = chunk_sumsq(reinterpret_cast<const float*>(g), off, len, flags & 1, acc);
    }
  }
  const float total = block_sum<kWarps>(acc, smem);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kFinishThreads)
norm_finish_kernel(const float* __restrict__ partials, int n_partials, float clip, int has_clip,
                   float* __restrict__ out) {
  __shared__ float smem[kFinishThreads / 32];
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n_partials; i += kFinishThreads) acc += partials[i];
  const float total = block_sum<kFinishThreads / 32>(acc, smem);
  if (threadIdx.x == 0) {
    const float norm = __fsqrt_rn(total);
    float scale = 1.0f;
    if (has_clip) {
      scale = __fdiv_rn(clip, __fadd_rn(norm, 1e-9f));
      scale = scale > 1.0f ? 1.0f : scale;     // NaN stays NaN, as torch.clamp
    }
    out[0] = norm;
    out[1] = scale;
  }
}

template <int R>
int launch_update(int p_bf16, int s_bf16, const Leaf* table, int n_leaves, long long n_chunks,
                  int grid, const float* scale, const Hyper& h, cudaStream_t stream) {
  if (p_bf16 && s_bf16) {
    fused_update_kernel<R, __nv_bfloat16, __nv_bfloat16>
        <<<grid, kThreads, 0, stream>>>(table, n_leaves, n_chunks, scale, h);
  } else if (p_bf16) {
    fused_update_kernel<R, __nv_bfloat16, float>
        <<<grid, kThreads, 0, stream>>>(table, n_leaves, n_chunks, scale, h);
  } else if (s_bf16) {
    fused_update_kernel<R, float, __nv_bfloat16>
        <<<grid, kThreads, 0, stream>>>(table, n_leaves, n_chunks, scale, h);
  } else {
    fused_update_kernel<R, float, float>
        <<<grid, kThreads, 0, stream>>>(table, n_leaves, n_chunks, scale, h);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements a chunk: the wrapper numbers each leaf's chunks with it.
int fused_optim_chunk_elems(void) { return kChunk; }

// Blocks a launch takes for each SM of the card, at most: the wrapper sizes
// each grid as min(chunks, SMs * this), with the SM count of the tensors' card.
int fused_optim_blocks_per_sm(void) { return kBlocksPerSm; }

// A: table (n_leaves Leaf rows, the g column and flags used) -> out[0] = norm,
// out[1] = the clip factor (1 without clip). The first pass runs `grid` blocks
// and `partials` holds `grid` floats, one a block. Returns a cudaError_t code.
int fused_optim_norm_launch(const void* table, const void* partials, const void* out,
                            int n_leaves, long long n_chunks, int grid, float clip, int has_clip,
                            void* stream) {
  if (n_leaves <= 0 || n_chunks <= 0 || grid <= 0) return (int)cudaErrorInvalidValue;
  fused_norm_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const Leaf*)table, n_leaves, n_chunks, (float*)partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  norm_finish_kernel<<<1, kFinishThreads, 0, (cudaStream_t)stream>>>(
      (const float*)partials, grid, clip, has_clip, (float*)out);
  return (int)cudaGetLastError();
}

// B: one rule (0 AdamW, 1 SGD, 2 Lion) over the table's leaves, all of one
// parameter dtype (p_bf16) and one state dtype (s_bf16), in place. `scale`
// is A's clip factor on the device, or null for unclipped gradients. `grid`
// blocks walk the chunks.
int fused_optim_update_launch(const void* table, const void* scale, int rule, int p_bf16,
                              int s_bf16, int n_leaves, long long n_chunks, int grid,
                              float lr, float b1, float omb1, float b2, float omb2,
                              float inv_bc1, float inv_bc2, float eps, float wd, float mom,
                              void* stream) {
  if (n_leaves <= 0 || n_chunks <= 0 || grid <= 0) return (int)cudaErrorInvalidValue;
  const Hyper h{lr, b1, omb1, b2, omb2, inv_bc1, inv_bc2, eps, wd, mom};
  const Leaf* t = (const Leaf*)table;
  const float* s = (const float*)scale;
  cudaStream_t st = (cudaStream_t)stream;
  switch (rule) {
    case kAdamW:
      return launch_update<kAdamW>(p_bf16, s_bf16, t, n_leaves, n_chunks, grid, s, h, st);
    case kSgd:
      return launch_update<kSgd>(p_bf16, s_bf16, t, n_leaves, n_chunks, grid, s, h, st);
    case kLion:
      return launch_update<kLion>(p_bf16, s_bf16, t, n_leaves, n_chunks, grid, s, h, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
