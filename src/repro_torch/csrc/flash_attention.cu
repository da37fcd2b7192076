// Flash attention for Hopper (sm_90a): the forward, dQ and dK/dV kernels.
//
// Replaces the three TPU kernels of src/repro/kernels/flash_attention.py:
//   flash_fwd_kernel  <- `_forward` -> `_flash_kernel` (causal online-softmax
//                        attention, returns o and the logsumexp lse);
//   flash_dq_kernel   <- `_backward` -> `_flash_dq_kernel` (recompute
//                        p = exp(s - lse), ds = p (do.v^T - delta), dq = ds.k);
//   flash_dkv_kernel  <- `_backward` -> `_flash_dkv_kernel` (dk = ds^T.q,
//                        dv = p^T.do per KV tile, looping q tiles and the GQA
//                        group).
// Same function as the TPU kernels: a causal mask (or none), a sliding window
// w as a runtime int (keys with k > q - w stay; w >= T is a no-op), an
// optional logit softcap s <- cap tanh(s / cap) with its chain-rule factor
// 1 - t^2 in the backward, GQA by reading kv stream bh / group, masked scores
// filled with -1e30, and the masked-row guard: a row whose whole horizon is
// masked gets p = 0, o = 0 and lse = +inf. m, l, acc and every product run in
// float32 whatever the input type (bf16 or f32), as on the TPU.
//
// What bounds them on this card: at the training path's shape (576 streams,
// S = 256, Dh = 64, bf16) the forward moves ~76 MB and needs ~5 GFLOP, so an
// ideal kernel would be bound by bytes (~23 us at 3.35 TB/s); at 4096 tokens
// it needs ~77 GFLOP and is bound by operations (~78 us at the 989 TFLOP/s
// bf16 tensor-core rate). These kernels do their products on the float32
// CUDA cores (67 TFLOP/s peak), without tensor cores, so they are bound by
// float32 operations and by shared-memory traffic, well above either bound.
//
// What the design does about it: each block stages tiles of TILE rows in
// shared memory as float32, stored d-major (x[d * LD + row], LD = TILE + 4)
// so that every inner product reads 2 or 4 neighbouring rows as one vector
// load, and each of the 256 threads keeps a (TILE/16) x (TILE/16) block of
// the score tile and (TILE/16) rows x ceil(Dh/16) columns of its output
// accumulator in registers. The TPU kernel keeps the whole (T, Dh) K/V stream
// resident in VMEM under a 12 MB guard; a Hopper block has 227 KB, so here
// the KV stream is tiled and only one K/V tile is resident at a time, which
// puts no limit on T. Causal and window tile bounds skip tiles with no
// unmasked entry; a skipped tile would contribute alpha = 1 and p = 0
// exactly, so bound_loop = 0 (scan every tile) gives bit-equal results.
// dK/dV owns one KV tile per block and loops over every q head of its GQA
// group, so no atomics are needed and every run gives the same bits.
// Tensor cores (mma.sync / wgmma), TMA and pipelining are not used yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // a 16 x 16 thread grid
constexpr float kMask = -1e30f;        // flash_attention.py _MASK
constexpr float kMaskGuard = -0.5e30f; // flash_attention.py _MASK_GUARD
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxHeadDim = 256;
constexpr int kMaxSmemBytes = 232448;  // 227 KB, one Hopper block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// R neighbouring floats from 8- or 16-byte-aligned shared memory
__device__ __forceinline__ void ld(float (&x)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void ld(float (&x)[2], const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  x[0] = v.x; x[1] = v.y;
}

// Head-dim class: each thread owns output columns d = tx + 16 j, j < NC.
// TILE = 32 above Dh 160 keeps the backward's five tiles under 227 KB.
__host__ __device__ inline int nc_class(int Dh) {
  return Dh <= 32 ? 2 : Dh <= 64 ? 4 : Dh <= 128 ? 8 : Dh <= 160 ? 10 : 16;
}
__host__ __device__ inline int tile_of(int nc) { return nc == 16 ? 32 : 64; }

// Dynamic shared memory of each kernel, in bytes (the Python wrapper's
// smem_bytes() computes the same sums).
inline size_t fwd_smem(int Dh, int tile) {      // Qt, Kt, Vt; Pt
  return 4 * (size_t)(3 * Dh + tile) * (tile + 4);
}
inline size_t dq_smem(int Dh, int tile) {       // Qt, dOt, Kt, Vt; dSt
  return 4 * (size_t)(4 * Dh + tile) * (tile + 4);
}
inline size_t dkv_smem(int Dh, int tile) {      // Kt, Vt, Qt, dOt; P, dS; lse, delta
  return 4 * ((size_t)(4 * Dh + 2 * tile) * (tile + 4) + 2 * (size_t)tile);
}

__device__ __forceinline__ bool valid(int qi, int kj, int Sq, int Tk, int causal,
                                      int window) {
  return qi < Sq && kj < Tk && (!causal || kj <= qi) && kj > qi - window;
}

// Rows [row0, row0 + TILE) of a (nrows, Dh) row-major stream into shared
// memory as dst[d * LD + r], times `mul`; rows past nrows are zero.
template <typename T, int TILE>
__device__ void load_t(float* dst, const T* __restrict__ src, int row0, int nrows,
                       int Dh, float mul) {
  constexpr int LD = TILE + 4;
  for (int e = threadIdx.x; e < TILE * Dh; e += kThreads) {
    const int r = e / Dh, d = e - r * Dh;
    const int row = row0 + r;
    dst[d * LD + r] = row < nrows ? to_f32(src[(size_t)row * Dh + d]) * mul : 0.f;
  }
}

// out[i][j] = sum_d A[d][ra + i] * B[d][cb + j] over the d-major tiles A, B.
template <int TILE>
__device__ __forceinline__ void tile_dot(float (&out)[TILE / 16][TILE / 16],
                                         const float* A, const float* B, int ra,
                                         int cb, int Dh) {
  constexpr int R = TILE / 16, LD = TILE + 4;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) out[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < Dh; ++d) {
    float a[R], b[R];
    ld(a, A + d * LD + ra);
    ld(b, B + d * LD + cb);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) out[i][j] = fmaf(a[i], b[j], out[i][j]);
  }
}

// acc[i][j] += sum_c X[c][ra + i] * Y[d_j][c], d_j = tx + 16 j < Dh: a
// (TILE x TILE) tile X, stored with its reduction index c major, times the
// d-major tile Y.
template <int TILE, int NC>
__device__ __forceinline__ void tile_acc(float (&acc)[TILE / 16][NC], const float* X,
                                         const float* Y, int ra, int tx, int Dh) {
  constexpr int R = TILE / 16, LD = TILE + 4;
#pragma unroll 2
  for (int c = 0; c < TILE; ++c) {
    float x[R];
    ld(x, X + c * LD + ra);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int d = tx + 16 * j;
      if (d < Dh) {
        const float y = Y[d * LD + c];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][j] = fmaf(x[i], y, acc[i][j]);
      }
    }
  }
}

// Reduce over the 16 threads (tx) that share a row; the xor butterfly leaves
// the same bits in every lane (each step adds the same two values).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Softcap (when cap > 0) and mask one raw score, as `_tile_scores`.
__device__ __forceinline__ float score(float s, bool ok, float cap) {
  if (cap > 0.f) s = cap * tanhf(s / cap);
  return ok ? s : kMask;
}

// ds = p (dp - delta), times the softcap factor 1 - t^2 (0 where masked).
__device__ __forceinline__ float dscore(float s, float p, float dp, float delta,
                                        bool ok, float cap) {
  float ds = p * (dp - delta);
  if (cap > 0.f) {
    const float t = s / cap;
    ds *= ok ? 1.f - t * t : 0.f;
  }
  return ds;
}

// [lo, hi) KV tiles that can hold an unmasked entry for q rows [q0, q0+TILE)
// (`_kv_bounds` for this kernel's tiles).
template <int TILE>
__device__ __forceinline__ void kv_bounds(int q0, int Sq, int Tk, int causal,
                                          int window, int bound_loop, int* lo,
                                          int* hi) {
  const int nk = (Tk + TILE - 1) / TILE;
  *lo = 0;
  *hi = nk;
  if (!bound_loop) return;
  if (causal) {
    const int q_end = min(q0 + TILE, Sq);  // keys <= q_end - 1
    *hi = min(nk, (q_end + TILE - 1) / TILE);
  }
  *lo = max(0, (q0 - window + 1) / TILE);  // keys >= q0 - window + 1
}

// [lo, hi) q tiles that can see KV rows [k0, k0+TILE) (the dK/dV q-loop
// bounds): causal needs q >= k0, the window q <= k_end - 1 + window - 1.
template <int TILE>
__device__ __forceinline__ void q_bounds(int k0, int Sq, int Tk, int causal,
                                         int window, int bound_loop, int* lo,
                                         int* hi) {
  const int nq = (Sq + TILE - 1) / TILE;
  *lo = 0;
  *hi = nq;
  if (!bound_loop) return;
  if (causal) *lo = k0 / TILE;
  const int last = min(k0 + TILE, Tk) + window - 2;
  *hi = last < 0 ? 0 : min(nq, last / TILE + 1);
}

// ---------------------------------------------------------------------------
// forward: one block per (q stream, q tile)
// ---------------------------------------------------------------------------
template <typename T, int NC, int TILE>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                 int Sq, int Tk, int Dh, int group, int causal, int window,
                 float softcap, float scale, int bound_loop) {
  constexpr int R = TILE / 16, LD = TILE + 4;
  extern __shared__ float4 smem_f4[];
  float* Qt = reinterpret_cast<float*>(smem_f4);
  float* Kt = Qt + Dh * LD;
  float* Vt = Kt + Dh * LD;
  float* Pt = Vt + Dh * LD;  // Pt[c * LD + r]

  const int bh = blockIdx.x, q0 = blockIdx.y * TILE;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int ra = ty * R, cb = tx * R;
  q += (size_t)bh * Sq * Dh;
  o += (size_t)bh * Sq * Dh;
  k += (size_t)(bh / group) * Tk * Dh;
  v += (size_t)(bh / group) * Tk * Dh;

  load_t<T, TILE>(Qt, q, q0, Sq, Dh, scale);
  float m[R], l[R], acc[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kMask;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  int lo, hi;
  kv_bounds<TILE>(q0, Sq, Tk, causal, window, bound_loop, &lo, &hi);
  for (int it = lo; it < hi; ++it) {
    const int k0 = it * TILE;
    __syncthreads();  // the previous tile's readers are done
    load_t<T, TILE>(Kt, k, k0, Tk, Dh, 1.f);
    load_t<T, TILE>(Vt, v, k0, Tk, Dh, 1.f);
    __syncthreads();
    float s[R][R];
    tile_dot<TILE>(s, Qt, Kt, ra, cb, Dh);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float mt = kMask;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = score(s[i][j], valid(q0 + ra + i, k0 + cb + j, Sq, Tk, causal, window),
                        softcap);
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mt));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        // a row masked so far keeps m_new at kMask: p = 0, not exp(0) = 1
        s[i][j] = m_new > kMaskGuard ? expf(s[i][j] - m_new) : 0.f;
        ps += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < R; ++j) Pt[(cb + j) * LD + ra + i] = s[i][j];
    }
    __syncthreads();
    tile_acc<TILE, NC>(acc, Pt, Vt, ra, tx, Dh);
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ra + i;
    if (qi >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int d = tx + 16 * j;
      if (d < Dh) store(o + (size_t)qi * Dh + d, acc[i][j] / den);
    }
    if (tx == 0) lse[(size_t)bh * Sq + qi] = l[i] > 0.f ? m[i] + logf(den) : CUDART_INF_F;
  }
}

// ---------------------------------------------------------------------------
// dQ: the forward's grid and KV loop
// ---------------------------------------------------------------------------
template <typename T, int NC, int TILE>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int Sq, int Tk, int Dh, int group, int causal,
                int window, float softcap, float scale, int bound_loop) {
  constexpr int R = TILE / 16, LD = TILE + 4;
  extern __shared__ float4 smem_f4[];
  float* Qt = reinterpret_cast<float*>(smem_f4);
  float* dOt = Qt + Dh * LD;
  float* Kt = dOt + Dh * LD;
  float* Vt = Kt + Dh * LD;
  float* dSt = Vt + Dh * LD;  // dSt[c * LD + r]

  const int bh = blockIdx.x, q0 = blockIdx.y * TILE;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int ra = ty * R, cb = tx * R;
  const size_t qoff = (size_t)bh * Sq * Dh;
  k += (size_t)(bh / group) * Tk * Dh;
  v += (size_t)(bh / group) * Tk * Dh;

  load_t<T, TILE>(Qt, q + qoff, q0, Sq, Dh, scale);
  load_t<T, TILE>(dOt, dout + qoff, q0, Sq, Dh, 1.f);
  float row_lse[R], row_delta[R], acc[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ra + i;
    row_lse[i] = qi < Sq ? lse[(size_t)bh * Sq + qi] : CUDART_INF_F;
    row_delta[i] = qi < Sq ? delta[(size_t)bh * Sq + qi] : 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  int lo, hi;
  kv_bounds<TILE>(q0, Sq, Tk, causal, window, bound_loop, &lo, &hi);
  for (int it = lo; it < hi; ++it) {
    const int k0 = it * TILE;
    __syncthreads();
    load_t<T, TILE>(Kt, k, k0, Tk, Dh, 1.f);
    load_t<T, TILE>(Vt, v, k0, Tk, Dh, 1.f);
    __syncthreads();
    float s[R][R], dp[R][R];
    tile_dot<TILE>(s, Qt, Kt, ra, cb, Dh);
    tile_dot<TILE>(dp, dOt, Vt, ra, cb, Dh);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const bool ok = valid(q0 + ra + i, k0 + cb + j, Sq, Tk, causal, window);
        const float x = score(s[i][j], ok, softcap);
        const float p = expf(x - row_lse[i]);  // normalized; 0 where masked
        dSt[(cb + j) * LD + ra + i] = dscore(x, p, dp[i][j], row_delta[i], ok, softcap);
      }
    __syncthreads();
    tile_acc<TILE, NC>(acc, dSt, Kt, ra, tx, Dh);
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ra + i;
    if (qi >= Sq) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int d = tx + 16 * j;
      if (d < Dh) store(dq + qoff + (size_t)qi * Dh + d, acc[i][j] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one block per (kv stream, KV tile); loops the group's q heads and
// their q tiles, so each output element is written by one thread, once
// ---------------------------------------------------------------------------
template <typename T, int NC, int TILE>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, int Sq, int Tk, int Dh,
                 int group, int causal, int window, float softcap, float scale,
                 int bound_loop) {
  constexpr int R = TILE / 16, LD = TILE + 4;
  extern __shared__ float4 smem_f4[];
  float* Kt = reinterpret_cast<float*>(smem_f4);
  float* Vt = Kt + Dh * LD;
  float* Qt = Vt + Dh * LD;
  float* dOt = Qt + Dh * LD;
  float* Pr = dOt + Dh * LD;    // Pr[r * LD + c]
  float* dSr = Pr + TILE * LD;  // dSr[r * LD + c]
  float* s_lse = dSr + TILE * LD;
  float* s_delta = s_lse + TILE;

  const int bkv = blockIdx.x, k0 = blockIdx.y * TILE;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int ra = ty * R, cb = tx * R;  // this thread's KV rows ra.., q rows cb..
  const size_t kvoff = (size_t)bkv * Tk * Dh;

  load_t<T, TILE>(Kt, k + kvoff, k0, Tk, Dh, 1.f);
  load_t<T, TILE>(Vt, v + kvoff, k0, Tk, Dh, 1.f);
  float dk_acc[R][NC], dv_acc[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  int lo, hi;
  q_bounds<TILE>(k0, Sq, Tk, causal, window, bound_loop, &lo, &hi);
  for (int g = 0; g < group; ++g) {
    const int bh = bkv * group + g;
    const size_t qoff = (size_t)bh * Sq * Dh;
    for (int it = lo; it < hi; ++it) {
      const int q0 = it * TILE;
      __syncthreads();
      load_t<T, TILE>(Qt, q + qoff, q0, Sq, Dh, scale);
      load_t<T, TILE>(dOt, dout + qoff, q0, Sq, Dh, 1.f);
      for (int r = threadIdx.x; r < TILE; r += kThreads) {
        const int qi = q0 + r;
        s_lse[r] = qi < Sq ? lse[(size_t)bh * Sq + qi] : CUDART_INF_F;
        s_delta[r] = qi < Sq ? delta[(size_t)bh * Sq + qi] : 0.f;
      }
      __syncthreads();
      float s[R][R], dp[R][R];  // transposed: [kv row][q row]
      tile_dot<TILE>(s, Kt, Qt, ra, cb, Dh);
      tile_dot<TILE>(dp, Vt, dOt, ra, cb, Dh);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int r = cb + j;
          const bool ok = valid(q0 + r, k0 + ra + i, Sq, Tk, causal, window);
          const float x = score(s[i][j], ok, softcap);
          const float p = expf(x - s_lse[r]);
          Pr[r * LD + ra + i] = p;
          dSr[r * LD + ra + i] = dscore(x, p, dp[i][j], s_delta[r], ok, softcap);
        }
      __syncthreads();
      tile_acc<TILE, NC>(dv_acc, Pr, dOt, ra, tx, Dh);
      tile_acc<TILE, NC>(dk_acc, dSr, Qt, ra, tx, Dh);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kj = k0 + ra + i;
    if (kj >= Tk) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int d = tx + 16 * j;
      if (d < Dh) {
        store(dk + kvoff + (size_t)kj * Dh + d, dk_acc[i][j]);
        store(dv + kvoff + (size_t)kj * Dh + d, dv_acc[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side: argument checks and dispatch on (dtype, head-dim class)
// ---------------------------------------------------------------------------
struct Args {
  int BH, BHkv, Sq, Tk, Dh, causal, window, bound_loop;
  float softcap, scale;
};

// Nonzero (a cudaError_t) for arguments the kernels do not take.
int check(const Args& a, int dtype, size_t need, int smem_bytes, int grid_y) {
  if (a.BH < 1 || a.BHkv < 1 || a.BH % a.BHkv || a.Sq < 1 || a.Tk < 1 || a.Dh < 1 ||
      a.Dh > kMaxHeadDim || (dtype != 0 && dtype != 1) || !(a.softcap >= 0.f) ||
      grid_y > 65535)
    return (int)cudaErrorInvalidValue;
  if (smem_bytes < 0 || (size_t)smem_bytes != need || need > (size_t)kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename K>
int prepare(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <typename T, int NC>
int fwd(const Args& a, const void* q, const void* k, const void* v, void* o, void* lse,
        size_t smem, cudaStream_t st) {
  constexpr int TILE = NC == 16 ? 32 : 64;
  auto kern = flash_fwd_kernel<T, NC, TILE>;
  if (int e = prepare(kern, smem)) return e;
  dim3 grid(a.BH, (a.Sq + TILE - 1) / TILE);
  kern<<<grid, kThreads, smem, st>>>((const T*)q, (const T*)k, (const T*)v, (T*)o,
                                     (float*)lse, a.Sq, a.Tk, a.Dh, a.BH / a.BHkv,
                                     a.causal, a.window, a.softcap, a.scale, a.bound_loop);
  return (int)cudaGetLastError();
}

template <typename T, int NC>
int dq(const Args& a, const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dqp, size_t smem, cudaStream_t st) {
  constexpr int TILE = NC == 16 ? 32 : 64;
  auto kern = flash_dq_kernel<T, NC, TILE>;
  if (int e = prepare(kern, smem)) return e;
  dim3 grid(a.BH, (a.Sq + TILE - 1) / TILE);
  kern<<<grid, kThreads, smem, st>>>((const T*)q, (const T*)k, (const T*)v,
                                     (const T*)dout, (const float*)lse,
                                     (const float*)delta, (T*)dqp, a.Sq, a.Tk, a.Dh,
                                     a.BH / a.BHkv, a.causal, a.window, a.softcap,
                                     a.scale, a.bound_loop);
  return (int)cudaGetLastError();
}

template <typename T, int NC>
int dkv(const Args& a, const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dkp, void* dvp, size_t smem,
        cudaStream_t st) {
  constexpr int TILE = NC == 16 ? 32 : 64;
  auto kern = flash_dkv_kernel<T, NC, TILE>;
  if (int e = prepare(kern, smem)) return e;
  dim3 grid(a.BHkv, (a.Tk + TILE - 1) / TILE);
  kern<<<grid, kThreads, smem, st>>>((const T*)q, (const T*)k, (const T*)v,
                                     (const T*)dout, (const float*)lse,
                                     (const float*)delta, (T*)dkp, (T*)dvp, a.Sq, a.Tk,
                                     a.Dh, a.BH / a.BHkv, a.causal, a.window, a.softcap,
                                     a.scale, a.bound_loop);
  return (int)cudaGetLastError();
}

// Returns CALL(T, NC) for the dtype code (0 f32, 1 bf16) and the head-dim
// class of Dh.
#define FLASH_DISPATCH(dtype, Dh, CALL)                   \
  switch ((dtype) * 100 + nc_class(Dh)) {                 \
    case 2: return CALL(float, 2);                        \
    case 4: return CALL(float, 4);                        \
    case 8: return CALL(float, 8);                        \
    case 10: return CALL(float, 10);                      \
    case 16: return CALL(float, 16);                      \
    case 102: return CALL(__nv_bfloat16, 2);              \
    case 104: return CALL(__nv_bfloat16, 4);              \
    case 108: return CALL(__nv_bfloat16, 8);              \
    case 110: return CALL(__nv_bfloat16, 10);             \
    case 116: return CALL(__nv_bfloat16, 16);             \
    default: return (int)cudaErrorInvalidValue;           \
  }

}  // namespace

extern "C" {

// Each entry point launches one kernel on `stream` and returns a cudaError_t
// code: nonzero if the arguments are refused or the launch fails. Pointers
// are device pointers to contiguous buffers: q, dout, o, dq (BH, Sq, Dh) and
// k, v, dk, dv (BHkv, T, Dh) in the input type (dtype 0 float32, 1 bf16),
// lse and delta (BH, Sq) float32. `window` is the sliding window (a value
// >= Sq + T turns it off); `softcap` 0 means none. `smem_bytes` is the
// dynamic shared memory the caller sized; it must equal the kernel's own sum.

int flash_fwd_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                     int dtype, int BH, int BHkv, int Sq, int T, int Dh, int causal,
                     int window, float softcap, float scale, int bound_loop,
                     int smem_bytes, void* stream) {
  const Args a{BH, BHkv, Sq, T, Dh, causal, window, bound_loop, softcap, scale};
  const int tile = tile_of(nc_class(Dh));
  const size_t need = fwd_smem(Dh, tile);
  if (int e = check(a, dtype, need, smem_bytes, (Sq + tile - 1) / tile)) return e;
#define FWD_CALL(Tp, NC) fwd<Tp, NC>(a, q, k, v, o, lse, need, (cudaStream_t)stream)
  FLASH_DISPATCH(dtype, Dh, FWD_CALL)
#undef FWD_CALL
}

int flash_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dq_out, int dtype, int BH,
                    int BHkv, int Sq, int T, int Dh, int causal, int window,
                    float softcap, float scale, int bound_loop, int smem_bytes,
                    void* stream) {
  const Args a{BH, BHkv, Sq, T, Dh, causal, window, bound_loop, softcap, scale};
  const int tile = tile_of(nc_class(Dh));
  const size_t need = dq_smem(Dh, tile);
  if (int e = check(a, dtype, need, smem_bytes, (Sq + tile - 1) / tile)) return e;
#define DQ_CALL(Tp, NC) \
  dq<Tp, NC>(a, q, k, v, dout, lse, delta, dq_out, need, (cudaStream_t)stream)
  FLASH_DISPATCH(dtype, Dh, DQ_CALL)
#undef DQ_CALL
}

int flash_dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk_out, void* dv_out,
                     int dtype, int BH, int BHkv, int Sq, int T, int Dh, int causal,
                     int window, float softcap, float scale, int bound_loop,
                     int smem_bytes, void* stream) {
  const Args a{BH, BHkv, Sq, T, Dh, causal, window, bound_loop, softcap, scale};
  const int tile = tile_of(nc_class(Dh));
  const size_t need = dkv_smem(Dh, tile);
  if (int e = check(a, dtype, need, smem_bytes, (T + tile - 1) / tile)) return e;
#define DKV_CALL(Tp, NC) \
  dkv<Tp, NC>(a, q, k, v, dout, lse, delta, dk_out, dv_out, need, (cudaStream_t)stream)
  FLASH_DISPATCH(dtype, Dh, DKV_CALL)
#undef DKV_CALL
}

}  // extern "C"
