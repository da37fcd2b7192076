// Flash attention for Hopper (sm_90a): the forward, dQ and dK/dV kernels.
//
// Replaces the three TPU kernels of src/repro/kernels/flash_attention.py:
//   forward  <- `_forward` -> `_flash_kernel` (causal online-softmax
//               attention, returns o and the logsumexp lse);
//   dQ       <- `_backward` -> `_flash_dq_kernel` (recompute
//               p = exp(s - lse), ds = p (do.v^T - delta), dq = ds.k);
//   dK/dV    <- `_backward` -> `_flash_dkv_kernel` (dk = ds^T.q,
//               dv = p^T.do per KV tile, looping q tiles and the GQA group).
// Same function as the TPU kernels: a causal mask (or none), a sliding window
// w as a runtime int (keys with k > q - w stay; w >= T is a no-op), an
// optional logit softcap s <- cap tanh(s / cap) with its chain-rule factor
// 1 - t^2 in the backward, GQA by reading kv stream bh / group, masked scores
// filled with -1e30, and the masked-row guard: a row whose whole horizon is
// masked gets p = 0, o = 0 and lse = +inf. m, l, the accumulators and every
// softmax step run in float32 whatever the input type, as on the TPU.
//
// Dispatch is by the input type, explicitly, with no fallback:
//   bf16 -> flash_fwd_mma_kernel, flash_dq_mma_kernel, flash_dkv_mma_kernel
//           (tensor cores, below);
//   f32  -> flash_fwd_kernel, flash_dq_kernel, flash_dkv_kernel (float32
//           CUDA cores; they serve the float32 smoke and check models).
//
// What bounds them on this card: at the training path's shape (576 streams,
// S = 256, Dh = 64, bf16, causal) the forward moves ~76 MB and needs ~5
// GFLOP, so an ideal kernel is bound by bytes (~23 us at 3.35 TB/s), and
// dQ (~29 us) and dK/dV (~34 us) by bytes too; at 4096 tokens all three are
// bound by operations (989 TFLOP/s bf16 on the tensor cores).
//
// The bf16 kernels (FlashAttention-2's shape on mma.sync.m16n8k16, bf16 x bf16
// -> f32, inline PTX). A block is 4 warps and owns 64 rows, 16 a warp: q rows
// in the forward and dQ, KV rows in dK/dV. Tiles sit in shared memory as bf16 rows of
// DP + 8 elements (DP: the head dim zero-padded to 16, 32, 64, 128, 160 or
// 256); the 16-byte row pad makes the 8 rows that one ldmatrix reads fall in
// 8 different bank groups, so ldmatrix has no bank conflicts. Copies are
// cp.async (16 bytes, zero-filled past the last row and past Dh; element
// copies where Dh is not a multiple of 8), double-buffered so that the next
// tile is in flight while the current one computes.
//   forward: Q goes to shared memory once and into ldmatrix A fragments held
//   for the whole KV loop (DP <= 160; at 256 they are re-read per tile, to
//   fit the registers). S = Q.K^T with K as the B operand (ldmatrix, no
//   .trans); scale in f32 after the product, then softcap, mask and the
//   online softmax in registers, rows reduced over the 4 threads of a quad.
//   P becomes the A operand of P.V straight from the S accumulators, rounded
//   to bf16 once; V comes through ldmatrix.trans; l sums the float32 p. KV
//   tiles of 64 rows (32 at DP 256).
//   dQ: the forward's grid, row order and KV loop; Q and dO go to shared
//   memory once, each thread keeps the lse and delta of its two rows in
//   registers, and Q's and dO's A fragments stay in registers up to DP 64
//   (re-read from shared memory above). Each KV tile is taken 16 keys at a
//   time, so that only a 16 x 16 S and dP live beside the dQ accumulator:
//   S = Q.K^T and dP = dO.V^T with K and V as B operands (ldmatrix, no
//   .trans); p = exp(scale S - lse) (mask, softcap) and dS = p (dP - delta)
//   (1 - t^2) in registers; dQ += dS.K with dS straight from its
//   accumulators as the A operand and K through ldmatrix.trans, times scale
//   at the end. dS goes in as hi + lo, hi = bf16(dS) and lo = bf16(dS - hi),
//   two products that keep ~16 bits of it: dQ = sum_j dS_j k_j cancels
//   heavily (sum_j dS_j ~ 0 on each row), so a single bf16 rounding of dS
//   comes close to the bf16 tolerance at 1024 tokens.
//   dK/dV: K and V stay A fragments in registers (DP <= 64; re-read from
//   shared memory above). The block loops the group's q heads and the q
//   tiles that can see it (64 rows, 32 at DP >= 160); Q, dO, lse and delta
//   are double-buffered. Everything is computed transposed, 16 q rows at a
//   time, so that the KV rows are M of all four products and P and dS never
//   leave registers: S^T = K.Q^T, P^T = exp(scale S^T - lse) (mask,
//   softcap), dV += P^T.dO, dP^T = V.dO^T, dS^T = P^T (dP^T - delta)(1 - t^2),
//   dK += dS^T.Q, times scale at the end. P and dS are rounded to bf16 once
//   before their products. Above DP 160 the f32 dK and dV accumulators
//   (DP/2 registers a thread each) do not fit, so the block's output columns
//   are split in two halves over blockIdx.z; each half recomputes S and dP.
//   Outputs leave through the block's own rows of shared memory as 16-byte
//   row stores.
//   All three: a tile wholly inside the unmasked region skips the
//   per-element mask test, and the causal forward and dQ run their longest
//   q tiles first. Up to DP 64 the forward and dQ are held to 128 registers
//   (4 blocks an SM) and dK/dV to 168 (3 blocks); chip_smoke.py's build
//   phase prints every instance's registers and spills. Rounding P to bf16
//   adds at most 2^-9 sum_j p_j |v_j| to o before o's own rounding (dS
//   likewise to dK), far less for random inputs; the tests hold the bf16
//   outputs to 2^-7 of the largest value of the plain float32 versions.
// The float32 kernels stage tiles of TILE rows in shared memory as float32,
// stored d-major (x[d * LD + row], LD = TILE + 4), and each of 256 threads
// keeps a (TILE/16) x (TILE/16) block of the score tile and its share of the
// output accumulator in registers; every product runs on the CUDA cores.
// All kernels tile KV (the TPU kernel keeps the whole K/V stream in VMEM
// under a 12 MB guard), which puts no limit on T. Causal and window tile
// bounds skip tiles with no unmasked entry; a skipped tile would contribute
// alpha = 1 and p = 0 (in the backward dS = 0) exactly, so bound_loop = 0
// (scan every tile) gives bit-equal results. dK/dV owns one KV tile per
// block and loops over every q head of its GQA group, so no atomics are
// needed and every run gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;          // a 16 x 16 thread grid
constexpr float kMask = -1e30f;        // flash_attention.py _MASK
constexpr float kMaskGuard = -0.5e30f; // flash_attention.py _MASK_GUARD
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxHeadDim = 256;
constexpr int kMaxSmemBytes = 232448;  // 227 KB, one Hopper block

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

// Dynamic shared memory of each float32 kernel, in bytes (the Python
// wrapper's f32_smem_bytes() computes the same sums, for supports() on a
// machine without the library; flash_smem_bytes() below returns every plan).
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
template <int TILE>
__device__ void load_t(float* dst, const float* __restrict__ src, int row0, int nrows,
                       int Dh, float mul) {
  constexpr int LD = TILE + 4;
  for (int e = threadIdx.x; e < TILE * Dh; e += kThreads) {
    const int r = e / Dh, d = e - r * Dh;
    const int row = row0 + r;
    dst[d * LD + r] = row < nrows ? src[(size_t)row * Dh + d] * mul : 0.f;
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

// [lo, hi) KV tiles of KR rows that can hold an unmasked entry for q rows
// [q0, q0 + QR) (`_kv_bounds` for these tiles).
__device__ __forceinline__ void kv_bounds(int q0, int QR, int KR, int Sq, int Tk, int causal,
                                          int window, int bound_loop, int* lo, int* hi) {
  const int nk = (Tk + KR - 1) / KR;
  *lo = 0;
  *hi = nk;
  if (!bound_loop) return;
  if (causal) {
    const int q_end = min(q0 + QR, Sq);  // keys <= q_end - 1
    *hi = min(nk, (q_end + KR - 1) / KR);
  }
  *lo = max(0, (q0 - window + 1) / KR);  // keys >= q0 - window + 1
}

// [lo, hi) q tiles of QR rows that can see KV rows [k0, k0 + KR) (the dK/dV
// q-loop bounds): causal needs q >= k0, the window q <= k_end - 1 + window - 1.
__device__ __forceinline__ void q_bounds(int k0, int KR, int QR, int Sq, int Tk, int causal,
                                         int window, int bound_loop, int* lo, int* hi) {
  const int nq = (Sq + QR - 1) / QR;
  *lo = 0;
  *hi = nq;
  if (!bound_loop) return;
  if (causal) *lo = k0 / QR;
  const int last = min(k0 + KR, Tk) + window - 2;
  *hi = last < 0 ? 0 : min(nq, last / QR + 1);
}

// ---------------------------------------------------------------------------
// float32 forward: one block per (q stream, q tile)
// ---------------------------------------------------------------------------
template <int NC, int TILE>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Tk, int Dh, int group, int causal,
                 int window, float softcap, float scale, int bound_loop) {
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

  load_t<TILE>(Qt, q, q0, Sq, Dh, scale);
  float m[R], l[R], acc[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kMask;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  int lo, hi;
  kv_bounds(q0, TILE, TILE, Sq, Tk, causal, window, bound_loop, &lo, &hi);
  for (int it = lo; it < hi; ++it) {
    const int k0 = it * TILE;
    __syncthreads();  // the previous tile's readers are done
    load_t<TILE>(Kt, k, k0, Tk, Dh, 1.f);
    load_t<TILE>(Vt, v, k0, Tk, Dh, 1.f);
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
      if (d < Dh) o[(size_t)qi * Dh + d] = acc[i][j] / den;
    }
    if (tx == 0) lse[(size_t)bh * Sq + qi] = l[i] > 0.f ? m[i] + logf(den) : CUDART_INF_F;
  }
}

// ---------------------------------------------------------------------------
// float32 dQ: the float32 forward's grid and KV loop
// ---------------------------------------------------------------------------
template <int NC, int TILE>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int Sq, int Tk, int Dh, int group, int causal,
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

  load_t<TILE>(Qt, q + qoff, q0, Sq, Dh, scale);
  load_t<TILE>(dOt, dout + qoff, q0, Sq, Dh, 1.f);
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
  kv_bounds(q0, TILE, TILE, Sq, Tk, causal, window, bound_loop, &lo, &hi);
  for (int it = lo; it < hi; ++it) {
    const int k0 = it * TILE;
    __syncthreads();
    load_t<TILE>(Kt, k, k0, Tk, Dh, 1.f);
    load_t<TILE>(Vt, v, k0, Tk, Dh, 1.f);
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
      if (d < Dh) dq[qoff + (size_t)qi * Dh + d] = acc[i][j] * scale;
    }
  }
}

// ---------------------------------------------------------------------------
// float32 dK/dV: one block per (kv stream, KV tile); loops the group's q heads and
// their q tiles, so each output element is written by one thread, once
// ---------------------------------------------------------------------------
template <int NC, int TILE>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int Sq, int Tk, int Dh,
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

  load_t<TILE>(Kt, k + kvoff, k0, Tk, Dh, 1.f);
  load_t<TILE>(Vt, v + kvoff, k0, Tk, Dh, 1.f);
  float dk_acc[R][NC], dv_acc[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  int lo, hi;
  q_bounds(k0, TILE, TILE, Sq, Tk, causal, window, bound_loop, &lo, &hi);
  for (int g = 0; g < group; ++g) {
    const int bh = bkv * group + g;
    const size_t qoff = (size_t)bh * Sq * Dh;
    for (int it = lo; it < hi; ++it) {
      const int q0 = it * TILE;
      __syncthreads();
      load_t<TILE>(Qt, q + qoff, q0, Sq, Dh, scale);
      load_t<TILE>(dOt, dout + qoff, q0, Sq, Dh, 1.f);
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
        dk[kvoff + (size_t)kj * Dh + d] = dk_acc[i][j];
        dv[kvoff + (size_t)kj * Dh + d] = dv_acc[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 forward, dQ and dK/dV on the tensor cores (mma.sync.m16n8k16 bf16 -> f32)
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 128;  // 4 warps
constexpr int kBlockRows = 64;    // q rows (forward, dQ) or KV rows (dK/dV): 16 a warp

// Padded head dim, and the tile plans.
__host__ __device__ inline int dp_class(int Dh) {
  return Dh <= 16 ? 16 : Dh <= 32 ? 32 : Dh <= 64 ? 64 : Dh <= 128 ? 128 : Dh <= 160 ? 160 : 256;
}
// KV rows a tile of the forward and of dQ
__host__ __device__ constexpr int fwd_kv_rows(int dp) { return dp > 160 ? 32 : 64; }
__host__ __device__ constexpr int dkv_q_rows(int dp) { return dp >= 160 ? 32 : 64; }
__host__ __device__ constexpr int dkv_splits(int dp) { return dp > 160 ? 2 : 1; }
// Blocks an SM the register allocation must allow: up to DP 64 the forward
// and dQ are capped at 128 registers (4 blocks) and dK/dV at 168 (3 blocks),
// so that more blocks share an SM at the training path's shape; under their
// caps the forward at DP 64 spills 44 bytes and dQ 8 (chip_smoke.py prints
// each instance's registers and spills). Above DP 64 none is capped.
__host__ __device__ constexpr int fwd_min_blocks(int dp) { return dp <= 64 ? 4 : 1; }
__host__ __device__ constexpr int dq_min_blocks(int dp) { return dp <= 64 ? 4 : 1; }
__host__ __device__ constexpr int dkv_min_blocks(int dp) { return dp <= 64 ? 3 : 1; }

inline size_t fwd_mma_smem(int dp) {  // Q; K, V double-buffered (bf16 rows of dp + 8)
  return 2 * (size_t)(kBlockRows + 4 * fwd_kv_rows(dp)) * (dp + 8);
}
inline size_t dq_mma_smem(int dp) {   // Q, dO; K, V double-buffered
  return 2 * (size_t)(2 * kBlockRows + 4 * fwd_kv_rows(dp)) * (dp + 8);
}
inline size_t dkv_mma_smem(int dp) {  // K, V; Q, dO double-buffered; lse, delta double-buffered
  const int bq = dkv_q_rows(dp);
  return 2 * (size_t)(2 * kBlockRows + 4 * bq) * (dp + 8) + 4 * (size_t)(4 * bq);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 (or 4) bytes global -> shared; bytes past src_bytes are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
// d += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two floats -> bf16x2, round to nearest even; lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}
// The A fragment of a 16x16 tile whose two 16x8 halves are f32 accumulators
// (an S or dS tile turned into the A operand of the next product).
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}
// The same A fragment as hi + lo: hi = bf16(x), lo = bf16(x - hi) (the
// difference is exact in f32), ~16 significant bits of x between the two.
__device__ __forceinline__ void acc_to_a_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                               const float (&c0)[4], const float (&c1)[4]) {
  const float x[8] = {c0[0], c0[1], c0[2], c0[3], c1[0], c1[1], c1[2], c1[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack_bf16(x[2 * i] - __low2float(h), x[2 * i + 1] - __high2float(h));
  }
}
// Reduce over the 4 threads of a quad (the lanes that share an accumulator
// row); the xor butterfly leaves the same bits in every lane.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// Rows [row0, row0 + ROWS) of a (nrows, Dh) bf16 stream into a shared tile of
// row stride DP + 8, columns [0, DP); rows past nrows and columns past Dh are
// zero. vec: 16-byte cp.async (Dh % 8 == 0, 16-byte-aligned stream); else
// element copies, visible after the next __syncthreads.
template <int ROWS, int DP>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, int row0,
                                          int nrows, int Dh, int vec) {
  constexpr int LDS = DP + 8;
  if (vec) {
    constexpr int CH = DP / 8, N = ROWS * CH;
#pragma unroll
    for (int i = 0; i < (N + kMmaThreads - 1) / kMmaThreads; ++i) {
      const int e = threadIdx.x + i * kMmaThreads;
      if (N % kMmaThreads == 0 || e < N) {
        const int r = e / CH, c = (e - r * CH) * 8;
        const bool in = row0 + r < nrows && c < Dh;
        cp_async16(smem_u32(dst + r * LDS + c), in ? src + (size_t)(row0 + r) * Dh + c : src,
                   in ? 16 : 0);
      }
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DP; e += kMmaThreads) {
      const int r = e / DP, c = e - r * DP;
      dst[r * LDS + c] = row0 + r < nrows && c < Dh ? src[(size_t)(row0 + r) * Dh + c]
                                                    : __float2bfloat16(0.f);
    }
  }
}

// One warp: 16 rows of a shared tile (row stride DP + 8), columns
// [c0, c0 + NCOLS) that lie below Dh, to rows row0.. of a (nrows, Dh) stream.
template <int DP, int NCOLS>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const bf16* src, int row0,
                                           int nrows, int c0, int Dh, int vec, int lane) {
  constexpr int LDS = DP + 8;
  if (vec) {
    constexpr int CH = NCOLS / 8;
    for (int e = lane; e < 16 * CH; e += 32) {
      const int r = e / CH, c = c0 + (e - r * CH) * 8;
      if (row0 + r < nrows && c < Dh)
        *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * Dh + c) =
            *reinterpret_cast<const uint4*>(src + r * LDS + c);
    }
  } else {
    for (int e = lane; e < 16 * NCOLS; e += 32) {
      const int r = e / NCOLS, c = c0 + e - r * NCOLS;
      if (row0 + r < nrows && c < Dh) dst[(size_t)(row0 + r) * Dh + c] = src[r * LDS + c];
    }
  }
}

// Whether every (q, k) of q rows [q0, q0 + QR) and keys [k0, k0 + KR) is
// unmasked, so that the tile needs no mask test.
__device__ __forceinline__ bool interior(int q0, int QR, int k0, int KR, int Sq, int Tk,
                                         int causal, int window) {
  return q0 + QR <= Sq && k0 + KR <= Tk && (!causal || k0 + KR - 1 <= q0) &&
         k0 > q0 + QR - 1 - window;
}

// ldmatrix lane addressing: rows and columns (within a 16x16 tile) of the row
// address each lane gives. A operand, and B operand through .trans:
// matrices (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15).
// B operand without .trans (two n-tiles of 8 rows):
// matrices (rows 0-7, cols 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15).
__device__ __forceinline__ int a_row(int lane) { return (lane & 7) + ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) * 8; }
__device__ __forceinline__ int b_row(int lane) { return (lane & 7) + (lane >> 4) * 8; }
__device__ __forceinline__ int b_col(int lane) { return ((lane >> 3) & 1) * 8; }

// forward: one block per (q stream, 64 q rows), a warp per 16 rows
template <int DP>
__global__ void __launch_bounds__(kMmaThreads, fwd_min_blocks(DP))
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Tk, int Dh, int group, int causal,
                     int window, float softcap, float scale, int bound_loop, int vec) {
  constexpr int BK = fwd_kv_rows(DP), LDS = DP + 8;
  constexpr int KD = DP / 16, NS = BK / 8, NO = DP / 8;
  constexpr bool kQRegs = DP <= 160;  // Q's A fragments live in registers
  extern __shared__ uint4 smem_u4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_u4);
  bf16* sK = sQ + kBlockRows * LDS;  // two tiles of BK rows
  bf16* sV = sK + 2 * BK * LDS;      // two tiles of BK rows

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;  // longest causal rows first
  const int row0 = warp * 16;
  const int qr[2] = {q0 + row0 + g, q0 + row0 + g + 8};  // this thread's two q rows
  q += (size_t)bh * Sq * Dh;
  o += (size_t)bh * Sq * Dh;
  k += (size_t)(bh / group) * Tk * Dh;
  v += (size_t)(bh / group) * Tk * Dh;

  int lo, hi;
  kv_bounds(q0, kBlockRows, BK, Sq, Tk, causal, window, bound_loop, &lo, &hi);
  load_rows<kBlockRows, DP>(sQ, q, q0, Sq, Dh, vec);
  if (lo < hi) {
    load_rows<BK, DP>(sK, k, lo * BK, Tk, Dh, vec);
    load_rows<BK, DP>(sV, v, lo * BK, Tk, Dh, vec);
  }
  cp_async_commit();

  const uint32_t q_a = smem_u32(sQ + (row0 + a_row(lane)) * LDS + a_col(lane));
  uint32_t qf[kQRegs ? KD : 1][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};

  for (int it = lo; it < hi; ++it) {
    const int buf = (it - lo) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile `it` landed; every warp is done with tile it - 1
    if (it + 1 < hi) {
      load_rows<BK, DP>(sK + (buf ^ 1) * BK * LDS, k, (it + 1) * BK, Tk, Dh, vec);
      load_rows<BK, DP>(sV + (buf ^ 1) * BK * LDS, v, (it + 1) * BK, Tk, Dh, vec);
    }
    cp_async_commit();
    if constexpr (kQRegs) {
      if (it == lo) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) ldsm_x4(qf[kk], q_a + kk * 32);
      }
    }
    const bf16* cK = sK + buf * BK * LDS;
    const bf16* cV = sV + buf * BK * LDS;

    // S = Q K^T (16 x BK a warp)
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldsm_x4(a, q_a + kk * 32);
      }
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t b[4];
        ldsm_x4(b, smem_u32(cK + (j * 8 + b_row(lane)) * LDS + kk * 16 + b_col(lane)));
        mma_bf16(s[j], a, b[0], b[1]);
        mma_bf16(s[j + 1], a, b[2], b[3]);
      }
    }

    // scale, softcap, mask; online softmax over the quad's rows
    const int k0 = it * BK;
    const bool edge = !interior(q0, kBlockRows, k0, BK, Sq, Tk, causal, window);
    float mt[2] = {kMask, kMask};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok =
            !edge || valid(qr[e >> 1], k0 + j * 8 + 2 * t + (e & 1), Sq, Tk, causal, window);
        s[j][e] = score(s[j][e] * scale, ok, softcap);
        mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
      }
    float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mt[h]));
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a row masked so far keeps m at kMask: p = 0, not exp(0) = 1
        const int h = e >> 1;
        s[j][e] = m[h] > kMaskGuard ? expf(s[j][e] - m[h]) : 0.f;
        ps[h] += s[j][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + quad_sum(ps[h]);
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // O += P V, P rounded to bf16 once
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, smem_u32(cV + (kc * 16 + a_row(lane)) * LDS + n * 8 + a_col(lane)));
        mma_bf16(acc[n], a, b[0], b[1]);
        mma_bf16(acc[n + 1], a, b[2], b[3]);
      }
    }
  }

  cp_async_wait_all();
  __syncthreads();  // every copy has landed and every warp is done with sQ
  bf16* sO = sQ + row0 * LDS;  // this warp's own rows of the Q tile
  float den[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) den[h] = fmaxf(l[h], 1e-30f);
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(sO + (g + 8 * h) * LDS + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * h] / den[h], acc[n][2 * h + 1] / den[h]);
  __syncwarp();
  store_rows<DP, DP>(o, sO, q0 + row0, Sq, 0, Dh, vec, lane);
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (qr[h] < Sq)
        lse[(size_t)bh * Sq + qr[h]] = l[h] > 0.f ? m[h] + logf(den[h]) : CUDART_INF_F;
  }
}

// dQ: one block per (q stream, 64 q rows), a warp per 16 rows; the forward's
// grid and KV loop, each KV tile taken 16 keys at a time
template <int DP>
__global__ void __launch_bounds__(kMmaThreads, dq_min_blocks(DP))
flash_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int Sq, int Tk, int Dh, int group, int causal,
                    int window, float softcap, float scale, int bound_loop, int vec) {
  constexpr int BK = fwd_kv_rows(DP), LDS = DP + 8;
  constexpr int KD = DP / 16, NO = DP / 8;
  constexpr bool kRegs = DP <= 64;  // Q's and dO's A fragments live in registers
  extern __shared__ uint4 smem_u4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_u4);
  bf16* sdO = sQ + kBlockRows * LDS;
  bf16* sK = sdO + kBlockRows * LDS;  // two tiles of BK rows
  bf16* sV = sK + 2 * BK * LDS;       // two tiles of BK rows

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;  // longest causal rows first
  const int row0 = warp * 16;
  const int qr[2] = {q0 + row0 + g, q0 + row0 + g + 8};  // this thread's two q rows
  const size_t qoff = (size_t)bh * Sq * Dh;
  k += (size_t)(bh / group) * Tk * Dh;
  v += (size_t)(bh / group) * Tk * Dh;

  int lo, hi;
  kv_bounds(q0, kBlockRows, BK, Sq, Tk, causal, window, bound_loop, &lo, &hi);
  load_rows<kBlockRows, DP>(sQ, q + qoff, q0, Sq, Dh, vec);
  load_rows<kBlockRows, DP>(sdO, dout + qoff, q0, Sq, Dh, vec);
  if (lo < hi) {
    load_rows<BK, DP>(sK, k, lo * BK, Tk, Dh, vec);
    load_rows<BK, DP>(sV, v, lo * BK, Tk, Dh, vec);
  }
  cp_async_commit();
  // rows past Sq: lse = +inf, so p = 0 and dS = 0
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_lse[h] = qr[h] < Sq ? lse[(size_t)bh * Sq + qr[h]] : CUDART_INF_F;
    row_delta[h] = qr[h] < Sq ? delta[(size_t)bh * Sq + qr[h]] : 0.f;
  }

  const uint32_t q_a = smem_u32(sQ + (row0 + a_row(lane)) * LDS + a_col(lane));
  const uint32_t do_a = smem_u32(sdO + (row0 + a_row(lane)) * LDS + a_col(lane));
  uint32_t qf[kRegs ? KD : 1][4], df[kRegs ? KD : 1][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = lo; it < hi; ++it) {
    const int buf = (it - lo) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile `it` landed; every warp is done with tile it - 1
    if (it + 1 < hi) {
      load_rows<BK, DP>(sK + (buf ^ 1) * BK * LDS, k, (it + 1) * BK, Tk, Dh, vec);
      load_rows<BK, DP>(sV + (buf ^ 1) * BK * LDS, v, (it + 1) * BK, Tk, Dh, vec);
    }
    cp_async_commit();
    if constexpr (kRegs) {
      if (it == lo) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          ldsm_x4(qf[kk], q_a + kk * 32);
          ldsm_x4(df[kk], do_a + kk * 32);
        }
      }
    }
    const bf16* cK = sK + buf * BK * LDS;
    const bf16* cV = sV + buf * BK * LDS;
    const int k0 = it * BK;
    const bool edge = !interior(q0, kBlockRows, k0, BK, Sq, Tk, causal, window);
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {  // 16 keys at a time
      // S = Q K^T and dP = dO V^T (16 q rows x 16 keys a warp)
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t aq[4], ad[4], b[4];
        if constexpr (kRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            aq[e] = qf[kk][e];
            ad[e] = df[kk][e];
          }
        } else {
          ldsm_x4(aq, q_a + kk * 32);
          ldsm_x4(ad, do_a + kk * 32);
        }
        ldsm_x4(b, smem_u32(cK + (c * 16 + b_row(lane)) * LDS + kk * 16 + b_col(lane)));
        mma_bf16(s[0], aq, b[0], b[1]);
        mma_bf16(s[1], aq, b[2], b[3]);
        ldsm_x4(b, smem_u32(cV + (c * 16 + b_row(lane)) * LDS + kk * 16 + b_col(lane)));
        mma_bf16(dp[0], ad, b[0], b[1]);
        mma_bf16(dp[1], ad, b[2], b[3]);
      }
      // dS in place of dP: scale, softcap, mask, p = exp(s - lse)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const bool ok = !edge || valid(qr[h], k0 + c * 16 + j * 8 + 2 * t + (e & 1), Sq, Tk,
                                         causal, window);
          const float x = score(s[j][e] * scale, ok, softcap);
          const float p = expf(x - row_lse[h]);  // normalized; 0 where masked
          dp[j][e] = dscore(x, p, dp[j][e], row_delta[h], ok, softcap);
        }
      // dQ += dS K, dS as hi + lo; K through ldmatrix.trans
      uint32_t ds_hi[4], ds_lo[4];
      acc_to_a_split(ds_hi, ds_lo, dp[0], dp[1]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, smem_u32(cK + (c * 16 + a_row(lane)) * LDS + n * 8 + a_col(lane)));
        mma_bf16(acc[n], ds_hi, b[0], b[1]);
        mma_bf16(acc[n + 1], ds_hi, b[2], b[3]);
        mma_bf16(acc[n], ds_lo, b[0], b[1]);
        mma_bf16(acc[n + 1], ds_lo, b[2], b[3]);
      }
    }
  }

  cp_async_wait_all();
  __syncthreads();  // every copy has landed and every warp is done with sQ
  bf16* sO = sQ + row0 * LDS;  // this warp's own rows of the Q tile
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(sO + (g + 8 * h) * LDS + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
  __syncwarp();
  store_rows<DP, DP>(dq + qoff, sO, q0 + row0, Sq, 0, Dh, vec, lane);
}

// dK/dV: one block per (kv stream, 64 KV rows, output half), a warp per 16
// KV rows; loops the group's q heads and their q tiles, so each output
// element is written by one thread, once
template <int DP>
__global__ void __launch_bounds__(kMmaThreads, dkv_min_blocks(DP))
flash_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Tk, int Dh,
                     int group, int causal, int window, float softcap, float scale,
                     int bound_loop, int vec) {
  constexpr int BQ = dkv_q_rows(DP), LDS = DP + 8, KD = DP / 16;
  constexpr int DC = DP / dkv_splits(DP), NO = DC / 8;  // output columns of a block
  constexpr bool kKVRegs = DP <= 64;  // K's and V's A fragments live in registers
  extern __shared__ uint4 smem_u4[];
  bf16* sK = reinterpret_cast<bf16*>(smem_u4);
  bf16* sV = sK + kBlockRows * LDS;
  bf16* sQ = sV + kBlockRows * LDS;  // two tiles of BQ rows
  bf16* sdO = sQ + 2 * BQ * LDS;     // two tiles of BQ rows
  float* sL = reinterpret_cast<float*>(sdO + 2 * BQ * LDS);  // lse, two tiles
  float* sD = sL + 2 * BQ;                                    // delta, two tiles

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int bkv = blockIdx.x, k0 = blockIdx.y * kBlockRows, c0 = blockIdx.z * DC;
  const int row0 = warp * 16;
  const int kr[2] = {k0 + row0 + g, k0 + row0 + g + 8};  // this thread's two KV rows
  const size_t kvoff = (size_t)bkv * Tk * Dh;

  load_rows<kBlockRows, DP>(sK, k + kvoff, k0, Tk, Dh, vec);
  load_rows<kBlockRows, DP>(sV, v + kvoff, k0, Tk, Dh, vec);
  int lo, hi;
  q_bounds(k0, kBlockRows, BQ, Sq, Tk, causal, window, bound_loop, &lo, &hi);
  const int nq = max(0, hi - lo), n_it = group * nq;  // (q head, q tile) pairs
  // Q, dO, lse and delta of pair i into buffer buf; past Sq they are zero,
  // where every p is 0 (the mask) and so is every ds
  auto prefetch = [&](int i, int buf) {
    const int bh = bkv * group + i / nq, q0 = (lo + i % nq) * BQ;
    const size_t qoff = (size_t)bh * Sq * Dh;
    load_rows<BQ, DP>(sQ + buf * BQ * LDS, q + qoff, q0, Sq, Dh, vec);
    load_rows<BQ, DP>(sdO + buf * BQ * LDS, dout + qoff, q0, Sq, Dh, vec);
    if (threadIdx.x < BQ) {
      const int qi = q0 + threadIdx.x;
      const size_t at = (size_t)bh * Sq + (qi < Sq ? qi : 0);
      cp_async4(smem_u32(sL + buf * BQ + threadIdx.x), lse + at, qi < Sq ? 4 : 0);
      cp_async4(smem_u32(sD + buf * BQ + threadIdx.x), delta + at, qi < Sq ? 4 : 0);
    }
  };
  if (n_it > 0) prefetch(0, 0);
  cp_async_commit();

  const uint32_t k_a = smem_u32(sK + (row0 + a_row(lane)) * LDS + a_col(lane));
  const uint32_t v_a = smem_u32(sV + (row0 + a_row(lane)) * LDS + a_col(lane));
  uint32_t kf[kKVRegs ? KD : 1][4], vf[kKVRegs ? KD : 1][4];
  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int i = 0; i < n_it; ++i) {
    const int buf = i & 1;
    cp_async_wait_all();
    __syncthreads();  // pair i landed; every warp is done with pair i - 1
    if (i + 1 < n_it) prefetch(i + 1, buf ^ 1);
    cp_async_commit();
    if constexpr (kKVRegs) {
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          ldsm_x4(kf[kk], k_a + kk * 32);
          ldsm_x4(vf[kk], v_a + kk * 32);
        }
      }
    }
    const int q0 = (lo + i % nq) * BQ;
    const bf16* cQ = sQ + buf * BQ * LDS;
    const bf16* cdO = sdO + buf * BQ * LDS;
    const float* cL = sL + buf * BQ;
    const float* cD = sD + buf * BQ;
    const bool edge = !interior(q0, BQ, k0, kBlockRows, Sq, Tk, causal, window);
#pragma unroll
    for (int c = 0; c < BQ / 16; ++c) {  // 16 q rows at a time
      // S^T = K Q^T and dP^T = V dO^T (16 KV rows x 16 q rows a warp)
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ak[4], av[4], b[4];
        if constexpr (kKVRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ak[e] = kf[kk][e];
            av[e] = vf[kk][e];
          }
        } else {
          ldsm_x4(ak, k_a + kk * 32);
          ldsm_x4(av, v_a + kk * 32);
        }
        ldsm_x4(b, smem_u32(cQ + (c * 16 + b_row(lane)) * LDS + kk * 16 + b_col(lane)));
        mma_bf16(s[0], ak, b[0], b[1]);
        mma_bf16(s[1], ak, b[2], b[3]);
        ldsm_x4(b, smem_u32(cdO + (c * 16 + b_row(lane)) * LDS + kk * 16 + b_col(lane)));
        mma_bf16(dp[0], av, b[0], b[1]);
        mma_bf16(dp[1], av, b[2], b[3]);
      }
      // P^T and dS^T in place of S^T and dP^T
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = c * 16 + j * 8 + 2 * t + (e & 1);  // q row of the tile
          const bool ok = !edge || valid(q0 + r, kr[e >> 1], Sq, Tk, causal, window);
          const float x = score(s[j][e] * scale, ok, softcap);
          const float p = expf(x - cL[r]);  // normalized; 0 where masked
          dp[j][e] = dscore(x, p, dp[j][e], cD[r], ok, softcap);
          s[j][e] = p;
        }
      // dV += P^T dO and dK += dS^T Q, P and dS rounded to bf16 once
      uint32_t pa[4], da[4];
      acc_to_a(pa, s[0], s[1]);
      acc_to_a(da, dp[0], dp[1]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, smem_u32(cdO + (c * 16 + a_row(lane)) * LDS + c0 + n * 8 + a_col(lane)));
        mma_bf16(dv_acc[n], pa, b[0], b[1]);
        mma_bf16(dv_acc[n + 1], pa, b[2], b[3]);
        ldsm_x4_t(b, smem_u32(cQ + (c * 16 + a_row(lane)) * LDS + c0 + n * 8 + a_col(lane)));
        mma_bf16(dk_acc[n], da, b[0], b[1]);
        mma_bf16(dk_acc[n + 1], da, b[2], b[3]);
      }
    }
  }

  cp_async_wait_all();
  __syncthreads();  // every copy has landed and every warp is done with its K/V rows
  bf16* oK = sK + row0 * LDS;  // this warp's own rows of the K and V tiles
  bf16* oV = sV + row0 * LDS;
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = (g + 8 * h) * LDS + c0 + n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(oK + at) =
          pack_bf16(dk_acc[n][2 * h] * scale, dk_acc[n][2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(oV + at) = pack_bf16(dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
    }
  __syncwarp();
  store_rows<DP, DC>(dk + kvoff, oK, k0 + row0, Tk, c0, Dh, vec, lane);
  store_rows<DP, DC>(dv + kvoff, oV, k0 + row0, Tk, c0, Dh, vec, lane);
}

// ---------------------------------------------------------------------------
// host side: argument checks and dispatch on (dtype, head-dim class)
// ---------------------------------------------------------------------------
struct Args {
  int BH, BHkv, Sq, Tk, Dh, causal, window, bound_loop;
  float softcap, scale;
};

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

// Dynamic shared memory of one block of `kind` for dtype 0 (float32) or 1
// (bf16): the one place the plans are summed.
size_t plan_smem(int kind, int dtype, int Dh) {
  if (dtype == 1) {
    const int dp = dp_class(Dh);
    return kind == kFwd ? fwd_mma_smem(dp) : kind == kDq ? dq_mma_smem(dp) : dkv_mma_smem(dp);
  }
  const int tile = tile_of(nc_class(Dh));
  return kind == kFwd ? fwd_smem(Dh, tile) : kind == kDq ? dq_smem(Dh, tile) : dkv_smem(Dh, tile);
}

// Blocks along the tiled sequence: q rows for the forward and dQ, KV rows
// for dK/dV.
int grid_rows(int kind, int dtype, const Args& a) {
  const int rows = kind == kDkv ? a.Tk : a.Sq;
  const int tile = dtype == 1 ? kBlockRows : tile_of(nc_class(a.Dh));
  return (rows + tile - 1) / tile;
}

// Nonzero (a cudaError_t) for arguments the kernels do not take.
int check(const Args& a, int kind, int dtype) {
  if (a.BH < 1 || a.BHkv < 1 || a.BH % a.BHkv || a.Sq < 1 || a.Tk < 1 || a.Dh < 1 ||
      a.Dh > kMaxHeadDim || (dtype != 0 && dtype != 1) || !(a.softcap >= 0.f) ||
      grid_rows(kind, dtype, a) > 65535 || plan_smem(kind, dtype, a.Dh) > (size_t)kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename K>
int prepare(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// 1 when the bf16 kernels may copy rows as 16-byte chunks
int vec_ok(int Dh, std::initializer_list<const void*> ptrs) {
  if (Dh % 8) return 0;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return 0;
  return 1;
}

template <int NC>
int fwd(const Args& a, const void* q, const void* k, const void* v, void* o, void* lse,
        cudaStream_t st) {
  constexpr int TILE = NC == 16 ? 32 : 64;
  const size_t smem = plan_smem(kFwd, 0, a.Dh);
  auto kern = flash_fwd_kernel<NC, TILE>;
  if (int e = prepare(kern, smem)) return e;
  dim3 grid(a.BH, grid_rows(kFwd, 0, a));
  kern<<<grid, kThreads, smem, st>>>((const float*)q, (const float*)k, (const float*)v, (float*)o,
                                     (float*)lse, a.Sq, a.Tk, a.Dh, a.BH / a.BHkv,
                                     a.causal, a.window, a.softcap, a.scale, a.bound_loop);
  return (int)cudaGetLastError();
}

template <int DP>
int fwd_mma(const Args& a, const void* q, const void* k, const void* v, void* o, void* lse,
            cudaStream_t st) {
  const size_t smem = fwd_mma_smem(DP);
  auto kern = flash_fwd_mma_kernel<DP>;
  if (int e = prepare(kern, smem)) return e;
  dim3 grid(a.BH, grid_rows(kFwd, 1, a));
  kern<<<grid, kMmaThreads, smem, st>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                        (bf16*)o, (float*)lse, a.Sq, a.Tk, a.Dh,
                                        a.BH / a.BHkv, a.causal, a.window, a.softcap,
                                        a.scale, a.bound_loop, vec_ok(a.Dh, {q, k, v, o}));
  return (int)cudaGetLastError();
}

template <int NC>
int dq(const Args& a, const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dqp, cudaStream_t st) {
  constexpr int TILE = NC == 16 ? 32 : 64;
  const size_t smem = plan_smem(kDq, 0, a.Dh);
  auto kern = flash_dq_kernel<NC, TILE>;
  if (int e = prepare(kern, smem)) return e;
  dim3 grid(a.BH, grid_rows(kDq, 0, a));
  kern<<<grid, kThreads, smem, st>>>((const float*)q, (const float*)k, (const float*)v,
                                     (const float*)dout, (const float*)lse,
                                     (const float*)delta, (float*)dqp, a.Sq, a.Tk, a.Dh,
                                     a.BH / a.BHkv, a.causal, a.window, a.softcap,
                                     a.scale, a.bound_loop);
  return (int)cudaGetLastError();
}

template <int DP>
int dq_mma(const Args& a, const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dqp, cudaStream_t st) {
  const size_t smem = dq_mma_smem(DP);
  auto kern = flash_dq_mma_kernel<DP>;
  if (int e = prepare(kern, smem)) return e;
  dim3 grid(a.BH, grid_rows(kDq, 1, a));
  kern<<<grid, kMmaThreads, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (bf16*)dqp, a.Sq, a.Tk, a.Dh, a.BH / a.BHkv, a.causal, a.window,
      a.softcap, a.scale, a.bound_loop, vec_ok(a.Dh, {q, k, v, dout, dqp}));
  return (int)cudaGetLastError();
}

template <int NC>
int dkv(const Args& a, const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dkp, void* dvp, cudaStream_t st) {
  constexpr int TILE = NC == 16 ? 32 : 64;
  const size_t smem = plan_smem(kDkv, 0, a.Dh);
  auto kern = flash_dkv_kernel<NC, TILE>;
  if (int e = prepare(kern, smem)) return e;
  dim3 grid(a.BHkv, grid_rows(kDkv, 0, a));
  kern<<<grid, kThreads, smem, st>>>((const float*)q, (const float*)k, (const float*)v,
                                     (const float*)dout, (const float*)lse,
                                     (const float*)delta, (float*)dkp, (float*)dvp, a.Sq, a.Tk,
                                     a.Dh, a.BH / a.BHkv, a.causal, a.window, a.softcap,
                                     a.scale, a.bound_loop);
  return (int)cudaGetLastError();
}

template <int DP>
int dkv_mma(const Args& a, const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dkp, void* dvp, cudaStream_t st) {
  const size_t smem = dkv_mma_smem(DP);
  auto kern = flash_dkv_mma_kernel<DP>;
  if (int e = prepare(kern, smem)) return e;
  dim3 grid(a.BHkv, grid_rows(kDkv, 1, a), dkv_splits(DP));
  kern<<<grid, kMmaThreads, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (bf16*)dkp, (bf16*)dvp, a.Sq, a.Tk, a.Dh, a.BH / a.BHkv,
      a.causal, a.window, a.softcap, a.scale, a.bound_loop,
      vec_ok(a.Dh, {q, k, v, dout, dkp, dvp}));
  return (int)cudaGetLastError();
}

// Returns CALL(NC) for the head-dim class of Dh (the float32 CUDA-core kernels).
#define NC_DISPATCH(Dh, CALL)                 \
  switch (nc_class(Dh)) {                     \
    case 2: return CALL(2);                   \
    case 4: return CALL(4);                   \
    case 8: return CALL(8);                   \
    case 10: return CALL(10);                 \
    default: return CALL(16);                 \
  }
// Returns CALL(DP) for the padded head dim of Dh (the bf16 tensor-core kernels).
#define DP_DISPATCH(Dh, CALL)                 \
  switch (dp_class(Dh)) {                     \
    case 16: return CALL(16);                 \
    case 32: return CALL(32);                 \
    case 64: return CALL(64);                 \
    case 128: return CALL(128);               \
    case 160: return CALL(160);               \
    default: return CALL(256);                \
  }

}  // namespace

extern "C" {

// Each entry point launches one kernel on `stream` and returns a cudaError_t
// code: nonzero if the arguments are refused or the launch fails. Pointers
// are device pointers to contiguous buffers: q, dout, o, dq (BH, Sq, Dh) and
// k, v, dk, dv (BHkv, T, Dh) in the input type (dtype 0 float32, 1 bf16),
// lse and delta (BH, Sq) float32. `window` is the sliding window (a value
// >= Sq + T turns it off); `softcap` 0 means none. Each sizes its kernel's
// shared memory itself. bf16 takes the tensor-core kernels, float32 the
// float32-core kernels.

int flash_fwd_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                     int dtype, int BH, int BHkv, int Sq, int T, int Dh, int causal,
                     int window, float softcap, float scale, int bound_loop, void* stream) {
  const Args a{BH, BHkv, Sq, T, Dh, causal, window, bound_loop, softcap, scale};
  const cudaStream_t st = (cudaStream_t)stream;
  if (int e = check(a, kFwd, dtype)) return e;
  if (dtype == 1) {
#define FWD_MMA_CALL(DP) fwd_mma<DP>(a, q, k, v, o, lse, st)
    DP_DISPATCH(Dh, FWD_MMA_CALL)
#undef FWD_MMA_CALL
  }
#define FWD_CALL(NC) fwd<NC>(a, q, k, v, o, lse, st)
  NC_DISPATCH(Dh, FWD_CALL)
#undef FWD_CALL
}

int flash_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dq_out, int dtype, int BH,
                    int BHkv, int Sq, int T, int Dh, int causal, int window,
                    float softcap, float scale, int bound_loop, void* stream) {
  const Args a{BH, BHkv, Sq, T, Dh, causal, window, bound_loop, softcap, scale};
  const cudaStream_t st = (cudaStream_t)stream;
  if (int e = check(a, kDq, dtype)) return e;
  if (dtype == 1) {
#define DQ_MMA_CALL(DP) dq_mma<DP>(a, q, k, v, dout, lse, delta, dq_out, st)
    DP_DISPATCH(Dh, DQ_MMA_CALL)
#undef DQ_MMA_CALL
  }
#define DQ_CALL(NC) dq<NC>(a, q, k, v, dout, lse, delta, dq_out, st)
  NC_DISPATCH(Dh, DQ_CALL)
#undef DQ_CALL
}

int flash_dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk_out, void* dv_out,
                     int dtype, int BH, int BHkv, int Sq, int T, int Dh, int causal,
                     int window, float softcap, float scale, int bound_loop, void* stream) {
  const Args a{BH, BHkv, Sq, T, Dh, causal, window, bound_loop, softcap, scale};
  const cudaStream_t st = (cudaStream_t)stream;
  if (int e = check(a, kDkv, dtype)) return e;
  if (dtype == 1) {
#define DKV_MMA_CALL(DP) dkv_mma<DP>(a, q, k, v, dout, lse, delta, dk_out, dv_out, st)
    DP_DISPATCH(Dh, DKV_MMA_CALL)
#undef DKV_MMA_CALL
  }
#define DKV_CALL(NC) dkv<NC>(a, q, k, v, dout, lse, delta, dk_out, dv_out, st)
  NC_DISPATCH(Dh, DKV_CALL)
#undef DKV_CALL
}

// Bytes of dynamic shared memory one block of `kind` (0 forward, 1 dQ, 2
// dK/dV) takes at head dim Dh in dtype 0 (float32) or 1 (bf16); -1 for
// arguments no kernel takes.
int flash_smem_bytes(int kind, int dtype, int Dh) {
  if (kind < kFwd || kind > kDkv || (dtype != 0 && dtype != 1) || Dh < 1 || Dh > kMaxHeadDim)
    return -1;
  return (int)plan_smem(kind, dtype, Dh);
}

}  // extern "C"
