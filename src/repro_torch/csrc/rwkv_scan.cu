// The RWKV6 WKV recurrence and its gradient, for Hopper (sm_90a).
//
// rwkv_fwd_kernel replaces `rwkv_scan_pallas` (`_rwkv_kernel`,
// src/repro/kernels/rwkv_scan.py). Per stream bh (one batch row and head),
// with the state S (D, D) indexed [k-dim i, v-dim j] and S_0 = 0:
//     o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T
// rwkv_bwd_kernel is its gradient, which the JAX package gets by autodiff
// of `lax.scan` (no TPU kernel). With dS the adjoint of S_t (0 after the
// last step) and c = v_t . do_t, going from t = T-1 down to 0:
//     dr_t = S_{t-1} do_t + u * k_t c      dw_t = rowsum(dS * S_{t-1})
//     dk_t = dS v_t + u * r_t c             du  += r_t * k_t c
//     dv_t = dS^T k_t + (sum_i r_t u k_t) do_t
//     dS   = diag(w_t) dS + r_t do_t^T
// All inputs and outputs are float32, (BH, T, D) row-major, u and du (BH, D).
//
// What bounds them on this card: at the model's shapes (D = 64, T = 256)
// the forward reads four (T, D) streams and writes one, 5 * 64 KB a
// stream, and the function needs 5 float32 operations per state element
// per step (r . S 2; the decay update and k v^T 3; the bonus term is O(D)),
// T * D^2 * 5 = 5.2 MFLOP a stream: 16 FLOP a byte, below the ratio of the
// float32 CUDA cores to HBM (67 TFLOP/s over 3.35 TB/s = 20), so the bytes
// bound it. This kernel executes 7 per element, as it folds the bonus into
// every element. The backward moves 9 streams and needs 14 operations per
// element (one recompute of S, dS, and the dr, dk, dv, dw sums): 25 FLOP a
// byte, bound by the CUDA cores (this form of the recurrence has no matrix
// product for the tensor cores).
// Every element of S is its own scalar recurrence in t, so the work is
// parallel over (bh, i, j) and sequential only in t.
//
// What the design does about it:
//   * One instance for every D: blocks of kThreads = 64 threads, a thread
//     holding kChunk = 64 elements of S. A smaller D runs with zero padding.
//   * Forward: one block per (stream, block of up to 64 v-columns j), one
//     thread per column. The thread keeps its column S[i0:i0+kChunk, j] in
//     registers and reads r_t, k_t, w_t and u from shared memory (the same
//     address across the warp: a broadcast), staged kTile steps at a time
//     with coalesced loads of the contiguous (kTile, D) row blocks. For
//     D > kChunk the rows are done in chunks of kChunk, one pass over T each,
//     and the output accumulates the chunks' partial sums in a fixed order,
//     so any D runs with the state in registers and no scratch.
//   * The state at the start of each tile is written to `states` (BH,
//     n_tiles, D, D) when the caller will differentiate (never in the no-grad
//     selection forward). The backward never rebuilds S_{t-1} by dividing by
//     w_t (w = exp(-exp(.)) reaches 1e-9): it reloads the tile's start state
//     and recomputes forward inside the tile, O(kTile^2 / 2) extra steps a
//     tile, which at kTile = 16 costs about as much as the backward's own
//     arithmetic and no memory beyond the tile states.
//   * Backward, one launch, two kinds of block (blockIdx.y): "row" blocks
//     own rows i of S and dS, so dr, dk, dw and du are sums along the
//     thread's own row (no cross-thread reduction); "column" blocks own
//     columns j of dS, so dv is a sum down the thread's own column. The
//     column blocks need no S at all: dS alone runs backward from 0.
//   * No atomics, fixed summation orders: reruns are bit-equal. The
//     recompute uses the forward's own expression, fmaf(S, w, k * v), so it
//     reproduces the forward's states bit for bit.
// Tensor cores, a chunked (matrix) form of the recurrence and several
// streams per block are later work.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;     // time steps per staged tile and per saved state (TIME_TILE)
constexpr int kThreads = 64;  // threads per block: one column (forward) or row of S each
constexpr int kChunk = 64;    // rows (columns) of S a thread holds in registers per pass

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// forward: grid (BH, ceil(D / kThreads)); thread x owns column j = blockIdx.y*kThreads + x
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
rwkv_fwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, float* __restrict__ o,
                float* __restrict__ states, int T, int D) {
  __shared__ float sr[kTile][kChunk], sk[kTile][kChunk], sw[kTile][kChunk], su[kChunk];
  __shared__ float sv[kTile][kThreads];
  const size_t bh = blockIdx.x;
  const int x = threadIdx.x;
  const int j0 = blockIdx.y * kThreads;
  const int j = j0 + x;
  const bool active = j < D;
  const size_t base = bh * (size_t)T * D;
  const int tiles = ceil_div(T, kTile);
  for (int i0 = 0; i0 < D; i0 += kChunk) {
    const int ni = min(kChunk, D - i0);
    float s[kChunk];
#pragma unroll
    for (int a = 0; a < kChunk; ++a) s[a] = 0.f;
    for (int c = 0; c < tiles; ++c) {
      const int t0 = c * kTile;
      const int nt = min(kTile, T - t0);
      __syncthreads();                       // the previous tile is read
      if (c == 0)
        for (int a = x; a < kChunk; a += kThreads) su[a] = a < ni ? u[bh * D + i0 + a] : 0.f;
      for (int e = x; e < kTile * kChunk; e += kThreads) {
        const int tt = e / kChunk, a = e % kChunk;
        const bool in = tt < nt && a < ni;
        const size_t g = base + (size_t)(t0 + tt) * D + i0 + a;
        sr[tt][a] = in ? r[g] : 0.f;         // zero padding keeps the padded
        sk[tt][a] = in ? k[g] : 0.f;         // state rows at exactly 0
        sw[tt][a] = in ? w[g] : 0.f;
      }
      for (int e = x; e < kTile * kThreads; e += kThreads) {
        const int tt = e / kThreads, b = e % kThreads;
        sv[tt][b] = (tt < nt && j0 + b < D) ? v[base + (size_t)(t0 + tt) * D + j0 + b] : 0.f;
      }
      __syncthreads();
      if (states != nullptr && active) {     // S_{t0-1}[i0:i0+ni, j]
        float* st = states + ((bh * tiles + c) * (size_t)D + i0) * D + j;
#pragma unroll
        for (int a = 0; a < kChunk; ++a)
          if (a < ni) st[(size_t)a * D] = s[a];
      }
      for (int tt = 0; tt < nt; ++tt) {
        const float vj = sv[tt][x];
        float acc = 0.f;
#pragma unroll
        for (int a = 0; a < kChunk; ++a) {
          const float kv = sk[tt][a] * vj;
          acc = fmaf(sr[tt][a], fmaf(su[a], kv, s[a]), acc);
          s[a] = fmaf(s[a], sw[tt][a], kv);
        }
        if (active) {
          float* op = o + base + (size_t)(t0 + tt) * D + j;
          *op = i0 == 0 ? acc : *op + acc;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// dynamic shared memory of a row block (r, k, w by row; v, do by column; c;
// the start state) and of a column block (r, k, w by row; u; do by column;
// sum r u k): a block is either, so it gets the larger
constexpr int kRowSmemWords =
    3 * kTile * kThreads + 2 * kTile * kChunk + kTile + kThreads * (kChunk + 1);
constexpr int kColSmemWords = 3 * kTile * kChunk + kChunk + kTile * kThreads + kTile;
constexpr int kBwdSmemBytes =
    4 * (kRowSmemWords > kColSmemWords ? kRowSmemWords : kColSmemWords);

// Row block: thread x owns row i = rb*kThreads + x of S_{t-1} and dS, columns in
// chunks of kChunk: dr, dk, dw (partial sums over the chunk's columns, added in
// chunk order) and du.
__device__ void bwd_rows(float* smem, int rb, const float* __restrict__ r,
                         const float* __restrict__ k, const float* __restrict__ v,
                         const float* __restrict__ w, const float* __restrict__ u,
                         const float* __restrict__ dout,
                         const float* __restrict__ states, float* __restrict__ dr,
                         float* __restrict__ dk, float* __restrict__ dw,
                         float* __restrict__ du, int T, int D) {
  float* sr = smem;                          // [kTile][kThreads]
  float* sk = sr + kTile * kThreads;
  float* sw = sk + kTile * kThreads;
  float* sv = sw + kTile * kThreads;         // [kTile][kChunk]
  float* sdo = sv + kTile * kChunk;
  float* sc = sdo + kTile * kChunk;          // [kTile]: c_t = v_t . do_t
  float* s0 = sc + kTile;                    // [kThreads][kChunk + 1]: tile start state
  const size_t bh = blockIdx.x;
  const int x = threadIdx.x;
  const int i_base = rb * kThreads;
  const int i = i_base + x;
  const bool active = i < D;
  const size_t base = bh * (size_t)T * D;
  const int tiles = ceil_div(T, kTile);
  const float ui = active ? u[bh * D + i] : 0.f;
  float du_acc = 0.f;
  for (int j0 = 0; j0 < D; j0 += kChunk) {
    const int nj = min(kChunk, D - j0);
    float ds[kChunk];
#pragma unroll
    for (int a = 0; a < kChunk; ++a) ds[a] = 0.f;
    for (int c = tiles - 1; c >= 0; --c) {
      const int t0 = c * kTile;
      const int nt = min(kTile, T - t0);
      __syncthreads();
      for (int e = x; e < kTile * kThreads; e += kThreads) {
        const int tt = e / kThreads, b = e % kThreads;
        const bool in = tt < nt && i_base + b < D;
        const size_t g = base + (size_t)(t0 + tt) * D + i_base + b;
        sr[e] = in ? r[g] : 0.f;
        sk[e] = in ? k[g] : 0.f;
        sw[e] = in ? w[g] : 0.f;
      }
      for (int e = x; e < kTile * kChunk; e += kThreads) {
        const int tt = e / kChunk, a = e % kChunk;
        const bool in = tt < nt && a < nj;
        const size_t g = base + (size_t)(t0 + tt) * D + j0 + a;
        sv[e] = in ? v[g] : 0.f;
        sdo[e] = in ? dout[g] : 0.f;
      }
      const float* st = states + ((bh * tiles + c) * (size_t)D + i_base) * D + j0;
      for (int e = x; e < kThreads * kChunk; e += kThreads) {
        const int b = e / kChunk, a = e % kChunk;
        s0[b * (kChunk + 1) + a] = (i_base + b < D && a < nj) ? st[(size_t)b * D + a] : 0.f;
      }
      if (j0 == 0 && x < nt) {               // c over all D columns, in order
        const float* vr = v + base + (size_t)(t0 + x) * D;
        const float* dr_ = dout + base + (size_t)(t0 + x) * D;
        float cc = 0.f;
        for (int b = 0; b < D; ++b) cc = fmaf(vr[b], dr_[b], cc);
        sc[x] = cc;
      }
      __syncthreads();
      for (int tt = nt - 1; tt >= 0; --tt) {
        float s[kChunk];                         // S_{t-1}[i, chunk], recomputed
#pragma unroll
        for (int a = 0; a < kChunk; ++a) s[a] = s0[x * (kChunk + 1) + a];
        for (int q = 0; q < tt; ++q) {
          const float wq = sw[q * kThreads + x], kq = sk[q * kThreads + x];
#pragma unroll
          for (int a = 0; a < kChunk; ++a) s[a] = fmaf(s[a], wq, kq * sv[q * kChunk + a]);
        }
        float drp = 0.f, dkp = 0.f, dwp = 0.f;
#pragma unroll
        for (int a = 0; a < kChunk; ++a) {
          drp = fmaf(s[a], sdo[tt * kChunk + a], drp);
          dkp = fmaf(ds[a], sv[tt * kChunk + a], dkp);
          dwp = fmaf(ds[a], s[a], dwp);
        }
        const float wt = sw[tt * kThreads + x], rt = sr[tt * kThreads + x];
        const float kt = sk[tt * kThreads + x];
#pragma unroll
        for (int a = 0; a < kChunk; ++a) ds[a] = fmaf(ds[a], wt, rt * sdo[tt * kChunk + a]);
        if (active) {
          const size_t g = base + (size_t)(t0 + tt) * D + i;
          if (j0 == 0) {
            const float cc = sc[tt];
            dr[g] = fmaf(ui * kt, cc, drp);
            dk[g] = fmaf(ui * rt, cc, dkp);
            dw[g] = dwp;
            du_acc = fmaf(rt * kt, cc, du_acc);
          } else {
            dr[g] += drp;
            dk[g] += dkp;
            dw[g] += dwp;
          }
        }
      }
    }
  }
  if (active) du[bh * D + i] = du_acc;
}

// Column block: thread x owns column j = cb*kThreads + x of dS, rows in chunks of
// kChunk: dv (partial sums over the chunk's rows, added in chunk order).
__device__ void bwd_cols(float* smem, int cb, const float* __restrict__ r,
                         const float* __restrict__ k, const float* __restrict__ w,
                         const float* __restrict__ u, const float* __restrict__ dout,
                         float* __restrict__ dv, int T, int D) {
  float* sr = smem;                          // [kTile][kChunk]
  float* sk = sr + kTile * kChunk;
  float* sw = sk + kTile * kChunk;
  float* su = sw + kTile * kChunk;               // [kChunk]
  float* sdo = su + kChunk;                      // [kTile][kThreads]
  float* sruk = sdo + kTile * kThreads;            // [kTile]: sum over the chunk of r u k
  const size_t bh = blockIdx.x;
  const int x = threadIdx.x;
  const int j_base = cb * kThreads;
  const int j = j_base + x;
  const bool active = j < D;
  const size_t base = bh * (size_t)T * D;
  const int tiles = ceil_div(T, kTile);
  for (int i0 = 0; i0 < D; i0 += kChunk) {
    const int ni = min(kChunk, D - i0);
    float ds[kChunk];
#pragma unroll
    for (int a = 0; a < kChunk; ++a) ds[a] = 0.f;
    for (int c = tiles - 1; c >= 0; --c) {
      const int t0 = c * kTile;
      const int nt = min(kTile, T - t0);
      __syncthreads();
      for (int a = x; a < kChunk; a += kThreads) su[a] = a < ni ? u[bh * D + i0 + a] : 0.f;
      for (int e = x; e < kTile * kChunk; e += kThreads) {
        const int tt = e / kChunk, a = e % kChunk;
        const bool in = tt < nt && a < ni;
        const size_t g = base + (size_t)(t0 + tt) * D + i0 + a;
        sr[e] = in ? r[g] : 0.f;
        sk[e] = in ? k[g] : 0.f;
        sw[e] = in ? w[g] : 0.f;
      }
      for (int e = x; e < kTile * kThreads; e += kThreads) {
        const int tt = e / kThreads, b = e % kThreads;
        sdo[e] = (tt < nt && j_base + b < D)
                     ? dout[base + (size_t)(t0 + tt) * D + j_base + b] : 0.f;
      }
      __syncthreads();
      if (x < nt) {
        float acc = 0.f;
        for (int a = 0; a < kChunk; ++a)
          acc = fmaf(sr[x * kChunk + a] * su[a], sk[x * kChunk + a], acc);
        sruk[x] = acc;
      }
      __syncthreads();
      for (int tt = nt - 1; tt >= 0; --tt) {
        const float doj = sdo[tt * kThreads + x];
        float dvp = 0.f;
#pragma unroll
        for (int a = 0; a < kChunk; ++a) dvp = fmaf(ds[a], sk[tt * kChunk + a], dvp);
#pragma unroll
        for (int a = 0; a < kChunk; ++a)
          ds[a] = fmaf(ds[a], sw[tt * kChunk + a], sr[tt * kChunk + a] * doj);
        dvp = fmaf(sruk[tt], doj, dvp);
        if (active) {
          float* p = dv + base + (size_t)(t0 + tt) * D + j;
          *p = i0 == 0 ? dvp : *p + dvp;
        }
      }
    }
  }
}

// grid (BH, 2 * ceil(D / kThreads)): the first half of blockIdx.y are row blocks,
// the second half column blocks.
__global__ void __launch_bounds__(kThreads)
rwkv_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ dout,
                const float* __restrict__ states, float* __restrict__ dr,
                float* __restrict__ dk, float* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ du, int T, int D) {
  extern __shared__ float smem[];
  const int blocks = (int)gridDim.y / 2;
  if ((int)blockIdx.y < blocks)
    bwd_rows(smem, blockIdx.y, r, k, v, w, u, dout, states, dr, dk, dw, du, T, D);
  else
    bwd_cols(smem, blockIdx.y - blocks, r, k, w, u, dout, dv, T, D);
}

bool bad_shape(int BH, int T, int D, int y_blocks) {
  return BH < 1 || T < 1 || D < 1 || y_blocks > 65535;
}

}  // namespace

extern "C" {

// The forward over BH streams on `stream`: r, k, v, w (BH,T,D), u (BH,D) ->
// o (BH,T,D). With `states` non-null it also writes the state at the start
// of every kTile steps, states (BH, ceil(T/kTile), D, D). Returns a
// cudaError_t code: nonzero if the arguments are refused or the launch fails.
int rwkv_scan_forward_launch(const void* r, const void* k, const void* v, const void* w,
                             const void* u, void* o, void* states, int BH, int T, int D,
                             void* stream) {
  if (bad_shape(BH, T, D, ceil_div(D, kThreads))) return (int)cudaErrorInvalidValue;
  const dim3 grid(BH, ceil_div(D, kThreads));
  rwkv_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)w, (const float*)u,
      (float*)o, (float*)states, T, D);
  return (int)cudaGetLastError();
}

// The backward: with do (BH,T,D) and the forward's `states` -> dr, dk, dv,
// dw (BH,T,D) and du (BH,D) per stream, in one launch.
int rwkv_scan_backward_launch(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* dout, const void* states,
                              void* dr, void* dk, void* dv, void* dw, void* du, int BH,
                              int T, int D, void* stream) {
  if (bad_shape(BH, T, D, 2 * ceil_div(D, kThreads)) || states == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      rwkv_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, 2 * ceil_div(D, kThreads));
  rwkv_bwd_kernel<<<grid, kThreads, kBwdSmemBytes, (cudaStream_t)stream>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)w, (const float*)u,
      (const float*)dout, (const float*)states, (float*)dr, (float*)dk, (float*)dv,
      (float*)dw, (float*)du, T, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
