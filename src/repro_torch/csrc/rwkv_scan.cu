// The RWKV6 WKV recurrence and its gradient, for Hopper (sm_90a).
//
// rwkv_fwd_kernel replaces `rwkv_scan_pallas` (`_rwkv_kernel`,
// src/repro/kernels/rwkv_scan.py). Per stream bh (one batch row and head),
// with the state S (D, D) indexed [k-dim i, v-dim j] and S_0 = 0:
//     o_t = S_{t-1}^T r_t + (sum_i r_t,i u_i k_t,i) v_t
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
// What bounds them on this card. At the model's shapes (D = 64, T = 256)
// the forward moves five (T, D) streams, 5 * 64 KB a stream, and needs 5
// float32 operations per state element and step, 3 instructions (r . S, and
// the update w * S + k v): 16 FLOP a byte, under the float32 CUDA cores' 20
// (67 TFLOP/s over 3.35 TB/s), so bytes bound it (0.100 ms at BH 1024). The backward
// moves nine streams and needs ~8 instructions an element (the recompute of
// S 2, the dS update 2, and the dr, dk, dv, dw sums 4): the CUDA cores bound
// it. Every element of S is its own scalar recurrence in t, so the work is
// parallel over (bh, i, j) and sequential only in t: a block walks T one
// step at a time. What holds such a kernel back is less the arithmetic than
// what each step costs around it: shared loads (every lane of a warp pays for
// a 16-byte load, broadcast or not), the sums across lanes, and the latency
// of each step's chain when few warps share an SM, as at the subset's
// BH 128, where one stream runs on each SM.
//
// What the design does about it:
//   * A block owns a 64 x 64 patch of one stream's S for a whole pass over
//     T; a D above 64 runs in passes over 64-row (and, for the backward,
//     64-column) chunks that add their partial sums in chunk order.
//   * Inputs are staged in shared memory by cp.async (16-byte copies where
//     the rows allow, else 4-byte) and double-buffered: the next tile loads
//     while this one computes. Missing rows and columns are zero-filled, so
//     a padded row or column of S stays exactly 0, and every step of a tile
//     runs: past T the inputs are zero and nothing is written.
//   * Forward: 4 warps, a thread holding 8 rows x 4 columns of S in
//     registers. A step costs a thread 7 sixteen-byte shared loads and 96
//     float32 instructions, 3 an element. The bonus is hoisted: one dot
//     product sum_i r u k per step, summed by the block once per 8-step
//     tile. The 8 row groups of a warp add their partial outputs two steps
//     at a time by shuffles that halve the values a lane holds at each level
//     (7 shuffles for 8 outputs), and each lane writes one output.
//   * Backward: one 256-thread block per stream, a thread holding 2 rows x 8
//     columns of S and dS, so its v and do loads and its dv sums serve two
//     rows. It reloads the tile's start state (saved by the forward every
//     kTile steps) and recomputes the states of 8 steps at a time into
//     registers, so each state is recomputed about 1.4 times and never by
//     dividing by w (w = exp(-exp(.)) reaches 1e-9, and 0). dr, dk and dw
//     are row sums across the 8 lanes that share a row (the same halving
//     shuffles); dv is summed over the warp's rows by shuffles and over the
//     block's 8 warps in shared memory at the end of each tile, in warp
//     order. One kind of block, no second pass.
//   * No atomics, fixed summation orders: reruns are bit-equal. The
//     recompute uses the forward's own expression, fmaf(S, w, k * v), so it
//     reproduces the forward's states bit for bit.
// Tensor cores and a chunked (matrix) form of the recurrence are untried.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;          // time steps per saved state (TIME_TILE) and per backward tile
constexpr int kStage = 8;          // time steps per staged tile of the forward
constexpr int kRows = 64;          // rows of S a block holds in one pass
constexpr int kCols = 64;          // columns of S a block holds in one pass
constexpr int kFwdRows = 8;        // rows of S a forward thread holds
constexpr int kFwdCols = 4;        // columns of S a forward thread holds
constexpr int kFwdThreads = 128;   // forward block: 4 warps of 16 columns each
constexpr int kBwdRows = 2;        // rows of S a backward thread holds
constexpr int kBwdThreads = 512 / kBwdRows;      // backward block: 8 warps of 8 rows each
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdCols = 8;        // columns of S a backward thread holds
constexpr int kSub = 8;            // steps whose states a backward thread keeps in registers
static_assert(kFwdThreads == kStage * kRows / 4, "one 16-byte copy of each of r, k, w, v a thread");
static_assert(kFwdThreads / 32 * 2 == kStage, "two steps' bonus a warp");

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// 4-byte asynchronous copy global -> shared; `in` false writes a zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(in ? 4 : 0) : "memory");
}
// 16-byte asynchronous copy global -> shared (both 16-byte aligned)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ bool aligned16(const float* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// The state update of one element, the same expression in both kernels.
__device__ __forceinline__ float decay_update(float s, float w, float k, float v) {
  return fmaf(s, w, __fmul_rn(k, v));
}

// ---------------------------------------------------------------------------
// forward: grid (BH, ceil(D / kCols)), kFwdThreads threads. Lane bits 0-2 are
// the row group rg (rows 4 rg + a and 32 + 4 rg + a of the pass, a < 4), bits
// 3-4 the column group cg; warp wp holds columns 16 wp + 4 cg + c, c < 4.
// ---------------------------------------------------------------------------

// the pass's row that a thread of row group rg holds as its a-th
__device__ __forceinline__ int fwd_row(int rg, int a) { return a < 4 ? 4 * rg + a : 28 + 4 * rg + a; }

// Halve-and-send sums of 8 values over the 8 lanes of a row group (lane
// bits 2, 1, 0 in that order): at each level a lane keeps half its values,
// sends the other half to its partner and adds what it receives, so after 7
// shuffles lane rg holds the whole sum of value rg. `t` rides along with no
// sums: it ends as value rg's own t.
__device__ __forceinline__ void halve8(float (&x)[8], float (&t)[8], int lane) {
#pragma unroll
  for (int m = 4, h = 4; m >= 1; m >>= 1, h >>= 1) {
    const bool hi = (lane & m) != 0;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < h) {
        const float keep = hi ? x[q + h] : x[q];
        const float send = hi ? x[q] : x[q + h];
        t[q] = hi ? t[q + h] : t[q];
        x[q] = keep + __shfl_xor_sync(0xffffffffu, send, m);
      }
  }
}

__global__ void __launch_bounds__(kFwdThreads, 4)
rwkv_fwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, float* __restrict__ o,
                float* __restrict__ states, int T, int D) {
  constexpr int C = kFwdCols;
  constexpr int kBatch = 8 / C;      // steps whose outputs one halving sum takes
  __shared__ __align__(16) float sr[2][kStage][kRows];
  __shared__ __align__(16) float sk[2][kStage][kRows];
  __shared__ __align__(16) float sw[2][kStage][kRows];
  __shared__ __align__(16) float sv[2][kStage][kCols];
  __shared__ __align__(16) float su[kRows];
  __shared__ float sb[2][kStage];    // sum over the pass's rows of r u k, per step
  const int x = threadIdx.x, lane = x & 31, warp = x >> 5;
  const int rg = lane & 7, cg = lane >> 3;
  const size_t bh = blockIdx.x;
  const int j0 = blockIdx.y * kCols;
  const int jl = warp * 4 * C + cg * C;          // the thread's first column in the block
  const size_t base = bh * (size_t)T * D;
  const int stages = ceil_div(T, kStage);
  const int tiles = ceil_div(T, kTile);
  // rows start on 16 bytes: 16-byte copies
  const bool vec = (D & 3) == 0 && aligned16(r) && aligned16(k) && aligned16(w) && aligned16(v);
  // after the halving sums lane rg holds value rg of its batch: step rg / C
  // of the batch, column rg % C
  const int out_b = rg / C, out_col = j0 + jl + rg % C;
  // the bonus: warp wp sums steps 2 wp and 2 wp + 1, lane l the 4 rows from
  // 4 (l & 15) of step 2 wp + l / 16
  const int bon_t = 2 * warp + (lane >> 4), bon_row = 4 * (lane & 15);
  const bool vec_states = (D & 3) == 0 && aligned16(states);

  for (int i0 = 0; i0 < D; i0 += kRows) {
    auto stage = [&](int c, int b) {
      const int t0 = c * kStage, nt = min(kStage, T - t0);
      if (vec) {                             // x: step x / 16, 4 rows (columns) from 4 (x % 16)
        const int tt = x >> 4, a = 4 * (x & 15);
        const size_t g = base + (size_t)(t0 + tt) * D;
        const bool row_in = tt < nt && i0 + a < D, col_in = tt < nt && j0 + a < D;
        cp_async16(&sr[b][tt][a], r + (row_in ? g + i0 + a : 0), row_in);
        cp_async16(&sk[b][tt][a], k + (row_in ? g + i0 + a : 0), row_in);
        cp_async16(&sw[b][tt][a], w + (row_in ? g + i0 + a : 0), row_in);
        cp_async16(&sv[b][tt][a], v + (col_in ? g + j0 + a : 0), col_in);
      } else {
        for (int e = x; e < kStage * kRows; e += kFwdThreads) {
          const int tt = e / kRows, a = e % kRows;
          const size_t g = base + (size_t)(t0 + tt) * D;
          const bool row_in = tt < nt && i0 + a < D, col_in = tt < nt && j0 + a < D;
          cp_async4(&sr[b][tt][a], r + (row_in ? g + i0 + a : 0), row_in);
          cp_async4(&sk[b][tt][a], k + (row_in ? g + i0 + a : 0), row_in);
          cp_async4(&sw[b][tt][a], w + (row_in ? g + i0 + a : 0), row_in);
          cp_async4(&sv[b][tt][a], v + (col_in ? g + j0 + a : 0), col_in);
        }
      }
      cp_async_commit();
    };
    float s[kFwdRows][C];
#pragma unroll
    for (int a = 0; a < kFwdRows; ++a)
#pragma unroll
      for (int c = 0; c < C; ++c) s[a][c] = 0.f;
    __syncthreads();                       // the previous pass is done with shared memory
    if (x < kRows) su[x] = i0 + x < D ? u[bh * D + i0 + x] : 0.f;
    stage(0, 0);
    for (int c = 0; c < stages; ++c) {
      const int buf = c & 1;
      const int t0 = c * kStage, nt = min(kStage, T - t0);
      cp_async_wait_all();
      __syncthreads();                     // stage c landed; stage c-1's buffer is free
      if (c + 1 < stages) stage(c + 1, buf ^ 1);
      {
        const float4 rq = *reinterpret_cast<const float4*>(&sr[buf][bon_t][bon_row]);
        const float4 kq = *reinterpret_cast<const float4*>(&sk[buf][bon_t][bon_row]);
        const float4 uq = *reinterpret_cast<const float4*>(&su[bon_row]);
        float b = __fmul_rn(__fmul_rn(rq.x, uq.x), kq.x);
        b = fmaf(__fmul_rn(rq.y, uq.y), kq.y, b);
        b = fmaf(__fmul_rn(rq.z, uq.z), kq.z, b);
        b = fmaf(__fmul_rn(rq.w, uq.w), kq.w, b);
#pragma unroll
        for (int m = 1; m <= 8; m <<= 1) b += __shfl_xor_sync(0xffffffffu, b, m);
        if ((lane & 15) == 0) sb[buf][bon_t] = b;
      }
      if (states != nullptr && c % (kTile / kStage) == 0) {  // S_{t0-1}
        float* st = states + (bh * tiles + c / (kTile / kStage)) * (size_t)D * D;
#pragma unroll
        for (int a = 0; a < kFwdRows; ++a) {
          const int i = i0 + fwd_row(rg, a);
          float* p = st + (size_t)i * D + j0 + jl;
          if (vec_states && i < D && j0 + jl < D) {
            *reinterpret_cast<float4*>(p) = make_float4(s[a][0], s[a][1], s[a][2], s[a][3]);
          } else {
#pragma unroll
            for (int cc = 0; cc < C; ++cc)
              if (i < D && j0 + jl + cc < D) p[cc] = s[a][cc];
          }
        }
      }
      __syncthreads();                     // sb of this stage
      // every step of the stage runs: past T the inputs are zero and the
      // state, never read again, decays to 0
#pragma unroll
      for (int g = 0; g < kStage / kBatch; ++g) {
        float acc[8], vt[8];
#pragma unroll
        for (int bb = 0; bb < kBatch; ++bb) {
          const int tt = g * kBatch + bb;
          float rr[kFwdRows], kk[kFwdRows], ww[kFwdRows];
          {
            const float4 r0 = *reinterpret_cast<const float4*>(&sr[buf][tt][4 * rg]);
            const float4 r1 = *reinterpret_cast<const float4*>(&sr[buf][tt][32 + 4 * rg]);
            const float4 k0 = *reinterpret_cast<const float4*>(&sk[buf][tt][4 * rg]);
            const float4 k1 = *reinterpret_cast<const float4*>(&sk[buf][tt][32 + 4 * rg]);
            const float4 w0 = *reinterpret_cast<const float4*>(&sw[buf][tt][4 * rg]);
            const float4 w1 = *reinterpret_cast<const float4*>(&sw[buf][tt][32 + 4 * rg]);
            rr[0] = r0.x; rr[1] = r0.y; rr[2] = r0.z; rr[3] = r0.w;
            rr[4] = r1.x; rr[5] = r1.y; rr[6] = r1.z; rr[7] = r1.w;
            kk[0] = k0.x; kk[1] = k0.y; kk[2] = k0.z; kk[3] = k0.w;
            kk[4] = k1.x; kk[5] = k1.y; kk[6] = k1.z; kk[7] = k1.w;
            ww[0] = w0.x; ww[1] = w0.y; ww[2] = w0.z; ww[3] = w0.w;
            ww[4] = w1.x; ww[5] = w1.y; ww[6] = w1.z; ww[7] = w1.w;
          }
          const float4 vq = *reinterpret_cast<const float4*>(&sv[buf][tt][jl]);
          const float vv[C] = {vq.x, vq.y, vq.z, vq.w};
#pragma unroll
          for (int cc = 0; cc < C; ++cc) {
            acc[bb * C + cc] = 0.f;
            vt[bb * C + cc] = vv[cc];
          }
#pragma unroll
          for (int a = 0; a < kFwdRows; ++a)
#pragma unroll
            for (int cc = 0; cc < C; ++cc) {
              acc[bb * C + cc] = fmaf(rr[a], s[a][cc], acc[bb * C + cc]);
              s[a][cc] = decay_update(s[a][cc], ww[a], kk[a], vv[cc]);
            }
        }
        halve8(acc, vt, lane);
        const int tt = g * kBatch + out_b;
        if (tt < nt && out_col < D) {
          float val = fmaf(sb[buf][tt], vt[0], acc[0]);
          float* op = o + base + (size_t)(t0 + tt) * D + out_col;
          if (i0 > 0) val += *op;
          *op = val;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward: grid (BH,), kBwdThreads threads. Warp wp holds rows
// 4 kBwdRows wp + rg + 4 r (r < kBwdRows) of the pass (rg = lane bits 3-4), a
// lane its columns 4 cg + c and 32 + 4 cg + c (cg = lane bits 0-2, c < 4).
// ---------------------------------------------------------------------------

struct BwdSmem {
  float4 rkw[2][kTile][kRows];                 // r, k, w of each row (.w unused)
  float v[2][kTile][kCols], dout[2][kTile][kCols];
  float s0[2][kRows][kCols];                   // the tile's start state
  float2 cb[2][kTile];                         // c_t = v . do over all D; sum r u k over the pass's rows
  float u[kRows];
  float dvp[kTile][kBwdWarps][kCols];          // dv partial sums of each warp
  float orow[3][kTile][kRows];                 // dr, dk, dw of the tile
};

__device__ __forceinline__ void load8(float (&d)[kBwdCols], const float* row, int cg) {
  const float4 a = *reinterpret_cast<const float4*>(row + 4 * cg);
  const float4 b = *reinterpret_cast<const float4*>(row + 32 + 4 * cg);
  d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
  d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
}

// Four values of (t0 + tt, col..col+3) of a (BH, T, D) output: written, or
// added to what an earlier pass wrote; those past D are not written.
__device__ __forceinline__ void put4(float* out, size_t row_base, int col, int D, float4 val,
                                     bool accumulate) {
  const float x[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (col + e < D) {
      float* p = out + row_base + col + e;
      if (accumulate) *p += x[e];
      else *p = x[e];
    }
}

__global__ void __launch_bounds__(kBwdThreads, 1)
rwkv_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ dout,
                const float* __restrict__ states, float* __restrict__ dr,
                float* __restrict__ dk, float* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ du, int T, int D) {
  constexpr int R = kBwdRows;
  constexpr int kVals = 4 * R;                   // (dr, dk, dw, -) of each row, summed over lanes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(smem_raw);
  const int x = threadIdx.x, lane = x & 31, warp = x >> 5;
  const int cg = lane & 7, rg = lane >> 3;
  int il[R];                                     // the thread's rows in the pass
#pragma unroll
  for (int q = 0; q < R; ++q) il[q] = 4 * R * warp + rg + 4 * q;
  const size_t bh = blockIdx.x;
  const size_t base = bh * (size_t)T * D;
  const int tiles = ceil_div(T, kTile);
  const bool one_chunk = D <= kCols;
  // rows start on 16 bytes: 16-byte copies
  const bool vec = (D & 3) == 0 && aligned16(v) && aligned16(dout) && aligned16(states);
  // the two columns a lane holds after the dv sums over the warp's row groups
  const int dv_col = ((lane & 16) ? 32 : 0) + 4 * cg + ((lane & 8) ? 2 : 0);
  // after the row sums lane cg holds value `row_val` of rs: halving over lane
  // bits 0, 1, 2 keeps the upper half where the bit is set
  int row_val = 0;
  {
    int n = kVals;
#pragma unroll
    for (int m = 1; m <= 4; m <<= 1)
      if (n > 1) { n >>= 1; if (lane & m) row_val += n; }
  }
  const int row_of_val = il[0] + 4 * (row_val / 4), which_of_val = row_val % 4;
  // lanes past the first kVals hold copies
  const bool val_writer = which_of_val < 3 && cg < kVals;

  for (int i0 = 0; i0 < D; i0 += kRows) {
    const int row = i0 + row_of_val;
    const float ui = row < D ? u[bh * D + row] : 0.f;
    float du_acc = 0.f;
    for (int j0 = 0; j0 < D; j0 += kCols) {
      auto stage = [&](int c, int b) {
        const int t0 = c * kTile, nt = min(kTile, T - t0);
        for (int e = x; e < kTile * kRows; e += kBwdThreads) {
          const int tt = e / kRows, a = e % kRows;
          const bool in = tt < nt && i0 + a < D;
          const size_t g = in ? base + (size_t)(t0 + tt) * D + i0 + a : 0;
          float* d = reinterpret_cast<float*>(&sm.rkw[b][tt][a]);
          cp_async4(d, r + g, in);
          cp_async4(d + 1, k + g, in);
          cp_async4(d + 2, w + g, in);
        }
        const float* st = states + (bh * tiles + c) * (size_t)D * D;
        if (vec) {                           // 16-byte copies of v, do and the start state
#pragma unroll
          for (int e = x; e < 2 * kTile * kCols / 4; e += kBwdThreads) {
            const int q = e % (kTile * kCols / 4), tt = q >> 4, a = 4 * (q & 15);
            const bool in = tt < nt && j0 + a < D;
            const size_t g = in ? base + (size_t)(t0 + tt) * D + j0 + a : 0;
            if (e < kTile * kCols / 4) cp_async16(&sm.v[b][tt][a], v + g, in);
            else cp_async16(&sm.dout[b][tt][a], dout + g, in);
          }
#pragma unroll
          for (int e = x; e < kRows * kCols / 4; e += kBwdThreads) {
            const int a = e >> 4, bb = 4 * (e & 15);
            const bool in = i0 + a < D && j0 + bb < D;
            cp_async16(&sm.s0[b][a][bb], st + (in ? (size_t)(i0 + a) * D + j0 + bb : 0), in);
          }
        } else {
          for (int e = x; e < kTile * kCols; e += kBwdThreads) {
            const int tt = e / kCols, a = e % kCols;
            const bool in = tt < nt && j0 + a < D;
            const size_t g = in ? base + (size_t)(t0 + tt) * D + j0 + a : 0;
            cp_async4(&sm.v[b][tt][a], v + g, in);
            cp_async4(&sm.dout[b][tt][a], dout + g, in);
          }
          for (int e = x; e < kRows * kCols; e += kBwdThreads) {
            const int a = e / kCols, bb = e % kCols;
            const bool in = i0 + a < D && j0 + bb < D;
            cp_async4(&sm.s0[b][a][bb], st + (in ? (size_t)(i0 + a) * D + j0 + bb : 0), in);
          }
        }
        cp_async_commit();
      };
      float ds[R][kBwdCols];
#pragma unroll
      for (int q = 0; q < R; ++q)
#pragma unroll
        for (int a = 0; a < kBwdCols; ++a) ds[q][a] = 0.f;
      __syncthreads();                       // the previous pass is done with shared memory
      if (x < kRows) sm.u[x] = i0 + x < D ? u[bh * D + i0 + x] : 0.f;
      stage(tiles - 1, 0);
      for (int c = tiles - 1; c >= 0; --c) {
        const int buf = (tiles - 1 - c) & 1;
        const int t0 = c * kTile, nt = min(kTile, T - t0);
        cp_async_wait_all();
        __syncthreads();                     // tile c landed; the other buffer is free
        if (c > 0) stage(c - 1, buf ^ 1);
        for (int tt = warp; tt < kTile; tt += kBwdWarps) {  // c_t over all D, sum r u k over the pass's rows
          float cc = 0.f, b = 0.f;
          if (tt < nt) {
            if (one_chunk) {
#pragma unroll
              for (int a = lane; a < kCols; a += 32)
                cc = fmaf(sm.v[buf][tt][a], sm.dout[buf][tt][a], cc);
            } else {
              const size_t g = base + (size_t)(t0 + tt) * D;
              for (int a = lane; a < D; a += 32) cc = fmaf(v[g + a], dout[g + a], cc);
            }
#pragma unroll
            for (int a = lane; a < kRows; a += 32) {
              const float4 q = sm.rkw[buf][tt][a];
              b = fmaf(__fmul_rn(q.x, sm.u[a]), q.y, b);
            }
          }
          cc = warp_sum(cc);
          b = warp_sum(b);
          if (lane == 0) sm.cb[buf][tt] = make_float2(cc, b);
        }
        __syncthreads();                     // cb of this tile

        // one step of the recompute: S_t from S_{t-1}
        auto advance = [&](float (&s)[R][kBwdCols], int tt) {
          float vv[kBwdCols];
          load8(vv, sm.v[buf][tt], cg);
#pragma unroll
          for (int q = 0; q < R; ++q) {
            const float4 p = sm.rkw[buf][tt][il[q]];
#pragma unroll
            for (int a = 0; a < kBwdCols; ++a) s[q][a] = decay_update(s[q][a], p.z, p.y, vv[a]);
          }
        };
        // one step of the backward with prev = S_{t-1}; every step of the tile
        // runs: past T the inputs are zero and dS stays 0
        auto back = [&](const float (&prev)[R][kBwdCols], int tt) {
          const float2 cb = sm.cb[buf][tt];
          float vv[kBwdCols], dd[kBwdCols];
          load8(vv, sm.v[buf][tt], cg);
          load8(dd, sm.dout[buf][tt], cg);
          float rs[kVals], dvq[kBwdCols];
          float4 mine = make_float4(0.f, 0.f, 0.f, 0.f);   // r, k of the row of the lane's value
#pragma unroll
          for (int q = 0; q < R; ++q) {
            const float4 p = sm.rkw[buf][tt][il[q]];
            if (q == row_val / 4) mine = p;
            float a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll
            for (int a = 0; a < kBwdCols; ++a) {
              a0 = fmaf(prev[q][a], dd[a], a0);
              a1 = fmaf(ds[q][a], vv[a], a1);
              a2 = fmaf(ds[q][a], prev[q][a], a2);
              dvq[a] = q == 0 ? __fmul_rn(ds[q][a], p.y) : fmaf(ds[q][a], p.y, dvq[a]);
              ds[q][a] = fmaf(ds[q][a], p.z, __fmul_rn(p.x, dd[a]));
            }
            rs[4 * q] = a0; rs[4 * q + 1] = a1; rs[4 * q + 2] = a2; rs[4 * q + 3] = 0.f;
          }
          // the row sums over the 8 lanes of a row group (bits 0, 1, 2): keep
          // half, send half while a lane holds more than one value, then add
          {
            int n = kVals;
#pragma unroll
            for (int m = 1; m <= 4; m <<= 1) {
              const bool hi = (lane & m) != 0;
              if (n > 1) {
                const int h = n >> 1;
#pragma unroll
                for (int a = 0; a < kVals / 2; ++a)
                  if (a < h) {
                    const float keep = hi ? rs[a + h] : rs[a];
                    const float send = hi ? rs[a] : rs[a + h];
                    rs[a] = keep + __shfl_xor_sync(0xffffffffu, send, m);
                  }
                n = h;
              } else {
                rs[0] += __shfl_xor_sync(0xffffffffu, rs[0], m);
              }
            }
          }
          // dv over the warp's 4 row groups (lane bits 4, 3): keep half, send half
          {
            const bool hi = (lane & 16) != 0;
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              const float keep = hi ? dvq[a + 4] : dvq[a];
              const float send = hi ? dvq[a] : dvq[a + 4];
              dvq[a] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
            }
          }
          {
            const bool hi = (lane & 8) != 0;
#pragma unroll
            for (int a = 0; a < 2; ++a) {
              const float keep = hi ? dvq[a + 2] : dvq[a];
              const float send = hi ? dvq[a] : dvq[a + 2];
              dvq[a] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
            }
          }
          *reinterpret_cast<float2*>(&sm.dvp[tt][warp][dv_col]) = make_float2(dvq[0], dvq[1]);
          if (val_writer) {
            float val = rs[0];
            if (j0 == 0) {
              if (which_of_val == 0) {
                val = fmaf(ui * mine.y, cb.x, val);
                du_acc = fmaf(mine.x * mine.y, cb.x, du_acc);
              } else if (which_of_val == 1) {
                val = fmaf(ui * mine.x, cb.x, val);
              }
            }
            sm.orow[which_of_val][tt][row_of_val] = val;
          }
        };

        // the states of kSub steps at a time, recomputed into registers from
        // the tile's start state; the second half of the tile first
#pragma unroll
        for (int sub = 1; sub >= 0; --sub) {
          float prev[kSub][R][kBwdCols];
#pragma unroll
          for (int q = 0; q < R; ++q) load8(prev[0][q], sm.s0[buf][il[q]], cg);
          if (sub == 1)
#pragma unroll
            for (int t = 0; t < kSub; ++t) advance(prev[0], t);
#pragma unroll
          for (int t = 1; t < kSub; ++t) {
#pragma unroll
            for (int q = 0; q < R; ++q)
#pragma unroll
              for (int a = 0; a < kBwdCols; ++a) prev[t][q][a] = prev[t - 1][q][a];
            advance(prev[t], sub * kSub + t - 1);
          }
#pragma unroll
          for (int t = kSub - 1; t >= 0; --t) back(prev[t], sub * kSub + t);
        }
        __syncthreads();                     // dvp and orow of the tile
        for (int e = x; e < 4 * kTile * kCols / 4; e += kBwdThreads) {
          if (e < kTile * kCols / 4) {       // dv: 4 columns of a step, summed in warp order
            const int tt = e / (kCols / 4), a = 4 * (e % (kCols / 4));
            float4 acc = *reinterpret_cast<const float4*>(&sm.dvp[tt][0][a]);
#pragma unroll
            for (int q = 1; q < kBwdWarps; ++q) {
              const float4 p = *reinterpret_cast<const float4*>(&sm.dvp[tt][q][a]);
              acc.x += p.x; acc.y += p.y; acc.z += p.z; acc.w += p.w;
            }
            const float bk = sm.cb[buf][tt].y;
            const float4 d4 = *reinterpret_cast<const float4*>(&sm.dout[buf][tt][a]);
            acc.x = fmaf(bk, d4.x, acc.x); acc.y = fmaf(bk, d4.y, acc.y);
            acc.z = fmaf(bk, d4.z, acc.z); acc.w = fmaf(bk, d4.w, acc.w);
            if (tt < nt) put4(dv, base + (size_t)(t0 + tt) * D, j0 + a, D, acc, i0 > 0);
          } else {                           // dr, dk, dw: 4 rows of a step
            const int f = e - kTile * kCols / 4;
            const int which = f / (kTile * kRows / 4), rem = f % (kTile * kRows / 4);
            const int tt = rem / (kRows / 4), a = 4 * (rem % (kRows / 4));
            const float4 val = *reinterpret_cast<const float4*>(&sm.orow[which][tt][a]);
            float* out = which == 0 ? dr : which == 1 ? dk : dw;
            if (tt < nt) put4(out, base + (size_t)(t0 + tt) * D, i0 + a, D, val, j0 > 0);
          }
        }
      }
    }
    if (row < D && val_writer && which_of_val == 0) du[bh * D + row] = du_acc;
  }
}

bool bad_shape(int BH, int T, int D) { return BH < 1 || T < 1 || D < 1 || D > 65535 * kCols; }

}  // namespace

extern "C" {

// The forward over BH streams on `stream`: r, k, v, w (BH,T,D), u (BH,D) ->
// o (BH,T,D). With `states` non-null it also writes the state at the start
// of every kTile steps, states (BH, ceil(T/kTile), D, D). Returns a
// cudaError_t code: nonzero if the arguments are refused or the launch fails.
int rwkv_scan_forward_launch(const void* r, const void* k, const void* v, const void* w,
                             const void* u, void* o, void* states, int BH, int T, int D,
                             void* stream) {
  if (bad_shape(BH, T, D)) return (int)cudaErrorInvalidValue;
  const dim3 grid(BH, ceil_div(D, kCols));
  rwkv_fwd_kernel<<<grid, kFwdThreads, 0, (cudaStream_t)stream>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)w, (const float*)u,
      (float*)o, (float*)states, T, D);
  return (int)cudaGetLastError();
}

// Bytes of dynamic shared memory a backward block takes.
int rwkv_scan_backward_smem_bytes(void) { return (int)sizeof(BwdSmem); }

// The backward: with do (BH,T,D) and the forward's `states` -> dr, dk, dv,
// dw (BH,T,D) and du (BH,D) per stream, in one launch.
int rwkv_scan_backward_launch(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* dout, const void* states,
                              void* dr, void* dk, void* dv, void* dw, void* du, int BH,
                              int T, int D, void* stream) {
  if (bad_shape(BH, T, D) || states == nullptr) return (int)cudaErrorInvalidValue;
  const int bytes = (int)sizeof(BwdSmem);
  const cudaError_t err = cudaFuncSetAttribute(
      rwkv_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  rwkv_bwd_kernel<<<BH, kBwdThreads, bytes, (cudaStream_t)stream>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)w, (const float*)u,
      (const float*)dout, (const float*)states, (float*)dr, (float*)dk, (float*)dv,
      (float*)dw, (float*)du, T, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
