// Packed varlen FlashAttention-2, forward and backward, for Hopper
// (sm_90a), on the CUDA cores.
//
// Replaces three kernels of paddle2_tpu/kernels/pallas_flash.py, driven by
// `_varlen_fwd` and `_varlen_bwd` under the `_flash_varlen` custom VJP:
//   flash_varlen_fwd_kernel <- `_fwd_kernel_varlen`
//   flash_varlen_dkv_kernel <- `_bwd_dkv_kernel_varlen`
//   flash_varlen_dq_kernel  <- `_bwd_dq_kernel_varlen`
//
// The ragged batch is one packed sequence: q [Tq, H, D], k/v [Tk, H, D].
// Every row carries a segment id and an offset; query row r sees key c
// when seg_q[r] == seg_k[c] and off_k[c] <= off_q[r] (the caller gives
// off_q = local position + len_k - len_q for the bottom-right causal
// alignment of each sequence, or 2^30 when not causal). Per (head, tile):
//   forward:  o = softmax(q k^T * scale) v and lse, online over key tiles
//   backward: P = exp(q k^T * scale - lse), dS = P * (dO V^T - delta),
//             dV = P^T dO, dK = dS^T Q * scale, dQ = dS K * scale
// with lse and delta = rowsum(dO * O) f32 [H, Tq], computed outside. As in
// the Pallas kernels and the dense flash kernels, scores, the running
// max and sum and every accumulator are f32; P and dS are rounded to the
// input dtype before they enter a product. A query row that sees no key
// (padding, or a causal row of a sequence with len_k < len_q) gets o = 0,
// lse = -inf and dq = 0; a key no row sees gets dk = dv = 0. The backward
// is the TPU's split pair: dK/dV with the query tiles innermost, dQ with
// the key tiles innermost, so no block writes what another writes, and no
// atomics: an f32 backward is bitwise reproducible.
//
// Tile skipping. The TPU kernel walks every key tile and skips the dead
// ones with pl.when. Here the segments are sorted, so the live keys of a
// query tile form one contiguous range, and the live queries of a key tile
// too. The wrapper computes both per tile (flash_varlen.py `tile_ranges`,
// from the same seg/off rows) and each block loops over its range only; a
// 2048-token sequence packed with sixteen 128-token ones spends no block
// walking dead tiles. The range's ends need not be multiples of 64: tiles
// start at the range's first row and the element mask does the rest.
//
// What bounds it on the H100: 4, 8 and 6 operations per live (query, key)
// pair and head-dim element (forward, dK/dV, dQ) against 2(Tq+Tk)HD,
// (2Tq+4Tk)HD and (3Tq+2Tk)HD elements moved. At the packed batches of the
// main path (T 3,313-8,192, D 128, ~10^6 live pairs a head) that is bound by
// operations. Like the dense kernels, this first version runs its products
// on the CUDA cores in f32 (67 TFLOP/s peak), not on the tensor cores
// (wgmma/TMA is later work), and keeps device-memory traffic at the flash
// minimum: the block's own tile is read once, the other side's tiles once
// per block, and no score matrix leaves the block.
//
// Layout: one block of 256 threads per (64-row tile, head), as a 16 x 16
// grid; thread (ty, tx) owns score rows ty*4..ty*4+3 and columns tx + 16*j,
// j < 4, and, for the accumulations, four rows of the block's own tile and
// columns tx + 16*jj, jj < D/16. Rows of a head are H*D elements apart in
// the packed tensors; shared rows are padded to D+1 (and 65) floats so the
// column reads of a half-warp hit different banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int PP = BK + 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded through T and back: `.astype(v.dtype)` of the Pallas kernels
template <typename T> __device__ __forceinline__ float round_t(float x) {
  return to_f(from_f<T>(x));
}

// rows [r0, r0 + 64) of head h of a packed [T, H, D] tensor into shared
// [64][D+1], zero at and past row `end`
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0,
                                          int end, int H, int h) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, c = i % D, g = r0 + r;
    dst[r * DP + c] =
        g < end ? to_f(src[((long long)g * H + h) * D + c]) : 0.f;
  }
}

// seg/off of rows [r0, r0 + 64) into shared, `pad` past row `end`
__device__ __forceinline__ void load_meta(int* s_seg, int* s_off,
                                          const int* seg, const int* off,
                                          int r0, int end, int pad) {
  for (int r = threadIdx.x; r < 64; r += NT) {
    const int g = r0 + r;
    s_seg[r] = g < end ? seg[g] : pad;
    s_off[r] = g < end ? off[g] : 0;
  }
}

// f32 row values (lse, delta) of rows [r0, r0 + 64) of head h, [H, T]
__device__ __forceinline__ void load_row_stats(float* sL, float* sDl,
                                               const float* lse,
                                               const float* delta, int r0,
                                               int end, int T, int h) {
  for (int r = threadIdx.x; r < 64; r += NT) {
    const int g = r0 + r;
    sL[r] = g < end ? lse[(long long)h * T + g] : -INFINITY;
    sDl[r] = g < end ? delta[(long long)h * T + g] : 0.f;
  }
}

// the segment mask of one (query row, key column) of the two tiles;
// q_rows / k_rows are the tiles' rows inside the live range
__device__ __forceinline__ bool live(const int* sSq, const int* sOq,
                                     const int* sSk, const int* sOk, int row,
                                     int col, int q_rows, int k_rows) {
  return row < q_rows && col < k_rows && sSq[row] == sSk[col] &&
         sOk[col] <= sOq[row];
}

// s[i][j] = sum_d A[ty*4+i][d] * B[tx+16j][d], both [64][D+1] in shared
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* A,
                                         const float* Bm, int ty, int tx) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * DP + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bm[(tx + 16 * j) * DP + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// P and dS of one tile (`_bwd_p_ds`, guarded form), rounded to T into
// shared [64][65] tiles (sP may be null)
template <typename T>
__device__ __forceinline__ void p_ds(const float (&s)[4][4],
                                     const float (&dp)[4][4], float* sP,
                                     float* sdS, const float* sL,
                                     const float* sDl, const int* sSq,
                                     const int* sOq, const int* sSk,
                                     const int* sOk, int q_rows, int k_rows,
                                     float scale, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i;
    const float lse = sL[row];
    const float delta = sDl[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      const bool ok = live(sSq, sOq, sSk, sOk, row, col, q_rows, k_rows);
      const float p =
          (ok && lse != -INFINITY) ? expf(s[i][j] * scale - lse) : 0.f;
      const float ds = p * (dp[i][j] - delta);
      if (sP != nullptr) sP[row * PP + col] = round_t<T>(p);
      sdS[row * PP + col] = round_t<T>(ds);
    }
  }
}

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * ((size_t)3 * 64 * (D + 1) + (size_t)64 * PP) +
         sizeof(int) * 4 * 64;
}

template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) *
             ((size_t)4 * 64 * (D + 1) + (size_t)2 * 64 * PP + 2 * 64) +
         sizeof(int) * 4 * 64;
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) *
             ((size_t)4 * 64 * (D + 1) + (size_t)64 * PP + 2 * 64) +
         sizeof(int) * 4 * 64;
}

// one block per (64-row query tile, head); the live key range of the tile
// is q_tiles[tile] = [k_lo, k_hi)
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_varlen_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ seg_q,
    const int* __restrict__ off_q, const int* __restrict__ seg_k,
    const int* __restrict__ off_k, const int* __restrict__ q_tiles,
    T* __restrict__ o, float* __restrict__ lse, int Tq, int H, float scale) {
  constexpr int DP = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;             // [BQ][DP]
  float* sK = sQ + BQ * DP;     // [BK][DP]
  float* sV = sK + BK * DP;     // [BK][DP]
  float* sP = sV + BK * DP;     // [BQ][PP]
  int* sSq = reinterpret_cast<int*>(sP + BQ * PP);  // [BQ]
  int* sOq = sSq + BQ;          // [BQ]
  int* sSk = sOq + BQ;          // [BK]
  int* sOk = sSk + BK;          // [BK]

  const int h = blockIdx.y;
  const int tile = blockIdx.x;
  const int q0 = tile * BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k_lo = q_tiles[2 * tile], k_hi = q_tiles[2 * tile + 1];
  const int q_rows = min(BQ, Tq - q0);

  load_rows<T, D>(sQ, q, q0, Tq, H, h);
  load_meta(sSq, sOq, seg_q, off_q, q0, Tq, -1);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  }

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's K/V readers are done
    load_rows<T, D>(sK, k, k0, k_hi, H, h);
    load_rows<T, D>(sV, v, k0, k_hi, H, h);
    load_meta(sSk, sOk, seg_k, off_k, k0, k_hi, -2);
    __syncthreads();
    const int k_rows = k_hi - k0;

    float s[4][4];
    tile_dot<D>(s, sQ, sK, ty, tx);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok =
            live(sSq, sOq, sSk, sOk, row, tx + 16 * j, q_rows, k_rows);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float safe = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - safe);
        rs += p;
        sP[row * PP + tx + 16 * j] = round_t<T>(p);
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, w);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncwarp();  // sP rows of this half-warp are written by this warp

    for (int kk = 0; kk < BK; ++kk) {
      float vv[DJ];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) vv[jj] = sV[kk * DP + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sP[(ty * 4 + i) * PP + kk];
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj)
          acc[i][jj] = fmaf(p, vv[jj], acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i;
    if (row >= q_rows) continue;
    const long long gr = q0 + row;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      o[(gr * H + h) * D + tx + 16 * jj] = from_f<T>(acc[i][jj] / safe_l);
    if (tx == 0)
      lse[(long long)h * Tq + gr] =
          l[i] == 0.f ? -INFINITY : m[i] + logf(safe_l);
  }
}

// one block per (64-key tile, head); the live query range of the tile is
// k_tiles[tile] = [q_lo, q_hi), walked as the inner loop
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_varlen_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg_q, const int* __restrict__ off_q,
    const int* __restrict__ seg_k, const int* __restrict__ off_k,
    const int* __restrict__ k_tiles, T* __restrict__ dk, T* __restrict__ dv,
    int Tq, int Tk, int H, float scale) {
  constexpr int DP = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;             // [BK][DP]
  float* sV = sK + BK * DP;     // [BK][DP]
  float* sQ = sV + BK * DP;     // [BQ][DP]
  float* sdO = sQ + BQ * DP;    // [BQ][DP]
  float* sP = sdO + BQ * DP;    // [BQ][PP]
  float* sdS = sP + BQ * PP;    // [BQ][PP]
  float* sL = sdS + BQ * PP;    // [BQ]
  float* sDl = sL + BQ;         // [BQ]
  int* sSq = reinterpret_cast<int*>(sDl + BQ);  // [BQ]
  int* sOq = sSq + BQ;
  int* sSk = sOq + BQ;          // [BK]
  int* sOk = sSk + BK;

  const int h = blockIdx.y;
  const int tile = blockIdx.x;
  const int k0 = tile * BK;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q_lo = k_tiles[2 * tile], q_hi = k_tiles[2 * tile + 1];
  const int k_rows = min(BK, Tk - k0);

  load_rows<T, D>(sK, k, k0, Tk, H, h);
  load_rows<T, D>(sV, v, k0, Tk, H, h);
  load_meta(sSk, sOk, seg_k, off_k, k0, Tk, -2);

  float dka[4][DJ], dva[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dka[i][jj] = dva[i][jj] = 0.f;

  for (int q0 = q_lo; q0 < q_hi; q0 += BQ) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, D>(sQ, q, q0, q_hi, H, h);
    load_rows<T, D>(sdO, dout, q0, q_hi, H, h);
    load_row_stats(sL, sDl, lse, delta, q0, q_hi, Tq, h);
    load_meta(sSq, sOq, seg_q, off_q, q0, q_hi, -1);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<D>(s, sQ, sK, ty, tx);
    tile_dot<D>(dp, sdO, sV, ty, tx);
    p_ds<T>(s, dp, sP, sdS, sL, sDl, sSq, sOq, sSk, sOk, q_hi - q0, k_rows,
            scale, ty, tx);
    __syncthreads();  // P and dS columns are read by every thread

    // dV[kr] += sum_r P[r][kr] dO[r];  dK[kr] += sum_r dS[r][kr] Q[r]
    for (int r = 0; r < BQ; ++r) {
      float pk[4], dsk[4], dov[DJ], qv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pk[i] = sP[r * PP + ty * 4 + i];
        dsk[i] = sdS[r * PP + ty * 4 + i];
      }
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        dov[jj] = sdO[r * DP + tx + 16 * jj];
        qv[jj] = sQ[r * DP + tx + 16 * jj];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          dva[i][jj] = fmaf(pk[i], dov[jj], dva[i][jj]);
          dka[i][jj] = fmaf(dsk[i], qv[jj], dka[i][jj]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i;
    if (row >= k_rows) continue;
    const long long gk = k0 + row;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const long long at = (gk * H + h) * D + tx + 16 * jj;
      dk[at] = from_f<T>(dka[i][jj] * scale);
      dv[at] = from_f<T>(dva[i][jj]);
    }
  }
}

// one block per (64-row query tile, head); the live key range
// q_tiles[tile] = [k_lo, k_hi) is the inner loop
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_varlen_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg_q, const int* __restrict__ off_q,
    const int* __restrict__ seg_k, const int* __restrict__ off_k,
    const int* __restrict__ q_tiles, T* __restrict__ dq, int Tq, int H,
    float scale) {
  constexpr int DP = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;             // [BQ][DP]
  float* sdO = sQ + BQ * DP;    // [BQ][DP]
  float* sK = sdO + BQ * DP;    // [BK][DP]
  float* sV = sK + BK * DP;     // [BK][DP]
  float* sdS = sV + BK * DP;    // [BQ][PP]
  float* sL = sdS + BQ * PP;    // [BQ]
  float* sDl = sL + BQ;         // [BQ]
  int* sSq = reinterpret_cast<int*>(sDl + BQ);  // [BQ]
  int* sOq = sSq + BQ;
  int* sSk = sOq + BQ;          // [BK]
  int* sOk = sSk + BK;

  const int h = blockIdx.y;
  const int tile = blockIdx.x;
  const int q0 = tile * BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k_lo = q_tiles[2 * tile], k_hi = q_tiles[2 * tile + 1];
  const int q_rows = min(BQ, Tq - q0);

  load_rows<T, D>(sQ, q, q0, Tq, H, h);
  load_rows<T, D>(sdO, dout, q0, Tq, H, h);
  load_row_stats(sL, sDl, lse, delta, q0, Tq, Tq, h);
  load_meta(sSq, sOq, seg_q, off_q, q0, Tq, -1);

  float dqa[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dqa[i][jj] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's K readers are done
    load_rows<T, D>(sK, k, k0, k_hi, H, h);
    load_rows<T, D>(sV, v, k0, k_hi, H, h);
    load_meta(sSk, sOk, seg_k, off_k, k0, k_hi, -2);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<D>(s, sQ, sK, ty, tx);
    tile_dot<D>(dp, sdO, sV, ty, tx);
    p_ds<T>(s, dp, nullptr, sdS, sL, sDl, sSq, sOq, sSk, sOk, q_rows,
            k_hi - k0, scale, ty, tx);
    __syncwarp();  // the half-warp reads back only the dS rows it wrote

    for (int c = 0; c < BK; ++c) {
      float dsr[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsr[i] = sdS[(ty * 4 + i) * PP + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) kv[jj] = sK[c * DP + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj)
          dqa[i][jj] = fmaf(dsr[i], kv[jj], dqa[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i;
    if (row >= q_rows) continue;
    const long long gr = q0 + row;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      dq[(gr * H + h) * D + tx + 16 * jj] = from_f<T>(dqa[i][jj] * scale);
  }
}

enum Which { FWD = 0, DKV = 1, DQ = 2 };

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  const void *seg_q, *off_q, *seg_k, *off_k, *tiles;
  void *o0, *o1;
  int Tq, Tk, H;
  float scale;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D>
cudaError_t launch(Which which, const Args& a) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  const int* sq = static_cast<const int*>(a.seg_q);
  const int* oq = static_cast<const int*>(a.off_q);
  const int* sk = static_cast<const int*>(a.seg_k);
  const int* ok = static_cast<const int*>(a.off_k);
  const int* tiles = static_cast<const int*>(a.tiles);
  cudaError_t err;
  if (which == FWD) {
    constexpr size_t smem = fwd_smem<D>();
    if ((err = prepare(flash_varlen_fwd_kernel<T, D>, smem)) != cudaSuccess)
      return err;
    dim3 grid((a.Tq + BQ - 1) / BQ, a.H);
    flash_varlen_fwd_kernel<T, D><<<grid, NT, smem, a.stream>>>(
        q, k, v, sq, oq, sk, ok, tiles, static_cast<T*>(a.o0),
        static_cast<float*>(a.o1), a.Tq, a.H, a.scale);
    return cudaGetLastError();
  }
  if (which == DKV) {
    constexpr size_t smem = dkv_smem<D>();
    if ((err = prepare(flash_varlen_dkv_kernel<T, D>, smem)) != cudaSuccess)
      return err;
    dim3 grid((a.Tk + BK - 1) / BK, a.H);
    flash_varlen_dkv_kernel<T, D><<<grid, NT, smem, a.stream>>>(
        q, k, v, dout, lse, delta, sq, oq, sk, ok, tiles,
        static_cast<T*>(a.o0), static_cast<T*>(a.o1), a.Tq, a.Tk, a.H,
        a.scale);
    return cudaGetLastError();
  }
  constexpr size_t smem = dq_smem<D>();
  if ((err = prepare(flash_varlen_dq_kernel<T, D>, smem)) != cudaSuccess)
    return err;
  dim3 grid((a.Tq + BQ - 1) / BQ, a.H);
  flash_varlen_dq_kernel<T, D><<<grid, NT, smem, a.stream>>>(
      q, k, v, dout, lse, delta, sq, oq, sk, ok, tiles,
      static_cast<T*>(a.o0), a.Tq, a.H, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(Which which, int D, const Args& a) {
  switch (D) {
    case 16: return launch<T, 16>(which, a);
    case 64: return launch<T, 64>(which, a);
    case 128: return launch<T, 128>(which, a);
    default: return cudaErrorInvalidValue;
  }
}

int run(Which which, int D, int dtype, const Args& a) {
  if (dtype == 0) return dispatch_d<float>(which, D, a);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(which, D, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/dout/o/dq [Tq, H, D], k/v/dk/dv
// [Tk, H, D] in dtype; lse, delta [H, Tq] f32; seg_*/off_* int32 [T];
// q_tiles int32 [ceil(Tq/64), 2] (live key range of each query tile),
// k_tiles int32 [ceil(Tk/64), 2] (live query range of each key tile); all
// contiguous on the current device.

extern "C" int flash_varlen_fwd(const void* q, const void* k, const void* v,
                                const void* seg_q, const void* off_q,
                                const void* seg_k, const void* off_k,
                                const void* q_tiles, void* o, void* lse,
                                int Tq, int Tk, int H, int D, int dtype,
                                float scale, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, seg_q, off_q, seg_k, off_k,
         q_tiles, o, lse, Tq, Tk, H, scale,
         static_cast<cudaStream_t>(stream)};
  return run(FWD, D, dtype, a);
}

extern "C" int flash_varlen_bwd_dkv(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    const void* seg_q, const void* off_q,
                                    const void* seg_k, const void* off_k,
                                    const void* k_tiles, void* dk, void* dv,
                                    int Tq, int Tk, int H, int D, int dtype,
                                    float scale, void* stream) {
  Args a{q, k, v, dout, lse, delta, seg_q, off_q, seg_k, off_k, k_tiles,
         dk, dv, Tq, Tk, H, scale, static_cast<cudaStream_t>(stream)};
  return run(DKV, D, dtype, a);
}

extern "C" int flash_varlen_bwd_dq(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   const void* seg_q, const void* off_q,
                                   const void* seg_k, const void* off_k,
                                   const void* q_tiles, void* dq, int Tq,
                                   int Tk, int H, int D, int dtype,
                                   float scale, void* stream) {
  Args a{q, k, v, dout, lse, delta, seg_q, off_q, seg_k, off_k, q_tiles,
         dq, nullptr, Tq, Tk, H, scale, static_cast<cudaStream_t>(stream)};
  return run(DQ, D, dtype, a);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
