// FlashAttention-2 backward for Hopper (sm_90a), on the CUDA cores.
// The split pair serves bf16 and f16 only (reached by route="split";
// their default route is flash_bwd_wgmma.cu's fused kernel), f32's split
// pair being the tensor-core kernels of flash_bwd_tf32x3.cu; the fused
// kernel serves f32 only, bf16 and f16 going to flash_bwd_wgmma.cu. Each
// entry refuses the dtype it does not serve (cudaErrorInvalidValue), so
// each dtype and route has exactly one kernel.
//
// Replaces three kernels of paddle2_tpu/kernels/pallas_flash.py, driven by
// `_flash_bwd`:
//   flash_bwd_dkv_kernel   <- `_bwd_dkv_kernel`  (split route, 1 of 2)
//   flash_bwd_dq_kernel    <- `_bwd_dq_kernel`   (split route, 2 of 2)
//   flash_bwd_fused_kernel <- `_bwd_fused_1blk_kernel` (fused route)
//
// On (B, H, S, D) tensors with the saved row log-sum-exp `lse` and
// delta = rowsum(dO*O) (both f32, computed outside), per score tile:
//   P  = exp(Q K^T * scale - lse)      (0 where masked or lse == -inf)
//   dP = dO V^T,  dS = P * (dP - delta)
//   dV += P^T dO,  dK += dS^T Q * scale,  dQ += dS K * scale
// with the causal mask aligned to the bottom right (row r sees keys
// c <= r + Sk - Sq). As in the Pallas kernels, P and dS are rounded to the
// input dtype before they enter a product, and every sum is f32; s * scale
// is rounded once (__fmul_rn) before lse is subtracted, as the plain
// version rounds it.
//
// The split route is the TPU's: dK/dV with the query tiles innermost, dQ
// with the key tiles innermost, so no block writes what another block
// writes. The fused route does the five products of a tile once (the
// split pair does seven, recomputing Q K^T and dO V^T for dQ): each block
// owns a key tile, keeps dK and dV in registers over the query tiles, and
// adds its share of dQ into an f32 buffer with atomicAdd. The TPU ran that
// route only when one 1024-tile held the whole row (its grid is
// sequential, so a cross-tile dQ sum had no home); on the H100 atomics give
// it a home at any length. The atomics' order changes from run to run, so
// the fused route's dQ is not bitwise deterministic.
//
// What bounds it on the H100: 10*Sq*Sk*D*H*B operations (fused; halved
// when causal) against (4Sq+4Sk)*H*D*B elements moved, so operations, not
// bytes. Like the forward, this first kernel runs its products on the
// CUDA cores in f32 (67 TFLOP/s peak), not on the tensor cores; the layout
// keeps device-memory traffic at the flash minimum: the block's own tile
// (K/V, or Q/dO) is read once, the other side's tiles once per block, and
// no S x S matrix leaves the block. Tiles wholly above the causal diagonal
// are never loaded.
//
// Layout: 256 threads as a 16 x 16 grid, 64 x 64 score tiles. For the
// score products thread (ty, tx) owns rows ty*4..ty*4+3 and columns
// tx + 16*j, j < 4. For the accumulations it owns four
// rows of the block's own tile and columns tx + 16*jj, jj < D/16, of the
// head dimension. Shared rows are padded to D+1 (and 65) floats so the
// column reads of a half-warp hit different banks.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int PP = BK + 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}
// x rounded through T and back: `.astype(q.dtype)` of the Pallas kernels
template <typename T> __device__ __forceinline__ float round_t(float x) {
  return to_f(from_f<T>(x));
}

// rows [r0, r0 + 64) of a (S, D) slab into shared [64][D+1], zero past S
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int S) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, c = i % D, g = r0 + r;
    dst[r * DP + c] = g < S ? to_f(src[(long long)g * D + c]) : 0.f;
  }
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

// P and dS of one tile from the score and dO V^T sums (`_bwd_p_ds`,
// guarded form), rounded to T into shared [64][65] tiles
template <typename T>
__device__ __forceinline__ void p_ds(const float (&s)[4][4],
                                     const float (&dp)[4][4], float* sP,
                                     float* sdS, const float* sL,
                                     const float* sDl, int q0, int k0,
                                     int Sq, int Sk, int offset, float scale,
                                     int causal, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i;
    const int gr = q0 + row;
    const float lse = sL[row];
    const float delta = sDl[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      const int gc = k0 + col;
      const bool valid = gr < Sq && gc < Sk && (!causal || gc <= gr + offset);
      const float p = (valid && lse != -INFINITY)
                          ? expf(__fmul_rn(s[i][j], scale) - lse) : 0.f;
      const float ds = p * (dp[i][j] - delta);
      if (sP != nullptr) sP[row * PP + col] = round_t<T>(p);
      sdS[row * PP + col] = round_t<T>(ds);
    }
  }
}

template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) *
         ((size_t)4 * 64 * (D + 1) + (size_t)2 * 64 * PP + 2 * 64);
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * ((size_t)4 * 64 * (D + 1) + (size_t)64 * PP + 2 * 64);
}

// one block per (64-key tile, b*H + h); the query tiles are the inner loop
template <typename T, int D, bool FUSED>
__device__ __forceinline__ void dkv_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq32,
    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, float scale,
    int causal) {
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

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long qb = (long long)bh * Sq * D;
  const long long kb = (long long)bh * Sk * D;
  const int offset = Sk - Sq;

  load_tile<T, D>(sK, k + kb, k0, Sk);
  load_tile<T, D>(sV, v + kb, k0, Sk);

  float dka[4][DJ], dva[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dka[i][jj] = dva[i][jj] = 0.f;

  for (int q0 = 0; q0 < Sq; q0 += BQ) {
    // the tile's last row q0+63 sees keys up to q0+63+offset
    if (causal && q0 + BQ - 1 + offset < k0) continue;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(sQ, q + qb, q0, Sq);
    load_tile<T, D>(sdO, dout + qb, q0, Sq);
    for (int r = tid; r < BQ; r += NT) {
      const int g = q0 + r;
      sL[r] = g < Sq ? lse[(long long)bh * Sq + g] : -INFINITY;
      sDl[r] = g < Sq ? delta[(long long)bh * Sq + g] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<D>(s, sQ, sK, ty, tx);
    tile_dot<D>(dp, sdO, sV, ty, tx);
    p_ds<T>(s, dp, sP, sdS, sL, sDl, q0, k0, Sq, Sk, offset, scale, causal,
            ty, tx);
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

    if (FUSED) {
      // this key tile's share of dQ[qr] = sum_c dS[qr][c] K[c] * scale
      float dqa[4][DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) dqa[i][jj] = 0.f;
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
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gr = q0 + ty * 4 + i;
        if (gr >= Sq) continue;
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj)
          atomicAdd(dq32 + qb + (long long)gr * D + tx + 16 * jj,
                    dqa[i][jj] * scale);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gk = k0 + ty * 4 + i;
    if (gk >= Sk) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const long long at = kb + (long long)gk * D + tx + 16 * jj;
      dk[at] = from_f<T>(dka[i][jj] * scale);
      dv[at] = from_f<T>(dva[i][jj]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_bwd_dkv_kernel(const T* q, const T* k, const T* v, const T* dout,
                         const float* lse, const float* delta, T* dk, T* dv,
                         int Sq, int Sk, float scale, int causal) {
  dkv_body<T, D, false>(q, k, v, dout, lse, delta, nullptr, dk, dv, Sq, Sk,
                        scale, causal);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_bwd_fused_kernel(const T* q, const T* k, const T* v, const T* dout,
                           const float* lse, const float* delta, float* dq32,
                           T* dk, T* dv, int Sq, int Sk, float scale,
                           int causal) {
  dkv_body<T, D, true>(q, k, v, dout, lse, delta, dq32, dk, dv, Sq, Sk,
                       scale, causal);
}

// one block per (64-row query tile, b*H + h); the key tiles are the inner
// loop
template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int Sq, int Sk, float scale, int causal) {
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

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long qb = (long long)bh * Sq * D;
  const long long kb = (long long)bh * Sk * D;
  const int offset = Sk - Sq;

  load_tile<T, D>(sQ, q + qb, q0, Sq);
  load_tile<T, D>(sdO, dout + qb, q0, Sq);
  for (int r = tid; r < BQ; r += NT) {
    const int g = q0 + r;
    sL[r] = g < Sq ? lse[(long long)bh * Sq + g] : -INFINITY;
    sDl[r] = g < Sq ? delta[(long long)bh * Sq + g] : 0.f;
  }

  float dqa[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dqa[i][jj] = 0.f;

  const int k_end = causal ? min(Sk, q0 + BQ + offset) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's K readers are done
    load_tile<T, D>(sK, k + kb, k0, Sk);
    load_tile<T, D>(sV, v + kb, k0, Sk);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<D>(s, sQ, sK, ty, tx);
    tile_dot<D>(dp, sdO, sV, ty, tx);
    p_ds<T>(s, dp, nullptr, sdS, sL, sDl, q0, k0, Sq, Sk, offset, scale,
            causal, ty, tx);
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
    const int gr = q0 + ty * 4 + i;
    if (gr >= Sq) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      dq[qb + (long long)gr * D + tx + 16 * jj] =
          from_f<T>(dqa[i][jj] * scale);
  }
}

enum Which { DKV = 0, DQ = 1, FUSED = 2 };

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *o0, *o1, *o2;
  int B, H, Sq, Sk;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch(Which which, const Args& a) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value) {
    // f32: the split pair is flash_bwd_tf32x3's
    if (which != FUSED) return cudaErrorInvalidValue;
    constexpr size_t smem = dkv_smem<D>();
    err = cudaFuncSetAttribute(flash_bwd_fused_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.Sk + BK - 1) / BK, a.B * a.H);
    flash_bwd_fused_kernel<T, D><<<grid, NT, smem, a.stream>>>(
        q, k, v, dout, lse, delta, static_cast<float*>(a.o0),
        static_cast<T*>(a.o1), static_cast<T*>(a.o2), a.Sq, a.Sk, a.scale,
        a.causal);
    return cudaGetLastError();
  } else {
    // bf16 and f16: the fused route is flash_bwd_fused_wgmma's
    if (which == FUSED) return cudaErrorInvalidValue;
    if (which == DQ) {
      constexpr size_t smem = dq_smem<D>();
      err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return err;
      dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.H);
      flash_bwd_dq_kernel<T, D><<<grid, NT, smem, a.stream>>>(
          q, k, v, dout, lse, delta, static_cast<T*>(a.o0), a.Sq, a.Sk,
          a.scale, a.causal);
      return cudaGetLastError();
    }
    constexpr size_t smem = dkv_smem<D>();
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.Sk + BK - 1) / BK, a.B * a.H);
    flash_bwd_dkv_kernel<T, D><<<grid, NT, smem, a.stream>>>(
        q, k, v, dout, lse, delta, static_cast<T*>(a.o0),
        static_cast<T*>(a.o1), a.Sq, a.Sk, a.scale, a.causal);
    return cudaGetLastError();
  }
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
  if (dtype == 2) return dispatch_d<__half>(which, D, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. q/dout [B,H,Sq,D], k/v
// [B,H,Sk,D] in dtype; lse and delta [B,H,Sq] f32; all contiguous on the
// current device.

// split route, kernel 1, bf16 and f16 (f32 is flash_bwd_dkv_tf32x3's): dk, dv
// [B,H,Sk,D] in dtype
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int B,
                             int H, int Sq, int Sk, int D, int dtype,
                             float scale, int causal, void* stream) {
  Args a{q, k, v, dout, lse, delta, dk, dv, nullptr, B, H, Sq, Sk,
         scale, causal, static_cast<cudaStream_t>(stream)};
  return run(DKV, D, dtype, a);
}

// split route, kernel 2, bf16 and f16 (f32 is flash_bwd_dq_tf32x3's): dq
// [B,H,Sq,D] in dtype
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int B, int H,
                            int Sq, int Sk, int D, int dtype, float scale,
                            int causal, void* stream) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, H, Sq, Sk,
         scale, causal, static_cast<cudaStream_t>(stream)};
  return run(DQ, D, dtype, a);
}

// fused route, f32 only (bf16 and f16 are flash_bwd_fused_wgmma's): dq32
// [B,H,Sq,D] f32, zeroed by the caller, accumulated with atomics; dk, dv
// [B,H,Sk,D]
extern "C" int flash_bwd_fused(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq32, void* dk,
                               void* dv, int B, int H, int Sq, int Sk, int D,
                               int dtype, float scale, int causal,
                               void* stream) {
  Args a{q, k, v, dout, lse, delta, dq32, dk, dv, B, H, Sq, Sk,
         scale, causal, static_cast<cudaStream_t>(stream)};
  return run(FUSED, D, dtype, a);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
