// FlashAttention-2 forward for Hopper (sm_90a), on the CUDA cores.
//
// Replaces: paddle2_tpu/kernels/pallas_flash.py `_fwd_kernel` (tiled
// online softmax) and `_fwd_kernel_1blk` (whole row in one tile), both
// driven by `_flash_fwd`. One kernel covers both: a row that fits one
// key tile is the one-tile case of the same loop.
//
// Computes, per (batch, head), o = softmax(q k^T * scale) v and the row
// log-sum-exp, on (B, H, S, D) tensors, with the causal mask aligned to
// the bottom right (row r sees keys c <= r + Sk - Sq). Scores, the
// running max m, the running sum l and the output accumulator are f32;
// o is written in the input dtype, lse in f32. As in the Pallas kernel,
// the probabilities are rounded to the input dtype before the p.V
// product and the sum l is taken over the unrounded probabilities.
//
// What bounds it on the H100: at the prefill shapes (S up to 2048,
// D 128, 16 heads) the work is 4*Sq*Sk*D*H operations (halved when
// causal) against 2*(Sq+Sk)*H*D elements moved, so it is bound by
// operations, not bytes. This first kernel runs its two products on the
// CUDA cores in f32 (67 TFLOP/s peak), not on the tensor cores
// (989 TFLOP/s in bf16): a wgmma/TMA pipeline is later work. The design
// keeps the device-memory traffic at the flash minimum, which is what
// the TPU kernel's VMEM scratch did: Q stays in shared memory for the
// whole row of key tiles, K/V tiles are read once per query tile, and
// the S x S score matrix never leaves the block. Tiles wholly above
// the causal diagonal are never loaded.
//
// Layout: one block of 256 threads per (64-row query tile, b*H + h).
// Thread (ty, tx) in a 16 x 16 grid owns score rows ty*4 .. ty*4+3 and
// key columns tx + 16*j, j < 4, of each 64-key tile, and output columns
// tx + 16*jj, jj < D/16, of the same four rows. The 16 threads sharing a
// row are one half-warp, so row max and row sum reduce with shuffles,
// and the probability tile they write to shared memory is read back by
// the same warp (a warp barrier, not a block barrier). Shared rows of Q
// and K are padded to D+1 floats so the per-column reads of a half-warp
// hit 16 different banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

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
// x rounded through T and back: p.astype(v.dtype) of the Pallas kernel
template <typename T> __device__ __forceinline__ float round_t(float x) {
  return to_f(from_f<T>(x));
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, float scale,
                     int causal) {
  constexpr int DP = D + 1;
  constexpr int DJ = D / 16;
  constexpr int PP = BK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;           // [BQ][DP]
  float* sK = sQ + BQ * DP;   // [BK][DP]
  float* sV = sK + BK * DP;   // [BK][D]
  float* sP = sV + BK * D;    // [BQ][PP]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long qbase = (long long)bh * Sq * D;
  const long long kbase = (long long)bh * Sk * D;
  const int offset = Sk - Sq;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D, gr = q0 + r;
    sQ[r * DP + c] = gr < Sq ? to_f(q[qbase + (long long)gr * D + c]) : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  }

  // the tile's last row q0+BQ-1 sees keys up to q0+BQ-1+offset
  const int k_end = causal ? min(Sk, q0 + BQ + offset) : Sk;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's K/V readers are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D, gk = k0 + r;
      const bool ok = gk < Sk;
      const long long at = kbase + (long long)gk * D + c;
      sK[r * DP + c] = ok ? to_f(k[at]) : 0.f;
      sV[r * D + c] = ok ? to_f(v[at]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      const int gr = q0 + row;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gc = k0 + tx + 16 * j;
        const bool valid = gc < Sk && (!causal || gc <= gr + offset);
        s[i][j] = valid ? s[i][j] * scale : -INFINITY;
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
      for (int jj = 0; jj < DJ; ++jj) vv[jj] = sV[kk * D + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sP[(ty * 4 + i) * PP + kk];
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = fmaf(p, vv[jj], acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = q0 + ty * 4 + i;
    if (gr >= Sq) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      o[qbase + (long long)gr * D + tx + 16 * jj] =
          from_f<T>(acc[i][jj] / safe_l);
    if (tx == 0)
      lse[(long long)bh * Sq + gr] =
          l[i] == 0.f ? -INFINITY : m[i] + logf(safe_l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int Sq, int Sk, float scale,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      Sq, Sk, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int Sq, int Sk, int D,
                       float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, B, H, Sq, Sk, scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, H, Sq, Sk, scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, H, Sq, Sk, scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q [B,H,Sq,D], k/v [B,H,Sk,D], o like
// q, lse [B,H,Sq] f32, all contiguous on the current device.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int H, int Sq, int Sk, int D,
                         int dtype, float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, lse, B, H, Sq, Sk, D, scale, causal, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, lse, B, H, Sq, Sk, D, scale,
                                     causal, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
