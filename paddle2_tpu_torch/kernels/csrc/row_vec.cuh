// The row-in-registers design shared by the vector kernels of the two
// norms (rms_norm.cu `rms_norm_fwd_vec_kernel` and `rms_norm_bwd_vec_kernel`,
// layer_norm.cu `layer_norm_fwd_vec_kernel` and `layer_norm_bwd_vec_kernel`):
// a row of x is read as 16-byte vectors, held in registers while it is
// reduced, and written as 16-byte vectors. rope.cu `rope_vec_kernel`
// reads its angle tables with chunk_f.
//
// Mapping. A row of H elements of type T is NV = H / E vectors (E = 16 /
// sizeof(T)). It belongs to WPR warps (a power of two); its lanes are
// t = (warp % WPR) * 32 + lane, 0 <= t < T = 32 * WPR, and lane t holds
// vectors t, t + T, ..., t + (VPL - 1) * T, those below NV. vec_plan
// picks the fewest warps, at most VEC_WARPS, that keep a lane at a
// kernel's most vectors or fewer (the forwards MAX_VPL: one warp for NV
// <= 512, H <= 4096 in bf16, H <= 2048 in f32; the backwards, which hold
// x, the output gradient and their parameter sums, their own cap), then
// VPL, the power of two that covers the row. Neighbouring lanes read
// neighbouring vectors, so a warp instruction moves 512 bytes.
//
// A block is VEC_NT threads: RPB = VEC_WARPS / WPR rows at a time. Blocks
// are persistent (the occupancy that the compiled kernel reaches on every
// SM, G blocks) and walk the rows with a grid stride: the row slot s of
// block b takes rows b * RPB + s + i * G * RPB. The per-column parameters
// (w, gamma, beta) are staged once a block into shared memory in their
// own type and read from there for every row.
//
// Reductions. Warp shuffles (xor tree: every lane ends with the sum);
// where a row spans warps, each warp writes its sum to shared memory,
// the row's warps meet at a named barrier of their own (bar.sync 1 +
// slot, 32 * WPR threads) and every lane adds the WPR sums in warp
// order. The buffer alternates between two halves, one a reduction, so
// one barrier an exchange suffices: a warp can write a half again only
// after every warp of its row has passed the next barrier, that is after
// they all read the half. row_sum2 exchanges two sums at once through a
// buffer of its own, alternating the same way. The sums do not depend on
// timing.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rowvec {

constexpr int VEC_NT = 256;
constexpr int VEC_WARPS = VEC_NT / 32;
constexpr int MAX_VPL = 16;
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// element j of a 16-byte vector of T, in f32; and its store
template <typename T>
__device__ __forceinline__ float elem(const uint4& u, int j) {
  return to_f(reinterpret_cast<const T*>(&u)[j]);
}
template <typename T>
__device__ __forceinline__ void set_elem(uint4& u, int j, float v) {
  reinterpret_cast<T*>(&u)[j] = from_f<T>(v);
}

// The E = 16 / sizeof(XT) parameters of x's vector, in f32, from
// shared or global memory: E * sizeof(PT) is 8, 16 or 32 bytes, and p
// lies on a multiple of the smaller of that size and 16.
template <typename XT, typename PT>
__device__ __forceinline__ void chunk_f(const PT* p, float* f) {
  constexpr int E = 16 / sizeof(XT);
  constexpr int B = E * sizeof(PT);
  if constexpr (B == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int j = 0; j < E; ++j)
      f[j] = to_f(reinterpret_cast<const PT*>(&u)[j]);
  } else {
    constexpr int PE = 16 / sizeof(PT);
#pragma unroll
    for (int i = 0; i < B / 16; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
#pragma unroll
      for (int j = 0; j < PE; ++j) f[i * PE + j] = elem<PT>(u, j);
    }
  }
}

// Copy `bytes` (a multiple of 8) from 16-byte aligned global memory to
// 16-byte aligned shared memory, the block's threads together.
__device__ __forceinline__ void stage(const void* src, void* dst,
                                      int bytes) {
  const uint4* s = static_cast<const uint4*>(src);
  uint4* d = static_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x) d[i] = s[i];
  if (bytes % 16 && threadIdx.x == 0)
    reinterpret_cast<uint2*>(d + bytes / 16)[0] =
        reinterpret_cast<const uint2*>(s + bytes / 16)[0];
}

// The sum of v over the row's lanes, in every lane (see the note above).
// red: two halves of VEC_WARPS floats; par picks the half.
__device__ __forceinline__ float row_sum(float v, float (*red)[VEC_WARPS],
                                         int& par, int wpr) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (wpr == 1) return v;
  const int warp = threadIdx.x >> 5;
  const int first = warp - warp % wpr;
  float* half = red[par];
  par ^= 1;
  if ((threadIdx.x & 31) == 0) half[warp] = v;
  asm volatile("bar.sync %0, %1;" ::"r"(1 + warp / wpr), "r"(32 * wpr)
               : "memory");
  float s = 0.f;
  for (int i = 0; i < wpr; ++i) s += half[first + i];
  return s;
}

// The sums of a and of b over the row's lanes, in every lane, in one
// exchange (each the sum row_sum would give). red: two halves of
// 2 x VEC_WARPS floats, a warp's pair side by side; par picks the half.
__device__ __forceinline__ void row_sum2(float& a, float& b,
                                         float (*red)[2 * VEC_WARPS],
                                         int& par, int wpr) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (wpr == 1) return;
  const int warp = threadIdx.x >> 5;
  const int first = warp - warp % wpr;
  float* half = red[par];
  par ^= 1;
  if ((threadIdx.x & 31) == 0) {
    half[2 * warp] = a;
    half[2 * warp + 1] = b;
  }
  asm volatile("bar.sync %0, %1;" ::"r"(1 + warp / wpr), "r"(32 * wpr)
               : "memory");
  float sa = 0.f, sb = 0.f;
  for (int i = 0; i < wpr; ++i) {
    sa += half[2 * (first + i)];
    sb += half[2 * (first + i) + 1];
  }
  a = sa;
  b = sb;
}

// ----------------------------------------------------------- host side

// warps a row and vectors a lane for a row of nv 16-byte vectors, a lane
// holding at most max_vpl of them where VEC_WARPS warps allow it
inline void vec_plan(int nv, int* wpr, int* vpl, int max_vpl = MAX_VPL) {
  int w = 1;
  while (w * 32 * max_vpl < nv && w < VEC_WARPS) w *= 2;
  const int per = (nv + 32 * w - 1) / (32 * w);
  int p = 1;
  while (p < per) p *= 2;
  *wpr = w;
  *vpl = p;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// What one kernel has asked of each device: its SMs, the shared memory
// granted, and its occupancy at the last size asked. A zero-initialised
// static, one a kernel.
struct GridCache {
  int sms[MAX_DEVICES];
  bool granted[MAX_DEVICES];
  size_t occ_smem[MAX_DEVICES];
  int occ[MAX_DEVICES];
};

// The persistent grid: blocks of `kernel` that stay resident on every SM
// with `smem` bytes of dynamic shared memory, at most `want`. The SM
// count is asked once a device, the occupancy once a device and size.
// Above 48 KB the kernel is granted `widest` bytes first, once a device.
template <typename K>
cudaError_t persistent_blocks(K kernel, GridCache& c, size_t smem,
                              size_t widest, long long want, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (c.sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&c.sms[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  if (smem > 48 * 1024 && !c.granted[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)widest);
    if (err != cudaSuccess) return err;
    c.granted[dev] = true;
  }
  if (c.occ[dev] == 0 || c.occ_smem[dev] != smem) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, VEC_NT,
                                                        smem);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorInvalidConfiguration;
    c.occ[dev] = n;
    c.occ_smem[dev] = smem;
  }
  const long long cap = (long long)c.occ[dev] * c.sms[dev];
  *blocks = (int)(want < cap ? want : cap);
  return cudaSuccess;
}

}  // namespace rowvec
