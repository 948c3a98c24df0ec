// The arithmetic the int8 weight-only kernels share (wo_matmul.cu's decode
// and TF32 prefill kernels, wo_matmul_wgmma.cu's bf16 prefill): the exact
// widening of int8 weights and the epilogue's rounding order.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace wo {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
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

// The column's scale after the f32 sum, then the bias in f32, then the
// one cast: the rounding order of the Pallas kernel's epilogue and its
// wrapper's bias add (pallas_matmul.py:171, :229-237).
template <typename T>
__device__ __forceinline__ T epilogue(float acc, float s, float qmax,
                                      const T* __restrict__ bias, int n) {
  float v = __fmul_rn(acc, __fdiv_rn(s, qmax));
  if (bias != nullptr) v = __fadd_rn(v, to_f(bias[n]));
  return from_f<T>(v);
}

// Four int8 values in one 32-bit word to four exact floats, without the
// int-to-float unit: flip each sign bit (the byte becomes b + 128), place
// the byte in the low mantissa bits of 2^23 and subtract 2^23 + 128.
__device__ __forceinline__ void i8x4_to_f32(uint32_t word, float* f) {
  const uint32_t u = word ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

}  // namespace wo
