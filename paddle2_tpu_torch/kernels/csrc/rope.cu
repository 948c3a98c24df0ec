// Fused rotary position embedding (half-split convention) for Hopper
// (sm_90a).
//
// Replaces: paddle2_tpu/kernels/pallas_fused.py `_rope_kernel` (through
// `fused_rope` and its custom_vjp), reached from
// `incubate.nn.functional.fused_rotary_position_embedding` with
// use_neox_rotary_style=False. On x [B, S, H, D] with angle tables cos and
// sin of T rows of D:
//   rot(x) = cat(-x[D/2:], x[:D/2])
//   o = x * cos + rot(x) * sin       f32, rounded once to x's type
// with the (b, s) row reading table row (b*S + s) mod T: T = S for an
// [S, D] table, T = B*S for one gathered by position_ids. One row of angles
// serves the row's H heads. The TPU wrapper tiles an [S, D] table B times
// before its call; that copy is staging, and the modulus replaces it.
// The backward is the same kernel with -sin (`negate_sin`), as the TPU
// kernel's custom_vjp has it: negating sin is exact, so it equals a call
// on a negated table bitwise.
//
// Every operation is written with its round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn), which nvcc never contracts into a fused
// multiply-add: the result equals the plain version, one torch op per
// operation, bitwise.
//
// What bounds it on the H100: bytes. 2*B*S*H*D*size bytes of x and o, plus
// the table rows read once each, against 3 f32 operations an element. One
// block walks (b, s) rows; its threads take the row's H*D/2 element pairs
// (d, d + D/2), neighbouring threads on neighbouring d, so each load of x
// is coalesced and each table element is read from device memory once a
// row and from the cache by the row's other heads.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;

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

template <typename XT, typename CT, bool NEG>
__global__ void __launch_bounds__(NT)
    rope_kernel(const XT* __restrict__ x, const CT* __restrict__ cs,
                const CT* __restrict__ sn, XT* __restrict__ o,
                long long rows, int H, int D, long long T) {
  const int half = D / 2;
  const int pairs = H * half;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const long long base = row * (long long)H * D;
    const long long tb = (row % T) * D;
    for (int p = threadIdx.x; p < pairs; p += NT) {
      const int h = p / half;
      const int d = p - h * half;
      const long long i1 = base + (long long)h * D + d;
      const float x1 = to_f(x[i1]);
      const float x2 = to_f(x[i1 + half]);
      const float c1 = to_f(cs[tb + d]), c2 = to_f(cs[tb + d + half]);
      float s1 = to_f(sn[tb + d]), s2 = to_f(sn[tb + d + half]);
      if (NEG) {
        s1 = -s1;
        s2 = -s2;
      }
      // o[d] = x1*c1 + (-x2)*s1;  o[d + D/2] = x2*c2 + x1*s2
      o[i1] = from_f<XT>(__fadd_rn(__fmul_rn(x1, c1), __fmul_rn(-x2, s1)));
      o[i1 + half] =
          from_f<XT>(__fadd_rn(__fmul_rn(x2, c2), __fmul_rn(x1, s2)));
    }
  }
}

template <typename XT, typename CT>
int launch(const void* x, const void* cs, const void* sn, void* o,
           long long rows, int H, int D, long long T, int neg,
           cudaStream_t st) {
  // 8 resident blocks of 256 threads on each of the 132 SMs; more rows
  // loop
  const int grid = (int)(rows < 132 * 8 ? rows : 132 * 8);
  const XT* xp = static_cast<const XT*>(x);
  const CT* cp = static_cast<const CT*>(cs);
  const CT* sp = static_cast<const CT*>(sn);
  XT* op = static_cast<XT*>(o);
  if (neg)
    rope_kernel<XT, CT, true><<<grid, NT, 0, st>>>(xp, cp, sp, op, rows, H, D,
                                                   T);
  else
    rope_kernel<XT, CT, false><<<grid, NT, 0, st>>>(xp, cp, sp, op, rows, H,
                                                    D, T);
  return cudaGetLastError();
}

template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<T>{}) for the element type of a dtype code: 0 f32, 1 bf16, 2 f16
template <typename F>
int with_type(int code, F f) {
  switch (code) {
    case 0: return f(Tag<float>{});
    case 1: return f(Tag<__nv_bfloat16>{});
    case 2: return f(Tag<__half>{});
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x, o: [rows, H, D] contiguous of x_dtype (0 f32, 1 bf16, 2 f16), rows =
// B*S; cos, sin: [T, D] contiguous of c_dtype, T = S or B*S; D even.
// negate_sin = 1 rotates by -sin (the backward).
extern "C" int rope(const void* x, const void* cos_t, const void* sin_t,
                    void* o, long long rows, int H, int D, long long T,
                    int x_dtype, int c_dtype, int negate_sin, void* stream) {
  if (rows <= 0 || H <= 0 || D <= 0 || D % 2 || T <= 0 ||
      (long long)H * D / 2 > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_type(x_dtype, [&](auto xt) {
    return with_type(c_dtype, [&](auto ct) {
      return launch<typename decltype(xt)::type, typename decltype(ct)::type>(
          x, cos_t, sin_t, o, rows, H, D, T, negate_sin, st);
    });
  });
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
