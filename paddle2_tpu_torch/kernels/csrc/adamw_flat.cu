// One-pass flat AdamW with an f32 master copy for Hopper (sm_90a), in the
// Pallas kernel's op order.
//
// Replaces: paddle2_tpu/kernels/pallas_fused.py `_adamw_kernel`, driven by
// `fused_adamw` and reached from `incubate.nn.functional.
// fused_adamw_kernel`. One pass reads (g, m, v, master) and writes four new
// arrays (p', m', v', master'):
//   m'  = b1*m + (1-b1)*g
//   v'  = b2*v + ((1-b2)*g)*g
//   mw' = mw - lr*((m'/bc1)/(sqrt(v'/bc2) + eps) + wd*mw)
//   p'  = mw' rounded to the param's type
// in f32, with the decay folded into the update (not the eager AdamW's
// order: that is `adamw_step.cu`). g is f32, bf16 or f16; m, v and the
// master f32; p' f32, bf16 or f16. The param itself is never read: as in
// the Pallas kernel, it fixes only p's type and shape. Every scalar is
// staged on the host in f32 by the wrapper (1-b1 as f32(1) - f32(b1), bc1
// = 1 - b1**t in f32), as the Pallas wrapper stages them.
//
// The contract is bitwise against the plain version, one torch op per line
// above. nvcc would contract a*b + c into a fused multiply-add, which
// rounds once where the plain chain rounds twice, so every operation is
// written with its round-to-nearest intrinsic (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn, __fsqrt_rn), which nvcc never contracts.
//
// What bounds it on the H100: bytes. (psize + gsize + 24) bytes an element
// (g, m, v, master in; p', m', v', master' out): 32 in f32, 28 with bf16 p
// and g, against 16 operations: ~0.5 operations a byte, far below the
// card's ~20 f32 operations a byte. The grid-stride loop reads each element
// once, with neighbouring threads on neighbouring addresses.

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

struct Scalars {
  float lr, b1, om1, b2, om2, eps, wd, bc1, bc2;
};

template <typename PT, typename GT>
__global__ void __launch_bounds__(NT)
    adamw_flat_kernel(const GT* __restrict__ g, const float* __restrict__ m,
                      const float* __restrict__ v,
                      const float* __restrict__ mw, PT* __restrict__ p_out,
                      float* __restrict__ m_out, float* __restrict__ v_out,
                      float* __restrict__ mw_out, long long n, Scalars s) {
  const long long stride = (long long)gridDim.x * NT;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n;
       i += stride) {
    const float gi = to_f(g[i]);
    const float wi = mw[i];
    const float mi = __fadd_rn(__fmul_rn(s.b1, m[i]), __fmul_rn(s.om1, gi));
    const float vi = __fadd_rn(__fmul_rn(s.b2, v[i]),
                               __fmul_rn(__fmul_rn(s.om2, gi), gi));
    const float mhat = __fdiv_rn(mi, s.bc1);
    const float vhat = __fdiv_rn(vi, s.bc2);
    const float upd =
        __fadd_rn(__fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), s.eps)),
                  __fmul_rn(s.wd, wi));
    const float nw = __fsub_rn(wi, __fmul_rn(s.lr, upd));
    p_out[i] = from_f<PT>(nw);
    m_out[i] = mi;
    v_out[i] = vi;
    mw_out[i] = nw;
  }
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

// g: n contiguous of g_dtype (0 f32, 1 bf16, 2 f16); m, v, master: n f32;
// p_out: n of p_dtype; m_out, v_out, master_out: n f32, written (no
// output may alias an input).
extern "C" int adamw_flat(const void* g, const void* m, const void* v,
                          const void* master, void* p_out, void* m_out,
                          void* v_out, void* master_out, long long n,
                          int p_dtype, int g_dtype, float lr, float b1,
                          float om1, float b2, float om2, float eps, float wd,
                          float bc1, float bc2, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const long long blocks = (n + NT - 1) / NT;
  // 8 resident blocks of 256 threads (an SM's 2,048) on each of the 132
  // SMs; larger tensors loop
  const int grid = (int)(blocks < 132 * 8 ? blocks : 132 * 8);
  const Scalars s{lr, b1, om1, b2, om2, eps, wd, bc1, bc2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_type(p_dtype, [&](auto pt) {
    return with_type(g_dtype, [&](auto gt) {
      using PT = typename decltype(pt)::type;
      using GT = typename decltype(gt)::type;
      adamw_flat_kernel<PT, GT><<<grid, NT, 0, st>>>(
          static_cast<const GT*>(g), static_cast<const float*>(m),
          static_cast<const float*>(v), static_cast<const float*>(master),
          static_cast<PT*>(p_out), static_cast<float*>(m_out),
          static_cast<float*>(v_out), static_cast<float*>(master_out), n, s);
      return (int)cudaGetLastError();
    });
  });
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
