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
// card's ~20 f32 operations a byte. Each element is read once.
//
// Two routes, one per C entry; the wrapper picks. The vector route
// (`adamw_flat_vec`, every pointer on a 16-byte boundary) gives a thread 8
// elements a step: g in one 16-byte load (bf16/f16) or two (f32); m, v and
// the master in two each; the four outputs in 16-byte stores. A thread
// issues the loads of U steps before it computes any, so each SM keeps
// ~100 KB in flight; the last n % 8 elements are done one by one. The
// general route (`adamw_flat`, any alignment) is a grid-stride loop, one
// element a thread an iteration. Both run the same per-element arithmetic.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

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

// One element, in the op order of the note at the top.
__device__ __forceinline__ void adamw_element(float gi, float mi0, float vi0,
                                              float wi, const Scalars& s,
                                              float& mi, float& vi,
                                              float& nw) {
  mi = __fadd_rn(__fmul_rn(s.b1, mi0), __fmul_rn(s.om1, gi));
  vi = __fadd_rn(__fmul_rn(s.b2, vi0), __fmul_rn(__fmul_rn(s.om2, gi), gi));
  const float mhat = __fdiv_rn(mi, s.bc1);
  const float vhat = __fdiv_rn(vi, s.bc2);
  const float upd =
      __fadd_rn(__fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), s.eps)),
                __fmul_rn(s.wd, wi));
  nw = __fsub_rn(wi, __fmul_rn(s.lr, upd));
}

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
    float mi, vi, nw;
    adamw_element(to_f(g[i]), m[i], v[i], mw[i], s, mi, vi, nw);
    p_out[i] = from_f<PT>(nw);
    m_out[i] = mi;
    v_out[i] = vi;
    mw_out[i] = nw;
  }
}

// 8 elements of T at p (16-byte aligned) as floats, and back
template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&x)[8]) {
  if constexpr (sizeof(T) == 4) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* h = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = to_f(h[i]);
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&x)[8]) {
  if constexpr (sizeof(T) == 4) {
    reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
  } else {
    uint4 u;
    T* h = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = from_f<T>(x[i]);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// steps of 8 elements a thread keeps in flight on the vector route
constexpr int U = 2;

// The vector route: thread t of the grid takes the 8-element steps t,
// t + S, ... (S threads), U of them at once, every load before any
// arithmetic; then the n % 8 elements past the last whole step.
template <typename PT, typename GT>
__global__ void __launch_bounds__(NT)
    adamw_flat_vec_kernel(const GT* __restrict__ g,
                          const float* __restrict__ m,
                          const float* __restrict__ v,
                          const float* __restrict__ mw,
                          PT* __restrict__ p_out, float* __restrict__ m_out,
                          float* __restrict__ v_out,
                          float* __restrict__ mw_out, long long n,
                          Scalars s) {
  const long long steps = n / 8;
  const long long S = (long long)gridDim.x * NT;
  for (long long i0 = (long long)blockIdx.x * NT + threadIdx.x; i0 < steps;
       i0 += S * U) {
    float gx[U][8], mx[U][8], vx[U][8], wx[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long e = (i0 + u * S) * 8;
      if (i0 + u * S < steps) {
        load8(g + e, gx[u]);
        load8(m + e, mx[u]);
        load8(v + e, vx[u]);
        load8(mw + e, wx[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long e = (i0 + u * S) * 8;
      if (i0 + u * S < steps) {
        float pm[8], pv[8], pw[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          adamw_element(gx[u][k], mx[u][k], vx[u][k], wx[u][k], s, pm[k],
                        pv[k], pw[k]);
        store8(p_out + e, pw);
        store8(m_out + e, pm);
        store8(v_out + e, pv);
        store8(mw_out + e, pw);
      }
    }
  }
  const long long i = steps * 8 + (long long)blockIdx.x * NT + threadIdx.x;
  if (i < n && blockIdx.x == 0) {
    float mi, vi, nw;
    adamw_element(to_f(g[i]), m[i], v[i], mw[i], s, mi, vi, nw);
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

// The blocks of a launch: one thread a unit of work (an element on the
// general route, U steps of 8 on the vector route), at most `per_sm`
// blocks of NT threads for each of the 132 SMs; larger tensors loop.
int grid_for(long long units, int per_sm) {
  const long long blocks = (units + NT - 1) / NT;
  const long long cap = 132LL * per_sm;
  return (int)(blocks < 1 ? 1 : blocks < cap ? blocks : cap);
}

template <bool VEC>
int launch(const void* g, const void* m, const void* v, const void* master,
           void* p_out, void* m_out, void* v_out, void* master_out,
           long long n, int p_dtype, int g_dtype, const Scalars& s,
           cudaStream_t st) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  if (VEC) {
    for (const void* ptr : {g, m, v, master, (const void*)p_out,
                            (const void*)m_out, (const void*)v_out,
                            (const void*)master_out})
      if (reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorInvalidValue;
  }
  // 8 blocks of 256 threads an SM (an SM's 2,048 threads on the general
  // route; the vector route's registers let 2 be resident, and a grid of
  // 8 an SM measured faster than one of 4: adamw_flat_variants.py)
  const int grid = grid_for(VEC ? (n / 8 + U - 1) / U : n, 8);
  return with_type(p_dtype, [&](auto pt) {
    return with_type(g_dtype, [&](auto gt) {
      using PT = typename decltype(pt)::type;
      using GT = typename decltype(gt)::type;
      auto kernel = VEC ? adamw_flat_vec_kernel<PT, GT>
                        : adamw_flat_kernel<PT, GT>;
      kernel<<<grid, NT, 0, st>>>(
          static_cast<const GT*>(g), static_cast<const float*>(m),
          static_cast<const float*>(v), static_cast<const float*>(master),
          static_cast<PT*>(p_out), static_cast<float*>(m_out),
          static_cast<float*>(v_out), static_cast<float*>(master_out), n, s);
      return (int)cudaGetLastError();
    });
  });
}

}  // namespace

// g: n contiguous of g_dtype (0 f32, 1 bf16, 2 f16); m, v, master: n f32;
// p_out: n of p_dtype; m_out, v_out, master_out: n f32, written (no
// output may alias an input). `adamw_flat` takes any alignment;
// `adamw_flat_vec` needs every pointer on a 16-byte boundary (it refuses
// others).
extern "C" int adamw_flat(const void* g, const void* m, const void* v,
                          const void* master, void* p_out, void* m_out,
                          void* v_out, void* master_out, long long n,
                          int p_dtype, int g_dtype, float lr, float b1,
                          float om1, float b2, float om2, float eps, float wd,
                          float bc1, float bc2, void* stream) {
  return launch<false>(g, m, v, master, p_out, m_out, v_out, master_out, n,
                       p_dtype, g_dtype,
                       Scalars{lr, b1, om1, b2, om2, eps, wd, bc1, bc2},
                       static_cast<cudaStream_t>(stream));
}

extern "C" int adamw_flat_vec(const void* g, const void* m, const void* v,
                              const void* master, void* p_out, void* m_out,
                              void* v_out, void* master_out, long long n,
                              int p_dtype, int g_dtype, float lr, float b1,
                              float om1, float b2, float om2, float eps,
                              float wd, float bc1, float bc2, void* stream) {
  return launch<true>(g, m, v, master, p_out, m_out, v_out, master_out, n,
                      p_dtype, g_dtype,
                      Scalars{lr, b1, om1, b2, om2, eps, wd, bc1, bc2},
                      static_cast<cudaStream_t>(stream));
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
