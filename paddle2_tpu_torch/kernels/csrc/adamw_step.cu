// Multi-tensor AdamW step for Hopper (sm_90a): one launch updates every
// tensor of an optimizer step, in the eager op order.
//
// Replaces: paddle2_tpu/kernels/pallas_fused.py `_adamw_step_kernel`,
// which the JAX optimizer drives once per leaf through `fused_adamw_step`.
// Here one launch takes a table of tensors; for each, in place on flat f32
// working parameter p (the parameter, or the multi-precision master), m and
// v, with the gradient g read in its stored dtype:
//   m  = b1*m + (1-b1)*g
//   v  = b2*v + (1-b2)*(g*g)
//   p' = p - (lr*(m/bc1)) / (sqrt(v/bc2) + eps)
//   p' = p' - (lr*wd)*p          (decoupled decay, against the old p; only
//                                 for a tensor whose decay flag is set, as
//                                 the eager `if wd and decay` branch)
// and, where the tensor has one, the low-precision parameter (bf16 or f16,
// the master's model copy) is written from p' with round-to-nearest-even,
// which is torch's `.to(dtype)`. A bf16 or f16 gradient widens to f32
// exactly, so it equals the eager `g.float()`. Every scalar is staged on the
// host in f32 by the wrapper (1-b1 from the Python double, bc1 = 1 - b1**t in
// f32 from the integer step), as the Pallas wrapper stages them, and passed
// as a launch argument beside the table.
//
// The contract is bitwise: the result equals the port's eager AdamW, one
// torch op per line above, on f32 state. nvcc would contract a*b + c into a
// fused multiply-add, which rounds once where the eager chain rounds twice,
// so every operation is written with its round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), which nvcc
// never contracts.
//
// What bounds it on the H100: bytes. 28 bytes an element (p, g, m, v read
// and p, m, v written in f32; or a 2-byte g read and a 2-byte parameter
// written beside them) against 16 operations: far below the card's ~20 f32
// operations a byte. What the per-tensor version lost besides bytes was
// launches and a chain around each: a launch per tensor, and for each bf16
// parameter a `g.float()` before it and a `.to(bf16)` and a copy after it
// (12 more bytes an element and two more launches a tensor). Here the table
// travels as one kernel parameter (a __grid_constant__ struct of up to
// MAX_TENSORS descriptors; Hopper with CUDA >= 12.1 takes 32,764 bytes of
// parameters), so a step costs one launch, reads each gradient as it is
// stored and writes each bf16 parameter in the same pass.
//
// Work split (momentum_step.cu's): each tensor is cut into chunks of CHUNK
// elements, and the chunks of all tensors form one index space; a block
// takes chunks in a grid-stride loop and finds a chunk's tensor by a binary
// search over the running chunk counts (uniform across the block, so it
// reads the parameter space as a broadcast). A thread moves 4 elements at a
// time with 128-bit f32 loads and stores (64-bit for 2-byte types) where the
// tensor's pointers allow it, and one at a time otherwise and in the tail.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int NT = 256;
constexpr int VEC = 4;
constexpr int UNROLL = 4;
constexpr int CHUNK = NT * VEC * UNROLL;  // 4,096 elements
constexpr int MAX_TENSORS = 256;

// dtype codes of the wrapper: 0 float32, 1 bfloat16, 2 float16; a low
// parameter code of 0 means there is none
struct Desc {  // 56 bytes, the wrapper's numpy record
  float* work;
  float* m;
  float* v;
  const void* grad;
  void* low;
  long long n;
  int codes;  // grad code | low code << 8 | decay << 16
  int pad;
};
static_assert(sizeof(Desc) == 56, "the wrapper's record is 56 bytes");

struct Table {
  Desc t[MAX_TENSORS];
  int chunk_end[MAX_TENSORS];  // running chunk counts
  int count;
};

struct Scalars {
  float lr, b1, om1, b2, om2, eps, wd, bc1, bc2;
};

template <int C> struct Dt;  // the wrapper's dtype code -> its type
template <> struct Dt<0> { using T = float; };
template <> struct Dt<1> { using T = __nv_bfloat16; };
template <> struct Dt<2> { using T = __half; };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }
__device__ __forceinline__ float widen_bits(uint16_t b, __nv_bfloat16) {
  return __bfloat162float(__ushort_as_bfloat16(b));
}
__device__ __forceinline__ float widen_bits(uint16_t b, __half) {
  return __half2float(__ushort_as_half(b));
}
// round to nearest even: torch's .to(bfloat16) / .to(float16)
__device__ __forceinline__ uint16_t narrow_bits(float x, __nv_bfloat16) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ uint16_t narrow_bits(float x, __half) {
  return __half_as_ushort(__float2half_rn(x));
}

// the eager chain on one element; updates m and v, returns p'
__device__ __forceinline__ float update(float p, float g, float& m, float& v,
                                        const Scalars& s, float lr_wd,
                                        bool decay) {
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.om1, g));
  v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(s.om2, __fmul_rn(g, g)));
  const float mhat = __fdiv_rn(m, s.bc1);
  const float vhat = __fdiv_rn(v, s.bc2);
  float np = __fsub_rn(p, __fdiv_rn(__fmul_rn(s.lr, mhat),
                                    __fadd_rn(__fsqrt_rn(vhat), s.eps)));
  if (decay) np = __fsub_rn(np, __fmul_rn(lr_wd, p));
  return np;
}

// 4 consecutive 2-byte values, one 64-bit load or store
struct alignas(8) Bits4 {
  uint16_t x[4];
};

__device__ __forceinline__ void load_f4(const float* src, long long i,
                                        float (&f)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(src + i);
  f[0] = q.x, f[1] = q.y, f[2] = q.z, f[3] = q.w;
}

__device__ __forceinline__ void store_f4(float* dst, long long i,
                                         const float (&f)[4]) {
  *reinterpret_cast<float4*>(dst + i) = make_float4(f[0], f[1], f[2], f[3]);
}

template <int G>
__device__ __forceinline__ void load_g4(const void* src, long long i,
                                        float (&g)[4]) {
  if constexpr (G == 0) {
    load_f4(static_cast<const float*>(src), i, g);
  } else {
    const Bits4 b =
        *reinterpret_cast<const Bits4*>(static_cast<const uint16_t*>(src) + i);
#pragma unroll
    for (int e = 0; e < 4; ++e) g[e] = widen_bits(b.x[e], typename Dt<G>::T());
  }
}

template <int L>
__device__ __forceinline__ void store_low4(void* low, long long i,
                                           const float (&p)[4]) {
  Bits4 b;
#pragma unroll
  for (int e = 0; e < 4; ++e) b.x[e] = narrow_bits(p[e], typename Dt<L>::T());
  *reinterpret_cast<Bits4*>(static_cast<uint16_t*>(low) + i) = b;
}

// U groups of 4 elements, from j0 every `stride` elements, vectorized:
// every load is issued before the first store
template <int G, int L, int U>
__device__ __forceinline__ void step_vec(const Desc& d, long long j0,
                                         long long stride, const Scalars& s,
                                         float lr_wd, bool decay) {
  float p[U][4], m[U][4], v[U][4], g[U][4];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long j = j0 + u * stride;
    load_f4(d.work, j, p[u]);
    load_f4(d.m, j, m[u]);
    load_f4(d.v, j, v[u]);
    load_g4<G>(d.grad, j, g[u]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[u][e] = update(p[u][e], g[u][e], m[u][e], v[u][e], s, lr_wd, decay);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long j = j0 + u * stride;
    store_f4(d.work, j, p[u]);
    store_f4(d.m, j, m[u]);
    store_f4(d.v, j, v[u]);
    if constexpr (L != 0) store_low4<L>(d.low, j, p[u]);
  }
}

// elements [begin, end) of one tensor; begin is a multiple of CHUNK
template <int G, int L>
__device__ void run_chunk(const Desc& d, long long begin, long long end,
                          const Scalars& s, float lr_wd) {
  using TG = typename Dt<G>::T;
  const bool decay = (d.codes >> 16) & 1;
  const uintptr_t a16 = reinterpret_cast<uintptr_t>(d.work) |
                        reinterpret_cast<uintptr_t>(d.m) |
                        reinterpret_cast<uintptr_t>(d.v) |
                        (G == 0 ? reinterpret_cast<uintptr_t>(d.grad) : 0);
  const uintptr_t a8 = (G != 0 ? reinterpret_cast<uintptr_t>(d.grad) : 0) |
                       (L != 0 ? reinterpret_cast<uintptr_t>(d.low) : 0);
  long long i = begin;
  if ((a16 & 15) == 0 && (a8 & 7) == 0) {
    const long long vend = begin + ((end - begin) / VEC) * VEC;
    const long long j0 = begin + (long long)threadIdx.x * VEC;
    if (vend - begin == CHUNK) {
      step_vec<G, L, UNROLL>(d, j0, NT * VEC, s, lr_wd, decay);
    } else {
      for (long long j = j0; j < vend; j += NT * VEC)
        step_vec<G, L, 1>(d, j, 0, s, lr_wd, decay);
    }
    i = vend;
  }
  for (long long j = i + threadIdx.x; j < end; j += NT) {
    float m = d.m[j], v = d.v[j];
    const float p = update(d.work[j],
                           widen(static_cast<const TG*>(d.grad)[j]), m, v, s,
                           lr_wd, decay);
    d.work[j] = p;
    d.m[j] = m;
    d.v[j] = v;
    if constexpr (L != 0)
      static_cast<uint16_t*>(d.low)[j] = narrow_bits(p, typename Dt<L>::T());
  }
}

template <int G>
__device__ __forceinline__ void by_low(const Desc& d, long long begin,
                                       long long end, const Scalars& s,
                                       float lr_wd) {
  switch ((d.codes >> 8) & 255) {
    case 0: run_chunk<G, 0>(d, begin, end, s, lr_wd); break;
    case 1: run_chunk<G, 1>(d, begin, end, s, lr_wd); break;
    case 2: run_chunk<G, 2>(d, begin, end, s, lr_wd); break;
  }
}

__global__ void __launch_bounds__(NT)
    adamw_step_kernel(const __grid_constant__ Table tab, const Scalars s) {
  const float lr_wd = __fmul_rn(s.lr, s.wd);
  const int total = tab.chunk_end[tab.count - 1];
  for (int c = blockIdx.x; c < total; c += gridDim.x) {
    // the first tensor whose running chunk count passes c
    int lo = 0, hi = tab.count - 1;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (tab.chunk_end[mid] > c) hi = mid;
      else lo = mid + 1;
    }
    const Desc& d = tab.t[lo];
    const int first = lo == 0 ? 0 : tab.chunk_end[lo - 1];
    const long long begin = (long long)(c - first) * CHUNK;
    const long long end = min(d.n, begin + CHUNK);
    switch (d.codes & 255) {
      case 0: by_low<0>(d, begin, end, s, lr_wd); break;
      case 1: by_low<1>(d, begin, end, s, lr_wd); break;
      case 2: by_low<2>(d, begin, end, s, lr_wd); break;
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

}  // namespace

// `descs`: `count` (1 .. 256) 56-byte records {work, m, v, grad, low, n,
// codes, pad} on the host, one per tensor; work/m/v f32, grad and low in the
// dtypes `codes` names (decay in bit 16), each n contiguous elements on the
// current device (low may be null when its code is 0). work, m, v and low
// are updated in place. The nine scalars are the step's, staged in f32. One
// launch.
extern "C" int adamw_step_multi(const void* descs, int count, float lr,
                                float b1, float om1, float b2, float om2,
                                float eps, float wd, float bc1, float bc2,
                                void* stream) {
  if (count <= 0 || count > MAX_TENSORS) return cudaErrorInvalidValue;
  Table tab;
  memcpy(tab.t, descs, sizeof(Desc) * count);
  long long chunks = 0;
  for (int i = 0; i < count; ++i) {
    if (tab.t[i].n < 0) return cudaErrorInvalidValue;
    chunks += (tab.t[i].n + CHUNK - 1) / CHUNK;
    if (chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
    tab.chunk_end[i] = (int)chunks;
  }
  if (chunks == 0) return cudaSuccess;
  tab.count = count;
  const Scalars s{lr, b1, om1, b2, om2, eps, wd, bc1, bc2};
  // 8 resident blocks of 256 threads (an SM's 2,048) on every SM; more
  // chunks loop
  const long long cap = (long long)sm_count() * 8;
  const int grid = (int)(chunks < cap ? chunks : cap);
  adamw_step_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(tab,
                                                                       s);
  return cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
