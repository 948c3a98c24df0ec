// Multi-tensor (Nesterov) momentum step for Hopper (sm_90a): one launch
// updates every tensor of an optimizer step, in the eager op order.
//
// Replaces: paddle2_tpu/kernels/pallas_fused.py `_momentum_step_kernel`,
// which the JAX optimizer drives once per leaf through
// `fused_momentum_step`. Here one launch takes a table of tensors; for
// each, in place on flat f32 working parameter p and velocity v, with the
// gradient g read in its stored dtype:
//   g  = g + wd*p                (L2 decay, the tensor's own wd; skipped
//                                 when wd is 0, as the eager `if wd and
//                                 decay` branch skips it)
//   v  = mom*v + g
//   p' = p - lr*v                (plain)
//   p' = p - lr*(g + mom*v)      (Nesterov, with the new v)
// and, where the tensor has one, the low-precision parameter (bf16 or
// f16, the multi-precision master's model copy) is written from p' with
// round-to-nearest-even, which is torch's `.to(dtype)`. A bf16 or f16
// gradient widens to f32 exactly, so it equals the eager `g.float()`.
// lr, mom and each wd are staged on the host in f32 by the wrapper, as
// the Pallas wrapper stages them.
//
// The contract is bitwise: the result equals the port's eager Momentum,
// one torch op per line above, on f32 state. nvcc would contract mom*v + g
// into a fused multiply-add, which rounds once where the eager chain
// rounds twice, so every operation is written with its round-to-nearest
// intrinsic (__fmul_rn, __fadd_rn, __fsub_rn), which nvcc never contracts.
//
// What bounds it on the H100: bytes. 20 bytes an element (p, g, v read
// and p, v written in f32; or a 2-byte g read and a 2-byte parameter
// written) against at most 7 operations: far below the card's ~20 f32
// operations a byte. What the per-tensor version lost was not bytes but
// launches: ResNet-50 has 161 parameter tensors, most of them BatchNorm
// vectors of 64-2,048 elements, and each took its own launch, plus a cast
// and a copy for each bf16 one. Here the table travels as one kernel
// parameter (a __grid_constant__ struct of up to MAX_TENSORS descriptors;
// Hopper with CUDA >= 12.1 takes 32,764 bytes of parameters), so a step
// costs one launch, no host sync and no upload beyond the launch's own.
//
// Work split: each tensor is cut into chunks of CHUNK elements, and the
// chunks of all tensors form one index space; a block takes chunks in a
// grid-stride loop and finds a chunk's tensor by a binary search over the
// running chunk counts (uniform across the block, so it reads the
// parameter space as a broadcast). A thread moves 4 elements at a time
// with 128-bit f32 loads and stores (64-bit for 2-byte types) where the
// tensor's pointers allow it, and one at a time otherwise and in the
// tail. The grid fills the card's SMs at full occupancy.

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
struct Desc {  // 48 bytes, the wrapper's numpy record
  float* work;
  float* vel;
  const void* grad;
  void* low;
  long long n;
  float wd;
  int codes;  // grad code | low code << 8
};
static_assert(sizeof(Desc) == 48, "the wrapper's record is 48 bytes");

struct Table {
  Desc t[MAX_TENSORS];
  int chunk_end[MAX_TENSORS];  // running chunk counts
  int count;
  float lr;
  float mom;
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

// the eager chain on one element; returns p'
template <bool NESTEROV>
__device__ __forceinline__ float update(float p, float g, float& v, float lr,
                                        float mom, float wd) {
  if (wd != 0.f) g = __fadd_rn(g, __fmul_rn(wd, p));
  v = __fadd_rn(__fmul_rn(mom, v), g);
  const float step = NESTEROV ? __fmul_rn(lr, __fadd_rn(g, __fmul_rn(mom, v)))
                              : __fmul_rn(lr, v);
  return __fsub_rn(p, step);
}

// 4 consecutive 2-byte values, one 64-bit load or store
struct alignas(8) Bits4 {
  uint16_t x[4];
};

template <int G>
__device__ __forceinline__ void load4(const void* src, long long i,
                                      float (&g)[4]) {
  if constexpr (G == 0) {
    const float4 f =
        *reinterpret_cast<const float4*>(static_cast<const float*>(src) + i);
    g[0] = f.x, g[1] = f.y, g[2] = f.z, g[3] = f.w;
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
template <bool NESTEROV, int G, int L, int U>
__device__ __forceinline__ void step_vec(const Desc& d, long long j0,
                                         long long stride, float lr,
                                         float mom) {
  float p[U][4], v[U][4], g[U][4];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long j = j0 + u * stride;
    const float4 pw = *reinterpret_cast<const float4*>(d.work + j);
    const float4 vv = *reinterpret_cast<const float4*>(d.vel + j);
    p[u][0] = pw.x, p[u][1] = pw.y, p[u][2] = pw.z, p[u][3] = pw.w;
    v[u][0] = vv.x, v[u][1] = vv.y, v[u][2] = vv.z, v[u][3] = vv.w;
    load4<G>(d.grad, j, g[u]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[u][e] = update<NESTEROV>(p[u][e], g[u][e], v[u][e], lr, mom, d.wd);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long j = j0 + u * stride;
    *reinterpret_cast<float4*>(d.work + j) =
        make_float4(p[u][0], p[u][1], p[u][2], p[u][3]);
    *reinterpret_cast<float4*>(d.vel + j) =
        make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
    if constexpr (L != 0) store_low4<L>(d.low, j, p[u]);
  }
}

// elements [begin, end) of one tensor; begin is a multiple of CHUNK
template <bool NESTEROV, int G, int L>
__device__ void run_chunk(const Desc& d, long long begin, long long end,
                          float lr, float mom) {
  using TG = typename Dt<G>::T;
  const uintptr_t a16 = reinterpret_cast<uintptr_t>(d.work) |
                        reinterpret_cast<uintptr_t>(d.vel) |
                        (G == 0 ? reinterpret_cast<uintptr_t>(d.grad) : 0);
  const uintptr_t a8 = (G != 0 ? reinterpret_cast<uintptr_t>(d.grad) : 0) |
                       (L != 0 ? reinterpret_cast<uintptr_t>(d.low) : 0);
  long long i = begin;
  if ((a16 & 15) == 0 && (a8 & 7) == 0) {
    const long long vend = begin + ((end - begin) / VEC) * VEC;
    const long long j0 = begin + (long long)threadIdx.x * VEC;
    if (vend - begin == CHUNK) {
      step_vec<NESTEROV, G, L, UNROLL>(d, j0, NT * VEC, lr, mom);
    } else {
      for (long long j = j0; j < vend; j += NT * VEC)
        step_vec<NESTEROV, G, L, 1>(d, j, 0, lr, mom);
    }
    i = vend;
  }
  for (long long j = i + threadIdx.x; j < end; j += NT) {
    float v = d.vel[j];
    const float p = update<NESTEROV>(
        d.work[j], widen(static_cast<const TG*>(d.grad)[j]), v, lr, mom,
        d.wd);
    d.work[j] = p;
    d.vel[j] = v;
    if constexpr (L != 0)
      static_cast<uint16_t*>(d.low)[j] = narrow_bits(p, typename Dt<L>::T());
  }
}

template <bool NESTEROV, int G>
__device__ __forceinline__ void by_low(const Desc& d, long long begin,
                                       long long end, float lr, float mom) {
  switch (d.codes >> 8) {
    case 0: run_chunk<NESTEROV, G, 0>(d, begin, end, lr, mom); break;
    case 1: run_chunk<NESTEROV, G, 1>(d, begin, end, lr, mom); break;
    case 2: run_chunk<NESTEROV, G, 2>(d, begin, end, lr, mom); break;
  }
}

template <bool NESTEROV>
__global__ void __launch_bounds__(NT)
    momentum_step_kernel(const __grid_constant__ Table tab) {
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
      case 0: by_low<NESTEROV, 0>(d, begin, end, tab.lr, tab.mom); break;
      case 1: by_low<NESTEROV, 1>(d, begin, end, tab.lr, tab.mom); break;
      case 2: by_low<NESTEROV, 2>(d, begin, end, tab.lr, tab.mom); break;
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

// `descs`: `count` (1 .. 256) 48-byte records {work, vel, grad, low, n,
// wd, codes} on the host, one per tensor; work/vel f32, grad and low in
// the dtypes `codes` names, each n contiguous elements on the current
// device (low may be null when its code is 0). work, vel and low are
// updated in place. One launch.
extern "C" int momentum_step_multi(const void* descs, int count, float lr,
                                   float mom, int nesterov, void* stream) {
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
  tab.lr = lr;
  tab.mom = mom;
  // 8 resident blocks of 256 threads (an SM's 2,048) on every SM; more
  // chunks loop
  const long long cap = (long long)sm_count() * 8;
  const int grid = (int)(chunks < cap ? chunks : cap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nesterov)
    momentum_step_kernel<true><<<grid, NT, 0, s>>>(tab);
  else
    momentum_step_kernel<false><<<grid, NT, 0, s>>>(tab);
  return cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
