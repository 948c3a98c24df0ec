// Fused LayerNorm, forward and backward, for Hopper (sm_90a).
//
// Replaces: paddle2_tpu/kernels/pallas_ln.py `_fwd_kernel` and
// `_bwd_kernel` (through `fused_layer_norm` and its custom_vjp), reached
// from `layer_norm` in nn/functional/norm.py under FLAGS_pallas_layer_norm
// by every LayerNorm of a transformer: last-axis affine LN over x [R, H].
//
// Forward, per row, all arithmetic in f32:
//   m = mean(x);  v = mean((x - m)^2);  r = 1/sqrt(v + eps)
//   y = (x - m) * r * g + b                  rounded once to x's type
// The variance is taken in a second pass over the centred row, as the TPU
// kernel does: E[x^2] - E[x]^2 loses the small variances that an eps of
// 1e-12 (ERNIE's) leaves exposed.
// Backward recomputes m and r from x (the only residuals are x and g), then
//   xh = (x - m) * r;  dxh = dy * g
//   dx = (dxh - mean(dxh) - xh * mean(dxh * xh)) * r     in x's type
//   dg = sum_rows dy * xh;  db = sum_rows dy            f32, cast to g's type
// x and dy are f32, bf16 or f16; g and b are f32, bf16 or f16 of their own,
// so one kernel serves half-precision activations with f32 (an unstacked
// LayerNorm under AMP O2) or half-precision (stacked leaves) parameters.
//
// What bounds it on the H100: bytes. The forward moves 2*R*H*size bytes
// against ~8 f32 operations an element, the backward 3*R*H*size against
// ~16: far below the ~20 operations a byte where the CUDA cores would be
// the limit. Each element of x (and dy) is read once.
//
// The forward has two routes, picked by the C entry from the shape and
// the addresses alone (the wrapper's fwd_route is the same rule):
// - the vector route, `layer_norm_fwd_vec_kernel`, for every row that
//   16-byte vectors can take: H * sizeof(x) % 16 == 0, with x, y, g and
//   b on 16-byte boundaries. The row stays in registers as it arrived
//   (row_vec.cuh: each lane issues all of its 16-byte loads before its
//   first add); the mean and then the centred squares are warp-shuffle
//   reductions (one exchange in shared memory each where a row spans
//   warps), the second pass reading the registers again; the output goes
//   out as 16-byte stores. Blocks are persistent and keep g and b in
//   shared memory for every row.
// - the general route, `layer_norm_fwd_kernel`, for every other row (H
//   not a multiple of 16 / sizeof(x), an address off a 16-byte
//   boundary, H = 1): one block a row, scalar loads, the row held in
//   shared memory in f32 while the block reduces it (warp shuffles, then
//   one value a warp in shared memory, summed by every thread in the
//   same order). Each thread revisits only its own elements, so the
//   buffers need no barrier; only the reductions synchronise. Every H
//   from 1 to 8192 is taken.
// The backward is the general design, walking the rows with G blocks.
//
// dg and db are where the TPU design does not carry over. The TPU's grid
// runs in order, so `_bwd_kernel` adds each row block's sums into VMEM
// scratch and writes them at its last step. Here the backward runs a fixed
// number of blocks, each walking rows blockIdx.x, blockIdx.x + gridDim.x,
// ... and summing its dy * xh and dy into f32 accumulators in shared
// memory; each block writes its partial sums to its own row of a workspace,
// and a second kernel adds the partials of each column in block order. No
// float atomics: the sums do not depend on which block ran first, so f32
// runs are bitwise reproducible.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "row_vec.cuh"

namespace {

constexpr int MAX_NT = 256;
constexpr int MAX_H = 8192;
constexpr int MAX_DEVICES = 64;
// the reduction of the partials: 32 columns x 8 slices of the blocks
constexpr int RED_COLS = 32;
constexpr int RED_SLICES = 8;

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

// The sum of v over the block, in every thread. red: one float a warp.
// The leading barrier keeps a previous call's readers ahead of this
// call's writers.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int nw = blockDim.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < nw; ++w) s += red[w];
  return s;
}

template <typename XT, typename GT>
__global__ void __launch_bounds__(MAX_NT)
    layer_norm_fwd_kernel(const XT* __restrict__ x, const GT* __restrict__ g,
                          const GT* __restrict__ b, XT* __restrict__ y,
                          int H, float eps) {
  extern __shared__ float xs[];  // [H], the row in f32
  __shared__ float red[MAX_NT / 32];
  const long long base = (long long)blockIdx.x * H;
  const float inv_h = 1.f / (float)H;
  float s = 0.f;
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    const float v = to_f(x[base + i]);
    xs[i] = v;
    s += v;
  }
  const float m = block_sum(s, red) * inv_h;
  float q = 0.f;
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    const float c = xs[i] - m;
    xs[i] = c;
    q += c * c;
  }
  const float r = __frsqrt_rn(block_sum(q, red) * inv_h + eps);
  for (int i = threadIdx.x; i < H; i += blockDim.x)
    y[base + i] = from_f<XT>(xs[i] * r * to_f(g[i]) + to_f(b[i]));
}

// The vector route (see the note at the top and row_vec.cuh): VPL
// 16-byte vectors a lane, wpr warps a row, g and b in shared memory in
// their own type (b from the first 16-byte boundary after g). The
// arithmetic is the general kernel's; only the order of the f32 sums
// differs.
template <typename XT, typename GT, int VPL>
__global__ void __launch_bounds__(rowvec::VEC_NT)
    layer_norm_fwd_vec_kernel(const XT* __restrict__ x,
                              const GT* __restrict__ g,
                              const GT* __restrict__ b, XT* __restrict__ y,
                              long long R, int H, int wpr, float eps) {
  constexpr int E = 16 / sizeof(XT);
  extern __shared__ __align__(16) unsigned char sm_raw[];
  __shared__ float red[2][rowvec::VEC_WARPS];
  const int gbytes = H * (int)sizeof(GT);
  const int boff = (gbytes + 15) & ~15;
  const GT* gs = reinterpret_cast<const GT*>(sm_raw);
  const GT* bs = reinterpret_cast<const GT*>(sm_raw + boff);
  rowvec::stage(g, sm_raw, gbytes);
  rowvec::stage(b, sm_raw + boff, gbytes);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int t = (warp % wpr) * 32 + (threadIdx.x & 31);
  const int T = 32 * wpr;
  const int nv = H / E;
  const int rpb = rowvec::VEC_WARPS / wpr;
  const float inv_h = 1.f / (float)H;
  int par = 0;
  for (long long row = (long long)blockIdx.x * rpb + warp / wpr; row < R;
       row += (long long)gridDim.x * rpb) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * H);
    uint4 v[VPL];
#pragma unroll
    for (int k = 0; k < VPL; ++k)
      if (t + k * T < nv) v[k] = xr[t + k * T];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      if (t + k * T < nv) {
#pragma unroll
        for (int j = 0; j < E; ++j) s += rowvec::elem<XT>(v[k], j);
      }
    }
    const float m = rowvec::row_sum(s, red, par, wpr) * inv_h;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      if (t + k * T < nv) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float c = rowvec::elem<XT>(v[k], j) - m;
          q += c * c;
        }
      }
    }
    const float r =
        __frsqrt_rn(rowvec::row_sum(q, red, par, wpr) * inv_h + eps);
    uint4* yrow = reinterpret_cast<uint4*>(y + row * H);
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int i = t + k * T;
      if (i < nv) {
        float gf[E], bf[E];
        rowvec::chunk_f<XT, GT>(gs + i * E, gf);
        rowvec::chunk_f<XT, GT>(bs + i * E, bf);
        uint4 out;
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float c = rowvec::elem<XT>(v[k], j) - m;
          rowvec::set_elem<XT>(out, j, c * r * gf[j] + bf[j]);
        }
        yrow[i] = out;
      }
    }
  }
}

template <typename XT, typename GT>
__global__ void __launch_bounds__(MAX_NT)
    layer_norm_bwd_kernel(const XT* __restrict__ x, const GT* __restrict__ g,
                          const XT* __restrict__ dy, XT* __restrict__ dx,
                          float* __restrict__ ws, long long R, int H,
                          float eps) {
  extern __shared__ float sm[];
  float* xs = sm;           // [H] x, then xh
  float* ds = sm + H;       // [H] dy, then dy * g
  float* dga = sm + 2 * H;  // [H] this block's sum of dy * xh
  float* dba = sm + 3 * H;  // [H] this block's sum of dy
  __shared__ float red[MAX_NT / 32];
  const float inv_h = 1.f / (float)H;
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    dga[i] = 0.f;
    dba[i] = 0.f;
  }
  for (long long row = blockIdx.x; row < R; row += gridDim.x) {
    const long long base = row * H;
    float s = 0.f;
    for (int i = threadIdx.x; i < H; i += blockDim.x) {
      const float v = to_f(x[base + i]);
      xs[i] = v;
      ds[i] = to_f(dy[base + i]);
      s += v;
    }
    const float m = block_sum(s, red) * inv_h;
    float q = 0.f;
    for (int i = threadIdx.x; i < H; i += blockDim.x) {
      const float c = xs[i] - m;
      xs[i] = c;
      q += c * c;
    }
    const float r = __frsqrt_rn(block_sum(q, red) * inv_h + eps);
    float s1 = 0.f, s2 = 0.f;
    for (int i = threadIdx.x; i < H; i += blockDim.x) {
      const float xh = xs[i] * r;
      const float d = ds[i];
      const float dxh = d * to_f(g[i]);
      xs[i] = xh;
      ds[i] = dxh;
      dga[i] += d * xh;
      dba[i] += d;
      s1 += dxh;
      s2 += dxh * xh;
    }
    const float m1 = block_sum(s1, red) * inv_h;
    const float m2 = block_sum(s2, red) * inv_h;
    for (int i = threadIdx.x; i < H; i += blockDim.x)
      dx[base + i] = from_f<XT>((ds[i] - m1 - xs[i] * m2) * r);
  }
  float* wg = ws + (long long)blockIdx.x * H;
  float* wb = ws + (long long)(gridDim.x + blockIdx.x) * H;
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    wg[i] = dga[i];
    wb[i] = dba[i];
  }
}

// dg[i] = sum over the G blocks' partials, in a fixed order: slice s of
// the block's 8 adds partials s, s + 8, ...; then slice 0 adds the slices
// in order. Neighbouring threads read neighbouring columns.
template <typename GT>
__global__ void __launch_bounds__(RED_COLS* RED_SLICES)
    layer_norm_bwd_reduce_kernel(const float* __restrict__ ws,
                                 GT* __restrict__ dg, GT* __restrict__ db,
                                 int G, int H) {
  __shared__ float pg[RED_SLICES][RED_COLS];
  __shared__ float pb[RED_SLICES][RED_COLS];
  const int c = threadIdx.x % RED_COLS;
  const int sl = threadIdx.x / RED_COLS;
  const int i = blockIdx.x * RED_COLS + c;
  float a = 0.f, e = 0.f;
  if (i < H) {
    for (int k = sl; k < G; k += RED_SLICES) {
      a += ws[(long long)k * H + i];
      e += ws[(long long)(G + k) * H + i];
    }
  }
  pg[sl][c] = a;
  pb[sl][c] = e;
  __syncthreads();
  if (sl == 0 && i < H) {
    float ta = 0.f, te = 0.f;
#pragma unroll
    for (int k = 0; k < RED_SLICES; ++k) {
      ta += pg[k][c];
      te += pb[k][c];
    }
    dg[i] = from_f<GT>(ta);
    db[i] = from_f<GT>(te);
  }
}

// a row's threads: a multiple of 32, about 4 elements each, at most 256
int threads_for(int H) {
  int warps = (H + 127) / 128;
  if (warps < 1) warps = 1;
  if (warps > MAX_NT / 32) warps = MAX_NT / 32;
  return warps * 32;
}

template <typename XT, typename GT>
int launch_fwd(const void* x, const void* g, const void* b, void* y,
               long long R, int H, float eps, cudaStream_t st) {
  const size_t smem = sizeof(float) * H;
  layer_norm_fwd_kernel<XT, GT><<<(unsigned)R, threads_for(H), smem, st>>>(
      static_cast<const XT*>(x), static_cast<const GT*>(g),
      static_cast<const GT*>(b), static_cast<XT*>(y), H, eps);
  return cudaGetLastError();
}

template <typename XT, typename GT, int VPL>
int launch_fwd_vec(const void* x, const void* g, const void* b, void* y,
                   long long R, int H, int wpr, float eps, cudaStream_t st) {
  const auto kernel = layer_norm_fwd_vec_kernel<XT, GT, VPL>;
  // g, then b from the first 16-byte boundary after it
  const size_t smem = 2 * ((sizeof(GT) * H + 15) & ~(size_t)15);
  const int rpb = rowvec::VEC_WARPS / wpr;
  static rowvec::GridCache cache;
  int blocks = 0;
  cudaError_t err = rowvec::persistent_blocks(
      kernel, cache, smem, 2 * sizeof(GT) * MAX_H, (R + rpb - 1) / rpb,
      &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, rowvec::VEC_NT, smem, st>>>(
      static_cast<const XT*>(x), static_cast<const GT*>(g),
      static_cast<const GT*>(b), static_cast<XT*>(y), R, H, wpr, eps);
  return cudaGetLastError();
}

// the vector route when 16-byte vectors take the row (see the note at
// the top), else the general one
template <typename XT, typename GT>
int launch_fwd_route(const void* x, const void* g, const void* b, void* y,
                     long long R, int H, float eps, cudaStream_t st) {
  if ((H * sizeof(XT)) % 16 != 0 || !rowvec::aligned16(x) ||
      !rowvec::aligned16(g) || !rowvec::aligned16(b) ||
      !rowvec::aligned16(y))
    return launch_fwd<XT, GT>(x, g, b, y, R, H, eps, st);
  int wpr = 0, vpl = 0;
  rowvec::vec_plan(H / (16 / (int)sizeof(XT)), &wpr, &vpl);
  switch (vpl) {
    case 1: return launch_fwd_vec<XT, GT, 1>(x, g, b, y, R, H, wpr, eps, st);
    case 2: return launch_fwd_vec<XT, GT, 2>(x, g, b, y, R, H, wpr, eps, st);
    case 4: return launch_fwd_vec<XT, GT, 4>(x, g, b, y, R, H, wpr, eps, st);
    case 8: return launch_fwd_vec<XT, GT, 8>(x, g, b, y, R, H, wpr, eps, st);
    case 16:
      return launch_fwd_vec<XT, GT, 16>(x, g, b, y, R, H, wpr, eps, st);
  }
  return cudaErrorInvalidValue;
}

template <typename XT, typename GT>
int launch_bwd(const void* x, const void* g, const void* dy, void* dx,
               void* dg, void* db, void* ws, long long R, int H, float eps,
               int G, cudaStream_t st) {
  const size_t smem = sizeof(float) * 4 * H;
  // above 48 KB (H > 3072) dynamic shared memory must be asked for: once
  // a device for each instantiation, for the widest row
  static bool granted[MAX_DEVICES] = {};
  cudaError_t err;
  if (smem > 48 * 1024) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (!granted[dev]) {
      err = cudaFuncSetAttribute(layer_norm_bwd_kernel<XT, GT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)(sizeof(float) * 4 * MAX_H));
      if (err != cudaSuccess) return err;
      granted[dev] = true;
    }
  }
  layer_norm_bwd_kernel<XT, GT><<<G, threads_for(H), smem, st>>>(
      static_cast<const XT*>(x), static_cast<const GT*>(g),
      static_cast<const XT*>(dy), static_cast<XT*>(dx),
      static_cast<float*>(ws), R, H, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  layer_norm_bwd_reduce_kernel<GT>
      <<<(H + RED_COLS - 1) / RED_COLS, RED_COLS * RED_SLICES, 0, st>>>(
          static_cast<const float*>(ws), static_cast<GT*>(dg),
          static_cast<GT*>(db), G, H);
  return cudaGetLastError();
}

bool bad_shape(long long R, int H) {
  return R <= 0 || R > 0x7fffffffLL || H <= 0 || H > MAX_H;
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

// x, y: [R, H] contiguous of x_dtype (0 f32, 1 bf16, 2 f16); g, b: [H] of
// g_dtype. One launch: the vector route's persistent grid, or the
// general route's R blocks.
extern "C" int layer_norm_fwd(const void* x, const void* g, const void* b,
                              void* y, long long R, int H, int x_dtype,
                              int g_dtype, float eps, void* stream) {
  if (bad_shape(R, H)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_type(x_dtype, [&](auto xt) {
    return with_type(g_dtype, [&](auto gt) {
      return launch_fwd_route<typename decltype(xt)::type,
                              typename decltype(gt)::type>(x, g, b, y, R, H,
                                                           eps, st);
    });
  });
}

// x, dy, dx: [R, H] of x_dtype; g, dg, db: [H] of g_dtype; ws: 2 * G * H
// f32 of scratch. G blocks walk the rows; then one reduction launch.
extern "C" int layer_norm_bwd(const void* x, const void* g, const void* dy,
                              void* dx, void* dg, void* db, void* ws,
                              long long R, int H, int x_dtype, int g_dtype,
                              float eps, int G, void* stream) {
  if (bad_shape(R, H) || G <= 0 || G > R) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_type(x_dtype, [&](auto xt) {
    return with_type(g_dtype, [&](auto gt) {
      return launch_bwd<typename decltype(xt)::type,
                        typename decltype(gt)::type>(x, g, dy, dx, dg, db, ws,
                                                     R, H, eps, G, st);
    });
  });
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
