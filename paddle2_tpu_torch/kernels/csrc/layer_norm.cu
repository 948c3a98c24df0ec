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
// The backward has the same two routes, by the same rule (x, dy, dx, g
// and the partials' workspace on 16-byte boundaries; the wrapper's
// bwd_route):
// - the vector route, `layer_norm_bwd_vec_kernel`: x and dy stay in
//   registers as they arrived (each lane issues all of its 16-byte loads
//   of both before its first add). The mean, then the variance of the
//   centred row from the same registers, as the vector forward takes
//   them; then mean(dxh) and mean(dxh * xh) in one exchange
//   (row_vec.cuh row_sum2): three reductions a row, none a block barrier
//   where a row fits one warp. A lane keeps its sums of dy * xh and dy in
//   registers across all of its rows (its columns are the same in every
//   row); the block adds its row slots in slot order through shared
//   memory. Blocks are persistent, at most G, and keep g in shared memory
//   in its own type. A lane holds at most BWD_MAX_VPL vectors of x (and
//   of dy) before a row takes more warps.
// - the general route, `layer_norm_bwd_kernel`, for every other call:
//   one block a row at a time on G blocks, scalar loads, the row held in
//   shared memory in f32, dg and db summed in shared memory.
//
// dg and db are where the TPU design does not carry over. The TPU's grid
// runs in order, so `_bwd_kernel` adds each row block's sums into VMEM
// scratch and writes them at its last step. Here the backward runs a fixed
// number of blocks, each walking rows with a grid stride and summing its
// dy * xh and dy in f32; each block writes its partial sums to its own row
// of a workspace, and a second kernel, `layer_norm_bwd_reduce_kernel`,
// adds the partials of each column in block order. No float atomics, and
// the grid is fixed by the shape and the card: the sums do not depend on
// which block ran first, so f32 runs are bitwise reproducible.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "row_vec.cuh"

namespace {

constexpr int MAX_NT = 256;
constexpr int MAX_H = 8192;
constexpr int MAX_DEVICES = 64;
// the reduction of the partials: 32 columns x 8 slices of the blocks,
// dg's and db's columns in blocks of their own
constexpr int RED_COLS = 32;
constexpr int RED_SLICES = 8;
// the backward's vector route: at most 2 vectors of x a lane (and 2 of
// dy, and their 2 x 2 x E dg and db sums in registers) before a row takes
// more warps: ERNIE's H 768 and the GPT bench's H 1024 in bf16 are two
// warps a row, ~80 registers, three blocks an SM. At most 4 (one warp a
// row, ~156 registers, one block an SM) was 20-27 % slower there in bf16
// and f16, 9 % faster at H 768 in f32 (layer_norm_bwd_variants.py)
constexpr int BWD_MAX_VPL = 2;

// The vector backward's shared memory: g in its own type, rounded up to 16
// bytes, then the block's dg and db sums, H floats each.
template <typename GT>
__host__ __device__ constexpr int bwd_g_bytes(int H) {
  return (H * (int)sizeof(GT) + 15) / 16 * 16;
}

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

// dg[i] (blockIdx.y 0) or db[i] (1) = the sum of the G blocks' partials
// (ws rows 0..G-1 for dg, G..2G-1 for db), in a fixed order: slice s of
// the block's 8 adds partials s, s + 8, ...; then slice 0 adds the slices
// in order. Neighbouring threads read neighbouring columns.
template <typename GT>
__global__ void __launch_bounds__(RED_COLS* RED_SLICES)
    layer_norm_bwd_reduce_kernel(const float* __restrict__ ws,
                                 GT* __restrict__ dg, GT* __restrict__ db,
                                 int G, int H) {
  __shared__ float part[RED_SLICES][RED_COLS];
  const int c = threadIdx.x % RED_COLS;
  const int sl = threadIdx.x / RED_COLS;
  const int i = blockIdx.x * RED_COLS + c;
  const float* w = ws + (long long)blockIdx.y * G * H;
  float a = 0.f;
  if (i < H)
    for (int k = sl; k < G; k += RED_SLICES) a += w[(long long)k * H + i];
  part[sl][c] = a;
  __syncthreads();
  if (sl == 0 && i < H) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < RED_SLICES; ++k) t += part[k][c];
    (blockIdx.y ? db : dg)[i] = from_f<GT>(t);
  }
}

// The backward's vector route (see the note at the top and row_vec.cuh):
// VPL 16-byte vectors of x and of dy a lane, wpr warps a row; g in shared
// memory in its own type, then the block's dg and db sums in f32, written
// to the block's rows of ws (dg's row b, db's row gridDim.x + b) for
// layer_norm_bwd_reduce_kernel. The arithmetic is the general kernel's;
// only the order of the f32 sums differs.
template <typename XT, typename GT, int VPL>
__global__ void __launch_bounds__(rowvec::VEC_NT)
    layer_norm_bwd_vec_kernel(const XT* __restrict__ x,
                              const GT* __restrict__ g,
                              const XT* __restrict__ dy, XT* __restrict__ dx,
                              float* __restrict__ ws, long long R, int H,
                              int wpr, float eps) {
  constexpr int E = 16 / sizeof(XT);
  extern __shared__ __align__(16) unsigned char sm_raw[];
  __shared__ float red[2][rowvec::VEC_WARPS];
  __shared__ float red2[2][2 * rowvec::VEC_WARPS];
  const GT* gs = reinterpret_cast<const GT*>(sm_raw);
  float* dgb = reinterpret_cast<float*>(sm_raw + bwd_g_bytes<GT>(H));
  float* dbb = dgb + H;
  rowvec::stage(g, sm_raw, H * (int)sizeof(GT));
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int slot = warp / wpr;
  const int t = (warp % wpr) * 32 + (threadIdx.x & 31);
  const int T = 32 * wpr;
  const int nv = H / E;
  const int rpb = rowvec::VEC_WARPS / wpr;
  const float inv_h = 1.f / (float)H;
  float dga[VPL][E], dba[VPL][E];
#pragma unroll
  for (int k = 0; k < VPL; ++k)
#pragma unroll
    for (int j = 0; j < E; ++j) dga[k][j] = dba[k][j] = 0.f;
  int par = 0, par2 = 0;
  for (long long row = (long long)blockIdx.x * rpb + slot; row < R;
       row += (long long)gridDim.x * rpb) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * H);
    const uint4* dr = reinterpret_cast<const uint4*>(dy + row * H);
    uint4 xv[VPL], dv[VPL];
#pragma unroll
    for (int k = 0; k < VPL; ++k)
      if (t + k * T < nv) {
        xv[k] = xr[t + k * T];
        dv[k] = dr[t + k * T];
      }
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k)
      if (t + k * T < nv)
#pragma unroll
        for (int j = 0; j < E; ++j) s += rowvec::elem<XT>(xv[k], j);
    const float m = rowvec::row_sum(s, red, par, wpr) * inv_h;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k)
      if (t + k * T < nv)
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float c = rowvec::elem<XT>(xv[k], j) - m;
          q += c * c;
        }
    const float r =
        __frsqrt_rn(rowvec::row_sum(q, red, par, wpr) * inv_h + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int i = t + k * T;
      if (i < nv) {
        float gf[E];
        rowvec::chunk_f<XT, GT>(gs + i * E, gf);
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float xh = (rowvec::elem<XT>(xv[k], j) - m) * r;
          const float d = rowvec::elem<XT>(dv[k], j);
          const float dxh = d * gf[j];
          dga[k][j] += d * xh;
          dba[k][j] += d;
          s1 += dxh;
          s2 += dxh * xh;
        }
      }
    }
    rowvec::row_sum2(s1, s2, red2, par2, wpr);
    const float m1 = s1 * inv_h, m2 = s2 * inv_h;
    uint4* dxr = reinterpret_cast<uint4*>(dx + row * H);
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int i = t + k * T;
      if (i < nv) {
        float gf[E];
        rowvec::chunk_f<XT, GT>(gs + i * E, gf);
        uint4 out;
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float xh = (rowvec::elem<XT>(xv[k], j) - m) * r;
          const float dxh = rowvec::elem<XT>(dv[k], j) * gf[j];
          rowvec::set_elem<XT>(out, j, (dxh - m1 - xh * m2) * r);
        }
        dxr[i] = out;
      }
    }
  }
  // the block's dg and db: its row slots' sums added in slot order
  for (int sl = 0; sl < rpb; ++sl) {
    if (slot == sl) {
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        const int i = t + k * T;
        if (i < nv)
#pragma unroll
          for (int j = 0; j < E; ++j) {
            const int c = i * E + j;
            dgb[c] = sl == 0 ? dga[k][j] : dgb[c] + dga[k][j];
            dbb[c] = sl == 0 ? dba[k][j] : dbb[c] + dba[k][j];
          }
      }
    }
    __syncthreads();
  }
  float4* wg = reinterpret_cast<float4*>(ws + (long long)blockIdx.x * H);
  float4* wb =
      reinterpret_cast<float4*>(ws + (long long)(gridDim.x + blockIdx.x) * H);
  for (int i = threadIdx.x; i < H / 4; i += blockDim.x) {
    wg[i] = reinterpret_cast<const float4*>(dgb)[i];
    wb[i] = reinterpret_cast<const float4*>(dbb)[i];
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

// the partials' sums: dg's columns in blockIdx.y 0, db's in 1
template <typename GT>
int launch_reduce(void* ws, void* dg, void* db, int G, int H,
                  cudaStream_t st) {
  layer_norm_bwd_reduce_kernel<GT>
      <<<dim3((H + RED_COLS - 1) / RED_COLS, 2), RED_COLS * RED_SLICES, 0,
         st>>>(static_cast<const float*>(ws), static_cast<GT*>(dg),
               static_cast<GT*>(db), G, H);
  return cudaGetLastError();
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
  return launch_reduce<GT>(ws, dg, db, G, H, st);
}

template <typename XT, typename GT, int VPL>
int launch_bwd_vec(const void* x, const void* g, const void* dy, void* dx,
                   void* dg, void* db, void* ws, long long R, int H, int wpr,
                   float eps, int G, cudaStream_t st) {
  const auto kernel = layer_norm_bwd_vec_kernel<XT, GT, VPL>;
  const size_t smem = bwd_g_bytes<GT>(H) + 2 * sizeof(float) * H;
  const int rpb = rowvec::VEC_WARPS / wpr;
  static rowvec::GridCache cache;
  int blocks = 0;
  cudaError_t err = rowvec::persistent_blocks(
      kernel, cache, smem, bwd_g_bytes<GT>(MAX_H) + 2 * sizeof(float) * MAX_H,
      (R + rpb - 1) / rpb, &blocks);
  if (err != cudaSuccess) return err;
  // ws holds G partial rows of each sum
  if (blocks > G) blocks = G;
  kernel<<<blocks, rowvec::VEC_NT, smem, st>>>(
      static_cast<const XT*>(x), static_cast<const GT*>(g),
      static_cast<const XT*>(dy), static_cast<XT*>(dx),
      static_cast<float*>(ws), R, H, wpr, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce<GT>(ws, dg, db, blocks, H, st);
}

// the vector route when 16-byte vectors take the rows (see the note at
// the top), else the general one
template <typename XT, typename GT>
int launch_bwd_route(const void* x, const void* g, const void* dy, void* dx,
                     void* dg, void* db, void* ws, long long R, int H,
                     float eps, int G, cudaStream_t st) {
  if ((H * sizeof(XT)) % 16 != 0 || !rowvec::aligned16(x) ||
      !rowvec::aligned16(g) || !rowvec::aligned16(dy) ||
      !rowvec::aligned16(dx) || !rowvec::aligned16(ws))
    return launch_bwd<XT, GT>(x, g, dy, dx, dg, db, ws, R, H, eps, G, st);
  int wpr = 0, vpl = 0;
  rowvec::vec_plan(H / (16 / (int)sizeof(XT)), &wpr, &vpl, BWD_MAX_VPL);
  switch (vpl) {
    case 1:
      return launch_bwd_vec<XT, GT, 1>(x, g, dy, dx, dg, db, ws, R, H, wpr,
                                       eps, G, st);
    case 2:
      return launch_bwd_vec<XT, GT, 2>(x, g, dy, dx, dg, db, ws, R, H, wpr,
                                       eps, G, st);
    case 4:
      return launch_bwd_vec<XT, GT, 4>(x, g, dy, dx, dg, db, ws, R, H, wpr,
                                       eps, G, st);
    case 8:
      // only f32 rows take 8 vectors a lane (H > 4096 on 8 warps)
      if constexpr (sizeof(XT) == 4)
        return launch_bwd_vec<XT, GT, 8>(x, g, dy, dx, dg, db, ws, R, H,
                                         wpr, eps, G, st);
  }
  return cudaErrorInvalidValue;
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
// f32 of scratch. The vector route: at most G persistent blocks walk the
// rows; the general route: G blocks; then one reduction launch.
extern "C" int layer_norm_bwd(const void* x, const void* g, const void* dy,
                              void* dx, void* dg, void* db, void* ws,
                              long long R, int H, int x_dtype, int g_dtype,
                              float eps, int G, void* stream) {
  if (bad_shape(R, H) || G <= 0 || G > R) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_type(x_dtype, [&](auto xt) {
    return with_type(g_dtype, [&](auto gt) {
      return launch_bwd_route<typename decltype(xt)::type,
                              typename decltype(gt)::type>(
          x, g, dy, dx, dg, db, ws, R, H, eps, G, st);
    });
  });
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
