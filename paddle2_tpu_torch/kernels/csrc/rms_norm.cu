// Fused RMSNorm, forward and backward, for Hopper (sm_90a).
//
// Replaces: paddle2_tpu/kernels/pallas_fused.py `_rmsnorm_fwd_kernel` and
// `_rmsnorm_bwd_kernel` (through `fused_rms_norm` and its custom_vjp),
// reached from `incubate.nn.functional.fused_rms_norm`: RMSNorm over the
// last axis of x [R, H] with a weight w [H].
//
// Forward, per row, all arithmetic in f32:
//   ms = mean(x * x);  r = 1/sqrt(ms + eps)
//   o = (x * r) * w                 rounded once to x's type
//   r                               saved, f32 [R]
// The TPU kernel writes r broadcast over 128 lanes ([R, 128]), which is
// the TPU's layout; here r is one float a row.
// Backward, from the saved r (no statistics recomputed):
//   xh = x * r;  dy = do * w
//   dx = r * (dy - xh * mean(dy * xh))          in x's type
//   dw = sum_rows do * xh                       f32, cast to w's type
// x and do are f32, bf16 or f16; w is f32, bf16 or f16 of its own.
//
// What bounds it on the H100: bytes. The forward moves 2*R*H*size bytes
// against ~4 f32 operations an element, the backward 3*R*H*size against
// ~10: far below the ~20 operations a byte where the CUDA cores would be
// the limit. Each element of x (and do) is read once.
//
// Both directions have two routes, picked by the C entry from the shape
// and the addresses alone (the wrapper's fwd_route / bwd_route are the
// same rule):
// - the vector routes, `rms_norm_fwd_vec_kernel` and
//   `rms_norm_bwd_vec_kernel`, for every row that 16-byte vectors can
//   take: H * sizeof(x) % 16 == 0, with x, o, w and r (forward) or x, do,
//   dx and w (backward) on 16-byte boundaries. The row stays in registers
//   as it arrived (row_vec.cuh: each lane issues all of its 16-byte loads,
//   of x and of do, before its first add, so a warp has its whole row in
//   flight); the row's one sum (of squares; of dy * xh) is a warp-shuffle
//   reduction (one exchange in shared memory where a row spans warps); the
//   output goes out as 16-byte stores. Blocks are persistent and keep w in
//   shared memory for every row.
// - the general routes, `rms_norm_fwd_kernel` and `rms_norm_bwd_kernel`,
//   for every other row (H not a multiple of 16 / sizeof(x), an address
//   off a 16-byte boundary, H = 1): a block a row, scalar loads, the row
//   held in shared memory in f32 while the block reduces it (warp
//   shuffles, then one value a warp in shared memory, summed by every
//   thread in the same order). Every H from 1 to MAX_H is taken.
//
// dw is where the TPU design does not carry over. The TPU kernel writes one
// partial sum a row block and the wrapper adds the blocks' partials in
// order. Here a fixed number of blocks walk the rows (blockIdx.x,
// blockIdx.x + gridDim.x, ...), each summing its do * xh into f32
// partial sums and writing them to its own row of a workspace; a second
// kernel, `rms_norm_bwd_reduce_kernel`, adds the partials of each column
// in block order (slice s of 8 adds partials s, s + 8, ..., then the 8
// slices in order). The general route sums a block's rows in shared memory
// (`dwa`). The vector route keeps a lane's sums in registers across all of
// its rows (a lane's columns are the same for every row its warp takes)
// and adds its block's row slots in slot order through shared memory.
// (Adding the partials in the same launch, a cooperative launch whose
// blocks meet at a grid-wide barrier, was 0.4-4 % slower than the second
// kernel at the main shapes in two runs: rms_norm_bwd_variants.py.) No
// float atomics, and the grid is fixed by the shape and the card: the
// sums do not depend on which block ran first, so f32 runs are bitwise
// reproducible.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "row_vec.cuh"

namespace {

constexpr int MAX_NT = 256;
constexpr int MAX_H = 16384;
// the backward's vector route: at most 4 vectors of x a lane (and 4 of
// do, and their 4 x E dw sums in registers) before a row takes more warps:
// two warps a row at the stack's H 2048 in bf16, ~104 registers, two
// blocks an SM (8 vectors a lane, one warp a row, ~176 registers and one
// block an SM, were 8 % slower there; rms_norm_bwd_variants.py)
constexpr int BWD_MAX_VPL = 4;
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

// The vector backward's shared memory: w in its own type, rounded up to 16
// bytes, then the block's dw sums, H floats.
template <typename WT>
__host__ __device__ constexpr int bwd_w_bytes(int H) {
  return (H * (int)sizeof(WT) + 15) / 16 * 16;
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

template <typename XT, typename WT>
__global__ void __launch_bounds__(MAX_NT)
    rms_norm_fwd_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
                        XT* __restrict__ o, float* __restrict__ r_out, int H,
                        float eps) {
  extern __shared__ float xs[];  // [H], the row in f32
  __shared__ float red[MAX_NT / 32];
  const long long base = (long long)blockIdx.x * H;
  float q = 0.f;
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    const float v = to_f(x[base + i]);
    xs[i] = v;
    q += v * v;
  }
  const float r = __frsqrt_rn(block_sum(q, red) / (float)H + eps);
  for (int i = threadIdx.x; i < H; i += blockDim.x)
    o[base + i] = from_f<XT>(__fmul_rn(__fmul_rn(xs[i], r), to_f(w[i])));
  if (threadIdx.x == 0) r_out[blockIdx.x] = r;
}

// The vector route (see the note at the top and row_vec.cuh): VPL
// 16-byte vectors a lane, wpr warps a row, w in shared memory in its own
// type. The arithmetic is the general kernel's; only the order of the
// f32 sum of squares differs.
template <typename XT, typename WT, int VPL>
__global__ void __launch_bounds__(rowvec::VEC_NT)
    rms_norm_fwd_vec_kernel(const XT* __restrict__ x,
                            const WT* __restrict__ w, XT* __restrict__ o,
                            float* __restrict__ r_out, long long R, int H,
                            int wpr, float eps) {
  constexpr int E = 16 / sizeof(XT);
  extern __shared__ __align__(16) unsigned char sm_raw[];
  __shared__ float red[2][rowvec::VEC_WARPS];
  const WT* ws = reinterpret_cast<const WT*>(sm_raw);
  rowvec::stage(w, sm_raw, H * (int)sizeof(WT));
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int t = (warp % wpr) * 32 + (threadIdx.x & 31);
  const int T = 32 * wpr;
  const int nv = H / E;
  const int rpb = rowvec::VEC_WARPS / wpr;
  int par = 0;
  for (long long row = (long long)blockIdx.x * rpb + warp / wpr; row < R;
       row += (long long)gridDim.x * rpb) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * H);
    uint4 v[VPL];
#pragma unroll
    for (int k = 0; k < VPL; ++k)
      if (t + k * T < nv) v[k] = xr[t + k * T];
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      if (t + k * T < nv) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float f = rowvec::elem<XT>(v[k], j);
          q += f * f;
        }
      }
    }
    const float r =
        __frsqrt_rn(rowvec::row_sum(q, red, par, wpr) / (float)H + eps);
    uint4* orow = reinterpret_cast<uint4*>(o + row * H);
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int i = t + k * T;
      if (i < nv) {
        float wf[E];
        rowvec::chunk_f<XT, WT>(ws + i * E, wf);
        uint4 out;
#pragma unroll
        for (int j = 0; j < E; ++j)
          rowvec::set_elem<XT>(
              out, j,
              __fmul_rn(__fmul_rn(rowvec::elem<XT>(v[k], j), r), wf[j]));
        orow[i] = out;
      }
    }
    if (t == 0) r_out[row] = r;
  }
}

template <typename XT, typename WT>
__global__ void __launch_bounds__(MAX_NT)
    rms_norm_bwd_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
                        const float* __restrict__ rr,
                        const XT* __restrict__ dout, XT* __restrict__ dx,
                        float* __restrict__ ws, long long R, int H) {
  extern __shared__ float sm[];
  float* xs = sm;           // [H] xh
  float* ds = sm + H;       // [H] do * w
  float* dwa = sm + 2 * H;  // [H] this block's sum of do * xh
  __shared__ float red[MAX_NT / 32];
  for (int i = threadIdx.x; i < H; i += blockDim.x) dwa[i] = 0.f;
  for (long long row = blockIdx.x; row < R; row += gridDim.x) {
    const long long base = row * H;
    const float r = rr[row];
    float s = 0.f;
    for (int i = threadIdx.x; i < H; i += blockDim.x) {
      const float xh = __fmul_rn(to_f(x[base + i]), r);
      const float d = to_f(dout[base + i]);
      const float dy = __fmul_rn(d, to_f(w[i]));
      xs[i] = xh;
      ds[i] = dy;
      dwa[i] += d * xh;
      s += dy * xh;
    }
    const float mt = block_sum(s, red) / (float)H;
    for (int i = threadIdx.x; i < H; i += blockDim.x)
      dx[base + i] = from_f<XT>(
          __fmul_rn(r, __fsub_rn(ds[i], __fmul_rn(xs[i], mt))));
  }
  float* wg = ws + (long long)blockIdx.x * H;
  for (int i = threadIdx.x; i < H; i += blockDim.x) wg[i] = dwa[i];
}

// dw[i] = sum over the G blocks' partials, in a fixed order: slice s of
// the block's 8 adds partials s, s + 8, ...; then slice 0 adds the slices
// in order. Neighbouring threads read neighbouring columns.
template <typename WT>
__global__ void __launch_bounds__(RED_COLS* RED_SLICES)
    rms_norm_bwd_reduce_kernel(const float* __restrict__ ws,
                               WT* __restrict__ dw, int G, int H) {
  __shared__ float pw[RED_SLICES][RED_COLS];
  const int c = threadIdx.x % RED_COLS;
  const int sl = threadIdx.x / RED_COLS;
  const int i = blockIdx.x * RED_COLS + c;
  float a = 0.f;
  if (i < H)
    for (int k = sl; k < G; k += RED_SLICES) a += ws[(long long)k * H + i];
  pw[sl][c] = a;
  __syncthreads();
  if (sl == 0 && i < H) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < RED_SLICES; ++k) t += pw[k][c];
    dw[i] = from_f<WT>(t);
  }
}

// The backward's vector route (see the note at the top and row_vec.cuh):
// VPL 16-byte vectors of x and of do a lane, wpr warps a row; w in shared
// memory in its own type, then the block's dw sums in f32, written to the
// block's row of ws for rms_norm_bwd_reduce_kernel. The arithmetic is the
// general kernel's, with its rounded products (x̂ = x·r, dy = do·w, dx =
// r·(dy − x̂·mean)); only the order of the f32 sums differs.
template <typename XT, typename WT, int VPL>
__global__ void __launch_bounds__(rowvec::VEC_NT)
    rms_norm_bwd_vec_kernel(const XT* __restrict__ x,
                            const WT* __restrict__ w,
                            const float* __restrict__ rr,
                            const XT* __restrict__ dout, XT* __restrict__ dx,
                            float* __restrict__ ws, long long R, int H,
                            int wpr) {
  constexpr int E = 16 / sizeof(XT);
  extern __shared__ __align__(16) unsigned char sm_raw[];
  __shared__ float red[2][rowvec::VEC_WARPS];
  const WT* wsm = reinterpret_cast<const WT*>(sm_raw);
  float* dwb = reinterpret_cast<float*>(sm_raw + bwd_w_bytes<WT>(H));
  rowvec::stage(w, sm_raw, H * (int)sizeof(WT));
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int slot = warp / wpr;
  const int t = (warp % wpr) * 32 + (threadIdx.x & 31);
  const int T = 32 * wpr;
  const int nv = H / E;
  const int rpb = rowvec::VEC_WARPS / wpr;
  float dwa[VPL][E];
#pragma unroll
  for (int k = 0; k < VPL; ++k)
#pragma unroll
    for (int j = 0; j < E; ++j) dwa[k][j] = 0.f;
  int par = 0;
  for (long long row = (long long)blockIdx.x * rpb + slot; row < R;
       row += (long long)gridDim.x * rpb) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * H);
    const uint4* dr = reinterpret_cast<const uint4*>(dout + row * H);
    uint4 xv[VPL], dv[VPL];
#pragma unroll
    for (int k = 0; k < VPL; ++k)
      if (t + k * T < nv) {
        xv[k] = xr[t + k * T];
        dv[k] = dr[t + k * T];
      }
    const float r = rr[row];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int i = t + k * T;
      if (i < nv) {
        float wf[E];
        rowvec::chunk_f<XT, WT>(wsm + i * E, wf);
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float xh = __fmul_rn(rowvec::elem<XT>(xv[k], j), r);
          const float d = rowvec::elem<XT>(dv[k], j);
          s += __fmul_rn(d, wf[j]) * xh;
          dwa[k][j] += d * xh;
        }
      }
    }
    const float mt = rowvec::row_sum(s, red, par, wpr) / (float)H;
    uint4* dxr = reinterpret_cast<uint4*>(dx + row * H);
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int i = t + k * T;
      if (i < nv) {
        float wf[E];
        rowvec::chunk_f<XT, WT>(wsm + i * E, wf);
        uint4 out;
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float xh = __fmul_rn(rowvec::elem<XT>(xv[k], j), r);
          const float dy = __fmul_rn(rowvec::elem<XT>(dv[k], j), wf[j]);
          rowvec::set_elem<XT>(out, j,
                               __fmul_rn(r, __fsub_rn(dy, __fmul_rn(xh, mt))));
        }
        dxr[i] = out;
      }
    }
  }
  // the block's dw: its row slots' sums added in slot order
  for (int sl = 0; sl < rpb; ++sl) {
    if (slot == sl) {
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        const int i = t + k * T;
        if (i < nv)
#pragma unroll
          for (int j = 0; j < E; ++j)
            dwb[i * E + j] = sl == 0 ? dwa[k][j] : dwb[i * E + j] + dwa[k][j];
      }
    }
    __syncthreads();
  }
  float4* wg = reinterpret_cast<float4*>(ws + (long long)blockIdx.x * H);
  for (int i = threadIdx.x; i < H / 4; i += blockDim.x)
    wg[i] = reinterpret_cast<const float4*>(dwb)[i];
}

// a row's threads: a multiple of 32, about 8 elements each, at most 256
int threads_for(int H) {
  int warps = (H + 255) / 256;
  if (warps < 1) warps = 1;
  if (warps > MAX_NT / 32) warps = MAX_NT / 32;
  return warps * 32;
}

// Above 48 KB of dynamic shared memory a kernel must ask for it: once a
// device for each instantiation, for the widest row.
template <typename K>
cudaError_t grant_smem(K kernel, size_t smem, size_t widest, bool* granted) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)widest);
  if (err == cudaSuccess) granted[dev] = true;
  return err;
}

template <typename XT, typename WT>
int launch_fwd(const void* x, const void* w, void* o, void* r, long long R,
               int H, float eps, cudaStream_t st) {
  static bool granted[MAX_DEVICES] = {};
  const size_t smem = sizeof(float) * H;
  cudaError_t err = grant_smem(rms_norm_fwd_kernel<XT, WT>, smem,
                               sizeof(float) * MAX_H, granted);
  if (err != cudaSuccess) return err;
  rms_norm_fwd_kernel<XT, WT><<<(unsigned)R, threads_for(H), smem, st>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(w),
      static_cast<XT*>(o), static_cast<float*>(r), H, eps);
  return cudaGetLastError();
}

template <typename XT, typename WT, int VPL>
int launch_fwd_vec(const void* x, const void* w, void* o, void* r,
                   long long R, int H, int wpr, float eps, cudaStream_t st) {
  const auto kernel = rms_norm_fwd_vec_kernel<XT, WT, VPL>;
  const size_t smem = sizeof(WT) * H;
  const int rpb = rowvec::VEC_WARPS / wpr;
  static rowvec::GridCache cache;
  int blocks = 0;
  cudaError_t err = rowvec::persistent_blocks(
      kernel, cache, smem, sizeof(WT) * MAX_H, (R + rpb - 1) / rpb, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, rowvec::VEC_NT, smem, st>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(w),
      static_cast<XT*>(o), static_cast<float*>(r), R, H, wpr, eps);
  return cudaGetLastError();
}

// the vector route when 16-byte vectors take the row (see the note at
// the top), else the general one
template <typename XT, typename WT>
int launch_fwd_route(const void* x, const void* w, void* o, void* r,
                     long long R, int H, float eps, cudaStream_t st) {
  if ((H * sizeof(XT)) % 16 != 0 || !rowvec::aligned16(x) ||
      !rowvec::aligned16(w) || !rowvec::aligned16(o) ||
      !rowvec::aligned16(r))
    return launch_fwd<XT, WT>(x, w, o, r, R, H, eps, st);
  int wpr = 0, vpl = 0;
  rowvec::vec_plan(H / (16 / (int)sizeof(XT)), &wpr, &vpl);
  switch (vpl) {
    case 1: return launch_fwd_vec<XT, WT, 1>(x, w, o, r, R, H, wpr, eps, st);
    case 2: return launch_fwd_vec<XT, WT, 2>(x, w, o, r, R, H, wpr, eps, st);
    case 4: return launch_fwd_vec<XT, WT, 4>(x, w, o, r, R, H, wpr, eps, st);
    case 8: return launch_fwd_vec<XT, WT, 8>(x, w, o, r, R, H, wpr, eps, st);
    case 16:
      return launch_fwd_vec<XT, WT, 16>(x, w, o, r, R, H, wpr, eps, st);
  }
  return cudaErrorInvalidValue;
}

template <typename XT, typename WT>
int launch_bwd(const void* x, const void* w, const void* r, const void* dout,
               void* dx, void* dw, void* ws, long long R, int H, int G,
               cudaStream_t st) {
  static bool granted[MAX_DEVICES] = {};
  const size_t smem = sizeof(float) * 3 * H;
  cudaError_t err = grant_smem(rms_norm_bwd_kernel<XT, WT>, smem,
                               sizeof(float) * 3 * MAX_H, granted);
  if (err != cudaSuccess) return err;
  rms_norm_bwd_kernel<XT, WT><<<G, threads_for(H), smem, st>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(w),
      static_cast<const float*>(r), static_cast<const XT*>(dout),
      static_cast<XT*>(dx), static_cast<float*>(ws), R, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rms_norm_bwd_reduce_kernel<WT>
      <<<(H + RED_COLS - 1) / RED_COLS, RED_COLS * RED_SLICES, 0, st>>>(
          static_cast<const float*>(ws), static_cast<WT*>(dw), G, H);
  return cudaGetLastError();
}

template <typename XT, typename WT, int VPL>
int launch_bwd_vec(const void* x, const void* w, const void* r,
                   const void* dout, void* dx, void* dw, void* ws,
                   long long R, int H, int wpr, int G, cudaStream_t st) {
  const auto kernel = rms_norm_bwd_vec_kernel<XT, WT, VPL>;
  const size_t smem = bwd_w_bytes<WT>(H) + sizeof(float) * H;
  const int rpb = rowvec::VEC_WARPS / wpr;
  static rowvec::GridCache cache;
  int blocks = 0;
  cudaError_t err = rowvec::persistent_blocks(
      kernel, cache, smem, bwd_w_bytes<WT>(MAX_H) + sizeof(float) * MAX_H,
      (R + rpb - 1) / rpb, &blocks);
  if (err != cudaSuccess) return err;
  // ws holds G partial rows
  if (blocks > G) blocks = G;
  kernel<<<blocks, rowvec::VEC_NT, smem, st>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(w),
      static_cast<const float*>(r), static_cast<const XT*>(dout),
      static_cast<XT*>(dx), static_cast<float*>(ws), R, H, wpr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rms_norm_bwd_reduce_kernel<WT>
      <<<(H + RED_COLS - 1) / RED_COLS, RED_COLS * RED_SLICES, 0, st>>>(
          static_cast<const float*>(ws), static_cast<WT*>(dw), blocks, H);
  return cudaGetLastError();
}

// the vector route when 16-byte vectors take the rows (see the note at
// the top), else the general one
template <typename XT, typename WT>
int launch_bwd_route(const void* x, const void* w, const void* r,
                     const void* dout, void* dx, void* dw, void* ws,
                     long long R, int H, int G, cudaStream_t st) {
  if ((H * sizeof(XT)) % 16 != 0 || !rowvec::aligned16(x) ||
      !rowvec::aligned16(w) || !rowvec::aligned16(dout) ||
      !rowvec::aligned16(dx) || !rowvec::aligned16(ws))
    return launch_bwd<XT, WT>(x, w, r, dout, dx, dw, ws, R, H, G, st);
  int wpr = 0, vpl = 0;
  rowvec::vec_plan(H / (16 / (int)sizeof(XT)), &wpr, &vpl, BWD_MAX_VPL);
  switch (vpl) {
    case 1:
      return launch_bwd_vec<XT, WT, 1>(x, w, r, dout, dx, dw, ws, R, H, wpr,
                                       G, st);
    case 2:
      return launch_bwd_vec<XT, WT, 2>(x, w, r, dout, dx, dw, ws, R, H, wpr,
                                       G, st);
    case 4:
      return launch_bwd_vec<XT, WT, 4>(x, w, r, dout, dx, dw, ws, R, H, wpr,
                                       G, st);
    case 8:
      return launch_bwd_vec<XT, WT, 8>(x, w, r, dout, dx, dw, ws, R, H, wpr,
                                       G, st);
    case 16:
      // only f32 rows take 16 vectors a lane (H 16384 on 8 warps)
      if constexpr (sizeof(XT) == 4)
        return launch_bwd_vec<XT, WT, 16>(x, w, r, dout, dx, dw, ws, R, H,
                                          wpr, G, st);
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

// x, o: [R, H] contiguous of x_dtype (0 f32, 1 bf16, 2 f16); w: [H] of
// w_dtype; r: [R] f32, written. One launch: the vector route's
// persistent grid, or the general route's R blocks.
extern "C" int rms_norm_fwd(const void* x, const void* w, void* o, void* r,
                            long long R, int H, int x_dtype, int w_dtype,
                            float eps, void* stream) {
  if (bad_shape(R, H)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_type(x_dtype, [&](auto xt) {
    return with_type(w_dtype, [&](auto wt) {
      return launch_fwd_route<typename decltype(xt)::type,
                              typename decltype(wt)::type>(x, w, o, r, R, H,
                                                           eps, st);
    });
  });
}

// x, dout, dx: [R, H] of x_dtype; w, dw: [H] of w_dtype; r: [R] f32 from
// the forward; ws: G * H f32 of scratch. The vector route: at most G
// persistent blocks walk the rows; the general route: G blocks; then one
// reduction launch.
extern "C" int rms_norm_bwd(const void* x, const void* w, const void* r,
                            const void* dout, void* dx, void* dw, void* ws,
                            long long R, int H, int x_dtype, int w_dtype,
                            int G, void* stream) {
  if (bad_shape(R, H) || G <= 0 || G > R) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_type(x_dtype, [&](auto xt) {
    return with_type(w_dtype, [&](auto wt) {
      return launch_bwd_route<typename decltype(xt)::type,
                              typename decltype(wt)::type>(
          x, w, r, dout, dx, dw, ws, R, H, G, st);
    });
  });
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
