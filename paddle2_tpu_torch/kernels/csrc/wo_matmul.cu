// Int8 weight-only matmul for Hopper (sm_90a), on the CUDA cores.
//
// Replaces: paddle2_tpu/kernels/pallas_matmul.py `_wo_kernel` (through
// `_wo_pallas`), reached from `int8_weight_only_matmul` by every block
// projection (WeightOnlyLinear) and the logits matmul (WeightOnlyLMHead) of
// a model served with weight_only_int8 / weight_only_lm_head.
//
//   y[m, n] = cast( (sum_k x[m, k] * w[k, n]) * (s[n] / qmax)  (+ b[n]) )
//
// x [M, K] f32 or bf16, w [K, N] int8, s [N] f32, b [N] in x's type, y
// [M, N] in x's type. The sum is taken in f32 from exact products (an int8
// value is exact in f32, and so is a bf16 times an int8 one), the scale is
// applied once per column after the sum and the bias is added in f32 before
// the one cast, as the Pallas kernel and its wrapper do. The kernel and its
// plain version therefore differ only in the order of summation.
//
// What bounds it on the H100, and what the design does about it:
//
// * Decode (M <= 8) is bound by the weight bytes: K*N int8 bytes against
//   2*M*K*N operations, at most 16 operations a byte, below the card's ~20
//   f32 operations a byte of its memory rate. `wo_gemv_kernel` streams w
//   once: each thread owns 16 neighbouring columns (one 16-byte copy a
//   row, neighbouring threads on neighbouring columns, a warp on four
//   128-byte rows) and keeps its next 8 rows in flight as asynchronous
//   copies (cp.async) into a ring of its own in shared memory, so the
//   bytes in flight (32 KB a block) take no registers: at M 8 the 128
//   accumulators of a thread take those. Each row used is replaced at once
//   by the copy of the row 8 further on. x's <= 8 rows over the block's K
//   range are staged in shared memory once, while the first copies fly.
//   The 32 row lanes of a block split its K range and are reduced through
//   warp shuffles and shared memory. A 128-column tile gives 16 blocks at
//   N = 2048, too few for 132 SMs, so K is also split across blocks
//   (gridDim.y), as many ways as one wave of resident blocks allows: each
//   block writes its f32 partial sums to a workspace, and the last block of
//   a column tile to finish (a counter per tile, the threadfence-reduction
//   pattern) adds the partials in split order, so the result does not
//   depend on which block ran first. The last block sets its counter back
//   to 0.
// * Prefill (M > 8) is bound by operations: 2*M*K*N against ~M*K*size +
//   K*N bytes. `wo_gemm_kernel` is a tiled product on the CUDA cores: a
//   128 x 128 output tile a block, 8 x 8 outputs a thread in registers,
//   tiles of x and of the int8 weight (converted to f32) in shared memory
//   eight rows of K at a time, the next tile's loads in flight while the
//   current one is used. It serves f32 x (the tensor cores would need
//   TF32, which the f32 contract refuses) and bf16 shapes outside TMA's
//   16-byte rule; bf16 prefill within it runs on the tensor cores
//   (wo_matmul_wgmma.cu).
//
// Every shape is taken: M, N and K are masked at the ragged edge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wo_common.cuh"

namespace {

using namespace wo;

constexpr int NT = 256;

// ------------------------------------------------------------ decode GEMV
constexpr int GV_COLS = 128;                 // columns of a block
constexpr int GV_LANE_COLS = 16;             // columns of a thread
constexpr int GV_COL_LANES = GV_COLS / GV_LANE_COLS;   // 8
constexpr int GV_ROW_LANES = NT / GV_COL_LANES;        // 32
constexpr int GV_MAX_M = 8;
// A block's shared memory: x's MT rows over the block's K range of at
// most 8192 / MT rows (32 KB, later reused for the 8 warps' partial sums,
// 8 * MT * 128 floats), then a ring of GV_STAGES 16-byte slots for each
// thread, which asynchronous copies fill with the thread's next rows of
// w: the bytes in flight live in shared memory, not in registers (at MT 8
// the 128 accumulators take those).
constexpr int GV_SMEM_FLOATS = 8192;
constexpr int GV_STAGES = 8;
constexpr int GV_SMEM_BYTES = GV_SMEM_FLOATS * 4 + GV_STAGES * NT * 16;
constexpr int GV_X_LOADS = 16;               // x loads in flight a thread

// Row k, columns n0..n0+15 of w as 16 bytes, byte by byte (any N and
// alignment); zero past kend or N.
__device__ __forceinline__ uint4 load_w16(const int8_t* __restrict__ w,
                                          int k, int n0, int kend, int N) {
  if (k >= kend || n0 >= N) return make_uint4(0u, 0u, 0u, 0u);
  const int8_t* p = w + (size_t)k * N + n0;
  uint32_t q[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int c = 0; c < GV_LANE_COLS; ++c)
    if (n0 + c < N)
      q[c >> 2] |= (uint32_t)(uint8_t)__ldg(p + c) << (8 * (c & 3));
  return make_uint4(q[0], q[1], q[2], q[3]);
}

// The same 16 bytes into this thread's ring slot: an asynchronous copy
// (cp.async, zero-filled past kend or N) when VEC, else a masked load
// and a store. Only the thread that fills a slot reads it, so the ring
// needs no barrier: cp.async.wait_group makes a thread's own copies
// visible to it.
template <bool VEC>
__device__ __forceinline__ void fetch_w16(uint4* slot,
                                          const int8_t* __restrict__ w,
                                          int k, int n0, int kend, int N) {
  if (!VEC) {
    *slot = load_w16(w, k, n0, kend, N);
    return;
  }
  const bool in = k < kend && n0 < N;
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(slot));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(in ? w + (size_t)k * N + n0 : w), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Grid (ceil(N / 128), K splits of k_per_split <= 8192 / MT rows), dynamic
// shared memory GV_SMEM_BYTES. MT >= M rows of x are computed (the rows
// past M are zero). VEC: N % 16 == 0 and w 16-byte aligned. Row lane rl
// takes rows kbeg + rl + 32 t.
template <typename T, int MT, bool VEC>
__global__ void __launch_bounds__(NT)
    wo_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ s, const T* __restrict__ bias,
                   T* __restrict__ y, float* __restrict__ ws,
                   unsigned* __restrict__ counters, int M, int K, int N,
                   int k_per_split, float qmax) {
  extern __shared__ __align__(16) unsigned char gv_smem[];
  __shared__ bool last;
  constexpr int KMAX = GV_SMEM_FLOATS / MT;  // rows of K a block may take
  float(*xs)[KMAX] = reinterpret_cast<float(*)[KMAX]>(gv_smem);
  float(*red)[MT][GV_COLS] = reinterpret_cast<float(*)[MT][GV_COLS]>(gv_smem);
  uint4* ring = reinterpret_cast<uint4*>(gv_smem + GV_SMEM_FLOATS * 4);
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int cl = tid % GV_COL_LANES, rl = tid / GV_COL_LANES;
  const int n0 = blockIdx.x * GV_COLS + cl * GV_LANE_COLS;
  const int kbeg = blockIdx.y * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const int kp = kend - kbeg;
  const int steps = (kp + GV_ROW_LANES - 1) / GV_ROW_LANES;

  // this thread's first GV_STAGES rows of w in flight while x is staged
#pragma unroll
  for (int t = 0; t < GV_STAGES; ++t) {
    fetch_w16<VEC>(&ring[t * NT + tid], w, kbeg + rl + GV_ROW_LANES * t, n0,
                   kend, N);
    cp_async_commit();
  }
  for (int base = 0; base < MT * kp; base += GV_X_LOADS * NT) {
    float v[GV_X_LOADS];
#pragma unroll
    for (int u = 0; u < GV_X_LOADS; ++u) {
      const int i = base + u * NT + tid, m = i / kp;
      v[u] = (i < MT * kp && m < M)
                 ? to_f(x[(size_t)m * K + kbeg + i - m * kp]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < GV_X_LOADS; ++u) {
      const int i = base + u * NT + tid, m = i / kp;
      if (i < MT * kp) xs[m][i - m * kp] = v[u];
    }
  }
  __syncthreads();

  float acc[MT][GV_LANE_COLS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < GV_LANE_COLS; ++c) acc[m][c] = 0.f;

  // each row used frees its slot for the row GV_STAGES further on
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<GV_STAGES - 1>();
    uint4* slot = &ring[(t % GV_STAGES) * NT + tid];
    const uint4 cur = *slot;
    const int kk = rl + GV_ROW_LANES * t;
    if (kk < kp) {
      float wf[GV_LANE_COLS];
      i8x4_to_f32(cur.x, wf);
      i8x4_to_f32(cur.y, wf + 4);
      i8x4_to_f32(cur.z, wf + 8);
      i8x4_to_f32(cur.w, wf + 12);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xv = xs[m][kk];
#pragma unroll
        for (int c = 0; c < GV_LANE_COLS; ++c)
          acc[m][c] = fmaf(xv, wf[c], acc[m][c]);
      }
    }
    fetch_w16<VEC>(slot, w, kbeg + kk + GV_ROW_LANES * GV_STAGES, n0, kend,
                   N);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // the 4 row lanes of a warp (lanes 8 apart), then the 8 warps in order
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < GV_LANE_COLS; ++c) {
      float v = acc[m][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][c] = v;
    }
  __syncthreads();                 // every read of xs is done
  if (lane < GV_COL_LANES) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < GV_LANE_COLS; ++c)
        red[warp][m][cl * GV_LANE_COLS + c] = acc[m][c];
  }
  __syncthreads();
  const bool split = gridDim.y > 1;
  for (int o = tid; o < MT * GV_COLS; o += NT) {
    const int m = o / GV_COLS, c = o % GV_COLS;
    const int n = blockIdx.x * GV_COLS + c;
    float v = 0.f;
#pragma unroll
    for (int wp = 0; wp < NT / 32; ++wp) v += red[wp][m][c];
    if (m < M && n < N) {
      if (split)
        ws[((size_t)blockIdx.y * M + m) * N + n] = v;
      else
        y[(size_t)m * N + n] = epilogue(v, s[n], qmax, bias, n);
    }
  }
  if (!split) return;

  // the last block of this column tile adds the K splits' partials
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(&counters[blockIdx.x], 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int o = tid; o < MT * GV_COLS; o += NT) {
    const int m = o / GV_COLS, c = o % GV_COLS;
    const int n = blockIdx.x * GV_COLS + c;
    if (m >= M || n >= N) continue;
    float v = 0.f;
    for (int ks = 0; ks < (int)gridDim.y; ++ks)
      v += __ldcg(&ws[((size_t)ks * M + m) * N + n]);
    y[(size_t)m * N + n] = epilogue(v, s[n], qmax, bias, n);
  }
  if (tid == 0) counters[blockIdx.x] = 0u;
}

// ----------------------------------------------------------- prefill GEMM
constexpr int BM = 128, BN = 128, BK = 8;

// Grid (ceil(N / 128), ceil(M / 128)); 16 x 16 threads, each owning rows
// {ty*4 + i, 64 + ty*4 + i} and columns {tx*4 + j, 64 + tx*4 + j}.
template <typename T>
__global__ void __launch_bounds__(NT)
    wo_gemm_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ s, const T* __restrict__ bias,
                   T* __restrict__ y, int M, int K, int N, float qmax) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // loaders: x rows a_r, k a_c..a_c+3; w row b_r, columns b_c..b_c+3
  const int a_r = tid / 2, a_c = (tid % 2) * 4;
  const int b_r = tid / 32, b_c = (tid % 32) * 4;
  float av[4], bv[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + a_r, k = k0 + a_c + i;
      av[i] = (m < M && k < K) ? to_f(x[(size_t)m * K + k]) : 0.f;
      const int kb = k0 + b_r, n = n0 + b_c + i;
      bv[i] = (kb < K && n < N) ? (float)__ldg(w + (size_t)kb * N + n) : 0.f;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) As[a_c + i][a_r] = av[i];
    *reinterpret_cast<float4*>(&Bs[b_r][b_c]) =
        make_float4(bv[0], bv[1], bv[2], bv[3]);
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < N) y[(size_t)m * N + n] = epilogue(acc[i][j], s[n], qmax, bias, n);
    }
  }
}

// The decode kernel for (T, MT, vec), allowed its dynamic shared memory
// on the current device.
template <typename T, int MT>
auto gemv_kernel(bool vec) {
  auto kernel = vec ? wo_gemv_kernel<T, MT, true> : wo_gemv_kernel<T, MT, false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       GV_SMEM_BYTES);
  return kernel;
}

template <typename T, int MT>
void launch_gemv(dim3 grid, cudaStream_t st, bool vec, const T* x,
                 const int8_t* w, const float* s, const T* bias, T* y,
                 float* ws, unsigned* counters, int M, int K, int N,
                 int k_per_split, float qmax) {
  gemv_kernel<T, MT>(vec)<<<grid, NT, GV_SMEM_BYTES, st>>>(
      x, w, s, bias, y, ws, counters, M, K, N, k_per_split, qmax);
}

template <typename T>
int launch(const void* xv, const void* wv, const void* sv, const void* bv,
           void* yv, void* wsv, void* cv, int M, int K, int N,
           int k_per_split, float qmax, cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  const int8_t* w = static_cast<const int8_t*>(wv);
  const float* s = static_cast<const float*>(sv);
  const T* bias = static_cast<const T*>(bv);
  T* y = static_cast<T*>(yv);
  if (M <= GV_MAX_M) {
    const int mt = M == 1 ? 1 : M == 2 ? 2 : M <= 4 ? 4 : 8;
    if (k_per_split > GV_SMEM_FLOATS / mt) return cudaErrorInvalidValue;
    const dim3 grid((N + GV_COLS - 1) / GV_COLS,
                    (K + k_per_split - 1) / k_per_split);
    if (grid.y > 1 && (wsv == nullptr || cv == nullptr))
      return cudaErrorInvalidValue;
    const bool vec =
        N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    float* ws = static_cast<float*>(wsv);
    unsigned* counters = static_cast<unsigned*>(cv);
    if (M == 1)
      launch_gemv<T, 1>(grid, st, vec, x, w, s, bias, y, ws, counters, M, K,
                        N, k_per_split, qmax);
    else if (M == 2)
      launch_gemv<T, 2>(grid, st, vec, x, w, s, bias, y, ws, counters, M, K,
                        N, k_per_split, qmax);
    else if (M <= 4)
      launch_gemv<T, 4>(grid, st, vec, x, w, s, bias, y, ws, counters, M, K,
                        N, k_per_split, qmax);
    else
      launch_gemv<T, 8>(grid, st, vec, x, w, s, bias, y, ws, counters, M, K,
                        N, k_per_split, qmax);
  } else {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    wo_gemm_kernel<T><<<grid, NT, 0, st>>>(x, w, s, bias, y, M, K, N, qmax);
  }
  return cudaGetLastError();
}

template <typename T, int MT>
int gemv_occupancy(bool vec, int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, gemv_kernel<T, MT>(vec), NT, GV_SMEM_BYTES);
}

template <typename T>
int gemv_occupancy(int M, bool vec, int* blocks) {
  if (M == 1) return gemv_occupancy<T, 1>(vec, blocks);
  if (M == 2) return gemv_occupancy<T, 2>(vec, blocks);
  if (M <= 4) return gemv_occupancy<T, 4>(vec, blocks);
  return gemv_occupancy<T, 8>(vec, blocks);
}

}  // namespace

// x [M, K] (dtype 0: f32, 1: bf16), w [K, N] int8, s [N] f32, bias [N] in
// x's type or null, y [M, N] in x's type, all contiguous on the current
// device. For M <= 8 and K > k_per_split, ws holds ceil(K / k_per_split)
// * M * N f32 and counters ceil(N / 128) zeroed u32 (left zeroed); else
// both may be null.
extern "C" int wo_matmul(const void* x, const void* w, const void* s,
                         const void* bias, void* y, void* ws, void* counters,
                         int M, int K, int N, int k_per_split, float qmax,
                         int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || k_per_split <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, s, bias, y, ws, counters, M, K, N,
                         k_per_split, qmax, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, s, bias, y, ws, counters, M, K, N,
                                 k_per_split, qmax, st);
  return cudaErrorInvalidValue;
}

// Blocks of the decode kernel for M (<= 8) rows that one SM holds at
// once, on the current device; vec: N % 16 == 0. The wrapper splits K so
// that one wave fills the card.
extern "C" int wo_gemv_blocks_per_sm(int M, int vec, int dtype,
                                     int* blocks) {
  if (M <= 0 || M > GV_MAX_M) return cudaErrorInvalidValue;
  if (dtype == 0) return gemv_occupancy<float>(M, vec != 0, blocks);
  if (dtype == 1) return gemv_occupancy<__nv_bfloat16>(M, vec != 0, blocks);
  return cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
