// Int8 weight-only matmul for Hopper (sm_90a): bf16 decode and every
// prefill on the tensor cores (mma.sync; f32 prefill in two TF32 passes),
// f32 decode on the CUDA cores.
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
// value is exact in f32 and in bf16, and a bf16 times an int8 one is exact
// in f32), the scale is applied once per column after the sum and the bias
// is added in f32 before the one cast, as the Pallas kernel and its wrapper
// do. The kernels and their plain version therefore differ only in the
// order of summation, and on f32 prefill in the TF32 products (each within
// about 2^-21 of its f32 value, below).
//
// What bounds it on the H100, and what the design does about it:
//
// * Decode (M <= 8) is bound by the weight bytes: K*N int8 bytes against
//   2*M*K*N operations. On the CUDA cores that is not so at M 8: every
//   weight byte costs 8 FMAs and its widening, about as long as the byte
//   takes to arrive, and 128 f32 accumulators a thread cap the blocks an SM
//   holds. So bf16 x takes `wo_gemv_mma_kernel`, on the tensor cores:
//
//   - The product is swapped, y^T = w^T x^T, on mma.sync m16n8k16 (bf16 in,
//     f32 sums): 16 columns of w are the A operand's rows, x's <= 8 rows
//     the n8 side (rows past M are zero), so at M 8 no tensor-core work is
//     wasted.
//   - A warp owns a 128-column tile of w and takes 16 rows of K a step. Its
//     thread (g = lane / 4, t = lane % 4) loads rows 4t .. 4t+3 of the step
//     at columns 16g .. 16g+15 (four 16-byte loads; a warp reads four whole
//     128-byte rows each time) and widens them straight into its A
//     fragments, with no shared-memory transpose, by two maps the mma
//     leaves free. The column map: in the step's mma j (0..7), A row g
//     stands for column 16g + 2j of the tile and A row g+8 for 16g + 2j + 1.
//     The k map: A's (and B's) k slots 2t, 2t+1, 2t+8, 2t+9 stand for the
//     step's rows 4t, 4t+1, 4t+2, 4t+3. So register a0 of mma j packs rows
//     4t and 4t+1 at column 16g + 2j, a1 the same rows at the next column,
//     a2 and a3 rows 4t+2 and 4t+3; and B's registers b0, b1 are x's row g
//     at the step's k 4t .. 4t+3, one 8-byte load of x (from L2: x is a
//     few KB). The accumulators come back as rows 2t, 2t+1 of x and the
//     thread's own 16 columns: 32 registers a thread.
//   - Widening stays exact: wo::i8x4_to_f32, then a bf16 pair
//     (cvt.rn.bf16x2.f32, exact for every int8 value).
//   - Loads go straight to registers, two steps ahead of the mmas (2 KB a
//     warp a step). A block is 4 warps over one column tile, splitting its
//     K range step by step; at ~128 registers a thread an SM holds 4 blocks
//     (16 warps, 64 KB in flight). A first design staged the weights in
//     shared memory through per-thread cp.async rings (8 warps, 97 KB a
//     block) and x in shared memory as well, and was slower at every
//     decode shape: small blocks that hold nothing in shared memory but
//     their sums start and finish sooner.
//   - The 4 warps of a block are added through shared memory in warp
//     order; K is also split across blocks (gridDim.y, at most 8 ways)
//     until the blocks fill about two an SM. The splits of a column tile
//     are one thread-block cluster: after a cluster barrier each block
//     adds the blocks' sums for its share of the tile's outputs in rank
//     (split) order through distributed shared memory, so the result does
//     not depend on which block ran first and no partial sum goes through
//     global memory. (A global workspace with a counter a tile and the
//     last block adding, the CUDA-core kernel's way, was as fast or up to
//     17 % slower at every decode shape.)
//
//   f32 x keeps `wo_gemv_kernel` on the CUDA cores (a tensor-core form in
//   two TF32 passes, as the prefill below, is still to be written): each
//   thread owns 16 neighbouring columns (one 16-byte copy a
//   row, neighbouring threads on neighbouring columns, a warp on four
//   128-byte rows) and keeps its next 8 rows in flight as cp.async copies
//   into a ring of its own, x's <= 8 rows over the block's K range staged
//   in shared memory once; the 32 row lanes of a block split its K range
//   and are reduced through warp shuffles and shared memory; K is split
//   across blocks, each block writing f32 partial sums to a workspace and
//   the last block of a column tile to finish (a counter per tile) adding
//   them in split order.
// * Prefill (M > 8) is bound by operations: 2*M*N*K against ~M*K*size +
//   K*N bytes. bf16 prefill within TMA's 16-byte rule runs on wgmma
//   (wo_matmul_wgmma.cu); f32 prefill, and bf16 rows of another length,
//   take `wo_gemm_tf32_kernel` on mma.sync m16n8k8 with TF32 operands and
//   f32 sums:
//
//   - Every int8 value is exact in TF32 (10 mantissa bits), and so is every
//     bf16 value, so a bf16 x needs one TF32 pass. An f32 x is split once
//     as it enters a fragment into big (rounded to TF32) and small = x - big
//     (tf32x3.cuh's split), and each product is x_small*w + x_big*w: two
//     mma a product, not the three of error-compensated TF32 with two
//     inexact operands, within about 2^-21 of its f32 value. One pass on
//     f32 x (about 2^-11) reads past the f32 limit; chip_smoke.py gates that.
//   - Bound: 2 passes * 2*M*N*K / 494.7e12 on the tensor cores (0.137 ms
//     at M 1008 K 2048 N 8192) against 2*M*N*K / 67e12 on the CUDA cores
//     (0.505 ms), where the kernel this one replaces ran (a 128 x 128 tile a
//     block, 8 x 8 FMAs a thread, ~36 TFLOP/s at that shape).
//   - A block of 8 warps computes a 32 x 512 tile of y in f32, 32 rows x 64
//     columns a warp, so that every warp has rows at the padded prompt
//     lengths (M 32 up) and a block's f32 x tile is a quarter of a 128 x
//     128 tile's; bf16 x, which reads x element by element, takes the 128
//     x 128 tile (4 warps along M). x's type sets the tile. x's and
//     w's tiles of a 32-row k-step arrive by 16-byte cp.async into a ring
//     of three (rows padded to 36 floats and BN + 32 bytes, so the fragment
//     reads hit 32 different banks); w is widened exactly
//     (wo::i8x4_to_f32) as it enters the B fragments. The n map (gemm_step)
//     makes B's (k t, n g) and (k t+4, n g) of four n-tiles one word each;
//     the C fragments then hold eight neighbouring columns of a row, stored
//     as two 16-byte runs. Row tiles past M are skipped.
//   - The tensor cores' f32 sums drift with the rows one accumulator takes
//     (at M 1008 the down projection read 9e-5 of the f32 limit's 1e-4 with
//     4096 rows in one accumulator, 2.9e-5 with 2048). So every 64 k-steps
//     (2048 rows) of a longer walk, the mma accumulators are added into a
//     second sum on the CUDA cores, held in local memory (the registers are
//     full), and zeroed: any K keeps the error of 2048 rows.
//   - K is split across blocks (gridDim.z, at most 8 ways) when the output
//     tiles fill under half of the blocks the card holds (the wrapper's
//     quant_matmul.gemm_k_split): at M 128 the down projection is 16 tiles
//     for 132 SMs. The splits of a tile are one thread-block cluster: each
//     block leaves its partial tile in shared memory and the blocks add
//     them in rank (split) order through distributed shared memory, so no
//     sum goes through an atomic or global memory and two runs give
//     bitwise-equal outputs. The scale and bias are applied once, in the
//     f32 epilogue (wo::epilogue).
//
// Every shape is taken: M, N and K are masked at the ragged edge (a w
// whose rows are not 16-byte runs, N % 16 != 0 or an unaligned base, is
// read byte by byte).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"
#include "wo_common.cuh"

namespace {

using namespace tf32x3;
using namespace wo;

constexpr int GV_NT = 256;

// ------------------------------------------------------------ decode GEMV
constexpr int GV_COLS = 128;                 // columns of a block
constexpr int GV_LANE_COLS = 16;             // columns of a thread
constexpr int GV_COL_LANES = GV_COLS / GV_LANE_COLS;   // 8
constexpr int GV_ROW_LANES = GV_NT / GV_COL_LANES;        // 32
constexpr int GV_MAX_M = 8;
// A block's shared memory: x's MT rows over the block's K range of at
// most 8192 / MT rows (32 KB, later reused for the 8 warps' partial sums,
// 8 * MT * 128 floats), then a ring of GV_STAGES 16-byte slots for each
// thread, which asynchronous copies fill with the thread's next rows of
// w: the bytes in flight live in shared memory, not in registers (at MT 8
// the 128 accumulators take those).
constexpr int GV_SMEM_FLOATS = 8192;
constexpr int GV_STAGES = 8;
constexpr int GV_SMEM_BYTES = GV_SMEM_FLOATS * 4 + GV_STAGES * GV_NT * 16;
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

// The block's GV_COLS columns from its warps' partial sums red[w][m][c] (m
// < MT, added in warp order): with one K split, y through the epilogue;
// else each block writes its partials to ws, and the last block of the
// column tile to finish (a counter per tile, the threadfence-reduction
// pattern) adds them in split order, so the result does not depend on
// which block ran first, and sets its counter back to 0.
template <typename T, int MT>
__device__ __forceinline__ void finish_tile(const float* red,
                                            const float* __restrict__ s,
                                            const T* __restrict__ bias,
                                            T* __restrict__ y,
                                            float* __restrict__ ws,
                                            unsigned* __restrict__ counters,
                                            int M, int N, float qmax) {
  // outputs a thread: o = tid + GV_NT u
  constexpr int PER = (MT * GV_COLS + GV_NT - 1) / GV_NT;
  __shared__ bool last;
  const int tid = threadIdx.x;
  const bool split = gridDim.y > 1;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int o = tid + GV_NT * u;
    const int m = o / GV_COLS, c = o % GV_COLS;
    const int n = blockIdx.x * GV_COLS + c;
    if (o >= MT * GV_COLS) break;
    float v = 0.f;
#pragma unroll
    for (int wp = 0; wp < GV_NT / 32; ++wp)
      v += red[(wp * MT + m) * GV_COLS + c];
    if (m < M && n < N) {
      if (split)
        ws[((size_t)blockIdx.y * M + m) * N + n] = v;
      else
        y[(size_t)m * N + n] = epilogue(v, s[n], qmax, bias, n);
    }
  }
  if (!split) return;

  // the last block of this column tile adds the K splits' partials: each
  // thread's outputs split by split, their loads all independent (and the
  // scales beside them), so they are in flight together
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(&counters[blockIdx.x], 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float v[PER], sc[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int o = tid + GV_NT * u, n = blockIdx.x * GV_COLS + o % GV_COLS;
    v[u] = 0.f;
    sc[u] = o < M * GV_COLS && n < N ? s[n] : 0.f;
  }
#pragma unroll 4
  for (int ks = 0; ks < (int)gridDim.y; ++ks) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int o = tid + GV_NT * u, m = o / GV_COLS;
      const int n = blockIdx.x * GV_COLS + o % GV_COLS;
      if (o < M * GV_COLS && n < N)
        v[u] += __ldcg(&ws[((size_t)ks * M + m) * N + n]);
    }
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int o = tid + GV_NT * u, m = o / GV_COLS;
    const int n = blockIdx.x * GV_COLS + o % GV_COLS;
    if (o < M * GV_COLS && n < N)
      y[(size_t)m * N + n] = epilogue(v[u], sc[u], qmax, bias, n);
  }
  if (tid == 0) counters[blockIdx.x] = 0u;
}

// Grid (ceil(N / 128), K splits of k_per_split <= 8192 / MT rows), dynamic
// shared memory GV_SMEM_BYTES. MT >= M rows of x are computed (the rows
// past M are zero). VEC: N % 16 == 0 and w 16-byte aligned. Row lane rl
// takes rows kbeg + rl + 32 t.
template <typename T, int MT, bool VEC>
__global__ void __launch_bounds__(GV_NT)
    wo_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ s, const T* __restrict__ bias,
                   T* __restrict__ y, float* __restrict__ ws,
                   unsigned* __restrict__ counters, int M, int K, int N,
                   int k_per_split, float qmax) {
  extern __shared__ __align__(16) unsigned char gv_smem[];
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
    fetch_w16<VEC>(&ring[t * GV_NT + tid], w, kbeg + rl + GV_ROW_LANES * t, n0,
                   kend, N);
    cp_async_commit();
  }
  for (int base = 0; base < MT * kp; base += GV_X_LOADS * GV_NT) {
    float v[GV_X_LOADS];
#pragma unroll
    for (int u = 0; u < GV_X_LOADS; ++u) {
      const int i = base + u * GV_NT + tid, m = i / kp;
      v[u] = (i < MT * kp && m < M)
                 ? to_f(x[(size_t)m * K + kbeg + i - m * kp]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < GV_X_LOADS; ++u) {
      const int i = base + u * GV_NT + tid, m = i / kp;
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
    uint4* slot = &ring[(t % GV_STAGES) * GV_NT + tid];
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
  finish_tile<T, MT>(&red[0][0][0], s, bias, y, ws, counters, M, N, qmax);
}

// ------------------------------------------- bf16 decode, tensor cores
constexpr int MMA_NT = 128;            // threads a block
constexpr int MMA_NW = MMA_NT / 32;    // warps a block
constexpr int MMA_KSTEP = 16;          // rows of K a warp takes a step
constexpr int MMA_AHEAD = 2;           // steps a thread keeps in flight
// the K splits of a column tile form one thread-block cluster, of at most
// the portable size
constexpr int MMA_MAX_SPLITS = 8;

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += A * B on one m16n8k16 tile: bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Word q of the thread's four rows of a step (columns 4q .. 4q+3 of its 16)
// into the A fragments of mmas 2q (columns 4q, 4q+1) and 2q+1 (4q+2, 4q+3),
// by the column and k maps of the note at the top.
__device__ __forceinline__ void mma_word(float (&c0)[4], float (&c1)[4],
                                         uint32_t r0, uint32_t r1,
                                         uint32_t r2, uint32_t r3,
                                         uint32_t b0, uint32_t b1) {
  float f0[4], f1[4], f2[4], f3[4];
  i8x4_to_f32(r0, f0);
  i8x4_to_f32(r1, f1);
  i8x4_to_f32(r2, f2);
  i8x4_to_f32(r3, f3);
  mma_bf16(c0, bf16x2(f0[0], f1[0]), bf16x2(f0[1], f1[1]),
           bf16x2(f2[0], f3[0]), bf16x2(f2[1], f3[1]), b0, b1);
  mma_bf16(c1, bf16x2(f0[2], f1[2]), bf16x2(f0[3], f1[3]),
           bf16x2(f2[2], f3[2]), bf16x2(f2[3], f3[3]), b0, b1);
}

// A step's operands in one thread's registers: its four rows of w at its
// 16 columns, and x's row g at the step's k 4t .. 4t+3 (B's two registers)
struct Step {
  uint4 w[4];
  uint2 x;
};

// The block's 128 columns from its warps' partial sums red[w][m][c] when
// the K splits of the tile are one cluster (rank q = blockIdx.y): each
// block adds its warps in order into red's first [8][128], then, after
// the cluster's barrier, rank r adds the ranks' sums in rank order for
// the outputs o = tid + 128 (r + S i) (S ranks) through distributed shared
// memory, applies the epilogue and stores them; a second barrier keeps
// every block's shared memory alive until the others have read it.
__device__ __forceinline__ void cluster_finish(
    float* red, const float* __restrict__ s,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y,
    int M, int N, float qmax) {
  namespace cg = cooperative_groups;
  constexpr int OUTS = GV_MAX_M * GV_COLS;
  constexpr int PER = OUTS / MMA_NT;
  const int tid = threadIdx.x;
  float part[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int o = tid + MMA_NT * u;
    float v = 0.f;
#pragma unroll
    for (int wp = 0; wp < MMA_NW; ++wp) v += red[wp * OUTS + o];
    part[u] = v;
  }
  __syncthreads();                 // every read of the warps' sums is done
#pragma unroll
  for (int u = 0; u < PER; ++u) red[tid + MMA_NT * u] = part[u];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int ranks = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  for (int o = tid + MMA_NT * r; o < M * GV_COLS; o += MMA_NT * ranks) {
    const int n = blockIdx.x * GV_COLS + o % GV_COLS;
    if (n >= N) continue;
    float v = 0.f;
    for (int q = 0; q < ranks; ++q) v += cluster.map_shared_rank(red, q)[o];
    y[(size_t)(o / GV_COLS) * N + n] = epilogue(v, s[n], qmax, bias, n);
  }
  cluster.sync();
}

// Grid (ceil(N / 128), K splits of k_per_split rows, a multiple of 128), 128
// threads; the splits of a tile are one cluster (1, splits, 1). Warp w
// takes the block's steps w, w + 4, ... (16 rows each).
// VEC: N % 16 == 0 and w 16-byte aligned (16-byte loads of w, else byte by
// byte); XVEC: K % 4 == 0 and x 8-byte aligned (8-byte loads of x, else
// element by element).
template <bool VEC, bool XVEC>
__global__ void __launch_bounds__(MMA_NT, 512 / MMA_NT)
    wo_gemv_mma_kernel(const __nv_bfloat16* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ s,
                       const __nv_bfloat16* __restrict__ bias,
                       __nv_bfloat16* __restrict__ y, int M, int K, int N,
                       int k_per_split, float qmax) {
  __shared__ __align__(16) float red[MMA_NW * GV_MAX_M * GV_COLS];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * GV_COLS + 16 * g;  // this thread's columns
  const int kbeg = blockIdx.y * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const int steps = (kend - kbeg + MMA_KSTEP - 1) / MMA_KSTEP;
  const int mine = warp < steps ? (steps - warp + MMA_NW - 1) / MMA_NW : 0;
  const __nv_bfloat16* xrow = x + (size_t)min(g, M - 1) * K;

  // this warp's step i: rows k .. k+3 of this thread's 16 columns, k =
  // kbeg + 16 (warp + 4 i) + 4t, and x's row g there (zeros past the
  // split, N or M)
  auto load_step = [&](Step& st, int i) {
    const int k = kbeg + MMA_KSTEP * (warp + MMA_NW * i) + 4 * t;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (!VEC)
        st.w[r] = load_w16(w, k + r, n0, kend, N);
      else if (k + r < kend && n0 < N)
        st.w[r] = __ldg(reinterpret_cast<const uint4*>(
            w + (size_t)(k + r) * N + n0));
      else
        st.w[r] = make_uint4(0u, 0u, 0u, 0u);
    }
    st.x = make_uint2(0u, 0u);
    if (g < M) {
      if (XVEC) {
        // k and kend are multiples of 4: the 4 values are wholly in range
        if (k < kend) st.x = __ldg(reinterpret_cast<const uint2*>(xrow + k));
      } else {
        uint32_t h[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          h[e] = k + e < kend ? __bfloat16_as_ushort(xrow[k + e]) : 0u;
        st.x = make_uint2(h[0] | h[1] << 16, h[2] | h[3] << 16);
      }
    }
  };
  Step ahead[MMA_AHEAD];
#pragma unroll
  for (int a = 0; a < MMA_AHEAD; ++a) load_step(ahead[a], a);

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int i = 0; i < mine; i += MMA_AHEAD) {
#pragma unroll
    for (int a = 0; a < MMA_AHEAD; ++a) {
      if (i + a < mine) {
        const Step st = ahead[a];
        mma_word(acc[0], acc[1], st.w[0].x, st.w[1].x, st.w[2].x, st.w[3].x,
                 st.x.x, st.x.y);
        mma_word(acc[2], acc[3], st.w[0].y, st.w[1].y, st.w[2].y, st.w[3].y,
                 st.x.x, st.x.y);
        mma_word(acc[4], acc[5], st.w[0].z, st.w[1].z, st.w[2].z, st.w[3].z,
                 st.x.x, st.x.y);
        mma_word(acc[6], acc[7], st.w[0].w, st.w[1].w, st.w[2].w, st.w[3].w,
                 st.x.x, st.x.y);
        // the registers are in the mmas' operands: load the step
        // MMA_AHEAD further on into them
        load_step(ahead[a], i + a + MMA_AHEAD);
      }
    }
  }

  // warp w's sums, red[w][m][c]: mma j gives rows 2t, 2t+1 of x at
  // columns 16g + 2j (c0, c1) and 16g + 2j + 1 (c2, c3)
  float* mine_red = red + warp * GV_MAX_M * GV_COLS;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 16 * g + 2 * j;
    *reinterpret_cast<float2*>(&mine_red[(2 * t) * GV_COLS + c]) =
        make_float2(acc[j][0], acc[j][2]);
    *reinterpret_cast<float2*>(&mine_red[(2 * t + 1) * GV_COLS + c]) =
        make_float2(acc[j][1], acc[j][3]);
  }
  __syncthreads();
  cluster_finish(red, s, bias, y, M, N, qmax);
}

// ---------------------------------------------- prefill GEMM, TF32 mma
constexpr int GM_NT = 256;             // 8 warps, 32 x 64 outputs each
constexpr int GM_BK = 32;              // rows of K a k-step
constexpr int GM_STAGES = 3;
constexpr int GM_XP = GM_BK + 4;       // a row of x's tile in shared, floats
// the K splits of an output tile form one thread-block cluster, of at most
// the portable size
constexpr int GM_MAX_SPLITS = 8;
// k-steps (2048 rows of K) one mma accumulator takes before it is added
// into the second sum
constexpr int GM_CHUNK = 64;

// A block's tile for WM of its 8 warps along M: 32 WM rows x 64 (8 / WM)
// columns; w's rows in shared are BN + 32 bytes
// (a multiple of 16 for cp.async, and 8 words past a multiple of 32 banks,
// so the B reads of rows t and t + 4 hit 32 different banks), the split
// partial tile's BN + 4 floats (16-byte stores of a quarter warp in
// different banks).
template <int WM>
struct GemmTile {
  static constexpr int BM = 32 * WM, BN = 64 * (8 / WM);
  static constexpr int WP = BN + 32, RP = BN + 4;
  static constexpr int X_BYTES = BM * GM_XP * 4;
  static constexpr int STAGE_BYTES = X_BYTES + GM_BK * WP;
  static constexpr int SMEM_BYTES = GM_STAGES * STAGE_BYTES > BM * RP * 4
                                        ? GM_STAGES * STAGE_BYTES
                                        : BM * RP * 4;
};

// x's type sets the tile: f32 32 x 512 (1 warp along M), bf16 128 x 128 (4)
template <typename T>
using GemmTileOf = GemmTile<std::is_same<T, float>::value ? 1 : 4>;

// One k-step (GM_BK rows of K from k0) of x and w into the stage buffers xs
// [BM][GM_XP] f32 and ws [GM_BK][WP] int8, zero past M, kend and N:
// by 16-byte cp.async where XVEC (f32 x, K % 4 == 0, 16-byte aligned) and
// WVEC (N % 16 == 0, 16-byte aligned), else element by element through
// registers (x widened to f32 on the way: a bf16 value is exact there; w
// byte by byte).
template <typename T, bool XVEC, bool WVEC>
__device__ __forceinline__ void gemm_stage(float* xs, uint8_t* ws,
                                           const T* __restrict__ x,
                                           const int8_t* __restrict__ w,
                                           int m0, int n0, int k0, int kend,
                                           int M, int K, int N) {
  using Tile = GemmTileOf<T>;
  const int tid = threadIdx.x;
  if constexpr (XVEC) {
    constexpr int CH = GM_BK / 4;   // 16-byte chunks a row
#pragma unroll
    for (int u = 0; u < Tile::BM * CH / GM_NT; ++u) {
      const int i = tid + GM_NT * u, r = i / CH, c = (i % CH) * 4;
      // kend is a multiple of 4: a chunk lies wholly in or out
      const bool in = m0 + r < M && k0 + c < kend;
      cp_async16(xs + r * GM_XP + c,
                 in ? x + (size_t)(m0 + r) * K + k0 + c : x, in);
    }
  } else {
#pragma unroll 4
    for (int u = 0; u < Tile::BM * GM_BK / GM_NT; ++u) {
      const int i = tid + GM_NT * u, r = i / GM_BK, c = i % GM_BK;
      xs[r * GM_XP + c] = m0 + r < M && k0 + c < kend
                              ? to_f(x[(size_t)(m0 + r) * K + k0 + c])
                              : 0.f;
    }
  }
  if constexpr (WVEC) {
    constexpr int CH = Tile::BN / 16;
#pragma unroll
    for (int u = 0; u < GM_BK * CH / GM_NT; ++u) {
      const int i = tid + GM_NT * u, r = i / CH, c = (i % CH) * 16;
      const bool in = k0 + r < kend && n0 + c < N;
      cp_async16(ws + r * Tile::WP + c,
                 in ? w + (size_t)(k0 + r) * N + n0 + c : w, in);
    }
  } else {
    constexpr int CH = Tile::BN / 4;   // 4-byte words a row
#pragma unroll
    for (int u = 0; u < GM_BK * CH / GM_NT; ++u) {
      const int i = tid + GM_NT * u, r = i / CH, c = (i % CH) * 4;
      uint32_t word = 0u;
      if (k0 + r < kend) {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (n0 + c + b < N)
            word |= (uint32_t)(uint8_t)__ldg(w + (size_t)(k0 + r) * N + n0 +
                                             c + b) << (8 * b);
      }
      *reinterpret_cast<uint32_t*>(ws + r * Tile::WP + c) = word;
    }
  }
}

// The warp's products of one stage: rows wm*32 + 16 mt + (g, g+8) of x's
// tile against the 64 columns of w's tile at wn*64, in two groups q of 32.
// The n8 tile j of group q stands for the columns 32q + 4n + j (n < 8), so
// that B's elements (k t, n g) and (k t+4, n g) are byte j of the words at
// rows t and t+4, columns 32q + 4g .. 32q + 4g + 3: two 32-bit shared loads
// give the thread its B values for all four n-tiles of a group, widened
// exactly (wo::i8x4_to_f32). A's fragments are split once (PASSES 2, f32 x:
// x_small*w, then x_big*w, exact since w is) or taken as they are (PASSES 1,
// bf16 x) and serve the warp's 8 n-tiles. Row tiles wholly past M (live)
// are skipped.
template <int WM, int PASSES>
__device__ __forceinline__ void gemm_step(float (&acc)[2][8][4],
                                          const float* xs, const uint8_t* ws,
                                          int wm, int wn, int g, int t,
                                          const bool (&live)[2]) {
  const float* X = xs + (wm * 32 + g) * GM_XP + t;
  constexpr int WP = GemmTile<WM>::WP;
  const uint8_t* W = ws + t * WP + wn * 64 + 4 * g;
#pragma unroll
  for (int kk = 0; kk < GM_BK; kk += 8) {
    float b[2][2][4];   // [group q][rows t, t+4][byte j]
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        i8x4_to_f32(*reinterpret_cast<const uint32_t*>(
                        W + (kk + 4 * h) * WP + 32 * q),
                    b[q][h]);
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float* a = X + 16 * mt * GM_XP + kk;
      const float v[4] = {a[0], a[8 * GM_XP], a[4], a[8 * GM_XP + 4]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (PASSES == 2)
          split(v[e], ab[mt][e], as[mt][e]);
        else
          ab[mt][e] = __float_as_uint(v[e]);
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t b0 = __float_as_uint(b[q][0][j]);
        const uint32_t b1 = __float_as_uint(b[q][1][j]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (!live[mt]) continue;
          if (PASSES == 2) mma_tf32(acc[mt][4 * q + j], as[mt], b0, b1);
          mma_tf32(acc[mt][4 * q + j], ab[mt], b0, b1);
        }
      }
  }
}

// y's row, columns col .. col+7, from the f32 sums v through the epilogue;
// two 16-byte stores where the run lies inside N and y's rows are 16-byte
// runs (vec)
template <typename T>
__device__ __forceinline__ void store_run(T* __restrict__ y,
                                          const float* __restrict__ s,
                                          const T* __restrict__ bias,
                                          float qmax, int row, int col,
                                          int N, const float (&v)[8],
                                          bool vec) {
  T* out = y + (size_t)row * N;
  if constexpr (std::is_same<T, float>::value) {
    if (vec && col + 8 <= N) {
      float r[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        r[e] = epilogue(v[e], s[col + e], qmax, bias, col + e);
      *reinterpret_cast<float4*>(out + col) =
          make_float4(r[0], r[1], r[2], r[3]);
      *reinterpret_cast<float4*>(out + col + 4) =
          make_float4(r[4], r[5], r[6], r[7]);
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (col + e < N) out[col + e] = epilogue(v[e], s[col + e], qmax, bias,
                                             col + e);
}

// Grid (ceil(M / BM), ceil(N / BN), K splits of k_per_split rows, a
// multiple of 32), GM_NT threads, GemmTileOf<T>::SMEM_BYTES of dynamic
// shared memory; with more than one split, the splits of an output tile are
// one thread-block cluster (1, 1, splits). Warp w owns rows 32 (w % WM) ..
// +31 and columns 64 (w / WM) .. +63 of the block's tile. f32 x runs two
// TF32 passes, bf16 x one.
template <typename T, bool XVEC, bool WVEC>
__global__ void __launch_bounds__(GM_NT, 2)
    wo_gemm_tf32_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                        const float* __restrict__ s,
                        const T* __restrict__ bias, T* __restrict__ y, int M,
                        int K, int N, int k_per_split, float qmax) {
  using Tile = GemmTileOf<T>;
  constexpr int WM = Tile::BM / 32;
  constexpr int PASSES = std::is_same<T, float>::value ? 2 : 1;
  extern __shared__ __align__(16) unsigned char gm_smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp % WM, wn = warp / WM;
  const int m0 = blockIdx.x * Tile::BM, n0 = blockIdx.y * Tile::BN;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const int steps = (kend - kbeg + GM_BK - 1) / GM_BK;
  const bool live[2] = {m0 + wm * 32 < M, m0 + wm * 32 + 16 < M};
  auto xs = [&](int st) {
    return reinterpret_cast<float*>(gm_smem + st * Tile::STAGE_BYTES);
  };
  auto ws = [&](int st) {
    return reinterpret_cast<uint8_t*>(gm_smem + st * Tile::STAGE_BYTES +
                                      Tile::X_BYTES);
  };

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  // the second sum of a walk past GM_CHUNK k-steps: in local memory, since
  // the loop holds every register, and touched once a chunk
  volatile float outer[2 * 8 * 4];
  const bool chunked = steps > GM_CHUNK;
  if (chunked)
#pragma unroll
    for (int o = 0; o < 2 * 8 * 4; ++o) outer[o] = 0.f;

  // a ring of GM_STAGES k-steps: GM_STAGES - 1 in flight while one is used
#pragma unroll
  for (int st = 0; st < GM_STAGES - 1; ++st) {
    if (st < steps)
      gemm_stage<T, XVEC, WVEC>(xs(st), ws(st), x, w, m0, n0,
                                kbeg + st * GM_BK, kend, M, K, N);
    cp_async_commit();
  }
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<GM_STAGES - 2>();
    __syncthreads();   // step i has landed; step i - 1's readers are done
    const int nx = i + GM_STAGES - 1;
    if (nx < steps)
      gemm_stage<T, XVEC, WVEC>(xs(nx % GM_STAGES), ws(nx % GM_STAGES), x, w,
                                m0, n0, kbeg + nx * GM_BK, kend, M, K, N);
    cp_async_commit();
    gemm_step<WM, PASSES>(acc, xs(i % GM_STAGES), ws(i % GM_STAGES), wm, wn, g,
                          t, live);
    if (chunked && (i + 1) % GM_CHUNK == 0 && i + 1 < steps)
#pragma unroll
      for (int o = 0; o < 2 * 8 * 4; ++o) {
        float& a = acc[o / 32][o / 4 % 8][o % 4];
        outer[o] = outer[o] + a;
        a = 0.f;
      }
  }
  cp_async_wait<0>();
  if (chunked)
#pragma unroll
    for (int o = 0; o < 2 * 8 * 4; ++o) {
      float& a = acc[o / 32][o / 4 % 8][o % 4];
      a = outer[o] + a;
    }

  // the C fragment of n-tile 4q + j holds rows g (c0, c1) and g+8 (c2,
  // c3) at the columns 32q + 8t + j (c0, c2) and 32q + 8t + 4 + j (c1, c3):
  // eight neighbouring columns a row
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (gridDim.z == 1) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + 16 * mt + 8 * h + g;
        if (row >= M) continue;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float v[8];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            v[j] = acc[mt][4 * q + j][2 * h];
            v[4 + j] = acc[mt][4 * q + j][2 * h + 1];
          }
          store_run(y, s, bias, qmax, row, n0 + wn * 64 + 32 * q + 8 * t, N,
                    v, vec);
        }
      }
    return;
  }

  // K splits: each block's partial tile in its shared memory, then after
  // the cluster's barrier rank r adds the ranks' tiles in rank (split)
  // order for its share of the outputs through distributed shared memory,
  // so the result does not depend on which block ran first; a second
  // barrier keeps every block's shared memory alive until the others have
  // read it
  namespace cg = cooperative_groups;
  __syncthreads();   // every warp is done with the ring
  float* red = reinterpret_cast<float*>(gm_smem);   // [BM][RP]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float* p = red + (wm * 32 + 16 * mt + 8 * h + g) * Tile::RP + wn * 64 +
                   32 * q + 8 * t;
        const float(&c)[8][4] = acc[mt];
        *reinterpret_cast<float4*>(p) =
            make_float4(c[4 * q][2 * h], c[4 * q + 1][2 * h],
                        c[4 * q + 2][2 * h], c[4 * q + 3][2 * h]);
        *reinterpret_cast<float4*>(p + 4) =
            make_float4(c[4 * q][2 * h + 1], c[4 * q + 1][2 * h + 1],
                        c[4 * q + 2][2 * h + 1], c[4 * q + 3][2 * h + 1]);
      }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int ranks = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  for (int o = 4 * (tid + GM_NT * r); o < Tile::BM * Tile::BN;
       o += 4 * GM_NT * ranks) {
    const int lr = o / Tile::BN, lc = o % Tile::BN, row = m0 + lr;
    if (row >= M || n0 + lc >= N) continue;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int qr = 0; qr < ranks; ++qr) {
      const float4 p = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(red, qr) + lr * Tile::RP + lc);
      v[0] += p.x;
      v[1] += p.y;
      v[2] += p.z;
      v[3] += p.w;
    }
    T* out = y + (size_t)row * N;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + lc + e;
      if (n < N) out[n] = epilogue(v[e], s[n], qmax, bias, n);
    }
  }
  cluster.sync();
}

// The prefill kernel for (T, xvec, wvec): xvec only for f32 x
template <typename T>
auto gemm_kernel(bool xvec, bool wvec) {
  if constexpr (std::is_same<T, float>::value) {
    if (xvec)
      return wvec ? wo_gemm_tf32_kernel<T, true, true>
                  : wo_gemm_tf32_kernel<T, true, false>;
  }
  return wvec ? wo_gemm_tf32_kernel<T, false, true>
              : wo_gemm_tf32_kernel<T, false, false>;
}

template <typename T>
int launch_gemm(const T* x, const int8_t* w, const float* s, const T* bias,
                T* y, int M, int K, int N, int k_per_split, float qmax,
                cudaStream_t st) {
  using Tile = GemmTileOf<T>;
  if (k_per_split % GM_BK != 0) return cudaErrorInvalidValue;
  const dim3 grid((M + Tile::BM - 1) / Tile::BM, (N + Tile::BN - 1) / Tile::BN,
                  (K + k_per_split - 1) / k_per_split);
  if (grid.z > GM_MAX_SPLITS) return cudaErrorInvalidValue;
  const bool xvec = std::is_same<T, float>::value && K % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool wvec = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  auto kernel = gemm_kernel<T>(xvec, wvec);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(GM_NT);
  cfg.dynamicSmemBytes = Tile::SMEM_BYTES;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = grid.z;
  cfg.attrs = cluster;
  cfg.numAttrs = grid.z > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, x, w, s, bias, y, M, K, N,
                           k_per_split, qmax);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the kernel with 16-byte copies of w (and of x in f32), whose occupancy
// the others share
template <typename T>
int gemm_occupancy(int* blocks) {
  auto kernel = gemm_kernel<T>(true, true);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      GemmTileOf<T>::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, GM_NT, GemmTileOf<T>::SMEM_BYTES);
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
  gemv_kernel<T, MT>(vec)<<<grid, GV_NT, GV_SMEM_BYTES, st>>>(
      x, w, s, bias, y, ws, counters, M, K, N, k_per_split, qmax);
}

// The f32 decode kernel for M <= 8 rows (bf16 decode is wo_gemv_mma's,
// prefill wo_gemm_tf32's)
int launch_gemv_f32(const float* x, const int8_t* w, const float* s,
                    const float* bias, float* y, float* ws,
                    unsigned* counters, int M, int K, int N, int k_per_split,
                    float qmax, cudaStream_t st) {
  const int mt = M == 1 ? 1 : M == 2 ? 2 : M <= 4 ? 4 : 8;
  if (k_per_split > GV_SMEM_FLOATS / mt) return cudaErrorInvalidValue;
  const dim3 grid((N + GV_COLS - 1) / GV_COLS,
                  (K + k_per_split - 1) / k_per_split);
  if (grid.y > 1 && (ws == nullptr || counters == nullptr))
    return cudaErrorInvalidValue;
  const bool vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (M == 1)
    launch_gemv<float, 1>(grid, st, vec, x, w, s, bias, y, ws, counters, M,
                          K, N, k_per_split, qmax);
  else if (M == 2)
    launch_gemv<float, 2>(grid, st, vec, x, w, s, bias, y, ws, counters, M,
                          K, N, k_per_split, qmax);
  else if (M <= 4)
    launch_gemv<float, 4>(grid, st, vec, x, w, s, bias, y, ws, counters, M,
                          K, N, k_per_split, qmax);
  else
    launch_gemv<float, 8>(grid, st, vec, x, w, s, bias, y, ws, counters, M,
                          K, N, k_per_split, qmax);
  return cudaGetLastError();
}

template <typename T, int MT>
int gemv_occupancy(bool vec, int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, gemv_kernel<T, MT>(vec), GV_NT, GV_SMEM_BYTES);
}

template <typename T>
int gemv_occupancy(int M, bool vec, int* blocks) {
  if (M == 1) return gemv_occupancy<T, 1>(vec, blocks);
  if (M == 2) return gemv_occupancy<T, 2>(vec, blocks);
  if (M <= 4) return gemv_occupancy<T, 4>(vec, blocks);
  return gemv_occupancy<T, 8>(vec, blocks);
}

}  // namespace

// The f32 decode on the CUDA cores (wo_gemv_kernel): x [M, K] f32 (dtype 0;
// bf16 decode is wo_gemv_mma's, prefill wo_gemm_tf32's) with 1 <= M <= 8, w
// [K, N] int8, s [N] f32, bias [N] f32 or null, y [M, N] f32, all contiguous
// on the current device. For K > k_per_split, ws holds ceil(K / k_per_split)
// * M * N f32 and counters ceil(N / 128) zeroed u32 (left zeroed); else both
// may be null.
extern "C" int wo_matmul(const void* x, const void* w, const void* s,
                         const void* bias, void* y, void* ws, void* counters,
                         int M, int K, int N, int k_per_split, float qmax,
                         int dtype, void* stream) {
  if (M <= 0 || M > GV_MAX_M || N <= 0 || K <= 0 || k_per_split <= 0 ||
      dtype != 0)
    return cudaErrorInvalidValue;
  return launch_gemv_f32(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(s), static_cast<const float*>(bias),
      static_cast<float*>(y), static_cast<float*>(ws),
      static_cast<unsigned*>(counters), M, K, N, k_per_split, qmax,
      static_cast<cudaStream_t>(stream));
}

// Blocks of the CUDA-core decode kernel (f32, dtype 0) for M (<= 8) rows
// that one SM holds at once, on the current device; vec: N % 16 == 0. The
// wrapper splits K so that one wave fills the card.
extern "C" int wo_gemv_blocks_per_sm(int M, int vec, int dtype,
                                     int* blocks) {
  if (M <= 0 || M > GV_MAX_M) return cudaErrorInvalidValue;
  if (dtype == 0) return gemv_occupancy<float>(M, vec != 0, blocks);
  return cudaErrorInvalidValue;
}

// The prefill GEMM on the tensor cores (wo_gemm_tf32_kernel): x [M, K] (dtype
// 0: f32, any M, a 32 x 512 tile a block; 1: bf16, for rows off TMA's
// 16-byte rule, 128 x 128), w [K, N] int8, s [N] f32, bias [N] in x's type
// or null, y [M, N] in x's type, all contiguous on the current device (any
// alignment). k_per_split is a multiple of 32 and K takes at most 8 of them
// (the splits of a tile are one cluster); a split may take any number of
// rows.
extern "C" int wo_gemm_tf32(const void* x, const void* w, const void* s,
                            const void* bias, void* y, int M, int K, int N,
                            int k_per_split, float qmax, int dtype,
                            void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || k_per_split <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* wi = static_cast<const int8_t*>(w);
  const float* sf = static_cast<const float*>(s);
  if (dtype == 0)
    return launch_gemm<float>(
        static_cast<const float*>(x), wi, sf, static_cast<const float*>(bias),
        static_cast<float*>(y), M, K, N, k_per_split, qmax, st);
  if (dtype == 1)
    return launch_gemm<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x), wi, sf,
        static_cast<const __nv_bfloat16*>(bias),
        static_cast<__nv_bfloat16*>(y), M, K, N, k_per_split, qmax, st);
  return cudaErrorInvalidValue;
}

// Blocks of the prefill GEMM for x of dtype (0 f32, 1 bf16) that one SM
// holds at once, on the current device. The wrapper splits K when the
// output tiles fill under half of them.
extern "C" int wo_gemm_blocks_per_sm(int dtype, int* blocks) {
  if (dtype == 0) return gemm_occupancy<float>(blocks);
  if (dtype == 1) return gemm_occupancy<__nv_bfloat16>(blocks);
  return cudaErrorInvalidValue;
}

// The bf16 decode on the tensor cores (wo_gemv_mma_kernel): x [M, K] bf16
// with 1 <= M <= 8, w [K, N] int8, s [N] f32, bias [N] bf16 or null, y [M,
// N] bf16, all contiguous on the current device (any alignment). k_per_split
// is a multiple of 128, and K takes at most MMA_MAX_SPLITS of them (the
// splits of a column tile are one cluster).
extern "C" int wo_gemv_mma(const void* x, const void* w, const void* s,
                           const void* bias, void* y, int M, int K, int N,
                           int k_per_split, float qmax, void* stream) {
  if (M <= 0 || M > GV_MAX_M || N <= 0 || K <= 0 || k_per_split <= 0 ||
      k_per_split % 128 != 0)
    return cudaErrorInvalidValue;
  const dim3 grid((N + GV_COLS - 1) / GV_COLS,
                  (K + k_per_split - 1) / k_per_split);
  if (grid.y > MMA_MAX_SPLITS) return cudaErrorInvalidValue;
  const bool vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bool xvec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0;
  auto kernel = vec ? (xvec ? wo_gemv_mma_kernel<true, true>
                            : wo_gemv_mma_kernel<true, false>)
                    : (xvec ? wo_gemv_mma_kernel<false, true>
                            : wo_gemv_mma_kernel<false, false>);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(MMA_NT);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = grid.y;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(x),
      static_cast<const int8_t*>(w), static_cast<const float*>(s),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(y), M, K, N, k_per_split, qmax);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Blocks of the tensor-core decode kernel that one SM holds at once, on the
// current device; vec: N % 16 == 0. The wrapper splits K to fill whole
// waves of them.
extern "C" int wo_gemv_mma_blocks_per_sm(int vec, int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks,
      vec ? wo_gemv_mma_kernel<true, true> : wo_gemv_mma_kernel<false, true>,
      MMA_NT, 0);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
