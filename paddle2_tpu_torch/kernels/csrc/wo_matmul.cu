// Int8 weight-only matmul for Hopper (sm_90a), on the tensor cores
// (mma.sync): decode in bf16 (`wo_gemv_mma_kernel`) and in f32 in two TF32
// passes (`wo_gemv_tf32_kernel`), prefill in f32 in two TF32 passes and in
// bf16 off TMA's rule (`wo_gemm_tf32_kernel`).
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
// value is exact in f32, bf16 and TF32, and a bf16 times an int8 one is
// exact in f32), the scale is applied once per column after the sum and the
// bias is added in f32 before the one cast, as the Pallas kernel and its
// wrapper do. The kernels and their plain version therefore differ only in
// the order of summation, and in f32 in the TF32 products: an f32 x is
// split once as it enters a fragment into big (rounded to TF32) and small
// = x - big (tf32x3.cuh's split), and each product is x_small*w + x_big*w,
// two mma a product (not the three of error-compensated TF32 with two
// inexact operands), within about 2^-21 of its f32 value. One pass on f32
// x (about 2^-11) reads past the f32 limit; chip_smoke.py gates that.
//
// What bounds it on the H100, and what the design does about it:
//
// * Decode (M <= 8) is bound by the weight bytes: K*N int8 bytes against
//   2*M*K*N operations. On the CUDA cores that is not so at M 8: every
//   weight byte costs 8 FMAs and its widening, about as long as the byte
//   takes to arrive, and 128 f32 accumulators a thread cap the blocks an
//   SM holds. So both decode kernels run on the tensor cores, one body
//   (`decode_tile`) for both types:
//
//   - The product is swapped, y^T = w^T x^T: 16 columns of w are the A
//     operand's rows, x's <= 8 rows the n8 side (rows past M are zero), so
//     at M 8 no tensor-core work is wasted. bf16 runs mma.sync m16n8k16
//     (bf16 in, f32 sums), f32 m16n8k8 with TF32 operands in two passes
//     into the same accumulators (x_small, then x_big).
//   - A warp owns a 128-column tile of w and takes 16 rows of K a step. Its
//     thread (g = lane / 4, t = lane % 4) loads rows 4t .. 4t+3 of the step
//     at columns 16g .. 16g+15 (four 16-byte loads; a warp reads four whole
//     128-byte rows each time) and widens them straight into its A
//     fragments (wo::i8x4_to_f32), with no shared-memory transpose, by two
//     maps the mma leaves free. The column map: in the step's mma j
//     (0..7), A row g stands for column 16g + 2j of the tile and A row g+8
//     for 16g + 2j + 1. The k map, bf16: A's (and B's) k slots 2t, 2t+1,
//     2t+8, 2t+9 stand for the step's rows 4t, 4t+1, 4t+2, 4t+3, so
//     register a0 of mma j packs rows 4t and 4t+1 at column 16g + 2j, a1
//     the same rows at the next column, a2 and a3 rows 4t+2 and 4t+3, and
//     B's registers b0, b1 are x's row g at the step's k 4t .. 4t+3, one
//     8-byte load of x (from L2: x is a few KB). The k map, f32: the step's
//     16 rows are two k8 mmas; in the first, k slots t and t+4 stand for
//     rows 4t and 4t+1, in the second for rows 4t+2 and 4t+3, so B's two
//     registers are neighbouring values of x's row g and one 16-byte load
//     of x feeds both. The accumulators come back as rows 2t, 2t+1 of x and
//     the thread's own 16 columns: 32 registers a thread, in both types.
//   - Widening stays exact: wo::i8x4_to_f32, then a bf16 pair
//     (cvt.rn.bf16x2.f32, exact for every int8 value); in f32 the widened
//     floats are TF32 operands as they are.
//   - Loads go straight to registers, ahead of the mmas (2 KB a warp a
//     step): two steps in bf16, one in f32, whose two passes and 16-byte x
//     take more registers (two steps spilled there and were 3-8 % slower
//     at the decode shapes read cold; wo_gemv_mma_variants.py). A block is
//     4 warps over one column tile, splitting its K range step by step; at
//     <= 128 registers a thread an SM holds 4 blocks (16 warps). A first bf16 design staged the weights
//     in shared memory through per-thread cp.async rings (8 warps, 97 KB a
//     block) and x in shared memory as well, and was slower at every
//     decode shape: small blocks that hold nothing in shared memory but
//     their sums start and finish sooner.
//   - The 4 warps of a block are added through shared memory in warp
//     order; K is also split across blocks (gridDim.y; quant_matmul.
//     mma_k_split, at most 8 ways, and tf32_k_split, up to 16 where a
//     split keeps 512 rows: the down projection's 16 column tiles read
//     cold in 0.0152 ms on 16 splits, 0.0187 on 8). The splits of a column
//     tile are one thread-block cluster: after a cluster barrier each block
//     adds the blocks' sums for its share of the tile's outputs in rank
//     (split) order through distributed shared memory, so the result does
//     not depend on which block ran first, no partial sum goes through
//     global memory and y is written once, from torch.empty. (A global
//     workspace with a counter a tile and the last block adding, the
//     CUDA-core f32 kernel's way before these, was as fast or up to 17 %
//     slower at every bf16 decode shape.)
//   - The tensor cores' f32 sums drift with the rows one accumulator
//     takes (the prefill below): in f32, a warp whose walk passes TF_CHUNK
//     steps (512 rows) adds its mma accumulators into a second sum, in
//     local memory, every TF_CHUNK steps. At M 8, K 20480, N 34816 in one
//     split (5,120 rows a warp) the error against the f32 sums reads
//     1.3e-5 so, 4.8e-5 every 2048 rows and 1.3e-4, past the f32 limit,
//     with no second sum; no GPT-3 1.3B shape walks that far.
//
// * Prefill (M > 8) is bound by operations: 2*M*N*K against ~M*K*size +
//   K*N bytes. bf16 prefill within TMA's 16-byte rule runs on wgmma
//   (wo_matmul_wgmma.cu); f32 prefill, and bf16 rows of another length,
//   take `wo_gemm_tf32_kernel` on mma.sync m16n8k8 with TF32 operands and
//   f32 sums:
//
//   - Every int8 value is exact in TF32 (10 mantissa bits), and so is every
//     bf16 value, so a bf16 x needs one TF32 pass, an f32 x two (above).
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

// ------------------------------------------------ decode, tensor cores
constexpr int GV_COLS = 128;           // columns of a block (and of a warp)
constexpr int GV_MAX_M = 8;            // rows of x: the mma's n8 side
constexpr int MMA_NT = 128;            // threads a block
constexpr int MMA_NW = MMA_NT / 32;    // warps a block
constexpr int MMA_KSTEP = 16;          // rows of K a warp takes a step
constexpr int MMA_AHEAD = 2;           // bf16: steps a thread keeps in flight
constexpr int TF_AHEAD = 1;            // f32: steps a thread keeps in flight
// the K splits of a column tile form one thread-block cluster: in bf16 of
// at most the portable size, in f32 of up to 16 blocks, the non-portable
// size the H100 allows (narrow N: 16 column tiles take 256 blocks)
constexpr int MMA_MAX_SPLITS = 8;
constexpr int TF_MAX_SPLITS = 16;
// f32: a warp's steps (512 rows of K) that its mma accumulators take
// before they are added into the second sum
constexpr int TF_CHUNK = 32;

// Row k, columns n0..n0+15 of w as 16 bytes, byte by byte (any N and
// alignment); zero past kend or N.
__device__ __forceinline__ uint4 load_w16(const int8_t* __restrict__ w,
                                          int k, int n0, int kend, int N) {
  if (k >= kend || n0 >= N) return make_uint4(0u, 0u, 0u, 0u);
  const int8_t* p = w + (size_t)k * N + n0;
  uint32_t q[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int c = 0; c < 16; ++c)
    if (n0 + c < N)
      q[c >> 2] |= (uint32_t)(uint8_t)__ldg(p + c) << (8 * (c & 3));
  return make_uint4(q[0], q[1], q[2], q[3]);
}

// x's row at k .. k+3, a step's B operand: bf16 as B's two registers (one
// 8-byte load), f32 as four floats (one 16-byte load)
template <typename T>
struct XQuad {
  using type = uint2;
};
template <>
struct XQuad<float> {
  using type = float4;
};

// A step's operands in one thread's registers: its four rows of w at its
// 16 columns, and x's row g at the step's k 4t .. 4t+3
template <typename T>
struct Step {
  uint4 w[4];
  typename XQuad<T>::type x;
};

// x's row at k .. k+3, zero past kend: one load where XVEC (K % 4 == 0
// and the row's base aligned to the 4 values' size; k and kend are
// multiples of 4, so the 4 lie wholly in range or out), else element by
// element
template <bool XVEC>
__device__ __forceinline__ uint2 load_x4(const __nv_bfloat16* xrow, int k,
                                         int kend) {
  if (XVEC) return k < kend ? __ldg(reinterpret_cast<const uint2*>(xrow + k))
                            : make_uint2(0u, 0u);
  uint32_t h[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    h[e] = k + e < kend ? __bfloat16_as_ushort(xrow[k + e]) : 0u;
  return make_uint2(h[0] | h[1] << 16, h[2] | h[3] << 16);
}
template <bool XVEC>
__device__ __forceinline__ float4 load_x4(const float* xrow, int k,
                                          int kend) {
  if (XVEC) return k < kend ? __ldg(reinterpret_cast<const float4*>(xrow + k))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
  float h[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = k + e < kend ? __ldg(xrow + k + e) : 0.f;
  return make_float4(h[0], h[1], h[2], h[3]);
}

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

// The f32 form of mma_word, on m16n8k8 with TF32 operands: the step's
// rows 4t, 4t+1 are k slots t, t+4 of a first k8 mma and rows 4t+2, 4t+3
// those of a second (the k map of the note at the top), each in two
// passes, x_small (xs) then x_big (xb). An int8 value is exact in TF32,
// so the widened floats are A as they are.
__device__ __forceinline__ void tf32_word(float (&c0)[4], float (&c1)[4],
                                          uint32_t r0, uint32_t r1,
                                          uint32_t r2, uint32_t r3,
                                          const uint32_t (&xb)[4],
                                          const uint32_t (&xs)[4]) {
  float f[4][4];
  i8x4_to_f32(r0, f[0]);
  i8x4_to_f32(r1, f[1]);
  i8x4_to_f32(r2, f[2]);
  i8x4_to_f32(r3, f[3]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {       // rows 4t + 2h, 4t + 2h + 1
    const float(&lo)[4] = f[2 * h];
    const float(&hi)[4] = f[2 * h + 1];
    const uint32_t a0[4] = {__float_as_uint(lo[0]), __float_as_uint(lo[1]),
                            __float_as_uint(hi[0]), __float_as_uint(hi[1])};
    const uint32_t a1[4] = {__float_as_uint(lo[2]), __float_as_uint(lo[3]),
                            __float_as_uint(hi[2]), __float_as_uint(hi[3])};
    mma_tf32(c0, a0, xs[2 * h], xs[2 * h + 1]);
    mma_tf32(c0, a0, xb[2 * h], xb[2 * h + 1]);
    mma_tf32(c1, a1, xs[2 * h], xs[2 * h + 1]);
    mma_tf32(c1, a1, xb[2 * h], xb[2 * h + 1]);
  }
}

// One step's mmas: bf16 x as B as it is, f32 x split once into big + small
__device__ __forceinline__ void step_mmas(float (&acc)[8][4],
                                          const Step<__nv_bfloat16>& st) {
  mma_word(acc[0], acc[1], st.w[0].x, st.w[1].x, st.w[2].x, st.w[3].x,
           st.x.x, st.x.y);
  mma_word(acc[2], acc[3], st.w[0].y, st.w[1].y, st.w[2].y, st.w[3].y,
           st.x.x, st.x.y);
  mma_word(acc[4], acc[5], st.w[0].z, st.w[1].z, st.w[2].z, st.w[3].z,
           st.x.x, st.x.y);
  mma_word(acc[6], acc[7], st.w[0].w, st.w[1].w, st.w[2].w, st.w[3].w,
           st.x.x, st.x.y);
}
__device__ __forceinline__ void step_mmas(float (&acc)[8][4],
                                          const Step<float>& st) {
  uint32_t xb[4], xs[4];
  split(st.x.x, xb[0], xs[0]);
  split(st.x.y, xb[1], xs[1]);
  split(st.x.z, xb[2], xs[2]);
  split(st.x.w, xb[3], xs[3]);
  tf32_word(acc[0], acc[1], st.w[0].x, st.w[1].x, st.w[2].x, st.w[3].x, xb,
            xs);
  tf32_word(acc[2], acc[3], st.w[0].y, st.w[1].y, st.w[2].y, st.w[3].y, xb,
            xs);
  tf32_word(acc[4], acc[5], st.w[0].z, st.w[1].z, st.w[2].z, st.w[3].z, xb,
            xs);
  tf32_word(acc[6], acc[7], st.w[0].w, st.w[1].w, st.w[2].w, st.w[3].w, xb,
            xs);
}

// The block's 128 columns from its warps' partial sums red[w][m][c] when
// the K splits of the tile are one cluster (rank q = blockIdx.y): each
// block adds its warps in order into red's first [8][128], then, after
// the cluster's barrier, rank r adds the ranks' sums in rank order for
// the outputs o = tid + 128 (r + S i) (S ranks) through distributed shared
// memory, applies the epilogue and stores them; a second barrier keeps
// every block's shared memory alive until the others have read it.
template <typename T>
__device__ __forceinline__ void cluster_finish(float* red,
                                               const float* __restrict__ s,
                                               const T* __restrict__ bias,
                                               T* __restrict__ y, int M,
                                               int N, float qmax) {
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

// The decode kernels' body, for x of type T (bf16: wo_gemv_mma_kernel;
// f32: wo_gemv_tf32_kernel). Grid (ceil(N / 128), K splits of
// k_per_split rows, a multiple of 128), 128 threads; the splits of a tile
// are one cluster (1, splits, 1). Warp w takes the block's steps w, w +
// 4, ... (16 rows each). VEC: N % 16 == 0 and w 16-byte aligned (16-byte
// loads of w, else byte by byte); XVEC: K % 4 == 0 and x aligned to 4
// values (one load of x a step, else element by element). In f32 a warp
// adds its mma accumulators into a second sum every TF_CHUNK steps.
template <typename T, bool VEC, bool XVEC>
__device__ __forceinline__ void decode_tile(const T* __restrict__ x,
                                            const int8_t* __restrict__ w,
                                            const float* __restrict__ s,
                                            const T* __restrict__ bias,
                                            T* __restrict__ y, int M, int K,
                                            int N, int k_per_split,
                                            float qmax) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int AHEAD = F32 ? TF_AHEAD : MMA_AHEAD;
  __shared__ __align__(16) float red[MMA_NW * GV_MAX_M * GV_COLS];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * GV_COLS + 16 * g;  // this thread's columns
  const int kbeg = blockIdx.y * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const int steps = (kend - kbeg + MMA_KSTEP - 1) / MMA_KSTEP;
  const int mine = warp < steps ? (steps - warp + MMA_NW - 1) / MMA_NW : 0;
  const T* xrow = x + (size_t)min(g, M - 1) * K;

  // this warp's step i: rows k .. k+3 of this thread's 16 columns, k =
  // kbeg + 16 (warp + 4 i) + 4t, and x's row g there (zeros past the
  // split, N or M)
  auto load_step = [&](Step<T>& st, int i) {
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
    if (g < M)
      st.x = load_x4<XVEC>(xrow, k, kend);
    else
      st.x = {};
  };
  Step<T> ahead[AHEAD];
#pragma unroll
  for (int a = 0; a < AHEAD; ++a) load_step(ahead[a], a);

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // f32's second sum for a walk past TF_CHUNK steps: in local memory,
  // touched once a chunk (the prefill GEMM's way)
  volatile float outer[32];
  const bool chunked = F32 && mine > TF_CHUNK;
  if (chunked)
#pragma unroll
    for (int o = 0; o < 32; ++o) outer[o] = 0.f;
  for (int i = 0; i < mine; i += AHEAD) {
#pragma unroll
    for (int a = 0; a < AHEAD; ++a) {
      if (i + a < mine) {
        const Step<T> st = ahead[a];
        step_mmas(acc, st);
        // the registers are in the mmas' operands: load the step AHEAD
        // further on into them
        load_step(ahead[a], i + a + AHEAD);
      }
    }
    if (chunked && (i + AHEAD) % TF_CHUNK == 0 && i + AHEAD < mine)
#pragma unroll
      for (int o = 0; o < 32; ++o) {
        float& c = acc[o / 4][o % 4];
        outer[o] = outer[o] + c;
        c = 0.f;
      }
  }
  if (chunked)
#pragma unroll
    for (int o = 0; o < 32; ++o) {
      float& c = acc[o / 4][o % 4];
      c = outer[o] + c;
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

// bf16 decode: mma.sync m16n8k16, bf16 operands (see decode_tile)
template <bool VEC, bool XVEC>
__global__ void __launch_bounds__(MMA_NT, 512 / MMA_NT)
    wo_gemv_mma_kernel(const __nv_bfloat16* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ s,
                       const __nv_bfloat16* __restrict__ bias,
                       __nv_bfloat16* __restrict__ y, int M, int K, int N,
                       int k_per_split, float qmax) {
  decode_tile<__nv_bfloat16, VEC, XVEC>(x, w, s, bias, y, M, K, N,
                                        k_per_split, qmax);
}

// f32 decode: mma.sync m16n8k8, TF32 operands, x in two passes (see
// decode_tile)
template <bool VEC, bool XVEC>
__global__ void __launch_bounds__(MMA_NT, 512 / MMA_NT)
    wo_gemv_tf32_kernel(const float* __restrict__ x,
                        const int8_t* __restrict__ w,
                        const float* __restrict__ s,
                        const float* __restrict__ bias, float* __restrict__ y,
                        int M, int K, int N, int k_per_split, float qmax) {
  decode_tile<float, VEC, XVEC>(x, w, s, bias, y, M, K, N, k_per_split,
                                qmax);
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

}  // namespace

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

namespace {

// The decode kernel for x of type T (bf16 wo_gemv_mma_kernel, f32
// wo_gemv_tf32_kernel) with 16-byte loads of w (vec) and one load of x a
// step (xvec) or not
template <typename T>
auto decode_kernel(bool vec, bool xvec) {
  if constexpr (std::is_same<T, float>::value)
    return vec ? (xvec ? wo_gemv_tf32_kernel<true, true>
                       : wo_gemv_tf32_kernel<true, false>)
               : (xvec ? wo_gemv_tf32_kernel<false, true>
                       : wo_gemv_tf32_kernel<false, false>);
  else
    return vec ? (xvec ? wo_gemv_mma_kernel<true, true>
                       : wo_gemv_mma_kernel<true, false>)
               : (xvec ? wo_gemv_mma_kernel<false, true>
                       : wo_gemv_mma_kernel<false, false>);
}

template <typename T>
int launch_decode(const void* x, const void* w, const void* s,
                  const void* bias, void* y, int M, int K, int N,
                  int k_per_split, float qmax, void* stream) {
  if (M <= 0 || M > GV_MAX_M || N <= 0 || K <= 0 || k_per_split <= 0 ||
      k_per_split % 128 != 0)
    return cudaErrorInvalidValue;
  const dim3 grid((N + GV_COLS - 1) / GV_COLS,
                  (K + k_per_split - 1) / k_per_split);
  constexpr bool F32 = std::is_same<T, float>::value;
  if (grid.y > (F32 ? TF_MAX_SPLITS : MMA_MAX_SPLITS))
    return cudaErrorInvalidValue;
  const bool vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bool xvec =
      K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
  const auto kernel = decode_kernel<T>(vec, xvec);
  if (grid.y > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
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
      &cfg, kernel, static_cast<const T*>(x),
      static_cast<const int8_t*>(w), static_cast<const float*>(s),
      static_cast<const T*>(bias), static_cast<T*>(y), M, K, N, k_per_split,
      qmax);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
int decode_occupancy(int vec, int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, decode_kernel<T>(vec != 0, true), MMA_NT, 0);
}

}  // namespace

// The decode on the tensor cores: x [M, K] with 1 <= M <= 8 (wo_gemv_mma:
// bf16, wo_gemv_mma_kernel; wo_gemv_tf32: f32, wo_gemv_tf32_kernel), w
// [K, N] int8, s [N] f32, bias [N] in x's type or null, y [M, N] in x's
// type, all contiguous on the current device (any alignment). k_per_split
// is a multiple of 128, and K takes at most MMA_MAX_SPLITS of them in bf16,
// TF_MAX_SPLITS in f32 (the splits of a column tile are one cluster).
extern "C" int wo_gemv_mma(const void* x, const void* w, const void* s,
                           const void* bias, void* y, int M, int K, int N,
                           int k_per_split, float qmax, void* stream) {
  return launch_decode<__nv_bfloat16>(x, w, s, bias, y, M, K, N,
                                      k_per_split, qmax, stream);
}

extern "C" int wo_gemv_tf32(const void* x, const void* w, const void* s,
                            const void* bias, void* y, int M, int K, int N,
                            int k_per_split, float qmax, void* stream) {
  return launch_decode<float>(x, w, s, bias, y, M, K, N, k_per_split, qmax,
                              stream);
}

// Blocks of a decode kernel (bf16 or f32) that one SM holds at once, on
// the current device; vec: N % 16 == 0. The wrapper splits K to fill the
// card with them.
extern "C" int wo_gemv_mma_blocks_per_sm(int vec, int* blocks) {
  return decode_occupancy<__nv_bfloat16>(vec, blocks);
}

extern "C" int wo_gemv_tf32_blocks_per_sm(int vec, int* blocks) {
  return decode_occupancy<float>(vec, blocks);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
