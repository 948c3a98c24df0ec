// Int8 x int8 -> int32 matmul for Hopper (sm_90a), on the tensor cores.
//
// Replaces: paddle2_tpu/kernels/pallas_matmul.py `_i8i8_kernel` (launched by
// `int8_matmul`), reached from `int8_matmul` by every QuantedInferenceLinear,
// the full-int8 Linear that PTQ.convert builds: four a block of a GPT served
// after post-training quantization.
//
//   y[m, n] = sum_k x[m, k] * w[k, n]
//
// x [M, K] int8 and w [K, N] int8, both row-major; y [M, N] int32. No scales:
// the caller dequantizes.
//
// Exactness. A product has magnitude at most 128 * 128 = 2^14, so the int32
// sum is exact while K * 2^14 < 2^31, that is K < 131,072 (every GPT-3 1.3B
// shape has K <= 8192). Past that the sums wrap modulo 2^32, as the Pallas
// kernel's int32 adds do: wgmma and mma.sync without .satfinite wrap, and the
// K splits are added in unsigned arithmetic. Integer adds commute modulo
// 2^32, so the result is the same whatever the order of the tiles, the
// splits or the blocks, and equals the plain version's
// (int8_matmul_reference) bit for bit.
//
// What bounds it on the H100: max(2*M*N*K / 1,979e12 op/s (int8 tensor
// cores, dense), (M*K + K*N + 4*M*N) / 3.35e12 B/s). Two kernels:
//
// * Prefill (M > 16, K % 16 == 0, N % 16 == 0): `i8i8_wgmma_kernel<BN>`, on
//   wgmma m64nNk32 s8 -> s32 at the int8 rate, which only wgmma reaches; at
//   M 1008 the product is bound by operations (the up projection: 0.0171
//   ms). For 8-bit types wgmma reads both shared-memory operands K-major
//   only. x [M, K] is K-major as the A operand, but w [K, N] is MN-major as
//   B, so the consumers rewrite each TMA-landed w tile into a K-major tile
//   (the product stays y = x w, and the weights are kept once, as [K, N]):
//
//   - One block per 128 x BN output tile (BN 128 or 256, the wrapper's
//     choice), M tiles fastest, so that the blocks in flight share w's
//     tiles in L2. Nine warps: warps 0-7 are two consumer warpgroups; lane 0
//     of warp 8 (the producer) keeps K-steps of 128 bytes in flight with
//     TMA: x's 128 x 128 tile in the 128-byte swizzle (chunk c of row r at
//     c ^ (r % 8), the layout the descriptor names) and w's 128 x BN tile
//     as it lies, in two rings with an mbarrier a stage: x's stages are held
//     until the products that read them are done, w's only until both
//     warpgroups have rewritten them, so the larger tile goes back to TMA
//     a step sooner. Rows and columns past M, N and K arrive as zeros
//     (TMA's out-of-bounds fill) and add nothing.
//   - Warpgroup h owns the output columns h BN/2 .. h BN/2 + BN/2 - 1 of
//     both 64-row halves of the tile, so it reads only its own half of the
//     K-major w tile and rewrites that half itself: it needs no barrier
//     with the other warpgroup, and two K-major buffers suffice (the one it
//     writes was last read by its own step i - 1, which it has waited for).
//   - The rewrite (`transpose_tile`): a thread takes 4 columns x 16 rows of
//     w (16 aligned 4-byte loads: the 32 lanes of a warp read 32 different
//     words of a row, no bank conflict), transposes each 4 x 4 block of
//     bytes with __byte_perm (transpose4x4), and stores each column's 16 k
//     as one 16-byte chunk of its K-major row in the 128-byte swizzle; the
//     lanes' 16-row chunks are staggered so that each 8-lane phase of the
//     store writes 8 different chunk positions (no bank conflict either).
//     Each thread fences its stores to the async proxy, and a named barrier
//     over the warpgroup precedes the wgmma that reads them.
//   - Per K-step i a warpgroup issues 4 k32 steps x 2 row halves of wgmma
//     m64n(BN/2)k32, keeps that group in flight, waits for step i - 1's
//     group, releases step i - 1's stage (one arrival a consumer warp), and
//     rewrites step i + 1's w tile while step i's products run.
//   - Small grids (M 32..144 at N 2048) split K across a thread-block
//     cluster of up to 8 blocks (gridDim.z): each block leaves its partial
//     tile in its idle buffers, and after the cluster's barrier each
//     rank adds the ranks' partials for its share of the tile through
//     distributed shared memory and writes y once. No atomics, no zeroed y.
//
// * Decode (M <= 16), and any shape off TMA's 16-byte rule:
//   `i8i8_gemv_mma_kernel<NT8, VEC, XVEC>`, bound by w's K*N bytes (M8 up:
//   0.00509 ms). The product is swapped, y^T = w^T x^T, on mma.sync
//   m16n8k32 s8 -> s32: 16 columns of w are the A operand's rows and x's
//   rows the n8 side (NT8 = 1 n8 tile for M <= 8, 2 for M 9..16; rows past
//   M are zero), so no tensor-core row is wasted on the batch.
//
//   - A warp owns the block's 128-column tile and takes 32 rows of K a step.
//     Thread (g = lane / 4, t = lane % 4) loads rows 8t .. 8t+7 of the step
//     at columns 16g .. 16g+15 (eight 16-byte loads; a warp reads four whole
//     128-byte rows each time) straight into registers, two steps ahead of
//     the MMAs (one with two n8 tiles), and builds its A fragments by two
//     maps the mma leaves free.
//     The k map: A's (and B's) k slots 4t .. 4t+3 stand for the step's rows
//     8t .. 8t+3 and slots 16+4t .. 16+4t+3 for rows 8t+4 .. 8t+7, so B's
//     two registers are one 8-byte load of x's row at the step's k 8t ..
//     8t+7. The column map: in the step's mma j (0..7), A row g stands for
//     column 16g + 2j of the tile and A row g+8 for 16g + 2j + 1. Word q of
//     the thread's rows (columns 4q .. 4q+3) transposed (transpose4x4, rows
//     8t..8t+3 and 8t+4..8t+7) gives the four A registers of mmas 2q and
//     2q + 1. The accumulators come back as rows 2t, 2t+1 of x (of each n8
//     tile) and the thread's own 16 columns: 32 registers a tile.
//   - A block is 4 warps over one column tile, splitting its K range step by
//     step; the warps are added through shared memory in warp order. K is
//     also split across blocks (gridDim.y, at most 8 ways, whole 128-row
//     runs) as far as the blocks stay within two an SM; the
//     splits of a column tile are one thread-block cluster, added in rank
//     order through distributed shared memory, so y is written once.
//     gridDim.z walks M in tiles of 8 NT8 rows (M > 16 off TMA's rule).
//   - VEC: N % 16 == 0 and a 16-byte aligned w (16-byte loads, else byte by
//     byte); XVEC: K % 8 == 0 and an 8-byte aligned x (8-byte loads of x,
//     else byte by byte). Every shape is taken.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
namespace cg = cooperative_groups;

// Rows r0..r3 hold four k-neighbours, byte j of each being column j: the
// result's word j holds column j's four k values, k in byte order.
__device__ __forceinline__ uint4 transpose4x4(uint32_t r0, uint32_t r1,
                                              uint32_t r2, uint32_t r3) {
  const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);
  const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);
  const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
  const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
  return make_uint4(__byte_perm(lo01, lo23, 0x5410),
                    __byte_perm(lo01, lo23, 0x7632),
                    __byte_perm(hi01, hi23, 0x5410),
                    __byte_perm(hi01, hi23, 0x7632));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// ------------------------------------------------- prefill, wgmma s8
constexpr int PF_BM = 128;             // rows of x a block
constexpr int PF_BK = 128;             // rows of K (bytes of x) a stage
constexpr int PF_NCW = 8;              // consumer warps: two warpgroups
constexpr int PF_NC = PF_NCW * 32;     // consumer threads
constexpr int PF_NT = PF_NC + 32;      // + the producer warp
constexpr int PF_MAX_SPLITS = 8;       // a tile's K splits: one cluster

template <int BN>
struct Pf {
  // x's stages (held until the products that read them are done) and w's
  // (released as soon as both warpgroups have rewritten them)
  static constexpr int XS = BN == 256 ? 4 : 6;
  static constexpr int WS = BN == 256 ? 3 : 4;
  static constexpr int X_BYTES = PF_BM * PF_BK;   // x's tile, swizzled
  static constexpr int W_BYTES = PF_BK * BN;      // w's tile, as it lies
  static constexpr int T_BYTES = BN * PF_BK;      // w's tile, K-major
  static constexpr int OFF_W = XS * X_BYTES;
  static constexpr int OFF_T = OFF_W + WS * W_BYTES;
  static constexpr int OFF_BAR = OFF_T + 2 * T_BYTES;
  static constexpr int SMEM = OFF_BAR + 2 * (XS + WS) * 8 + 1024;
  // the partial tile of a K split, rows padded by 8 ints (conflict-free
  // 8-byte stores), over the stage and K-major buffers once they are idle
  static constexpr int RED_STRIDE = BN + 8;
  static constexpr int ACC = BN / 4;              // accumulators a half
  static_assert(PF_BM * RED_STRIDE * 4 <= OFF_BAR, "partial tile fits");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// d (+)= A[64x32] * B[32x64], s8 x s8 -> s32: A and B from shared memory,
// both K-major; `accum` 0 overwrites d, 1 adds to it
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da,
                                         uint64_t db, int accum) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(accum));
}

// d (+)= A[64x32] * B[32x128], as above
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db, int accum) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accum));
}

// after a wait: the compiler may not read an accumulator early
template <int R>
__device__ __forceinline__ void pin(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Warpgroup h's half of w's tile `raw` ([PF_BK rows][BN bytes], as TMA
// lands it) into the K-major tile `tk` ([BN rows][128 bytes] in the
// 128-byte swizzle): its columns h BN/2 + 4 cg + j, cg < BN/8. A unit is 4
// columns x 16 rows (16-row chunk kc of the step); a thread takes BN/128
// units. Warp wq's lane takes column group cg = lane % (BN/8) and chunk kc =
// ((cg/2 + wq) % 4) + 4 (lane / (BN/8) + u): for a column group the four
// warps and the units give the 8 chunks once, and the lanes of an 8-lane
// store phase write 8 different chunk positions (the 16-byte chunk of row n
// lands at kc ^ (n % 8), n % 8 = 4 (cg % 2) + j).
template <int BN>
__device__ __forceinline__ void transpose_tile(const uint8_t* raw,
                                               uint8_t* tk, int h, int wq,
                                               int lane) {
  constexpr int G = BN / 8;
  constexpr int U = BN / 128;
  const int cg = lane % G;
  const int hi = lane / G;
  const int a = ((cg >> 1) + wq) & 3;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int kc = a + 4 * (hi + u);
    const uint8_t* src = raw + 16 * kc * BN + h * (BN / 2) + 4 * cg;
    uint32_t r[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      r[i] = *reinterpret_cast<const uint32_t*>(src + i * BN);
    uint4 tq[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      tq[q] = transpose4x4(r[4 * q], r[4 * q + 1], r[4 * q + 2],
                           r[4 * q + 3]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = h * (BN / 2) + 4 * cg + j;
      *reinterpret_cast<uint4*>(tk + n * 128 + ((kc ^ (n & 7)) * 16)) =
          make_uint4(word(tq[0], j), word(tq[1], j), word(tq[2], j),
                     word(tq[3], j));
    }
  }
}

// Grid (ceil(M / 128), ceil(N / BN), K splits of k_per_split rows, a
// multiple of 128); the splits of a tile are one cluster (1, 1, splits).
template <int BN>
__global__ void __launch_bounds__(PF_NT, 1)
    i8i8_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tw,
                      int* __restrict__ y, int M, int K, int N,
                      int k_per_split) {
  using C = Pf<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sx = smem;
  uint8_t* sw = smem + C::OFF_W;
  uint8_t* stk = smem + C::OFF_T;
  uint64_t* full_x = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* empty_x = full_x + C::XS;
  uint64_t* full_w = empty_x + C::XS;
  uint64_t* empty_w = full_w + C::WS;

  const int m0 = blockIdx.x * PF_BM, n0 = blockIdx.y * BN;
  const int kb = blockIdx.z * k_per_split;
  const int n_k = (min(K, kb + k_per_split) - kb + PF_BK - 1) / PF_BK;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int st = 0; st < C::XS; ++st) {
      mbar_init(&full_x[st], 1);
      mbar_init(&empty_x[st], PF_NCW);
    }
    for (int st = 0; st < C::WS; ++st) {
      mbar_init(&full_w[st], 1);
      mbar_init(&empty_w[st], PF_NCW);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // consumers: warpgroup wg owns columns n0 + wg BN/2 .. of both halves
  const int wg = warp / 4, wq = warp % 4;
  int acc[2][C::ACC];
  if (warp == PF_NCW) {  // producer
    if (lane == 0) {
      for (int i = 0; i < n_k; ++i) {
        const int sw_ = i % C::WS;
        if (i >= C::WS) mbar_wait(&empty_w[sw_], ((i / C::WS) - 1) & 1);
        mbar_expect_tx(&full_w[sw_], C::W_BYTES);
        tma_load_3d(sw + sw_ * C::W_BYTES, &tw, &full_w[sw_], n0,
                    kb + i * PF_BK, 0);
        const int sx_ = i % C::XS;
        if (i >= C::XS) mbar_wait(&empty_x[sx_], ((i / C::XS) - 1) & 1);
        mbar_expect_tx(&full_x[sx_], C::X_BYTES);
        tma_load_3d(sx + sx_ * C::X_BYTES, &tx, &full_x[sx_], kb + i * PF_BK,
                    m0, 0);
      }
    }
  } else {
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int i = 0; i < C::ACC; ++i) acc[mb][i] = 0;

    // step i's w tile: wait for it, rewrite this warpgroup's half into
    // K-major buffer i % 2, release its stage (each warp once its reads
    // are done)
    auto rewrite = [&](int i) {
      const int s1 = i % C::WS;
      mbar_wait(&full_w[s1], (i / C::WS) & 1);
      transpose_tile<BN>(sw + s1 * C::W_BYTES, stk + (i & 1) * C::T_BYTES,
                         wg, wq, lane);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_w[s1]);
    };
    rewrite(0);
    named_barrier(1 + wg, 128);
    for (int i = 0; i < n_k; ++i) {
      const int st = i % C::XS;
      mbar_wait(&full_x[st], (i / C::XS) & 1);
      const uint32_t xa = smem_u32(sx + st * C::X_BYTES);
      const uint32_t tb =
          smem_u32(stk + (i & 1) * C::T_BYTES) + wg * (BN / 2) * 128;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < PF_BK / 32; ++kk) {
        const uint64_t db = make_desc<128>(tb + kk * 32, 8 * 128);
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
          wgmma_s8(acc[mb],
                   make_desc<128>(xa + mb * 64 * 128 + kk * 32, 8 * 128), db,
                   1);
      }
      wg_commit();
      // step i - 1's products are done: release its x stage
      wg_wait<1>();
      if (i > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty_x[(i - 1) % C::XS]);
      }
      // the next step's w tile, rewritten while step i's products run,
      // into the buffer this warpgroup's step i - 1 read
      if (i + 1 < n_k) rewrite(i + 1);
      named_barrier(1 + wg, 128);
    }
    wg_wait<0>();
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) pin(acc[mb]);
  }

  // thread: rows m0 + 64 mb + 16 wq + lane / 4 + 8 hh, columns
  // n0 + wg BN/2 + 8 j + 2 (lane % 4) + {0, 1} hold acc[mb][4 j + 2 hh + e]
  const int rl = 16 * wq + lane / 4;
  const int cl = wg * (BN / 2) + 2 * (lane % 4);
  if (gridDim.z == 1) {
    if (warp < PF_NCW) {
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = m0 + 64 * mb + rl + 8 * hh;
          if (m >= M) continue;
          int* yrow = y + (size_t)m * N;
#pragma unroll
          for (int j = 0; j < C::ACC / 4; ++j) {
            const int n = n0 + cl + 8 * j;
            if (n < N)  // N % 16 == 0: n + 1 < N too
              *reinterpret_cast<int2*>(yrow + n) = make_int2(
                  acc[mb][4 * j + 2 * hh], acc[mb][4 * j + 2 * hh + 1]);
          }
        }
    }
    return;
  }

  // K split: the partial tile into the idle buffers, once both
  // warpgroups' products (which read x's stages) are done
  int* red = reinterpret_cast<int*>(smem);
  if (warp == PF_NCW) {
    __syncwarp();
  } else {
    named_barrier(3, PF_NC);
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < C::ACC / 4; ++j)
          *reinterpret_cast<int2*>(
              red + (64 * mb + rl + 8 * hh) * C::RED_STRIDE + cl + 8 * j) =
              make_int2(acc[mb][4 * j + 2 * hh], acc[mb][4 * j + 2 * hh + 1]);
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  // rank r adds the ranks' partials, in rank order, for the outputs o = tid
  // + PF_NT (r + S i) (4 ints each) of the tile's rows below M
  const int ranks = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int rows = min(PF_BM, M - m0);
  constexpr int Q = BN / 4;
  for (int o = tid + PF_NT * r; o < rows * Q; o += PF_NT * ranks) {
    const int m = o / Q, c = (o % Q) * 4;
    if (n0 + c >= N) continue;
    uint32_t s[4] = {0u, 0u, 0u, 0u};
    for (int q = 0; q < ranks; ++q) {
      const int4 v = *reinterpret_cast<const int4*>(
          cluster.map_shared_rank(red, q) + m * C::RED_STRIDE + c);
      s[0] += (uint32_t)v.x;
      s[1] += (uint32_t)v.y;
      s[2] += (uint32_t)v.z;
      s[3] += (uint32_t)v.w;
    }
    *reinterpret_cast<int4*>(y + (size_t)(m0 + m) * N + n0 + c) =
        make_int4((int)s[0], (int)s[1], (int)s[2], (int)s[3]);
  }
  // keep every block's shared memory alive until the others have read it
  cluster.sync();
}

template <int BN>
int launch_wgmma(const void* x, const void* w, void* y, int M, int K, int N,
                 int k_per_split, cudaStream_t st) {
  using C = Pf<BN>;
  CUtensorMap tx, tw;
  if (!encode_3d(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x, 1, M, K, PF_BK,
                 PF_BM, 1, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_3d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, 1, K, N, BN,
                 PF_BK, 1, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      i8i8_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + PF_BM - 1) / PF_BM, (N + BN - 1) / BN,
                  (K + k_per_split - 1) / k_per_split);
  if (grid.y > 65535 || grid.z > PF_MAX_SPLITS) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(PF_NT);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = grid.z;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, i8i8_wgmma_kernel<BN>,
                           tx, tw, static_cast<int*>(y), M, K, N,
                           k_per_split);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// ------------------------------------------- decode, swapped mma.sync
constexpr int GV_NT = 128;             // threads a block
constexpr int GV_NW = GV_NT / 32;      // warps a block
constexpr int GV_COLS = 128;           // columns a block (and each warp)
constexpr int GV_KSTEP = 32;           // rows of K a warp takes a step
constexpr int GV_RUN = GV_NW * GV_KSTEP;  // a K split: whole runs of these
constexpr int GV_MAX_SPLITS = 8;       // a tile's K splits: one cluster

// c += A * B on one m16n8k32 tile: s8 operands, s32 sums (wrapping)
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 bytes of w's row k at columns n .. n+15, zero past kend or N
__device__ __forceinline__ uint4 load_w16(const int8_t* __restrict__ w,
                                          int k, int n, int kend, int N) {
  if (k >= kend || n >= N) return make_uint4(0u, 0u, 0u, 0u);
  const int8_t* p = w + (size_t)k * N + n;
  uint32_t q[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int c = 0; c < 16; ++c)
    if (n + c < N)
      q[c >> 2] |= (uint32_t)(uint8_t)__ldg(p + c) << (8 * (c & 3));
  return make_uint4(q[0], q[1], q[2], q[3]);
}

// A step's operands in one thread's registers: its eight rows of w at its
// 16 columns, and each n8 tile's x row (g, or 8 + g) at the step's k 8t ..
// 8t+7 (B's two registers)
template <int NT8>
struct Step {
  uint4 w[8];
  uint2 x[NT8];
};

// Grid (ceil(N / 128), K splits of k_per_split rows, a multiple of 128,
// ceil(M / (8 NT8))), 128 threads; the splits of a column tile are one
// cluster (1, splits, 1). Warp w takes the block's steps w, w + 4, ...
template <int NT8, bool VEC, bool XVEC>
__global__ void __launch_bounds__(GV_NT, 3)
    i8i8_gemv_mma_kernel(const int8_t* __restrict__ x,
                         const int8_t* __restrict__ w, int* __restrict__ y,
                         int M, int K, int N, int k_per_split) {
  constexpr int RM = 8 * NT8;               // rows of x a block
  constexpr int OUTS = RM * GV_COLS;        // sums a warp
  __shared__ __align__(16) int red[GV_NW * OUTS];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int nw = blockIdx.x * GV_COLS + 16 * g;  // this thread's columns
  const int mb = blockIdx.z * RM;
  const int kbeg = blockIdx.y * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const int steps = (kend - kbeg + GV_KSTEP - 1) / GV_KSTEP;
  const int mine = warp < steps ? (steps - warp + GV_NW - 1) / GV_NW : 0;

  // this warp's step i: rows k .. k+7 of this thread's 16 columns, k = kbeg
  // + 32 (warp + 4 i) + 8t, and x's rows there (zeros past the split, N or
  // M)
  auto load_step = [&](Step<NT8>& st, int i) {
    const int k = kbeg + GV_KSTEP * (warp + GV_NW * i) + 8 * t;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (!VEC)
        st.w[r] = load_w16(w, k + r, nw, kend, N);
      else if (k + r < kend && nw < N)
        st.w[r] = __ldg(reinterpret_cast<const uint4*>(
            w + (size_t)(k + r) * N + nw));
      else
        st.w[r] = make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int tile = 0; tile < NT8; ++tile) {
      const int m = mb + 8 * tile + g;
      st.x[tile] = make_uint2(0u, 0u);
      if (m < M) {
        const int8_t* xr = x + (size_t)m * K;
        if (XVEC) {
          // k and kend are multiples of 8: the 8 values lie wholly in range
          if (k < kend)
            st.x[tile] = __ldg(reinterpret_cast<const uint2*>(xr + k));
        } else {
          uint32_t q[2] = {0u, 0u};
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (k + e < kend)
              q[e >> 2] |=
                  (uint32_t)(uint8_t)__ldg(xr + k + e) << (8 * (e & 3));
          st.x[tile] = make_uint2(q[0], q[1]);
        }
      }
    }
  };
  // steps a thread keeps in flight: two with one n8 tile, one with two
  // (its registers then hold both tiles' sums; i8i8_variants.py: M16 up
  // 0.0094 ms against 0.0116 with two)
  constexpr int AHEAD = NT8 == 1 ? 2 : 1;
  Step<NT8> ahead[AHEAD];
#pragma unroll
  for (int a = 0; a < AHEAD; ++a) load_step(ahead[a], a);

  int acc[NT8][8][4];
#pragma unroll
  for (int tile = 0; tile < NT8; ++tile)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[tile][j][e] = 0;
  for (int i = 0; i < mine; i += AHEAD) {
#pragma unroll
    for (int a = 0; a < AHEAD; ++a) {
      if (i + a < mine) {
        const Step<NT8> st = ahead[a];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // columns 4q .. 4q+3 of the thread's 16: rows 8t..8t+3 (A's k
          // slots 4t..) and 8t+4..8t+7 (slots 16+4t..)
          const uint4 lo = transpose4x4(word(st.w[0], q), word(st.w[1], q),
                                        word(st.w[2], q), word(st.w[3], q));
          const uint4 hi = transpose4x4(word(st.w[4], q), word(st.w[5], q),
                                        word(st.w[6], q), word(st.w[7], q));
#pragma unroll
          for (int tile = 0; tile < NT8; ++tile) {
            mma_s8(acc[tile][2 * q], lo.x, lo.y, hi.x, hi.y, st.x[tile].x,
                   st.x[tile].y);
            mma_s8(acc[tile][2 * q + 1], lo.z, lo.w, hi.z, hi.w,
                   st.x[tile].x, st.x[tile].y);
          }
        }
        // the registers are in the mmas' operands: load the step AHEAD
        // further on into them
        load_step(ahead[a], i + a + AHEAD);
      }
    }
  }

  // warp w's sums, red[w][m][c]: mma j of tile gives rows 8 tile + 2t,
  // 8 tile + 2t + 1 of x at columns 16g + 2j (c0, c1) and 16g + 2j + 1
  // (c2, c3)
  int* mine_red = red + warp * OUTS;
#pragma unroll
  for (int tile = 0; tile < NT8; ++tile)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 16 * g + 2 * j;
      const int m = 8 * tile + 2 * t;
      *reinterpret_cast<int2*>(&mine_red[m * GV_COLS + c]) =
          make_int2(acc[tile][j][0], acc[tile][j][2]);
      *reinterpret_cast<int2*>(&mine_red[(m + 1) * GV_COLS + c]) =
          make_int2(acc[tile][j][1], acc[tile][j][3]);
    }
  __syncthreads();
  // the block's warps in warp order into red's first [RM][128]; then, after
  // the cluster's barrier, rank r adds the ranks' sums in rank order for the
  // outputs o = tid + 128 (r + S i) (S ranks) through distributed shared
  // memory and stores them; a second barrier keeps every block's shared
  // memory alive until the others have read it
  constexpr int PER = OUTS / GV_NT;
  uint32_t part[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int o = tid + GV_NT * u;
    uint32_t v = 0u;
#pragma unroll
    for (int wp = 0; wp < GV_NW; ++wp) v += (uint32_t)red[wp * OUTS + o];
    part[u] = v;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < PER; ++u) red[tid + GV_NT * u] = (int)part[u];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int ranks = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int rows = min(RM, M - mb);
  for (int o = tid + GV_NT * r; o < rows * GV_COLS; o += GV_NT * ranks) {
    const int n = blockIdx.x * GV_COLS + o % GV_COLS;
    if (n >= N) continue;
    uint32_t v = 0u;
    for (int q = 0; q < ranks; ++q)
      v += (uint32_t)cluster.map_shared_rank(red, q)[o];
    y[(size_t)(mb + o / GV_COLS) * N + n] = (int)v;
  }
  cluster.sync();
}

template <int NT8>
using GvKernel = void (*)(const int8_t*, const int8_t*, int*, int, int, int,
                          int);

template <int NT8>
GvKernel<NT8> gemv_kernel(bool vec, bool xvec) {
  return vec ? (xvec ? i8i8_gemv_mma_kernel<NT8, true, true>
                     : i8i8_gemv_mma_kernel<NT8, true, false>)
             : (xvec ? i8i8_gemv_mma_kernel<NT8, false, true>
                     : i8i8_gemv_mma_kernel<NT8, false, false>);
}

template <int NT8>
int launch_gemv(const void* x, const void* w, void* y, int M, int K, int N,
                int k_per_split, cudaStream_t st) {
  const dim3 grid((N + GV_COLS - 1) / GV_COLS,
                  (K + k_per_split - 1) / k_per_split,
                  (M + 8 * NT8 - 1) / (8 * NT8));
  if (grid.y > GV_MAX_SPLITS || grid.z > 65535) return cudaErrorInvalidValue;
  const bool vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bool xvec = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(GV_NT);
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = grid.y;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, gemv_kernel<NT8>(vec, xvec), static_cast<const int8_t*>(x),
      static_cast<const int8_t*>(w), static_cast<int*>(y), M, K, N,
      k_per_split);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// The prefill kernel: x [M, K] int8, w [K, N] int8, y [M, N] int32, all
// contiguous on the current device, M > 0; TMA's rule: K % 16 == 0, N % 16
// == 0, x and w 16-byte aligned. bn: the tile's columns, 128 or 256;
// k_per_split: a multiple of 128, at most 8 splits (the splits of a tile are
// one cluster, adding through distributed shared memory: y needs no zeros).
extern "C" int i8i8_wgmma(const void* x, const void* w, void* y, int M,
                          int K, int N, int bn, int k_per_split,
                          void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || N % 16 != 0 ||
      k_per_split <= 0 || k_per_split % PF_BK != 0 ||

      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 256) return launch_wgmma<256>(x, w, y, M, K, N, k_per_split, st);
  if (bn == 128) return launch_wgmma<128>(x, w, y, M, K, N, k_per_split, st);
  return cudaErrorInvalidValue;
}

// The decode kernel, which also takes every shape off TMA's rule: x [M, K]
// int8, w [K, N] int8, y [M, N] int32, all contiguous on the current device
// (any alignment; M > 16 walks M in 16-row tiles). k_per_split: a multiple
// of 128, at most 8 splits (one cluster a column tile).
extern "C" int i8i8_gemv_mma(const void* x, const void* w, void* y, int M,
                             int K, int N, int k_per_split, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || k_per_split <= 0 ||
      k_per_split % GV_RUN != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 8) return launch_gemv<1>(x, w, y, M, K, N, k_per_split, st);
  return launch_gemv<2>(x, w, y, M, K, N, k_per_split, st);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
