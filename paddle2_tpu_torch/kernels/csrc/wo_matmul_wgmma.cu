// Int8 weight-only matmul for Hopper (sm_90a) on the tensor cores: the
// bf16 prefill route (M > 8).
//
// Replaces: paddle2_tpu/kernels/pallas_matmul.py `_wo_kernel` (through
// `_wo_pallas`) for bf16 x with more than 8 rows, reached from
// `int8_weight_only_matmul` by every block projection (WeightOnlyLinear)
// of a prompt's prefill. Decode (M <= 8) and f32 x keep the CUDA-core
// kernels of wo_matmul.cu.
//
//   y[m, n] = bf16( (sum_k x[m, k] * w[k, n]) * (s[n] / qmax)  (+ b[n]) )
//
// x [M, K] bf16, w [K, N] int8, s [N] f32, b [N] bf16, y [M, N] bf16.
// Every int8 value is exact in bf16 and a bf16 times a bf16 is exact in
// f32, so bf16 tensor-core products summed in f32 compute the Pallas
// kernel's function; only the order of summation differs. The scale, the
// bias and the one cast follow in wo_common.cuh's order.
//
// What bounds it on the H100: 2*M*K*N operations against M*K*2 + K*N +
// M*N*2 bytes; at prefill (M 32..1008) operations, at 989 TFLOP/s, which
// only wgmma reaches.
//
// Layout: one block per 128 x 128 output tile, M tiles fastest. Nine
// warps: warps 0-7 are two consumer warpgroups of 64 rows each; lane 0 of
// warp 8 (the producer) keeps STAGES K-steps of BK = 64 in flight with
// TMA: x's 128 x 64 tile in the 128-byte swizzle (the K-major A operand,
// as the flash kernels load Q) and w's 64 x 128 int8 tile, unswizzled,
// both on one mbarrier a stage. Rows and columns past M, N and K arrive as
// zeros (TMA's out-of-bounds fill), so ragged edges add nothing.
//
// The weight tile is widened to bf16 by the 256 consumer threads
// themselves, each 32 values a step (wo::i8x4_to_f32, exact, then
// round-to-nearest bf16 pairs, exact for |v| <= 256), into a ring of
// three widened tiles in the MN-major layout wgmma reads for B: two
// column blocks of 64 rows x 128 bytes with the 128-byte swizzle (16-byte
// chunk c of row r at c ^ (r % 8)), exactly as TMA lands V for the flash
// kernels' P V. Each thread fences its stores to the async proxy
// (fence.proxy.async) and a named barrier over the 256 consumers precedes
// the wgmma that reads the tile.
//
// Per K-step i each warpgroup issues 4 k16 steps x 2 column blocks of
// wgmma m64n64k16 (A and B from shared memory) into 64 f32 accumulators a
// thread, keeps that group in flight, waits for step i - 1's group and
// releases its stage on the `empty` mbarrier (one arrival a consumer
// warp), then widens step i + 1's tile while step i's products run. The
// buffer it writes was read by step i - 2, which both warpgroups waited
// for before the last barrier. (One m64n128k16 a k16 step, B's column
// blocks joined through the descriptor's leading byte offset, measured
// the same on the H100.)

#include "hopper.cuh"
#include "wo_common.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;                // rows of x a block
constexpr int BN = 128;                // columns of w a block
constexpr int BK = 64;                 // rows of K a step (128 bytes of x)
constexpr int STAGES = 4;              // TMA stages of x and int8 w
constexpr int WSTAGES = 3;             // widened w tiles
constexpr int NCW = 8;                 // consumer warps: two warpgroups
constexpr int NC = NCW * 32;           // consumer threads
constexpr int NT = NC + 32;            // + the producer warp
constexpr int NCB = BN / 64;           // widened column blocks
constexpr int X_BYTES = BM * BK * 2;   // a stage's x tile, bf16
constexpr int W_BYTES = BK * BN;       // a stage's w tile, int8
constexpr int WB_BYTES = BK * BN * 2;  // a widened tile, bf16
constexpr int OFF_W = STAGES * X_BYTES;
constexpr int OFF_WB = OFF_W + STAGES * W_BYTES;
constexpr int OFF_BAR = OFF_WB + WSTAGES * WB_BYTES;
constexpr int SMEM = OFF_BAR + 2 * STAGES * 8 + 1024;  // + alignment slack
static_assert(X_BYTES % 1024 == 0 && W_BYTES % 1024 == 0 &&
                  WB_BYTES % 1024 == 0,
              "tiles start on 1024-byte boundaries");
static_assert(W_BYTES == 2 * NC * 16, "two 16-byte chunks a thread");

// The int8 tile `src` ([BK rows][BN bytes], as TMA lands it) into the
// bf16 tile `dst`, NCB column blocks of [BK rows][64] in the 128-byte
// swizzle. Thread tid takes 16-byte chunks tid and tid + NC (neighbouring
// threads on neighbouring bytes); each becomes two 16-byte bf16 chunks.
__device__ __forceinline__ void widen(const uint8_t* src, uint8_t* dst,
                                      int tid) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int g = tid + NC * j;
    const int r = g / (BN / 16), c16 = g % (BN / 16);
    const uint4 v = *reinterpret_cast<const uint4*>(src + g * 16);
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
    uint8_t* row = dst + (c16 / 4) * (BK * 128) + r * 128;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float f[8];
      wo::i8x4_to_f32(words[2 * e], f);
      wo::i8x4_to_f32(words[2 * e + 1], f + 4);
      const int chunk = (2 * c16 + e) % 8;
      *reinterpret_cast<uint4*>(row + ((chunk ^ (r % 8)) * 16)) =
          make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                     pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
    }
  }
}

__global__ void __launch_bounds__(NT, 1)
    wo_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                         const __grid_constant__ CUtensorMap tw,
                         const float* __restrict__ s,
                         const __nv_bfloat16* __restrict__ bias,
                         __nv_bfloat16* __restrict__ y, int M, int K, int N,
                         float qmax) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sx = smem;
  uint8_t* sw = smem + OFF_W;
  uint8_t* swb = smem + OFF_WB;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* empty = full + STAGES;

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int n_k = (K + BK - 1) / BK;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], NCW);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == NCW) {  // producer
    if (lane == 0) {
      for (int i = 0; i < n_k; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[st], ((i / STAGES) - 1) & 1);
        mbar_expect_tx(&full[st], X_BYTES + W_BYTES);
        tma_load_3d(sx + st * X_BYTES, &tx, &full[st], i * BK, m0, 0);
        tma_load_3d(sw + st * W_BYTES, &tw, &full[st], n0, i * BK, 0);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + 64 wg .. m0 + 64 wg + 63
  const int wg = warp / 4;
  float acc[NCB][32];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;

  mbar_wait(&full[0], 0);
  widen(sw, swb, tid);
  fence_proxy_async();
  named_barrier(1, NC);
  for (int i = 0; i < n_k; ++i) {
    const int st = i % STAGES;
    const uint32_t x_base = smem_u32(sx + st * X_BYTES) + wg * 64 * 128;
    const uint32_t w_base = smem_u32(swb + (i % WSTAGES) * WB_BYTES);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = make_desc<128>(x_base + kk * 32, 8 * 128);
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
        wgmma_ss<0, 1>(acc[cb], da,
                       make_desc<128>(w_base + cb * BK * 128 + kk * 16 * 128,
                                      8 * 128),
                       1);
    }
    wg_commit();
    // step i - 1's products are done: release its stage
    wg_wait<1>();
    if (i > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(i - 1) % STAGES]);
    }
    // the next step's weight tile, widened while step i's products run,
    // into the buffer step i - 2 read (done in both warpgroups: each
    // waited for it before the last barrier)
    if (i + 1 < n_k) {
      const int s1 = (i + 1) % STAGES;
      mbar_wait(&full[s1], ((i + 1) / STAGES) & 1);
      widen(sw + s1 * W_BYTES, swb + ((i + 1) % WSTAGES) * WB_BYTES, tid);
      fence_proxy_async();
    }
    named_barrier(1, NC);
  }
  wg_wait<0>();
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb) pin(acc[cb]);

  // thread: rows r0 and r0 + 8, columns c0 + 64 cb + 8 j + {0, 1}
  const int r0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int c0 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = r0 + 8 * h;
    if (m >= M) continue;
    __nv_bfloat16* yrow = y + (size_t)m * N;
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = c0 + cb * 64 + 8 * j;
        if (n >= N) continue;  // N % 16 == 0: n + 1 < N too
        __nv_bfloat162 v;
        v.x = wo::epilogue(acc[cb][4 * j + 2 * h], s[n], qmax, bias, n);
        v.y = wo::epilogue(acc[cb][4 * j + 2 * h + 1], s[n + 1], qmax,
                           bias, n + 1);
        *reinterpret_cast<__nv_bfloat162*>(yrow + n) = v;
      }
  }
}

}  // namespace

// x [M, K] bf16, w [K, N] int8, s [N] f32, bias [N] bf16 or null, y [M, N]
// bf16, all contiguous on the current device; TMA's rule: K % 8 == 0,
// N % 16 == 0, x and w 16-byte aligned.
extern "C" int wo_matmul_wgmma(const void* x, const void* w, const void* s,
                               const void* bias, void* y, int M, int K,
                               int N, float qmax, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 != 0 || N % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  if (!hopper::tile_map(&tx, x, 1, M, K, BK, BM) ||
      !hopper::encode_3d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, 1, K,
                         N, BN, BK, 1, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wo_gemm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  wo_gemm_wgmma_kernel<<<grid, NT, SMEM, static_cast<cudaStream_t>(stream)>>>(
      tx, tw, static_cast<const float*>(s),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(y), M, K, N, qmax);
  return cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
