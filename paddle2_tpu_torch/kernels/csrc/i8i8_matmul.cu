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
// kernel's int32 adds do: mma.sync without .satfinite wraps, and so do the
// atomic adds that join the K splits. Integer adds commute modulo 2^32, so
// the result is the same whatever the order of the tiles, the splits or the
// blocks, and equals the plain version's (int8_matmul_reference) bit for bit.
//
// What bounds it on the H100: max(2*M*N*K / 1,979e12 op/s (int8 tensor
// cores, dense), (M*K + K*N + 4*M*N) / 3.35e12 B/s).
//
// * Decode (M = the batch, <= 8) is bound by the weight's K*N bytes: 12.6 MB
//   for GPT-3 1.3B's qkv, 3.8 us. A 16-row tile (half of it zero rows at
//   M 8) costs nothing there. The 128-column tiles give 16-64 blocks at
//   N 2048-8192, too few for 132 SMs, so K is split across blocks
//   (gridDim.z, about two waves of blocks; int8_matmul's i8i8_split) and the
//   splits add into y with int32 atomics.
// * Prefill (M up to ~1000) is bound by operations: 2*M*N*K at the tensor
//   cores' int8 rate. A block computes a 64 x 128 tile with four warps of
//   32 x 64, each issuing mma.sync.m16n8k32 (s8 x s8 -> s32) on fragments
//   read from shared memory.
//
// The tiles. 64 rows of K (bytes) a stage, two m16n8k32 steps. x's tile is
// kept as loaded, rows padded to 80 bytes, so a fragment's 32-bit reads (row
// g, word t) fall in distinct banks. The B fragment wants four neighbouring
// k of one column in a 32-bit register, but w's rows run along N: each
// thread loads four rows of four columns (a 32-bit load each, neighbouring
// threads on neighbouring columns), transposes the 4 x 4 bytes with
// __byte_perm, and stores the four words column-major by k-groups of four
// (rows padded to 136 words: conflict-free fragment reads). The next stage's
// loads are in flight in registers while the current stage is multiplied,
// with two buffers in shared memory and one barrier a stage. wgmma and TMA
// are a later step.
//
// Every shape is taken: M, N and K are masked at the ragged edge (K at the
// end of the block's split). 16-byte loads of x need K % 16 == 0 and a
// 16-byte aligned x; 4-byte loads of w need N % 4 == 0 and an aligned w;
// otherwise the loads go byte by byte.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;        // four warps
constexpr int BK = 64;              // bytes of K a stage: two k32 steps
constexpr int BN = 128;             // columns a block
constexpr int SMALL_M = 16;         // up to here, 16-row tiles
constexpr int A_STRIDE = BK + 16;   // bytes a row of x's tile (20 words)
constexpr int A_WORDS = A_STRIDE / 4;
constexpr int B_STRIDE = BN + 8;    // words a k-group row of w's tile

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// MT x NTL m16n8 tiles a warp; WM x WN warps a block.
template <int MT, int NTL, int WM, int WN>
__global__ void __launch_bounds__(THREADS)
    i8i8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                int* __restrict__ y, int M, int K, int N, int k_per_split,
                bool vec_x, bool vec_w) {
  constexpr int BM = 16 * MT * WM;
  static_assert(WM * WN == THREADS / 32, "four warps");
  static_assert(8 * NTL * WN == BN, "the warps cover the columns");
  constexpr int A_CHUNKS = BM * BK / 16;  // 16-byte pieces of x's tile
  constexpr int A_PER = (A_CHUNKS + THREADS - 1) / THREADS;
  constexpr int B_UNITS = (BK / 4) * (BN / 4);  // 4 rows x 4 columns each
  constexpr int B_PER = B_UNITS / THREADS;
  static_assert(B_UNITS % THREADS == 0, "whole units a thread");

  __shared__ __align__(16) uint8_t As[2][BM * A_STRIDE];
  __shared__ __align__(16) uint32_t Bs[2][(BK / 4) * B_STRIDE];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * k_per_split;
  const int ke = min(K, kb + k_per_split);
  const int steps = (ke - kb + BK - 1) / BK;

  uint4 ra[A_PER];
  uint32_t rb[B_PER][4];

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int c = tid + i * THREADS;
      if (c >= A_CHUNKS) break;
      const int m = m0 + c / (BK / 16);
      const int k = k0 + (c % (BK / 16)) * 16;
      if (m < M && vec_x && k + 16 <= ke) {
        ra[i] = *reinterpret_cast<const uint4*>(x + (size_t)m * K + k);
      } else {
        uint32_t q[4] = {0u, 0u, 0u, 0u};
        if (m < M) {
          for (int j = 0; j < 16; ++j)
            if (k + j < ke)
              q[j >> 2] |= (uint32_t)(uint8_t)x[(size_t)m * K + k + j]
                           << (8 * (j & 3));
        }
        ra[i] = make_uint4(q[0], q[1], q[2], q[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int u = tid + i * THREADS;
      const int kq = u / (BN / 4);
      const int n = n0 + (u % (BN / 4)) * 4;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = k0 + kq * 4 + r;
        uint32_t v = 0u;
        if (k < ke) {
          const int8_t* row = w + (size_t)k * N;
          if (vec_w && n + 3 < N) {
            v = *reinterpret_cast<const uint32_t*>(row + n);
          } else {
            for (int j = 0; j < 4; ++j)
              if (n + j < N) v |= (uint32_t)(uint8_t)row[n + j] << (8 * j);
          }
        }
        rb[i][r] = v;
      }
    }
  };

  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int c = tid + i * THREADS;
      if (c >= A_CHUNKS) break;
      *reinterpret_cast<uint4*>(&As[buf][(c / (BK / 16)) * A_STRIDE +
                                         (c % (BK / 16)) * 16]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int u = tid + i * THREADS;
      const int kq = u / (BN / 4);
      const int nq = (u % (BN / 4)) * 4;
      *reinterpret_cast<uint4*>(&Bs[buf][kq * B_STRIDE + nq]) =
          transpose4x4(rb[i][0], rb[i][1], rb[i][2], rb[i][3]);
    }
  };

  int acc[MT][NTL][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NTL; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  if (steps > 0) {
    load(kb);
    store(0);
    __syncthreads();
  }
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    if (s + 1 < steps) load(kb + (s + 1) * BK);
    const uint32_t* A32 = reinterpret_cast<const uint32_t*>(As[cur]);
    const uint32_t* B32 = Bs[cur];
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      // A fragment (PTX m16n8k32, .s8): a0 row g, k 4t..4t+3; a1 row g+8;
      // a2 row g, k 16+4t..; a3 row g+8, k 16+4t..
      uint32_t a[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int row = wm * 16 * MT + mi * 16 + g;
        a[mi][0] = A32[row * A_WORDS + kk * 8 + t];
        a[mi][1] = A32[(row + 8) * A_WORDS + kk * 8 + t];
        a[mi][2] = A32[row * A_WORDS + kk * 8 + 4 + t];
        a[mi][3] = A32[(row + 8) * A_WORDS + kk * 8 + 4 + t];
      }
#pragma unroll
      for (int ni = 0; ni < NTL; ++ni) {
        // B fragment: b0 column g, k 4t..4t+3; b1 column g, k 16+4t..
        const int col = wn * 8 * NTL + ni * 8 + g;
        const uint32_t b0 = B32[(kk * 8 + t) * B_STRIDE + col];
        const uint32_t b1 = B32[(kk * 8 + 4 + t) * B_STRIDE + col];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) mma_s8(acc[mi][ni], a[mi], b0, b1);
      }
    }
    if (s + 1 < steps) store(cur ^ 1);
    __syncthreads();
  }

  // C fragment: c0, c1 row g, columns 2t, 2t+1; c2, c3 row g+8
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NTL; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 16 * MT + mi * 16 + g + (e >> 1) * 8;
        const int n = n0 + wn * 8 * NTL + ni * 8 + 2 * t + (e & 1);
        if (m < M && n < N) {
          int* dst = y + (size_t)m * N + n;
          if (split)
            atomicAdd(dst, acc[mi][ni][e]);
          else
            *dst = acc[mi][ni][e];
        }
      }
}

template <int MT, int NTL, int WM, int WN>
int launch(const void* x, const void* w, void* y, int M, int K, int N,
           int k_per_split, cudaStream_t st) {
  constexpr int BM = 16 * MT * WM;
  const bool vec_x = K % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vec_w = N % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 3) == 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM,
                  (K + k_per_split - 1) / k_per_split);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  i8i8_kernel<MT, NTL, WM, WN><<<grid, THREADS, 0, st>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int*>(y), M, K, N, k_per_split, vec_x, vec_w);
  return cudaGetLastError();
}

}  // namespace

// y must hold zeros when K is split (k_per_split < K): the splits add into it.
extern "C" int i8i8_matmul(const void* x, const void* w, void* y, int M,
                           int K, int N, int k_per_split, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || k_per_split <= 0 || k_per_split % BK)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= SMALL_M) return launch<1, 4, 1, 4>(x, w, y, M, K, N, k_per_split, st);
  return launch<2, 8, 2, 2>(x, w, y, M, K, N, k_per_split, st);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
