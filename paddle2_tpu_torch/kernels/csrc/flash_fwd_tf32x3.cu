// FlashAttention-2 forward in float32 for Hopper (sm_90a), on the tensor
// cores in error-compensated TF32 (3xTF32). bf16 inputs go to
// flash_fwd_wgmma.cu, so each dtype has exactly one forward kernel.
//
// Replaces: paddle2_tpu/kernels/pallas_flash.py `_fwd_kernel` (tiled online
// softmax) and `_fwd_kernel_1blk` (whole row in one tile), both driven by
// `_flash_fwd`, for f32. One kernel covers both: a row that fits one key
// tile is the one-tile case of the same loop.
//
// Computes, per (batch, head), o = softmax(q k^T * scale) v and the row
// log-sum-exp, on (B, H, S, D) f32 tensors, with the causal mask aligned to
// the bottom right (row r sees keys c <= r + Sk - Sq), any Sq <= Sk, ragged
// tiles at both ends. The scores, the running max m and sum l and the
// output accumulator are f32; the probabilities are rounded to v's dtype
// before P.V in the Pallas kernel, which in f32 is nothing. expf is the
// full-precision one. No atomics and a fixed summation order: two runs give
// bitwise-equal outputs.
//
// Products: S = Q K^T and O += P V both in 3xTF32 on
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, with tf32x3.cuh's
// split and order (small*big, big*small, big*big), as the f32 backward pair
// of flash_bwd_tf32x3.cu: each product stays within about 2^-21 of its f32
// value, so the kernel is held to the f32 limit (1e-4), which a single TF32
// pass (about 2^-11) misses (chip_smoke.py gates the plain forward with its
// products in one TF32 pass past that limit).
//
// What bounds it on the H100: 4 operations per kept (query, key) pair and
// head-dim element (two products), each done three times on the tensor
// cores at 494.7 TFLOP/s dense TF32: 3 * 4 * pairs * D * H * B / 494.7e12
// (0.104 ms at B8 H16 S1024 D64 causal, 0.026 ms at B1 H16 S1024 D128
// causal), against 4 * pairs * D * H * B / 67e12 on the CUDA cores, where
// the kernel this one replaces ran (scalar shared-memory loads, 31 % of
// that bound at the training shape). Bytes are far below either: q, k, v
// and o once each.
//
// Layout: one block of four warps per (b*H + h, 64*MT-row query tile); each
// warp owns MT m16 row tiles (two at D 16 and 64, one at D 128, where two
// would take 128 accumulator registers a thread for O alone). The block
// walks 32-key tiles up to the causal edge; the next K and V tiles arrive
// by 16-byte cp.async into the second of two buffers while the current ones
// are multiplied, zero-filled past Sk. Shared rows are padded to D + 4
// floats, so the fragment reads X[g][t] and X[2t][g] hit 32 different
// banks. A tile wholly above the causal diagonal is never loaded; a warp
// whose last row sees none of a tile's keys (or whose rows lie past Sq)
// skips it; only tiles on the diagonal or at the ragged ends are masked.
// The longest query walks (the last query tiles) have the lowest
// blockIdx.y and are dispatched first.
//
// Per key tile a warp computes S = Q K^T (mma_abt: each Q fragment split
// once for the tile's four key n-tiles, each K fragment once for the warp's
// row tiles), then the online softmax in registers: a C fragment holds rows
// g and g+8 at keys 2t, 2t+1 of each n-tile, so the four threads of a quad
// own a row and reduce its max by two shuffles; each thread keeps its own
// share of the running sum l (rescaled with the max; the quad adds the
// shares once, at the end). P then feeds O += P V straight from the S
// accumulators (mma_cx: logical k = t is key 2t, so a = (c0, c2, c1, c3),
// and V's B rows are read in that order).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;


constexpr int BKT = 32;   // keys a step
template <int D>
constexpr int MT = D == 128 ? 1 : 2;
template <int D>
constexpr int BQ = 64 * MT<D>;   // query rows a block

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) *
         ((size_t)BQ<D> * (D + 4) + (size_t)4 * BKT * (D + 4));
}

// grid (B*H, query tiles), the last query tile (the longest walk) at y = 0
template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_tf32x3_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int Sq, int Sk, float scale, int causal) {
  constexpr int M = MT<D>, BQR = BQ<D>, BK = BKT, DP = D + 4;
  constexpr int NJ = BK / 8, NN = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;               // [BQR][DP]
  float* sK = sQ + BQR * DP;      // [2][BK][DP]
  float* sV = sK + 2 * BK * DP;   // [2][BK][DP]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const long long qb = (long long)bh * Sq * D;
  const long long kb = (long long)bh * Sk * D;
  const int offset = Sk - Sq;
  const int row_w = q0 + warp * 16 * M;   // the warp's first row
  // the last row q0 + BQR - 1 sees keys up to q0 + BQR - 1 + offset
  const int k_end = causal ? min(Sk, q0 + BQR + offset) : Sk;
  const int nk = (k_end + BK - 1) / BK;

  load_rows<D, BQR>(sQ, q + qb, q0, Sq);
  load_rows<D, BK>(sK, k + kb, 0, Sk);
  load_rows<D, BK>(sV, v + kb, 0, Sk);
  cp_async_commit();

  float acc[M][NN][4], mx[M][2], ls[M][2];
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[m][h] = -INFINITY;
      ls[m][h] = 0.f;
    }
  }

  const float* wQ = sQ + warp * 16 * M * DP;
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {
      const int k1 = (kt + 1) * BK;
      load_rows<D, BK>(sK + (st ^ 1) * BK * DP, k + kb, k1, Sk);
      load_rows<D, BK>(sV + (st ^ 1) * BK * DP, v + kb, k1, Sk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile kt has landed for every thread

    const int k0 = kt * BK;
    // the warp's rows lie past Sq, or its last row sees none of the
    // tile's keys: nothing to add
    if (row_w < Sq && (!causal || k0 <= row_w + 16 * M - 1 + offset)) {
      const float* K = sK + st * BK * DP;
      const float* V = sV + st * BK * DP;
      const bool edge = row_w + 16 * M > Sq || k0 + BK > Sk ||
                        (causal && k0 + BK - 1 > row_w + offset);

      float s[M][NJ][4];
      mma_abt<D, M, NJ>(s, wQ, K, g, t);   // S = Q K^T
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row_w + 16 * m + g + 8 * h;
          float tile_max = -INFINITY;
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int key = k0 + 8 * j + 2 * t + c;
              const bool valid = !edge || (row < Sq && key < Sk &&
                                           (!causal || key <= row + offset));
              const float x = valid ? s[m][j][2 * h + c] * scale : -INFINITY;
              s[m][j][2 * h + c] = x;
              tile_max = fmaxf(tile_max, x);
            }
          // the quad's four threads hold the row's keys
          tile_max = fmaxf(tile_max,
                           __shfl_xor_sync(0xffffffffu, tile_max, 1));
          tile_max = fmaxf(tile_max,
                           __shfl_xor_sync(0xffffffffu, tile_max, 2));
          const float m_new = fmaxf(mx[m][h], tile_max);
          const float safe = m_new == -INFINITY ? 0.f : m_new;
          const float alpha =
              mx[m][h] == -INFINITY ? 0.f : expf(mx[m][h] - safe);
          float rs = 0.f;
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float x = s[m][j][2 * h + c];
              const float p = x == -INFINITY ? 0.f : expf(x - safe);
              s[m][j][2 * h + c] = p;
              rs += p;
            }
          ls[m][h] = alpha * ls[m][h] + rs;
          mx[m][h] = m_new;
#pragma unroll
          for (int n = 0; n < NN; ++n) {
            acc[m][n][2 * h] *= alpha;
            acc[m][n][2 * h + 1] *= alpha;
          }
        }
      mma_cx<D, M, NJ>(acc, s, V, g, t);   // O += P V
    }
    __syncthreads();  // every warp is done with stage st before its refill
  }

#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = ls[m][h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = row_w + 16 * m + 8 * h + g;
      if (row >= Sq) continue;
      const float safe_l = l == 0.f ? 1.f : l;
#pragma unroll
      for (int n = 0; n < NN; ++n)
        *reinterpret_cast<float2*>(o + qb + (long long)row * D + 8 * n +
                                   2 * t) =
            make_float2(acc[m][n][2 * h] / safe_l,
                        acc[m][n][2 * h + 1] / safe_l);
      if (t == 0)
        lse[(long long)bh * Sq + row] =
            l == 0.f ? -INFINITY : mx[m][h] + logf(safe_l);
    }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, int BH, int Sq, int Sk, float scale,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32x3_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (Sq + BQ<D> - 1) / BQ<D>);
  flash_fwd_tf32x3_kernel<D><<<grid, NT, smem, stream>>>(
      q, k, v, o, lse, Sq, Sk, scale, causal);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// flash_fwd_wgmma's arguments. dtype must be 0 (float32). q [B,H,Sq,D], k/v
// [B,H,Sk,D] f32 on 16-byte boundaries (cp.async reads 16-byte chunks), o
// like q, lse [B,H,Sq] f32, all contiguous on the current device; D 16, 64
// or 128.
extern "C" int flash_fwd_tf32x3(const void* q, const void* k, const void* v,
                                void* o, void* lse, int B, int H, int Sq,
                                int Sk, int D, int dtype, float scale,
                                int causal, void* stream) {
  if (dtype != 0 || Sq < 1 || Sq > Sk || !aligned16(q) || !aligned16(k) ||
      !aligned16(v))
    return cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(qf, kf, vf, of, lf, B * H, Sq, Sk, scale, causal, st);
    case 64:
      return launch<64>(qf, kf, vf, of, lf, B * H, Sq, Sk, scale, causal, st);
    case 128:
      return launch<128>(qf, kf, vf, of, lf, B * H, Sq, Sk, scale, causal,
                         st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
