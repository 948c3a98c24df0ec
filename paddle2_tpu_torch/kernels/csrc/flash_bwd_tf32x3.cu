// FlashAttention-2 backward in float32 for Hopper (sm_90a), the split pair
// on the tensor cores in error-compensated TF32 (3xTF32).
//
// Replaces two kernels of paddle2_tpu/kernels/pallas_flash.py, driven by
// `_flash_bwd` (the split route, f32's default backward route):
//   flash_bwd_dkv_tf32x3_kernel <- `_bwd_dkv_kernel` (split route, 1 of 2)
//   flash_bwd_dq_tf32x3_kernel  <- `_bwd_dq_kernel`  (split route, 2 of 2)
// flash_bwd.cu keeps the bf16 split pair (reached only by route="split")
// and the f32 fused kernel; its f32 split entries refuse, so each dtype and
// route has exactly one kernel.
//
// On (B, H, S, D) f32 tensors with the saved row log-sum-exp `lse` and
// delta = rowsum(dO*O) (both f32, computed outside), per score tile:
//   P  = exp(Q K^T * scale - lse)      (0 where masked or lse == -inf)
//   dP = dO V^T,  dS = P * (dP - delta)
//   dV += P^T dO,  dK += dS^T Q * scale,  dQ += dS K * scale
// with the causal mask aligned to the bottom right (row r sees keys
// c <= r + Sk - Sq), any Sq <= Sk, ragged tiles at both ends. expf is the
// full-precision one. No atomics and a fixed summation order: two runs give
// bitwise-equal outputs.
//
// Products: 3xTF32 on mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.
// Each f32 operand x is split once in registers as it enters a fragment
// into big (x rounded to TF32, to nearest, ties away from zero) and small =
// x - big (exact), and each product accumulates a_small*b_big, then
// a_big*b_small, then a_big*b_big in f32 (the terms and the order of
// CUTLASS's OpMultiplyAddFastF32). The dropped small*small term and the
// tensor cores' truncation of small leave each product within about 2^-21
// of its f32 value, so the kernels are held to the f32 limit (1e-4). A
// single TF32 pass (about 2^-11) is not: chip_smoke.py checks that the
// plain backward with its operands rounded to TF32 reads past that limit.
// Deviation from the design first written (cvt.rna.tf32.f32 for both
// halves): big is the same rounding done as an integer add and mask, and
// small goes to the mma unrounded, the tensor cores reading only its top
// 19 bits. The compiler wraps cvt.rna.tf32.f32 in NaN and infinity tests
// that made the split the pair's largest cost: the pair took 1.59 ms
// against 1.25 at the training shape on an H100, and rounding small to
// nearest as well 1.35 (flash_bwd_tf32x3_variants.py).
//
// What bounds it on the H100: 8 (dK/dV) and 6 (dQ) operations per kept
// (query, key) pair and head-dim element, each product done three times on
// the tensor cores at 494.7 TFLOP/s dense TF32: 3 * ops / 494.7e12 (0.209 ms
// and 0.156 ms at B8 H16 S1024 D64 causal), against ops / 67e12 on the CUDA
// cores (0.513 and 0.385 ms), 2.5x lower. The CUDA-core pair of flash_bwd.cu
// was bound by shared-memory loads (8 scalar loads for 16 FMAs); here a
// fragment load feeds three mma of 128 FMAs each, an A fragment is split
// once and reused across a whole row of n-tiles, and a B fragment across
// the warp's two row tiles. mma.sync, not wgmma: wgmma takes tf32 operands
// from shared memory only K-major, and the B operands of dV = P^T dO,
// dK = dS^T Q (dO, Q) and dQ = dS K (K) are MN-major; wgmma would need
// transposed copies of those tiles (a later step).
//
// P and dS become A fragments with no shuffles. A tf32 m16n8k8 C fragment
// holds columns (2t, 2t+1) of rows g and g+8 (g = lane / 4, t = lane % 4);
// an A fragment wants columns (t, t+4). The order of the reduction inside
// one k8 step is free, so logical k = t is column 2t and k = t + 4 is column
// 2t + 1: a = (c0, c2, c1, c3) as they stand, and B's rows are read in the
// same order, b0 = X[2t][g], b1 = X[2t+1][g].
// tests/test_torch_flash_bwd_tf32x3.py mirrors this mapping on the host.
// The split, the products, the cp.async staging and both fragment walks
// are in tf32x3.cuh, shared with the f32 forward (flash_fwd_tf32x3.cu).
//
// Each warp owns MT m16 row tiles: two (32 rows) at D 16 and 64, one at
// D 128, where two would take 256 accumulator registers a thread.
// dK/dV kernel: one block per (b*H + h, 64*MT-key tile), four warps. It
// computes the transposed tiles S^T = K Q^T and dP^T = V dO^T, so that each
// accumulator row is a key and lse, delta are indexed by column, then
// dV += P^T dO and dK += dS^T Q with P^T, dS^T straight from those
// accumulators; dK and dV stay in registers over the whole walk. It walks
// 32-row query tiles from the first one the causal mask lets reach its key
// tile; a warp whose keys the tile's last row does not reach (or which
// lie past Sk) skips it.
// dQ kernel: one block per (b*H + h, 64*MT-row query tile), four warps,
// walking 32-key tiles up to the causal edge; dQ stays in registers; a
// warp whose last row reaches none of a tile's keys (or whose rows lie
// past Sq) skips it. In both, the
// tile a block walks over (Q, dO, lse, delta; or K, V) arrives by 16-byte
// cp.async into two buffers, the next tile in flight while the current one
// is multiplied, zero-filled past the sequence end. Shared rows are padded
// to D + 4 floats: 16-byte aligned for cp.async, and the fragment reads
// X[g][t] and X[2t][g] hit 32 different banks. A tile wholly above the
// causal diagonal is never loaded; only tiles on the diagonal or the
// ragged ends are masked. The heaviest blocks (the longest walks) have the
// lowest blockIdx.y and are dispatched first. On the H100 the pair takes
// about 3.4x its 3xTF32 bound at the training shape (1.25 against 0.365
// ms); one row tile a warp, 64-row steps and full unrolling moved it by
// under 5 % or spilled (flash_bwd_tf32x3_variants.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int DKV_BQ = 32;  // query rows a dK/dV step
constexpr int BKD = 32;     // keys a dQ step

// m16 row tiles a warp owns: two, so that each B fragment is loaded and
// split once for 32 rows; one at D 128, where two would need 256
// accumulator registers a thread
template <int D>
constexpr int MT = D == 128 ? 1 : 2;
template <int D>
constexpr int DKV_BK = 64 * MT<D>;   // keys a dK/dV block
template <int D>
constexpr int DQ_BQ = 64 * MT<D>;    // query rows a dQ block

template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * ((size_t)2 * DKV_BK<D> * (D + 4) +
                          (size_t)4 * DKV_BQ * (D + 4) + (size_t)4 * DKV_BQ);
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) *
         ((size_t)2 * DQ_BQ<D> * (D + 4) + (size_t)4 * BKD * (D + 4));
}

// grid (B*H, key tiles), the first key tile (the longest walk) at y = 0
template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_tf32x3_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk,
    float scale, int causal) {
  constexpr int M = MT<D>, BKV = DKV_BK<D>, BQ = DKV_BQ, DP = D + 4;
  constexpr int NJ = BQ / 8, NN = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                // [BKV][DP]
  float* sV = sK + BKV * DP;       // [BKV][DP]
  float* sQ = sV + BKV * DP;       // [2][BQ][DP]
  float* sdO = sQ + 2 * BQ * DP;   // [2][BQ][DP]
  float* sL = sdO + 2 * BQ * DP;   // [2][BQ]
  float* sDl = sL + 2 * BQ;        // [2][BQ]

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BKV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const long long qb = (long long)bh * Sq * D;
  const long long kb = (long long)bh * Sk * D;
  const float* lse_bh = lse + (long long)bh * Sq;
  const float* delta_bh = delta + (long long)bh * Sq;
  const int offset = Sk - Sq;
  const int nq = (Sq + BQ - 1) / BQ;
  // the first query tile whose last row reaches key k0 (k0 < Sk, so the
  // last row Sq - 1, which sees Sk - 1, always does: qt < nq)
  const int qt0 = causal && k0 - offset > 0 ? (k0 - offset) / BQ : 0;

  auto load_q_tile = [&](int st, int qt) {
    const int q0 = qt * BQ;
    load_rows<D, BQ>(sQ + st * BQ * DP, q + qb, q0, Sq);
    load_rows<D, BQ>(sdO + st * BQ * DP, dout + qb, q0, Sq);
    load_vec<BQ>(sL + st * BQ, lse_bh, q0, Sq);
    load_vec<BQ>(sDl + st * BQ, delta_bh, q0, Sq);
  };
  load_rows<D, BKV>(sK, k + kb, k0, Sk);
  load_rows<D, BKV>(sV, v + kb, k0, Sk);
  load_q_tile(0, qt0);
  cp_async_commit();

  float dka[M][NN][4], dva[M][NN][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[m][n][e] = dva[m][n][e] = 0.f;

  const int key_w = k0 + warp * 16 * M;  // the warp's first key
  const float* wK = sK + warp * 16 * M * DP;
  const float* wV = sV + warp * 16 * M * DP;
  for (int qt = qt0; qt < nq; ++qt) {
    const int st = (qt - qt0) & 1;
    if (qt + 1 < nq) load_q_tile(st ^ 1, qt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile qt has landed for every thread

    const int q0 = qt * BQ;
    // the warp's keys lie past Sk, or the tile's last row sees none of
    // them: nothing to add
    if (key_w < Sk && (!causal || key_w <= q0 + BQ - 1 + offset)) {
      const float* Q = sQ + st * BQ * DP;
      const float* dO = sdO + st * BQ * DP;
      const float* L = sL + st * BQ;
      const float* Dl = sDl + st * BQ;
      const bool edge = q0 + BQ > Sq || key_w + 16 * M > Sk ||
                        (causal && key_w + 16 * M - 1 > q0 + offset);

      // P^T: rows are keys, columns queries
      float s[M][NJ][4];
      mma_abt<D, M, NJ>(s, wK, Q, g, t);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(L + 8 * j + 2 * t);
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = key_w + 16 * m + g + (e >> 1) * 8;
            const int qr = q0 + 8 * j + 2 * t + (e & 1);
            const float lq = (e & 1) ? l.y : l.x;
            const bool valid = !edge || (qr < Sq && key < Sk &&
                                         (!causal || key <= qr + offset));
            s[m][j][e] = (valid && lq != -INFINITY)
                             ? expf(s[m][j][e] * scale - lq) : 0.f;
          }
      }
      mma_cx<D, M, NJ>(dva, s, dO, g, t);  // dV += P^T dO

      float dp[M][NJ][4];
      mma_abt<D, M, NJ>(dp, wV, dO, g, t);  // dP^T = V dO^T
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 dl =
            *reinterpret_cast<const float2*>(Dl + 8 * j + 2 * t);
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[m][j][e] =
                s[m][j][e] * (dp[m][j][e] - ((e & 1) ? dl.y : dl.x));
      }
      mma_cx<D, M, NJ>(dka, dp, Q, g, t);  // dK += dS^T Q (scaled below)
    }
    __syncthreads();  // every warp is done with stage st before its refill
  }

#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key_w + 16 * m + 8 * h + g;
      if (key >= Sk) continue;
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        const long long at = kb + (long long)key * D + 8 * n + 2 * t;
        *reinterpret_cast<float2*>(dk + at) = make_float2(
            dka[m][n][2 * h] * scale, dka[m][n][2 * h + 1] * scale);
        *reinterpret_cast<float2*>(dv + at) =
            make_float2(dva[m][n][2 * h], dva[m][n][2 * h + 1]);
      }
    }
}

// grid (B*H, query tiles), the last query tile (the longest walk) at y = 0
template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_tf32x3_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int Sq, int Sk, float scale, int causal) {
  constexpr int M = MT<D>, BQR = DQ_BQ<D>, DP = D + 4;
  constexpr int NJ = BKD / 8, NN = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                // [BQR][DP]
  float* sdO = sQ + BQR * DP;      // [BQR][DP]
  float* sK = sdO + BQR * DP;      // [2][BKD][DP]
  float* sV = sK + 2 * BKD * DP;   // [2][BKD][DP]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const long long qb = (long long)bh * Sq * D;
  const long long kb = (long long)bh * Sk * D;
  const int offset = Sk - Sq;
  const int row_w = q0 + warp * 16 * M;   // the warp's first row
  float lr[M][2], dr[M][2];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row_w + 16 * m + 8 * h + g;
      lr[m][h] = r < Sq ? lse[(long long)bh * Sq + r] : 0.f;
      dr[m][h] = r < Sq ? delta[(long long)bh * Sq + r] : 0.f;
    }
  // the last row q0 + BQR - 1 sees keys up to q0 + BQR - 1 + offset
  const int k_end = causal ? min(Sk, q0 + BQR + offset) : Sk;
  const int nk = (k_end + BKD - 1) / BKD;

  load_rows<D, BQR>(sQ, q + qb, q0, Sq);
  load_rows<D, BQR>(sdO, dout + qb, q0, Sq);
  load_rows<D, BKD>(sK, k + kb, 0, Sk);
  load_rows<D, BKD>(sV, v + kb, 0, Sk);
  cp_async_commit();

  float dqa[M][NN][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[m][n][e] = 0.f;

  const float* wQ = sQ + warp * 16 * M * DP;
  const float* wdO = sdO + warp * 16 * M * DP;
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {
      const int k1 = (kt + 1) * BKD;
      load_rows<D, BKD>(sK + (st ^ 1) * BKD * DP, k + kb, k1, Sk);
      load_rows<D, BKD>(sV + (st ^ 1) * BKD * DP, v + kb, k1, Sk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile kt has landed for every thread

    const int k0 = kt * BKD;
    // the warp's rows lie past Sq, or its last row sees none of the
    // tile's keys: nothing to add
    if (row_w < Sq && (!causal || k0 <= row_w + 16 * M - 1 + offset)) {
      const float* K = sK + st * BKD * DP;
      const float* V = sV + st * BKD * DP;
      const bool edge = row_w + 16 * M > Sq || k0 + BKD > Sk ||
                        (causal && k0 + BKD - 1 > row_w + offset);

      float s[M][NJ][4], dp[M][NJ][4];
      mma_abt<D, M, NJ>(s, wQ, K, g, t);    // S = Q K^T
      mma_abt<D, M, NJ>(dp, wdO, V, g, t);  // dP = dO V^T
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = row_w + 16 * m + g + (e >> 1) * 8;
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            const float l = lr[m][e >> 1];
            const bool valid = !edge || (row < Sq && key < Sk &&
                                         (!causal || key <= row + offset));
            const float p = (valid && l != -INFINITY)
                                ? expf(s[m][j][e] * scale - l) : 0.f;
            dp[m][j][e] = p * (dp[m][j][e] - dr[m][e >> 1]);
          }
      mma_cx<D, M, NJ>(dqa, dp, K, g, t);   // dQ += dS K (scaled below)
    }
    __syncthreads();  // every warp is done with stage st before its refill
  }

#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_w + 16 * m + 8 * h + g;
      if (row >= Sq) continue;
#pragma unroll
      for (int n = 0; n < NN; ++n)
        *reinterpret_cast<float2*>(dq + qb + (long long)row * D + 8 * n +
                                   2 * t) =
            make_float2(dqa[m][n][2 * h] * scale,
                        dqa[m][n][2 * h + 1] * scale);
    }
}

struct Args {
  const float *q, *k, *v, *dout, *lse, *delta;
  float *o0, *o1;
  int BH, Sq, Sk;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = dkv_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tf32x3_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.BH, (a.Sk + DKV_BK<D> - 1) / DKV_BK<D>);
  flash_bwd_dkv_tf32x3_kernel<D><<<grid, NT, smem, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.o0, a.o1, a.Sq, a.Sk,
      a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tf32x3_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.BH, (a.Sq + DQ_BQ<D> - 1) / DQ_BQ<D>);
  flash_bwd_dq_tf32x3_kernel<D><<<grid, NT, smem, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.o0, a.Sq, a.Sk, a.scale,
      a.causal);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int run(bool dkv, int D, int dtype, const Args& a) {
  // f32 only; cp.async reads 16-byte chunks of q, k, v and dout
  if (dtype != 0 || !aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v) ||
      !aligned16(a.dout))
    return cudaErrorInvalidValue;
  switch (D) {
    case 16: return dkv ? launch_dkv<16>(a) : launch_dq<16>(a);
    case 64: return dkv ? launch_dkv<64>(a) : launch_dq<64>(a);
    case 128: return dkv ? launch_dkv<128>(a) : launch_dq<128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The arguments of flash_bwd.cu's flash_bwd_dkv / flash_bwd_dq. dtype must
// be 0 (float32). q/dout [B,H,Sq,D], k/v [B,H,Sk,D] f32 on 16-byte
// boundaries; lse and delta [B,H,Sq] f32; all contiguous on the current
// device.

// kernel 1: dk, dv [B,H,Sk,D] f32
extern "C" int flash_bwd_dkv_tf32x3(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int B, int H, int Sq,
                                    int Sk, int D, int dtype, float scale,
                                    int causal, void* stream) {
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<const float*>(dout),
         static_cast<const float*>(lse), static_cast<const float*>(delta),
         static_cast<float*>(dk), static_cast<float*>(dv), B * H, Sq, Sk,
         scale, causal, static_cast<cudaStream_t>(stream)};
  return run(true, D, dtype, a);
}

// kernel 2: dq [B,H,Sq,D] f32
extern "C" int flash_bwd_dq_tf32x3(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, int B, int H, int Sq, int Sk,
                                   int D, int dtype, float scale, int causal,
                                   void* stream) {
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<const float*>(dout),
         static_cast<const float*>(lse), static_cast<const float*>(delta),
         static_cast<float*>(dq), nullptr, B * H, Sq, Sk, scale, causal,
         static_cast<cudaStream_t>(stream)};
  return run(false, D, dtype, a);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
