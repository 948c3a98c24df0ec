// FlashAttention forward for Hopper (sm_90a) on the tensor cores, bf16
// and f16 (one kernel template, instantiated for each).
//
// Replaces: paddle2_tpu/kernels/pallas_flash.py `_fwd_kernel` (tiled
// online softmax) and `_fwd_kernel_1blk` (whole row in one tile), both
// driven by `_flash_fwd`, for bf16 and f16 inputs. f32 inputs take the 3xTF32
// kernel of flash_fwd_tf32x3.cu.
//
// Computes, per (batch, head), o = softmax(q k^T * scale) v and the row
// log-sum-exp, on contiguous (B, H, S, D) tensors, D in {16, 64, 128}, 1 <= Sq
// <= Sk, with the causal mask aligned to the bottom right (row r sees keys c
// <= r + Sk - Sq). Scores, the running max m and the running sum l are f32; as
// in the Pallas kernel, p is rounded to the input type T before the p.V
// product and l sums the unrounded p (in f16 a p below 2^-14 rounds to a
// subnormal, as `p.astype(v.dtype)` does). Inside the kernel the exponentials
// are base 2 with scale * log2(e) folded into the scores; lse leaves in
// natural log. o is T, lse f32; rows >= Sq are never written.
//
// What bounds it on the H100: 4 * pairs * D * H * B operations (pairs the
// (query, key) pairs the mask keeps) against 2 * (Sq + Sk) * H * D * B 2-byte
// elements moved: operations, at 989 TFLOP/s (bf16 and f16 alike) on the
// tensor cores, which only wgmma reaches. The design keeps the flash minimum
// of device-memory traffic (the score matrix never leaves the block; K/V tiles
// are read once per 128-row query tile) and feeds the tensor cores from shared
// memory that TMA fills, so no thread spends instructions on copies.
//
// Layout: one block per (b * H + h, 128-row query tile), the longest
// causal tiles launched first. Nine warps: warps 0-7 are two consumer
// warpgroups of 64 query rows each; warp 8 is the producer, whose lane 0
// issues every TMA copy: Q once, then K and V tiles of BK keys (128 for
// D <= 64, 64 for D 128) into a ring of two stages, each completing on
// its own mbarrier, so S = Q K^T of a tile can start before its V lands.
// Consumers release a stage on an `empty` mbarrier (one arrival per
// warp). Tiles wholly above the causal diagonal are never loaded; only
// tiles that cross it, or pass Sk, are masked.
//
// Per tile, each consumer warpgroup: S = Q K^T as wgmma m64nBKk16 with
// both operands K-major in shared memory (D / 16 steps); the online
// softmax on the accumulator in registers (row max and sum over the 4
// threads of a quad); P packed to T straight from the accumulator
// into wgmma's register A operand (hopper.cuh `to_a_frags`); O += P V as
// wgmma m64nSWEk16 per 64-column block of V, V MN-major (transposed) from
// shared memory. Tiles are 32- (D 16) or 128-byte swizzled (hopper.cuh).

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 128;             // query rows a block
constexpr int NCW = 8;              // consumer warps: two warpgroups
constexpr int NT = NCW * 32 + 32;   // + the producer warp
constexpr int STAGES = 2;

template <int D>
struct Cfg {
  static constexpr int SWE = D < 64 ? D : 64;  // elements a swizzled row
  static constexpr int SWB = SWE * 2;          // its bytes: 32 or 128
  static constexpr int NCB = D / SWE;          // column blocks
  static constexpr int BK = D == 128 ? 64 : 128;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + STAGES * KV_BYTES;
  static constexpr int SMEM = OFF_BAR + 64 + 1024;  // + alignment slack
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "alignment");
};

template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           T* __restrict__ o,
                           float* __restrict__ lse, int Sq, int Sk,
                           float scale_log2, int causal) {
  using C = Cfg<D>;
  constexpr int SWE = C::SWE, SWB = C::SWB, NCB = C::NCB, BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sQ = smem;
  uint8_t* sK = smem + C::OFF_K;
  uint8_t* sV = smem + C::OFF_V;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + STAGES;
  uint64_t* empty = bars + 1 + 2 * STAGES;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int offset = Sk - Sq;
  // the block's last row q0 + BQ - 1 sees keys up to q0 + BQ - 1 + offset
  const int k_end = causal ? min(Sk, q0 + BQ + offset) : Sk;
  const int n_tiles = (k_end + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], NCW);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == NCW) {  // producer
    if (lane == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int cb = 0; cb < NCB; ++cb)
        tma_load_3d(sQ + cb * BQ * SWB, &tq, q_full, cb * SWE, q0, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        uint8_t* k_dst = sK + s * C::KV_BYTES;
        uint8_t* v_dst = sV + s * C::KV_BYTES;
        mbar_expect_tx(&k_full[s], C::KV_BYTES);
        for (int cb = 0; cb < NCB; ++cb)
          tma_load_3d(k_dst + cb * BK * SWB, &tk, &k_full[s], cb * SWE,
                      i * BK, bh);
        mbar_expect_tx(&v_full[s], C::KV_BYTES);
        for (int cb = 0; cb < NCB; ++cb)
          tma_load_3d(v_dst + cb * BK * SWB, &tv, &v_full[s], cb * SWE,
                      i * BK, bh);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows q0 + 64 wg .. q0 + 64 wg + 63; this
  // thread rows row0 and row0 + 8 of them
  const int wg = warp / 4;
  const int row0 = q0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  const uint32_t q_base = smem_u32(sQ) + wg * 64 * SWB;

  float acc[NCB][SWE / 2];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < SWE / 2; ++i) acc[cb][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const uint32_t ph = (i / STAGES) & 1;
    const int k0 = i * BK;
    const uint32_t k_base = smem_u32(sK + s * C::KV_BYTES);
    const uint32_t v_base = smem_u32(sV + s * C::KV_BYTES);

    float sc[BK / 2];
    mbar_wait(&k_full[s], ph);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int cb = ks * 16 / SWE;
      const uint32_t at = (ks * 16 % SWE) * 2;
      wgmma_ss<0, 0, T>(
          sc, make_desc<SWB>(q_base + cb * BQ * SWB + at, 8 * SWB),
          make_desc<SWB>(k_base + cb * BK * SWB + at, 8 * SWB), ks > 0);
    }
    wg_commit();
    wg_wait<0>();
    pin(sc);

    // online softmax, base 2
    const bool masked = k0 + BK > Sk ||
                        (causal && k0 + BK - 1 > q0 + wg * 64 + offset);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = sc[4 * j + 2 * h + e] * scale_log2;
          if (masked) {
            const int c = k0 + 8 * j + col0 + e;
            if (c >= Sk || (causal && c > row0 + 8 * h + offset))
              x = -INFINITY;
          }
          sc[4 * j + 2 * h + e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float safe = mx[h] == -INFINITY ? 0.f : mx[h];
      alpha[h] = exp2f(m[h] - safe);  // 0 while m is -inf
      m[h] = mx[h];
      mx[h] = safe;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(sc[4 * j + 2 * h + e] - mx[h]);
          sc[4 * j + 2 * h + e] = p;
          sum[h] += p;
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int j = 0; j < SWE / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) acc[cb][4 * j + 2 * h + e] *= alpha[h];

    uint32_t pa[BK / 16][4];
    to_a_frags<T>(sc, pa);
    mbar_wait(&v_full[s], ph);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
        wgmma_rs<1, T>(acc[cb], pa[kk],
                    make_desc<SWB>(v_base + cb * BK * SWB + kk * 16 * SWB,
                                   8 * SWB),
                    1);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) pin(acc[cb]);
    pin(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= Sq) continue;
    const float inv = l[h] == 0.f ? 1.f : 1.f / l[h];
    T* orow = o + ((long long)bh * Sq + row) * D;
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int j = 0; j < SWE / 8; ++j) {
        const int c = cb * SWE + 8 * j + col0;
        store2<T>(orow + c, acc[cb][4 * j + 2 * h] * inv,
                  acc[cb][4 * j + 2 * h + 1] * inv);
      }
    if (lane % 4 == 0)
      lse[(long long)bh * Sq + row] =
          l[h] == 0.f ? -INFINITY : (m[h] + log2f(l[h])) * LN2;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int Sq, int Sk, float scale,
                   int causal, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv;
  if (!tile_map(&tq, q, B * H, Sq, D, C::SWE, BQ, tma_type<T>()) ||
      !tile_map(&tk, k, B * H, Sk, D, C::SWE, C::BK, tma_type<T>()) ||
      !tile_map(&tv, v, B * H, Sk, D, C::SWE, C::BK, tma_type<T>()))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_fwd_wgmma_kernel<T, D><<<grid, NT, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<T*>(o), static_cast<float*>(lse),
      Sq, Sk, scale * LOG2E, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     void* lse, int B, int H, int Sq, int Sk, int D,
                     float scale, int causal, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, B, H, Sq, Sk, scale, causal, s);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, H, Sq, Sk, scale, causal, s);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, H, Sq, Sk, scale, causal,
                            s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// flash_fwd's signature; dtype 1 (bfloat16) or 2 (float16), others
// refused. q [B,H,Sq,D], k/v [B,H,Sk,D] in dtype, o like q, lse [B,H,Sq]
// f32, all contiguous on the current device, each 16-byte aligned (TMA).
extern "C" int flash_fwd_wgmma(const void* q, const void* k, const void* v,
                               void* o, void* lse, int B, int H, int Sq,
                               int Sk, int D, int dtype, float scale,
                               int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, lse, B, H, Sq, Sk, D, scale,
                                   causal, s);
  if (dtype == 2)
    return launch_d<__half>(q, k, v, o, lse, B, H, Sq, Sk, D, scale, causal,
                            s);
  return cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
