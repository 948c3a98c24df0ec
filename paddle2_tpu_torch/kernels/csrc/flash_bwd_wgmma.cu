// Fused FlashAttention backward for Hopper (sm_90a) on the tensor cores,
// bf16 and f16 (one kernel template T, instantiated for each).
//
// Replaces: paddle2_tpu/kernels/pallas_flash.py `_bwd_fused_1blk_kernel`
// (the fused route of `_flash_bwd`) for bf16 and f16 inputs. f32 inputs,
// and the split route in every dtype, keep the CUDA-core kernels of
// flash_bwd.cu (f32's split pair is flash_bwd_tf32x3.cu's).
//
// On contiguous (B, H, S, D) tensors, D in {16, 64, 128}, 1 <= Sq <= Sk,
// with the saved row log-sum-exp `lse` and delta = rowsum(dO * O) (both
// f32, computed outside), per score tile:
//   P  = exp(Q K^T * scale - lse)      (0 where masked or lse == -inf)
//   dS = P * (dO V^T - delta)
//   dV += P^T dO,  dK += dS^T Q * scale,  dQ += dS K * scale
// with the causal mask aligned to the bottom right (row r sees keys
// c <= r + Sk - Sq). As in the Pallas kernel, P and dS are rounded to T
// before each product and every sum is f32; s * scale is rounded once
// (__fmul_rn), as the plain version rounds it, before lse is subtracted.
// In f16 nothing is clamped: under loss scaling dS or dV may overflow
// f16's 65,504 to inf where the Pallas kernel's casts do, and the loss
// scaler then skips the step. dK and dV are written in T; dQ is added
// into an f32 buffer the caller zeroed, a tile at a time by TMA bulk
// reductions (cp.reduce.async.bulk.tensor) whose order
// changes from run to run, so dQ is not bitwise deterministic (dK and dV
// are).
//
// What bounds it on the H100: 10 * pairs * D * H * B operations (five
// products; pairs the (query, key) pairs the mask keeps) against
// (3 Sq + 4 Sk) * H * D * B 2-byte elements moved: operations, on the
// tensor cores, reached only through wgmma.
//
// Layout: one block per (b * H + h, 128-key tile), the longest causal
// walks launched first: two warpgroups of 64 keys each, 256 threads and no
// producer warp, so each thread may hold up to 255 registers (a producer
// warp would make the block three warpgroups and cap them at 168, which
// spilled the accumulators). Thread 0 copies the block's K and V tiles
// once, and Q and dO tiles of BQ query rows (128 for D <= 64, 64 for
// D 128) with TMA into a ring of two stages, each completing on an
// mbarrier: tile i + 1 right after the named barrier of tile i, when both
// warpgroups are done with the stage it overwrites. The threads stage the
// next tile's lse (+inf where it is -inf or past Sq, so that exp gives 0)
// and delta beside it at the top of each tile. The walk starts at the
// first query tile that reaches the block's keys under the causal mask.
// dK and dV stay in registers across the walk.
//
// Per query tile, each consumer warpgroup (keys k of its 64, queries q):
//   S^T  = K Q^T    wgmma m64nBQk16, both operands K-major in shared memory
//   dP^T = V dO^T   the same shape
//   P^T and dS^T in registers, in f32, P as the plain version computes it
//                   (expf(s * scale - lse)), then packed to T A fragments
//   dV += P^T dO    wgmma, A from registers, dO MN-major (transposed)
//   dK += dS^T Q    the same, with Q: one smem tile serves as K-major
//                   operand above and MN-major here
//   dS^T also goes to shared memory in T (128-byte swizzle, two
//   buffers, one named barrier over the 256 consumer threads a tile), and
//   dQ = dS K       wgmma with A = dS MN-major from that buffer and
//                   B = K MN-major: at BQ 128 warpgroup w takes query rows
//                   64 w .. 64 w + 63 over all 128 keys; at BQ 64 (D 128)
//                   it takes head-dim columns 64 w .. 64 w + 63
// then the warpgroup writes its dQ tile (times scale, f32) to shared
// memory and one of its threads adds it into the buffer with a TMA bulk
// reduction, which took less time than one red.global.add a value.
// All five products are wgmma; none falls back to mma.sync.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BKEY = 128;  // keys a block
constexpr int NT = 256;    // two warpgroups
constexpr int STAGES = 2;

template <int D>
struct Cfg {
  static constexpr int SWE = D < 64 ? D : 64;  // elements a swizzled row
  static constexpr int SWB = SWE * 2;          // its bytes: 32 or 128
  static constexpr int NCB = D / SWE;          // column blocks
  static constexpr int BQ = D == 128 ? 64 : 128;
  static constexpr int KV_BYTES = BKEY * D * 2;
  static constexpr int QT_BYTES = BQ * D * 2;
  static constexpr int DS_BYTES = BKEY * BQ * 2;  // dS^T, [BQ / 64][128][64]
  static constexpr int NQ = BQ == 128 ? D : 64;     // dQ columns a warpgroup
  static constexpr int DQ_BYTES = 64 * NQ * 4;      // a warpgroup's dQ, f32
  static constexpr int OFF_V = KV_BYTES;
  static constexpr int OFF_Q = 2 * KV_BYTES;
  static constexpr int OFF_DO = OFF_Q + STAGES * QT_BYTES;
  static constexpr int OFF_DS = OFF_DO + STAGES * QT_BYTES;
  static constexpr int OFF_DQ = OFF_DS + 2 * DS_BYTES;    // [2][64][NQ]
  static constexpr int OFF_L = OFF_DQ + 2 * DQ_BYTES;     // [STAGES][BQ]
  static constexpr int OFF_DL = OFF_L + STAGES * BQ * 4;  // [STAGES][BQ]
  static constexpr int OFF_BAR = OFF_DL + STAGES * BQ * 4;
  static constexpr int SMEM = OFF_BAR + 64 + 1024;  // + alignment slack
  static_assert(KV_BYTES % 1024 == 0 && QT_BYTES % 1024 == 0, "alignment");
};

template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
    flash_bwd_fused_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const __grid_constant__ CUtensorMap tdo,
                                 const __grid_constant__ CUtensorMap tdq,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 T* __restrict__ dk,
                                 T* __restrict__ dv, int Sq,
                                 int Sk, float scale, int causal) {
  using C = Cfg<D>;
  constexpr int SWE = C::SWE, SWB = C::SWB, NCB = C::NCB, BQ = C::BQ;
  constexpr int NQ = C::NQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sK = smem;
  uint8_t* sV = smem + C::OFF_V;
  uint8_t* sQ = smem + C::OFF_Q;
  uint8_t* sdO = smem + C::OFF_DO;
  uint8_t* sdS = smem + C::OFF_DS;
  float* sdQ = reinterpret_cast<float*>(smem + C::OFF_DQ);
  float* sL = reinterpret_cast<float*>(smem + C::OFF_L);
  float* sDl = reinterpret_cast<float*>(smem + C::OFF_DL);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BKEY;
  const int offset = Sk - Sq;
  // the first query row that sees key k0 is k0 - offset
  const int qt_start = causal ? max(0, k0 - offset) / BQ : 0;
  const int n_iter = (Sq + BQ - 1) / BQ - qt_start;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  // Q and dO of walk step `it` into stage it % 2 (thread 0 only)
  auto load_q_tile = [&](int it) {
    const int st_ = it % STAGES;
    const int q0 = (qt_start + it) * BQ;
    mbar_expect_tx(&full[st_], 2 * C::QT_BYTES);
    for (int cb = 0; cb < NCB; ++cb) {
      tma_load_3d(sQ + st_ * C::QT_BYTES + cb * BQ * SWB, &tq, &full[st_],
                  cb * SWE, q0, bh);
      tma_load_3d(sdO + st_ * C::QT_BYTES + cb * BQ * SWB, &tdo, &full[st_],
                  cb * SWE, q0, bh);
    }
  };
  // lse and delta of walk step `it` into stage it % 2 (threads < BQ)
  auto stage_rows = [&](int it) {
    if (tid >= BQ) return;
    const int g = (qt_start + it) * BQ + tid;
    const float L = g < Sq ? lse[(long long)bh * Sq + g] : -INFINITY;
    sL[(it % STAGES) * BQ + tid] = L == -INFINITY ? INFINITY : L;
    sDl[(it % STAGES) * BQ + tid] =
        g < Sq ? delta[(long long)bh * Sq + g] : 0.f;
  };

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int st_ = 0; st_ < STAGES; ++st_) mbar_init(&full[st_], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kv_full, 2 * C::KV_BYTES);
    for (int cb = 0; cb < NCB; ++cb) {
      tma_load_3d(sK + cb * BKEY * SWB, &tk, kv_full, cb * SWE, k0, bh);
      tma_load_3d(sV + cb * BKEY * SWB, &tv, kv_full, cb * SWE, k0, bh);
    }
    load_q_tile(0);
  }
  stage_rows(0);
  __syncthreads();

  // consumers: warpgroup wg owns keys k0 + 64 wg .. k0 + 64 wg + 63; this
  // thread the accumulator rows r0 and r0 + 8 of them (keys, or for dQ
  // at BQ 128 query rows), and columns 8 j + col0 + e
  const int wg = warp / 4;
  const int r0 = (warp % 4) * 16 + lane / 4;
  const int key0 = k0 + wg * 64 + r0;
  const int col0 = 2 * (lane % 4);
  const uint32_t k_base = smem_u32(sK);
  const uint32_t v_base = smem_u32(sV);

  float dka[NCB][SWE / 2], dva[NCB][SWE / 2];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < SWE / 2; ++i) dka[cb][i] = dva[cb][i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % STAGES;
    const uint32_t ph = (it / STAGES) & 1;
    const int q0 = (qt_start + it) * BQ;
    const uint32_t q_base = smem_u32(sQ + s * C::QT_BYTES);
    const uint32_t do_base = smem_u32(sdO + s * C::QT_BYTES);
    const float* tL = sL + s * BQ;
    const float* tDl = sDl + s * BQ;

    // the next step's rows: stage s ^ 1 was last read before the named
    // barrier of step it - 1
    if (it + 1 < n_iter) stage_rows(it + 1);

    float st[BQ / 2], dp[BQ / 2];
    mbar_wait(&full[s], ph);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int cb = ks * 16 / SWE;
      const uint32_t at = (ks * 16 % SWE) * 2;
      wgmma_ss<0, 0, T>(
          st, make_desc<SWB>(k_base + cb * BKEY * SWB + wg * 64 * SWB + at,
                             8 * SWB),
          make_desc<SWB>(q_base + cb * BQ * SWB + at, 8 * SWB), ks > 0);
    }
    wg_commit();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int cb = ks * 16 / SWE;
      const uint32_t at = (ks * 16 % SWE) * 2;
      wgmma_ss<0, 0, T>(
          dp, make_desc<SWB>(v_base + cb * BKEY * SWB + wg * 64 * SWB + at,
                             8 * SWB),
          make_desc<SWB>(do_base + cb * BQ * SWB + at, 8 * SWB), ks > 0);
    }
    wg_commit();

    // P^T, f32: st[4 j + 2 h + e] is key key0 + 8 h, query q0 + 8 j + col0 + e
    wg_wait<1>();
    pin(st);
    const bool masked = k0 + wg * 64 + 64 > Sk ||
                        (causal && k0 + wg * 64 + 63 > q0 + offset);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + col0 + e;
          float x = __fmul_rn(st[4 * j + 2 * h + e], scale);
          if (masked) {
            const int key = key0 + 8 * h;
            if (key >= Sk || (causal && key > q0 + c + offset)) x = -INFINITY;
          }
          st[4 * j + 2 * h + e] = expf(x - tL[c]);
        }
    // dS^T = P^T * (dP^T - delta), f32, in dp's registers
    wg_wait<0>();
    pin(dp);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          dp[i] = st[i] * (dp[i] - tDl[8 * j + col0 + e]);
        }
    uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
    to_a_frags<T>(st, pa);
    to_a_frags<T>(dp, dsa);

    // dS^T into shared memory, T: row = key (of the block's 128),
    // column = query, in column blocks of 64 queries, 128-byte swizzle
    uint8_t* ds_buf = sdS + (it & 1) * C::DS_BYTES;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wg * 64 + r0 + 8 * h;
        const int c = 8 * j + col0;
        const int cc = c % 64;
        const int off = (c / 64) * (BKEY * 128) + row * 128 +
                        (((cc / 8) ^ (row % 8)) * 16) + (cc % 8) * 2;
        *reinterpret_cast<uint32_t*>(ds_buf + off) =
            dsa[j / 2][(j % 2) * 2 + h];
      }
    fence_proxy_async();

    // dV += P^T dO, dK += dS^T Q: A from registers, B MN-major
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        const uint32_t at = cb * BQ * SWB + kk * 16 * SWB;
        wgmma_rs<1, T>(dva[cb], pa[kk],
                       make_desc<SWB>(do_base + at, 8 * SWB), 1);
        wgmma_rs<1, T>(dka[cb], dsa[kk],
                       make_desc<SWB>(q_base + at, 8 * SWB), 1);
      }
    wg_commit();

    // dQ: both warpgroups' dS^T rows are in ds_buf; and both are done
    // with stage s ^ 1 (their step it - 1 ended in wg_wait<0>)
    named_barrier(1, NT);
    if (tid == 0 && it + 1 < n_iter) load_q_tile(it + 1);
    float dqa[NQ / 2];
    const uint32_t ds_base = smem_u32(ds_buf) + (BQ == 128 ? wg : 0) *
                                                    (BKEY * 128);
    const uint32_t kb_base = k_base + (BQ == 128 ? 0 : wg) * (BKEY * SWB);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < BKEY / 16; ++ks)
      wgmma_ss<1, 1, T>(dqa, make_desc<128>(ds_base + ks * 16 * 128, 8 * 128),
                     make_desc<SWB>(kb_base + ks * 16 * SWB, 8 * SWB),
                     ks > 0);
    wg_commit();
    // the dV/dK group first: its A fragments die before the dQ epilogue
    wg_wait<1>();
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) {
      pin(dka[cb]);
      pin(dva[cb]);
    }
    pin(pa);
    pin(dsa);
    wg_wait<0>();
    pin(dqa);

    // dQ * scale through this warpgroup's f32 tile in shared memory,
    // added into dq32 by one TMA bulk reduction (rows past Sq dropped)
    float* dq_tile = sdQ + wg * 64 * NQ;
    const bool issuer = tid % 128 == 0;
    if (issuer) bulk_wait_read();  // the last step's reduction read it
    named_barrier(2 + wg, 128);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j)
        *reinterpret_cast<float2*>(dq_tile + (r0 + 8 * h) * NQ + 8 * j +
                                   col0) =
            make_float2(dqa[4 * j + 2 * h] * scale,
                        dqa[4 * j + 2 * h + 1] * scale);
    fence_proxy_async();
    named_barrier(2 + wg, 128);
    if (issuer) {
      tma_reduce_add_3d(&tdq, dq_tile, BQ == 128 ? 0 : wg * 64,
                        q0 + (BQ == 128 ? wg * 64 : 0), bh);
      bulk_commit();
    }
  }
  if (tid % 128 == 0) bulk_wait();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    if (key >= Sk) continue;
    const long long at = ((long long)bh * Sk + key) * D;
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int j = 0; j < SWE / 8; ++j) {
        const int c = cb * SWE + 8 * j + col0;
        const int i = 4 * j + 2 * h;
        store2<T>(dk + at + c, dka[cb][i] * scale, dka[cb][i + 1] * scale);
        store2<T>(dv + at + c, dva[cb][i], dva[cb][i + 1]);
      }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq32, void* dk, void* dv, int B, int H, int Sq,
                   int Sk, float scale, int causal, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv, tdo, tdq;
  constexpr CUtensorMapDataType ty = tma_type<T>();
  if (!tile_map(&tq, q, B * H, Sq, D, C::SWE, C::BQ, ty) ||
      !tile_map(&tdo, dout, B * H, Sq, D, C::SWE, C::BQ, ty) ||
      !tile_map(&tk, k, B * H, Sk, D, C::SWE, BKEY, ty) ||
      !tile_map(&tv, v, B * H, Sk, D, C::SWE, BKEY, ty) ||
      !f32_map(&tdq, dq32, B * H, Sq, D, C::NQ, 64))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_fused_wgmma_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Sk + BKEY - 1) / BKEY);
  flash_bwd_fused_wgmma_kernel<T, D><<<grid, NT, C::SMEM, stream>>>(
      tq, tk, tv, tdo, tdq, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), Sq, Sk, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq32, void* dk, void* dv, int B, int H, int Sq,
                     int Sk, int D, float scale, int causal,
                     cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, dout, lse, delta, dq32, dk, dv, B, H,
                           Sq, Sk, scale, causal, s);
    case 64:
      return launch<T, 64>(q, k, v, dout, lse, delta, dq32, dk, dv, B, H,
                           Sq, Sk, scale, causal, s);
    case 128:
      return launch<T, 128>(q, k, v, dout, lse, delta, dq32, dk, dv, B, H,
                            Sq, Sk, scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// flash_bwd_fused's signature; dtype 1 (bfloat16) or 2 (float16), others
// refused. q/dout [B,H,Sq,D], k/v [B,H,Sk,D] in dtype, each 16-byte
// aligned (TMA); lse and delta [B,H,Sq] f32; dq32 [B,H,Sq,D] f32, zeroed
// by the caller; dk, dv [B,H,Sk,D] in dtype; all contiguous on the current
// device.
extern "C" int flash_bwd_fused_wgmma(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dq32, void* dk, void* dv, int B,
                                     int H, int Sq, int Sk, int D, int dtype,
                                     float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, dout, lse, delta, dq32, dk, dv,
                                   B, H, Sq, Sk, D, scale, causal, s);
  if (dtype == 2)
    return launch_d<__half>(q, k, v, dout, lse, delta, dq32, dk, dv, B, H,
                            Sq, Sk, D, scale, causal, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
