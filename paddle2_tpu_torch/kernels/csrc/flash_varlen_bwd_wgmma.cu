// Packed varlen FlashAttention backward for Hopper (sm_90a) on the tensor
// cores, bf16 and f16 (one kernel template T, instantiated for each): dQ,
// dK and dV in one kernel.
//
// Replaces: paddle2_tpu/kernels/pallas_flash.py `_bwd_dkv_kernel_varlen` and
// `_bwd_dq_kernel_varlen`, the pair `_varlen_bwd` drives under
// `flash_attention_varlen_packed`, for bf16 and f16 inputs. f32 inputs keep
// the CUDA-core pair of flash_varlen.cu, as the dense route keeps flash_bwd.cu
// for f32.
//
// The ragged batch is one packed sequence: q/dO [Tq, H, D], k/v [Tk, H, D],
// in T, D in {16, 64, 128}, any Tq and Tk, with an int32 segment id and
// offset per row; query row r sees key c when seg_q[r] == seg_k[c] and
// off_k[c] <= off_q[r]. With the forward's lse and delta = rowsum(dO * O)
// (both [H, Tq] f32, computed outside), per score tile:
//   P  = exp(Q K^T * scale - lse)      (0 where masked or lse == -inf)
//   dS = P * (dO V^T - delta)
//   dV += P^T dO,  dK += dS^T Q * scale,  dQ += dS K * scale
// As in the Pallas kernels (`_bwd_p_ds`), P and dS are rounded to T
// before each product and every sum is f32 (in f16 nothing is clamped: a
// dS or dV past 65,504 is inf where the Pallas kernel's cast makes it
// so). A query row that sees no key
// gets dq = 0, a key that no row sees dk = dv = 0. dK and dV are written
// in T, each by the one block that owns the key, so they are bitwise
// deterministic; dQ is added into an f32 [Tq, H, D] buffer the caller
// zeroed, a tile at a time by TMA bulk reductions
// (cp.reduce.async.bulk.tensor) whose order changes from run to run, so
// dQ is not bitwise deterministic.
//
// What bounds it on the H100: 10 * pairs * D * H operations (five
// products; pairs the (query, key) pairs the mask keeps) against
// (3 Tq + 4 Tk) * H * D 2-byte elements moved (q, dO, k, v in; dq, dk, dv
// out) plus lse, delta and the metadata: operations, on the tensor cores,
// reached only through wgmma. The f32 dQ buffer is an implementation
// choice and is left out of the bound, as in the dense kernel's. At the
// README batch (H16 D128, T 4096 packed as 1 x 2048 + 16 x 128, causal:
// 2,230,272 pairs a head) that is 4.57e10 operations / 989 TFLOP/s =
// 0.0462 ms.
//
// The design is flash_bwd_wgmma.cu's, changed only where the ragged batch
// forces it. One block per (head, 128-key tile): two consumer warpgroups
// of 64 keys each, 256 threads and no producer warp, so each thread may
// hold up to 255 registers; dK and dV stay in registers across the walk
// and leave once. Thread 0 copies the block's K and V tiles once, and Q
// and dO tiles of BQ query rows (128 for D <= 64, 64 for D 128) into a
// ring of two stages on mbarriers: tile i + 1 right after the named
// barrier of tile i, when both warpgroups are done with the stage it
// overwrites. Every copy goes through hopper.cuh `packed_map`, a 3-D
// (D, H, T) map that reads the packed rows in place, starts a box at any
// row and reads rows past T as zeros.
//
// The walk. A block walks the union of the two 64-row entries of k_tiles
// (flash_varlen.py `tile_ranges`, TILE 64) that its 128 keys cover,
// [q_lo, q_hi), in query tiles that start at q_lo wherever it lies: the
// forward's use of q_tiles transposed, so the functional layer's memo
// serves all three kernels. Blocks start longest walk first: a small
// kernel before the main one ranks the key tiles by their walks on the
// device (no host sync) and block y takes the tile of rank y, so the
// first key tiles of a long causal sequence do not start in the last
// wave.
//
// Rows. At the top of each query tile the threads of the first BQ / 32
// warps stage the next tile's lse and delta, and its rows' seg/off with a
// summary per warp (the segment its rows share, if one, and their least
// offset), beside the ring. Rows past q_hi or Tq take a segment id no key
// has and lse +inf, as rows whose lse is -inf do, so that exp gives
// P = 0 there and such rows add zeros to dq.
//
// The mask, transposed from the forward's: the keys are the accumulator's
// rows (S^T = K Q^T). Each thread keeps its two key rows' seg/off in
// registers, and each warp the segment its 16 keys share (if one) and
// their largest offset. A (warp, query tile) pair whose keys all lie in
// the one segment of the tile's rows, at or below the tile's least
// offset, skips the per-score check; otherwise each score is checked
// against the query tile's seg/off in shared memory. Keys past Tk, query
// rows past the range, and tiles of several segments take sentinel ids no
// row has; the caller's padding rows carry negative ids (-1 for queries,
// -2 for keys), which never match either.
//
// Per query tile, each consumer warpgroup (keys k of its 64, queries q):
//   S^T  = K Q^T    wgmma m64nBQk16, both operands K-major in shared memory
//   dP^T = V dO^T   the same shape
//   P^T and dS^T in registers, in f32, then packed to T A fragments
//   dV += P^T dO    wgmma, A from registers, dO MN-major (transposed)
//   dK += dS^T Q    the same, with Q
//   dS^T also goes to shared memory in T (128-byte swizzle, two
//   buffers, one named barrier over the 256 threads a tile), and
//   dQ = dS K       wgmma with A = dS MN-major from that buffer and
//                   B = K MN-major: at BQ 128 warpgroup w takes query rows
//                   64 w .. 64 w + 63 over all 128 keys; at BQ 64 (D 128)
//                   head-dim columns 64 w .. 64 w + 63
// then the warpgroup writes its dQ tile (times scale, f32) to shared
// memory and one of its threads adds it into the buffer through a packed
// f32 map (hopper.cuh `packed_f32_map`), which drops the rows past Tq.
// All five products are wgmma; none falls back to mma.sync.

#include <limits.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BKEY = 128;  // keys a block
constexpr int TILE = 64;   // rows of a k_tiles entry
constexpr int NT = 256;    // two warpgroups
constexpr int STAGES = 2;
// segment ids no row has: keys past Tk, query rows past the live range,
// 16 keys of several segments, a query tile of several
constexpr int SEG_PAST_K = INT_MIN;
constexpr int SEG_PAST_Q = INT_MIN + 1;
constexpr int SEG_MIXED_K = INT_MIN + 2;
constexpr int SEG_MIXED_Q = INT_MIN + 3;

template <int D>
struct Cfg {
  static constexpr int SWE = D < 64 ? D : 64;  // elements a swizzled row
  static constexpr int SWB = SWE * 2;          // its bytes: 32 or 128
  static constexpr int NCB = D / SWE;          // column blocks
  static constexpr int BQ = D == 128 ? 64 : 128;
  static constexpr int NW = BQ / 32;           // warps that stage rows
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
  // per stage: lse, delta, seg, off [BQ] each, then per staging warp
  // {least segment, largest segment, least offset, unused}
  static constexpr int OFF_L = OFF_DQ + 2 * DQ_BYTES;
  static constexpr int OFF_DL = OFF_L + STAGES * BQ * 4;
  static constexpr int OFF_SEG = OFF_DL + STAGES * BQ * 4;
  static constexpr int OFF_OFF = OFF_SEG + STAGES * BQ * 4;
  static constexpr int OFF_SUM = OFF_OFF + STAGES * BQ * 4;
  static constexpr int OFF_BAR = OFF_SUM + STAGES * NW * 16;
  static constexpr int SMEM = OFF_BAR + 64 + 1024;  // + alignment slack
  static_assert(KV_BYTES % 1024 == 0 && QT_BYTES % 1024 == 0, "alignment");
  static_assert(OFF_BAR % 8 == 0, "mbarrier alignment");
};

// the live query range of key tile `kb` (128 keys): the union of its two
// k_tiles entries; an empty entry is [Tq, 0), which the union ignores
__device__ __forceinline__ int2 walk_range(const int* k_tiles, int kb,
                                           int Tk) {
  const int n64 = (Tk + TILE - 1) / TILE;
  int lo = k_tiles[4 * kb], hi = k_tiles[4 * kb + 1];
  if (2 * kb + 1 < n64) {
    lo = min(lo, k_tiles[4 * kb + 2]);
    hi = max(hi, k_tiles[4 * kb + 3]);
  }
  return make_int2(lo, hi);
}

__device__ __forceinline__ int walk_tiles(int2 r, int bq) {
  return r.y > r.x ? (r.y - r.x + bq - 1) / bq : 0;
}

// order[rank] = key tile: the longest walks first, ties by tile index
__global__ void varlen_bwd_order_kernel(const int* __restrict__ k_tiles,
                                        int Tk, int bq,
                                        int* __restrict__ order) {
  const int nkb = (Tk + BKEY - 1) / BKEY;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nkb) return;
  const int mine = walk_tiles(walk_range(k_tiles, b, Tk), bq);
  int rank = 0;
  for (int j = 0; j < nkb; ++j) {
    const int w = walk_tiles(walk_range(k_tiles, j, Tk), bq);
    rank += w > mine || (w == mine && j < b);
  }
  order[rank] = b;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
    flash_varlen_bwd_fused_wgmma_kernel(
        const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv,
        const __grid_constant__ CUtensorMap tdo,
        const __grid_constant__ CUtensorMap tdq,
        const float* __restrict__ lse, const float* __restrict__ delta,
        const int* __restrict__ seg_q, const int* __restrict__ off_q,
        const int* __restrict__ seg_k, const int* __restrict__ off_k,
        const int* __restrict__ k_tiles, const int* __restrict__ order,
        T* __restrict__ dk, T* __restrict__ dv,
        int Tq, int Tk, int H, float scale) {
  using C = Cfg<D>;
  constexpr int SWE = C::SWE, SWB = C::SWB, NCB = C::NCB, BQ = C::BQ;
  constexpr int NQ = C::NQ, NW = C::NW;
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
  int* sSeg = reinterpret_cast<int*>(smem + C::OFF_SEG);
  int* sOff = reinterpret_cast<int*>(smem + C::OFF_OFF);
  int* sSum = reinterpret_cast<int*>(smem + C::OFF_SUM);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;

  const int h = blockIdx.x;
  const int k0 = order[blockIdx.y] * BKEY;
  const int2 range = walk_range(k_tiles, k0 / BKEY, Tk);
  const int q_lo = range.x, q_hi = range.y;
  const int n_iter = walk_tiles(range, BQ);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  // consumers: warpgroup wg owns keys k0 + 64 wg .. k0 + 64 wg + 63; this
  // thread the accumulator rows r0 and r0 + 8 of them (keys, or for dQ
  // at BQ 128 query rows), and columns 8 j + col0 + e
  const int wg = warp / 4;
  const int r0 = (warp % 4) * 16 + lane / 4;
  const int key0 = k0 + wg * 64 + r0;
  const int col0 = 2 * (lane % 4);

  float dka[NCB][SWE / 2], dva[NCB][SWE / 2];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < SWE / 2; ++i) dka[cb][i] = dva[cb][i] = 0.f;

  // n_iter is the block's: a tile that no query row sees writes zeros
  if (n_iter > 0) {
    // Q and dO of walk step `it` into stage it % 2 (thread 0 only)
    auto load_q_tile = [&](int it) {
      const int st_ = it % STAGES;
      const int q0 = q_lo + it * BQ;
      mbar_expect_tx(&full[st_], 2 * C::QT_BYTES);
      for (int cb = 0; cb < NCB; ++cb) {
        tma_load_3d(sQ + st_ * C::QT_BYTES + cb * BQ * SWB, &tq, &full[st_],
                    cb * SWE, h, q0);
        tma_load_3d(sdO + st_ * C::QT_BYTES + cb * BQ * SWB, &tdo,
                    &full[st_], cb * SWE, h, q0);
      }
    };
    // lse, delta and seg/off of walk step `it` into stage it % 2, and
    // each staging warp's summary of its rows (threads < BQ: whole warps)
    auto stage_rows = [&](int it) {
      if (tid >= BQ) return;
      const int st_ = it % STAGES;
      const int g = q_lo + it * BQ + tid;
      const bool live = g < q_hi;  // q_hi <= Tq
      const float L = live ? lse[(long long)h * Tq + g] : -INFINITY;
      sL[st_ * BQ + tid] = L == -INFINITY ? INFINITY : L;
      sDl[st_ * BQ + tid] = live ? delta[(long long)h * Tq + g] : 0.f;
      const int sg = live ? seg_q[g] : SEG_PAST_Q;
      const int of = live ? off_q[g] : INT_MIN;
      sSeg[st_ * BQ + tid] = sg;
      sOff[st_ * BQ + tid] = of;
      int smin = sg, smax = sg, omin = of;
#pragma unroll
      for (int w = 16; w >= 1; w >>= 1) {
        smin = min(smin, __shfl_xor_sync(0xffffffffu, smin, w));
        smax = max(smax, __shfl_xor_sync(0xffffffffu, smax, w));
        omin = min(omin, __shfl_xor_sync(0xffffffffu, omin, w));
      }
      if (lane == 0) {
        int* sum = sSum + (st_ * NW + warp) * 4;
        sum[0] = smin;
        sum[1] = smax;
        sum[2] = omin;
      }
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
        tma_load_3d(sK + cb * BKEY * SWB, &tk, kv_full, cb * SWE, h, k0);
        tma_load_3d(sV + cb * BKEY * SWB, &tv, kv_full, cb * SWE, h, k0);
      }
      load_q_tile(0);
    }
    stage_rows(0);
    __syncthreads();

    // this thread's two keys, and its warp's 16: the segment they share
    // (if one) and their largest offset
    int kseg[2], koff[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = key0 + 8 * hh;
      kseg[hh] = key < Tk ? seg_k[key] : SEG_PAST_K;
      koff[hh] = key < Tk ? off_k[key] : INT_MAX;
    }
    int wmin = min(kseg[0], kseg[1]), wmax = max(kseg[0], kseg[1]);
    int wkoff = max(koff[0], koff[1]);
#pragma unroll
    for (int w = 16; w >= 1; w >>= 1) {
      wmin = min(wmin, __shfl_xor_sync(0xffffffffu, wmin, w));
      wmax = max(wmax, __shfl_xor_sync(0xffffffffu, wmax, w));
      wkoff = max(wkoff, __shfl_xor_sync(0xffffffffu, wkoff, w));
    }
    const int warp_seg = wmin == wmax ? wmin : SEG_MIXED_K;

    const uint32_t k_base = smem_u32(sK);
    const uint32_t v_base = smem_u32(sV);
    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % STAGES;
      const uint32_t ph = (it / STAGES) & 1;
      const int q0 = q_lo + it * BQ;
      const uint32_t q_base = smem_u32(sQ + s * C::QT_BYTES);
      const uint32_t do_base = smem_u32(sdO + s * C::QT_BYTES);
      const float* tL = sL + s * BQ;
      const float* tDl = sDl + s * BQ;
      const int* tSeg = sSeg + s * BQ;
      const int* tOff = sOff + s * BQ;

      // the tile's rows: the segment they share, if one, and their least
      // offset; then the next step's rows (stage s ^ 1 was last read
      // before the named barrier of step it - 1)
      const int* sum = sSum + s * NW * 4;
      int tmin = sum[0], tmax = sum[1], toff = sum[2];
#pragma unroll
      for (int w = 1; w < NW; ++w) {
        tmin = min(tmin, sum[4 * w]);
        tmax = max(tmax, sum[4 * w + 1]);
        toff = min(toff, sum[4 * w + 2]);
      }
      const bool masked =
          !(warp_seg == (tmin == tmax ? tmin : SEG_MIXED_Q) && wkoff <= toff);
      if (it + 1 < n_iter) stage_rows(it + 1);

      float st[BQ / 2], dp[BQ / 2];
      mbar_wait(&full[s], ph);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int cb = ks * 16 / SWE;
        const uint32_t at = (ks * 16 % SWE) * 2;
        wgmma_ss<0, 0, T>(
            st,
            make_desc<SWB>(k_base + cb * BKEY * SWB + wg * 64 * SWB + at,
                           8 * SWB),
            make_desc<SWB>(q_base + cb * BQ * SWB + at, 8 * SWB), ks > 0);
      }
      wg_commit();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int cb = ks * 16 / SWE;
        const uint32_t at = (ks * 16 % SWE) * 2;
        wgmma_ss<0, 0, T>(
            dp,
            make_desc<SWB>(v_base + cb * BKEY * SWB + wg * 64 * SWB + at,
                           8 * SWB),
            make_desc<SWB>(do_base + cb * BQ * SWB + at, 8 * SWB), ks > 0);
      }
      wg_commit();

      // P^T, f32: st[4 j + 2 hh + e] is key key0 + 8 hh, query row
      // q0 + 8 j + col0 + e
      wg_wait<1>();
      pin(st);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + col0 + e;
            // rounded as the plain version rounds s * scale (no fused
            // multiply-add into the exponent's argument)
            float x = __fmul_rn(st[4 * j + 2 * hh + e], scale);
            if (masked && (tSeg[c] != kseg[hh] || koff[hh] > tOff[c]))
              x = -INFINITY;
            st[4 * j + 2 * hh + e] = expf(x - tL[c]);
          }
      // dS^T = P^T * (dP^T - delta), f32, in dp's registers
      wg_wait<0>();
      pin(dp);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hh + e;
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
        for (int hh = 0; hh < 2; ++hh) {
          const int row = wg * 64 + r0 + 8 * hh;
          const int c = 8 * j + col0;
          const int cc = c % 64;
          const int off = (c / 64) * (BKEY * 128) + row * 128 +
                          (((cc / 8) ^ (row % 8)) * 16) + (cc % 8) * 2;
          *reinterpret_cast<uint32_t*>(ds_buf + off) =
              dsa[j / 2][(j % 2) * 2 + hh];
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
                         make_desc<SWB>(do_base + at, 8 * SWB),
                      1);
          wgmma_rs<1, T>(dka[cb], dsa[kk],
                         make_desc<SWB>(q_base + at, 8 * SWB),
                      1);
        }
      wg_commit();

      // dQ: both warpgroups' dS^T rows are in ds_buf; and both are done
      // with stage s ^ 1 (their step it - 1 ended in wg_wait<0>)
      named_barrier(1, NT);
      if (tid == 0 && it + 1 < n_iter) load_q_tile(it + 1);
      float dqa[NQ / 2];
      const uint32_t ds_base =
          smem_u32(ds_buf) + (BQ == 128 ? wg : 0) * (BKEY * 128);
      const uint32_t kb_base = k_base + (BQ == 128 ? 0 : wg) * (BKEY * SWB);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < BKEY / 16; ++ks)
        wgmma_ss<1, 1, T>(dqa,
                          make_desc<128>(ds_base + ks * 16 * 128, 8 * 128),
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
      // added into dq32 by one TMA bulk reduction (rows past Tq dropped)
      float* dq_tile = sdQ + wg * 64 * NQ;
      const bool issuer = tid % 128 == 0;
      if (issuer) bulk_wait_read();  // the last step's reduction read it
      named_barrier(2 + wg, 128);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < NQ / 8; ++j)
          *reinterpret_cast<float2*>(dq_tile + (r0 + 8 * hh) * NQ + 8 * j +
                                     col0) =
              make_float2(dqa[4 * j + 2 * hh] * scale,
                          dqa[4 * j + 2 * hh + 1] * scale);
      fence_proxy_async();
      named_barrier(2 + wg, 128);
      if (issuer) {
        tma_reduce_add_3d(&tdq, dq_tile, BQ == 128 ? 0 : wg * 64, h,
                          q0 + (BQ == 128 ? wg * 64 : 0));
        bulk_commit();
      }
    }
    if (tid % 128 == 0) bulk_wait();
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = key0 + 8 * hh;
    if (key >= Tk) continue;
    const long long at = ((long long)key * H + h) * D;
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int j = 0; j < SWE / 8; ++j) {
        const int c = cb * SWE + 8 * j + col0;
        const int i = 4 * j + 2 * hh;
        store2<T>(dk + at + c, dka[cb][i] * scale, dka[cb][i + 1] * scale);
        store2<T>(dv + at + c, dva[cb][i], dva[cb][i + 1]);
      }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   const void* seg_q, const void* off_q, const void* seg_k,
                   const void* off_k, const void* k_tiles, void* order,
                   void* dq32, void* dk, void* dv, int Tq, int Tk, int H,
                   float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv, tdo, tdq;
  constexpr CUtensorMapDataType ty = tma_type<T>();
  if (!packed_map(&tq, q, Tq, H, D, C::SWE, C::BQ, ty) ||
      !packed_map(&tdo, dout, Tq, H, D, C::SWE, C::BQ, ty) ||
      !packed_map(&tk, k, Tk, H, D, C::SWE, BKEY, ty) ||
      !packed_map(&tv, v, Tk, H, D, C::SWE, BKEY, ty) ||
      !packed_f32_map(&tdq, dq32, Tq, H, D, C::NQ, 64))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_varlen_bwd_fused_wgmma_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const int nkb = (Tk + BKEY - 1) / BKEY;
  varlen_bwd_order_kernel<<<(nkb + 255) / 256, 256, 0, stream>>>(
      static_cast<const int*>(k_tiles), Tk, C::BQ, static_cast<int*>(order));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dim3 grid(H, nkb);
  flash_varlen_bwd_fused_wgmma_kernel<T, D><<<grid, NT, C::SMEM, stream>>>(
      tq, tk, tv, tdo, tdq, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(seg_q),
      static_cast<const int*>(off_q), static_cast<const int*>(seg_k),
      static_cast<const int*>(off_k), static_cast<const int*>(k_tiles),
      static_cast<const int*>(order), static_cast<T*>(dk),
      static_cast<T*>(dv), Tq, Tk, H, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     const void* seg_q, const void* off_q, const void* seg_k,
                     const void* off_k, const void* k_tiles, void* order,
                     void* dq32, void* dk, void* dv, int Tq, int Tk, int H,
                     int D, float scale, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, dout, lse, delta, seg_q, off_q, seg_k,
                           off_k, k_tiles, order, dq32, dk, dv, Tq, Tk, H,
                           scale, s);
    case 64:
      return launch<T, 64>(q, k, v, dout, lse, delta, seg_q, off_q, seg_k,
                           off_k, k_tiles, order, dq32, dk, dv, Tq, Tk, H,
                           scale, s);
    case 128:
      return launch<T, 128>(q, k, v, dout, lse, delta, seg_q, off_q, seg_k,
                            off_k, k_tiles, order, dq32, dk, dv, Tq, Tk, H,
                            scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// flash_varlen_bwd_dkv's arguments with the dQ pair's outputs beside them;
// dtype 1 (bfloat16) or 2 (float16), others refused. q/dout [Tq, H, D],
// k/v [Tk, H, D] in dtype,
// each 16-byte aligned (TMA); lse and delta [H, Tq] f32; seg_*/off_*
// int32 [T]; k_tiles int32 [ceil(Tk/64), 2]; order int32 [ceil(Tk/128)]
// scratch; dq32 [Tq, H, D] f32, zeroed by the caller; dk, dv [Tk, H, D]
// in dtype; all contiguous on the current device.
extern "C" int flash_varlen_bwd_fused_wgmma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg_q, const void* off_q,
    const void* seg_k, const void* off_k, const void* k_tiles, void* order,
    void* dq32, void* dk, void* dv, int Tq, int Tk, int H, int D, int dtype,
    float scale, void* stream) {
  if (dtype != 1 && dtype != 2) return cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout |
       (uintptr_t)dq32) & 15)
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, dout, lse, delta, seg_q, off_q,
                                   seg_k, off_k, k_tiles, order, dq32, dk, dv,
                                   Tq, Tk, H, D, scale, s);
  return launch_d<__half>(q, k, v, dout, lse, delta, seg_q, off_q, seg_k,
                          off_k, k_tiles, order, dq32, dk, dv, Tq, Tk, H, D,
                          scale, s);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
