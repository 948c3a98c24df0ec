// Packed varlen FlashAttention forward for Hopper (sm_90a) on the tensor
// cores, bf16 and f16 (one kernel template T, instantiated for each).
//
// Replaces: paddle2_tpu/kernels/pallas_flash.py `_fwd_kernel_varlen`,
// driven by `_varlen_fwd` under `flash_attention_varlen_packed`, for bf16
// and f16 inputs. f32 inputs keep the CUDA-core kernel of flash_varlen.cu, and
// the backward stays the CUDA-core pair there, which reads this kernel's
// o and lse.
//
// The ragged batch is one packed sequence: q [Tq, H, D], k/v [Tk, H, D],
// in T, D in {16, 64, 128}, with an int32 segment id and offset per row.
// Query row r sees key c when seg_q[r] == seg_k[c] and off_k[c] <=
// off_q[r]. Per head: o = softmax(q k^T * scale) v and the row
// log-sum-exp. Scores, the running max m and the running sum l are f32;
// as in the Pallas kernel, p is rounded to T before the p.V product
// and l sums the unrounded p. Inside the kernel the exponentials are base
// 2 with scale * log2(e) folded into the scores; lse leaves in natural
// log, [H, Tq] f32, the layout the backward pair reads. A row that sees
// no key gets o = 0 and lse = -inf.
//
// What bounds it on the H100: 4 * pairs * D * H operations (pairs the
// (query, key) pairs the mask keeps) against 2 * (Tq + Tk) * H * D 2-byte
// elements moved plus lse and the metadata; at the packed batches of the
// main path both bounds are ~0.02 ms, and only wgmma reaches the
// operations' rate. The design is flash_fwd_wgmma.cu's: the score matrix
// never leaves the block, K/V tiles are read once per 128-row query tile,
// and TMA fills shared memory so no consumer thread spends instructions
// on copies.
//
// Layout: one block per (head, 128-row query tile), tiles launched from
// the last to the first, so each causal sequence's longest tiles start
// first. Nine warps: warps 0-7 are two consumer warpgroups of 64 query
// rows each; warp 8 is the producer. Its lane 0 issues every TMA copy: Q
// once, then K and V tiles of BK keys (128 for D <= 64, 64 for D 128) into
// a ring of two stages, each completing on its own mbarrier; the whole
// warp loads each key tile's seg/off into shared memory beside it and
// summarises it (one segment id if all its keys share one, and the
// largest offset) before lane 0 arms the stage's barrier.
//
// TMA maps (hopper.cuh `packed_map`): each packed tensor is a 3-D map
// (D, H, T) with strides (2, 2D, 2HD) bytes, so q, k and v are read in
// place: one map serves every head, a box starts at any row and rows past
// T arrive as zeros. TMA needs every base and stride on a 16-byte
// boundary; the strides are (D is a multiple of 8) and the entry refuses
// a base that is not.
//
// Tile ranges: the block walks only its live key range, the union of the
// two 64-row entries of q_tiles (flash_varlen.py `tile_ranges`, TILE 64)
// that its 128 rows cover, so the backward's tables and the functional
// layer's memo serve both kernels. Key tiles start at the range's first
// row, wherever it lies.
//
// Mask: each thread keeps the seg/off of its two accumulator rows in
// registers, and each warp the segment its 16 rows share (if they share
// one) and their smallest offset. A key tile needs no mask for a warp
// when all its keys lie in that segment at or below that offset; then the
// warp runs the tile as the dense kernel runs an interior tile. Otherwise
// each score is checked against the tile's seg/off in shared memory.
// Keys past the range's end take a segment id no row has.
//
// Per tile, each consumer warpgroup: S = Q K^T as wgmma m64nBKk16 with
// both operands K-major in shared memory (D / 16 steps); the online
// softmax on the accumulator in registers (row max and sum over the 4
// threads of a quad); P packed to T straight from the accumulator
// into wgmma's register A operand (hopper.cuh `to_a_frags`); O += P V as
// wgmma m64nSWEk16 per 64-column block of V, V MN-major (transposed) from
// shared memory. Tiles are 32- (D 16) or 128-byte swizzled (hopper.cuh).

#include <limits.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 128;             // query rows a block
constexpr int TILE = 64;            // rows of a q_tiles entry
constexpr int NCW = 8;              // consumer warps: two warpgroups
constexpr int NT = NCW * 32 + 32;   // + the producer warp
constexpr int STAGES = 2;
// segment ids no row has: keys past the live range, query rows past Tq,
// a key tile of several segments, 16 query rows of several
constexpr int SEG_PAST_K = INT_MIN;
constexpr int SEG_PAST_Q = INT_MIN + 1;
constexpr int SEG_MIXED_K = INT_MIN + 2;
constexpr int SEG_MIXED_Q = INT_MIN + 3;

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
  // per stage: the tile's seg[BK], off[BK], then {segment, largest off}
  static constexpr int META_INTS = 2 * BK + 2;
  static constexpr int OFF_META = OFF_V + STAGES * KV_BYTES;
  static constexpr int OFF_BAR = OFF_META + STAGES * META_INTS * 4;
  static constexpr int SMEM = OFF_BAR + 64 + 1024;  // + alignment slack
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "alignment");
  static_assert(OFF_BAR % 8 == 0, "mbarrier alignment");
};

template <typename T, int D>
__global__ void __launch_bounds__(NT, 1) flash_varlen_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const int* __restrict__ seg_q,
    const int* __restrict__ off_q, const int* __restrict__ seg_k,
    const int* __restrict__ off_k, const int* __restrict__ q_tiles,
    T* __restrict__ o, float* __restrict__ lse, int Tq, int H,
    float scale_log2) {
  using C = Cfg<D>;
  constexpr int SWE = C::SWE, SWB = C::SWB, NCB = C::NCB, BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sQ = smem;
  uint8_t* sK = smem + C::OFF_K;
  uint8_t* sV = smem + C::OFF_V;
  int* sMeta = reinterpret_cast<int*>(smem + C::OFF_META);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + STAGES;
  uint64_t* empty = bars + 1 + 2 * STAGES;

  const int h = blockIdx.x;
  const int tile = gridDim.y - 1 - blockIdx.y;
  const int q0 = tile * BQ;
  // the live key range: the union of the block's two 64-row entries (an
  // empty entry is [Tk, 0), which the union ignores)
  const int n64 = (Tq + TILE - 1) / TILE;
  int k_lo = q_tiles[4 * tile], k_hi = q_tiles[4 * tile + 1];
  if (2 * tile + 1 < n64) {
    k_lo = min(k_lo, q_tiles[4 * tile + 2]);
    k_hi = max(k_hi, q_tiles[4 * tile + 3]);
  }
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;
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
    if (n_tiles == 0) return;
    if (lane == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int cb = 0; cb < NCB; ++cb)
        tma_load_3d(sQ + cb * BQ * SWB, &tq, q_full, cb * SWE, h, q0);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      const int k0 = k_lo + i * BK;
      if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
      int* m_seg = sMeta + s * C::META_INTS;
      int* m_off = m_seg + BK;
      int smin = INT_MAX, smax = INT_MIN, omax = INT_MIN;
#pragma unroll
      for (int jj = 0; jj < BK / 32; ++jj) {
        const int j = jj * 32 + lane;
        const int c = k0 + j;
        const int sg = c < k_hi ? seg_k[c] : SEG_PAST_K;
        const int of = c < k_hi ? off_k[c] : INT_MAX;
        m_seg[j] = sg;
        m_off[j] = of;
        smin = min(smin, sg);
        smax = max(smax, sg);
        omax = max(omax, of);
      }
#pragma unroll
      for (int w = 16; w >= 1; w >>= 1) {
        smin = min(smin, __shfl_xor_sync(0xffffffffu, smin, w));
        smax = max(smax, __shfl_xor_sync(0xffffffffu, smax, w));
        omax = max(omax, __shfl_xor_sync(0xffffffffu, omax, w));
      }
      if (lane == 0) {
        m_off[BK] = smin == smax ? smin : SEG_MIXED_K;
        m_off[BK + 1] = omax;
      }
      __syncwarp();  // the warp's stores come before lane 0's arrive
      if (lane == 0) {
        mbar_expect_tx(&k_full[s], C::KV_BYTES);
        for (int cb = 0; cb < NCB; ++cb)
          tma_load_3d(sK + s * C::KV_BYTES + cb * BK * SWB, &tk, &k_full[s],
                      cb * SWE, h, k0);
        mbar_expect_tx(&v_full[s], C::KV_BYTES);
        for (int cb = 0; cb < NCB; ++cb)
          tma_load_3d(sV + s * C::KV_BYTES + cb * BK * SWB, &tv, &v_full[s],
                      cb * SWE, h, k0);
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

  int my_seg[2], my_off[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 8 * hh;
    my_seg[hh] = r < Tq ? seg_q[r] : SEG_PAST_Q;
    my_off[hh] = r < Tq ? off_q[r] : INT_MIN;
  }
  // the segment this warp's 16 rows share, if one, and their least offset
  int wmin = min(my_seg[0], my_seg[1]), wmax = max(my_seg[0], my_seg[1]);
  int woff = min(my_off[0], my_off[1]);
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) {
    wmin = min(wmin, __shfl_xor_sync(0xffffffffu, wmin, w));
    wmax = max(wmax, __shfl_xor_sync(0xffffffffu, wmax, w));
    woff = min(woff, __shfl_xor_sync(0xffffffffu, woff, w));
  }
  const int warp_seg = wmin == wmax ? wmin : SEG_MIXED_Q;

  float acc[NCB][SWE / 2];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < SWE / 2; ++i) acc[cb][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  if (n_tiles > 0) mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const uint32_t ph = (i / STAGES) & 1;
    const uint32_t k_base = smem_u32(sK + s * C::KV_BYTES);
    const uint32_t v_base = smem_u32(sV + s * C::KV_BYTES);
    const int* m_seg = sMeta + s * C::META_INTS;
    const int* m_off = m_seg + BK;

    float sc[BK / 2];
    mbar_wait(&k_full[s], ph);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int cb = ks * 16 / SWE;
      const uint32_t at = (ks * 16 % SWE) * 2;
      wgmma_ss<0, 0, T>(sc,
                        make_desc<SWB>(q_base + cb * BQ * SWB + at, 8 * SWB),
                     make_desc<SWB>(k_base + cb * BK * SWB + at, 8 * SWB),
                     ks > 0);
    }
    wg_commit();
    wg_wait<0>();
    pin(sc);

    // online softmax, base 2; the mask only where the warp needs it
    const bool masked = !(m_off[BK] == warp_seg && m_off[BK + 1] <= woff);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = sc[4 * j + 2 * hh + e] * scale_log2;
          if (masked) {
            const int c = 8 * j + col0 + e;
            if (m_seg[c] != my_seg[hh] || m_off[c] > my_off[hh])
              x = -INFINITY;
          }
          sc[4 * j + 2 * hh + e] = x;
          mx[hh] = fmaxf(mx[hh], x);
        }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float safe = mx[hh] == -INFINITY ? 0.f : mx[hh];
      alpha[hh] = exp2f(m[hh] - safe);  // 0 while m is -inf
      m[hh] = mx[hh];
      mx[hh] = safe;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(sc[4 * j + 2 * hh + e] - mx[hh]);
          sc[4 * j + 2 * hh + e] = p;
          sum[hh] += p;
        }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + sum[hh];
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int j = 0; j < SWE / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            acc[cb][4 * j + 2 * hh + e] *= alpha[hh];

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
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= Tq) continue;
    const float inv = l[hh] == 0.f ? 1.f : 1.f / l[hh];
    T* orow = o + ((long long)row * H + h) * D;
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int j = 0; j < SWE / 8; ++j) {
        const int c = cb * SWE + 8 * j + col0;
        store2<T>(orow + c, acc[cb][4 * j + 2 * hh] * inv,
                  acc[cb][4 * j + 2 * hh + 1] * inv);
      }
    if (lane % 4 == 0)
      lse[(long long)h * Tq + row] =
          l[hh] == 0.f ? -INFINITY : (m[hh] + log2f(l[hh])) * LN2;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* seg_q, const void* off_q, const void* seg_k,
                   const void* off_k, const void* q_tiles, void* o, void* lse,
                   int Tq, int Tk, int H, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv;
  constexpr CUtensorMapDataType ty = tma_type<T>();
  if (!packed_map(&tq, q, Tq, H, D, C::SWE, BQ, ty) ||
      !packed_map(&tk, k, Tk, H, D, C::SWE, C::BK, ty) ||
      !packed_map(&tv, v, Tk, H, D, C::SWE, C::BK, ty))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_varlen_fwd_wgmma_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(H, (Tq + BQ - 1) / BQ);
  flash_varlen_fwd_wgmma_kernel<T, D><<<grid, NT, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<const int*>(seg_q),
      static_cast<const int*>(off_q), static_cast<const int*>(seg_k),
      static_cast<const int*>(off_k), static_cast<const int*>(q_tiles),
      static_cast<T*>(o), static_cast<float*>(lse), Tq, H,
      scale * LOG2E);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* seg_q, const void* off_q, const void* seg_k,
                     const void* off_k, const void* q_tiles, void* o,
                     void* lse, int Tq, int Tk, int H, int D, float scale,
                     cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, seg_q, off_q, seg_k, off_k, q_tiles, o,
                           lse, Tq, Tk, H, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, seg_q, off_q, seg_k, off_k, q_tiles, o,
                           lse, Tq, Tk, H, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, seg_q, off_q, seg_k, off_k, q_tiles, o,
                            lse, Tq, Tk, H, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// flash_varlen_fwd's signature (flash_varlen.cu); dtype 1 (bfloat16) or 2
// (float16), others refused. q/o [Tq, H, D], k/v [Tk, H, D] in dtype, lse [H,
// Tq] f32, seg_*/off_* int32 [T], q_tiles int32 [ceil(Tq/64), 2]; all
// contiguous on the current device, q/k/v 16-byte aligned (TMA).
extern "C" int flash_varlen_fwd_wgmma(const void* q, const void* k,
                                      const void* v, const void* seg_q,
                                      const void* off_q, const void* seg_k,
                                      const void* off_k, const void* q_tiles,
                                      void* o, void* lse, int Tq, int Tk,
                                      int H, int D, int dtype, float scale,
                                      void* stream) {
  if (dtype != 1 && dtype != 2) return cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15)
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, seg_q, off_q, seg_k, off_k,
                                   q_tiles, o, lse, Tq, Tk, H, D, scale, s);
  return launch_d<__half>(q, k, v, seg_q, off_q, seg_k, off_k, q_tiles, o,
                          lse, Tq, Tk, H, D, scale, s);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
