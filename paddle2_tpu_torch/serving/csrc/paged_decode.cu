// Paged-attention decode for Hopper (sm_90a): one kernel template for both
// routes, a thread-block cluster along each sequence's context.
//
// Replaces: paddle2_tpu/serving/paged_attention.py `_decode_kernel`
// (one global softmax over the whole context) and `_decode_kernel_split`
// (split-K partials (m, l, unnormalised o) for the cross-split merge),
// both reached through `paged_attention_decode`.
//
// Computes, for each sequence b and head h, the attention of one query
// token over the ctx_lens[b] keys and values of that sequence, which lie
// scattered across fixed-size pages of the shared pools
// [num_blocks, block_size, H, D] through block_tables[b]. Keys past
// ctx_lens[b] are never read and contribute exactly 0, whatever stale
// values their slots hold. Arithmetic follows the Pallas bodies: the score
// is rounded to the input dtype after the dot and again after the scale;
// the global body normalises in f32 over the whole context and rounds
// p = e / sum to the input dtype before p.V; the split body keeps m and l
// in f32 over the unrounded exponentials and rounds p = exp(s - m) to the
// input dtype for the f32 p.V partial.
//
// What bounds it on the H100: the bytes of K and V. One query row against
// ctx keys is 4*ctx*D operations per head for 2*ctx*D elements read, a few
// operations a byte against the ~295 the card needs before arithmetic
// limits it. Each K and V element is read from device memory once.
//
// The design, for that bound at decode batch sizes (few sequences, very
// different context lengths):
// - One cluster of C blocks per (sequence, head, range); the range is the
//   whole context on the global route and one split on the split route.
//   Block r of the cluster takes the range's pages [r*chunk, (r+1)*chunk).
//   The host picks C (a power of two, at most 16) and the chunk from the
//   range's width in pages (`plan`), never from ctx_lens, so a long and a
//   short sequence spread over as many SMs as their tables are wide.
// - A block reads its chunk's page ids and its context length at once (the
//   ids do not wait for the length). A block whose chunk lies past the
//   context exits at once (rank 0 stays to write the result): a cluster
//   barrier waits only for blocks that have not exited, and the live
//   blocks exchange among themselves, so a short sequence frees its SMs.
// - A live block keeps its K tiles, then its V tiles, streaming through a
//   ring of STAGES tiles of 8 KB filled by cp.async, so V arrives while the
//   scores are computed and while the cluster agrees on the softmax. The
//   ring is small, so that many blocks share an SM: a block's chain of
//   dependent loads, not its bytes in flight, sets its pace, and
//   paged_decode_variants.py measured deeper rings and smaller tiles
//   slower.
// - The softmax across the cluster keeps the global body's arithmetic:
//   each block pushes its max into every live block's shared memory
//   (distributed shared memory) to give the cluster's max M; each block
//   sums exp(s - M) over its keys and the sums, pushed alike and added in
//   rank order, give the cluster's sum; then p = round(e / sum) and p.V
//   over the block's keys. Each block pushes its o partial of column d to
//   block d % CL (CL live blocks), which adds the ranks' partials in rank
//   order, so a run is deterministic. Three cluster barriers, and no block
//   touches another's memory after the last. On the split route the
//   cluster writes (o, m, l) with p = round(exp(s - m)).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int NT = 128;
constexpr int NW = NT / 32;
// a tile is 8 KB of K or of V; the ring holds STAGES of them
constexpr int TILE_BYTES = 8192;
constexpr int STAGES = 2;
constexpr int RING_BYTES = TILE_BYTES * STAGES;
// the plan: a cluster grows (in powers of two, to MAX_CLUSTER blocks)
// while each block keeps at least TARGET_KEYS keys of the range. Mirrored
// by paddle2_tpu_torch/serving/paged_attention.py `cluster_plan`.
constexpr int TARGET_KEYS = 128;
constexpr int MAX_CLUSTER = 16;
// shared memory one block may use on the H100 (dynamic, after opting in)
constexpr int SMEM_LIMIT = 232448;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <typename T> __device__ __forceinline__ float round_t(float x) {
  return to_f(from_f<T>(x));
}

// 16 bytes of T in shared memory (16-byte aligned), widened to floats
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// block-wide max (is_max) or sum over NT threads in a fixed order; sW
// holds NW floats
__device__ float block_reduce(float x, float* sW, bool is_max) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, w);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  if (lane == 0) sW[warp] = x;
  __syncthreads();
  float r = is_max ? -INFINITY : 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) r = is_max ? fmaxf(r, sW[w]) : r + sW[w];
  __syncthreads();  // sW may be reused right after
  return r;
}

// The two halves of a cluster barrier: the arrival (relaxed: it orders no
// memory) and the wait
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Block r's value x into slot[r] of every block of the cluster (thread q
// writes block q's), then a cluster barrier; returns the cluster's max or
// sum of the slots in rank order.
__device__ float cluster_reduce(cg::cluster_group& cluster, float* slot,
                                float x, int C, int r, bool is_max) {
  if ((int)threadIdx.x < C) cluster.map_shared_rank(slot, threadIdx.x)[r] = x;
  cluster.sync();
  float y = is_max ? -INFINITY : 0.f;
  for (int q = 0; q < C; ++q) y = is_max ? fmaxf(y, slot[q]) : y + slot[q];
  return y;
}

// Shared memory of one block: the ring, the chunk's scores and page ids,
// the p.V group partials (NT floats), the ranks' maxima and sums
// (2 * MAX_CLUSTER), the columns pushed to this block (D + MAX_CLUSTER)
// and the warps' partials (NW). Mirrored by paged_attention.py
// `decode_scratch_smem_bytes`.
constexpr size_t smem_bytes(int D, int chunk_keys, int chunk_pages) {
  return RING_BYTES + sizeof(float) * (size_t)(chunk_keys + chunk_pages +
                                               NT + D + 3 * MAX_CLUSTER +
                                               NW);
}

// Grid (C * ranges, H, B), clusters of (C, 1, 1), NT threads. Range sp
// of sequence b covers pages [sp * range_pages, (sp + 1) * range_pages)
// of its table (the whole table on the global route); block r of the
// range's cluster takes chunk_pages of them. Global route (!SPLIT): out
// [B, 1, H, D] in T. Split route: o_parts [B, H, ranges, D], m and l
// [B, H, ranges], in f32.
template <typename T, int D, bool SPLIT>
__global__ void __launch_bounds__(NT) paged_decode_cluster_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ block_tables,
    const int* __restrict__ ctx_lens, T* __restrict__ out,
    float* __restrict__ o_parts, float* __restrict__ m_out,
    float* __restrict__ l_out, int H, int bs, int P, int range_pages,
    int chunk_pages, float scale) {
  constexpr int VEC = Vec<T>::N;            // elements in 16 bytes
  constexpr int LPK = D / VEC;              // 16-byte pieces of a row
  constexpr int ROW = D * (int)sizeof(T);   // bytes of a row
  constexpr int TK = TILE_BYTES / ROW;      // keys a tile
  constexpr int KPW = 32 / LPK;             // keys a warp scores at once
  constexpr int ROUNDS = TK / (NW * KPW);   // rounds a tile (2)
  constexpr int G = NT / D;                 // p.V key groups
  static_assert(ROUNDS * NW * KPW == TK && G * D == NT, "tile shape");
  extern __shared__ __align__(128) unsigned char smem[];
  float* sS = reinterpret_cast<float*>(smem + RING_BYTES);
  int* sT = reinterpret_cast<int*>(sS + chunk_pages * bs);
  float* sP = reinterpret_cast<float*>(sT + chunk_pages);
  float* sX = sP + NT;                // [0, C) maxima, [MAX_CLUSTER, +C) sums
  float* sG = sX + 2 * MAX_CLUSTER;   // pushed columns
  float* sW = sG + D + MAX_CLUSTER;   // warps' partials

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int sp = blockIdx.x / C;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int* table = block_tables + (long long)b * P;
  const int range_lo = sp * range_pages;
  const int page_lo = range_lo + r * chunk_pages;
  const int page_hi = min(min(page_lo + chunk_pages, range_lo + range_pages),
                          P);
  // the chunk's page ids (every one: they need not wait for the length)
  for (int i = tid; i < page_hi - page_lo; i += NT) sT[i] = table[page_lo + i];
  const int ctx = min(ctx_lens[b], P * bs);
  // the live ranks: those whose chunk starts below the context, and rank 0
  // (which writes the result). The others exit at once; a cluster barrier
  // waits only for blocks that have not exited, and no block touches
  // theirs.
  const int live_pages = min(range_pages, (ctx + bs - 1) / bs - range_lo);
  const int CL = max(1, min(C, (live_pages + chunk_pages - 1) / chunk_pages));
  if (r >= CL) return;
  // no block writes into another's shared memory before every live block
  // has started: the barrier's arrival here, its wait before the first
  // such write
  cluster_arrive_relaxed();
  const int t0 = page_lo * bs;
  const int n = max(0, min(ctx, page_hi * bs) - t0);  // the block's keys
  const int nk = (n + TK - 1) / TK;                   // tiles of K, of V
  const int total = 2 * nk;
  const int part = lane % LPK;
  float qv[VEC];
  const long long qo = ((long long)b * H + h) * D;
#pragma unroll
  for (int i = 0; i < VEC; ++i) qv[i] = to_f(q[qo + part * VEC + i]);
  __syncthreads();

  // tile i of the block: K tiles 0 .. nk-1, then V tiles; slot i % STAGES
  auto issue = [&](int i) {
    const bool is_v = i >= nk;
    const int key0 = (is_v ? i - nk : i) * TK;
    const T* pool = is_v ? v_pool : k_pool;
    unsigned char* dst = smem + (i % STAGES) * TILE_BYTES;
    for (int c = tid; c < TK * LPK; c += NT) {
      const int j = key0 + c / LPK;
      if (j < n) {
        const long long row =
            ((long long)sT[j / bs] * bs + j % bs) * H + h;
        cp_async16(dst + c * 16, pool + row * D + (c % LPK) * VEC);
      }
    }
  };
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) issue(s);
    cp_async_commit();
  }

  // pass 1: scores of the block's keys into sS. A key's row is read by
  // LPK lanes, 16 bytes each, so a warp scores KPW keys at once.
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (i + STAGES - 1 < total) issue(i + STAGES - 1);
    cp_async_commit();
    const T* tile = reinterpret_cast<const T*>(smem + (i % STAGES) *
                                               TILE_BYTES);
#pragma unroll
    for (int rd = 0; rd < ROUNDS; ++rd) {
      const int kk = rd * NW * KPW + warp * KPW + lane / LPK;
      const int j = i * TK + kk;
      float acc = 0.f;
      if (j < n) {
        float kv[VEC];
        Vec<T>::load(tile + kk * D + part * VEC, kv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc = fmaf(qv[e], kv[e], acc);
      }
#pragma unroll
      for (int w = LPK / 2; w >= 1; w >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, w);
      if (part == 0 && j < n) sS[j] = round_t<T>(round_t<T>(acc) * scale);
    }
  }
  __syncthreads();

  // the softmax across the cluster
  float mx = -INFINITY;
  for (int j = tid; j < n; j += NT) mx = fmaxf(mx, sS[j]);
  mx = block_reduce(mx, sW, true);
  cluster_wait();
  const float M = cluster_reduce(cluster, sX, mx, CL, r, true);
  float sum = 0.f;
  for (int j = tid; j < n; j += NT) {
    const float e = expf(sS[j] - M);
    sum += e;
    sS[j] = SPLIT ? round_t<T>(e) : e;
  }
  sum = block_reduce(sum, sW, false);
  const float L = cluster_reduce(cluster, sX + MAX_CLUSTER, sum, CL, r,
                                 false);
  if (!SPLIT)  // M and L are the whole context's: the global body's p
    for (int j = tid; j < n; j += NT) sS[j] = round_t<T>(sS[j] / L);

  // pass 2: p.V. Thread (g, d) sums column d over the tile's keys g,
  // g + G, ...; the loop's barrier orders the p writes above.
  const int g = tid / D, d = tid % D;
  float acc = 0.f;
  for (int i = nk; i < total; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (i + STAGES - 1 < total) issue(i + STAGES - 1);
    cp_async_commit();
    const T* tile = reinterpret_cast<const T*>(smem + (i % STAGES) *
                                               TILE_BYTES);
    const int key0 = (i - nk) * TK;
    const int m = min(TK, n - key0);
    for (int kk = g; kk < m; kk += G)
      acc = fmaf(sS[key0 + kk], to_f(tile[kk * D + d]), acc);
  }
  sP[tid] = acc;
  __syncthreads();
  // column d of the block's o goes to block d % CL, at (d / CL) * CL + r
  if (tid < D) {
    float o = 0.f;
#pragma unroll
    for (int gg = 0; gg < G; ++gg) o += sP[gg * D + tid];
    cluster.map_shared_rank(sG, tid % CL)[(tid / CL) * CL + r] = o;
  }
  cluster.sync();

  // rank r finishes columns r, r + CL, ...: each column's ranks added in
  // rank order
  const int ncol = r < D ? (D - r + CL - 1) / CL : 0;
  const long long po = ((long long)b * H + h) * (gridDim.x / C) + sp;
  for (int i = tid; i < ncol; i += NT) {
    float o = 0.f;
    for (int qq = 0; qq < CL; ++qq) o += sG[i * CL + qq];
    if (SPLIT)
      o_parts[po * D + r + CL * i] = o;
    else
      out[qo + r + CL * i] = from_f<T>(o);
  }
  if (SPLIT && r == 0 && tid == 0) {
    m_out[po] = M;  // -inf and 0 for a split past the context
    l_out[po] = L;
  }
}

struct Plan {
  int cluster, chunk_pages;
};

// C: the largest power of two <= MAX_CLUSTER with C * TARGET_KEYS keys of
// the range or fewer (at least 1); chunk: the range's pages over C
Plan plan(int range_pages, int bs) {
  const long long keys = (long long)range_pages * bs;
  int c = 1;
  while (c < MAX_CLUSTER && (long long)(2 * c) * TARGET_KEYS <= keys) c *= 2;
  return {c, (range_pages + c - 1) / c};
}

template <typename T, int D, bool SPLIT>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* bt, const int* ctx, void* out, float* o_parts,
                   float* m, float* l, int B, int H, int bs, int P,
                   int range_pages, int ranges, float scale,
                   cudaStream_t s) {
  if (B < 1 || H < 1 || bs < 1 || P < 1 || range_pages < 1 || ranges < 1)
    return cudaErrorInvalidValue;
  const Plan pl = plan(range_pages, bs);
  const size_t smem = smem_bytes(D, pl.chunk_pages * bs, pl.chunk_pages);
  if (smem > (size_t)SMEM_LIMIT) return cudaErrorInvalidValue;
  auto kernel = paged_decode_cluster_kernel<T, D, SPLIT>;
  // clusters of 16 blocks are past the portable 8
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.cluster * ranges, H, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pl.cluster > 1;  // a cluster of one block needs none
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, ctx, static_cast<T*>(out), o_parts, m,
      l, H, bs, P, range_pages, pl.chunk_pages, scale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

#define P2T_DISPATCH(T, SPLIT, ...)                             \
  switch (D) {                                                  \
    case 16: return launch<T, 16, SPLIT>(__VA_ARGS__);          \
    case 64: return launch<T, 64, SPLIT>(__VA_ARGS__);          \
    case 128: return launch<T, 128, SPLIT>(__VA_ARGS__);        \
    default: return cudaErrorInvalidValue;                      \
  }

// dtype: 0 = float32, 1 = bfloat16. q [B,1,H,D]; pools [N,bs,H,D] (16-byte
// aligned); block_tables int32 [B,P]; ctx_lens int32 [B]; out like q. All
// contiguous on the current device.
extern "C" int paged_decode(const void* q, const void* k_pool,
                            const void* v_pool, const void* block_tables,
                            const void* ctx_lens, void* out, int B, int H,
                            int D, int bs, int P, int dtype, float scale,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* ctx = static_cast<const int*>(ctx_lens);
  if (dtype == 0) {
    P2T_DISPATCH(float, false, q, k_pool, v_pool, bt, ctx, out, nullptr,
                 nullptr, nullptr, B, H, bs, P, P, 1, scale, s)
  }
  if (dtype == 1) {
    P2T_DISPATCH(__nv_bfloat16, false, q, k_pool, v_pool, bt, ctx, out,
                 nullptr, nullptr, nullptr, B, H, bs, P, P, 1, scale, s)
  }
  return cudaErrorInvalidValue;
}

// o_parts f32 [B,H,n_splits,D]; m, l f32 [B,H,n_splits], n_splits =
// ceil(P / pps). The table is read only below P pages; pages past the
// context are never read.
extern "C" int paged_decode_split(const void* q, const void* k_pool,
                                  const void* v_pool,
                                  const void* block_tables,
                                  const void* ctx_lens, void* o_parts,
                                  void* m, void* l, int B, int H, int D,
                                  int bs, int P, int pps, int n_splits,
                                  int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* ctx = static_cast<const int*>(ctx_lens);
  float* op = static_cast<float*>(o_parts);
  float* mp = static_cast<float*>(m);
  float* lp = static_cast<float*>(l);
  if (pps < 1 || n_splits != (P + pps - 1) / pps) return cudaErrorInvalidValue;
  if (dtype == 0) {
    P2T_DISPATCH(float, true, q, k_pool, v_pool, bt, ctx, nullptr, op, mp,
                 lp, B, H, bs, P, pps, n_splits, scale, s)
  }
  if (dtype == 1) {
    P2T_DISPATCH(__nv_bfloat16, true, q, k_pool, v_pool, bt, ctx, nullptr,
                 op, mp, lp, B, H, bs, P, pps, n_splits, scale, s)
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
