// Paged-attention decode for Hopper (sm_90a): two kernels.
//
// Replaces: paddle2_tpu/serving/paged_attention.py `_decode_kernel`
// (one global softmax over the whole context) and `_decode_kernel_split`
// (split-K partials (m, l, unnormalised o) for the cross-split merge),
// both reached through `paged_attention_decode`.
//
// Computes, for each sequence b and head h, the attention of one query
// token over the ctx_lens[b] keys and values of that sequence, which lie
// scattered across fixed-size blocks of the shared pools
// [num_blocks, block_size, H, D]. Each block of threads reads the
// physical block id block_tables[b, t / block_size] itself (the Pallas
// kernel prefetched the table as scalars). Keys past ctx_lens[b] are
// never read and contribute exactly 0, whatever stale values their slots
// hold. Arithmetic follows the Pallas bodies: the score is rounded to
// the input dtype after the dot and again after the scale; the global
// body normalises in f32 and rounds the probabilities to the input dtype
// before p.V; the split body keeps m and l in f32 over the unrounded
// exponentials and rounds p to the input dtype for the f32 p.V partial.
//
// What bounds it on the H100: one query row against ctx keys is
// 4*ctx*D operations per head for 2*ctx*D elements of K and V read: a
// few operations per byte, far below the ~295 the card needs before its
// arithmetic is the limit. It is bound by the bytes of K and V. The
// design reads each K and V element from device memory exactly once and
// keeps many reads in flight, since at decode batch sizes there are few
// blocks (B*H, one per SM at B8 H16) and a block that waits on one load
// at a time is bound by latency, not bandwidth. In pass 1 a group of
// D*sizeof(T)/16 lanes reads one key's row in 16-byte loads, so a warp
// holds several keys, and UNROLL rounds of them are issued before any is
// used; the scores stay in shared memory. Pass 2 walks the keys the same
// way for V, each lane group accumulating its own f32 partial of o, and
// the partials are summed in shared memory. Nothing but the scores (4
// bytes per key) grows with the context in shared memory, which is what
// sets the context one block can hold (see paged_attention.py). The
// split kernel adds blocks along the context for long contexts or small
// batches; it writes D+2 floats per split and the merge runs in torch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;
constexpr int NW = NT / 32;

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

// block-wide max (is_max) or sum over NT threads; sW holds NW floats
__device__ float block_reduce(float x, float* sW, bool is_max) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, w);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  if (lane == 0) sW[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < NW ? sW[lane] : (is_max ? -INFINITY : 0.f);
#pragma unroll
    for (int w = 16; w >= 1; w >>= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x, w);
      x = is_max ? fmaxf(x, y) : x + y;
    }
    if (lane == 0) sW[0] = x;
  }
  __syncthreads();
  const float r = sW[0];
  __syncthreads();  // sW may be reused right after
  return r;
}

// 16 bytes of T at p (16-byte aligned), widened to floats.
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

// keys in flight per lane group in both passes
constexpr int UNROLL = 4;

__device__ __forceinline__ long long kv_row(const int* table, int t, int bs,
                                            int H, int h) {
  return ((long long)table[t / bs] * bs + t % bs) * H + h;
}

// Scores of keys [t_lo, t_hi) into sS[t - t_lo]. A key's row of D
// elements is read by a group of LPK lanes, 16 bytes each, so a warp
// holds 32/LPK keys and UNROLL rounds of them in flight at once.
template <typename T, int D>
__device__ void scores(const float* sQ, const T* __restrict__ k_pool,
                       const int* table, int h, int H, int bs, int t_lo,
                       int t_hi, float scale, float* sS) {
  constexpr int VEC = Vec<T>::N;
  constexpr int LPK = D / VEC;
  constexpr int KPW = 32 / LPK;
  constexpr int STEP = NW * KPW * UNROLL;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int part = lane % LPK;
  const int first = warp * KPW + lane / LPK;
  float q[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) q[i] = sQ[part * VEC + i];
  for (int base = t_lo; base < t_hi; base += STEP) {  // uniform: shuffles
    float acc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = base + u * NW * KPW + first;
      acc[u] = 0.f;
      if (t < t_hi) {
        float kv[VEC];
        Vec<T>::load(k_pool + kv_row(table, t, bs, H, h) * D + part * VEC,
                     kv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[u] = fmaf(q[i], kv[i], acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int w = LPK / 2; w >= 1; w >>= 1)
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], w);
      const int t = base + u * NW * KPW + first;
      if (part == 0 && t < t_hi)
        sS[t - t_lo] = round_t<T>(round_t<T>(acc[u]) * scale);
    }
  }
}

// sum over keys [t_lo, t_hi) of sS[t - t_lo] * V[t]: groups of LPK lanes
// take keys in turn, each lane 16 bytes of the row; the group partials
// meet in sR (NT * 8 floats). Returned to threads tid < D, column tid.
template <typename T, int D>
__device__ float weighted_v(const float* sS, const T* __restrict__ v_pool,
                            const int* table, int h, int H, int bs, int t_lo,
                            int t_hi, float* sR) {
  constexpr int VEC = Vec<T>::N;
  constexpr int LPK = D / VEC;
  constexpr int GROUPS = NT / LPK;
  const int g = threadIdx.x / LPK, part = threadIdx.x % LPK;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  for (int base = t_lo + g; base < t_hi; base += GROUPS * UNROLL) {
    float p[UNROLL], vv[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = base + u * GROUPS;
      p[u] = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) vv[u][i] = 0.f;
      if (t < t_hi) {
        p[u] = sS[t - t_lo];
        Vec<T>::load(v_pool + kv_row(table, t, bs, H, h) * D + part * VEC,
                     vv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(p[u], vv[u][i], acc[i]);
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) sR[g * D + part * VEC + i] = acc[i];
  __syncthreads();
  float tot = 0.f;
  if (threadIdx.x < D)
    for (int gg = 0; gg < GROUPS; ++gg) tot += sR[gg * D + threadIdx.x];
  return tot;
}

// One block per (h, b): global softmax over the whole context.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                        const T* __restrict__ v_pool,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ ctx_lens, T* __restrict__ out,
                        int H, int bs, int P, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;        // [D]
  float* sW = sQ + D;      // [NW]
  float* sR = sW + NW;     // [NT * 8]
  float* sS = sR + NT * 8; // [P * bs]
  const int h = blockIdx.x, b = blockIdx.y;
  const int* table = block_tables + (long long)b * P;
  const int ctx = min(ctx_lens[b], P * bs);
  const long long qo = ((long long)b * H + h) * D;
  for (int d = threadIdx.x; d < D; d += NT) sQ[d] = to_f(q[qo + d]);
  __syncthreads();

  scores<T, D>(sQ, k_pool, table, h, H, bs, 0, ctx, scale, sS);
  __syncthreads();
  float mx = -INFINITY;
  for (int t = threadIdx.x; t < ctx; t += NT) mx = fmaxf(mx, sS[t]);
  mx = block_reduce(mx, sW, true);
  float sum = 0.f;
  for (int t = threadIdx.x; t < ctx; t += NT) {
    const float e = expf(sS[t] - mx);
    sS[t] = e;
    sum += e;
  }
  sum = block_reduce(sum, sW, false);
  // ctx == 0 runs no key: the row is written as zeros
  for (int t = threadIdx.x; t < ctx; t += NT) sS[t] = round_t<T>(sS[t] / sum);
  __syncthreads();

  const float o = weighted_v<T, D>(sS, v_pool, table, h, H, bs, 0, ctx, sR);
  if (threadIdx.x < D) out[qo + threadIdx.x] = from_f<T>(o);
}

// One block per (h, b, split): partials of the split's pages.
template <typename T, int D>
__global__ void __launch_bounds__(NT) paged_decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ block_tables,
    const int* __restrict__ ctx_lens, float* __restrict__ o_parts,
    float* __restrict__ m_out, float* __restrict__ l_out, int H, int bs, int P,
    int pps, int n_splits, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sW = sQ + D;
  float* sR = sW + NW;
  float* sS = sR + NT * 8; // [pps * bs]
  const int h = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int* table = block_tables + (long long)b * P;
  const int ctx = min(ctx_lens[b], P * bs);
  const int t_lo = sp * pps * bs;
  const int t_hi = min(ctx, (sp + 1) * pps * bs);
  const long long qo = ((long long)b * H + h) * D;
  const long long po = ((long long)b * H + h) * n_splits + sp;
  if (t_hi <= t_lo) {  // dead split: (-inf, 0, 0), dropped by the merge
    for (int d = threadIdx.x; d < D; d += NT) o_parts[po * D + d] = 0.f;
    if (threadIdx.x == 0) {
      m_out[po] = -INFINITY;
      l_out[po] = 0.f;
    }
    return;
  }
  for (int d = threadIdx.x; d < D; d += NT) sQ[d] = to_f(q[qo + d]);
  __syncthreads();

  scores<T, D>(sQ, k_pool, table, h, H, bs, t_lo, t_hi, scale, sS);
  __syncthreads();
  const int n = t_hi - t_lo;
  float mx = -INFINITY;
  for (int t = threadIdx.x; t < n; t += NT) mx = fmaxf(mx, sS[t]);
  mx = block_reduce(mx, sW, true);
  float sum = 0.f;
  for (int t = threadIdx.x; t < n; t += NT) {
    const float p = expf(sS[t] - mx);
    sum += p;
    sS[t] = round_t<T>(p);
  }
  sum = block_reduce(sum, sW, false);

  const float o = weighted_v<T, D>(sS, v_pool, table, h, H, bs, t_lo, t_hi, sR);
  if (threadIdx.x < D) o_parts[po * D + threadIdx.x] = o;
  if (threadIdx.x == 0) {
    m_out[po] = mx;
    l_out[po] = sum;
  }
}

constexpr size_t smem_bytes(int D, int n_keys) {
  return sizeof(float) * (size_t)(D + NW + NT * 8 + n_keys);
}

template <typename T, int D>
cudaError_t launch_single(const void* q, const void* kp, const void* vp,
                          const int* bt, const int* ctx, void* out, int B,
                          int H, int bs, int P, float scale, cudaStream_t s) {
  const size_t smem = smem_bytes(D, P * bs);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  paged_decode_kernel<T, D><<<dim3(H, B), NT, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, ctx, static_cast<T*>(out), H, bs, P,
      scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_split(const void* q, const void* kp, const void* vp,
                         const int* bt, const int* ctx, float* o_parts,
                         float* m, float* l, int B, int H, int bs, int P,
                         int pps, int n_splits, float scale, cudaStream_t s) {
  const size_t smem = smem_bytes(D, pps * bs);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_split_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  paged_decode_split_kernel<T, D><<<dim3(H, B, n_splits), NT, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, ctx, o_parts, m, l, H, bs, P, pps,
      n_splits, scale);
  return cudaGetLastError();
}

}  // namespace

#define P2T_DISPATCH(FN, T, D, ...)               \
  switch (D) {                                    \
    case 16: return FN<T, 16>(__VA_ARGS__);       \
    case 64: return FN<T, 64>(__VA_ARGS__);       \
    case 128: return FN<T, 128>(__VA_ARGS__);     \
    default: return cudaErrorInvalidValue;        \
  }

// dtype: 0 = float32, 1 = bfloat16. q [B,1,H,D]; pools [N,bs,H,D];
// block_tables int32 [B,P]; ctx_lens int32 [B]; out like q. All
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
    P2T_DISPATCH(launch_single, float, D, q, k_pool, v_pool, bt, ctx, out, B,
                 H, bs, P, scale, s)
  }
  if (dtype == 1) {
    P2T_DISPATCH(launch_single, __nv_bfloat16, D, q, k_pool, v_pool, bt, ctx,
                 out, B, H, bs, P, scale, s)
  }
  return cudaErrorInvalidValue;
}

// o_parts f32 [B,H,n_splits,D]; m, l f32 [B,H,n_splits]. The table is
// read only below P pages; pages past the context are never read.
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
  if (dtype == 0) {
    P2T_DISPATCH(launch_split, float, D, q, k_pool, v_pool, bt, ctx, op, mp,
                 lp, B, H, bs, P, pps, n_splits, scale, s)
  }
  if (dtype == 1) {
    P2T_DISPATCH(launch_split, __nv_bfloat16, D, q, k_pool, v_pool, bt, ctx,
                 op, mp, lp, B, H, bs, P, pps, n_splits, scale, s)
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
