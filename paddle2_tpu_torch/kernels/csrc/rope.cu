// Fused rotary position embedding (half-split convention) for Hopper
// (sm_90a).
//
// Replaces: paddle2_tpu/kernels/pallas_fused.py `_rope_kernel` (through
// `fused_rope` and its custom_vjp), reached from
// `incubate.nn.functional.fused_rotary_position_embedding` with
// use_neox_rotary_style=False. On x [B, S, H, D] with angle tables cos and
// sin of T rows of D:
//   rot(x) = cat(-x[D/2:], x[:D/2])
//   o = x * cos + rot(x) * sin       f32, rounded once to x's type
// with the (b, s) row reading table row (b*S + s) mod T: T = S for an
// [S, D] table, T = B*S for one gathered by position_ids. One row of angles
// serves the row's H heads. The TPU wrapper tiles an [S, D] table B times
// before its call; that copy is staging, and the modulus replaces it.
// The backward is the same kernel with -sin (`negate_sin`), as the TPU
// kernel's custom_vjp has it: negating sin is exact, so it equals a call
// on a negated table bitwise.
//
// Every operation is written with its round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn), which nvcc never contracts into a fused
// multiply-add: the result equals the plain version, one torch op per
// operation, bitwise.
//
// What bounds it on the H100: bytes. 2*B*S*H*D*size bytes of x and o, plus
// the table rows read once each, against 3 f32 operations an element.
//
// Two routes, picked by the C entry from the shape and the addresses alone
// (the wrapper's `route` is the same rule):
// - the vector route, `rope_vec_kernel`, when 16-byte vectors take a half
//   row: (D/2) * sizeof(x) % 16 == 0, with x, o, cos and sin on 16-byte
//   boundaries. One warp takes one (b, s) row, a block 8 rows (a
//   persistent grid whose warps walk rows with a stride was 5-8 % slower
//   at the stack's shape: rope_variants.py). A half row is C = (D/2) / E chunks of E = 16 / sizeof(x)
//   elements; the row's (head, chunk) pairs p = h * C + c go to the lanes
//   in turn (lane l takes p = l, l + 32, ...), so neighbouring lanes read
//   neighbouring 16 bytes. A lane loads x's two chunks (d0 and its
//   partner d0 + D/2) of VEC_PAIRS pairs before it computes the first, and
//   its four table chunks (cos and sin, both halves; 8, 16 or 32 bytes,
//   row_vec.cuh chunk_f) once a row: where C divides 32 (D 128: 8 chunks
//   in bf16, 16 in f32) its chunk is the same for every head it takes, so
//   one row of angles serves all of them; otherwise it loads them again
//   when its chunk changes. The pairs' (h, c) advance by adding 32, with
//   no division; the table row is one modulus a row.
// - the general route, `rope_kernel`, for every other call: one block
//   walks (b, s) rows; its threads take the row's H*D/2 element pairs
//   (d, d + D/2), neighbouring threads on neighbouring d, with scalar
//   loads, each table element read from device memory once a row and from
//   the cache by the row's other heads.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "row_vec.cuh"

namespace {

constexpr int NT = 256;
// the vector route: a lane's pairs of x chunks in flight (D 128 bf16 at
// H 16: a lane's 4 heads, 8 16-byte loads)
constexpr int VEC_PAIRS = 4;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

template <typename XT, typename CT, bool NEG>
__global__ void __launch_bounds__(NT)
    rope_kernel(const XT* __restrict__ x, const CT* __restrict__ cs,
                const CT* __restrict__ sn, XT* __restrict__ o,
                long long rows, int H, int D, long long T) {
  const int half = D / 2;
  const int pairs = H * half;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const long long base = row * (long long)H * D;
    const long long tb = (row % T) * D;
    for (int p = threadIdx.x; p < pairs; p += NT) {
      const int h = p / half;
      const int d = p - h * half;
      const long long i1 = base + (long long)h * D + d;
      const float x1 = to_f(x[i1]);
      const float x2 = to_f(x[i1 + half]);
      const float c1 = to_f(cs[tb + d]), c2 = to_f(cs[tb + d + half]);
      float s1 = to_f(sn[tb + d]), s2 = to_f(sn[tb + d + half]);
      if (NEG) {
        s1 = -s1;
        s2 = -s2;
      }
      // o[d] = x1*c1 + (-x2)*s1;  o[d + D/2] = x2*c2 + x1*s2
      o[i1] = from_f<XT>(__fadd_rn(__fmul_rn(x1, c1), __fmul_rn(-x2, s1)));
      o[i1 + half] =
          from_f<XT>(__fadd_rn(__fmul_rn(x2, c2), __fmul_rn(x1, s2)));
    }
  }
}

// The vector route (see the note at the top): warp w of the grid takes
// row w (and w + warps, ... where the rows pass the grid); the
// arithmetic is rope_kernel's, operation for operation.
template <typename XT, typename CT, bool NEG>
__global__ void __launch_bounds__(rowvec::VEC_NT)
    rope_vec_kernel(const XT* __restrict__ x, const CT* __restrict__ cs,
                    const CT* __restrict__ sn, XT* __restrict__ o,
                    long long rows, int H, int D, long long T) {
  constexpr int E = 16 / sizeof(XT);
  const int half = D / 2;
  const int C = half / E;
  const int pairs = H * C;
  const int lane = threadIdx.x & 31;
  // where p moves on by 32: the chunk by 32 % C, the head by 32 / C
  const int step_h = 32 / C, step_c = 32 % C;
  const int h0 = lane / C, c0 = lane % C;
  const long long warps = (long long)gridDim.x * rowvec::VEC_WARPS;
  for (long long row = (long long)blockIdx.x * rowvec::VEC_WARPS +
                       (threadIdx.x >> 5);
       row < rows; row += warps) {
    const long long base = row * (long long)H * D;
    const long long tb = (row % T) * D;
    int h = h0, c = c0, cur = -1;
    float c1[E], c2[E], s1[E], s2[E];
    for (int p0 = lane; p0 < pairs; p0 += 32 * VEC_PAIRS) {
      uint4 a[VEC_PAIRS], b[VEC_PAIRS];
      int hk[VEC_PAIRS], ck[VEC_PAIRS];
#pragma unroll
      for (int k = 0; k < VEC_PAIRS; ++k) {
        hk[k] = h;
        ck[k] = c;
        if (p0 + 32 * k < pairs) {
          const XT* xp = x + base + (long long)h * D + c * E;
          a[k] = *reinterpret_cast<const uint4*>(xp);
          b[k] = *reinterpret_cast<const uint4*>(xp + half);
        }
        h += step_h;
        c += step_c;
        if (c >= C) {
          c -= C;
          ++h;
        }
      }
#pragma unroll
      for (int k = 0; k < VEC_PAIRS; ++k) {
        if (p0 + 32 * k >= pairs) break;
        if (ck[k] != cur) {
          rowvec::chunk_f<XT, CT>(cs + tb + ck[k] * E, c1);
          rowvec::chunk_f<XT, CT>(cs + tb + half + ck[k] * E, c2);
          rowvec::chunk_f<XT, CT>(sn + tb + ck[k] * E, s1);
          rowvec::chunk_f<XT, CT>(sn + tb + half + ck[k] * E, s2);
          if (NEG) {
#pragma unroll
            for (int j = 0; j < E; ++j) {
              s1[j] = -s1[j];
              s2[j] = -s2[j];
            }
          }
          cur = ck[k];
        }
        uint4 u, v;
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float x1 = rowvec::elem<XT>(a[k], j);
          const float x2 = rowvec::elem<XT>(b[k], j);
          // o[d] = x1*c1 + (-x2)*s1;  o[d + D/2] = x2*c2 + x1*s2
          rowvec::set_elem<XT>(
              u, j, __fadd_rn(__fmul_rn(x1, c1[j]), __fmul_rn(-x2, s1[j])));
          rowvec::set_elem<XT>(
              v, j, __fadd_rn(__fmul_rn(x2, c2[j]), __fmul_rn(x1, s2[j])));
        }
        XT* op = o + base + (long long)hk[k] * D + ck[k] * E;
        *reinterpret_cast<uint4*>(op) = u;
        *reinterpret_cast<uint4*>(op + half) = v;
      }
    }
  }
}

template <typename XT, typename CT>
int launch(const void* x, const void* cs, const void* sn, void* o,
           long long rows, int H, int D, long long T, int neg,
           cudaStream_t st) {
  // 8 resident blocks of 256 threads on each of the 132 SMs; more rows
  // loop
  const int grid = (int)(rows < 132 * 8 ? rows : 132 * 8);
  const XT* xp = static_cast<const XT*>(x);
  const CT* cp = static_cast<const CT*>(cs);
  const CT* sp = static_cast<const CT*>(sn);
  XT* op = static_cast<XT*>(o);
  if (neg)
    rope_kernel<XT, CT, true><<<grid, NT, 0, st>>>(xp, cp, sp, op, rows, H, D,
                                                   T);
  else
    rope_kernel<XT, CT, false><<<grid, NT, 0, st>>>(xp, cp, sp, op, rows, H,
                                                    D, T);
  return cudaGetLastError();
}

template <typename XT, typename CT, bool NEG>
int launch_vec_kernel(const void* x, const void* cs, const void* sn, void* o,
                      long long rows, int H, int D, long long T,
                      cudaStream_t st) {
  // a warp a row, up to the grid's limit
  const long long want = (rows + rowvec::VEC_WARPS - 1) / rowvec::VEC_WARPS;
  const int blocks = (int)(want < 0x7fffffffLL ? want : 0x7fffffffLL);
  rope_vec_kernel<XT, CT, NEG><<<blocks, rowvec::VEC_NT, 0, st>>>(
      static_cast<const XT*>(x), static_cast<const CT*>(cs),
      static_cast<const CT*>(sn), static_cast<XT*>(o), rows, H, D, T);
  return cudaGetLastError();
}

// the vector route when 16-byte vectors take a half row (see the note at
// the top), else the general one
template <typename XT, typename CT>
int launch_route(const void* x, const void* cs, const void* sn, void* o,
                 long long rows, int H, int D, long long T, int neg,
                 cudaStream_t st) {
  if ((D / 2 * sizeof(XT)) % 16 != 0 || !rowvec::aligned16(x) ||
      !rowvec::aligned16(cs) || !rowvec::aligned16(sn) ||
      !rowvec::aligned16(o))
    return launch<XT, CT>(x, cs, sn, o, rows, H, D, T, neg, st);
  if (neg)
    return launch_vec_kernel<XT, CT, true>(x, cs, sn, o, rows, H, D, T, st);
  return launch_vec_kernel<XT, CT, false>(x, cs, sn, o, rows, H, D, T, st);
}

template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<T>{}) for the element type of a dtype code: 0 f32, 1 bf16, 2 f16
template <typename F>
int with_type(int code, F f) {
  switch (code) {
    case 0: return f(Tag<float>{});
    case 1: return f(Tag<__nv_bfloat16>{});
    case 2: return f(Tag<__half>{});
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x, o: [rows, H, D] contiguous of x_dtype (0 f32, 1 bf16, 2 f16), rows =
// B*S; cos, sin: [T, D] contiguous of c_dtype, T = S or B*S; D even.
// negate_sin = 1 rotates by -sin (the backward). One launch: the vector
// route's persistent grid, or the general route's.
extern "C" int rope(const void* x, const void* cos_t, const void* sin_t,
                    void* o, long long rows, int H, int D, long long T,
                    int x_dtype, int c_dtype, int negate_sin, void* stream) {
  if (rows <= 0 || H <= 0 || D <= 0 || D % 2 || T <= 0 ||
      (long long)H * D / 2 > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_type(x_dtype, [&](auto xt) {
    return with_type(c_dtype, [&](auto ct) {
      return launch_route<typename decltype(xt)::type,
                          typename decltype(ct)::type>(
          x, cos_t, sin_t, o, rows, H, D, T, negate_sin, st);
    });
  });
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
