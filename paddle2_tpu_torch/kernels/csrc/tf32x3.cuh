// Error-compensated TF32 on mma.sync for the f32 kernels on the tensor cores:
// the operand split, the m16n8k8 TF32 product, cp.async staging and the two
// fragment walks of the flash kernels. Used by flash_bwd_tf32x3.cu (the f32
// split backward pair), flash_fwd_tf32x3.cu (the f32 forward) and
// wo_matmul.cu (the f32 weight-only prefill GEMM, and its cp.async groups).
//
// An f32 operand x is split once in registers as it enters a fragment into
// big (x rounded to TF32) and small = x - big; a product a*b then
// accumulates a_small*b_big, a_big*b_small and a_big*b_big in f32 (the terms
// and the order of CUTLASS's OpMultiplyAddFastF32), which keeps it within
// about 2^-21 of its f32 value. An operand exact in TF32 (an int8 or bf16
// value) has no small part, so its products need fewer terms.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// x = big + small: big is x rounded to TF32 (to nearest, ties away from
// zero, on the magnitude bits: cvt.rna.tf32.f32 for finite x, without the
// NaN and infinity tests the compiler wraps around that instruction);
// small = x - big is exact in f32 and goes to the mma as it is: the tensor
// cores read the top 19 bits of a tf32 operand, so small enters truncated
// to TF32 (an error below 2^-21 of x)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c += a * b on one m16n8k8 tile: tf32 operands, f32 sums. PTX layout (g =
// lane / 4, t = lane % 4): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8,
// t+4); b0 (k t, n g), b1 (k t+4, n g); c0 (g, 2t), c1 (g, 2t+1), c2 (g+8,
// 2t), c3 (g+8, 2t+1)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32: small*big, big*small, big*big
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  mma_tf32(c, as, bb[0], bb[1]);
  mma_tf32(c, ab, bs[0], bs[1]);
  mma_tf32(c, ab, bb[0], bb[1]);
}

// 16 bytes from global to shared without passing through registers;
// zero-filled when !in (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// the threads of a block of the kernels that load through load_rows and
// load_vec (four warps)
constexpr int NT = 128;

// rows [r0, r0 + ROWS) of a (S, D) slab into shared [ROWS][D+4], zero past
// S, by the block's NT threads
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int S) {
  constexpr int DP = D + 4, CH = D / 4;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i - r * CH;
    const bool in = r0 + r < S;
    cp_async16(dst + r * DP + c * 4,
               in ? src + (long long)(r0 + r) * D + c * 4 : src, in);
  }
}

// entries [r0, r0 + ROWS) of a length-S vector into shared, zero past S
template <int ROWS>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int r0,
                                         int S) {
  for (int i = threadIdx.x; i < ROWS; i += NT) {
    const bool in = r0 + i < S;
    cp_async4(dst + i, in ? src + r0 + i : src, in);
  }
}

// acc[m][j] = A_m B_j^T for this warp: A_m the 16 rows at sA + 16m, B_j
// the 8 rows at sB + 8j, both [.][D+4] in shared, the sum over the D
// columns (both operands K-major). acc[m][j] is the C fragment of rows
// g/g+8 of A_m and columns 2t/2t+1 of B_j's rows. Each A fragment is split
// once for the NJ B tiles, each B fragment once for the warp's MT row
// tiles.
template <int D, int MT, int NJ>
__device__ __forceinline__ void mma_abt(float (&acc)[MT][NJ][4],
                                        const float* sA, const float* sB,
                                        int g, int t) {
  constexpr int DP = D + 4;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < D; kk += 8) {
    uint32_t ab[MT][4], as[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float* a = sA + (16 * m + g) * DP + kk + t;
      split(a[0], ab[m][0], as[m][0]);
      split(a[8 * DP], ab[m][1], as[m][1]);
      split(a[4], ab[m][2], as[m][2]);
      split(a[8 * DP + 4], ab[m][3], as[m][3]);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* b = sB + (8 * j + g) * DP + kk + t;
      uint32_t bb[2], bs[2];
      split(b[0], bb[0], bs[0]);
      split(b[4], bb[1], bs[1]);
#pragma unroll
      for (int m = 0; m < MT; ++m) mma3(acc[m][j], ab[m], as[m], bb, bs);
    }
  }
}

// acc[m][n] += C_m X_n: C_m the 16 x 8*NJ tile whose k-step j is the C
// fragment c[m][j] (taken as the A fragment (c0, c2, c1, c3): logical
// k = t is column 2t, k = t + 4 column 2t + 1), X the 8*NJ rows at sX
// ([.][D+4] in shared, MN-major: row k, column n), X_n its columns
// 8n..8n+7, read in the same permuted order: b0 = X[8j + 2t][8n + g],
// b1 = X[8j + 2t + 1][8n + g].
template <int D, int MT, int NJ>
__device__ __forceinline__ void mma_cx(float (&acc)[MT][D / 8][4],
                                       const float (&c)[MT][NJ][4],
                                       const float* sX, int g, int t) {
  constexpr int DP = D + 4;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    uint32_t ab[MT][4], as[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      split(c[m][j][0], ab[m][0], as[m][0]);
      split(c[m][j][2], ab[m][1], as[m][1]);
      split(c[m][j][1], ab[m][2], as[m][2]);
      split(c[m][j][3], ab[m][3], as[m][3]);
    }
    const float* x0 = sX + (8 * j + 2 * t) * DP + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t bb[2], bs[2];
      split(x0[8 * n], bb[0], bs[0]);
      split(x0[DP + 8 * n], bb[1], bs[1]);
#pragma unroll
      for (int m = 0; m < MT; ++m) mma3(acc[m][n], ab[m], as[m], bb, bs);
    }
  }
}

}  // namespace tf32x3
