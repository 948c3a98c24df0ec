// Hopper (sm_90a) building blocks shared by the tensor-core flash kernels
// (flash_fwd_wgmma.cu, flash_bwd_wgmma.cu, flash_varlen_wgmma.cu,
// flash_varlen_bwd_wgmma.cu):
// mbarriers, TMA tile copies, wgmma shared-memory descriptors and the
// wgmma instructions themselves, and the host-side encoding of TMA tensor
// maps.
//
// Tiles. A bf16 tile of R rows by D columns lives in shared memory as
// D / SWE column blocks of R rows by SWE elements (SWE = min(D, 64)), one
// after the other, each row SWE * 2 bytes (32 or 128) and each block
// swizzled as TMA's CU_TENSOR_MAP_SWIZZLE_32B / _128B writes it: the
// 16-byte chunk c of row r sits at chunk c ^ (r % 8) (128 B), or
// c ^ ((r / 4) % 2) (32 B). Every block starts on a 1024-byte boundary,
// so the pattern is the address-bit pattern the wgmma descriptor's
// layout code names.
//
// Descriptors (64 bits): start address >> 4 in bits 0-13, the leading
// byte offset >> 4 in bits 16-29, the stride byte offset >> 4 in bits
// 32-45, the layout (1 = 128-byte swizzle, 3 = 32-byte swizzle) in bits
// 62-63.
//   K-major operand (the reduction dimension is contiguous: Q and K in
//   Q K^T): a k16 step is 32 bytes of a row, so step s starts at column
//   block (16 s) / SWE plus (16 s % SWE) * 2 bytes; the stride byte
//   offset is the distance between groups of 8 rows (8 * row bytes); the
//   leading byte offset is not read.
//   MN-major operand (the output dimension is contiguous: V in P V, K in
//   dS K): a k16 step is 16 rows, so step s starts 16 s rows down; the
//   stride byte offset is again 8 rows. The kernels issue one wgmma per
//   column block (N = SWE), so the leading byte offset, the distance
//   between column blocks, is never read either.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hopper {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary at or after the dynamic shared memory base
__device__ __forceinline__ uint8_t* align_1024(uint8_t* raw) {
  const uint32_t base = smem_u32(raw);
  return raw + ((1024u - (base & 1023u)) & 1023u);
}

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive, and expect `bytes` of TMA traffic before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait until the phase of parity `parity` has completed. A wait that
// outlasts 2^26 tries (seconds, where a tile takes microseconds) is a
// pipeline fault: it traps, and the launch fails, instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// ---------------------------------------------------------------- TMA

// box {c0 .. c0 + box0, c1 .. c1 + box1, c2} of a 3-D tensor map into
// shared memory; rows past the tensor's end arrive as zeros
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// add a box of f32 shared memory (row-major, unswizzled) into the tensor
// at {c0, c1, c2} of a 3-D map; parts of the box past the tensor's end
// are dropped. The issuing thread commits it as a bulk group and waits
// with bulk_wait_read (shared memory read) or bulk_wait (done).
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map,
                                                  const void* src, int c0,
                                                  int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------- wgmma, descriptors

template <int SWB>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr,
                                              uint32_t sbo_bytes) {
  static_assert(SWB == 128 || SWB == 32, "32- or 128-byte swizzle");
  constexpr uint64_t layout = SWB == 128 ? 1 : 3;
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         ((uint64_t)((sbo_bytes >> 4) & 0x3FFFu) << 32) | (layout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers an asynchronous wgmma reads or writes: after a wait, the
// compiler may not read an accumulator early or reuse an A register.
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void pin(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// make this thread's generic-proxy shared-memory stores visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1..15) over the first `count` threads of the block
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// two floats rounded to bf16 and packed, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The m64nNk16 accumulator: thread t of the warpgroup (warp w = t / 32,
// lane l) holds d[4 j + 2 h + e] at row 16 w + l / 4 + 8 h, column
// 8 j + 2 (l % 4) + e. The register A operand of m64n*k16 is the same
// layout for a 16-column slice, so the accumulator's columns
// 16 kk .. 16 kk + 15 are the A fragment {d[8kk] d[8kk+1]},
// {d[8kk+2] d[8kk+3]}, {d[8kk+4] d[8kk+5]}, {d[8kk+6] d[8kk+7]}.
template <int R>
__device__ __forceinline__ void to_a_frags(const float (&d)[R],
                                           uint32_t (&a)[R / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// ------------------------------------------------- wgmma instructions
//
// bf16 x bf16 -> f32, m64nNk16; TA / TB: 1 = that operand is MN-major
// (transposed); `accum` 0 overwrites d, 1 adds to it.

// d[8] (+)= A[64x16] * B[16x16]: A and B from shared memory
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da,
                                         uint64_t db, int accum) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accum), "n"(TA), "n"(TB));
}

// d[32] (+)= A[64x16] * B[16x64]: A and B from shared memory
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accum) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accum), "n"(TA), "n"(TB));
}

// d[64] (+)= A[64x16] * B[16x128]: A and B from shared memory
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accum) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accum), "n"(TA), "n"(TB));
}

// d[8] (+)= A[64x16] * B[16x16]: A from registers (bf16 pairs), B
// from shared memory
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accum) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accum),
        "n"(TB));
}

// d[32] (+)= A[64x16] * B[16x64]: A from registers (bf16 pairs), B
// from shared memory
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accum) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accum),
        "n"(TB));
}

// ---------------------------------------------------------------- host

// cuTensorMapEncodeTiled, fetched from the driver at run time so the
// library needs no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a contiguous tensor of dims (d2, d1, d0), d0 innermost, as a 3-D map
// {d0, d1, d2}, read in boxes of {box0, box1, box2}
inline bool encode_3d(CUtensorMap* map, CUtensorMapDataType type,
                      int esize, const void* base, int d2, int d1, int d0,
                      int box0, int box1, int box2,
                      CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  cuuint64_t strides[2] = {(cuuint64_t)d0 * esize,
                           (cuuint64_t)d1 * d0 * esize};
  cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, (cuuint32_t)box2};
  cuuint32_t step[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline CUtensorMapSwizzle swizzle_of(int swe) {
  return swe * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
}

// A contiguous bf16 (BH, S, D) tensor as a 3-D map (D, S, BH), read in
// boxes of {swe, rows, 1} with the swizzle of a swe * 2-byte row. Being
// 3-D, a box past row S of one head reads zeros, not the next head.
inline bool tile_map(CUtensorMap* map, const void* base, int BH, int S,
                     int D, int swe, int rows) {
  return encode_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, BH, S, D,
                   swe, rows, 1, swizzle_of(swe));
}

// A contiguous bf16 packed (T, H, D) tensor (rows of every head
// interleaved, as varlen attention keeps them) as a 3-D map (D, H, T),
// read in boxes of {swe, 1, rows}: one head's `rows` consecutive rows,
// landing in shared memory exactly as a tile_map box does. One map serves
// every head; a box may start at any row, and rows past T read zeros.
inline bool packed_map(CUtensorMap* map, const void* base, int T, int H,
                       int D, int swe, int rows) {
  return encode_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, T, H, D,
                   swe, 1, rows, swizzle_of(swe));
}

// A contiguous f32 (BH, S, D) tensor as a 3-D map, boxes of {cols, rows,
// 1} in plain row-major order (for tma_reduce_add_3d)
inline bool f32_map(CUtensorMap* map, const void* base, int BH, int S, int D,
                    int cols, int rows) {
  return encode_3d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, BH, S, D,
                   cols, rows, 1, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// A contiguous f32 packed (T, H, D) tensor as a 3-D map (D, H, T), boxes
// of {cols, 1, rows}: one head's `rows` consecutive rows in plain
// row-major order (for tma_reduce_add_3d); a box may start at any row,
// and the rows of it past T are dropped
inline bool packed_f32_map(CUtensorMap* map, const void* base, int T, int H,
                           int D, int cols, int rows) {
  return encode_3d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, T, H, D,
                   cols, 1, rows, CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace hopper
