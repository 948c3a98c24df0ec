#!/usr/bin/env python3
"""Time variants of the RMSNorm vector forward (``rms_norm_fwd_vec_kernel``)
against the kernel as committed.

    python3 norm_fwd_variants.py

Run from the repository root on a machine with a CUDA GPU and nvcc. It
copies ``paddle2_tpu_torch/kernels/csrc/rms_norm.cu`` into
``build/norm_fwd_variants/`` once a variant, with one textual change
each, builds the copies with nvcc (sm_90a) in parallel, holds each
variant's output and 1/rms against the committed kernel's (the same
sums in the same order: equal), and times the C entries at the RMSNorm
main-path shapes (the incubate stack's R16384 H2048 and the
``fused_rms_norm`` docstring's R8192 H1024, bf16 x and w): CUDA events
around 10 launches, median of 30, in turns (committed, the variants,
the variants backwards, committed). Prints the card's name and power
limit, ptxas's registers for the bf16 kernels, one line a shape, and
writes them to ``chiprun_out/norm_fwd_variants.json``.

- ``committed``: the kernel as committed;
- ``tma``: one kernel and C entry appended, ``rms_norm_fwd_tma``: the
  vector route's arithmetic and lane mapping (one warp a row, bf16 x
  and w only), but each warp's rows arrive in shared memory through
  ``cp.async.bulk`` (one bulk copy a row, completing on an mbarrier),
  two slots a warp, so the next row is in flight while the current one
  reduces and is written;
- ``evict_first``: x read and the output written with the evict-first
  cache hints (``__ldcs`` / ``__stcs``);
- ``one_pass_grid``: one block for every 8 rows (no persistent grid;
  each block stages w once for its 8 rows);
- ``interleaved_rows``: the persistent grid's row slots take
  neighbouring rows across blocks (rows s * G + b + i * G * 8) instead of
  within one block, so the last, partial sweep spreads over every block;
- ``four_blocks``: ``__launch_bounds__(256, 4)``, so ptxas keeps the
  kernel at 64 registers and four blocks (32 warps) fit an SM.
"""

import ctypes
import json
import sys
from pathlib import Path

import variant_harness as vh

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "norm_fwd_variants"

VARIANT = r"""
#include "hopper.cuh"

namespace {

// the most dynamic shared memory the variant asks for (its static
// barriers take the rest of the 227 KB)
constexpr int TMA_MAX_SMEM = 200 * 1024;

__device__ __forceinline__ void bulk_row(void* dst, uint64_t* bar,
                                         const void* src, int bytes) {
  hopper::mbar_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(hopper::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(hopper::smem_u32(bar))
      : "memory");
}

// one warp a row; shared memory: w (rounded up to 128 bytes), then two
// row slots a warp
template <int VPL>
__global__ void __launch_bounds__(rowvec::VEC_NT)
    rms_norm_fwd_tma_kernel(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ w,
                            __nv_bfloat16* __restrict__ o,
                            float* __restrict__ r_out, long long R, int H,
                            float eps) {
  using XT = __nv_bfloat16;
  constexpr int E = 8;
  extern __shared__ __align__(128) unsigned char sm_raw[];
  __shared__ __align__(8) uint64_t bar[rowvec::VEC_WARPS][2];
  const int row_bytes = H * 2;
  const int wbytes = (H * 2 + 127) & ~127;
  const XT* ws = reinterpret_cast<const XT*>(sm_raw);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned char* slots = sm_raw + wbytes + warp * 2 * row_bytes;
  rowvec::stage(w, sm_raw, H * 2);
  if (lane == 0) {
    hopper::mbar_init(&bar[warp][0], 1);
    hopper::mbar_init(&bar[warp][1], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int nv = H / E;
  const long long stride = (long long)gridDim.x * rowvec::VEC_WARPS;
  long long row = (long long)blockIdx.x * rowvec::VEC_WARPS + warp;
  if (lane == 0 && row < R)
    bulk_row(slots, &bar[warp][0], x + row * H, row_bytes);
  for (int i = 0; row < R; row += stride, ++i) {
    const int s = i & 1;
    // the other slot was read in the last iteration, before its
    // __syncwarp
    if (lane == 0 && row + stride < R)
      bulk_row(slots + (s ^ 1) * row_bytes, &bar[warp][s ^ 1],
               x + (row + stride) * H, row_bytes);
    hopper::mbar_wait(&bar[warp][s], (i >> 1) & 1);
    const uint4* srow = reinterpret_cast<const uint4*>(slots + s * row_bytes);
    uint4 v[VPL];
#pragma unroll
    for (int k = 0; k < VPL; ++k)
      if (lane + k * 32 < nv) v[k] = srow[lane + k * 32];
    __syncwarp();
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      if (lane + k * 32 < nv) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float f = rowvec::elem<XT>(v[k], j);
          q += f * f;
        }
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) q += __shfl_xor_sync(0xffffffffu, q, d);
    const float r = __frsqrt_rn(q / (float)H + eps);
    uint4* orow = reinterpret_cast<uint4*>(o + row * H);
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int i2 = lane + k * 32;
      if (i2 < nv) {
        float wf[E];
        rowvec::chunk_f<XT, XT>(ws + i2 * E, wf);
        uint4 out;
#pragma unroll
        for (int j = 0; j < E; ++j)
          rowvec::set_elem<XT>(
              out, j,
              __fmul_rn(__fmul_rn(rowvec::elem<XT>(v[k], j), r), wf[j]));
        orow[i2] = out;
      }
    }
    if (lane == 0) r_out[row] = r;
  }
}

template <int VPL>
int launch_tma(const void* x, const void* w, void* o, void* r, long long R,
               int H, float eps, cudaStream_t st) {
  const auto kernel = rms_norm_fwd_tma_kernel<VPL>;
  const size_t smem =
      ((H * 2 + 127) & ~127) + (size_t)rowvec::VEC_WARPS * 2 * H * 2;
  static rowvec::GridCache cache;
  int blocks = 0;
  cudaError_t err = rowvec::persistent_blocks(
      kernel, cache, smem, TMA_MAX_SMEM,
      (R + rowvec::VEC_WARPS - 1) / rowvec::VEC_WARPS, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, rowvec::VEC_NT, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(r), R, H, eps);
  return cudaGetLastError();
}

}  // namespace

// rms_norm_fwd's signature; bf16 x and w, 16-byte aligned, H % 8 == 0
// and H <= 4096 (one warp a row) only
extern "C" int rms_norm_fwd_tma(const void* x, const void* w, void* o,
                                void* r, long long R, int H, int x_dtype,
                                int w_dtype, float eps, void* stream) {
  if (x_dtype != 1 || w_dtype != 1 || H % 8 || H > 4096 || R <= 0)
    return cudaErrorInvalidValue;
  int wpr = 0, vpl = 0;
  rowvec::vec_plan(H / 8, &wpr, &vpl);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vpl) {
    case 4: return launch_tma<4>(x, w, o, r, R, H, eps, st);
    case 8: return launch_tma<8>(x, w, o, r, R, H, eps, st);
    case 16: return launch_tma<16>(x, w, o, r, R, H, eps, st);
  }
  return cudaErrorInvalidValue;
}
"""

SHAPES = [(16384, 2048, "stack"), (8192, 1024, "docstring")]
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_void_p])


LOAD = "      if (t + k * T < nv) v[k] = xr[t + k * T];"
STORE = "        orow[i] = out;"
ROWS = ("  for (long long row = (long long)blockIdx.x * rpb + warp / wpr; "
        "row < R;\n       row += (long long)gridDim.x * rpb) {")
BOUNDS = ("__global__ void __launch_bounds__(rowvec::VEC_NT)\n"
          "    rms_norm_fwd_vec_kernel(")
GRID = ("  kernel<<<blocks, rowvec::VEC_NT, smem, st>>>(\n"
        "      static_cast<const XT*>(x), static_cast<const WT*>(w),")
VARIANTS = {
    "committed": [],
    "tma": [],
    "evict_first": [(LOAD, LOAD.replace("xr[t + k * T]",
                                        "__ldcs(xr + t + k * T)")),
                    (STORE, "        __stcs(orow + i, out);")],
    "one_pass_grid": [(GRID, GRID.replace(
        "<<<blocks,", "<<<(unsigned)((R + rpb - 1) / rpb),"))],
    "interleaved_rows": [(ROWS, "  for (long long row = (long long)(warp / "
                                "wpr) * gridDim.x + blockIdx.x;\n       row "
                                "< R; row += (long long)gridDim.x * rpb) {")],
    "four_blocks": [(BOUNDS, BOUNDS.replace("(rowvec::VEC_NT)",
                                            "(rowvec::VEC_NT, 4)"))],
}


def build():
    src = (vh.CSRC / "rms_norm.cu").read_text()
    logs = vh.build(OUT, {
        name: vh.edited(src + (VARIANT if name == "tma" else ""), edits,
                        name)
        for name, edits in VARIANTS.items()})
    libs, regs = {}, {}
    for name, log in logs.items():
        for kernel, lines in vh.ptxas_lines(
                log, lambda k: "fwd_vec_kernelI13__nv_bfloat16S" in k
                or "fwd_tma_kernel" in k).items():
            regs[f"{name} {kernel}"] = lines
        entry = "rms_norm_fwd_tma" if name == "tma" else "rms_norm_fwd"
        libs[name] = vh.load(OUT / f"{name}.so", {entry: ARGTYPES})[entry]
    return libs, regs


def main():
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        sys.exit("norm_fwd_variants: no CUDA device")
    from paddle2_tpu_torch.kernels import fused_rms_norm as frn
    smi = vh.nvidia_smi()
    print(f"[device] {smi}", flush=True)
    libs, regs = build()
    for name, lines in regs.items():
        print(f"[build] {name}: {'; '.join(lines)}", flush=True)
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    rows = []
    for R, H, what in SHAPES:
        x = (torch.randn(R, H, generator=gen, device=dev) * 2 + 0.5).to(
            torch.bfloat16)
        w = torch.randn(H, generator=gen, device=dev).to(torch.bfloat16)
        runs, outs = {}, {}
        for name, fn in libs.items():
            o = torch.empty_like(x)
            r = torch.empty(R, dtype=torch.float32, device=dev)

            def run(fn=fn, o=o, r=r, name=name):
                err = fn(x.data_ptr(), w.data_ptr(), o.data_ptr(),
                         r.data_ptr(), R, H, 1, 1, 1e-6, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            run()
            torch.cuda.synchronize()
            runs[name], outs[name] = run, (o, r)
        o0, r0 = outs["committed"]
        equal = {n: torch.equal(o, o0) and torch.equal(r, r0)
                 for n, (o, r) in outs.items()}
        ref_o, _ = frn.rms_norm_fwd_reference(x, w, 1e-6)
        times = vh.in_turns(list(runs), lambda n: vh.event_ms(runs[n]))
        row = dict(shape=f"R{R} H{H} ({what}) bf16, w bf16",
                   equal_to_committed=equal,
                   max_abs_err_vs_plain=(o0.float() - ref_o.float()).abs()
                   .max().item(),
                   ms=times, bound_ms=(2.0 * R * H * 2 + H * 2 + 4.0 * R)
                   / 3.35e12 * 1e3)
        print(json.dumps(row), flush=True)
        rows.append(row)
        if not all(equal.values()):
            sys.exit(f"{what}: a variant's output differs from the "
                     f"committed kernel's: {equal}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "norm_fwd_variants.json").write_text(json.dumps(dict(
        nvidia_smi=smi, ptxas=regs, rows=rows)) + "\n")


if __name__ == "__main__":
    main()
