#!/usr/bin/env python3
"""Time variants of the f32 split flash backward pair
(``flash_bwd_tf32x3.cu``: ``flash_bwd_dkv_tf32x3_kernel``,
``flash_bwd_dq_tf32x3_kernel``) against the pair as committed.

    python3 flash_bwd_tf32x3_variants.py [--only NAME,NAME]

Run from the repository root on a machine with a CUDA GPU and nvcc. It
copies ``paddle2_tpu_torch/kernels/csrc/flash_bwd_tf32x3.cu``, with the
shared header ``tf32x3.cuh`` inlined, into
``build/flash_bwd_tf32x3_variants/`` once a variant, with textual edits
each, builds the copies with nvcc (sm_90a) in parallel, holds each
variant's dq/dk/dv against the plain backward (``flash_bwd_reference``,
f32) at the training shape (B8 H16 S1024 D64, causal and not) and at
Sq 200 / Sk 333 (D 16/64/128, causal and not) to the smoke's f32 limit
(1e-4, absolute below 1 and relative above), and times the two C
entries at the training shape, causal: CUDA events around 10 launches,
median of 15, in turns (committed, the variants, the variants
backwards, committed). Prints the card's name and power limit, ptxas's
registers and spills, one line a variant, and writes them to
``chiprun_out/flash_bwd_tf32x3_variants.json``.

It also measures the ceiling the pair works under: the rate of
``mma.sync.m16n8k8`` TF32 products alone on this card
(``mma_rate_kernel``: each warp runs eight independent accumulator
chains of back-to-back mma.sync on operands in registers, 132 x 16
blocks of 1, 2, 4 or 8 warps), in TFLOP/s, beside the dense TF32 peak
(494.7, a wgmma figure).

The edits (a variant is a set of them):

- ``cvt``: the operand split of the design first written, both halves
  through ``cvt.rna.tf32.f32`` (which the compiler expands with NaN and
  infinity tests) instead of the committed integer add and mask, small
  handed to the mma untruncated;
- ``rna_small``: as committed, and small's bits + 0x1000, so the bits
  the tensor cores read are small rounded to nearest (CUTLASS's
  ``round_half_ulp_truncate``) rather than truncated;
- ``trunc``: big = bits & 0xffffe000 (truncated, not rounded);
- ``mt1``: one m16 row tile a warp at every head dim (64-key dK/dV
  blocks, 64-row dQ blocks), so each B fragment serves 16 rows;
- ``bq64``: 64-row query steps in the dK/dV kernel;
- ``bkd64``: 64-key steps in the dQ kernel;
- ``unroll``: the K-major products' loop over D fully unrolled;
- ``ldsm``: the K-major products' fragments (A, and B two n-tiles at a
  time) read by ``ldmatrix.x4`` (an 8 x 8 b16 matrix is an 8 x 4 f32
  block, and lane (g, t) receives its element [g][t]: one instruction
  for four scalar loads).

Probes (``probe_*``) take a piece of the work out to show what it costs;
their outputs are wrong by design, so their error is reported, not
held to the limit: ``no_exp`` (P = the exponent, no ``expf``),
``no_split`` (big = x, small = 0: no split arithmetic, still three
mma), ``one_pass`` (big·big only: one mma a product; small, unused,
is not computed).
"""

import argparse
import ctypes
import json
import sys
from pathlib import Path

import variant_harness as vh

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "flash_bwd_tf32x3_variants"

ABT_LOADS = """    for (int m = 0; m < MT; ++m) {
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
    }"""
LDSM_LOADS = """    for (int m = 0; m < MT; ++m) {
      uint32_t r[4];
      ldsm_x4(r, sA + (16 * m + (lane & 7) + ((lane >> 3) & 1) * 8) * DP +
                     kk + (lane >> 4) * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split(__uint_as_float(r[e]), ab[m][e], as[m][e]);
    }
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      uint32_t r[4];
      ldsm_x4(r, sB + (8 * j + (lane & 7) + (lane >> 4) * 8) * DP + kk +
                     ((lane >> 3) & 1) * 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t bb[2], bs[2];
        split(__uint_as_float(r[2 * h]), bb[0], bs[0]);
        split(__uint_as_float(r[2 * h + 1]), bb[1], bs[1]);
#pragma unroll
        for (int m = 0; m < MT; ++m)
          mma3(acc[m][j + h], ab[m], as[m], bb, bs);
      }
    }"""
LDSM_HELPER = """__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

"""
SPLIT = '''  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));'''
EDITS = {
    "cvt": [(SPLIT, '''  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(rest));''')],
    "rna_small": [(SPLIT, '''  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;''')],
    "trunc": [(SPLIT, '''  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));''')],
    "mt1": [("constexpr int MT = D == 128 ? 1 : 2;", "constexpr int MT = 1;")],
    "bq64": [("constexpr int DKV_BQ = 32;", "constexpr int DKV_BQ = 64;")],
    "bkd64": [("constexpr int BKD = 32;", "constexpr int BKD = 64;")],
    "unroll": [("#pragma unroll 2\n  for (int kk = 0; kk < D; kk += 8)",
                "#pragma unroll\n  for (int kk = 0; kk < D; kk += 8)")],
    "no_exp": [("? expf(s[m][j][e] * scale - lq)", "? (s[m][j][e] * scale - lq)"),
               ("? expf(s[m][j][e] * scale - l)", "? (s[m][j][e] * scale - l)")],
    "no_split": [(SPLIT, '''  big = __float_as_uint(x);
  small = 0u;''')],
    "one_pass": [('''  mma_tf32(c, as, bb[0], bb[1]);
  mma_tf32(c, ab, bs[0], bs[1]);
  mma_tf32(c, ab, bb[0], bb[1]);''', "  mma_tf32(c, ab, bb[0], bb[1]);")],
    "ldsm": [("// acc[m][j] = A_m B_j^T for this warp", LDSM_HELPER
              + "// acc[m][j] = A_m B_j^T for this warp"),
             (ABT_LOADS, LDSM_LOADS),
             ("""  constexpr int DP = D + 4;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NJ; ++j)""", """  constexpr int DP = D + 4;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NJ; ++j)""")],
}
VARIANTS = {
    "committed": [],
    "cvt": ["cvt"],
    "rna_small": ["rna_small"],
    "trunc": ["trunc"],
    "mt1": ["mt1"],
    "mt1_bq64_bkd64": ["mt1", "bq64", "bkd64"],
    "mt1_cvt_bq64_bkd64": ["mt1", "cvt", "bq64", "bkd64"],
    "bq64": ["bq64"],
    "bkd64": ["bkd64"],
    "unroll": ["unroll"],
    "ldsm": ["ldsm"],
    "mt1_ldsm": ["mt1", "ldsm"],
    "probe_no_exp": ["no_exp"],
    "probe_no_split": ["no_split"],
    "probe_one_pass": ["one_pass"],
}


MMA_RATE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void mma_rate_kernel(float* out, int iters) {
  uint32_t a[4], b0, b1;
  const uint32_t lane = threadIdx.x % 32;
  for (int i = 0; i < 4; ++i) a[i] = 0x3f800000u + (lane + i) * 0x2000u;
  b0 = 0x3f000000u + lane * 0x2000u;
  b1 = b0 + 0x4000u;
  float c[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float sum = 0.f;
  for (int j = 0; j < 8; ++j)
    for (int e = 0; e < 4; ++e) sum += c[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

extern "C" int mma_rate(float* out, int blocks, int threads, int iters,
                        void* stream) {
  mma_rate_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return cudaGetLastError();
}
"""


def mma_rate(torch):
    """TFLOP/s of back-to-back mma.sync m16n8k8 TF32 products, by warps a
    block (132 x 16 blocks)."""
    vh.build(OUT, {"mma_rate": MMA_RATE})
    fn = vh.load(OUT / "mma_rate.so", {"mma_rate": [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]})["mma_rate"]
    blocks, iters = 132 * 16, 512
    out = torch.empty(blocks * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for warps in (1, 2, 4, 8):
        def run():
            assert fn(out.data_ptr(), blocks, 32 * warps, iters, stream) == 0
        s = vh.event_ms(run, iters=1, inner=5, warmup=1) / 1e3
        flops = blocks * warps * iters * 8 * 2 * 16 * 8 * 8
        rates[f"{warps} warps a block"] = flops / s / 1e12
    return rates


def build(names):
    # the shared helpers (split, mma3, the fragment walks) inlined, so
    # that the edits reach them in the copy
    src = (vh.CSRC / "flash_bwd_tf32x3.cu").read_text().replace(
        '#include "tf32x3.cuh"', (vh.CSRC / "tf32x3.cuh").read_text())
    logs = vh.build(OUT, {
        name: vh.edited(src, [e for edit in VARIANTS[name]
                              for e in EDITS[edit]], name)
        for name in names})
    import chip_smoke
    return {name: {k: [x for x in v if "registers" in x or "spill" in x]
                   for k, v in chip_smoke.ptxas_report(log).items()}
            for name, log in logs.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="",
                    help="comma-separated variants (committed is kept)")
    args = ap.parse_args()
    names = list(VARIANTS)
    if args.only:
        names = ["committed"] + [n for n in args.only.split(",")
                                 if n != "committed"]
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_bwd_tf32x3_variants: no CUDA device")
    from paddle2_tpu_torch.kernels import flash_attn as fa
    smi = vh.nvidia_smi()
    print(f"[device] {smi}", flush=True)
    rates = mma_rate(torch)
    print(f"[mma.sync tf32] TFLOP/s {json.dumps(rates)} (dense TF32 peak "
          f"494.7)", flush=True)
    ptxas = build(names)
    libs = {name: vh.load(OUT / f"{name}.so",
                          fa._LIBRARIES["flash_bwd_tf32x3"])
            for name in names}

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def inputs(B, H, Sq, Sk, D, causal):
        q, do = (torch.randn(B, H, Sq, D, generator=gen, device=dev)
                 for _ in range(2))
        k, v = (torch.randn(B, H, Sk, D, generator=gen, device=dev)
                for _ in range(2))
        scale = D ** -0.5
        o, lse = fa.flash_fwd(q, k, v, scale=scale, causal=causal)
        delta = (do * o).sum(-1)
        return q, k, v, o, lse, do, delta, scale

    def pair(lib, x, causal):
        q, k, v, o, lse, do, delta, scale = x
        B, H, Sq, D = q.shape
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        head = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
        tail = [B, H, Sq, k.shape[2], D, 0, scale, int(causal), stream]
        return (lambda: lib["flash_bwd_dkv_tf32x3"](
                    *head, dk.data_ptr(), dv.data_ptr(), *tail),
                lambda: lib["flash_bwd_dq_tf32x3"](*head, dq.data_ptr(),
                                                   *tail),
                (dq, dk, dv))

    errs = {n: {} for n in names}
    cases = [(8, 16, 1024, 1024, 64, c) for c in (True, False)] + [
        (2, 4, 200, 333, D, c) for D in (16, 64, 128) for c in (True, False)]
    for B, H, Sq, Sk, D, causal in cases:
        x = inputs(B, H, Sq, Sk, D, causal)
        q, k, v, o, lse, do, _, scale = x
        ref = fa.flash_bwd_reference(q, k, v, o, lse, do, scale, causal)
        for name in names:
            dkv, dq, outs = pair(libs[name], x, causal)
            assert dkv() == 0 and dq() == 0, name
            torch.cuda.synchronize()
            e = max(((g - r).abs() / r.abs().clamp_min(1.0)).max().item()
                    for g, r in zip(outs, ref))
            errs[name][f"B{B} H{H} Sq{Sq} Sk{Sk} D{D} causal={causal}"] = e
            if not e <= 1e-4 and not name.startswith("probe_"):
                raise SystemExit(f"{name}: err {e} at {Sq}/{Sk} D{D}")
        del x, q, k, v, o, lse, do, ref
        torch.cuda.empty_cache()

    x = inputs(8, 16, 1024, 1024, 64, True)
    runs = {n: pair(libs[n], x, True)[:2] for n in names}
    turns = vh.in_turns(names, lambda n: [vh.event_ms(fn, iters=15)
                                          for fn in runs[n]])
    rows = []
    for name in names:
        dkv_ms, dq_ms = (list(t) for t in zip(*turns[name]))
        row = dict(variant=name, edits=VARIANTS[name], dkv_ms=dkv_ms,
                   dq_ms=dq_ms, pair_ms=min(dkv_ms) + min(dq_ms),
                   max_err=max(errs[name].values()), ptxas=ptxas[name])
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "flash_bwd_tf32x3_variants.json").write_text(json.dumps(
        dict(nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
             mma_sync_tf32_tflops=rates,
             shape="B8 H16 Sq1024 Sk1024 D64 causal f32", errs=errs,
             variants=rows), indent=1))


if __name__ == "__main__":
    main()
