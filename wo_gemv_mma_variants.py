#!/usr/bin/env python3
"""Time variants and K splits of the tensor-core decode kernels
(``wo_gemv_mma_kernel``, bf16; ``wo_gemv_tf32_kernel``, f32) to see
what bounds them.

    python3 wo_gemv_mma_variants.py [--dtype bfloat16|float32] [--only a,b]

Run from the repository root on a machine with a CUDA GPU and nvcc. It
copies ``paddle2_tpu_torch/kernels/csrc/wo_matmul.cu`` with one textual
change per variant into ``build/wo_gemv_mma_variants/``, builds each
with nvcc (sm_90a) in parallel, and times the decode C entry of x's
dtype (``wo_gemv_mma`` for bf16, ``wo_gemv_tf32`` for f32) of each at
GPT-3 1.3B's decode shapes (M 1 and 8): CUDA events around 10 launches,
median of 30 (``variant_harness.event_ms``). Each shape is timed warm
(one weight, which stays in the 50 MB L2 where it is smaller) and cold
(a new weight each launch, from copies that together pass 100 MB, as a
decode step meets its 97 weights). Variants that drop work give wrong
products on purpose; their error is printed beside their time. Prints
the card's name and power limit, ptxas's registers for each variant,
the base kernel at every K split (``k_per_split``, a multiple of 128,
at most 8) with the wrapper's choice marked, and ``torch.mm`` over the
dequantized weight in x's dtype, warm and cold. In f32 it also prints
each variant's error at M 8, K 20480, N 34816 in one K split (5,120 rows
a warp, past the 2048 after which a warp adds its mma sums into a second
sum). (The kernels each replaced run on the parent commits:
``phase_runner.py --phase int8_serving`` / ``--phase f32_decode`` compare
them in turns.)

bf16 variants:

- ``base``: the kernel as committed (a column tile's K splits add
  their partial sums through distributed shared memory, one cluster);
- ``ahead1`` / ``ahead3``: one or three steps in flight a thread instead
  of two;
- ``nt256``: blocks of 256 threads (8 warps) instead of 128;
- ``six_blocks``: registers capped for six blocks of 128 an SM;
- ``no_finish``: the block's sums are neither added across its cluster
  nor stored (the reduction and the epilogue left out);
- ``no_mma``: no mma is issued (the loads and the widening alone);
- ``no_widen``: the raw int8 words go to the mma (no widening);

f32 variants (``--dtype float32``):

- ``base``: the kernel as committed (one step in flight a thread, a
  second sum every 32 steps);
- ``ahead2``: two steps in flight a thread;
- ``six_blocks`` as above;
- ``one_pass``: x_big alone, no x_small pass (single-pass TF32: reads
  past the f32 limit);
- ``chunk128``: a warp adds its mma sums into the second sum every 128
  steps (2048 rows) instead of 32 (512 rows);
- ``no_chunk``: no second sum at any K.

- ``stream`` (not a variant of the source): a plain read of the same
  weight bytes, 16 bytes a thread over a grid-stride loop of 528 blocks,
  the rate the card gives this many bytes.
"""

import argparse
import ctypes
import sys
from pathlib import Path

import variant_harness as vh

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "wo_gemv_mma_variants"
P, I = ctypes.c_void_p, ctypes.c_int
ENTRY = {"bfloat16": "wo_gemv_mma", "float32": "wo_gemv_tf32"}
ENTRIES = {e: {e: [P] * 5 + [I] * 4 + [ctypes.c_float, P],
               f"{e}_blocks_per_sm": [I, P]} for e in ENTRY.values()}

AHEAD = "constexpr int MMA_AHEAD = 2; "
NT128 = "constexpr int MMA_NT = 128; "
BOUNDS = "__launch_bounds__(MMA_NT, 512 / MMA_NT)"
MMA_ASM = """  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));"""
WIDEN = """  float f0[4], f1[4], f2[4], f3[4];
  i8x4_to_f32(r0, f0);
  i8x4_to_f32(r1, f1);
  i8x4_to_f32(r2, f2);
  i8x4_to_f32(r3, f3);
  mma_bf16(c0, bf16x2(f0[0], f1[0]), bf16x2(f0[1], f1[1]),
           bf16x2(f2[0], f3[0]), bf16x2(f2[1], f3[1]), b0, b1);
  mma_bf16(c1, bf16x2(f0[2], f1[2]), bf16x2(f0[3], f1[3]),
           bf16x2(f2[2], f3[2]), bf16x2(f2[3], f3[3]), b0, b1);"""
VARIANTS = {
    "base": [],
    "ahead1": [(AHEAD, "constexpr int MMA_AHEAD = 1; ")],
    "ahead3": [(AHEAD, "constexpr int MMA_AHEAD = 3; ")],
    "nt256": [(NT128, "constexpr int MMA_NT = 256; ")],
    "six_blocks": [(BOUNDS, "__launch_bounds__(MMA_NT, 768 / MMA_NT)")],
    "no_finish": [("  cluster_finish(red, s, bias, y, M, N, qmax);\n}",
                   "  if (tid == 0) y[blockIdx.x] = from_f<T>("
                   "red[blockIdx.y]);\n}")],
    "no_mma": [(MMA_ASM, "  c[0] += __uint_as_float((a0 ^ a1 ^ a2 ^ a3) "
                         "& b0 & b1 & 0x3f800000u);")],
    "no_widen": [(WIDEN, "  mma_bf16(c0, r0, r1, r2, r3, b0, b1);\n"
                         "  mma_bf16(c1, r3, r2, r1, r0, b0, b1);")],
}
SMALL_PASS = """    mma_tf32(c0, a0, xs[2 * h], xs[2 * h + 1]);
    mma_tf32(c0, a0, xb[2 * h], xb[2 * h + 1]);
    mma_tf32(c1, a1, xs[2 * h], xs[2 * h + 1]);
    mma_tf32(c1, a1, xb[2 * h], xb[2 * h + 1]);"""
CHUNK = "constexpr int TF_CHUNK = 32;"
F32_VARIANTS = {
    "base": [],
    "ahead2": [("constexpr int TF_AHEAD = 1; ",
                "constexpr int TF_AHEAD = 2; ")],
    "six_blocks": VARIANTS["six_blocks"],
    "one_pass": [(SMALL_PASS, "    mma_tf32(c0, a0, xb[2 * h], xb[2 * h + 1]);\n"
                              "    mma_tf32(c1, a1, xb[2 * h], xb[2 * h + 1]);")],
    "chunk128": [(CHUNK, "constexpr int TF_CHUNK = 128;")],
    "no_chunk": [(CHUNK, "constexpr int TF_CHUNK = 1 << 30;")],
}
LONG_K = (8, 20480, 34816)
STREAM = r"""
#include <cuda_runtime.h>
__global__ void stream_kernel(const uint4* __restrict__ p, long long n16,
                              unsigned* out) {
  unsigned acc = 0;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n16;
       i += gridDim.x * 256LL) {
    const uint4 v = __ldg(p + i);
    acc ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  if (acc == 0x9e3779b9u) out[0] = acc;
}
extern "C" int stream(const void* p, long long n16, void* out, void* st) {
  stream_kernel<<<528, 256, 0, (cudaStream_t)st>>>((const uint4*)p, n16,
                                                  (unsigned*)out);
  return cudaGetLastError();
}
"""
# GPT-3 1.3B's projections (K, N) at decode
SHAPES = {"up": (2048, 8192), "head": (2048, 50304), "qkv": (2048, 6144),
          "out_proj": (2048, 2048), "down": (8192, 2048)}
COLD_BYTES = 100 << 20


def build(only, dtype):
    src = (vh.CSRC / "wo_matmul.cu").read_text()
    table = F32_VARIANTS if dtype == "float32" else VARIANTS
    names = [n for n in table if only is None or n in only or n == "base"]
    sources = {n: vh.edited(src, table[n], n) for n in names}
    logs = vh.build(OUT, dict(sources, stream=STREAM))
    libs = {"stream": vh.load(OUT / "stream.so", {
        "stream": [P, ctypes.c_longlong, P, P]})["stream"]}
    for name, log in logs.items():
        if name == "stream":
            continue
        kernel = ("wo_gemv_tf32_kernel" if dtype == "float32"
                  else "wo_gemv_mma_kernel")
        regs = vh.ptxas_lines(log, lambda k: kernel in k)
        print(f"[build] {name}: {[v for lines in regs.values() for v in lines if 'registers' in v or 'spill' in v]}",
              flush=True)
        libs[name] = vh.load(OUT / f"{name}.so", ENTRIES[ENTRY[dtype]])
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="comma-separated variants besides base")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    args = ap.parse_args()
    only = None if args.only is None else set(args.only.split(","))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        sys.exit("wo_gemv_mma_variants: no CUDA device")
    from paddle2_tpu_torch.kernels import quant_matmul as qm
    print(f"[device] {vh.nvidia_smi()}", flush=True)
    libs = build(only, args.dtype)
    entry = ENTRY[args.dtype]
    xdt = getattr(torch, args.dtype)
    split = qm.tf32_k_split if args.dtype == "float32" else qm.mma_k_split
    dev = torch.device("cuda:0")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    sink = torch.zeros(4, dtype=torch.int32, device=dev)
    read = libs.pop("stream")
    for name, fns in libs.items():
        per_sm = ctypes.c_int(0)
        fns[f"{entry}_blocks_per_sm"](1, ctypes.byref(per_sm))
        print(f"[occupancy] {name}: {per_sm.value} blocks an SM", flush=True)
    base = libs["base"]
    per_sm = ctypes.c_int(0)
    base[f"{entry}_blocks_per_sm"](1, ctypes.byref(per_sm))
    resident = per_sm.value * sms
    if args.dtype == "float32":
        # every variant at a K whose warps' walks pass the second sum's
        # 2048 rows, in one split, against the plain version
        M, K, N = LONG_K
        w8, s8 = qm.quantize_channelwise(
            torch.randn(K, N, generator=gen, device=dev) * 0.02)
        x = torch.randn(M, K, generator=gen, device=dev)
        y = torch.empty(M, N, device=dev)
        ref = qm.int8_weight_only_matmul_reference(x, w8, s8)
        for name, fns in libs.items():
            err = fns[entry](x.data_ptr(), w8.data_ptr(), s8.data_ptr(),
                             None, y.data_ptr(), M, K, N, K, 127.0, stream)
            if err:
                sys.exit(f"{entry}: CUDA error {err}")
            torch.cuda.synchronize()
            scaled = ((y - ref).abs() / ref.abs().clamp_min(1.0)).max().item()
            ms = vh.event_ms(lambda: fns[entry](
                x.data_ptr(), w8.data_ptr(), s8.data_ptr(), None,
                y.data_ptr(), M, K, N, K, 127.0, stream), iters=10)
            print(f"long K M{M} K{K} N{N} one split {name}: scaled err "
                  f"{scaled:.3g}, {ms:.4f} ms", flush=True)
        del w8, s8, x, y, ref
        torch.cuda.empty_cache()
    for label, (K, N) in SHAPES.items():
        copies = max(1, -(-COLD_BYTES // (K * N)))
        ws8, ss = [], []
        for _ in range(copies):
            w8, s8 = qm.quantize_channelwise(
                torch.randn(K, N, generator=gen, device=dev) * 0.02)
            ws8.append(w8)
            ss.append(s8)
        turn = {"i": 0}

        def read_w(cold):
            i = turn["i"] = (turn["i"] + 1) % copies if cold else 0
            read(ws8[i].data_ptr(), K * N // 16, sink.data_ptr(), stream)
        print(f"{label} K{K} N{N} stream (a plain read of the weight): warm "
              f"{vh.event_ms(lambda: read_w(False)):.4f} cold "
              f"{vh.event_ms(lambda: read_w(True)):.4f} ms, bound "
              f"{K * N / 3.35e12 * 1e3:.4f}", flush=True)
        for M in (1, 8):
            if label not in ("up", "head") and M == 1 and \
                    args.dtype == "bfloat16":
                continue
            x = torch.randn(M, K, generator=gen, device=dev).to(xdt)
            y = torch.empty(M, N, dtype=xdt, device=dev)
            ref = qm.int8_weight_only_matmul_reference(x, ws8[0],
                                                       ss[0]).float()
            chosen, _ = split(M, K, N, resident)
            most = 16 if args.dtype == "float32" else 8
            pers = sorted({p for p in (128, 256, 512, 1024, 2048, chosen)
                           if p <= K and -(-K // p) <= most})
            state = {"i": 0}

            def call(fn, per, cold):
                i = state["i"] = (state["i"] + 1) % copies if cold else 0
                err = fn[entry](x.data_ptr(), ws8[i].data_ptr(),
                                ss[i].data_ptr(), None, y.data_ptr(),
                                M, K, N, per, 127.0, stream)
                if err:
                    sys.exit(f"{entry}: CUDA error {err}")

            def timed(fn, per):
                call(fn, per, False)
                torch.cuda.synchronize()
                err = ((y.float() - ref).abs() / ref.abs().clamp_min(1.0)
                       ).max().item()
                warm = vh.event_ms(lambda: call(fn, per, False))
                cold = vh.event_ms(lambda: call(fn, per, True))
                return warm, cold, err
            shape = f"{label} M{M} K{K} N{N}"
            size = x.element_size()
            bound = (M * K * size + K * N + 4 * N + M * N * size) \
                / 3.35e12 * 1e3
            for per in pers:
                warm, cold, err = timed(base, per)
                mark = " (the wrapper's split)" if per == chosen else ""
                print(f"{shape} base per {per} ({-(-K // per)} splits){mark}:"
                      f" warm {warm:.4f} cold {cold:.4f} ms, bound "
                      f"{bound:.4f}, scaled err {err:.3g}", flush=True)
            for name, fns in libs.items():
                if name == "base":
                    continue
                warm, cold, err = timed(fns, chosen)
                print(f"{shape} {name} per {chosen}: warm {warm:.4f} cold "
                      f"{cold:.4f} ms, scaled err {err:.3g}", flush=True)
            deq = [(w.float() * (s / 127.0)).to(xdt)
                   for w, s in zip(ws8[:max(1, copies // 2)], ss)]
            j = {"i": 0}

            def addmm(cold):
                i = j["i"] = (j["i"] + 1) % len(deq) if cold else 0
                return torch.mm(x, deq[i])
            print(f"{shape} torch.mm on the dequantized weight: warm "
                  f"{vh.event_ms(lambda: addmm(False)):.4f} cold "
                  f"{vh.event_ms(lambda: addmm(True)):.4f} ms", flush=True)
            del deq
        del ws8, ss
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
