#!/usr/bin/env python3
"""Time variants of the tensor-core weight-only kernel to see what bounds
a K-step.

    python3 wo_wgmma_variants.py

Run from the repository root on a machine with a CUDA GPU and nvcc. It
copies ``paddle2_tpu_torch/kernels/csrc/wo_matmul_wgmma.cu`` with one
textual change per variant into ``build/wo_wgmma_variants/``, builds
each with nvcc (sm_90a) in parallel, and times the C entry of each at
GPT-3 1.3B's prefill shapes (CUDA events around 10 launches, median of
30). Variants that drop work give wrong products on purpose; their
error is printed beside their time. Prints the card's name and power
limit, ptxas's registers for each variant, then one line a shape and
variant.

- ``base``: the kernel as committed;
- ``no_widen``: the consumers skip the widening (the MMA path alone);
- ``no_mma``: no wgmma is issued (the TMA and widening path alone);
- ``no_fence``: no ``fence.proxy.async`` after the widening;
- ``no_wait``: the consumers do not wait for the next stage's TMA;
- ``stages6`` / ``stages2``: six or two TMA stages instead of four;
- ``prmt``: bf16 pairs packed by byte permutation (the f32 values are
  small integers, so their low 16 bits are zero) instead of cvt;
- ``two_blocks``: two TMA stages and two blocks an SM;
- ``bn256``: 128 x 256 output tiles (four widened column blocks).
"""

import ctypes
import sys
from pathlib import Path

import variant_harness as vh

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "wo_wgmma_variants"
ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float,
                                                        ctypes.c_void_p]

MMA = "        wgmma_ss<0, 1>(acc[cb], da,"
PACK = """          make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                     pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));"""
PRMT = """          make_uint4(__byte_perm(__float_as_uint(f[0]),
                                 __float_as_uint(f[1]), 0x7632),
                     __byte_perm(__float_as_uint(f[2]),
                                 __float_as_uint(f[3]), 0x7632),
                     __byte_perm(__float_as_uint(f[4]),
                                 __float_as_uint(f[5]), 0x7632),
                     __byte_perm(__float_as_uint(f[6]),
                                 __float_as_uint(f[7]), 0x7632));"""
STAGES = "constexpr int STAGES = 4;"
VARIANTS = {
    "base": [],
    "no_widen": [("      widen(sw + s1 * W_BYTES, swb + ((i + 1) % WSTAGES)"
                  " * WB_BYTES, tid);\n", "")],
    "no_mma": [("      for (int cb = 0; cb < NCB; ++cb)\n" + MMA,
                "      for (int cb = 0; cb < 0; ++cb)\n" + MMA)],
    "no_fence": [("      fence_proxy_async();\n    }\n    named_barrier",
                  "    }\n    named_barrier")],
    "no_wait": [("      mbar_wait(&full[s1], ((i + 1) / STAGES) & 1);\n", "")],
    "stages6": [(STAGES, "constexpr int STAGES = 6;")],
    "stages2": [(STAGES, "constexpr int STAGES = 2;")],
    "prmt": [(PACK, PRMT)],
    "two_blocks": [(STAGES, "constexpr int STAGES = 2;"),
                   ("__launch_bounds__(NT, 1)", "__launch_bounds__(NT, 2)")],
    "bn256": [("constexpr int BN = 128;", "constexpr int BN = 256;"),
              ('static_assert(W_BYTES == 2 * NC * 16, "two 16-byte chunks a '
               'thread");', ""),
              ("  for (int j = 0; j < 2; ++j) {\n    const int g = tid + NC * "
               "j;", "  for (int j = 0; j < W_BYTES / (NC * 16); ++j) {\n    "
               "const int g = tid + NC * j;")],
}
# GPT-3 1.3B's projections at a padded 1000-token prefill and at M 128
SHAPES = [(128, 2048, 2048), (128, 8192, 2048), (1008, 2048, 8192),
          (1008, 2048, 6144), (1008, 2048, 2048), (1008, 8192, 2048)]


def build():
    src = (vh.CSRC / "wo_matmul_wgmma.cu").read_text()
    logs = vh.build(OUT, {name: vh.edited(src, edits, name)
                          for name, edits in VARIANTS.items()})
    libs = {}
    for name, log in logs.items():
        regs = [line.strip() for line in log.splitlines()
                if "registers" in line]
        print(f"[build] {name}: {regs}", flush=True)
        libs[name] = vh.load(OUT / f"{name}.so", {
            "wo_matmul_wgmma": ARGTYPES})["wo_matmul_wgmma"]
    return libs


def main():
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        sys.exit("wo_wgmma_variants: no CUDA device")
    from paddle2_tpu_torch.kernels import quant_matmul as qm
    print(f"[device] {vh.nvidia_smi()}", flush=True)
    libs = build()
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for M, K, N in SHAPES:
        x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
        w8, s8 = qm.quantize_channelwise(
            torch.randn(K, N, generator=gen, device=dev) * 0.02)
        y = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
        ref = qm.int8_weight_only_matmul_reference(x, w8, s8).float()
        for name, fn in libs.items():
            def call(fn=fn, name=name):
                err = fn(x.data_ptr(), w8.data_ptr(), s8.data_ptr(), None,
                         y.data_ptr(), M, K, N, 127.0, stream)
                if err:
                    sys.exit(f"variant {name}: CUDA error {err}")
            call()
            torch.cuda.synchronize()
            err = ((y.float() - ref).abs() / ref.abs().clamp_min(1.0)).max()
            t = vh.event_ms(call)
            print(f"M{M} K{K} N{N} {name}: {t:.4f} ms a launch, scaled err "
                  f"{err.item():.3g}", flush=True)


if __name__ == "__main__":
    main()
