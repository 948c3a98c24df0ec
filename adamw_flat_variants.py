#!/usr/bin/env python3
"""Time variants of the flat AdamW's vector kernel
(``adamw_flat_vec_kernel``) to see what bounds it.

    python3 adamw_flat_variants.py [--only a,b]

Run from the repository root on a machine with a CUDA GPU and nvcc. It
copies ``paddle2_tpu_torch/kernels/csrc/adamw_flat.cu`` with one textual
change per variant into ``build/adamw_flat_variants/``, builds each with
nvcc (sm_90a) in parallel, and times the ``adamw_flat_vec`` C entry of
each at the smoke's shape (84 M elements, p and g bf16, and all f32), in
turns: CUDA events around 10 launches, median of 30
(``variant_harness.event_ms``), beside ``torch._fused_adamw_`` over an
f32 master/m/v of the same N. Each variant's four outputs are held
against the base kernel's, bitwise. Prints the card's name and power
limit and ptxas's registers for each variant.

- ``base``: the kernel as committed (U = 2 steps of 8 elements in flight
  a thread, a grid of at most 8 blocks of 256 an SM);
- ``u1`` / ``u4``: 1 / 4 steps in flight a thread;
- ``grid4``: a grid of 4 blocks an SM;
- ``stream``: loads and stores with the streaming cache hints
  (``__ldcs`` / ``__stcs``: the data is touched once).
"""

import argparse
import ctypes
import json
from pathlib import Path

import variant_harness as vh

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "paddle2_tpu_torch" / "kernels" / "csrc" / "adamw_flat.cu"
OUT = ROOT / "build" / "adamw_flat_variants"
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ENTRIES = {"adamw_flat_vec": [P] * 8 + [ctypes.c_longlong] + [I] * 2
           + [F] * 9 + [P]}
N = 84_000_000

VARIANTS = {
    "base": [],
    "u1": [("constexpr int U = 2;", "constexpr int U = 1;")],
    "u4": [("constexpr int U = 2;", "constexpr int U = 4;")],
    "grid4": [("grid_for(VEC ? (n / 8 + U - 1) / U : n, 8)",
               "grid_for(VEC ? (n / 8 + U - 1) / U : n, 4)")],
    "stream": [("    const float4 a = reinterpret_cast<const float4*>(p)[0];\n"
                "    const float4 b = reinterpret_cast<const float4*>(p)[1];",
                "    const float4 a = __ldcs(reinterpret_cast<const float4*>"
                "(p));\n    const float4 b = __ldcs(reinterpret_cast<const "
                "float4*>(p) + 1);"),
               ("    const uint4 u = *reinterpret_cast<const uint4*>(p);",
                "    const uint4 u = __ldcs(reinterpret_cast<const uint4*>"
                "(p));"),
               ("    reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], "
                "x[2], x[3]);\n    reinterpret_cast<float4*>(p)[1] = "
                "make_float4(x[4], x[5], x[6], x[7]);",
                "    __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], "
                "x[1], x[2], x[3]));\n    __stcs(reinterpret_cast<float4*>(p) "
                "+ 1, make_float4(x[4], x[5], x[6], x[7]));"),
               ("    *reinterpret_cast<uint4*>(p) = u;",
                "    __stcs(reinterpret_cast<uint4*>(p), u);")],
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="")
    args = ap.parse_args()
    names = [n for n in VARIANTS
             if not args.only or n in args.only.split(",") or n == "base"]
    import torch
    print(f"[device] {vh.nvidia_smi()}", flush=True)
    src = SRC.read_text()
    logs = vh.build(OUT, {n: vh.edited(src, VARIANTS[n], n) for n in names})
    fns = {}
    for n in names:
        regs = vh.ptxas_lines(logs[n], lambda k: "adamw_flat_vec_kernel" in k)
        print(f"[build] {n}: " + "; ".join(
            v[-1] for k, v in sorted(regs.items()) if "I13__nv_bfloat16S" in k
            or "IffE" in k), flush=True)
        fns[n] = vh.load(OUT / f"{n}.so", ENTRIES)["adamw_flat_vec"]
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    sc = (1e-4, 0.9, 0.1, 0.999, 0.001, 1e-8, 0.01, 0.271, 0.002997)
    out = {}
    for pdt, code in ((torch.bfloat16, 1), (torch.float32, 0)):
        master = torch.randn(N, generator=gen, device=dev)
        g = torch.randn(N, generator=gen, device=dev).to(pdt)
        m = torch.randn(N, generator=gen, device=dev) * 0.1
        v = torch.rand(N, generator=gen, device=dev) * 0.01
        outs = {n: (torch.empty(N, dtype=pdt, device=dev),
                    *(torch.empty(N, device=dev) for _ in range(3)))
                for n in names}
        stream = torch.cuda.current_stream().cuda_stream

        def call(n):
            err = fns[n](g.data_ptr(), m.data_ptr(), v.data_ptr(),
                         master.data_ptr(), *(t.data_ptr() for t in outs[n]),
                         N, code, code, *sc, stream)
            assert err == 0, (n, err)
        for n in names:
            call(n)
        torch.cuda.synchronize()
        same = {n: all(torch.equal(a, b) for a, b in zip(outs[n],
                                                         outs["base"]))
                for n in names}
        times = vh.in_turns(names, lambda n: vh.event_ms(lambda: call(n)))
        lp, lg, lm, lv = (t.float().clone() for t in (master, g, m, v))
        steps = [torch.tensor(3.0, device=dev)]
        lib = vh.event_ms(lambda: torch._fused_adamw_(
            [lp], [lg], [lm], [lv], [], steps, lr=1e-4, beta1=0.9,
            beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False,
            maximize=False))
        key = str(pdt)[6:]
        out[key] = dict({n: dict(ms=times[n], bitwise=same[n])
                         for n in names}, library_ms=lib)
        print(f"[{key}] " + "  ".join(
            f"{n} {min(times[n]):.4f}-{max(times[n]):.4f} (bitwise "
            f"{same[n]})" for n in names) + f"  torch._fused_adamw_ "
            f"{lib:.4f}", flush=True)
        del master, g, m, v, outs, lp, lg, lm, lv
        torch.cuda.empty_cache()
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/adamw_flat_variants.json").write_text(
        json.dumps(dict(device=vh.nvidia_smi(), results=out), indent=1))


if __name__ == "__main__":
    main()
