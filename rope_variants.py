#!/usr/bin/env python3
"""Time variants of RoPE's vector kernel (``rope_vec_kernel``) against
the kernel as committed.

    python3 rope_variants.py

Run from the repository root on a machine with a CUDA GPU and nvcc. It
copies ``paddle2_tpu_torch/kernels/csrc/rope.cu`` into
``build/rope_variants/`` once a variant, with one textual change each,
builds the copies with nvcc (sm_90a) in parallel, holds each variant's
output bitwise against the plain version, forward and backward, and
times the ``rope`` C entry at the incubate stack's shape (B8 S2048 H16
D128: bf16 with an [S, D] table and with a ``position_ids``-gathered
[B*S, D] one, and f32 with an [S, D] table): CUDA events around 10
launches, median of 30, in turns (the variants, then backwards), beside
the general route (the committed entry on a copy of x one element past a
16-byte boundary) and the bound. Prints the card's name and power limit,
ptxas's registers and spills for the vector kernel's instantiations,
one line a shape, and writes them to ``chiprun_out/rope_variants.json``.

- ``committed``: the kernel as committed (a lane loads 4 pairs of x
  chunks before it computes the first; a warp a row, a block every 8
  rows);
- ``pairs2`` / ``pairs8``: 2 / 8 pairs a lane in flight (heads a lane
  at a time: 2 / 8 at D 128 in bf16);
- ``three_blocks``: ``__launch_bounds__(256, 3)``, so ptxas keeps the
  kernel at 85 registers and three blocks fit an SM;
- ``persistent``: a persistent grid (the blocks that stay resident on
  every SM), its warps walking the rows with a grid stride.
"""

import ctypes
import json
import sys
from pathlib import Path

import variant_harness as vh

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "rope_variants"
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# x, cos, sin, o, rows, H, D, table rows, x dtype, table dtype, negate sin,
# stream
ARGTYPES = [P] * 4 + [L, I, I, L, I, I, I, P]

PAIRS = "constexpr int VEC_PAIRS = 4;"
BOUNDS = """template <typename XT, typename CT, bool NEG>
__global__ void __launch_bounds__(rowvec::VEC_NT)
    rope_vec_kernel("""
GRID = """  const int blocks = (int)(want < 0x7fffffffLL ? want : 0x7fffffffLL);
  rope_vec_kernel<XT, CT, NEG><<<blocks, rowvec::VEC_NT, 0, st>>>("""
PERSISTENT = """  static rowvec::GridCache cache;
  int blocks = 0;
  const cudaError_t err = rowvec::persistent_blocks(
      rope_vec_kernel<XT, CT, NEG>, cache, 0, 0, want, &blocks);
  if (err != cudaSuccess) return err;
  rope_vec_kernel<XT, CT, NEG><<<blocks, rowvec::VEC_NT, 0, st>>>("""
VARIANTS = {
    "committed": [],
    "pairs2": [(PAIRS, "constexpr int VEC_PAIRS = 2;")],
    "pairs8": [(PAIRS, "constexpr int VEC_PAIRS = 8;")],
    "three_blocks": [(BOUNDS, BOUNDS.replace("(rowvec::VEC_NT)",
                                            "(rowvec::VEC_NT, 3)"))],
    "persistent": [(GRID, PERSISTENT)],
}
# B, S, H, D, table, x dtype
SHAPES = [(8, 2048, 16, 128, "S", "bfloat16"),
          (8, 2048, 16, 128, "pos", "bfloat16"),
          (8, 2048, 16, 128, "S", "float32")]
CODE = {"float32": 0, "bfloat16": 1}


def main():
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        sys.exit("rope_variants: no CUDA device")
    import chip_smoke as cs
    from paddle2_tpu_torch.incubate.nn import functional as IF
    from paddle2_tpu_torch.kernels.fused_rope import rope_reference
    smi = vh.nvidia_smi()
    print(f"[device] {smi}", flush=True)
    src = (vh.CSRC / "rope.cu").read_text()
    logs = vh.build(OUT, {n: vh.edited(src, e, n)
                          for n, e in VARIANTS.items()})
    regs = {f"{n} {cs.decode_instance(k)}": v for n, log in logs.items()
            for k, v in vh.ptxas_lines(
                log, lambda k: "rope_vec_kernel" in k).items()}
    for name, lines in sorted(regs.items()):
        print(f"[build] {name}: {'; '.join(lines)}", flush=True)
    libs = {n: vh.load(OUT / f"{n}.so", {"rope": ARGTYPES})["rope"]
            for n in VARIANTS}
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for B, S, H, D, table, dt in SHAPES:
        dtype = getattr(torch, dt)
        x = torch.randn(B, S, H, D, generator=gen, device=dev).to(dtype)
        cos, sin = IF._angle_table(S, D, 10000.0, False, dtype, dev)
        if table == "pos":
            pos = torch.randint(0, S, (B, S), generator=gen, device=dev)
            cos, sin = (t[pos].reshape(B * S, D) for t in (cos, sin))
        T = cos.shape[0]
        runs, bitwise = {}, {}
        for name, fn in libs.items():
            o = torch.empty_like(x)

            def run(fn=fn, o=o, name=name, neg=0, xin=x):
                err = fn(xin.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                         o.data_ptr(), B * S, H, D, T, CODE[dt], CODE[dt],
                         neg, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
                return o
            bitwise[name] = all(
                torch.equal(run(neg=neg).clone(),
                            rope_reference(x, cos, sin, bool(neg)))
                for neg in (0, 1))
            runs[name] = run
        xu = cs.unaligned(x)
        runs["general route"] = (lambda: runs["committed"](xin=xu))
        times = vh.in_turns(list(runs), lambda n: vh.event_ms(runs[n]))
        n = x.numel()
        row = dict(shape=f"B{B} S{S} H{H} D{D} {dt}, "
                   f"{'[S, D]' if table == 'S' else '[B*S, D]'} table",
                   ms=times, bitwise=bitwise,
                   device_ms={k: cs.device_ms(runs[k], "rope")[1]
                              for k in ("committed", "general route")},
                   bound_ms=(2.0 * n * x.element_size()
                             + 2.0 * T * D * cos.element_size())
                   / 3.35e12 * 1e3)
        print(json.dumps(row), flush=True)
        rows.append(row)
        if not all(bitwise.values()):
            sys.exit(f"{row['shape']}: not bitwise {bitwise}")
        del x, xu, runs, cos, sin
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "rope_variants.json").write_text(json.dumps(dict(
        nvidia_smi=smi, ptxas=regs, rows=rows)) + "\n")


if __name__ == "__main__":
    main()
