#!/usr/bin/env python3
"""Time variants of the f32 flash forward (``flash_fwd_tf32x3.cu``:
``flash_fwd_tf32x3_kernel``) against the kernel as committed.

    python3 flash_fwd_tf32x3_variants.py [--only NAME,NAME]

Run from the repository root on a machine with a CUDA GPU and nvcc. It
copies ``paddle2_tpu_torch/kernels/csrc/flash_fwd_tf32x3.cu``, with the
shared header ``tf32x3.cuh`` inlined, into
``build/flash_fwd_tf32x3_variants/`` once a variant, with textual edits
each, builds the copies with nvcc (sm_90a) in parallel, holds each
variant's o and lse against the plain forward (``flash_fwd_reference``,
f32) at the smoke's timed shapes and at Sq 200 / Sk 333 (D 16/64/128,
causal and not) to the smoke's f32 limit (1e-4), and times the C entry
at the smoke's f32 shapes (B1 H16 S 128/1024/2048 D128 and B8 H16 S1024
D64, causal): CUDA events around 10 launches, median of 15, in turns
(committed, the variants, the variants backwards, committed). Prints the
card's name and power limit, ptxas's registers and spills, one line a
variant, and writes them to ``chiprun_out/flash_fwd_tf32x3_variants.json``.

The edits (a variant is a set of them):

- ``bk16_d128``: 16-key steps at D 128 (K and V tiles half as large:
  67.6 KB of shared memory a block, three blocks an SM instead of two);
- ``bk64``: 64-key steps at D 16 and 64 (twice the n-tiles a Q fragment
  serves, one barrier pair per 64 keys);
- ``mt1``: one m16 row tile a warp at every head dim (64-row blocks, so
  twice the blocks at D 16 and 64).
"""

import argparse
import json
import sys
from pathlib import Path

import variant_harness as vh

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "flash_fwd_tf32x3_variants"

BKT = "constexpr int BKT = 32;   // keys a step\n"
MT = "constexpr int MT = D == 128 ? 1 : 2;"
# a key step that depends on the head dim makes BKT a template variable
BKT_D = "template <int D>\nconstexpr int BKT = D == 128 ? {} : {};\n"
USES = [("BK = BKT,", "BK = BKT<D>,"), ("4 * BKT *", "4 * BKT<D> *")]
EDITS = {
    "bk16_d128": [(BKT, BKT_D.format(16, 32)), *USES],
    "bk64": [(BKT, BKT_D.format(32, 64)), *USES],
    "mt1": [(MT, "constexpr int MT = 1;")],
}
VARIANTS = {
    "committed": [],
    "bk16_d128": ["bk16_d128"],
    "bk64": ["bk64"],
    "mt1": ["mt1"],
    "mt1_bk64": ["mt1", "bk64"],
}
TIMED = [(1, 128, 128), (1, 1024, 128), (1, 2048, 128), (8, 1024, 64)]


def build(names):
    src = (vh.CSRC / "flash_fwd_tf32x3.cu").read_text().replace(
        '#include "tf32x3.cuh"', (vh.CSRC / "tf32x3.cuh").read_text())
    logs = vh.build(OUT, {
        name: vh.edited(src, [e for edit in VARIANTS[name]
                              for e in EDITS[edit]], name)
        for name in names})
    return {name: vh.ptxas_lines(log) for name, log in logs.items()}


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
        sys.exit("flash_fwd_tf32x3_variants: no CUDA device")
    from paddle2_tpu_torch.kernels import flash_attn as fa
    smi = vh.nvidia_smi()
    print(f"[device] {smi}", flush=True)
    ptxas = build(names)
    libs = {name: vh.load(OUT / f"{name}.so",
                          fa._LIBRARIES["flash_fwd_tf32x3"])
            for name in names}
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(lib, q, k, v, causal):
        B, H, Sq, D = q.shape
        o, lse = torch.empty_like(q), q.new_empty((B, H, Sq))
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), B, H, Sq, k.shape[2], D, 0, D ** -0.5,
                int(causal), stream]
        return (lambda: lib["flash_fwd_tf32x3"](*args)), (o, lse)

    errs = {n: {} for n in names}
    cases = [(B, 16, S, S, D, True) for B, S, D in TIMED] + [
        (2, 4, 200, 333, D, c) for D in (16, 64, 128) for c in (True, False)]
    for B, H, Sq, Sk, D, causal in cases:
        q = torch.randn(B, H, Sq, D, generator=gen, device=dev)
        k, v = (torch.randn(B, H, Sk, D, generator=gen, device=dev)
                for _ in range(2))
        ref = fa.flash_fwd_reference(q, k, v, D ** -0.5, causal)
        for name in names:
            run, outs = call(libs[name], q, k, v, causal)
            assert run() == 0, name
            torch.cuda.synchronize()
            e = max((g - r).abs().max().item() for g, r in zip(outs, ref))
            errs[name][f"B{B} H{H} Sq{Sq} Sk{Sk} D{D} causal={causal}"] = e
            if not e <= 1e-4:
                raise SystemExit(f"{name}: err {e} at {Sq}/{Sk} D{D}")
        del q, k, v, ref
        torch.cuda.empty_cache()

    rows = {n: dict(variant=n, edits=VARIANTS[n], ms={},
                    max_err=max(errs[n].values()), ptxas=ptxas[n])
            for n in names}
    for B, S, D in TIMED:
        q, k, v = (torch.randn(B, 16, S, D, generator=gen, device=dev)
                   for _ in range(3))
        runs = {n: call(libs[n], q, k, v, True)[0] for n in names}
        turns = vh.in_turns(names, lambda n: vh.event_ms(runs[n], iters=15))
        for n in names:
            rows[n]["ms"][f"B{B} H16 S{S} D{D} causal"] = turns[n]
        del q, k, v
    for n in names:
        print(json.dumps(rows[n]), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "flash_fwd_tf32x3_variants.json").write_text(json.dumps(
        dict(nvidia_smi=smi, kind=torch.cuda.get_device_name(0), errs=errs,
             variants=list(rows.values())), indent=1))


if __name__ == "__main__":
    main()
