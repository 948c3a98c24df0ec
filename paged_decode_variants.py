#!/usr/bin/env python3
"""Time variants of the cluster paged decode kernel
(``paged_decode_cluster_kernel``) to see what bounds it.

    python3 paged_decode_variants.py [--only a,b]

Run from the repository root on a machine with a CUDA GPU and nvcc. It
copies ``paddle2_tpu_torch/serving/csrc/paged_decode.cu`` with one
textual change per variant into ``build/paged_decode_variants/``, builds
each with nvcc (sm_90a) in parallel, and times the ``paged_decode`` C
and ``paged_decode_split`` (8 pages a split) entries of each, in turns,
at the smoke's shapes (H16
D128 bs16, bf16 and f32: B8 with contexts 2048..17, B8 all 2048, B1
2048, B8 contexts 1..17): CUDA events around 10 launches, median of 30
(``variant_harness.event_ms``). Each variant's output is held against
the base kernel's (its largest difference is printed; the probes that
drop work differ on purpose). Prints the card's name and power limit and
ptxas's registers for each variant.

- ``base``: the kernel as committed (clusters of up to 16 blocks of at
  least 128 keys, a ring of 2 tiles of 8 KB, 128 threads);
- ``s3``: 3 tiles of 8 KB; ``t16k``: 2 of 16 KB; ``t4k_s4`` / ``_s8`` /
  ``_s16``: 4 / 8 / 16 of 4 KB; ``t2k_s4``: 4 of 2 KB;
- ``c8``: clusters of at most 8 blocks;
- ``no_exit``: the blocks past the context stay and join the cluster's
  barriers with (-inf, 0, 0) instead of exiting;
- ``attr1``: a launch whose cluster is one block sets the cluster
  attribute all the same;
- ``no_kv`` (probe): no tile is copied or used (the launch, the page
  ids, the context lengths and the cluster's barriers alone).
"""

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np

import variant_harness as vh

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "paddle2_tpu_torch" / "serving" / "csrc" / "paged_decode.cu"
OUT = ROOT / "build" / "paged_decode_variants"
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ENTRIES = {"paged_decode": [P] * 6 + [I] * 6 + [F, P],
           "paged_decode_split": [P] * 8 + [I] * 8 + [F, P]}
PPS = 8

VARIANTS = {
    "base": [],
    "s3": [("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
    "t16k": [("constexpr int TILE_BYTES = 8192;", "constexpr int TILE_BYTES = 16384;")],
    "t4k_s4": [("constexpr int TILE_BYTES = 8192;", "constexpr int TILE_BYTES = 4096;"), ("constexpr int STAGES = 2;", "constexpr int STAGES = 4;")],
    "t4k_s8": [("constexpr int TILE_BYTES = 8192;", "constexpr int TILE_BYTES = 4096;"), ("constexpr int STAGES = 2;", "constexpr int STAGES = 8;")],
    "t4k_s16": [("constexpr int TILE_BYTES = 8192;", "constexpr int TILE_BYTES = 4096;"), ("constexpr int STAGES = 2;", "constexpr int STAGES = 16;")],
    "t2k_s4": [("constexpr int TILE_BYTES = 8192;", "constexpr int TILE_BYTES = 2048;"), ("constexpr int STAGES = 2;", "constexpr int STAGES = 4;")],
    "c8": [("constexpr int MAX_CLUSTER = 16;",
            "constexpr int MAX_CLUSTER = 8;")],
    "no_exit": [("  const int CL = max(1, min(C, (live_pages + chunk_pages - 1) "
                 "/ chunk_pages));\n  if (r >= CL) return;",
                 "  const int CL = C + 0 * live_pages;")],
    "attr1": [("  cfg.numAttrs = pl.cluster > 1;", "  cfg.numAttrs = 1;")],
    "no_kv": [("  const int nk = (n + TK - 1) / TK;", "  const int nk = 0;")],
}
CTX = [2048, 1900, 1500, 1024, 700, 333, 129, 17]
SHAPES = {"main": CTX, "B8 all 2048": [2048] * 8, "B1 2048": [2048],
          "B8 short": [1, 2, 3, 5, 8, 13, 16, 17]}


def inputs(torch, ctx, dtype, seed=0, H=16, D=128, bs=16):
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    ctx = np.asarray(ctx, np.int32)
    pages = -(-ctx // bs)
    nb = int(pages.sum()) + 1
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((len(ctx), int(pages.max())), np.int32)
    used = 0
    for b in range(len(ctx)):
        tables[b, :pages[b]] = perm[used:used + pages[b]]
        used += pages[b]
    kp = torch.randn(nb, bs, H, D, generator=gen, device=dev).to(dtype)
    vp = torch.randn(nb, bs, H, D, generator=gen, device=dev).to(dtype)
    q = torch.randn(len(ctx), 1, H, D, generator=gen, device=dev).to(dtype)
    return (q, kp, vp, torch.as_tensor(tables, device=dev),
            torch.as_tensor(ctx, device=dev))


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
    libs = {}
    for n in names:
        regs = vh.ptxas_lines(logs[n],
                              lambda k: "paged_decode_cluster_kernel" in k)
        print(f"[build] {n}: " + "; ".join(
            f"{k[-40:]}: {v[-1]}" for k, v in sorted(regs.items())
            if "Lb0E" in k and "Li128E" in k), flush=True)
        libs[n] = vh.load(OUT / f"{n}.so", ENTRIES)
    out = {}
    for dtype, code in ((torch.bfloat16, 1), (torch.float32, 0)):
        for label, ctx in SHAPES.items():
            q, kp, vp, tables, ctxs = inputs(torch, ctx, dtype)
            B, _, H, D = q.shape
            stream = torch.cuda.current_stream().cuda_stream
            P = tables.shape[1]
            ns = -(-P // PPS)
            outs = {n: (torch.empty_like(q),
                        torch.empty(B, H, ns, D, device=q.device),
                        torch.empty(B, H, ns, device=q.device),
                        torch.empty(B, H, ns, device=q.device))
                    for n in names}
            head = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                    tables.data_ptr(), ctxs.data_ptr())

            def call(n, split):
                o = outs[n]
                if split:
                    err = libs[n]["paged_decode_split"](
                        *head, o[1].data_ptr(), o[2].data_ptr(),
                        o[3].data_ptr(), B, H, D, 16, P, PPS, ns, code,
                        D ** -0.5, stream)
                else:
                    err = libs[n]["paged_decode"](
                        *head, o[0].data_ptr(), B, H, D, 16, P, code,
                        D ** -0.5, stream)
                if err:
                    sys.exit(f"{n}: CUDA error {err}")
            for n in names:
                call(n, False)
                call(n, True)
            torch.cuda.synchronize()
            diff = {n: max((a.float() - b.float()).nan_to_num(
                0, 0, 0).abs().max().item()
                for a, b in zip(outs[n], outs["base"])) for n in names}
            for split in (False, True):
                times = vh.in_turns(names, lambda n: vh.event_ms(
                    lambda: call(n, split)))
                key = (f"{label} {str(dtype)[6:]} "
                       f"{'split pps8' if split else 'global'}")
                out[key] = {n: dict(ms=times[n], diff=diff[n])
                            for n in names}
                print(f"[{key}] " + "  ".join(
                    f"{n} {min(times[n]):.4f}-{max(times[n]):.4f} "
                    f"(diff {diff[n]:.2g})" for n in names), flush=True)
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/paged_decode_variants.json").write_text(
        json.dumps(dict(device=vh.nvidia_smi(), results=out), indent=1))


if __name__ == "__main__":
    main()
