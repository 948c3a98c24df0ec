#!/usr/bin/env python3
"""Time the int8 x int8 kernels' design choices on the card.

    python3 i8i8_variants.py [--only a,b]

Run from the repository root on a machine with a CUDA GPU and nvcc. It
copies ``paddle2_tpu_torch/kernels/csrc/i8i8_matmul.cu`` with one textual
change per variant into ``build/i8i8_variants/``, builds each with nvcc
(sm_90a) in parallel, and calls the C entries (``i8i8_wgmma``, the prefill
kernel; ``i8i8_gemv_mma``, the decode kernel) at GPT-3 1.3B's projections.
Each time is the device time of the kernel alone from torch.profiler (the
mean of 20 launches), warm (one w, which L2 then holds) and cold (copies
of w past L2's 50 MB in turn, as a serving step reads each layer's
weights), beside CUDA events around 10 warm launches (the median of 30,
the host's launch cost included). Variants that drop work give wrong
products on purpose; whether each result equals the plain version is
printed beside its time. Prints the card's name and power limit, ptxas's
registers and spills for each variant, then one line a measurement, each
line also into ``chiprun_out/i8i8_variants.txt``.

- ``base``: the kernels as committed; for the prefill kernel every tile
  width (128, 256) and K split (1, 2, 4, 8 where K has the stages) at M
  32, 144 and 1008, the wrapper's plan marked; for the decode kernel every
  K split at M 1, 8 and 16; both kernels at M 17..64 (the boundary); and
  ``torch._int_mm`` where it takes the shape (M > 16);
- ``no_rewrite``: the consumers skip rewriting w into the K-major tile
  (they still wait for w's stages and release them: the TMA and wgmma
  path alone);
- ``no_mma``: no wgmma is issued (the TMA and rewrite path alone);
- ``no_store``: an unsplit tile writes no y (the epilogue's stores);
- ``stages_less`` / ``stages_more``: one TMA stage fewer in each ring
  (x 3 and w 2 at BN 256, 4 and 3 at 128) / more (7 and 5 at 128; 256 has
  no room for more);
- ``ahead1`` / ``ahead2``: the decode kernel keeps 1 or 2 steps of w in
  flight a thread whatever its n8 tiles (committed: 2 with one tile, 1
  with two); ``ahead3`` / ``ahead4``: 3 or 4 with one tile (4 bounded to
  2 blocks an SM);
- ``lb4``: the decode kernel bounded to 4 blocks an SM (128 registers).
"""

import argparse
import builtins
import ctypes
import sys
from pathlib import Path

import variant_harness as vh

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "i8i8_variants"
LOG = ROOT / "chiprun_out" / "i8i8_variants.txt"
P, I = ctypes.c_void_p, ctypes.c_int
ENTRIES = {"i8i8_wgmma": [P] * 3 + [I] * 5 + [P],
           "i8i8_gemv_mma": [P] * 3 + [I] * 4 + [P]}
REWRITE = """      transpose_tile<BN>(sw + s1 * C::W_BYTES, stk + (i & 1) * C::T_BYTES,
                         wg, wq, lane);
"""
MMA = "        for (int mb = 0; mb < 2; ++mb)\n          wgmma_s8("
XS = "static constexpr int XS = BN == 256 ? 4 : 6;"
WS = "static constexpr int WS = BN == 256 ? 3 : 4;"
AHEAD = "constexpr int AHEAD = NT8 == 1 ? 2 : 1;"
VARIANTS = {
    "base": [],
    "no_rewrite": [(REWRITE, "")],
    "no_mma": [(MMA, "        for (int mb = 0; mb < 0; ++mb)\n"
                     "          wgmma_s8(")],
    "no_store": [("            if (n < N)  // N % 16 == 0: n + 1 < N too",
                  "            if (n < 0)")],
    "stages_less": [(XS, "static constexpr int XS = BN == 256 ? 3 : 4;"),
                    (WS, "static constexpr int WS = BN == 256 ? 2 : 3;")],
    "stages_more": [(XS, "static constexpr int XS = BN == 256 ? 4 : 7;"),
                    (WS, "static constexpr int WS = BN == 256 ? 3 : 5;")],
    "ahead1": [(AHEAD, "constexpr int AHEAD = 1;")],
    "ahead2": [(AHEAD, "constexpr int AHEAD = 2;")],
    "ahead3": [(AHEAD, "constexpr int AHEAD = NT8 == 1 ? 3 : 1;")],
    "ahead4": [(AHEAD, "constexpr int AHEAD = NT8 == 1 ? 4 : 1;"),
               ("__launch_bounds__(GV_NT, 3)", "__launch_bounds__(GV_NT, 2)")],
    "lb4": [("__launch_bounds__(GV_NT, 3)", "__launch_bounds__(GV_NT, 4)")],
}
PREFILL_ONLY = {"no_rewrite", "no_mma", "no_store", "stages_less",
                "stages_more"}
# GPT-3 1.3B's int8 projections, K x N
SHAPES = {"qkv": (2048, 6144), "out_proj": (2048, 2048), "up": (2048, 8192),
          "down": (8192, 2048)}
# copies of w that pass the 50 MB L2, called in turn for a cold read (a
# serving step reads each layer's weights once)
COLD_BYTES = 100 << 20


def print(*args, **kwargs):   # noqa: A001 (every line into the log too)
    builtins.print(*args, **kwargs)
    LOG.parent.mkdir(exist_ok=True)
    with LOG.open("a") as f:
        builtins.print(*args, file=f)


def build(only):
    src = (vh.CSRC / "i8i8_matmul.cu").read_text()
    names = [n for n in VARIANTS if only is None or n in only or n == "base"]
    logs = vh.build(OUT, {n: vh.edited(src, VARIANTS[n], n) for n in names})
    libs = {}
    for name, log in logs.items():
        for kernel, lines in vh.ptxas_lines(
                log, lambda k: "i8i8_" in k).items():
            short = kernel.split("i8i8_")[1].split("Pii")[0]
            print(f"[build] {name} i8i8_{short}: {'; '.join(lines)}",
                  flush=True)
        libs[name] = vh.load(OUT / f"{name}.so", ENTRIES)
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="comma-separated variants besides base")
    args = ap.parse_args()
    only = None if args.only is None else set(args.only.split(","))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        sys.exit("i8i8_variants: no CUDA device")
    from paddle2_tpu_torch.kernels import quant_matmul as qm
    LOG.unlink(missing_ok=True)
    print(f"[device] {vh.nvidia_smi()}", flush=True)
    libs = build(only)
    dev = torch.device("cuda:0")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    def device_ms(fn, n=20):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.device_time_total > 0]
        return sum(e.device_time_total for e in evs) / n / 1e3

    def measure(tag, runs, y, ref):
        warm, cold = runs
        warm()
        torch.cuda.synchronize()
        ok = torch.equal(y, ref)
        dev_t = device_ms(warm)
        ev = vh.event_ms(warm)
        print(f"{tag}: device {dev_t:.4f} ms (cold {device_ms(cold):.4f}), "
              f"events {ev:.4f} ms, equal {ok}", flush=True)
        return dev_t

    def call(fns, entry, x, ws, y, M, K, N, *plan):
        """The entry on w = ws[0] (warm: L2 holds it after a call) and
        on the copies ws in turn (cold: they pass L2's 50 MB)."""
        turn = [0]

        def run(cold):
            if cold:
                turn[0] = (turn[0] + 1) % len(ws)
            err = fns[entry](x.data_ptr(), ws[turn[0] if cold else 0]
                             .data_ptr(), y.data_ptr(), M, K, N, *plan,
                             stream)
            if err:
                sys.exit(f"{entry} {M}x{K}x{N} {plan}: CUDA error {err}")
        return (lambda: run(False)), (lambda: run(True))

    for label, (K, N) in SHAPES.items():
        ws = [torch.randint(-128, 128, (K, N), generator=gen, device=dev,
                            dtype=torch.int8)
              for _ in range(max(2, -(-COLD_BYTES // (K * N))))]
        w = ws[0]
        for M in (1, 8, 16, 17, 24, 32, 48, 64, 144, 1008):
            x = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                              dtype=torch.int8)
            y = torch.empty(M, N, dtype=torch.int32, device=dev)
            ref = qm.int8_matmul_reference(x, w)
            shape = f"{label} M{M} K{K} N{N}"
            bound = max(2.0 * M * N * K / 1979e12,
                        (M * K + K * N + 4.0 * M * N) / 3.35e12) * 1e3
            print(f"{shape}: bound {bound:.4f} ms", flush=True)
            stages = -(-K // 128)
            if M > 16:
                want = (qm.i8i8_tile_n(M, K, N, sms),
                        qm.i8i8_split(M, K, N, sms)[0])
                for name, fns in libs.items():
                    if name != "base" and name not in PREFILL_ONLY:
                        continue
                    for bn, splits in [(b, s) for b in (128, 256)
                                       for s in (1, 2, 4, 8)]:
                        per = -(-stages // splits) * 128
                        plan = (bn, per)
                        if -(-K // per) != splits:
                            continue
                        if name != "base" and (plan != want or M < 144):
                            continue
                        if M < 144 and M not in (32,) and plan != want:
                            continue
                        mark = " (the wrapper's plan)" if plan == want else ""
                        measure(f"{shape} {name} wgmma bn {bn} splits "
                                f"{splits}{mark}",
                                call(fns, "i8i8_wgmma", x, ws, y, M, K, N,
                                     *plan), y, ref)
                mm = lambda: torch._int_mm(x, w)   # noqa: E731
                print(f"{shape} torch._int_mm: device {device_ms(mm):.4f} "
                      f"ms, events {vh.event_ms(mm):.4f} ms", flush=True)
            if M <= 64:
                want = qm.i8i8_mma_split(M, K, N, sms)[0]
                for name, fns in libs.items():
                    if name in PREFILL_ONLY:
                        continue
                    for splits in (1, 2, 4, 8):
                        per = -(-(-(-K // splits)) // 128) * 128
                        if -(-K // per) != splits:
                            continue
                        if (name != "base" or M > 16) and per != want:
                            continue
                        if name != "base" and M not in (8, 16):
                            continue
                        mark = " (the wrapper's plan)" if per == want else ""
                        measure(f"{shape} {name} gemv_mma splits {splits}"
                                f"{mark}",
                                call(fns, "i8i8_gemv_mma", x, ws, y, M, K,
                                     N, per), y, ref)
            del x, y, ref
        del w, ws
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
