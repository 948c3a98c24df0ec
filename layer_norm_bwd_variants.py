#!/usr/bin/env python3
"""Time variants of the LayerNorm vector backward
(``layer_norm_bwd_vec_kernel``) against the kernel as committed.

    python3 layer_norm_bwd_variants.py

Run from the repository root on a machine with a CUDA GPU and nvcc. It
copies ``paddle2_tpu_torch/kernels/csrc/layer_norm.cu`` into
``build/layer_norm_bwd_variants/`` once a variant, with one textual
change each, builds the copies with nvcc (sm_90a) in parallel, holds each
variant's dx, dγ and dβ against the plain version (and says whether they
equal the committed kernel's), and times the ``layer_norm_bwd`` C entry
at the LayerNorm main path's shapes (``chip_smoke.LN_CASES``: ERNIE's
R4096 H768 with bf16 x and f32 or bf16 γ, f32, f16 x with f32 or f16 γ;
the GPT bench's R8192 H1024 in bf16 and f32): CUDA events around 10
launches, median of 30, in turns (the variants, then backwards), beside
``F.layer_norm``'s backward through autograd and the general route (the
committed entry on copies one element past a 16-byte boundary). For the
committed kernel it also splits the device time (torch.profiler) between
the row kernel and ``layer_norm_bwd_reduce_kernel``. Prints the card's
name and power limit, ptxas's registers and spills for the vector
kernel's instantiations, one line a shape, and writes them to
``chiprun_out/layer_norm_bwd_variants.json``.

- ``committed``: the kernel as committed (at most 2 vectors a lane:
  ERNIE's H 768 and the GPT bench's H 1024 in bf16 two warps a row);
- ``cap4``: at most 4 vectors a lane before a row takes more warps
  (ERNIE's H 768 in bf16: one warp a row, 3 of 4 vectors used);
- ``two_blocks``: ``__launch_bounds__(256, 2)``, so ptxas keeps the
  kernel at 128 registers and two blocks fit an SM;
- ``vpl_exact``: at most 4 vectors a lane, as many as the row needs,
  not rounded up to a power of two (H 768 in bf16: 3 in one warp, where
  ``cap4`` holds registers for 4);
- ``vpl_exact_two_blocks``: both of the last two;
- ``red16``: the reduction of the partials in 16 slices a column group
  (512 threads a block) where the committed kernel has 8;
- ``prefetch``: a slot loads its next row's x and dy before it reduces
  the current one (two rows in flight a slot);
- ``prefetch_cap1``: the same at 1 vector a lane (ERNIE's H 768 in bf16:
  four warps a row).
"""

import ctypes
import json
import re
import sys
from pathlib import Path

import variant_harness as vh

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "layer_norm_bwd_variants"
P, I = ctypes.c_void_p, ctypes.c_int
# x, g, dy, dx, dg, db, ws, R, H, x dtype, g dtype, eps, blocks, stream
ARGTYPES = [P] * 7 + [ctypes.c_longlong, I, I, I, ctypes.c_float, I, P]

CAP = "constexpr int BWD_MAX_VPL = 2;"
BOUNDS = """template <typename XT, typename GT, int VPL>
__global__ void __launch_bounds__(rowvec::VEC_NT)
    layer_norm_bwd_vec_kernel("""
TWO_BLOCKS = (BOUNDS, BOUNDS.replace("(rowvec::VEC_NT)",
                                     "(rowvec::VEC_NT, 2)"))
PLAN = """  rowvec::vec_plan(H / (16 / (int)sizeof(XT)), &wpr, &vpl, BWD_MAX_VPL);
  switch (vpl) {"""
EXACT = (PLAN, """  rowvec::vec_plan(H / (16 / (int)sizeof(XT)), &wpr, &vpl, BWD_MAX_VPL);
  vpl = (H / (16 / (int)sizeof(XT)) + 32 * wpr - 1) / (32 * wpr);
  switch (vpl) {
    case 3:
      return launch_bwd_vec<XT, GT, 3>(x, g, dy, dx, dg, db, ws, R, H, wpr,
                                       eps, G, st);""")
CAP4 = (CAP, "constexpr int BWD_MAX_VPL = 4;")
LOOP = """  for (long long row = (long long)blockIdx.x * rpb + slot; row < R;
       row += (long long)gridDim.x * rpb) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * H);
    const uint4* dr = reinterpret_cast<const uint4*>(dy + row * H);
    uint4 xv[VPL], dv[VPL];
#pragma unroll
    for (int k = 0; k < VPL; ++k)
      if (t + k * T < nv) {
        xv[k] = xr[t + k * T];
        dv[k] = dr[t + k * T];
      }
"""
PREFETCH = (LOOP, """  const long long stride = (long long)gridDim.x * rpb;
  uint4 xn[VPL], dn[VPL];
  {
    const long long row0 = (long long)blockIdx.x * rpb + slot;
    if (row0 < R) {
      const uint4* xr = reinterpret_cast<const uint4*>(x + row0 * H);
      const uint4* dr = reinterpret_cast<const uint4*>(dy + row0 * H);
#pragma unroll
      for (int k = 0; k < VPL; ++k)
        if (t + k * T < nv) {
          xn[k] = xr[t + k * T];
          dn[k] = dr[t + k * T];
        }
    }
  }
  for (long long row = (long long)blockIdx.x * rpb + slot; row < R;
       row += stride) {
    uint4 xv[VPL], dv[VPL];
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      xv[k] = xn[k];
      dv[k] = dn[k];
    }
    if (row + stride < R) {
      const uint4* xr =
          reinterpret_cast<const uint4*>(x + (row + stride) * H);
      const uint4* dr =
          reinterpret_cast<const uint4*>(dy + (row + stride) * H);
#pragma unroll
      for (int k = 0; k < VPL; ++k)
        if (t + k * T < nv) {
          xn[k] = xr[t + k * T];
          dn[k] = dr[t + k * T];
        }
    }
""")
VARIANTS = {
    "committed": [],
    "cap4": [CAP4],
    "two_blocks": [TWO_BLOCKS],
    "vpl_exact": [CAP4, EXACT],
    "vpl_exact_two_blocks": [CAP4, EXACT, TWO_BLOCKS],
    "red16": [("constexpr int RED_SLICES = 8;",
               "constexpr int RED_SLICES = 16;")],
    "prefetch": [PREFETCH],
    "prefetch_cap1": [PREFETCH, (CAP, "constexpr int BWD_MAX_VPL = 1;")],
}
CODE = {"float32": 0, "bfloat16": 1, "float16": 2}


def main():
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.nn import functional as F
    if not torch.cuda.is_available():
        sys.exit("layer_norm_bwd_variants: no CUDA device")
    import chip_smoke as cs
    from paddle2_tpu_torch.kernels import fused_layer_norm as fln
    smi = vh.nvidia_smi()
    print(f"[device] {smi}", flush=True)
    src = (vh.CSRC / "layer_norm.cu").read_text()
    logs = vh.build(OUT, {n: vh.edited(src, e, n)
                          for n, e in VARIANTS.items()})
    regs = {f"{n} {cs.vec_args(k)}": v for n, log in logs.items()
            for k, v in vh.ptxas_lines(
                log, lambda k: "bwd_vec_kernel" in k).items()}
    for name, lines in sorted(regs.items()):
        print(f"[build] {name}: {'; '.join(lines)}", flush=True)
    libs = {n: vh.load(OUT / f"{n}.so", {"layer_norm_bwd": ARGTYPES})[
        "layer_norm_bwd"] for n in VARIANTS}
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for R, H, xdt, gdt, what in cs.LN_CASES:
        x, g, b, dy, eps = cs.ln_inputs(R, H, xdt, gdt, gen, dev)
        xc, gc = CODE[cs.dname(xdt)], CODE[cs.dname(gdt)]
        G = fln.bwd_blocks(R, dev)
        ws = torch.empty(2 * G * H, dtype=torch.float32, device=dev)
        dx_ref, dg_ref, db_ref = fln.layer_norm_bwd_reference(x, g, dy, eps)
        runs, errs, same = {}, {}, {}
        outs = {}
        for name, fn in libs.items():
            dx, dg, db = (torch.empty_like(t) for t in (x, g, g))

            def run(fn=fn, dx=dx, dg=dg, db=db, name=name, xin=x, din=dy):
                err = fn(xin.data_ptr(), g.data_ptr(), din.data_ptr(),
                         dx.data_ptr(), dg.data_ptr(), db.data_ptr(),
                         ws.data_ptr(), R, H, xc, gc, eps, G, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            run()
            torch.cuda.synchronize()
            runs[name], outs[name] = run, (dx, dg, db)
            errs[name] = max(
                cs.ln_err(dx, dx_ref, xdt)[0], cs.ln_err(dg, dg_ref, gdt,
                                                         True)[0],
                cs.ln_err(db, db_ref, gdt, True)[0])
        for name, res in outs.items():
            same[name] = all(torch.equal(a, c) for a, c in
                             zip(res, outs["committed"]))
        # the general route: the committed entry on unaligned copies
        xu, du = cs.unaligned(x), cs.unaligned(dy)
        gdx, gdg, gdb = (torch.empty_like(t) for t in (x, g, g))
        runs["general route"] = (lambda: libs["committed"](
            xu.data_ptr(), g.data_ptr(), du.data_ptr(), gdx.data_ptr(),
            gdg.data_ptr(), gdb.data_ptr(), ws.data_ptr(), R, H, xc, gc,
            eps, G, stream))
        times = vh.in_turns(list(runs), lambda n: vh.event_ms(runs[n]))
        # the committed call's device time by kernel
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                runs["committed"]()
            torch.cuda.synchronize()
        split = {re.search(r"\w+_kernel", e.key).group(0):
                 e.device_time_total / 20 / 1e3
                 for e in prof.key_averages() if e.device_time_total > 0}
        gx, bx = g.to(xdt), b.to(xdt)
        xr, gr, br = (t.detach().clone().requires_grad_()
                      for t in (x, gx, bx))
        out = F.layer_norm(xr, (H,), gr, br, eps)

        def lib_bwd():
            return torch.autograd.grad(out, (xr, gr, br), dy,
                                       retain_graph=True)
        size, gsize = x.element_size(), g.element_size()
        row = dict(shape=f"R{R} H{H} x {cs.dname(xdt)} g {cs.dname(gdt)} "
                   f"({what})", ms=times,
                   committed_device_ms_by_kernel=split,
                   library_ms=vh.event_ms(lib_bwd),
                   library_device_ms=cs.device_ms(lib_bwd, "")[0],
                   excess_over_tol=errs, equal_to_committed=same,
                   bound_ms=(3.0 * R * H * size + 3.0 * H * gsize)
                   / 3.35e12 * 1e3, blocks_cap=G)
        print(json.dumps(row), flush=True)
        rows.append(row)
        bad = [n for n, e in errs.items() if e > 0]
        if bad:
            sys.exit(f"{what}: {bad} past the tolerance")
        del x, dy, ws, outs, runs, xr, gr, br, out
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "layer_norm_bwd_variants.json").write_text(json.dumps(dict(
        nvidia_smi=smi, ptxas=regs, rows=rows)) + "\n")


if __name__ == "__main__":
    main()
