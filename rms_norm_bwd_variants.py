#!/usr/bin/env python3
"""Time variants of the RMSNorm vector backward (``rms_norm_bwd_vec_kernel``)
against the kernel as committed.

    python3 rms_norm_bwd_variants.py

Run from the repository root on a machine with a CUDA GPU and nvcc. It
copies ``paddle2_tpu_torch/kernels/csrc/rms_norm.cu`` into
``build/rms_norm_bwd_variants/`` once a variant, with one textual change
each, builds the copies with nvcc (sm_90a) in parallel, holds each
variant's dx and dw against the committed kernel's and the plain
version's, and times the ``rms_norm_bwd`` C entry at the RMSNorm main
path's shapes (the incubate stack's R16384 H2048 and the
``fused_rms_norm`` docstring's R8192 H1024, bf16 x and w; the stack's in
f32): CUDA events around 10 launches, median of 30, in turns
(committed, the variants, the variants backwards, committed), beside
``F.rms_norm``'s backward through autograd and the general route (the
same entry on copies one element past a 16-byte boundary). Prints the
card's name and power limit, ptxas's registers and spills for the
kernels the shapes run, one line a shape, and writes them to
``chiprun_out/rms_norm_bwd_variants.json``.

- ``committed``: the kernel as committed (its blocks' dw partials added
  by ``rms_norm_bwd_reduce_kernel``, a second launch);
- ``fold``: the partials added in the same launch: a cooperative launch
  (every block resident), the blocks meeting at a grid-wide barrier,
  then block b adding the 32-column groups b, b + G, ... in the
  reduction kernel's order (the same sums: dx and dw equal to the
  committed kernel's);
- ``vpl8`` / ``vpl16``: at most 8 / 16 vectors a lane before a row
  takes more warps (R16384 H2048 bf16: one warp a row with 8 vectors a
  lane, where the committed 4 take two warps);
- ``two_blocks``: ``__launch_bounds__(256, 2)``, so ptxas keeps the
  kernel at 128 registers and two blocks fit an SM.
"""

import ctypes
import json
import sys
from pathlib import Path

import variant_harness as vh

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "rms_norm_bwd_variants"
P, I = ctypes.c_void_p, ctypes.c_int
# x, w, r, do, dx, dw, ws, R, H, x dtype, w dtype, blocks, stream
ARGTYPES = [P] * 7 + [ctypes.c_longlong, I, I, I, I, P]

INCLUDE = "#include <cuda_bf16.h>\n#include <cuda_fp16.h>"
SIGNATURE = """                            float* __restrict__ ws, long long R, int H,
                            int wpr) {"""
TAIL = """    wg[i] = reinterpret_cast<const float4*>(dwb)[i];
}"""
FOLD = """    wg[i] = reinterpret_cast<const float4*>(dwb)[i];
  // every block's partials written, then the column groups added, read
  // through L2: other blocks of this launch wrote them
  __shared__ float pw[RED_SLICES][RED_COLS];
  __threadfence();
  cooperative_groups::this_grid().sync();
  for (int grp = blockIdx.x; grp * RED_COLS < H; grp += gridDim.x) {
    const int c = threadIdx.x % RED_COLS, sl = threadIdx.x / RED_COLS;
    const int i = grp * RED_COLS + c;
    float a = 0.f;
    if (i < H)
      for (int k = sl; k < (int)gridDim.x; k += RED_SLICES)
        a += __ldcg(&ws[(long long)k * H + i]);
    pw[sl][c] = a;
    __syncthreads();
    if (sl == 0 && i < H) {
      float t = 0.f;
      for (int k = 0; k < RED_SLICES; ++k) t += pw[k][c];
      dw[i] = from_f<WT>(t);
    }
    __syncthreads();
  }
}"""
LAUNCH = """  kernel<<<blocks, rowvec::VEC_NT, smem, st>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(w),
      static_cast<const float*>(r), static_cast<const XT*>(dout),
      static_cast<XT*>(dx), static_cast<float*>(ws), R, H, wpr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rms_norm_bwd_reduce_kernel<WT>
      <<<(H + RED_COLS - 1) / RED_COLS, RED_COLS * RED_SLICES, 0, st>>>(
          static_cast<const float*>(ws), static_cast<WT*>(dw), blocks, H);
  return cudaGetLastError();"""
COOPERATIVE = """  const XT* xp = static_cast<const XT*>(x);
  const WT* wp = static_cast<const WT*>(w);
  const float* rp = static_cast<const float*>(r);
  const XT* dop = static_cast<const XT*>(dout);
  XT* dxp = static_cast<XT*>(dx);
  WT* dwp = static_cast<WT*>(dw);
  float* wsp = static_cast<float*>(ws);
  void* args[] = {&xp, &wp, &rp, &dop, &dxp, &dwp, &wsp, &R, &H, &wpr};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(blocks), dim3(rowvec::VEC_NT), args,
                                    smem, st);
  return err != cudaSuccess ? err : cudaGetLastError();"""
VPL = "constexpr int BWD_MAX_VPL = 4;"
BOUNDS = """template <typename XT, typename WT, int VPL>
__global__ void __launch_bounds__(rowvec::VEC_NT)
    rms_norm_bwd_vec_kernel("""
VARIANTS = {
    "committed": [],
    "fold": [(INCLUDE, "#include <cooperative_groups.h>\n" + INCLUDE),
             (SIGNATURE, "                            WT* __restrict__ dw,\n"
                         + SIGNATURE), (TAIL, FOLD), (LAUNCH, COOPERATIVE)],
    "vpl8": [(VPL, "constexpr int BWD_MAX_VPL = 8;")],
    "vpl16": [(VPL, "constexpr int BWD_MAX_VPL = 16;")],
    "two_blocks": [(BOUNDS, BOUNDS.replace("(rowvec::VEC_NT)",
                                          "(rowvec::VEC_NT, 2)"))],
}
# rows, H, x dtype code, w dtype code (0 f32, 1 bf16), what
SHAPES = [(16384, 2048, 1, 1, "stack"), (8192, 1024, 1, 1, "docstring"),
          (16384, 2048, 0, 0, "stack f32")]


def main():
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.nn import functional as F
    if not torch.cuda.is_available():
        sys.exit("rms_norm_bwd_variants: no CUDA device")
    from paddle2_tpu_torch.kernels import fused_rms_norm as frn
    smi = vh.nvidia_smi()
    print(f"[device] {smi}", flush=True)
    src = (vh.CSRC / "rms_norm.cu").read_text()
    logs = vh.build(OUT, {n: vh.edited(src, e, n)
                          for n, e in VARIANTS.items()})
    # the instantiations the shapes run: bf16 x and w at 4 vectors a lane
    # (8 in the vpl variants), f32 at 4 (8 and 16)
    keep = ("bwd_vec_kernelI13__nv_bfloat16S0_Li", "bwd_vec_kernelIffLi")
    regs = {f"{n} {k}": v for n, log in logs.items()
            for k, v in vh.ptxas_lines(
                log, lambda k: any(s in k for s in keep)).items()}
    for name, lines in regs.items():
        print(f"[build] {name}: {'; '.join(lines)}", flush=True)
    libs = {n: vh.load(OUT / f"{n}.so", {"rms_norm_bwd": ARGTYPES})[
        "rms_norm_bwd"] for n in VARIANTS}
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for R, H, xc, wc, what in SHAPES:
        xdt = torch.bfloat16 if xc else torch.float32
        wdt = torch.bfloat16 if wc else torch.float32
        x = (torch.randn(R, H, generator=gen, device=dev) * 2 + 0.5).to(xdt)
        w = torch.randn(H, generator=gen, device=dev).to(wdt)
        do = torch.randn(R, H, generator=gen, device=dev).to(xdt)
        _, r = frn.rms_norm_fwd_reference(x, w, 1e-6)
        G = frn.bwd_blocks(R, dev)
        ws = torch.empty(G * H, dtype=torch.float32, device=dev)
        runs, outs = {}, {}
        for name, fn in libs.items():
            dx, dw = torch.empty_like(x), torch.empty_like(w)

            def run(fn=fn, dx=dx, dw=dw, name=name, x=x, do=do):
                err = fn(x.data_ptr(), w.data_ptr(), r.data_ptr(),
                         do.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                         ws.data_ptr(), R, H, xc, wc, G, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            run()
            torch.cuda.synchronize()
            runs[name], outs[name] = run, (dx, dw)
        # the general route: the committed entry on unaligned copies
        xu, du = (unaligned(torch, t) for t in (x, do))
        runs["general route"] = (lambda xu=xu, du=du: libs["committed"](
            xu.data_ptr(), w.data_ptr(), r.data_ptr(), du.data_ptr(),
            torch.empty_like(x).data_ptr(), torch.empty_like(w).data_ptr(),
            ws.data_ptr(), R, H, xc, wc, G, stream))
        dx0, dw0 = outs["committed"]
        dx_ref, dw_ref = frn.rms_norm_bwd_reference(x, w, r, do)
        vs_committed = {n: dict(dx_equal=torch.equal(a, dx0),
                                dw_max_diff=(b.float() - dw0.float()).abs()
                                .max().item())
                        for n, (a, b) in outs.items()}
        times = vh.in_turns(list(runs), lambda n: vh.event_ms(runs[n]))
        xr = x.detach().clone().requires_grad_()
        wr = w.to(xdt).detach().clone().requires_grad_()
        out = F.rms_norm(xr, (H,), wr, 1e-6)
        lib_ms = vh.event_ms(lambda: torch.autograd.grad(
            out, (xr, wr), do, retain_graph=True))
        size, wsize = x.element_size(), w.element_size()
        row = dict(shape=f"R{R} H{H} ({what})", ms=times,
                   library_ms=lib_ms, vs_committed=vs_committed,
                   dx_err_vs_plain=(dx0.float() - dx_ref.float()).abs()
                   .max().item(),
                   dw_err_vs_plain=(dw0.float() - dw_ref.float()).abs()
                   .max().item(),
                   bound_ms=(3.0 * R * H * size + 2.0 * H * wsize + 4.0 * R)
                   / 3.35e12 * 1e3, blocks_cap=G)
        print(json.dumps(row), flush=True)
        rows.append(row)
        if not vs_committed["fold"]["dx_equal"] or \
                vs_committed["fold"]["dw_max_diff"] != 0.0:
            sys.exit(f"{what}: fold differs from the committed kernel")
        del x, do, ws, outs, runs, xr, wr, out
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "rms_norm_bwd_variants.json").write_text(json.dumps(dict(
        nvidia_smi=smi, ptxas=regs, rows=rows)) + "\n")


def unaligned(torch, t):
    """A contiguous copy of ``t`` one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


if __name__ == "__main__":
    main()
