#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle2_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA GPU, nvcc
(``$CUDA_HOME`` or ``/usr/local/cuda``) and PyTorch built for CUDA.
Phases, each of which fails the run (non-zero exit, no final ``ok``
line) when it fails:

1. Device: the card's name and power limit.
2. Build: every kernel under ``paddle2_tpu_torch/**/csrc`` with nvcc,
   in parallel, from the sources in the checkout.
3. Kernels against their plain versions, on the card, at the main
   path's shapes: the flash forward (B1 H16 D128, S 128/1024/2048,
   causal), the paged decode and the split-K paged decode (B8 H16
   D128, block 16, contexts up to 2048), in bf16 and f32. Each prints
   its error against its tolerance, its median time from CUDA events,
   its device time from torch.profiler (all kernels of the call, and
   the port's kernel alone), the plain version's time, one library
   call's time where one computes the same function, its bound, and
   its launches.
   The flash backward (both routes: the fused kernel and the split
   dK/dV + dQ pair) at the training path's shape (B8 H16 S1024 D64,
   causal) in bf16 and f32, and ragged ``Sq < Sk`` cases at head dims
   16/64/128, with a bf16 limit that the plain backward without its
   P/dS rounding must exceed; the fused AdamW step against the port's
   eager AdamW, bitwise (``torch.equal``), three steps on the training
   path's 16 parameter leaves (f32, and bf16 with f32 masters), and
   one step over the 16 f32 leaves timed against
   ``torch._fused_adamw_``.
4. The engine at full width: GPT-3 1.3B (24 layers kept) from a fixed
   seed serves 8 requests (prompts of 17..1000 tokens, 32 new tokens
   each) in f32, with the global-softmax decode and with split-K
   (``split_pages=8``), and in bf16. Tokens are held against the
   port's dense greedy ``generate`` (contiguous cache, no paged
   kernel); a mismatch fails unless the dense path's top-2 logit margin
   at that step is below 1e-3 in f32, or 0.0625 (4 bf16 rounding steps
   at the logits' magnitude) in bf16 (a near tie, counted). One decode
   step of each run is traced with torch.profiler for its device time. Two short prompts'
   first-token logits are held against the same model on the CPU (the
   plain path) at atol 1e-3. Every serving kernel's launch count must
   rise during the engine runs.
5. Training at full width and full depth: ``bench.py``'s default GPT
   (vocab 32768, hidden 1024, 24 layers, 16 heads of 64, seq 1024,
   batch 8, labels = ids) with "dots" remat, stacked blocks, the fused
   head loss, AMP O2 bf16 and ``AdamW(1e-4, multi_precision=True,
   fused=True)`` through ``jit.train_step``: 1 warm-up step, 5 timed
   steps and 1 traced step. Every loss must be finite and the 5th timed
   loss below the 1st; each step must launch ``flash_fwd`` exactly 24
   times, the bf16 backward route's kernels 24 times each and
   ``adamw_step`` 16 times. Prints a ``bench_gpt``-style line
   (tokens/s, step time, MFU against 989 TFLOP/s).
6. The card against the CPU: the same model at ``num_layers=2`` in f32
   (which takes the other backward route), batch 2: two ``train_step``
   calls on the card and on the CPU (plain versions) from the same
   weights and ids; both losses agree to 1e-4 relative, and the first
   step's gradients to 1e-4 of each gradient's largest magnitude.

Each main-path run (the serving runs, the bf16 training run, the f32
training run) starts with every launch count at 0 and is read just
after; the kernel checks' launches are not counted.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. A full record of the run is written
to ``chiprun_out/chip_smoke.json``.
"""

import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.nn import functional as F

from paddle2_tpu_torch import amp, jit
from paddle2_tpu_torch.kernels import _build
from paddle2_tpu_torch.kernels.flash_attn import (
    bwd_route, flash_bwd, flash_bwd_fused, flash_bwd_reference,
    flash_bwd_split_dkv, flash_bwd_split_dq, flash_fwd, flash_fwd_reference)
from paddle2_tpu_torch.kernels.fused_adamw import (adamw_step,
                                                   adamw_step_reference,
                                                   stage_scalars)
from paddle2_tpu_torch.models import GPTConfig, GPTForCausalLM, gpt3_1p3b
from paddle2_tpu_torch.optimizer import AdamW
from paddle2_tpu_torch.serving import EngineConfig, ServingEngine
from paddle2_tpu_torch.serving.paged_attention import (
    _merge_splits, paged_attention_reference,
    paged_attention_split_reference, paged_decode,
    paged_decode_split_partials)

# published H100 SXM peaks (NVIDIA data sheet, dense): f32 without TF32
# runs on the CUDA cores
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12
# f32: sums of up to 2048 terms in another order than the plain
# version; bf16: outputs and probabilities are rounded to bf16
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# the flash backward's dq/dk/dv, absolute below 1 and relative above.
# bf16: sound kernels read 2.0e-3 (fused: q*scale rounded to bf16 first)
# and 0 (split) at the training shape; the plain backward without the
# P/dS rounding reads above the limit (checked on every run)
BWD_TOL = {torch.bfloat16: 5e-3, torch.float32: 1e-4}
NEAR_TIE = 1e-3
# bf16 logits carry bf16 rounding (2**-6 at magnitudes 2..4), and the
# paged and the dense attention round at different places: a near tie
# in bf16 is a top-2 margin under 4 such steps
NEAR_TIE_BF16 = 0.0625
OUT = Path("chiprun_out")

KERNELS = {
    "flash_fwd": dict(
        source="paddle2_tpu_torch/kernels/csrc/flash_fwd.cu",
        replaces="paddle2_tpu/kernels/pallas_flash.py:153",
        also_replaces="paddle2_tpu/kernels/pallas_flash.py:122",
        counter=flash_fwd),
    "paged_decode": dict(
        source="paddle2_tpu_torch/serving/csrc/paged_decode.cu",
        replaces="paddle2_tpu/serving/paged_attention.py:103",
        counter=paged_decode),
    "paged_decode_split": dict(
        source="paddle2_tpu_torch/serving/csrc/paged_decode.cu",
        replaces="paddle2_tpu/serving/paged_attention.py:231",
        counter=paged_decode_split_partials),
    "flash_bwd_split_dkv": dict(
        source="paddle2_tpu_torch/kernels/csrc/flash_bwd.cu",
        replaces="paddle2_tpu/kernels/pallas_flash.py:305",
        counter=flash_bwd_split_dkv),
    "flash_bwd_split_dq": dict(
        source="paddle2_tpu_torch/kernels/csrc/flash_bwd.cu",
        replaces="paddle2_tpu/kernels/pallas_flash.py:354",
        counter=flash_bwd_split_dq),
    "flash_bwd_fused": dict(
        source="paddle2_tpu_torch/kernels/csrc/flash_bwd.cu",
        replaces="paddle2_tpu/kernels/pallas_flash.py:265",
        counter=flash_bwd_fused),
    "adamw_step": dict(
        source="paddle2_tpu_torch/kernels/csrc/adamw_step.cu",
        replaces="paddle2_tpu/kernels/pallas_fused.py:125",
        counter=adamw_step),
}
SERVING_KERNELS = ("flash_fwd", "paged_decode", "paged_decode_split")
# the training path (bench.py bench_gpt's default configuration)
TRAIN = dict(vocab=32768, hidden=1024, layers=24, heads=16, seq=1024,
             batch=8)


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(*a):
    print(*a, flush=True)


def dname(dtype):
    return str(dtype).replace("torch.", "")


def cuda_ms(fn, iters=20, warmup=3):
    """Median milliseconds of ``fn`` between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, kernel, iters=10):
    """Device time per call from torch.profiler (CUPTI): of every CUDA
    kernel the call launches, and of those whose name holds
    ``kernel``."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_time_total > 0]
    total = sum(e.device_time_total for e in evs) / iters / 1e3
    ours = sum(e.device_time_total for e in evs
               if kernel in e.key) / iters / 1e3
    return total, ours


def bound(ops, nbytes, dtype):
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def counts():
    return {n: k["counter"].launches for n, k in KERNELS.items()}


def reset_counts():
    for k in KERNELS.values():
        k["counter"].launches = 0


# ------------------------------------------------------------- phase 3
def check_flash(dtype, S, gen, dev, B=1, D=128):
    H = 16
    q, k, v = (torch.randn(B, H, S, D, generator=gen, device=dev)
               .to(dtype) for _ in range(3))
    scale = 1.0 / D ** 0.5
    o, lse = flash_fwd(q, k, v, scale=scale, causal=True)
    o_ref, lse_ref = flash_fwd_reference(q, k, v, scale, True)
    torch.cuda.synchronize()
    err = max((o.float() - o_ref.float()).abs().max().item(),
              (lse - lse_ref).abs().max().item())
    require(err <= TOL[dtype], f"flash_fwd {dname(dtype)} S{S} disagrees "
            f"with its plain version: {err} > {TOL[dtype]}")
    ms = cuda_ms(lambda: flash_fwd(q, k, v, scale=scale, causal=True))
    dev_ms, kern_ms = device_ms(
        lambda: flash_fwd(q, k, v, scale=scale, causal=True),
        "flash_fwd_kernel")
    plain = cuda_ms(lambda: flash_fwd_reference(q, k, v, scale, True),
                    iters=10)
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                         is_causal=True))
    ops = 4.0 * S * S * D * H * B / 2
    nbytes = 2.0 * (S + S) * H * D * B * q.element_size()
    b_ms, b_by = bound(ops, nbytes, dtype)
    return dict(name="flash_fwd", dtype=dname(dtype), shape=f"B{B} H{H} "
                f"S{S} D{D} causal", max_abs_err=err, tol=TOL[dtype],
                ms=ms, device_ms=dev_ms, kernel_device_ms=kern_ms,
                plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by)


def paged_inputs(dtype, gen, dev, rng):
    B, H, D, bs = 8, 16, 128, 16
    ctx = np.asarray([2048, 1900, 1500, 1024, 700, 333, 129, 17], np.int32)
    pages = -(-ctx // bs)
    n_pages = 128
    nb = int(pages.sum()) + 1
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((B, n_pages), np.int32)
    used = 0
    for b in range(B):
        tables[b, :pages[b]] = perm[used:used + pages[b]]
        used += pages[b]
    # stale slots hold x7 garbage, as in the CPU tests
    kp = (torch.randn(nb, bs, H, D, generator=gen, device=dev) * 7).to(dtype)
    vp = (torch.randn(nb, bs, H, D, generator=gen, device=dev) * 7).to(dtype)
    for b in range(B):
        for i in range(pages[b]):
            hi = min(bs, int(ctx[b]) - i * bs)
            blk = int(tables[b, i])
            kp[blk, :hi] = torch.randn(hi, H, D, generator=gen,
                                       device=dev).to(dtype)
            vp[blk, :hi] = torch.randn(hi, H, D, generator=gen,
                                       device=dev).to(dtype)
    q = torch.randn(B, 1, H, D, generator=gen, device=dev).to(dtype)
    return (q, kp, vp, torch.as_tensor(tables, device=dev),
            torch.as_tensor(ctx, device=dev)), int(ctx.sum())


def check_paged(dtype, gen, dev, rng, split):
    args, total_ctx = paged_inputs(dtype, gen, dev, rng)
    q = args[0]
    B, _, H, D = q.shape
    scale = 1.0 / D ** 0.5
    if split:
        def run():
            return _merge_splits(*paged_decode_split_partials(
                *args, scale=scale, pages_per_split=8), q.dtype)[:, None]

        def plain():
            return paged_attention_split_reference(*args, scale=scale,
                                                   pages_per_split=8)
    else:
        def run():
            return paged_decode(*args, scale=scale)

        def plain():
            return paged_attention_reference(*args, scale=scale)
    out, ref = run(), plain()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    require(torch.isfinite(out.float()).all().item(), "non-finite output")
    require(err <= TOL[dtype], f"paged decode (split={split}) "
            f"{dname(dtype)} disagrees with its plain version: {err} > "
            f"{TOL[dtype]}")
    ms = cuda_ms(run)
    dev_ms, kern_ms = device_ms(run, "paged_decode_split_kernel" if split
                                else "paged_decode_kernel")
    plain_ms = cuda_ms(plain, iters=10)
    ops = 4.0 * total_ctx * H * D
    nbytes = 2.0 * total_ctx * H * D * q.element_size()
    b_ms, b_by = bound(ops, nbytes, dtype)
    return dict(name="paged_decode_split" if split else "paged_decode",
                dtype=dname(dtype), shape=f"B{B} H{H} D{D} bs16 ctx "
                f"{total_ctx} total (max 2048)" + (" pps8" if split else ""),
                max_abs_err=err, tol=TOL[dtype], ms=ms, device_ms=dev_ms,
                kernel_device_ms=kern_ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def causal_pairs(Sq, Sk):
    """(query, key) pairs the bottom-right causal mask keeps."""
    r = np.arange(Sq)
    return int(np.minimum(Sk, r + (Sk - Sq) + 1).sum())


# operations per kept (query, key) pair and head-dim element (five,
# four or three products of 2 operations each), and the rows each
# kernel must read and write in the input dtype (q, do, k, v in; dq,
# dk, dv out); lse and delta add 8 bytes per query row
BWD_WORK = {
    "flash_bwd_fused": (10, lambda Sq, Sk: 3 * Sq + 4 * Sk),
    "flash_bwd_split_dkv": (8, lambda Sq, Sk: 2 * Sq + 4 * Sk),
    "flash_bwd_split_dq": (6, lambda Sq, Sk: 3 * Sq + 2 * Sk),
}


def bwd_bound(name, B, H, Sq, Sk, D, dtype, size):
    ops_per, elems = BWD_WORK[name]
    ops = ops_per * causal_pairs(Sq, Sk) * D * H * B
    nbytes = elems(Sq, Sk) * H * D * B * size + 8.0 * Sq * H * B
    return bound(ops, nbytes, dtype)


def bwd_inputs(dtype, B, H, Sq, Sk, D, gen, dev):
    q = torch.randn(B, H, Sq, D, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(B, H, Sk, D, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    do = torch.randn(B, H, Sq, D, generator=gen, device=dev).to(dtype)
    scale = 1.0 / D ** 0.5
    o, lse = flash_fwd(q, k, v, scale=scale, causal=True)
    return q, k, v, o, lse, do, scale


def check_flash_bwd(dtype, B, H, Sq, Sk, D, gen, dev, timed):
    """Both routes against the plain backward; with ``timed``, the
    route kernels' times, bounds and the SDPA backward's time."""
    q, k, v, o, lse, do, scale = bwd_inputs(dtype, B, H, Sq, Sk, D, gen,
                                            dev)
    ref = flash_bwd_reference(q, k, v, o, lse, do, scale, True)
    shape = f"B{B} H{H} Sq{Sq} Sk{Sk} D{D} causal"
    tol = BWD_TOL[dtype]

    def scaled(got):
        # absolute below 1, relative above: one bf16 rounding step of a
        # gradient of magnitude 8 is 0.03
        diff = [(g.float() - r.float()).abs() for g, r in zip(got, ref)]
        return ([(d / r.float().abs().clamp_min(1.0)).max().item()
                 for d, r in zip(diff, ref)], [d.max().item() for d in diff])
    errs, abs_errs = {}, {}
    for route in ("fused", "split"):
        got = flash_bwd(q, k, v, o, lse, do, scale, True, route=route)
        torch.cuda.synchronize()
        errs[route], abs_errs[route] = scaled(got)
        require(all(e <= tol for e in errs[route]),
                f"flash_bwd {route} {dname(dtype)} {shape}: dq/dk/dv err "
                f"{errs[route]} > {tol}")
    if not timed:
        return [dict(name="flash_bwd", dtype=dname(dtype), shape=shape,
                     dq_dk_dv_err=errs, dq_dk_dv_abs_err=abs_errs, tol=tol)]
    unrounded = None
    if dtype == torch.bfloat16:
        # what a kernel that skips the P/dS rounding reads: the limit
        # must catch it
        unrounded = scaled([t.to(dtype) for t in flash_bwd_reference(
            q.float(), k.float(), v.float(), o.float(), lse, do.float(),
            scale, True)])[0]
        require(max(unrounded) > tol,
                f"flash_bwd bf16 {shape}: the plain backward without P/dS "
                f"rounding reads {unrounded}, within the limit {tol}")
    delta = (do.float() * o.float()).sum(-1)
    plain = cuda_ms(lambda: flash_bwd_reference(q, k, v, o, lse, do, scale,
                                                True), iters=5, warmup=1)
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
    lib = cuda_ms(lambda: torch.autograd.grad(o_lib, (qr, kr, vr), do,
                                              retain_graph=True))
    rows = []
    for name, fn, route, outs in (
            ("flash_bwd_fused", flash_bwd_fused, "fused", slice(0, 3)),
            ("flash_bwd_split_dkv", flash_bwd_split_dkv, "split",
             slice(1, 3)),
            ("flash_bwd_split_dq", flash_bwd_split_dq, "split", slice(0, 1))):
        err = max(abs_errs[route][outs])
        scaled_err = max(errs[route][outs])
        def run(fn=fn):
            return fn(q, k, v, do, lse, delta, scale, True)
        ms = cuda_ms(run)
        dev_ms, kern_ms = device_ms(run, name.replace("_split", "")
                                    + "_kernel")
        b_ms, b_by = bwd_bound(name, B, H, Sq, Sk, D, dtype,
                               q.element_size())
        rows.append(dict(name=name, dtype=dname(dtype), shape=shape,
                         max_abs_err=err, scaled_err=scaled_err,
                         tol=tol, unrounded_err=unrounded, ms=ms,
                         device_ms=dev_ms, kernel_device_ms=kern_ms,
                         plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                         bound_by=b_by,
                         library="SDPA backward (is_causal)"))
    return rows


def check_adamw(shapes, gen, dev):
    """Three steps of the fused AdamW against the eager chain, bitwise,
    on parameters of the training path's leaf ``shapes``: in f32, and in
    bf16 with f32 masters. Then one step over the f32 state of all the
    leaves (what a training step runs) timed: the kernel, its plain
    version, and ``torch._fused_adamw_`` over the same list."""
    n_leaves = len(shapes)
    for dtype in (torch.float32, torch.bfloat16):
        inits = [torch.randn(sh, generator=gen, device=dev).to(dtype)
                 for sh in shapes]
        pa = [torch.nn.Parameter(t.clone()) for t in inits]
        pb = [torch.nn.Parameter(t) for t in inits]
        oa = AdamW(1e-3, parameters=pa, weight_decay=0.01,
                   multi_precision=True, fused=True)
        ob = AdamW(1e-3, parameters=pb, weight_decay=0.01,
                   multi_precision=True, fused=False)
        before = adamw_step.launches
        for _ in range(3):
            for a, b in zip(pa, pb):
                g = torch.randn(a.shape, generator=gen, device=dev).to(dtype)
                a.grad, b.grad = g, g.clone()
            oa.step()
            ob.step()
        torch.cuda.synchronize()
        require(adamw_step.launches - before == 3 * n_leaves,
                "the fused AdamW did not take the kernel for every leaf")
        for i, (a, b) in enumerate(zip(pa, pb)):
            sa, sb = oa._states[id(a)], ob._states[id(b)]
            pairs = [("param", a, b)]
            if dtype == torch.bfloat16:
                pairs.append(("master", sa["master"], sb["master"]))
                sa, sb = sa["inner"], sb["inner"]
            pairs += [("m", sa["m"], sb["m"]), ("v", sa["v"], sb["v"])]
            for what, x, y in pairs:
                require(torch.equal(x, y), f"adamw_step {dname(dtype)} leaf "
                        f"{i} {tuple(a.shape)}: {what} differs from the "
                        f"eager AdamW (max "
                        f"{(x.float() - y.float()).abs().max().item()})")
        del inits, pa, pb, oa, ob
        torch.cuda.empty_cache()
    state = [[torch.randn(sh, generator=gen, device=dev) for sh in shapes]
             for _ in range(4)]
    for v in state[3]:
        v.abs_()
    P, G, M, V = state
    sc = stage_scalars(1e-4, 0.9, 0.999, 1e-8, 0.01, 3)

    def run():
        for leaf in zip(P, G, M, V):
            adamw_step(*leaf, sc, True)

    def plain():
        for leaf in zip(P, G, M, V):
            adamw_step_reference(*leaf, sc, True)
    ms = cuda_ms(run)
    dev_ms, kern_ms = device_ms(run, "adamw_step_kernel")
    plain_ms = cuda_ms(plain, iters=5)
    steps = [torch.tensor(3.0, device=dev) for _ in shapes]
    lib = cuda_ms(lambda: torch._fused_adamw_(
        P, G, M, V, [], steps, lr=1e-4, beta1=0.9, beta2=0.999,
        weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False))
    N = sum(p.numel() for p in P)
    # 16 f32 operations an element; p, g, m, v read and p, m, v written
    b_ms, b_by = bound(16.0 * N, 28.0 * N, torch.float32)
    return dict(name="adamw_step", dtype="float32",
                shape=f"{n_leaves} leaves, {N} f32 elements (largest "
                f"{max(p.numel() for p in P)})",
                max_abs_err=0.0, tol="bitwise", ms=ms, device_ms=dev_ms,
                kernel_device_ms=kern_ms, plain_ms=plain_ms, library_ms=lib,
                bound_ms=b_ms, bound_by=b_by, library="torch._fused_adamw_")


# ------------------------------------------------------------- phase 4
# the decode step traced with torch.profiler: all 8 requests run by then
PROFILED_STEP = 20


def decode_step_profile(prof, wall_s):
    """Wall time of one traced decode step, the device time of its
    kernels (one stream: their sum is the busy time), and the kernels
    that take the most device time."""
    evs = [e for e in prof.key_averages() if e.device_time_total > 0]
    busy = sum(e.device_time_total for e in evs) / 1e3
    top = sorted(evs, key=lambda e: -e.device_time_total)[:6]
    return dict(traced_wall_ms=wall_s * 1e3, device_ms=busy,
                top=[(e.key[:70], e.device_time_total / 1e3, e.count)
                     for e in top])


def serve(model, econf, prompts, new_tokens):
    """Serve every prompt to completion; returns the generated tokens,
    the launch counts of this run alone, and its timings."""
    eng = ServingEngine(model, econf)
    reset_counts()
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    rids = [eng.submit(p, new_tokens) for p in prompts]
    prefill_s = decode_s = 0.0
    decode_tokens = 0
    ttft = {}
    step_profile = None
    step = 0
    while not eng.idle():
        t0 = time.perf_counter()
        infos = eng.admit_and_prefill(now=float(step))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for info in infos:
            ttft.setdefault(info["seq"].req_id, t1 - t_start)
        if step == PROFILED_STEP:
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                d = eng.decode_once(now=float(step))
                torch.cuda.synchronize()
            t2 = time.perf_counter()
            step_profile = decode_step_profile(prof, t2 - t1)
        else:
            d = eng.decode_once(now=float(step))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            decode_s += t2 - t1
            decode_tokens += d["tokens"] if d else 0
        prefill_s += t1 - t0
        step += 1
        require(step < 10_000, "engine did not drain")
    launches = counts()
    gens = [eng.sequence(r).generated for r in rids]
    for g in gens:
        require(len(g) == new_tokens, "a request finished short")
        require(all(0 <= t < model.cfg.vocab_size for t in g),
                "token out of range")
    if step_profile is not None:
        # the tracer slows the host: the idle share is taken against the
        # mean wall time of the untraced steps
        step_profile["untraced_step_ms"] = 1e3 * decode_s / (
            eng.decode_steps - 1)
        step_profile["idle_share"] = 1.0 - (step_profile["device_ms"]
                                            / step_profile["untraced_step_ms"])
    stats = dict(prefill_tok_s=sum(map(len, prompts)) / prefill_s,
                 decode_tok_s=decode_tokens / decode_s,  # untraced steps
                 ttft_mean_s=statistics.mean(ttft.values()),
                 ttft_max_s=max(ttft.values()), ticks=step,
                 decode_steps=eng.decode_steps, prefill_s=prefill_s,
                 decode_s=decode_s,
                 decode_programs=eng.num_decode_programs,
                 program_budget=eng.program_budget,
                 kv_high_water_bytes=eng.kv_high_water_bytes(),
                 step_profile=step_profile)
    require(eng.num_decode_programs <= eng.program_budget,
            "decode buckets past the budget")
    return gens, launches, stats


@torch.inference_mode()
def last_logits(model, ids):
    dev = model.gpt.wte.weight.device
    x = torch.as_tensor([ids], dtype=torch.long, device=dev)
    return model._head(model.gpt(x)[:, -1]).float()[0]


def dense_check(model, prompts, gens, new_tokens, tie):
    """Hold served tokens against the dense greedy path. The first
    mismatch of a request must be a near tie (dense top-2 margin below
    ``tie``); the request is not compared past it. Returns the dense tokens and the margins at the first
    mismatches."""
    margins, dense_all = [], []
    for p, g in zip(prompts, gens):
        dense = model.generate(np.asarray([p]), max_new_tokens=new_tokens)
        dense = dense[0, len(p):].tolist()
        dense_all.append(dense)
        if dense == g:
            continue
        i = next(j for j in range(new_tokens) if dense[j] != g[j])
        top2 = last_logits(model, p + dense[:i]).topk(2).values
        margin = (top2[0] - top2[1]).item()
        require(margin < tie,
                f"token {i} of a {len(p)}-token prompt: served {g[i]}, "
                f"dense {dense[i]}, margin {margin:.3g}")
        margins.append((len(p), i, margin))
    return dense_all, margins


# ---------------------------------------------------------- phases 5, 6
def train_setup(layers, device, bf16, seed=0):
    """``bench_gpt``'s default model, optimizer and fused step (the
    ``BENCH_FUSED_OPT=1`` variant), at ``layers`` blocks."""
    cfg = GPTConfig(vocab_size=TRAIN["vocab"], hidden_size=TRAIN["hidden"],
                    num_layers=layers, num_heads=TRAIN["heads"],
                    max_position_embeddings=TRAIN["seq"],
                    use_recompute=True, recompute_granularity="dots",
                    stacked_blocks=True, fused_head_loss=True)
    model = GPTForCausalLM(cfg, device=device, seed=seed)
    if bf16:
        model = amp.decorate(model, level="O2", dtype="bfloat16")
    return model, optimizer_and_step(model)


def optimizer_and_step(model):
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                multi_precision=True, fused=True)

    def train_fn(ids, labels):
        _, loss = model(ids, labels=labels)
        return loss
    return jit.train_step(train_fn, opt)


def batches(n, batch, device):
    """``bench_gpt``'s batches: token ids from ``RandomState(0)``."""
    rs = np.random.RandomState(0)
    return [torch.as_tensor(rs.randint(0, TRAIN["vocab"],
                                       (batch, TRAIN["seq"])),
                            dtype=torch.long, device=device)
            for _ in range(n)]


def step_profile(prof, wall_ms, untraced_ms):
    """Device busy time of one traced step (one stream: the sum of its
    kernels), its idle share against the untraced step time, and the
    items that take the most device time."""
    evs = [e for e in prof.key_averages() if e.device_time_total > 0]
    busy = sum(e.device_time_total for e in evs) / 1e3
    top = sorted(evs, key=lambda e: -e.device_time_total)[:8]
    return dict(traced_wall_ms=wall_ms, device_ms=busy,
                untraced_step_ms=untraced_ms,
                idle_share=1.0 - busy / untraced_ms,
                top=[(e.key[:70], e.device_time_total / 1e3, e.count)
                     for e in top])


def train_bf16(smi):
    """Phase 5: the full model in bf16 O2, 1 warm-up step, 5 timed
    steps, 1 traced step; launch counts per step."""
    T = TRAIN
    model, step = train_setup(T["layers"], "cuda", bf16=True)
    n_params = model.num_params()
    ids = batches(7, T["batch"], "cuda")
    route = bwd_route(torch.bfloat16)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = float(step(ids[0], ids[0]))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    losses, times = [], []
    for b in ids[1:6]:
        t0 = time.perf_counter()
        loss = step(b, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        traced = float(step(ids[6], ids[6]))
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = 7
    require(all(np.isfinite([warm, traced] + losses)),
            f"non-finite training loss: {[warm] + losses + [traced]}")
    require(losses[-1] < losses[0],
            f"training loss did not fall: {losses}")
    want = {"flash_fwd": T["layers"], "adamw_step": 16}
    if route == "fused":
        want["flash_bwd_fused"] = T["layers"]
    else:
        want["flash_bwd_split_dkv"] = want["flash_bwd_split_dq"] = \
            T["layers"]
    for n, per_step in want.items():
        require(launches[n] == steps * per_step,
                f"{n}: {launches[n]} launches in {steps} steps, want "
                f"{per_step} per step")
    step_s = statistics.mean(times)
    tok_s = T["batch"] * T["seq"] / step_s
    flops_per_token = 6 * n_params + 12 * T["layers"] * T["seq"] * \
        T["hidden"]
    bench = dict(metric="gpt_lm_train_tokens_per_sec", value=tok_s,
                 unit="tokens/s", step_time_s=step_s,
                 mfu_vs_chip_peak=tok_s * flops_per_token / PEAK_OPS[
                     torch.bfloat16],
                 model_params_m=n_params / 1e6,
                 config=dict(hidden=T["hidden"], layers=T["layers"],
                             seq=T["seq"], batch=T["batch"],
                             vocab=T["vocab"]),
                 device=torch.cuda.get_device_name(0), nvidia_smi=smi,
                 loss=losses[-1])
    run = dict(bench=bench, warmup_loss=warm, losses=losses,
               traced_loss=traced, step_times_s=times,
               first_step_s=first_s, peak_memory_gib=peak_gb,
               backward_route=route,
               launches_per_step={n: launches[n] / steps for n in KERNELS},
               step_profile=step_profile(prof, wall_ms, step_s * 1e3))
    return run, launches


def train_f32_vs_cpu():
    """Phase 6: a 2-layer copy at full width in f32 (the other backward
    route), two steps on the card and on the CPU from the same weights
    and ids; losses to 1e-4 relative and the first step's gradients to
    1e-4 of each gradient's largest magnitude."""
    model, step = train_setup(2, "cuda", bf16=False, seed=1)
    cpu = copy.deepcopy(model).cpu()
    cpu_step = optimizer_and_step(cpu)
    ids = batches(2, 2, "cpu")
    route = bwd_route(torch.float32)
    reset_counts()
    out = dict(backward_route=route, losses_card=[], losses_cpu=[])
    for i, b in enumerate(ids):
        out["losses_card"].append(float(step(b.cuda(), b.cuda())))
        out["losses_cpu"].append(float(cpu_step(b, b)))
        if i == 0:
            grad_err = max(
                ((p.grad.cpu() - q.grad).abs().max()
                 / q.grad.abs().max().clamp_min(1e-30)).item()
                for p, q in zip(model.parameters(), cpu.parameters()))
    torch.cuda.synchronize()
    launches = counts()
    rel = [abs(a - b) / abs(b) for a, b in zip(out["losses_card"],
                                              out["losses_cpu"])]
    out.update(loss_rel_err=rel, grad_rel_err=grad_err,
               launches=launches)
    require(max(rel) <= 1e-4, f"f32 training loss, card vs CPU: relative "
            f"errors {rel} > 1e-4")
    require(grad_err <= 1e-4, f"f32 gradients, card vs CPU: {grad_err} "
            f"> 1e-4 of the largest magnitude")
    kernels = (("flash_bwd_fused",) if route == "fused" else
               ("flash_bwd_split_dkv", "flash_bwd_split_dq"))
    for n in ("flash_fwd", "adamw_step") + kernels:
        require(launches[n] > 0, f"{n} was not launched by the f32 run")
    return out, launches


def main():
    t_run = time.perf_counter()
    # 1. device
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                 "is False)")
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    say(f"[device] {kind}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    say(f"[device] nvidia-smi: {smi}")

    # 2. build
    build_s = _build.build_all()
    say(f"[build] {len(_build.sources())} libraries in {build_s:.2f} s")
    for log in sorted(_build.BUILD_DIR.glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                say(f"[build] {log.stem}: {line.strip()}")

    # 3. kernels against their plain versions
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for S in (128, 1024, 2048):
            rows.append(check_flash(dtype, S, gen, dev))
        rows.append(check_paged(dtype, gen, dev, rng, split=False))
        rows.append(check_paged(dtype, gen, dev, rng, split=True))
    # the training path's shapes
    T = TRAIN
    hd = T["hidden"] // T["heads"]
    for dtype in (torch.bfloat16, torch.float32):
        rows.append(check_flash(dtype, T["seq"], gen, dev, B=T["batch"],
                                D=hd))
        rows += check_flash_bwd(dtype, T["batch"], T["heads"], T["seq"],
                                T["seq"], hd, gen, dev, timed=True)
    ragged = [r for dtype in (torch.bfloat16, torch.float32)
              for D in (16, 64, 128)
              for r in check_flash_bwd(dtype, 2, 4, 200, 333, D, gen, dev,
                                       timed=False)]
    shapes = [tuple(p.shape) for p in
              train_setup(T["layers"], dev, bf16=False)[0].parameters()]
    rows.append(check_adamw(shapes, gen, dev))
    torch.cuda.empty_cache()
    for r in rows:
        say(f"[kernel] {r['name']} {r['dtype']} {r['shape']}: err "
            f"{r['max_abs_err']:.3g} (tol {r['tol']}) ms {r['ms']:.4f} "
            f"(device {r['device_ms']:.4f}, kernel {r['kernel_device_ms']:.4f}) "
            f"plain {r['plain_ms']:.4f} library {r['library_ms']} bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']})")
    for r in ragged:
        say(f"[kernel] flash_bwd {r['dtype']} {r['shape']}: dq/dk/dv err "
            f"{r['dq_dk_dv_err']} (tol {r['tol']})")

    # 4. the engine at full width
    cfg = gpt3_1p3b()
    model = GPTForCausalLM(cfg, seed=1234)          # cuda, f32
    lens = [17, 45, 130, 257, 401, 613, 850, 1000]
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in lens]
    new = 32
    econf = dict(block_size=16, num_blocks=1024, max_batch=8)
    launches = {n: 0 for n in KERNELS}
    runs = {}

    def add(run_launches):
        for n, c in run_launches.items():
            launches[n] += c

    gens, l32, runs["f32"] = serve(model, EngineConfig(**econf), prompts,
                                   new)
    add(l32)
    _, ties = dense_check(model, prompts, gens, new, NEAR_TIE)
    runs["f32"].update(near_ties=len(ties), tie_margins=ties, launches=l32)
    say(f"[engine f32] {runs['f32']}")

    cpu = copy.deepcopy(model).cpu()
    for p in prompts[:2]:
        err = (last_logits(model, p).cpu() - last_logits(cpu, p)).abs().max()
        say(f"[engine f32] first-token logits vs CPU ({len(p)} tokens): "
            f"max abs err {err.item():.3g} (atol 1e-3)")
        require(err.item() <= 1e-3, "first-token logits differ from CPU")
    del cpu

    gens_s, ls, runs["f32_split8"] = serve(
        model, EngineConfig(**econf, split_pages=8), prompts, new)
    add(ls)
    _, ties = dense_check(model, prompts, gens_s, new, NEAR_TIE)
    runs["f32_split8"].update(near_ties=len(ties), tie_margins=ties,
                              launches=ls,
                              same_as_global=gens_s == gens)
    say(f"[engine f32 split8] {runs['f32_split8']}")

    model = model.to(torch.bfloat16)
    gens16, l16, runs["bf16"] = serve(
        model, EngineConfig(**econf, kv_dtype="bfloat16"), prompts, new)
    add(l16)
    _, ties = dense_check(model, prompts, gens16, new, NEAR_TIE_BF16)
    runs["bf16"].update(near_ties=len(ties), tie_margins=ties,
                        launches=l16)
    say(f"[engine bf16] {runs['bf16']}")

    for n in SERVING_KERNELS:
        require(launches[n] > 0, f"kernel {n} was never launched by the "
                f"engine")
    say(f"[engine] launches during the engine runs: {launches}")
    del model
    torch.cuda.empty_cache()

    # 5. training at full width and depth
    train, lt = train_bf16(smi)
    add(lt)
    say(f"[train bf16] {json.dumps(train['bench'])}")
    say(f"[train bf16] {train}")

    # 6. the card against the CPU, f32
    f32run, lf = train_f32_vs_cpu()
    add(lf)
    say(f"[train f32 vs cpu] {f32run}")
    say(f"[main path] launches: {launches}")
    for n in KERNELS:
        require(launches[n] > 0, f"kernel {n} was never launched on the "
                f"main path")

    line = []
    for n, k in KERNELS.items():
        # the line reports each kernel at its main path's bf16 shape
        # (the fused AdamW state is f32)
        r = next(r for r in rows if r["name"] == n
                 and r["dtype"] in ("bfloat16", "float32" if n ==
                                    "adamw_step" else "bfloat16")
                 and ("B1 H16 S1024" in r["shape"] or n != "flash_fwd"))
        line.append(dict(name=n, route="cuda", source=k["source"],
                         replaces=k["replaces"],
                         **({"also_replaces": k["also_replaces"]}
                            if "also_replaces" in k else {}),
                         launches=launches[n], shape=r["shape"],
                         dtype=r["dtype"], max_abs_err=r["max_abs_err"],
                         tol=r["tol"], ms=r["ms"], device_ms=r["device_ms"],
                         kernel_device_ms=r["kernel_device_ms"],
                         plain_ms=r["plain_ms"],
                         bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                         library_ms=r["library_ms"]))
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(
        dict(device=kind, nvidia_smi=smi, build_s=build_s, kernels=rows,
             ragged_flash_bwd=ragged, engine=runs, train_bf16=train,
             train_f32_vs_cpu=f32run, launches=launches,
             seconds=time.perf_counter() - t_run), indent=1))
    say(f"[done] {time.perf_counter() - t_run:.1f} s")
    say(f"nvidia-smi: {smi}")
    say(json.dumps({"kernels": line}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
