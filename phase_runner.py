#!/usr/bin/env python3
"""Run one measured phase of the port on a CUDA card, for the checkout
at ``--root``.

    python3 phase_runner.py --phase NAME [--root DIR] [--tag TAG]

Run on a machine with one CUDA GPU. The process imports the port and
``chip_smoke.py`` from ``DIR`` (default: this file's directory) and
builds ``DIR``'s kernels, so two commits are compared by running a phase
once per checkout, in turns (parent, change, change, parent), on one
card. Each phase prints the card's name and power limit, then one JSON
line, which it also writes to ``chiprun_out/phase_<NAME>[_<TAG>].json``.
Phases:

- ``int8_serving``: int8 weight-only serving of GPT-3 1.3B in bf16 (the
  smoke's phase-4 requests: 8 prompts of 17..1000 tokens, 32 new tokens
  each, ``EngineConfig(block_size=16, num_blocks=1024, max_batch=8)``,
  ``weight_only_int8=True, weight_only_lm_head=True``), served twice on
  one model, the second run's ``serve()`` figures; then
  ``int8_weight_only_matmul`` at the up projection (K 2048, N 8192, with
  a bias) at M 8 (decode) and M 1008 (a padded 1000-token prefill), bf16
  and f32: CUDA events, device time from torch.profiler, and the
  wrapper's host time a call (the median of 200 calls without a sync).
- ``varlen_step``: the smoke's phase 13 (``chip_smoke.varlen_train``:
  two GPT-3 1.3B-width packed self-attention layers, bf16 O2, batches of
  <= 8,192 tokens, 1 warm-up, 5 timed and 1 traced step, with that
  checkout's own launch gates): tokens/s, the step time, the traced
  step's device time, idle share and top kernels; then the backward of
  ``flash_attention_varlen_packed`` through autograd at the README batch
  (H16 D128, 1 x 2048 + 16 x 128 tokens, causal, bf16): CUDA events and
  device time.
- ``varlen_bwd_draws``: how far the bf16 packed varlen backward kernels
  sit from the plain version's f32 sums, over ``--draws`` random draws
  (``randn``, bf16) of the smoke's timed batches (H16: the README batch
  and the serving lengths at D 128, causal and not; the README batch at
  D 64 and 16) and one of each ragged case (H4, D 16/64/128). For the
  fused kernel, the split pair, the plain backward without its P/dS
  rounding (what the smoke's limits must reject) and the f32 plain
  version against the same backward with float64 sums, it reports
  ``chip_smoke.varlen_bwd_stats``: the largest error beyond half a bf16
  step, and the share of elements that are not the reference correctly
  rounded (the smoke's gate for the fused kernel).
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def nvidia_smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()


def int8_serving(cs, torch):
    import numpy as np
    from paddle2_tpu_torch.kernels import quant_matmul as qm
    from paddle2_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
    from paddle2_tpu_torch.serving import EngineConfig
    cfg = gpt3_1p3b()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (17, 45, 130, 257, 401, 613, 850, 1000)]
    model = GPTForCausalLM(cfg, seed=1234).to(torch.bfloat16)
    econf = EngineConfig(block_size=16, num_blocks=1024, max_batch=8,
                         kv_dtype="bfloat16", weight_only_int8=True,
                         weight_only_lm_head=True)
    runs = []
    for _ in range(2):
        gens, launches, st = cs.serve(model, econf, prompts, 32)
        runs.append(dict(prefill_tok_s=st["prefill_tok_s"],
                         ttft_mean_s=st["ttft_mean_s"],
                         ttft_max_s=st["ttft_max_s"],
                         decode_tok_s=st["decode_tok_s"],
                         prefill_s=st["prefill_s"], prefills=st["prefills"],
                         wo_launches=launches["wo_matmul"]))
    del model
    torch.cuda.empty_cache()

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    w8, s8 = qm.quantize_channelwise(
        torch.randn(2048, 8192, generator=gen, device=dev) * 0.02)
    b32 = torch.randn(8192, generator=gen, device=dev) * 0.02
    wo = {}
    for M, dtype in ((8, torch.bfloat16), (1008, torch.bfloat16),
                     (8, torch.float32), (1008, torch.float32)):
        x = torch.randn(M, 2048, generator=gen, device=dev).to(dtype)
        b = b32.to(dtype)

        def run():
            return qm.int8_weight_only_matmul(x, w8, s8, b)
        events = cs.cuda_ms(run)
        device, kernel = cs.device_ms(run, "wo_ge")
        host = []
        for _ in range(200):
            t0 = time.perf_counter()
            run()
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        wo[f"M{M} {str(dtype)[6:]}"] = dict(
            events_ms=events, device_ms=device, kernel_device_ms=kernel,
            host_ms=statistics.median(host))
    return dict(serve=runs[1], serve_first=runs[0],
                wo_up_k2048_n8192_bias=wo)


def varlen_step(cs, torch):
    from paddle2_tpu_torch.kernels.flash_varlen import \
        flash_attention_varlen_packed
    run, launches = cs.varlen_train(nvidia_smi())
    prof = run["step_profile"]
    step = dict(tokens_per_s=run["tokens_per_s"],
                step_ms=run["step_time_s"] * 1e3,
                step_times_ms=[t * 1e3 for t in run["step_times_s"]],
                device_ms=prof["device_ms"], idle_share=prof["idle_share"],
                top=prof["top"], launches_per_step=run["launches_per_step"])
    torch.cuda.empty_cache()

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    meta, tiles, keep = cs.varlen_meta(cs.VARLEN_README, None, True, dev)
    T, H, D = keep.shape[0], 16, 128
    q, k, v = (torch.randn(T, H, D, generator=gen, device=dev)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    do = torch.randn(T, H, D, generator=gen, device=dev).to(torch.bfloat16)
    o = flash_attention_varlen_packed(q, k, v, *meta, tiles=tiles)

    def backward():
        return torch.autograd.grad(o, (q, k, v), do, retain_graph=True)
    events = cs.cuda_ms(backward)
    device, _ = cs.device_ms(backward, "")
    return dict(packed_step=step,
                readme_backward=dict(events_ms=events, device_ms=device))


def _plain_f64(torch, q, k, v, do, lse, delta, meta, scale):
    """The plain backward with float64 sums; P and dS rounded to bf16 as
    the plain version rounds them."""
    seg_q, off_q, seg_k, off_k = meta
    keep = (seg_q[:, None] == seg_k[None, :]) & \
        (off_k[None, :] <= off_q[:, None])

    def heads(t):
        return t.double().transpose(0, 1)
    s = torch.matmul(heads(q), heads(k).transpose(-1, -2)) * scale
    s = s.masked_fill(~keep, float("-inf"))
    lse = lse.double()[..., None]
    dead = lse == float("-inf")
    p = torch.exp(s - torch.where(dead, torch.zeros_like(lse), lse))
    p = torch.where((s == float("-inf")) | dead, torch.zeros_like(p), p)
    dp = torch.matmul(heads(do), heads(v).transpose(-1, -2))
    ds = (p * (dp - delta.double()[..., None])).to(q.dtype).double()
    dq = torch.matmul(ds, heads(k)) * scale
    dk = torch.matmul(ds.transpose(-1, -2), heads(q)) * scale
    dv = torch.matmul(p.to(q.dtype).double().transpose(-1, -2), heads(do))
    return [t.float().transpose(0, 1).contiguous() for t in (dq, dk, dv)]


def varlen_bwd_draws(cs, torch, draws):
    from paddle2_tpu_torch.kernels import flash_varlen as fv
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(12)
    bf16 = torch.bfloat16
    cases = [(16, 128, cs.VARLEN_README, None, True, draws),
             (16, 128, cs.VARLEN_README, None, False, 2),
             (16, 128, cs.VARLEN_SERVING, None, True, 2),
             (16, 128, cs.VARLEN_SERVING, None, False, 1),
             (16, 64, cs.VARLEN_README, None, True, 2),
             (16, 16, cs.VARLEN_README, None, True, 1)]
    cases += [(4, D, lq, lk, causal, 1) for D in (16, 64, 128)
              for lq, lk, causal in cs.VARLEN_RAGGED]
    out = []
    for H, D, lens_q, lens_k, causal, n in cases:
        meta, (q_tiles, k_tiles), keep = cs.varlen_meta(lens_q, lens_k,
                                                        causal, dev)
        Tq, Tk = keep.shape
        scale = 1.0 / D ** 0.5
        for _ in range(n):
            q, do = (torch.randn(Tq, H, D, generator=gen, device=dev)
                     .to(bf16) for _ in range(2))
            k, v = (torch.randn(Tk, H, D, generator=gen, device=dev)
                    .to(bf16) for _ in range(2))
            o, lse = fv.flash_varlen_fwd(q, k, v, *meta, q_tiles, scale)
            delta = (do.float() * o.float()).sum(-1).t().contiguous()
            args = (q, k, v, do, lse, delta, *meta)
            fused = fv.flash_varlen_bwd_fused(*args, k_tiles, scale)
            split = (fv.flash_varlen_bwd_dq(*args, q_tiles, scale),
                     *fv.flash_varlen_bwd_dkv(*args, k_tiles, scale))
            f32 = fv.flash_varlen_bwd_fused_reference(
                *args, scale, out_dtype=torch.float32)
            up = [t.float() for t in (q, k, v, do)]
            unrounded = [t.to(bf16) for t in fv.flash_varlen_bwd_fused_reference(
                *up, lse, delta, *meta, scale)]
            f64 = _plain_f64(torch, q, k, v, do, lse, delta, meta, scale)
            torch.cuda.synchronize()
            out.append(dict(
                batch=f"H{H} D{D} Tq{Tq} Tk{Tk} "
                      + ("causal" if causal else "non-causal")
                      + ("" if H == 16 else f" lens {lens_q} / {lens_k}"),
                fused=cs.varlen_bwd_stats(fused, f32),
                split=cs.varlen_bwd_stats(split, f32),
                unrounded=cs.varlen_bwd_stats(unrounded, f32),
                fused_vs_f64=cs.varlen_bwd_stats(fused, f64),
                f32_plain_vs_f64=cs.varlen_bwd_stats(
                    [t.to(bf16) for t in f32], f64)))
            del q, k, v, do, o, fused, split, f32, up, unrounded, f64
            torch.cuda.empty_cache()
    summary = {}
    for key in out[0]:
        if key == "batch":
            continue
        for stat in out[0][key]:
            vals = [d[key][stat] for d in out]
            summary[f"{key}.{stat}"] = dict(
                max=max(vals), min=min(vals),
                median=sorted(vals)[len(vals) // 2])
    return dict(limits=dict(max_err=cs.BWD_TOL[bf16],
                            off_share=cs.VARLEN_OFF_SHARE),
                summary=summary, draws=out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", required=True,
                    choices=("int8_serving", "varlen_step",
                             "varlen_bwd_draws"))
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--tag", default="")
    ap.add_argument("--draws", type=int, default=8,
                    help="varlen_bwd_draws: draws of the README batch")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        sys.exit("phase_runner: no CUDA device")
    import chip_smoke as cs
    from paddle2_tpu_torch.kernels import _build

    smi = nvidia_smi()
    print(f"[{args.tag}] {smi}; root {root}", flush=True)
    build_s = _build.build_all()
    if args.phase == "int8_serving":
        result = int8_serving(cs, torch)
    elif args.phase == "varlen_step":
        result = varlen_step(cs, torch)
    else:
        result = varlen_bwd_draws(cs, torch, args.draws)
    line = json.dumps(dict(phase=args.phase, tag=args.tag, root=str(root),
                           nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
                           build_s=build_s, **result))
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / f"phase_{args.phase}{'_' + args.tag if args.tag else ''}.json"
     ).write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
