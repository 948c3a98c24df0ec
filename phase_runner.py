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
  one model, the second run's ``serve()`` figures (decode and prefill
  tokens/s, TTFT, and the traced decode step's device time by kernel
  group and idle share); then ``int8_weight_only_matmul`` at the up
  projection (K 2048, N 8192, with a bias) at M 8 (decode) and M 1008 (a
  padded 1000-token prefill), bf16 and f32, and at M 8 in bf16 at all
  five projections (qkv, out_proj, up and down with a bias, the head
  without): CUDA events, device time from torch.profiler (all kernels,
  and the weight-only kernel alone), the wrapper's host time a call (the
  median of 200 calls without a sync), and ``torch.addmm`` (``torch.mm``
  for the head) over the dequantized weight by events and device time.
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
- ``norms``: the RMSNorm and LayerNorm forwards at the main path's
  shapes (LayerNorm: ERNIE R4096 H768 bf16 with gamma/beta bf16 and f32,
  the GPT bench's R8192 H1024 bf16; RMSNorm: the incubate stack's R16384
  H2048 and the ``fused_rms_norm`` docstring's R8192 H1024, bf16 with a
  bf16 weight), each on an aligned x (the route the wrapper picks) and on
  a copy one element past a 16-byte boundary (the general route where
  the wrapper has two), plus a ragged H 771: CUDA events, device time
  from torch.profiler, the wrapper's host time a call (the median of 200
  calls without a sync), ``F.layer_norm`` / ``F.rms_norm``'s events and
  device times, and the bound; the RMSNorm backward at its
  three shapes, on x and do as given and on copies one element past a
  16-byte boundary (each route the checkout has), by events, device
  time, the wrapper's host time a call and the bound, beside
  ``F.rms_norm``'s backward through autograd; the host time of
  ``fused_layer_norm`` (the custom op) at ERNIE's shape, and of the
  pieces of a LayerNorm forward call there (the allocations, the stream
  and device queries, a device context, the data pointers); the
  LayerNorm backward at the smoke's ``LN_CASES`` (ERNIE R4096 H768: bf16
  x with bf16 and f32 γ, f32, f16 x with f16 and f32 γ; the GPT bench's
  R8192 H1024 bf16 and f32) on x and dy as given and on copies one
  element past a 16-byte boundary (each route the checkout has), by
  events, device time and the wrapper's host time a call, beside
  ``F.layer_norm``'s backward through autograd and the bound; RoPE at
  the stack's B8 S2048 H16 D128 in bf16 and f32, with an [S, D] and a
  gathered [B*S, D] table, on x as given and on a copy one element past
  a 16-byte boundary, the same way, with the bound; then the smoke's
  phase-14 stack step and phase-7 ERNIE step (``stack_bf16``,
  ``ernie_bf16`` with that checkout's own launch gates): tokens/s, the
  step time, the traced step's idle share, for the stack the traced
  step's device time and its split by kernel group (RoPE among them),
  and for ERNIE one more traced step's device time of the LayerNorm
  kernels by direction.
- ``core``: the smoke's phase 18 alone (``chip_smoke.phase18``): the
  op tables of the CPU tests on the card against the CPU, the surface at
  GPT-3 1.3B's width under ``FLAGS_check_nan_inf``, and save, load and
  serve of GPT-3 1.3B in bf16; the tokens to match are those of one
  ``serve()`` of the same model first (phase 4's bf16 run, rebuilt). Its
  record, with the phase's seconds.
- ``nn_transformer``: the smoke's phase 20 (a)-(b) alone
  (``chip_smoke.nn_transformer_bf16``): the default ``nn.Transformer``
  (Transformer-base) trained in bf16 O2 with ``FLAGS_pallas_layer_norm``
  on, 32 pairs of 256 + 256 tokens, 1 warm-up, 5 timed and 1 traced
  step, with that checkout's launch gates: target tokens/s, the step
  time, the losses, the traced step's device time, idle share and
  device time by kernel group.
- ``vision_rnn``: the smoke's phase 21 alone (``chip_smoke.phase21``),
  after phase 10's NCHW ResNet-50 run that (b) is recorded beside:
  DenseNet-121 in bf16 O2 through ``momentum_step``, ResNet-50 with
  ``FLAGS_conv_prefer_channels_last`` on, the nn case tables and an f32
  DenseNet-121 against the CPU, the LSTM LM through ``adamw_step``, beam
  search and a small f32 LM step against the CPU, and the path's
  kernels at its shapes. Its record, with the phase's seconds.
- ``obs_remat``: the smoke's phase 22 alone (``chip_smoke.phase22``):
  the bench GPT under each remat policy ("dots", "dots_plus",
  "dots_plus_ln", "offload", "full", "search"), 1 warm-up, 3 timed and
  1 traced step each with that checkout's gates, the "dots" steps' metrics
  stream through ``tools.perf_doctor``, one step priced by
  ``observability.cost_model.program_cost``, and
  ``FLAGS_check_nan_inf`` on the card. Its record, with the phase's
  seconds.
- ``fleet``: the smoke's phase 23 alone (``chip_smoke.phase23``):
  GPT-3 1.3B (24 layers, bf16) on one card through the host tier, a
  four-engine fleet under the router and the registry, the peer tier's
  decisions at two links, and failover with and without KV migration,
  with that checkout's gates. Its record, with the phase's seconds.
- ``flash_bwd_f32``: the f32 flash backward at the training shape (B8
  H16 S1024 D64, causal): the split pair's two wrappers
  (``flash_bwd_split_dkv``, ``flash_bwd_split_dq``) and ``flash_bwd``
  on its default route, each by CUDA events, device time from
  torch.profiler and the wrapper's host time a call (the median of 200
  calls without a sync); SDPA's f32 backward (through autograd) and the
  f32 fused kernel (``route="fused"``) by events and device time, for
  reference; then the smoke's phase-6 model (the bench GPT at 2 layers
  in f32, batch 2, ``chip_smoke.train_setup``): 1 warm-up step and 5
  timed steps, their mean and median step time and tokens/s (from the
  mean).
- ``train_bf16``: the smoke's phase 5 (``chip_smoke.train_bf16``: the
  bench GPT at full width and depth in bf16 O2, batch 8, 1 warm-up, 5
  timed and 1 traced step, with that checkout's own launch gates):
  tokens/s, the step times, the traced step's device time and idle
  share.
- ``adamw_step``: the fused AdamW step over the bench GPT's 16 training
  leaves (``chip_smoke.train_setup`` at full depth: 336.9 M elements),
  through the APIs both sides of a comparison have: the optimizer's step
  (``AdamW(1e-4, multi_precision=True, fused=True).step()``) on the
  leaves in their O2 dtypes (bf16 parameters with f32 masters and bf16
  gradients) and all in f32, with the kernel's launches a step; the
  kernel per leaf (``fused_adamw.adamw_step``, f32); where the checkout
  has it, the kernel over all 16 in one call (``adamw_step_multi``, f32
  and O2); and ``torch._fused_adamw_`` over the f32 state: each by CUDA
  events and device time from torch.profiler, with the host time a call
  of the optimizer's step.
- ``f32_prefill``: the smoke's f32 serving runs of GPT-3 1.3B (its
  phase-4 requests and engine settings), dense (``f32``) and int8
  weight-only with the int8 head (``int8_f32``), each served twice on
  one model: the second run's ``serve()`` figures (prefill tokens/s,
  TTFT, prefill seconds) and the f32 forward's and the prefill GEMM's
  launches; then a traced prefill of the 1000-token prompt alone (padded
  to 1008 rows): its device time by kernel group (the weight-only
  kernels, the flash kernels, the library's matmuls, the rest) and its
  wall time. Then the two kernels the f32 prefill runs, at the smoke's
  shapes: ``flash_fwd`` in f32 (B1 H16 S 128/1024/2048 D128 and B8 H16
  S1024 D64, causal) against SDPA's f32, and ``int8_weight_only_matmul``
  in f32 at the four block projections with their bias (M 32, 128, 144
  and 1008) against ``torch.addmm`` over the dequantized weight: CUDA
  events, device time from torch.profiler (all kernels of the call and
  the port's kernel alone) and the wrapper's host time a call. Then the
  same for two rows off the projections: bf16 M 1008, K 204, N 336 with
  its bias, off TMA's 16-byte rule (route "gemm" in every checkout), and
  f32 M 1008, K 20480, N 2048 with its bias, past 8 K splits of 2048
  rows (a checkout whose kernel refuses a row records its error).
- ``paged_decode``: the paged decode at the smoke's shapes (H16 bs16:
  B8 contexts 2048..17 at D 128, 64 and 16; B8 all 2048; B1 2048; B8
  contexts 1..17; B1 16,384), bf16 and f32, on the global route
  (``paged_decode``), the split route with its torch merge
  (``pages_per_split=8``) and the split kernel alone: CUDA events,
  device time from torch.profiler (all kernels of the call, and those
  named ``paged_decode``) and the wrapper's host time a call (the median
  of 200 calls without a sync); then ``int8_serving``'s bf16 serving
  runs: decode tokens/s, and the traced decode step's device time by
  kernel group (``paged_decode`` among them) and idle share.
- ``ptq_serving``: the smoke's phase-16 model in bf16 (GPT-3 1.3B from
  seed 1234, every block through PTQ with the smoke's quanters,
  calibrated on the phase-4 prompts and converted: 96
  ``QuantedInferenceLinear``), served twice (the phase-4 requests:
  decode and prefill tokens/s, TTFT, the ``i8i8_matmul`` launches by
  kernel where the checkout counts them); then a traced prefill of the
  1000-token prompt alone (padded to 1008 rows) and a traced decode step
  of all 8 requests (after 5 untimed and 5 timed untraced steps): device
  time by ``chip_smoke.SERVING_GROUPS`` and the 12 kernels with the most
  of it, wall time, and the decode step's idle share against the
  untraced steps' mean; then ``int8_matmul`` at
  the four block projections at M 8, 32, 144 and 1008 (random int8):
  CUDA events, device time from torch.profiler (all kernels of the call,
  and those named ``i8i8``), the wrapper's host time a call (the median
  of 200 calls without a sync), and ``torch._int_mm`` where it takes the
  shape (M > 16) by events and device time.
- ``f32_decode``: the smoke's int8 weight-only f32 serving of GPT-3
  1.3B (``int8_f32``: its phase-4 requests and engine settings,
  ``weight_only_int8=True, weight_only_lm_head=True``), served twice on
  one model (the second run's decode and prefill tokens/s, TTFT and
  launches by route); then a traced decode step of all 8 requests (after
  5 untimed and 5 timed untraced steps): its device time by
  ``chip_smoke.SERVING_GROUPS`` (the weight-only group is the step's 97
  ``int8_weight_only_matmul`` launches), its launches by kernel name,
  wall time and idle share against the untraced steps' mean. Then
  ``int8_weight_only_matmul`` in f32 at the five projections (qkv,
  out_proj, up and down with a bias, the head without) at M 1 and 8:
  CUDA events, device time from torch.profiler (all kernels of the call,
  and the weight-only kernel alone), the wrapper's host time a call, and
  ``torch.addmm`` / ``torch.mm`` over the dequantized f32 weight by
  events and device time; and M 8 at up and the head read cold (a new
  weight each call from copies that together pass 100 MB, as a decode
  step meets its 97 weights) against ``torch.mm`` read the same way.
- ``plain_serving``: the smoke's phase-4 fp serving (GPT-3 1.3B, seed
  1234, f32 then bf16, no option on), each served twice on one model:
  decode tokens/s, decode steps, TTFT, the traced step's device time
  and idle share, and the host time a decode step of the engine's table
  check where the checkout's ``serve()`` times it.
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


def _serve_int8_bf16(cs, torch):
    """The int8 weight-only bf16 serving runs of ``int8_serving``: the
    smoke's phase-4 requests served twice on one model; each run's
    ``serve()`` figures."""
    import numpy as np
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
        prof = st["step_profile"] or {}
        runs.append(dict(prefill_tok_s=st["prefill_tok_s"],
                         ttft_mean_s=st["ttft_mean_s"],
                         ttft_max_s=st["ttft_max_s"],
                         decode_tok_s=st["decode_tok_s"],
                         prefill_s=st["prefill_s"], prefills=st["prefills"],
                         decode_steps=st["decode_steps"],
                         wo_launches=launches["wo_matmul"],
                         paged_decode_launches=launches["paged_decode"],
                         decode_step_device_ms=prof.get("device_ms"),
                         decode_step_by_group=prof.get("by_group"),
                         decode_step_idle_share=prof.get("idle_share"),
                         decode_step_top=prof.get("top")))
    del model
    torch.cuda.empty_cache()
    return runs


def int8_serving(cs, torch):
    from paddle2_tpu_torch.kernels import quant_matmul as qm
    runs = _serve_int8_bf16(cs, torch)

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)

    def timed(run, x, w8, s8, b):
        events = cs.cuda_ms(run)
        device, kernel = cs.device_ms(run, "wo_ge")
        host = []
        for _ in range(200):
            t0 = time.perf_counter()
            run()
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        w_deq = (w8.float() * (s8 / 127.0)).to(x.dtype)

        def library():
            return (torch.mm(x, w_deq) if b is None
                    else torch.addmm(b, x, w_deq))
        return dict(events_ms=events, device_ms=device,
                    kernel_device_ms=kernel, host_ms=statistics.median(host),
                    library_events_ms=cs.cuda_ms(library),
                    library_device_ms=cs.device_ms(library, "")[0])
    w8, s8 = qm.quantize_channelwise(
        torch.randn(2048, 8192, generator=gen, device=dev) * 0.02)
    b32 = torch.randn(8192, generator=gen, device=dev) * 0.02
    wo = {}
    for M, dtype in ((8, torch.bfloat16), (1008, torch.bfloat16),
                     (8, torch.float32), (1008, torch.float32)):
        x = torch.randn(M, 2048, generator=gen, device=dev).to(dtype)
        b = b32.to(dtype)
        wo[f"M{M} {str(dtype)[6:]}"] = timed(
            lambda: qm.int8_weight_only_matmul(x, w8, s8, b), x, w8, s8, b)
        print(json.dumps({f"up M{M} {str(dtype)[6:]}":
                          wo[f"M{M} {str(dtype)[6:]}"]}), flush=True)
    del w8, s8
    decode = {}
    for label, (K, N) in cs.WO_SHAPES.items():
        w8, s8 = qm.quantize_channelwise(
            torch.randn(K, N, generator=gen, device=dev) * 0.02)
        x = torch.randn(8, K, generator=gen, device=dev).to(torch.bfloat16)
        b = (None if label == "head" else
             (torch.randn(N, generator=gen, device=dev) * 0.02).to(
                 torch.bfloat16))
        decode[label] = dict(shape=f"M8 K{K} N{N} bf16"
                             + ("" if b is None else " bias"),
                             route=qm.wo_route(8, K, N, torch.bfloat16),
                             **timed(lambda: qm.int8_weight_only_matmul(
                                 x, w8, s8, b), x, w8, s8, b))
        print(json.dumps({label: decode[label]}), flush=True)
        del w8, s8
        torch.cuda.empty_cache()
    # where a decode call's host time goes (bf16, M 8, the up projection
    # with a bias): each piece alone, the median of 200 calls without a
    # sync
    K, N = cs.WO_SHAPES["up"]
    w8, s8 = qm.quantize_channelwise(
        torch.randn(K, N, generator=gen, device=dev) * 0.02)
    x = torch.randn(8, K, generator=gen, device=dev).to(torch.bfloat16)
    b = (torch.randn(N, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    y = torch.empty(8, N, dtype=torch.bfloat16, device=dev)
    w_deq = w8.to(torch.bfloat16)
    plan = qm._plan(dev, 8, K, N, torch.bfloat16)
    stream = torch.cuda.current_stream(dev).cuda_stream
    pieces = dict(
        wrapper=lambda: qm.int8_weight_only_matmul(x, w8, s8, b),
        check=lambda: qm._check(x, w8, s8, b),
        on_card=lambda: qm._build.on_card("int8_weight_only_matmul", x, w8,
                                          s8, b),
        empty=lambda: torch.empty(x.shape[:-1] + (N,), dtype=x.dtype,
                                  device=x.device),
        current_device=torch.cuda.current_device,
        current_stream=lambda: torch.cuda.current_stream(dev).cuda_stream,
        raw_stream=lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        plan=lambda: qm._plan(dev, 8, K, N, torch.bfloat16),
        data_ptrs=lambda: (x.data_ptr(), w8.data_ptr(), s8.data_ptr(),
                           b.data_ptr(), y.data_ptr()),
        c_entry=(lambda: plan[4](x.data_ptr(), w8.data_ptr(), s8.data_ptr(),
                                 b.data_ptr(), y.data_ptr(), None, None, 8,
                                 K, N, plan[1], 127.0, stream))
        if len(plan) > 3 else (lambda: None),
        library=lambda: torch.addmm(b, x, w_deq))
    host_pieces = {k: _host_ms(torch, fn) for k, fn in pieces.items()}
    print(json.dumps(dict(host_pieces_ms=host_pieces)), flush=True)
    return dict(serve=runs[1], serve_first=runs[0],
                wo_up_k2048_n8192_bias=wo, decode_m8_bf16=decode,
                host_pieces_ms=host_pieces)


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


def _host_ms(torch, fn, n=200):
    """The median host time of ``n`` calls without a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def _misaligned(torch, t):
    """A contiguous copy of ``t`` one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


# the paged decode's shapes (chip_smoke.py PAGED_CASES): label,
# contexts, head dim; H 16, bs 16; the split route at 8 pages a split
PAGED_CTX = [2048, 1900, 1500, 1024, 700, 333, 129, 17]
PAGED_CASES = [("main", PAGED_CTX, 128), ("B8 all 2048", [2048] * 8, 128),
               ("B1 2048", [2048], 128),
               ("B8 short", [1, 2, 3, 5, 8, 13, 16, 17], 128),
               ("B1 16384", [16384], 128), ("D64", PAGED_CTX, 64),
               ("D16", PAGED_CTX, 16)]


def _paged_args(torch, ctx, D, dtype, seed):
    """Random pools (x7) and shuffled tables as wide as the longest
    context (the smoke's layout), from ``seed``: for timing only."""
    import numpy as np
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    H, bs = 16, 16
    ctx = np.asarray(ctx, np.int32)
    pages = -(-ctx // bs)
    nb = int(pages.sum()) + 1
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((len(ctx), int(pages.max())), np.int32)
    used = 0
    for b in range(len(ctx)):
        tables[b, :pages[b]] = perm[used:used + pages[b]]
        used += pages[b]
    kp = (torch.randn(nb, bs, H, D, generator=gen, device=dev) * 7).to(dtype)
    vp = (torch.randn(nb, bs, H, D, generator=gen, device=dev) * 7).to(dtype)
    q = torch.randn(len(ctx), 1, H, D, generator=gen, device=dev).to(dtype)
    return (q, kp, vp, torch.as_tensor(tables, device=dev),
            torch.as_tensor(ctx, device=dev))


def paged_decode(cs, torch):
    from paddle2_tpu_torch.serving import paged_attention as pa
    kernels = {}
    for dtype in (torch.bfloat16, torch.float32):
        for label, ctx, D in PAGED_CASES:
            args = _paged_args(torch, ctx, D, dtype, seed=len(kernels))
            scale = D ** -0.5
            runs = dict(
                global_route=lambda: pa.paged_decode(*args, scale=scale),
                split_route=lambda: pa._merge_splits(
                    *pa.paged_decode_split_partials(
                        *args, scale=scale, pages_per_split=8),
                    args[0].dtype),
                split_kernel=lambda: pa.paged_decode_split_partials(
                    *args, scale=scale, pages_per_split=8))
            for route, run in runs.items():
                device, kernel = cs.device_ms(run, "paged_decode")
                key = f"{label} {str(dtype)[6:]} {route}"
                kernels[key] = dict(events_ms=cs.cuda_ms(run),
                                    device_ms=device,
                                    kernel_device_ms=kernel,
                                    host_ms=_host_ms(torch, run))
                print(json.dumps({key: kernels[key]}), flush=True)
            del args
            torch.cuda.empty_cache()
    runs = _serve_int8_bf16(cs, torch)
    print(json.dumps(dict(serve=runs[1])), flush=True)
    return dict(kernels=kernels, serve=runs[1], serve_first=runs[0])


def plain_serving(cs, torch):
    """The smoke's phase-4 fp serving runs (f32, then bf16) on the
    seed's GPT-3 1.3B, each served twice on one model: ``serve()``'s
    figures, with the engine's table-check host time a step where the
    checkout's ``serve()`` times it (None where it does not)."""
    import numpy as np
    from paddle2_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
    from paddle2_tpu_torch.serving import EngineConfig
    cfg = gpt3_1p3b()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (17, 45, 130, 257, 401, 613, 850, 1000)]
    model = GPTForCausalLM(cfg, seed=1234)
    runs = {}
    for dtype in ("float32", "bfloat16"):
        if dtype == "bfloat16":
            model = model.to(torch.bfloat16)
        econf = EngineConfig(block_size=16, num_blocks=1024, max_batch=8,
                             kv_dtype=dtype)
        runs[dtype] = []
        for _ in range(2):
            _, launches, st = cs.serve(model, econf, prompts, 32)
            prof = st["step_profile"] or {}
            runs[dtype].append(dict(
                decode_tok_s=st["decode_tok_s"],
                decode_steps=st["decode_steps"], decode_s=st["decode_s"],
                ttft_mean_s=st["ttft_mean_s"],
                validate_host_ms_a_step=st.get("validate_host_ms_a_step"),
                paged_decode_launches=launches["paged_decode"],
                decode_step_device_ms=prof.get("device_ms"),
                decode_step_idle_share=prof.get("idle_share")))
            print(json.dumps({dtype: runs[dtype][-1]}), flush=True)
    return dict(serve=runs)


def f32_decode(cs, torch):
    import numpy as np
    from paddle2_tpu_torch.kernels import quant_matmul as qm
    from paddle2_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
    from paddle2_tpu_torch.serving import EngineConfig, ServingEngine
    cfg = gpt3_1p3b()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (17, 45, 130, 257, 401, 613, 850, 1000)]
    model = GPTForCausalLM(cfg, seed=1234)
    econf = EngineConfig(block_size=16, num_blocks=1024, max_batch=8,
                         weight_only_int8=True, weight_only_lm_head=True)
    runs = []
    for _ in range(2):
        _, launches, st = cs.serve(model, econf, prompts, 32)
        runs.append(dict(decode_tok_s=st["decode_tok_s"],
                         prefill_tok_s=st["prefill_tok_s"],
                         ttft_mean_s=st["ttft_mean_s"],
                         prefills=st["prefills"],
                         decode_steps=st["decode_steps"],
                         wo_launches=launches["wo_matmul"],
                         wo_route_launches=st["wo_route_launches"]))
    print(json.dumps(dict(serve=runs[1])), flush=True)
    eng = ServingEngine(model, econf)
    for p in prompts:
        eng.submit(p, 32)
    step = 0
    while step < 20:
        eng.admit_and_prefill(now=float(step))
        d = eng.decode_once(now=float(step))
        step += 1
        if d and d["tokens"] == len(prompts):
            break
    walls = []
    for i in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.decode_once(now=float(step))
        torch.cuda.synchronize()
        if i >= 5:
            walls.append((time.perf_counter() - t0) * 1e3)
        step += 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        d = eng.decode_once(now=float(step))
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    by_group = cs.device_groups(prof, cs.SERVING_GROUPS)
    evs = sorted((e for e in prof.key_averages() if e.device_time_total > 0),
                 key=lambda e: -e.device_time_total)
    device = sum(by_group.values())
    decode = dict(batch=d["tokens"], wall_ms=wall, device_ms=device,
                  by_group=by_group,
                  untraced_step_ms=statistics.mean(walls),
                  idle_share=1.0 - device / statistics.mean(walls),
                  wo_launches={e.key[:60]: e.count for e in evs
                               if "wo_ge" in e.key},
                  top=[(e.key[:70], e.device_time_total / 1e3, e.count)
                       for e in evs[:12]])
    print(json.dumps(dict(traced_decode_step=decode)), flush=True)
    del eng, model
    torch.cuda.empty_cache()

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    kernels = {}
    for label, (K, N) in cs.WO_SHAPES.items():
        w8, s8 = qm.quantize_channelwise(
            torch.randn(K, N, generator=gen, device=dev) * 0.02)
        b = (None if label == "head" else
             torch.randn(N, generator=gen, device=dev) * 0.02)
        w_deq = w8.float() * (s8 / 127.0)
        for M in (1, 8):
            x = torch.randn(M, K, generator=gen, device=dev)

            def run(x=x, w8=w8, s8=s8, b=b):
                return qm.int8_weight_only_matmul(x, w8, s8, b)

            def library(x=x, w_deq=w_deq, b=b):
                return (torch.mm(x, w_deq) if b is None
                        else torch.addmm(b, x, w_deq))
            device, kernel = cs.device_ms(run, "wo_ge")
            key = f"M{M} K{K} N{N} ({label})" + ("" if b is None else " bias")
            kernels[key] = dict(events_ms=cs.cuda_ms(run), device_ms=device,
                                kernel_device_ms=kernel,
                                host_ms=_host_ms(torch, run),
                                library_events_ms=cs.cuda_ms(library),
                                library_device_ms=cs.device_ms(library,
                                                               "")[0])
            print(json.dumps({key: kernels[key]}), flush=True)
        del w8, s8, w_deq
        torch.cuda.empty_cache()
    # read cold: a new weight each call, from copies past 100 MB
    cold = {}
    for label in ("up", "head"):
        K, N = cs.WO_SHAPES[label]
        copies = max(2, -(-(100 << 20) // (K * N)))
        ws = [qm.quantize_channelwise(
            torch.randn(K, N, generator=gen, device=dev) * 0.02)
            for _ in range(copies)]
        deq = [(w8.float() * (s8 / 127.0)) for w8, s8 in
               ws[:max(2, copies // 4)]]
        x = torch.randn(8, K, generator=gen, device=dev)
        turn = {"i": 0, "j": 0}

        def run(ws=ws, x=x, turn=turn):
            turn["i"] = (turn["i"] + 1) % len(ws)
            return qm.int8_weight_only_matmul(x, *ws[turn["i"]])

        def library(deq=deq, x=x, turn=turn):
            turn["j"] = (turn["j"] + 1) % len(deq)
            return torch.mm(x, deq[turn["j"]])
        device, kernel = cs.device_ms(run, "wo_ge")
        key = f"M8 K{K} N{N} ({label}) cold"
        cold[key] = dict(events_ms=cs.cuda_ms(run), device_ms=device,
                         kernel_device_ms=kernel, copies=len(ws),
                         library_events_ms=cs.cuda_ms(library),
                         library_device_ms=cs.device_ms(library, "")[0],
                         library_copies=len(deq))
        print(json.dumps({key: cold[key]}), flush=True)
        del ws, deq
        torch.cuda.empty_cache()
    return dict(serve=runs[1], serve_first=runs[0], traced_decode_step=decode,
                kernels=kernels, cold=cold)


# (norm, rows, H, x dtype, parameter dtype, what, eps)
NORM_SHAPES = [
    ("layer_norm", 4096, 768, "bfloat16", "bfloat16", "ERNIE stacked", 1e-12),
    ("layer_norm", 4096, 768, "bfloat16", "float32", "ERNIE emb_ln", 1e-12),
    ("layer_norm", 8192, 1024, "bfloat16", "bfloat16", "GPT bench", 1e-5),
    ("layer_norm", 4096, 771, "bfloat16", "bfloat16", "ragged H 771", 1e-5),
    ("rms_norm", 16384, 2048, "bfloat16", "bfloat16", "stack", 1e-6),
    ("rms_norm", 8192, 1024, "bfloat16", "bfloat16", "docstring", 1e-6),
    ("rms_norm", 4096, 771, "bfloat16", "bfloat16", "ragged H 771", 1e-6)]


def norms(cs, torch):
    from torch.nn import functional as F
    from paddle2_tpu_torch import flags
    from paddle2_tpu_torch.kernels import fused_layer_norm as fln
    from paddle2_tpu_torch.kernels import fused_rms_norm as frn
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for norm, R, H, xd, pd, what, eps in NORM_SHAPES:
        xdt, pdt = getattr(torch, xd), getattr(torch, pd)
        x = (torch.randn(R, H, generator=gen, device=dev) * 2 + 0.5).to(xdt)
        p = [torch.randn(H, generator=gen, device=dev).to(pdt)
             for _ in range(2 if norm == "layer_norm" else 1)]
        px = [t.to(xdt) for t in p]
        size, psize = x.element_size(), p[0].element_size()
        if norm == "layer_norm":
            def ours(xin, p=p, eps=eps):
                return fln.layer_norm_fwd(xin, *p, eps)

            def library(x=x, px=px, H=H, eps=eps):
                return F.layer_norm(x, (H,), *px, eps)
            ops, nbytes = 8.0 * R * H, 2.0 * R * H * size + 2.0 * H * psize
        else:
            def ours(xin, p=p, eps=eps):
                return frn.rms_norm_fwd(xin, *p, eps)

            def library(x=x, px=px, H=H, eps=eps):
                return F.rms_norm(x, (H,), *px, eps)
            ops = 4.0 * R * H
            nbytes = 2.0 * R * H * size + H * psize + 4.0 * R
        b_ms, b_by = cs.bound(ops, nbytes, torch.float32)
        row = dict(norm=norm, shape=f"R{R} H{H} x {xd} params {pd}",
                   what=what, bound_ms=b_ms, bound_by=b_by,
                   library_events_ms=cs.cuda_ms(library),
                   library_device_ms=cs.device_ms(library, "")[0])
        for label, xin in (("aligned", x),
                           ("unaligned", _misaligned(torch, x))):
            def run(xin=xin):
                return ours(xin)
            row[label] = dict(events_ms=cs.cuda_ms(run),
                              device_ms=cs.device_ms(run, "")[0],
                              host_ms=_host_ms(torch, run))
        if norm == "layer_norm" and "ERNIE" in what:
            row["fused_layer_norm_host_ms"] = _host_ms(
                torch, lambda x=x, p=p, eps=eps: fln.fused_layer_norm(
                    x, *p, eps))
        if norm == "rms_norm":
            # the backward on both routes, F.rms_norm's autograd backward
            # beside it
            dy = torch.randn(R, H, generator=gen, device=dev).to(xdt)
            r = frn.rms_norm_fwd(x, p[0], eps)[1]
            xr, wr = (t.detach().clone().requires_grad_()
                      for t in (x, px[0]))
            out = F.rms_norm(xr, (H,), wr, eps)

            def lib_bwd(out=out, xr=xr, wr=wr, dy=dy):
                return torch.autograd.grad(out, (xr, wr), dy,
                                           retain_graph=True)
            b_ms, b_by = cs.bound(10.0 * R * H, 3.0 * R * H * size
                                  + 2.0 * H * psize + 4.0 * R, torch.float32)
            row["backward"] = dict(
                bound_ms=b_ms, bound_by=b_by,
                library_events_ms=cs.cuda_ms(lib_bwd),
                library_device_ms=cs.device_ms(lib_bwd, "")[0])
            for label, xin, din in (
                    ("aligned", x, dy),
                    ("unaligned", _misaligned(torch, x),
                     _misaligned(torch, dy))):
                def backward(xin=xin, din=din, p=p, r=r):
                    return frn.rms_norm_bwd(xin, p[0], r, din)
                row["backward"][label] = dict(
                    events_ms=cs.cuda_ms(backward),
                    device_ms=cs.device_ms(backward, "")[0],
                    host_ms=_host_ms(torch, backward))
            del xr, wr, out
        rows.append(row)
        print(json.dumps(row), flush=True)
        del x, p, px
    # where a LayerNorm forward call's host time goes, at ERNIE's shape:
    # each piece alone, the median of 200 calls without a sync
    x = torch.randn(4096, 768, generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn(768, generator=gen, device=dev).to(torch.bfloat16)

    def in_device_context():
        with torch.cuda.device(dev):
            pass
    pieces = dict(
        layer_norm_fwd=lambda: fln.layer_norm_fwd(x, g, g, 1e-12),
        library=lambda: F.layer_norm(x, (768,), g, g, 1e-12),
        empty_like=lambda: torch.empty_like(x),
        empty_rows=lambda: torch.empty(4096, dtype=torch.float32,
                                       device=dev),
        current_stream=lambda: torch.cuda.current_stream(dev).cuda_stream,
        current_device=torch.cuda.current_device,
        device_context=in_device_context,
        data_ptrs=lambda: (x.data_ptr(), g.data_ptr(), g.data_ptr(),
                           x.data_ptr()))
    host_pieces = {k: _host_ms(torch, fn) for k, fn in pieces.items()}
    print(json.dumps(dict(host_pieces_ms=host_pieces)), flush=True)
    del x, g
    torch.cuda.empty_cache()
    ln_bwd = _layer_norm_backwards(cs, torch, gen, dev)
    ropes = _ropes(cs, torch, gen, dev)

    smi = nvidia_smi()
    stack, _ = cs.stack_bf16(smi, dev)
    steps = dict(stack=dict(tokens_per_s=stack["tokens_per_s"],
                            step_ms=stack["step_time_s"] * 1e3,
                            step_times_ms=[t * 1e3
                                           for t in stack["step_times_s"]],
                            idle_share=stack["step_profile"]["idle_share"],
                            device_ms=stack["step_profile"]["device_ms"],
                            device_ms_by_group=stack["device_ms_by_group"]))
    del stack
    torch.cuda.empty_cache()
    flags.set_flags({"pallas_layer_norm": True})
    ernie, _, model, step = cs.ernie_bf16(smi)
    # one more traced step, its device time by LayerNorm direction
    ids, lbl = cs.ernie_batches(1, cs.ERNIE["batch"], "cuda")[0]
    step(ids, lbl)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(ids, lbl)
        torch.cuda.synchronize()
    flags.set_flags({"pallas_layer_norm": False})
    groups = cs.device_groups(prof, ERNIE_LN_GROUPS)
    steps["ernie"] = dict(tokens_per_s=ernie["bench"]["value"],
                          step_ms=ernie["bench"]["step_time_s"] * 1e3,
                          step_times_ms=[t * 1e3
                                         for t in ernie["step_times_s"]],
                          idle_share=ernie["step_profile"]["idle_share"],
                          traced_device_ms=sum(groups.values()),
                          traced_device_ms_by_group=groups)
    del model, step
    torch.cuda.empty_cache()
    return dict(forwards=rows, host_pieces_ms=host_pieces,
                layer_norm_backwards=ln_bwd, ropes=ropes, steps=steps)


# a traced ERNIE step's LayerNorm kernels by direction (the backward's row
# kernels and the reduction of their partials), in every checkout
ERNIE_LN_GROUPS = (("layer_norm_fwd", ("layer_norm_fwd",)),
                   ("layer_norm_bwd", ("layer_norm_bwd",)))


def _layer_norm_backwards(cs, torch, gen, dev):
    """The LayerNorm backward at ``chip_smoke.LN_CASES``, on x and dy as
    given and on copies one element past a 16-byte boundary: events,
    device time of every kernel of the call, the wrapper's host time;
    ``F.layer_norm``'s backward through autograd; the bound."""
    from torch.nn import functional as F
    from paddle2_tpu_torch.kernels import fused_layer_norm as fln
    out = []
    for R, H, xdt, gdt, what in cs.LN_CASES:
        x, g, b, dy, eps = cs.ln_inputs(R, H, xdt, gdt, gen, dev)
        size, gsize = x.element_size(), g.element_size()
        b_ms, b_by = cs.bound(16.0 * R * H, 3.0 * R * H * size
                              + 3.0 * H * gsize, torch.float32)
        xr, gr, br = (t.detach().clone().requires_grad_()
                      for t in (x, g.to(xdt), b.to(xdt)))
        y = F.layer_norm(xr, (H,), gr, br, eps)

        def lib_bwd(y=y, xr=xr, gr=gr, br=br, dy=dy):
            return torch.autograd.grad(y, (xr, gr, br), dy,
                                       retain_graph=True)
        row = dict(shape=f"R{R} H{H} x {cs.dname(xdt)} g {cs.dname(gdt)}",
                   what=what, bound_ms=b_ms, bound_by=b_by,
                   library_events_ms=cs.cuda_ms(lib_bwd),
                   library_device_ms=cs.device_ms(lib_bwd, "")[0])
        for label, xin, din in (("aligned", x, dy),
                                ("unaligned", _misaligned(torch, x),
                                 _misaligned(torch, dy))):
            def run(xin=xin, din=din, g=g, eps=eps):
                return fln.layer_norm_bwd(xin, g, din, eps)
            row[label] = dict(events_ms=cs.cuda_ms(run),
                              device_ms=cs.device_ms(run, "")[0],
                              host_ms=_host_ms(torch, run))
        print(json.dumps(row), flush=True)
        out.append(row)
        del x, dy, xr, gr, br, y
    torch.cuda.empty_cache()
    return out


# the stack's RoPE: B, S, H, D
ROPE_SHAPE = (8, 2048, 16, 128)


def _ropes(cs, torch, gen, dev):
    """RoPE at the stack's shape (B8 S2048 H16 D128), bf16 and f32, with
    an [S, D] table and a ``position_ids``-gathered [B*S, D] one, on x as
    given and on a copy one element past a 16-byte boundary: events,
    device time of every kernel of the call, the wrapper's host time; the
    bound."""
    from paddle2_tpu_torch.incubate.nn import functional as IF
    from paddle2_tpu_torch.kernels import fused_rope as fr
    B, S, H, D = ROPE_SHAPE
    out = []
    for dt in ("bfloat16", "float32"):
        dtype = getattr(torch, dt)
        for table in ("S", "pos"):
            x = torch.randn(B, S, H, D, generator=gen, device=dev).to(dtype)
            cos, sin = IF._angle_table(S, D, 10000.0, False, dtype, dev)
            if table == "pos":
                pos = torch.randint(0, S, (B, S), generator=gen, device=dev)
                cos, sin = (t[pos].reshape(B * S, D) for t in (cos, sin))
            n = x.numel()
            b_ms, b_by = cs.bound(3.0 * n, 2.0 * n * x.element_size()
                                  + 2.0 * cos.shape[0] * D
                                  * cos.element_size(), torch.float32)
            row = dict(shape=f"B{B} S{S} H{H} D{D} {dt}, "
                       f"{'[S, D]' if table == 'S' else '[B*S, D]'} table",
                       bound_ms=b_ms, bound_by=b_by)
            for label, xin in (("aligned", x),
                               ("unaligned", _misaligned(torch, x))):
                def run(xin=xin, cos=cos, sin=sin):
                    return fr.rope(xin, cos, sin)
                row[label] = dict(events_ms=cs.cuda_ms(run),
                                  device_ms=cs.device_ms(run, "")[0],
                                  host_ms=_host_ms(torch, run))
            print(json.dumps(row), flush=True)
            out.append(row)
            del x, cos, sin
    torch.cuda.empty_cache()
    return out


def flash_bwd_f32(cs, torch):
    from torch.nn import functional as F
    from paddle2_tpu_torch.kernels import flash_attn as fa
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, H, S, D = 8, 16, 1024, 64
    q, k, v, do = (torch.randn(B, H, S, D, generator=gen, device=dev)
                   for _ in range(4))
    scale = D ** -0.5
    o, lse = fa.flash_fwd(q, k, v, scale=scale, causal=True)
    delta = (do * o).sum(-1)
    calls = dict(
        split_dkv=(lambda: fa.flash_bwd_split_dkv(
            q, k, v, do, lse, delta, scale, True), "flash_bwd_dkv"),
        split_dq=(lambda: fa.flash_bwd_split_dq(
            q, k, v, do, lse, delta, scale, True), "flash_bwd_dq"),
        flash_bwd=(lambda: fa.flash_bwd(q, k, v, o, lse, do, scale, True),
                   ""),
        fused=(lambda: fa.flash_bwd(q, k, v, o, lse, do, scale, True,
                                    route="fused"), ""))
    rows = {}
    for name, (fn, kernel) in calls.items():
        device, ours = cs.device_ms(fn, kernel)
        rows[name] = dict(events_ms=cs.cuda_ms(fn), device_ms=device,
                          kernel_device_ms=ours)
        if name != "fused":
            rows[name]["host_ms"] = _host_ms(torch, fn)
        print(json.dumps({name: rows[name]}), flush=True)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)

    def sdpa():
        return torch.autograd.grad(o_lib, (qr, kr, vr), do,
                                   retain_graph=True)
    rows["sdpa_backward"] = dict(events_ms=cs.cuda_ms(sdpa),
                                 device_ms=cs.device_ms(sdpa, "")[0])
    del q, k, v, do, o, lse, delta, qr, kr, vr, o_lib
    torch.cuda.empty_cache()

    model, step = cs.train_setup(2, "cuda", bf16=False, seed=1)
    ids = cs.batches(6, 2, "cuda")
    warm = float(step(ids[0], ids[0]))
    torch.cuda.synchronize()
    times, losses = [], []
    for b in ids[1:]:
        t0 = time.perf_counter()
        losses.append(float(step(b, b)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = statistics.mean(times)
    rows["f32_step"] = dict(step_ms=step_s * 1e3,
                            median_step_ms=statistics.median(times) * 1e3,
                            step_times_ms=[t * 1e3 for t in times],
                            tokens_per_s=2 * cs.TRAIN["seq"] / step_s,
                            warmup_loss=warm, losses=losses)
    del model, step
    torch.cuda.empty_cache()
    return dict(shape=f"B{B} H{H} S{S} D{D} causal f32", **rows)


def adamw_step(cs, torch):
    from paddle2_tpu_torch.kernels import fused_adamw as fa
    from paddle2_tpu_torch.optimizer import AdamW
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    model = cs.train_setup(cs.TRAIN["layers"], "cuda", bf16=True)[0]
    leaves = [(tuple(p.shape), p.dtype) for p in model.parameters()]
    del model
    torch.cuda.empty_cache()
    out = dict(leaves=len(leaves),
               elements=sum(torch.Size(sh).numel() for sh, _ in leaves))

    def record(name, fn, kernel=""):
        events = cs.cuda_ms(fn)
        device, ours = cs.device_ms(fn, kernel)
        out[name] = dict(events_ms=events, device_ms=device,
                         kernel_device_ms=ours if kernel else None)
        print(json.dumps({name: out[name]}), flush=True)

    for form in ("O2", "float32"):
        params = [torch.nn.Parameter(torch.randn(
            sh, generator=gen, device=dev).to(dt if form == "O2" else
                                              torch.float32))
                  for sh, dt in leaves]
        opt = AdamW(1e-4, parameters=params, multi_precision=True,
                    fused=True)
        for p in params:
            p.grad = torch.randn(p.shape, generator=gen, device=dev).to(
                p.dtype)
        before = fa.adamw_step.launches
        opt.step()
        torch.cuda.synchronize()
        launches = fa.adamw_step.launches - before
        record(f"optimizer_step_{form}", opt.step, "adamw_step_kernel")
        out[f"optimizer_step_{form}"].update(
            kernel_launches_a_step=launches,
            host_ms=_host_ms(torch, opt.step))
        del params, opt
        torch.cuda.empty_cache()
    P, G, M, V = [[torch.randn(sh, generator=gen, device=dev)
                   for sh, _ in leaves] for _ in range(4)]
    for v in V:
        v.abs_()
    sc = fa.stage_scalars(1e-4, 0.9, 0.999, 1e-8, 0.01, 3)

    def per_leaf():
        for leaf in zip(P, G, M, V):
            fa.adamw_step(*leaf, sc, True)
    record("kernel_per_leaf_float32", per_leaf, "adamw_step_kernel")
    if hasattr(fa, "adamw_step_multi"):
        n = len(leaves)
        record("kernel_one_launch_float32", lambda: fa.adamw_step_multi(
            P, G, M, V, [None] * n, [True] * n, sc), "adamw_step_kernel")
        G16 = [g.to(dt) for g, (_, dt) in zip(G, leaves)]
        L = [torch.empty(sh, dtype=dt, device=dev)
             if dt != torch.float32 else None for sh, dt in leaves]
        record("kernel_one_launch_O2", lambda: fa.adamw_step_multi(
            P, G16, M, V, L, [True] * n, sc), "adamw_step_kernel")
        del G16, L
    steps = [torch.tensor(3.0, device=dev) for _ in leaves]
    record("torch_fused_adamw_float32", lambda: torch._fused_adamw_(
        P, G, M, V, [], steps, lr=1e-4, beta1=0.9, beta2=0.999,
        weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False))
    del P, G, M, V
    torch.cuda.empty_cache()
    return out


def f32_prefill(cs, torch):
    import numpy as np
    from torch.nn import functional as F
    from paddle2_tpu_torch.kernels import flash_attn as fa
    from paddle2_tpu_torch.kernels import quant_matmul as qm
    from paddle2_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
    from paddle2_tpu_torch.serving import EngineConfig, ServingEngine
    cfg = gpt3_1p3b()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (17, 45, 130, 257, 401, 613, 850, 1000)]
    econf = dict(block_size=16, num_blocks=1024, max_batch=8)
    groups = (("wo_matmul", ("wo_ge",)), ("flash", ("flash_",)),
              ("library matmul", ("gemm", "gemv", "cutlass", "xmma",
                                  "nvjet", "cublas")))
    out = {}
    for tag, extra in (("f32", {}), ("int8_f32", dict(
            weight_only_int8=True, weight_only_lm_head=True))):
        model = GPTForCausalLM(cfg, seed=1234)
        ec = EngineConfig(**econf, **extra)
        runs = []
        for _ in range(2):
            _, launches, st = cs.serve(model, ec, prompts, 32)
            runs.append(dict(
                prefill_tok_s=st["prefill_tok_s"],
                ttft_mean_s=st["ttft_mean_s"], ttft_max_s=st["ttft_max_s"],
                prefill_s=st["prefill_s"], prefills=st["prefills"],
                decode_tok_s=st["decode_tok_s"],
                launches={n: launches.get(n) for n in (
                    "flash_fwd", "flash_fwd_tf32x3", "wo_matmul",
                    "wo_gemm_tf32")},
                wo_route_launches=st["wo_route_launches"]))
        eng = ServingEngine(model, ec)
        eng.submit(prompts[-1], 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            eng.admit_and_prefill(now=0.0)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_group = cs.device_groups(prof, groups)
        out[tag] = dict(serve=runs[1], serve_first=runs[0],
                        traced_prefill_1000=dict(
                            wall_ms=wall * 1e3,
                            device_ms=sum(by_group.values()),
                            by_group=by_group))
        print(json.dumps({tag: out[tag]}), flush=True)
        del model, eng
        torch.cuda.empty_cache()

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)

    def timed(run, library, kernel):
        device, ours = cs.device_ms(run, kernel)
        return dict(events_ms=cs.cuda_ms(run), device_ms=device,
                    kernel_device_ms=ours, host_ms=_host_ms(torch, run),
                    library_events_ms=cs.cuda_ms(library),
                    library_device_ms=cs.device_ms(library, "")[0])
    flash = {}
    for B, S, D in ((1, 128, 128), (1, 1024, 128), (1, 2048, 128),
                    (8, 1024, 64)):
        q, k, v = (torch.randn(B, 16, S, D, generator=gen, device=dev)
                   for _ in range(3))
        key = f"B{B} H16 S{S} D{D} causal"
        flash[key] = timed(
            lambda: fa.flash_fwd(q, k, v, scale=D ** -0.5, causal=True),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
            "flash_fwd")
        print(json.dumps({key: flash[key]}), flush=True)
        del q, k, v
    wo = {}
    for label in ("qkv", "out_proj", "up", "down"):
        K, N = cs.WO_SHAPES[label]
        w8, s8 = qm.quantize_channelwise(
            torch.randn(K, N, generator=gen, device=dev) * 0.02)
        b = torch.randn(N, generator=gen, device=dev) * 0.02
        w_deq = w8.float() * (s8 / 127.0)
        for M in (32, 128, 144, 1008):
            x = torch.randn(M, K, generator=gen, device=dev)
            key = f"M{M} K{K} N{N} ({label}) bias"
            wo[key] = timed(
                lambda: qm.int8_weight_only_matmul(x, w8, s8, b),
                lambda: torch.addmm(b, x, w_deq), "wo_ge")
            print(json.dumps({key: wo[key]}), flush=True)
        del w8, s8, w_deq
        torch.cuda.empty_cache()
    for dtype, M, K, N, label in (
            (torch.bfloat16, 1008, 204, 336, "off TMA"),
            (torch.float32, 1008, 20480, 2048, "long K")):
        w8, s8 = qm.quantize_channelwise(
            torch.randn(K, N, generator=gen, device=dev) * 0.02)
        b = (torch.randn(N, generator=gen, device=dev) * 0.02).to(dtype)
        w_deq = (w8.float() * (s8 / 127.0)).to(dtype)
        x = torch.randn(M, K, generator=gen, device=dev).to(dtype)
        key = (f"M{M} K{K} N{N} ({label}) bias "
               f"{'bf16' if dtype == torch.bfloat16 else 'f32'}")
        try:
            wo[key] = timed(lambda: qm.int8_weight_only_matmul(x, w8, s8, b),
                            lambda: torch.addmm(b, x, w_deq), "wo_ge")
        except RuntimeError as e:   # a checkout whose kernel refuses it
            wo[key] = dict(error=str(e))
        print(json.dumps({key: wo[key]}), flush=True)
        del w8, s8, w_deq, x
        torch.cuda.empty_cache()
    out.update(flash_fwd_f32=flash, wo_matmul_f32=wo)
    return out


def ptq_serving(cs, torch):
    import numpy as np
    from paddle2_tpu_torch.kernels import quant_matmul as qm
    from paddle2_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
    from paddle2_tpu_torch.serving import EngineConfig, ServingEngine
    cfg = gpt3_1p3b()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (17, 45, 130, 257, 401, 613, 850, 1000)]
    model = GPTForCausalLM(cfg, seed=1234).to(torch.bfloat16)
    quanted = cs.ptq_convert(model, prompts)
    econf = EngineConfig(block_size=16, num_blocks=1024, max_batch=8,
                         kv_dtype="bfloat16")
    runs = []
    for _ in range(2):
        _, launches, st = cs.serve(model, econf, prompts, 32)
        prof = st["step_profile"] or {}
        routes = getattr(qm.int8_matmul, "route_launches", None)
        runs.append(dict(prefill_tok_s=st["prefill_tok_s"],
                         decode_tok_s=st["decode_tok_s"],
                         ttft_mean_s=st["ttft_mean_s"],
                         ttft_max_s=st["ttft_max_s"],
                         prefills=st["prefills"],
                         decode_steps=st["decode_steps"],
                         i8i8_launches=launches["i8i8_matmul"],
                         i8i8_route_launches=None if routes is None
                         else dict(routes),
                         serve_decode_step_device_ms=prof.get("device_ms"),
                         serve_decode_step_by_group=prof.get("by_group"),
                         serve_decode_step_idle_share=prof.get(
                             "idle_share")))
    print(json.dumps(dict(quanted_linears=quanted, serve=runs[1])),
          flush=True)

    def traced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_group = cs.device_groups(prof, cs.SERVING_GROUPS)
        evs = sorted((e for e in prof.key_averages()
                      if e.device_time_total > 0),
                     key=lambda e: -e.device_time_total)
        return out, dict(wall_ms=wall * 1e3, device_ms=sum(by_group.values()),
                         by_group=by_group,
                         top=[(e.key[:70], e.device_time_total / 1e3, e.count)
                              for e in evs[:12]])
    eng = ServingEngine(model, econf)
    eng.submit(prompts[-1], 1)
    _, prefill = traced(lambda: eng.admit_and_prefill(now=0.0))
    print(json.dumps(dict(traced_prefill_1000=prefill)), flush=True)
    del eng
    eng = ServingEngine(model, econf)
    for p in prompts:
        eng.submit(p, 32)
    step = 0
    while step < 20:
        eng.admit_and_prefill(now=float(step))
        d = eng.decode_once(now=float(step))
        step += 1
        if d and d["tokens"] == len(prompts):
            break
    walls = []
    for i in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = eng.decode_once(now=float(step))
        torch.cuda.synchronize()
        if i >= 5:
            walls.append((time.perf_counter() - t0) * 1e3)
        step += 1
    d, decode = traced(lambda: eng.decode_once(now=float(step)))
    decode.update(batch=d["tokens"], untraced_step_ms=statistics.mean(walls),
                  idle_share=1.0 - decode["device_ms"]
                  / statistics.mean(walls))
    print(json.dumps(dict(traced_decode_step=decode)), flush=True)
    del eng, model
    torch.cuda.empty_cache()

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    kernels = {}
    for label in ("qkv", "out_proj", "up", "down"):
        K, N = cs.WO_SHAPES[label]
        w = torch.randint(-128, 128, (K, N), generator=gen, device=dev,
                          dtype=torch.int8)
        for M in (8, 32, 144, 1008):
            x = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                              dtype=torch.int8)
            run = lambda: qm.int8_matmul(x, w)   # noqa: E731
            device, kernel = cs.device_ms(run, "i8i8")
            key = f"M{M} K{K} N{N} ({label})"
            kernels[key] = dict(events_ms=cs.cuda_ms(run), device_ms=device,
                                kernel_device_ms=kernel,
                                host_ms=_host_ms(torch, run))
            if M > 16:
                mm = lambda: torch._int_mm(x, w)   # noqa: E731
                kernels[key].update(int_mm_events_ms=cs.cuda_ms(mm),
                                    int_mm_device_ms=cs.device_ms(mm, "")[0])
            print(json.dumps({key: kernels[key]}), flush=True)
        del w
        torch.cuda.empty_cache()
    return dict(quanted_linears=quanted, serve=runs[1], serve_first=runs[0],
                traced_prefill_1000=prefill, traced_decode_step=decode,
                kernels=kernels)


def train_bf16(cs, smi):
    run, _ = cs.train_bf16(smi)
    return dict(tokens_per_s=run["bench"]["value"],
                step_time_s=run["bench"]["step_time_s"],
                step_times_s=run["step_times_s"],
                first_step_s=run["first_step_s"],
                step_profile=run["step_profile"])


def core(cs, torch):
    """The smoke's phase 18 after phase 4's bf16 serving run."""
    import numpy as np
    cfg = cs.gpt3_1p3b()
    rng = np.random.default_rng(0)
    lens = [17, 45, 130, 257, 401, 613, 850, 1000]
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in lens]
    new = 32
    model = cs.GPTForCausalLM(cfg, seed=1234).to(torch.bfloat16)
    gens16, _, _ = cs.serve(model, cs.EngineConfig(
        block_size=16, num_blocks=1024, max_batch=8, kv_dtype="bfloat16"),
        prompts, new)
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec, launches = cs.phase18(torch.device("cuda:0"), prompts, new, gens16)
    rec["phase_s"] = time.perf_counter() - t0
    rec["ops"].pop("max_err")
    return rec


def nn_transformer(cs, torch, smi):
    """The smoke's phase 20 (a)-(b) alone: the default ``nn.Transformer``
    trained in bf16 O2 with ``FLAGS_pallas_layer_norm`` on, with that
    checkout's launch gates."""
    with cs.on_card(pallas_layer_norm=True):
        rec, launches, _ = cs.nn_transformer_bf16(smi)
    rec["launches"] = {n: v for n, v in launches.items() if v}
    for key in ("device", "nvidia_smi"):     # the line's own
        rec.pop(key)
    return rec


def vision_rnn(cs, torch, smi):
    """The smoke's phase 21 after phase 10's ResNet-50 run."""
    with cs.on_card(fused_optimizer_step=True):
        resnet, _ = cs.resnet50_bf16(smi)
    torch.cuda.empty_cache()
    rec, launches = cs.phase21(smi, resnet)
    rec["launches"] = {n: v for n, v in launches.items() if v}
    return rec


def obs_remat(cs, smi):
    """The smoke's phase 22 alone."""
    rec, launches = cs.phase22(smi)
    rec["launches"] = {n: v for n, v in launches.items() if v}
    return rec


def fleet(cs, smi):
    """The smoke's phase 23 alone."""
    rec, _ = cs.phase23(smi)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", required=True,
                    choices=("int8_serving", "varlen_step",
                             "varlen_bwd_draws", "norms", "flash_bwd_f32",
                             "train_bf16", "adamw_step", "f32_prefill",
                             "paged_decode", "ptq_serving", "f32_decode",
                             "plain_serving", "core", "nn_transformer",
                             "vision_rnn", "obs_remat", "fleet"))
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
    elif args.phase == "norms":
        result = norms(cs, torch)
    elif args.phase == "flash_bwd_f32":
        result = flash_bwd_f32(cs, torch)
    elif args.phase == "train_bf16":
        result = train_bf16(cs, smi)
    elif args.phase == "adamw_step":
        result = adamw_step(cs, torch)
    elif args.phase == "f32_prefill":
        result = f32_prefill(cs, torch)
    elif args.phase == "paged_decode":
        result = paged_decode(cs, torch)
    elif args.phase == "ptq_serving":
        result = ptq_serving(cs, torch)
    elif args.phase == "f32_decode":
        result = f32_decode(cs, torch)
    elif args.phase == "plain_serving":
        result = plain_serving(cs, torch)
    elif args.phase == "core":
        result = core(cs, torch)
    elif args.phase == "nn_transformer":
        result = nn_transformer(cs, torch, smi)
    elif args.phase == "vision_rnn":
        result = vision_rnn(cs, torch, smi)
    elif args.phase == "obs_remat":
        result = obs_remat(cs, smi)
    elif args.phase == "fleet":
        result = fleet(cs, smi)
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
