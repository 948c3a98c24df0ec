#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle2_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA GPU, nvcc
(``$CUDA_HOME`` or ``/usr/local/cuda``) and PyTorch built for CUDA.
Phases, each of which fails the run (non-zero exit, no final ``ok``
line) when it fails:

1. Device: the card's name and power limit.
2. Build: every kernel under ``paddle2_tpu_torch/**/csrc`` with nvcc,
   in parallel, from the sources in the checkout; the SASS of the five
   tensor-core libraries (``flash_fwd_wgmma``, ``flash_bwd_wgmma``,
   ``flash_varlen_wgmma``, ``flash_varlen_bwd_wgmma``,
   ``wo_matmul_wgmma``) must hold HGMMA (wgmma)
   instructions, and ptxas's registers and spills for their kernels are
   printed.
3. Kernels against their plain versions, on the card, at the main
   path's shapes: the flash forward (B1 H16 D128, S 128/1024/2048,
   causal; bf16 on the tensor-core kernel, f32 on the CUDA-core one),
   the paged decode and the split-K paged decode (B8 H16 D128, block
   16, contexts up to 2048), in bf16 and f32. Each prints its error
   against its tolerance, its median time from CUDA events, its device
   time from torch.profiler (all kernels of the call, and the port's
   kernel alone), the plain version's time, one library call's time
   where one computes the same function, its bound, and its launches.
   The flash backward (both routes: the fused kernel and the split
   dK/dV + dQ pair) at the training path's shape (B8 H16 S1024 D64,
   causal) in bf16 and f32 and at Sq 200 / Sk 333; the fused route
   alone (the bf16 route) at the serving shapes, at the incubate
   stack's (B8 H16 S2048 D128, timed with the forward and SDPA beside
   it) and at S 127 and 129; the forward at those ragged shapes; all
   at head dims 16/64/128. The bf16 fused backward (tensor cores,
   another summation order) is held to the plain version's f32 sums
   beyond half a bf16 step, the split pair to the plain version in the
   input dtype, both with a limit that the plain backward without its
   P/dS rounding must exceed; the fused AdamW step against the port's
   eager AdamW, bitwise (``torch.equal``), three steps on the training
   path's 16 parameter leaves (f32, and bf16 with f32 masters), and
   one step over the 16 f32 leaves timed against
   ``torch._fused_adamw_``. The fused momentum step against the port's
   eager Momentum, bitwise, three steps on ResNet-50's 161 parameter
   shapes (f32 plain, Nesterov, L2 decay 1e-4, bf16 with f32 masters,
   and ResNet-50's O2 list: bf16 convolutions and fc with f32 masters,
   f32 BatchNorm, L2 1e-4 but on the 1-D tensors), one launch a step;
   and one multi-tensor step over the 161 f32 tensors timed against
   ``torch._fused_sgd_`` (CUDA events and device time for both).
   The int8 weight-only matmul at GPT-3 1.3B's five projection shapes
   (qkv, out_proj, up, down, the tied head) at M 1, 8, 128 and 1008, in
   bf16 and f32, with and without a bias (bf16 at M 128 and 1008 on the
   tensor-core route), and at ragged shapes (M 3, K 200, N 333 on the
   CUDA cores; M 37, K 200, N 336 on the tensor cores), timed against
   ``torch.mm`` over the weight dequantized beforehand (and
   ``torch._weight_int8pack_mm`` where this torch has it on CUDA), with
   the wrapper's host time a call; every int8 value through the
   tensor-core route's widening, ``torch.equal`` to the plain version.
   Then, on the serving model's real weights and the activations that
   reach them on one prompt: the kernel's product
   stays within ``weight_quant_error_bound`` of ``x @ W`` (f64, on the
   host), a 4-bit payload of the same weight breaks that bound, and the
   bound is below ``max |x @ W|``; and layer 0's payload and scales
   quantized on the card equal those quantized on the CPU, bitwise.
   The int8 x int8 matmul at GPT-3 1.3B's four block projections (qkv,
   out_proj, up, down) at M 8 (a decode step) and M 1008 (a 1000-token
   prompt's padded prefill), at a ragged shape (M 3, K 200, N 333) and
   all-+-127 at K 8192 (the largest sums), ``torch.equal`` to its plain
   version (the integers are exact), timed against ``torch._int_mm``
   where that call takes the shape (M > 16, K and N multiples of 8); and
   ``int4_weight_only_matmul`` at the up projection (M 8, bf16 and f32)
   against the plain weight-only version on the unpacked payload.
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
   rise during the engine runs. Then two runs with
   ``weight_only_int8=True, weight_only_lm_head=True`` (the engine
   quantizes the model in place) over the same seed's model, in f32 and
   in bf16: tokens held against the quantized model's dense
   ``generate`` by the same near-tie rule, f32 first-token logits
   against the quantized model on the CPU at atol 1e-3, ``wo_matmul``
   launched 97 times (96 projections and the head) for every prefill
   and every decode step, the 96 projections of a bf16 prefill on the
   tensor-core route (none in f32); how many tokens agree with the fp
   runs is printed, not gated.
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
7. Fine-tuning at full width and full depth with
   ``FLAGS_pallas_layer_norm`` on: ``bench.py``'s ``bench_ernie``
   (ERNIE-3.0-base, vocab 40000, hidden 768, 12 layers, 12 heads of 64,
   dropout off, stacked blocks, AMP O2 bf16, ``AdamW(2e-5,
   multi_precision=True)`` with ``fused=None``, seq 128, batch 32, ids
   and labels from ``RandomState(0)``) through ``jit.train_step``: 1
   warm-up step, 5 timed steps and 1 traced step. Every loss must be
   finite; each step must launch ``layer_norm_fwd`` and
   ``layer_norm_bwd`` exactly 25 times (``emb_ln`` with f32 and 24
   stacked LayerNorms with bf16 scale and shift), ``flash_fwd`` and the
   bf16 backward route's kernel 12 times, and ``adamw_step`` never.
   Prints a ``bench_ernie``-style line (tokens/s, step time, MFU
   against 989 TFLOP/s).
8. Padded batches: three more steps of that model with an
   ``attention_mask`` from row lengths 16..128: finite losses, the
   LayerNorm kernels 25 times each a step, attention on the masked
   route (no flash launch).
9. ERNIE on the card against the CPU: ``num_layers=2`` in f32 with the
   flag on, batch 8: two ``train_step`` calls; losses to 1e-4 relative,
   the first step's gradients to 1e-4 of each gradient's largest
   magnitude, and a padded forward (sequence output, pooled output,
   logits) to 1e-4.

10. Image classification at full width and full depth with
    ``FLAGS_fused_optimizer_step`` on: ``bench.py``'s
    ``bench_resnet50`` on its chip profile (BASELINE config 1):
    ``resnet50(num_classes=1000)`` (25.56 M parameters in 161 tensors),
    AMP O2 bf16, ``Momentum(0.1, 0.9, multi_precision=True)`` with
    ``fused=None``, batch 128 of 224x224 images and labels from
    ``RandomState(0)``, through ``jit.train_step``: 1 warm-up step, 5
    timed steps and 1 traced step. Every loss must be finite; each step
    must launch ``momentum_step`` exactly once (every tensor in one
    multi-tensor launch) and no other kernel.
    Prints a ``bench_resnet50``-style line (images/s, step time, MFU
    against 989 TFLOP/s by the bench's 4.1 GFLOPs an image and by 2
    FLOPs a multiply-add), the traced step's device time by kernel
    group, and the step time with ``torch.backends.cudnn.benchmark`` on.
11. ResNet on the card against the CPU: ``resnet18(num_classes=10)``
    in f32, 64x64 images, batch 4 (the bench's CPU profile),
    ``Momentum(fused=True)``: two ``train_step`` calls; losses to 1e-4
    relative, the first step's gradients to 1e-4 of each gradient's
    largest magnitude, every BatchNorm buffer after both steps and an
    eval-mode forward's logits to 1e-4, ``momentum_step`` once a
    step; the CPU's own f32 gradients against f64 are recorded beside.

12. Packed varlen attention's four kernels against their plain
    versions, in phase 3's rows: GPT-3 1.3B's attention geometry (H16
    D128, causal) in bf16 and f32 on two packed batches, the README's
    1x2048 + 16x128 (T 4096) and the serving prompt lengths (T 3313),
    and the bench GPT's H16 D64 on the first; ragged cases (non-causal,
    a length-1 sequence, ``cu_seqlens_q != cu_seqlens_k`` with a
    sequence whose rows see no key, a last sequence ending mid-tile,
    lengths 1/127/129/255 around the tensor-core forward's 128-row
    blocks with ``len_k < len_q``, causal and not) at head dims
    16/64/128, and in bf16 both timed batches at head dims 16/64/128,
    causal and not, not timed. The bf16 forward runs on the tensor cores
    (``flash_varlen_wgmma``), the f32 one and the backward pair on the
    CUDA cores, the backward from the forward's own ``lse``; in bf16
    the fused backward (``flash_varlen_bwd_wgmma``, the tensor cores)
    runs at every case beside the pair. Each backward is held against
    the plain version's f32 sums, beyond half a step of its dtype (the
    one rounding both do): the pair by its largest error, the fused
    kernel (whose dS near ties flip whole rows) by the share of
    elements that are not the f32 sums correctly rounded
    (``varlen_bwd_stats``), its largest error reported. Rows that see
    no key must get dq = 0 and keys no row sees dk = dv = 0, and in
    bf16 the plain backward without its P/dS rounding must fail both
    limits; the f32 backward runs twice, bitwise equal. The fused backward also runs on
    inputs drawn from {-1, 0, 1}, where every sum is exact, at every
    ragged case, at both timed batches at head dims 16/64/128 causal and
    not, and on batches with sequences of no rows or no keys, and must
    equal the plain f32 sums to 1e-5. Each timed row has the
    kernel's CUDA-event and device times, the plain version's, one
    ``scaled_dot_product_attention`` over the packed rows as ``[1, H, T,
    D]`` with the block-diagonal causal mask (forward, or its backward)
    as the library yardstick, by CUDA events and by device time, its
    bound and its launches; the densify route's forward time is printed
    beside the packed route's. A bf16 packed batch whose q, k and v are
    contiguous views 2 bytes past a 16-byte boundary goes through
    ``flash_attention_varlen_packed`` and must equal, bitwise, the same
    call on aligned copies.
13. Packed varlen training at full width through the public entry
    points: two GPT-3 1.3B-width self-attention layers (hidden 2048, 16
    heads of 128; qkv ``Linear``, ``nn.functional.flash_attn_unpadded``
    causal, out ``Linear``, no biases, residual), AMP O2 bf16,
    ``AdamW(1e-4, multi_precision=True, fused=True)`` through
    ``jit.train_step(..., layers=[model])``, a squared-error loss, 1
    warm-up step, 5 timed steps, 1 traced step and the first batch
    again (each batch lengths of 16..2048 from ``RandomState(0)``
    packed to <= 8192 tokens); every loss finite, the varlen forward
    and the fused backward launched 2 times a step, the split backward
    pair never, ``adamw_step`` 4 times, no dense flash kernel, the
    repeated batch hits the ``cu_seqlens`` memo. One more
    step, on an eighth batch, is traced on the host alone: its host ops
    by self CPU time are printed (not gated, and its launches are not
    counted). Then
    ``flash_attn_varlen_qkvpacked`` equals the unpacked call, and a call
    with dropout 0.1 in training and one inside
    ``sdp_kernel(enable_flash=False)`` take the densify route (no varlen
    launch). Then the card against the CPU in f32 (H4 D64, lengths 1, 7,
    64, 100, 200, causal and not): the output and the q/k/v gradients to
    1e-4 of each tensor's largest magnitude, through the forward and the
    split pair (2 launches each, none of the fused backward).

14. The incubate slice at full width: a two-layer pre-norm decoder
    stack at GPT-3 1.3B's width (hidden 2048, 16 heads of 128, SwiGLU
    FFN ``W_1 [2048, 16384]``, ``W_2 [8192, 2048]``; 134.2 M parameters
    in 13 tensors), built here from the public functionals
    (``incubate.nn.functional.fused_rms_norm``, its residual form,
    ``fused_rotary_position_embedding(use_neox_rotary_style=False)``,
    ``swiglu``, ``nn.functional.flash_attention`` causal), bf16
    parameters with f32 masters and f32 m/v, on ``[8, 2048, 2048]`` bf16
    inputs from a seeded generator and a squared-error loss against
    targets from ``RandomState(0)``; each step is ``loss.backward()``
    then one ``fused_adamw_kernel`` (lr 1e-4) a tensor, its outputs
    copied back: 1 warm-up step, 5 timed steps and 1 traced step. Every
    loss finite; each step launches exactly 5 RMSNorm forwards, 5
    RMSNorm backwards, 8 RoPE (4 forward, 4 backward), 13 flat AdamW, 2
    dense flash forwards and 2 fused flash backwards, and no other
    kernel. Prints tokens/s, the step time, the traced step's device
    time by kernel group and the idle share. Then a neox-style call
    launches no RoPE kernel, and ``position_ids`` 100..103 on a sequence
    of 4 equal the matching window of a longer sequence.
15. The stack on the card against the CPU in f32 (hidden 256, 4 heads
    of 64, seq 256, batch 2, FFN 1024): two loop steps on each device
    from the same numpy weights; losses to 1e-4 relative, the first
    step's gradients to 1e-4 of each tensor's largest magnitude, and
    every parameter, m, v and master after both steps to 1e-5 of its
    largest magnitude.
16. PTQ full-int8 serving at full width (run after phase 4): the seed's
    GPT-3 1.3B (24 layers, per-block storage) in f32 and in bf16, each
    block through ``PTQ(QuantConfig(FakeQuanterWithAbsMaxObserver,
    FakeQuanterChannelWiseAbsMaxObserver)).quantize``, calibrated by one
    dense forward over each of phase 4's prompts, converted (96
    ``QuantedInferenceLinear``, checked) and served as in phase 4:
    ``i8i8_matmul`` launched 96 times a prefill and a decode step,
    ``wo_matmul`` never, ``flash_fwd`` and ``paged_decode`` launched.
    Activation quantization makes the model a step function of its f32
    activations: a value within f32 noise of a rounding boundary rounds
    one way on one path and the other way on another, and a few such
    flips move the logits by up to ~0.2. So the tokens are held against
    the dense path fed the served int8 inputs: the engine is run again
    one request at a time, recording every ``QuantedInferenceLinear``'s
    int8 input, and the dense greedy loop of each request multiplies
    those inputs; its tokens must equal the one-at-a-time run's and the
    batched run's but at near ties of phase 4's rule (the dense replay's
    top-2 margin there). The dense path rounding its own inputs is
    compared too, for information (first mismatches and margins). In
    f32 two prompts' first-token logits are held against the CPU the
    same way: with the card's int8 inputs replayed on the CPU to phase
    4's atol 1e-3 (f32 sums in another order), and free, for
    information, with the flips counted (layer 0 and all layers).
    Printed, not gated: decode and prefill tokens/s, TTFT, peak memory,
    a traced decode step's device time by kernel group with the idle
    share, and the tokens that agree with phase 4's fp runs.

Phase 3 also holds the slice's kernels against their plain versions:
the RMSNorm forward and backward at the ``fused_rms_norm`` docstring's
[8192, 1024] and the stack's [16384, 2048] (bf16, f32, bf16 x with an
f32 weight) and ragged [37, 200], [64, 8192] and [5, 1] (bf16 within one
ulp plus 1e-5 of the largest magnitude, f32 to 1e-5 of the largest
magnitude, two f32 backward runs bitwise equal), timed against
``F.rms_norm`` (forward, and its backward through autograd); the RoPE
forward and backward bitwise at the docstring's [8, 2048, 16, 128] with
an [S, D] table and a ``position_ids``-gathered [B*S, D] one, and at D
64 with an odd H, in bf16 and f32 (no single torch call computes it);
the flat AdamW bitwise on its four outputs at 84 M elements with f32
and with bf16 params and grads, and at 513, timed against
``torch._fused_adamw_`` over an f32 master/m/v of the same N (another
decay order: a yardstick of time only).

Phase 3 also holds the fused LayerNorm's forward and backward against
their plain versions at ERNIE's [4096, 768] (bf16 x with f32 and with
bf16 scale and shift, and f32), the GPT bench's [8192, 1024] (bf16 and
f32), ERNIE's shape under AMP float16 (f16 x with f32 and with f16
scale and shift), and ragged [37, 200], [64, 8192] and [5, 1]: a bf16
or f16 output within one ulp of its type (plus 1e-5 of the tensor's
largest magnitude where sums cancel), f32 to 1e-5 (dγ and dβ to 1e-5 of their largest magnitude),
and two f32 backward runs bitwise equal. Each timed shape records both
kernels' times, bounds and ``F.layer_norm``'s (forward; backward
through autograd).

Each main-path run (the serving runs, the training runs, the ERNIE
runs, the ResNet runs, the varlen runs, the incubate stack runs, the
PTQ runs) starts with every launch count at 0 and is read just after;
the kernel checks' launches (and the PTQ phase's one-at-a-time and
dense replays) are not counted.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. A full record of the run is written
to ``chiprun_out/chip_smoke.json``.
"""

import copy
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.nn import functional as F

from paddle2_tpu_torch import amp, flags, jit
from paddle2_tpu_torch.kernels import _build
from paddle2_tpu_torch.kernels.flash_attn import (
    bwd_route, flash_bwd, flash_bwd_fused, flash_bwd_reference,
    flash_bwd_split_dkv, flash_bwd_split_dq, flash_fwd, flash_fwd_reference)
from paddle2_tpu_torch.kernels.flash_varlen import (
    flash_attention_varlen_packed, flash_varlen_bwd_dkv,
    flash_varlen_bwd_dkv_reference, flash_varlen_bwd_dq,
    flash_varlen_bwd_dq_reference, flash_varlen_bwd_fused,
    flash_varlen_bwd_fused_reference, flash_varlen_fwd,
    flash_varlen_fwd_reference)
from paddle2_tpu_torch.kernels.fused_adamw import (
    adamw_flat, adamw_flat_reference, adamw_step, adamw_step_reference,
    stage_flat_scalars, stage_scalars)
from paddle2_tpu_torch.kernels.fused_layer_norm import (
    bwd_blocks, layer_norm_bwd, layer_norm_bwd_reference, layer_norm_fwd,
    layer_norm_fwd_reference)
from paddle2_tpu_torch.kernels.fused_momentum import (
    momentum_step, momentum_step_multi, momentum_step_reference)
from paddle2_tpu_torch.kernels import fused_rms_norm as frn
from paddle2_tpu_torch.kernels.fused_rms_norm import (
    rms_norm_bwd, rms_norm_bwd_reference, rms_norm_fwd,
    rms_norm_fwd_reference)
from paddle2_tpu_torch.kernels.fused_rope import rope, rope_reference
from paddle2_tpu_torch.kernels.quant_matmul import (
    i8i8_split, int4_weight_only_matmul, int8_matmul, int8_matmul_reference,
    int8_weight_only_matmul, int8_weight_only_matmul_reference, pack_int4,
    quantize_channelwise, unpack_int4, weight_quant_error_bound, wo_route)
from paddle2_tpu_torch.incubate.nn import functional as IF
from paddle2_tpu_torch.models import (ErnieForSequenceClassification,
                                      GPTConfig, GPTForCausalLM, ernie3_base,
                                      gpt3_1p3b)
from paddle2_tpu_torch.nn.functional import (cross_entropy,
                                             flash_attn_unpadded,
                                             flash_attn_varlen_qkvpacked,
                                             sdp_kernel)
from paddle2_tpu_torch.nn.functional import flash_attention as fa
from paddle2_tpu_torch.optimizer import AdamW, Momentum
from paddle2_tpu_torch import quantization
from paddle2_tpu_torch.quantization import (
    PTQ, FakeQuanterChannelWiseAbsMaxObserver, FakeQuanterWithAbsMaxObserver,
    QuantConfig, QuantedInferenceLinear, weight_only_quantize)
from paddle2_tpu_torch.serving import EngineConfig, ServingEngine
from paddle2_tpu_torch.serving.paged_attention import (
    _merge_splits, paged_attention_reference,
    paged_attention_split_reference, paged_decode,
    paged_decode_split_partials)
from paddle2_tpu_torch.vision.models import resnet18, resnet50

# published H100 SXM peaks (NVIDIA data sheet, dense): f32 without TF32
# runs on the CUDA cores; int8 on the tensor cores
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
            torch.int8: 1979e12}
HBM_BYTES_PER_S = 3.35e12
# f32: sums of up to 2048 terms in another order than the plain
# version; bf16: outputs and probabilities are rounded to bf16
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# the flash backward's dq/dk/dv, absolute below 1 and relative above.
# bf16: the split pair (CUDA cores, the plain version's summation order)
# reads 0 at the training shape against the plain version in bf16; the
# fused tensor-core kernel is held against the plain version's f32 sums
# beyond half a bf16 step (half_step_err); the plain backward without
# the P/dS rounding reads above the limit under both (checked on every
# timed run)
BWD_TOL = {torch.bfloat16: 5e-3, torch.float32: 1e-4}
# the fused varlen backward (tensor cores, bf16) on random inputs: the
# share of dq/dk/dv elements that are not the plain f32 sums correctly
# rounded (varlen_bwd_stats). Its largest error is reported, not gated:
# a dS element whose tensor-core sum lands on the other side of a bf16
# rounding boundary moves whole rows, so single draws read past BWD_TOL
# while the share stays near 2e-3 (H100: 3e-5..5.7e-3 over 37 draws of
# the smoke's batches); the plain backward without P/dS rounding reads
# 0.37-0.42 (phase_runner.py --phase varlen_bwd_draws)
VARLEN_OFF_SHARE = 0.05
NEAR_TIE = 1e-3
# bf16 logits carry bf16 rounding (2**-6 at magnitudes 2..4), and the
# paged and the dense attention round at different places: a near tie
# in bf16 is a top-2 margin under 4 such steps
NEAR_TIE_BF16 = 0.0625
OUT = Path("chiprun_out")

KERNELS = {
    "flash_fwd": dict(
        source="paddle2_tpu_torch/kernels/csrc/flash_fwd_wgmma.cu",
        f32_source="paddle2_tpu_torch/kernels/csrc/flash_fwd.cu",
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
        source="paddle2_tpu_torch/kernels/csrc/flash_bwd_wgmma.cu",
        f32_source="paddle2_tpu_torch/kernels/csrc/flash_bwd.cu",
        replaces="paddle2_tpu/kernels/pallas_flash.py:265",
        counter=flash_bwd_fused),
    "adamw_step": dict(
        source="paddle2_tpu_torch/kernels/csrc/adamw_step.cu",
        replaces="paddle2_tpu/kernels/pallas_fused.py:125",
        counter=adamw_step),
    # every route of the weight-only wrapper (decode, f32 prefill, and
    # the tensor-core route counted again below)
    "wo_matmul": dict(
        source="paddle2_tpu_torch/kernels/csrc/wo_matmul.cu",
        replaces="paddle2_tpu/kernels/pallas_matmul.py:155",
        counter=int8_weight_only_matmul),
    "wo_matmul_wgmma": dict(
        source="paddle2_tpu_torch/kernels/csrc/wo_matmul_wgmma.cu",
        replaces="paddle2_tpu/kernels/pallas_matmul.py:155",
        counter=int8_weight_only_matmul, route="wgmma"),
    "layer_norm_fwd": dict(
        source="paddle2_tpu_torch/kernels/csrc/layer_norm.cu",
        replaces="paddle2_tpu/kernels/pallas_ln.py:55",
        counter=layer_norm_fwd),
    "layer_norm_bwd": dict(
        source="paddle2_tpu_torch/kernels/csrc/layer_norm.cu",
        replaces="paddle2_tpu/kernels/pallas_ln.py:65",
        counter=layer_norm_bwd),
    "momentum_step": dict(
        source="paddle2_tpu_torch/kernels/csrc/momentum_step.cu",
        replaces="paddle2_tpu/kernels/pallas_fused.py:209",
        counter=momentum_step),
    "flash_varlen_fwd": dict(
        source="paddle2_tpu_torch/kernels/csrc/flash_varlen_wgmma.cu",
        f32_source="paddle2_tpu_torch/kernels/csrc/flash_varlen.cu",
        replaces="paddle2_tpu/kernels/pallas_flash.py:546",
        counter=flash_varlen_fwd),
    "flash_varlen_bwd_dkv": dict(
        source="paddle2_tpu_torch/kernels/csrc/flash_varlen.cu",
        replaces="paddle2_tpu/kernels/pallas_flash.py:578",
        counter=flash_varlen_bwd_dkv),
    "flash_varlen_bwd_dq": dict(
        source="paddle2_tpu_torch/kernels/csrc/flash_varlen.cu",
        replaces="paddle2_tpu/kernels/pallas_flash.py:620",
        counter=flash_varlen_bwd_dq),
    # the bf16 backward's route: both varlen backward kernels in one
    "flash_varlen_bwd_fused": dict(
        source="paddle2_tpu_torch/kernels/csrc/flash_varlen_bwd_wgmma.cu",
        replaces="paddle2_tpu/kernels/pallas_flash.py:578",
        also_replaces="paddle2_tpu/kernels/pallas_flash.py:620",
        counter=flash_varlen_bwd_fused),
    "rms_norm_fwd": dict(
        source="paddle2_tpu_torch/kernels/csrc/rms_norm.cu",
        replaces="paddle2_tpu/kernels/pallas_fused.py:262",
        counter=rms_norm_fwd),
    "rms_norm_bwd": dict(
        source="paddle2_tpu_torch/kernels/csrc/rms_norm.cu",
        replaces="paddle2_tpu/kernels/pallas_fused.py:290",
        counter=rms_norm_bwd),
    "rope": dict(
        source="paddle2_tpu_torch/kernels/csrc/rope.cu",
        replaces="paddle2_tpu/kernels/pallas_fused.py:369",
        counter=rope),
    "adamw_flat": dict(
        source="paddle2_tpu_torch/kernels/csrc/adamw_flat.cu",
        replaces="paddle2_tpu/kernels/pallas_fused.py:32",
        counter=adamw_flat),
    "i8i8_matmul": dict(
        source="paddle2_tpu_torch/kernels/csrc/i8i8_matmul.cu",
        replaces="paddle2_tpu/kernels/pallas_matmul.py:252",
        counter=int8_matmul),
}
INCUBATE_KERNELS = ("rms_norm_fwd", "rms_norm_bwd", "rope", "adamw_flat")
VARLEN_KERNELS = ("flash_varlen_fwd", "flash_varlen_bwd_dkv",
                  "flash_varlen_bwd_dq", "flash_varlen_bwd_fused")
DENSE_FLASH_KERNELS = ("flash_fwd", "flash_bwd_fused", "flash_bwd_split_dkv",
                       "flash_bwd_split_dq")
# the CUDA kernel each dense flash wrapper launches, by dtype (the names
# torch.profiler reports): bf16 on the tensor cores, f32 on the CUDA cores
FLASH_KERNEL_NAMES = {
    ("flash_fwd", torch.bfloat16): "flash_fwd_wgmma_kernel",
    ("flash_fwd", torch.float32): "flash_fwd_kernel",
    ("flash_bwd_fused", torch.bfloat16): "flash_bwd_fused_wgmma_kernel",
    ("flash_bwd_fused", torch.float32): "flash_bwd_fused_kernel",
    ("flash_bwd_split_dkv", torch.bfloat16): "flash_bwd_dkv_kernel",
    ("flash_bwd_split_dkv", torch.float32): "flash_bwd_dkv_kernel",
    ("flash_bwd_split_dq", torch.bfloat16): "flash_bwd_dq_kernel",
    ("flash_bwd_split_dq", torch.float32): "flash_bwd_dq_kernel"}
# the CUDA kernel each varlen wrapper launches, by dtype
VARLEN_KERNEL_NAMES = {
    ("flash_varlen_fwd", torch.bfloat16): "flash_varlen_fwd_wgmma_kernel",
    ("flash_varlen_fwd", torch.float32): "flash_varlen_fwd_kernel",
    ("flash_varlen_bwd_dkv", torch.bfloat16): "flash_varlen_dkv_kernel",
    ("flash_varlen_bwd_dkv", torch.float32): "flash_varlen_dkv_kernel",
    ("flash_varlen_bwd_dq", torch.bfloat16): "flash_varlen_dq_kernel",
    ("flash_varlen_bwd_dq", torch.float32): "flash_varlen_dq_kernel",
    ("flash_varlen_bwd_fused", torch.bfloat16):
        "flash_varlen_bwd_fused_wgmma_kernel"}
# the libraries of the tensor-core kernels, whose SASS must hold HGMMA
WGMMA_LIBRARIES = ("flash_fwd_wgmma", "flash_bwd_wgmma", "flash_varlen_wgmma",
                   "flash_varlen_bwd_wgmma", "wo_matmul_wgmma")
SERVING_KERNELS = ("flash_fwd", "paged_decode", "paged_decode_split")
# GPT-3 1.3B's weight-only projections, K x N ([in, out])
WO_SHAPES = {"qkv": (2048, 6144), "out_proj": (2048, 2048),
             "up": (2048, 8192), "down": (8192, 2048), "head": (2048, 50304)}
# the kernels line's wo_matmul rows: a bf16 decode step at batch 8, and
# a 1000-token prompt's prefill (padded to 1008) on the tensor cores
WO_LINE_SHAPE = "M8 K2048 N8192 (up) bias"
WO_WGMMA_LINE_SHAPE = "M1008 K2048 N8192 (up) bias"
# the int8 x int8 kernel's rows: GPT-3 1.3B's four block projections at a
# decode step of batch 8 and a 1000-token prompt's prefill (padded to
# 1008); the kernels line reports the decode step's up projection
I8_SHAPES = {n: WO_SHAPES[n] for n in ("qkv", "out_proj", "up", "down")}
I8_LINE_SHAPE = "M8 K2048 N8192 (up)"
# phase 16: PTQ's quanters (per-tensor activations, per-channel weights)
PTQ_QUANTERS = dict(activation=FakeQuanterWithAbsMaxObserver,
                    weight=FakeQuanterChannelWiseAbsMaxObserver)
# the training path (bench.py bench_gpt's default configuration)
# ragged flash shapes (Sq, Sk, causal): around the tensor-core kernels'
# 128-row tiles, and Sq < Sk
FLASH_RAGGED = [(200, 333, True), (200, 333, False), (127, 127, True),
                (129, 129, True)]
TRAIN = dict(vocab=32768, hidden=1024, layers=24, heads=16, seq=1024,
             batch=8)
# the fine-tuning path (bench.py bench_ernie at seq 128, batch 32)
ERNIE = dict(seq=128, batch=32)
# the image-classification path (bench.py bench_resnet50 on its chip
# profile: BASELINE config 1) and its f32 check copy (the bench's CPU
# profile: resnet18, 10 classes, 64x64, batch 4)
RESNET = dict(batch=128, size=224, classes=1000, lr=0.1, momentum=0.9)
RESNET_CHECK = dict(batch=4, size=64, classes=10)
# bench.py's forward FLOPs an image (ResNet-50's multiply-adds at 224)
RESNET_FWD_FLOPS = 4.1e9
# the fused LayerNorm's checks: rows, H, x dtype, gamma/beta dtype, what.
# The kernels line reports ERNIE's stacked leaves (24 of its 25 launches)
LN_CASES = [
    (4096, 768, torch.bfloat16, torch.float32, "ERNIE emb_ln"),
    (4096, 768, torch.bfloat16, torch.bfloat16, "ERNIE stacked leaves"),
    (8192, 1024, torch.bfloat16, torch.bfloat16, "GPT bench"),
    (4096, 768, torch.float32, torch.float32, "ERNIE f32"),
    (8192, 1024, torch.float32, torch.float32, "GPT bench f32"),
    # AMP float16: f16 activations with f32 (emb_ln) or f16 (stacked) g/b
    (4096, 768, torch.float16, torch.float32, "ERNIE emb_ln, AMP f16"),
    (4096, 768, torch.float16, torch.float16, "ERNIE stacked, AMP f16"),
]
LN_RAGGED = [(37, 200, xd, gd, "ragged") for xd in (torch.float32,
                                                    torch.bfloat16)
             for gd in (torch.float32, torch.bfloat16)] + [
    (64, 8192, torch.bfloat16, torch.float32, "widest H"),
    (5, 1, torch.float32, torch.float32, "H 1"),
    (37, 200, torch.float16, torch.float16, "ragged")]
# the packed varlen batches of phase 12: the README's ragged batch and
# the serving path's prompt lengths (T 3313, not a multiple of 8)
VARLEN_README = [2048] + [128] * 16
VARLEN_SERVING = [17, 45, 130, 257, 401, 613, 850, 1000]
VARLEN_LINE_SHAPE = "H16 D128 T4096 (1x2048 + 16x128) causal"
# ragged cases (lens_q, lens_k, causal): non-causal; a length-1 sequence
# and a last sequence ending mid-tile (T 209); len_k > len_q, and one
# sequence with len_k < len_q whose first 20 rows see no key; lengths
# around the tensor-core forward's 128-row blocks, with len_k < len_q
VARLEN_RAGGED = [([1, 7, 64, 100, 37], None, False),
                 ([1, 7, 64, 100, 37], None, True),
                 ([5, 40, 1, 30, 70], [9, 60, 3, 10, 100], True),
                 ([1, 127, 129, 255], None, False),
                 ([1, 127, 129, 255], None, True),
                 ([1, 127, 129, 255], [1, 100, 129, 200], True),
                 ([1, 127, 129, 255], [1, 100, 129, 200], False)]
# phase 13: GPT-3 1.3B's attention width, packed batches of <= 8192 tokens
VARLEN_TRAIN = dict(hidden=2048, heads=16, layers=2, max_tokens=8192,
                    min_len=16, max_len=2048)
# phase 14: a two-layer RMSNorm/RoPE/SwiGLU stack at GPT-3 1.3B's width
# (24 layers cut to 2); phase 15 its f32 check copy
STACK = dict(hidden=2048, heads=16, layers=2, ffn=8192, seq=2048, batch=8)
STACK_CHECK = dict(hidden=256, heads=4, layers=2, ffn=1024, seq=256,
                   batch=2)
STACK_LR = 1e-4
# the slice's kernel checks: the fused_rms_norm docstring's shape and the
# stack's (rows, H, x dtype, weight dtype, what); ragged ones
RMS_CASES = [(R, H, xd, wd, what)
             for R, H, what in ((8192, 1024, "docstring"),
                                (16384, 2048, "stack"))
             for xd, wd in ((torch.bfloat16, torch.bfloat16),
                            (torch.float32, torch.float32),
                            (torch.bfloat16, torch.float32))]
RMS_RAGGED = [(37, 200, xd, wd, "ragged")
              for xd, wd in ((torch.float32, torch.float32),
                             (torch.bfloat16, torch.bfloat16),
                             (torch.bfloat16, torch.float32))] + [
    (64, 8192, torch.bfloat16, torch.float32, "wide"),
    # the widest row: both kernels past 48 KB of shared memory
    (4, 16384, torch.bfloat16, torch.float32, "widest H"),
    (5, 1, torch.float32, torch.float32, "H 1")]
RMS_LINE_SHAPE = "R16384 H2048 (stack) w bf16"
# the RoPE checks: B, S, H, D, table ("S": [S, D]; "pos": gathered by
# position_ids to [B*S, D]); the docstring's shape is timed
ROPE_CASES = [(8, 2048, 16, 128, "S", True), (8, 2048, 16, 128, "pos", True),
              (2, 300, 7, 64, "S", False), (3, 17, 5, 64, "pos", False)]
ROPE_LINE_SHAPE = "B8 S2048 H16 D128, [S, D] table"
# the flat AdamW checks: N, param and grad dtype, timed
ADAMW_FLAT_CASES = [(84_000_000, torch.float32, True),
                    (84_000_000, torch.bfloat16, True),
                    (513, torch.float32, False),
                    (513, torch.bfloat16, False)]
ADAMW_FLAT_LINE_SHAPE = "N 84000000, p/g bf16"
LINE_SHAPES = {"flash_bwd_fused": "B8 H16 Sq1024 Sk1024 D64 causal",
               "wo_matmul": WO_LINE_SHAPE,
               "wo_matmul_wgmma": WO_WGMMA_LINE_SHAPE,
               "i8i8_matmul": I8_LINE_SHAPE,
               "rms_norm_fwd": RMS_LINE_SHAPE,
               "rms_norm_bwd": RMS_LINE_SHAPE,
               "rope": ROPE_LINE_SHAPE,
               "adamw_flat": ADAMW_FLAT_LINE_SHAPE,
               "flash_varlen_fwd": VARLEN_LINE_SHAPE,
               "flash_varlen_bwd_dkv": VARLEN_LINE_SHAPE,
               "flash_varlen_bwd_dq": VARLEN_LINE_SHAPE,
               "flash_varlen_bwd_fused": VARLEN_LINE_SHAPE,
               "layer_norm_fwd": "R4096 H768 (ERNIE stacked leaves) g bf16",
               "layer_norm_bwd": "R4096 H768 (ERNIE stacked leaves) g bf16"}


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


def device_ms(fn, kernel, iters=10, per_call=None):
    """Device time per call from torch.profiler (CUPTI): of every CUDA
    kernel the call launches, and of those whose name holds
    ``kernel``. With ``per_call``, the launches of ``kernel`` one call
    makes, a window that holds fewer of them (late in a long run the
    profiler has been seen to drop records) is taken again, up to three
    windows; if none is whole, both times are None (not measured)."""
    tries = 3
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.device_time_total > 0]
        ours = [e for e in evs if kernel in e.key]
        if per_call is None or sum(e.count for e in ours) == \
                iters * per_call:
            return (sum(e.device_time_total for e in evs) / iters / 1e3,
                    sum(e.device_time_total for e in ours) / iters / 1e3)
    say(f"[profiler] {kernel}: fewer than {iters * per_call} launches "
        f"recorded in each of {tries} windows: device time not measured")
    return None, None


def bound(ops, nbytes, dtype):
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def counts():
    return {n: k["counter"].route_launches[k["route"]] if "route" in k
            else k["counter"].launches for n, k in KERNELS.items()}


def reset_counts():
    for k in KERNELS.values():
        k["counter"].launches = 0
        if "route" in k:
            k["counter"].route_launches[k["route"]] = 0


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
        FLASH_KERNEL_NAMES["flash_fwd", dtype])
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


def check_flash_ragged(dtype, B, H, Sq, Sk, D, causal, gen, dev):
    """The flash forward against its plain version at lengths that are
    no multiple of a tile (the tensor-core kernel's are 128 query rows
    and 64 or 128 keys), ``Sq < Sk``, untimed."""
    q = torch.randn(B, H, Sq, D, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(B, H, Sk, D, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    scale = 1.0 / D ** 0.5
    o, lse = flash_fwd(q, k, v, scale=scale, causal=causal)
    o_ref, lse_ref = flash_fwd_reference(q, k, v, scale, causal)
    torch.cuda.synchronize()
    err = max((o.float() - o_ref.float()).abs().max().item(),
              (lse - lse_ref).abs().max().item())
    shape = f"B{B} H{H} Sq{Sq} Sk{Sk} D{D}" + (" causal" if causal else "")
    require(err <= TOL[dtype], f"flash_fwd {dname(dtype)} {shape} "
            f"disagrees with its plain version: {err} > {TOL[dtype]}")
    return dict(name="flash_fwd", dtype=dname(dtype), shape=shape,
                max_abs_err=err, tol=TOL[dtype])


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


def half_step_err(got, ref32):
    """A backward kernel's error against the plain version's f32 sums
    ``ref32``: absolute below 1 and relative above, as the dense
    backward's check, counted beyond half a step of ``got``'s dtype at
    ``ref32`` (the output's own rounding; 0 for f32). For the kernels
    that sum in another order than the plain version (the varlen
    kernels; the dense fused backward on the tensor cores): in bf16
    their same-dtype outputs differ by a whole step where a sum sits on
    a rounding boundary (7.3e-3 at 1.07: dV at the serving lengths on an
    H100; the same backward with float64 sums reads past the limit
    against the f32 plain one too, as ``check_flash_bwd`` records), and
    a few P or dS elements round to the
    other neighbour (~1e-3), while a backward without the P/dS rounding
    reads ~6-8e-3 past its half step."""
    return half_step_excess(got, ref32).max().item()


def half_step_excess(got, ref32):
    """Each element's error of ``half_step_err``."""
    half = 0.0
    if got.dtype == torch.bfloat16:
        half = torch.exp2(torch.floor(torch.log2(
            ref32.abs().clamp_min(1e-30))) - 8)
    excess = ((got.float() - ref32).abs() - half).clamp_min(0.0)
    return excess / ref32.abs().clamp_min(1.0)


def varlen_bwd_stats(got, ref32):
    """The fused varlen backward's readings over its outputs ``got``
    (dq, dk, dv) against the plain f32 sums ``ref32``, each element's
    error beyond half a step as in ``half_step_err``: the largest
    (``max_err``), the share of elements that are not the f32 sum
    correctly rounded (``off_share``) and the count past ``BWD_TOL``."""
    n = off = past = 0
    worst = 0.0
    for g, r in zip(got, ref32):
        e = half_step_excess(g, r)
        n += e.numel()
        off += int((e > 0).sum().item())
        past += int((e > BWD_TOL[torch.bfloat16]).sum().item())
        worst = max(worst, e.max().item() if e.numel() else 0.0)
    return dict(max_err=worst, off_share=off / max(n, 1), past_limit=past,
                elements=n)


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


def check_flash_bwd(dtype, B, H, Sq, Sk, D, gen, dev, timed,
                    routes=("fused", "split")):
    """The backward ``routes`` against the plain backward; with
    ``timed``, the route kernels' times, bounds and the SDPA backward's
    time. The split pair sums in the plain version's order (at the
    shapes it is held at) and is held to it in the input dtype; the
    fused route in bf16 runs on the tensor cores, sums in another order,
    and is held to the plain version's f32 sums beyond half a bf16 step
    (``half_step_err``), as the varlen kernels are."""
    q, k, v, o, lse, do, scale = bwd_inputs(dtype, B, H, Sq, Sk, D, gen,
                                            dev)
    ref = flash_bwd_reference(q, k, v, o, lse, do, scale, True)
    ref32 = flash_bwd_reference(q, k, v, o, lse, do, scale, True,
                                out_dtype=torch.float32)
    shape = f"B{B} H{H} Sq{Sq} Sk{Sk} D{D} causal"
    tol = BWD_TOL[dtype]
    half_step = dtype == torch.bfloat16

    def scaled(got):
        # absolute below 1, relative above: one bf16 rounding step of a
        # gradient of magnitude 8 is 0.03
        diff = [(g.float() - r.float()).abs() for g, r in zip(got, ref)]
        return ([(d / r.float().abs().clamp_min(1.0)).max().item()
                 for d, r in zip(diff, ref)], [d.max().item() for d in diff])
    errs, abs_errs, same_dtype = {}, {}, {}
    for route in routes:
        got = flash_bwd(q, k, v, o, lse, do, scale, True, route=route)
        torch.cuda.synchronize()
        same_dtype[route], abs_errs[route] = scaled(got)
        errs[route] = ([half_step_err(g, r) for g, r in zip(got, ref32)]
                       if route == "fused" and half_step
                       else same_dtype[route])
        require(all(e <= tol for e in errs[route]),
                f"flash_bwd {route} {dname(dtype)} {shape}: dq/dk/dv err "
                f"{errs[route]} > {tol}")
    if not timed:
        return [dict(name="flash_bwd", dtype=dname(dtype), shape=shape,
                     dq_dk_dv_err=errs, dq_dk_dv_abs_err=abs_errs,
                     dq_dk_dv_err_same_dtype=same_dtype, tol=tol)]
    unrounded = None
    if dtype == torch.bfloat16:
        # what a kernel that skips the P/dS rounding reads under either
        # metric: the limit must catch it
        plain32 = flash_bwd_reference(q.float(), k.float(), v.float(),
                                      o.float(), lse, do.float(), scale, True)
        unrounded = dict(
            same_dtype=scaled([t.to(dtype) for t in plain32])[0],
            half_step=[half_step_err(a.to(dtype), b)
                       for a, b in zip(plain32, ref32)])
        del plain32
        for metric, e in unrounded.items():
            require(max(e) > tol,
                    f"flash_bwd bf16 {shape}: the plain backward without P/dS "
                    f"rounding reads {e} ({metric}), within the limit {tol}")
        # why the tensor-core route needs the half-step metric: the same
        # backward with float64 sums, against the f32 plain version in
        # bf16, reads past the limit too (one bf16 step where a sum sits
        # on a rounding boundary)
        unrounded["exact_sums_same_dtype"] = scaled(flash_bwd_reference(
            q, k, v, o, lse, do, scale, True, sum_dtype=torch.float64))[0]
        say(f"[kernel] flash_bwd bf16 {shape}: the plain backward without "
            f"P/dS rounding, and with float64 sums: {unrounded}")
    del ref32
    delta = (do.float() * o.float()).sum(-1)
    plain = cuda_ms(lambda: flash_bwd_reference(q, k, v, o, lse, do, scale,
                                                True), iters=5, warmup=1)
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
    lib = cuda_ms(lambda: torch.autograd.grad(o_lib, (qr, kr, vr), do,
                                              retain_graph=True))
    del o_lib, qr, kr, vr
    rows = []
    for name, fn, route, outs in (
            ("flash_bwd_fused", flash_bwd_fused, "fused", slice(0, 3)),
            ("flash_bwd_split_dkv", flash_bwd_split_dkv, "split",
             slice(1, 3)),
            ("flash_bwd_split_dq", flash_bwd_split_dq, "split", slice(0, 1))):
        if route not in routes:
            continue
        err = max(abs_errs[route][outs])
        scaled_err = max(errs[route][outs])
        def run(fn=fn):
            return fn(q, k, v, do, lse, delta, scale, True)
        ms = cuda_ms(run)
        dev_ms, kern_ms = device_ms(run, FLASH_KERNEL_NAMES[name, dtype])
        b_ms, b_by = bwd_bound(name, B, H, Sq, Sk, D, dtype,
                               q.element_size())
        rows.append(dict(name=name, dtype=dname(dtype), shape=shape,
                         max_abs_err=err, scaled_err=scaled_err,
                         same_dtype_err=max(same_dtype[route][outs]),
                         metric="half_step" if route == "fused" and
                         half_step else "same_dtype",
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


def check_momentum(shapes, o2_dtypes, gen, dev):
    """Three steps of the fused Momentum against the eager chain,
    bitwise, on parameters of ResNet-50's 161 shapes: f32 plain, f32
    Nesterov, f32 with L2 decay 1e-4, bf16 with f32 masters, and the
    mixed list of ResNet-50 under O2 (``o2_dtypes``: bf16 convolutions
    and fc with f32 masters, f32 BatchNorm); each step one launch. Then
    one multi-tensor step over f32 state of all 161 (what a training
    step runs) timed: the kernel, its plain version, and
    ``torch._fused_sgd_`` (dampening 0: the same function) over the same
    lists, by CUDA events and by device time."""
    n_leaves = len(shapes)
    cases = [("f32", [torch.float32] * n_leaves, False, 0.0),
             ("f32 nesterov", [torch.float32] * n_leaves, True, 0.0),
             ("f32 L2 1e-4", [torch.float32] * n_leaves, False, 1e-4),
             ("bf16 + f32 masters", [torch.bfloat16] * n_leaves, False, 0.0),
             ("ResNet-50 O2 list", o2_dtypes, False, 1e-4)]
    for what, dtypes, nesterov, wd in cases:
        inits = [torch.randn(sh, generator=gen, device=dev).to(dt)
                 for sh, dt in zip(shapes, dtypes)]
        pa = [torch.nn.Parameter(t.clone()) for t in inits]
        pb = [torch.nn.Parameter(t) for t in inits]
        for a, b in zip(pa, pb):
            # BatchNorm-like vectors without decay, as a user's
            # apply_decay_param_fun would mark them
            a.no_weight_decay = b.no_weight_decay = a.dim() == 1
        kw = dict(learning_rate=RESNET["lr"], momentum=RESNET["momentum"],
                  use_nesterov=nesterov, weight_decay=wd,
                  multi_precision=True)
        oa = Momentum(parameters=pa, fused=True, **kw)
        ob = Momentum(parameters=pb, fused=False, **kw)
        before = momentum_step.launches
        for _ in range(3):
            for a, b in zip(pa, pb):
                g = torch.randn(a.shape, generator=gen, device=dev).to(
                    a.dtype)
                a.grad, b.grad = g, g.clone()
            oa.step()
            ob.step()
        torch.cuda.synchronize()
        require(momentum_step.launches - before == 3,
                f"the fused Momentum ({what}) launched the kernel "
                f"{momentum_step.launches - before} times in 3 steps, want "
                f"one a step")
        for i, (a, b) in enumerate(zip(pa, pb)):
            sa, sb = oa._states[id(a)], ob._states[id(b)]
            pairs = [("param", a, b)]
            if "master" in sa:
                pairs.append(("master", sa["master"], sb["master"]))
                sa, sb = sa["inner"], sb["inner"]
            pairs.append(("velocity", sa["velocity"], sb["velocity"]))
            for name, x, y in pairs:
                require(torch.equal(x, y), f"momentum_step {what} param "
                        f"{i} {tuple(a.shape)}: {name} differs from the "
                        f"eager Momentum (max "
                        f"{(x.float() - y.float()).abs().max().item()})")
        del inits, pa, pb, oa, ob
        torch.cuda.empty_cache()
    P, G, V = [[torch.randn(sh, generator=gen, device=dev) for sh in shapes]
               for _ in range(3)]
    lr, mom = RESNET["lr"], RESNET["momentum"]
    lows, wds = [None] * n_leaves, [0.0] * n_leaves

    def run():
        momentum_step_multi(P, G, V, lows, wds, lr, mom, False)

    def plain():
        for leaf in zip(P, G, V):
            momentum_step_reference(*leaf, lr, mom, False, 0.0)
    ms = cuda_ms(run)
    dev_ms, kern_ms = device_ms(run, "momentum_step_kernel", per_call=1)
    # the wrapper's host time (checks, the descriptor table, the launch),
    # which the CUDA-event time holds beside the kernel's
    host = []
    for _ in range(20):
        t0 = time.perf_counter()
        run()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    plain_ms = cuda_ms(plain, iters=5)
    lib = lib_dev_ms = None
    if hasattr(torch, "_fused_sgd_"):
        def lib_run():
            torch._fused_sgd_(P, G, V, weight_decay=0.0, momentum=mom, lr=lr,
                              dampening=0.0, nesterov=False, maximize=False,
                              is_first_step=False)
        lib = cuda_ms(lib_run)
        lib_dev_ms = device_ms(lib_run, "")[0]
    N = sum(p.numel() for p in P)
    # 4 f32 operations an element (mom*v, + g, lr*v, p -); p, g, v read
    # and p, v written
    b_ms, b_by = bound(4.0 * N, 20.0 * N, torch.float32)
    return dict(name="momentum_step", dtype="float32",
                shape=f"{n_leaves} ResNet-50 parameters, {N} f32 elements "
                f"(largest {max(p.numel() for p in P)}), one launch",
                max_abs_err=0.0, tol="bitwise", ms=ms, device_ms=dev_ms,
                kernel_device_ms=kern_ms, host_ms=statistics.median(host),
                plain_ms=plain_ms, library_ms=lib,
                library_device_ms=lib_dev_ms, bound_ms=b_ms, bound_by=b_by,
                library="torch._fused_sgd_")


def int8pack_available(dev):
    """Whether this torch computes ``torch._weight_int8pack_mm`` on
    CUDA: it takes w as ``[N, K]`` int8 and per-row scales in x's dtype.
    A yardstick only; the port never calls it."""
    try:
        torch._weight_int8pack_mm(
            torch.ones(1, 32, device=dev), torch.ones(8, 32, device=dev,
                                                      dtype=torch.int8),
            torch.ones(8, device=dev))
        torch.cuda.synchronize()
        return True
    except (AttributeError, NotImplementedError, RuntimeError):
        return False


def check_wo(dtype, M, K, N, with_bias, gen, dev, label, int8pack,
             timed=True):
    """The weight-only kernel against its plain version at ``M x K x
    N``: error absolute below 1 and relative above (one bf16 rounding
    step of an output of 4 is 0.03); the call must take the route
    ``wo_route`` names (the row is named ``wo_matmul_wgmma`` on the
    tensor-core route). With ``timed``, its times, the wrapper's host
    time a call, its bound and the library yardsticks."""
    x = torch.randn(M, K, generator=gen, device=dev).to(dtype)
    w = torch.randn(K, N, generator=gen, device=dev) * 0.02
    w8, s8 = quantize_channelwise(w)
    bias = ((torch.randn(N, generator=gen, device=dev) * 0.02).to(dtype)
            if with_bias else None)
    route = wo_route(M, K, N, dtype)
    before = int8_weight_only_matmul.route_launches[route]
    y = int8_weight_only_matmul(x, w8, s8, bias)
    require(int8_weight_only_matmul.route_launches[route] == before + 1,
            f"wo_matmul M{M} K{K} N{N} {dname(dtype)}: not on the {route} "
            f"route")
    ref = int8_weight_only_matmul_reference(x, w8, s8, bias)
    torch.cuda.synchronize()
    diff = (y.float() - ref.float()).abs()
    err = diff.max().item()
    scaled = (diff / ref.float().abs().clamp_min(1.0)).max().item()
    require(torch.isfinite(y.float()).all().item(), "non-finite output")
    shape = f"M{M} K{K} N{N} ({label})" + (" bias" if with_bias else "")
    require(scaled <= TOL[dtype], f"wo_matmul {dname(dtype)} {shape} "
            f"disagrees with its plain version: {scaled} > {TOL[dtype]}")
    row = dict(name="wo_matmul_wgmma" if route == "wgmma" else "wo_matmul",
               route=route, dtype=dname(dtype), shape=shape,
               max_abs_err=err, scaled_err=scaled, tol=TOL[dtype])
    if not timed:
        return row

    def run():
        return int8_weight_only_matmul(x, w8, s8, bias)
    ms = cuda_ms(run)
    dev_ms, kern_ms = device_ms(run, "wo_ge")
    # the wrapper's host time (checks, the plan, the launch), which the
    # CUDA-event time holds beside the kernel's
    host = []
    for _ in range(20):
        t0 = time.perf_counter()
        run()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    plain = cuda_ms(lambda: int8_weight_only_matmul_reference(
        x, w8, s8, bias), iters=10)
    w_deq = (w8.float() * (s8 / 127.0)).to(dtype)
    lib = cuda_ms((lambda: torch.addmm(bias, x, w_deq)) if with_bias
                  else (lambda: torch.mm(x, w_deq)))
    pack_ms = None
    if int8pack:
        w_nk, s_x = w8.t().contiguous(), (s8 / 127.0).to(dtype)
        pack_ms = cuda_ms(lambda: torch._weight_int8pack_mm(x, w_nk, s_x))
    size = x.element_size()
    nbytes = (M * K * size + K * N + 4.0 * N + M * N * size
              + (N * size if with_bias else 0))
    b_ms, b_by = bound(2.0 * M * N * K, nbytes, dtype)
    row.update(ms=ms, device_ms=dev_ms, kernel_device_ms=kern_ms,
               host_ms=statistics.median(host), plain_ms=plain,
               library_ms=lib, bound_ms=b_ms, bound_by=b_by,
               library="torch.mm over the dequantized weight",
               int8pack_mm_ms=pack_ms)
    return row


def check_wo_all_values(dev):
    """Every int8 value through the tensor-core route's widening: w holds
    -128..127 in each column (rotated), x picks one row of w in each of
    its 16 rows and sums all of them in one more column; with s = qmax
    the products are integers, so the kernel must equal its plain
    version exactly."""
    K, N, M = 256, 128, 16
    vals = torch.arange(-128, 128, device=dev, dtype=torch.int32).to(
        torch.int8)
    w8 = torch.roll(vals[:, None].repeat(1, N).reshape(-1), 37).view(
        K, N).contiguous()
    s8 = torch.full((N,), 127.0, device=dev)
    x = torch.zeros(M, K, device=dev, dtype=torch.bfloat16)
    x[torch.arange(M, device=dev), torch.arange(M, device=dev) * 16 + 3] = 1
    x[:, 200] = 1
    require(wo_route(M, K, N, torch.bfloat16) == "wgmma",
            "the all-values check is not on the tensor-core route")
    y = int8_weight_only_matmul(x, w8, s8)
    exact = torch.equal(y, int8_weight_only_matmul_reference(x, w8, s8))
    require(exact, "wo_matmul_wgmma: an int8 value widened inexactly")
    return dict(name="wo_matmul_wgmma", route="wgmma", dtype="bfloat16",
                shape=f"M{M} K{K} N{N} (every int8 value)", max_abs_err=0.0,
                scaled_err=0.0, tol="torch.equal")


@torch.inference_mode()
def check_wo_bound(model, prompt):
    """The analytic bound on the serving model's layer 0 and 23
    projections and the head, with the activations that reach them on
    ``prompt``: for each weight the kernel's error against ``x @ W`` in
    f64 on the host stays within ``weight_quant_error_bound + 1e-4 |y|``
    and the bound is below ``max |x @ W|``; a 4-bit payload of the same
    weights breaks the 8-bit bound somewhere. (The l1 bound grows with K
    and the error of a random payload with its square root: at K 8192
    the down projection's 4-bit payload can stay inside the bound.)"""
    caps, hooks = {}, []
    for li in (0, len(model.gpt.h) - 1):
        blk = model.gpt.h[li]
        for name, lin in (("qkv", blk.attn.qkv),
                          ("out_proj", blk.attn.out_proj),
                          ("up", blk.mlp.up), ("down", blk.mlp.down)):
            def pre(mod, inp, key=f"layer{li}.{name}"):
                caps[key] = (inp[0].reshape(-1, inp[0].shape[-1]).clone(),
                             mod.weight.t())
            hooks.append(lin.register_forward_pre_hook(pre))

    def head_in(mod, inp, out):
        caps["head"] = (out.reshape(-1, out.shape[-1]).clone(),
                        model.gpt.wte.weight.t())
    hooks.append(model.gpt.ln_f.register_forward_hook(head_in))
    dev = model.gpt.wte.weight.device
    model(torch.as_tensor([prompt], dtype=torch.long, device=dev))
    for h in hooks:
        h.remove()
    rows = []
    for key, (x, w) in caps.items():
        w8, s8 = quantize_channelwise(w, 8)
        w4, s4 = quantize_channelwise(w, 4)
        y8 = int8_weight_only_matmul(x, w8, s8).double().cpu()
        y4 = int8_weight_only_matmul(x, w4, s4, quant_bits=4).double().cpu()
        exact = x.double().cpu() @ w.double().cpu()
        bnd = weight_quant_error_bound(x, s8).double().cpu()
        err = (y8 - exact).abs()
        row = dict(
            weight=key, shape=f"M{x.shape[0]} K{w.shape[0]} N{w.shape[1]}",
            max_err=err.max().item(), max_bound=bnd.max().item(),
            max_abs_y=exact.abs().max().item(),
            holds=bool((err <= bnd + 1e-4 * y8.abs()).all()),
            four_bit_violates=bool(((y4 - exact).abs() > bnd).any()))
        row["informative"] = row["max_bound"] < row["max_abs_y"]
        say(f"[kernel] wo_matmul bound {row}")
        require(row["holds"], f"wo_matmul {key}: error past the analytic "
                f"bound")
        require(row["informative"], f"wo_matmul {key}: the bound is not "
                f"below max |x @ W|")
        rows.append(row)
    require(any(r["four_bit_violates"] for r in rows),
            "no 4-bit payload breaks the 8-bit bound: the bound is vacuous")
    return rows


def check_wo_payload(model):
    """Layer 0 quantized on the card and on the CPU from the same
    weights: payloads and scales ``torch.equal``."""
    card = weight_only_quantize(copy.deepcopy(model.gpt.h[0]))
    cpu = weight_only_quantize(copy.deepcopy(model.gpt.h[0]).cpu())
    out = {}
    for name in ("attn.qkv", "attn.out_proj", "mlp.up", "mlp.down"):
        a, b = card.get_submodule(name), cpu.get_submodule(name)
        out[name] = (torch.equal(a.weight_int8.cpu(), b.weight_int8)
                     and torch.equal(a.w_scale.cpu(), b.w_scale))
        require(out[name], f"layer 0 {name}: the card's payload differs "
                f"from the CPU's")
    return out


def int_mm_reason(M, K, N):
    """Why ``torch._int_mm`` cannot take ``M x K x N`` on CUDA, or None:
    it wants M > 16 and K and N multiples of 8."""
    if M <= 16:
        return "torch._int_mm needs M > 16"
    if K % 8 or N % 8:
        return "torch._int_mm needs K and N multiples of 8"
    return None


def check_i8i8(M, K, N, label, gen, dev, timed=True, fill=None):
    """The int8 x int8 kernel against its plain version at ``M x K x
    N``, ``torch.equal`` (the products are exact integers). ``fill``
    "pm127": x all 127 and w +-127 with one all-127 column, which
    reaches the largest sums. With ``timed``, its times, its bound and
    ``torch._int_mm``'s time where that call takes the shape."""
    if fill == "pm127":
        x = torch.full((M, K), 127, dtype=torch.int8, device=dev)
        w = (torch.randint(0, 2, (K, N), generator=gen, device=dev,
                           dtype=torch.int8) * 2 - 1) * 127
        w[:, 0] = 127
    else:
        x = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-128, 128, (K, N), generator=gen, device=dev,
                          dtype=torch.int8)
    y = int8_matmul(x, w)
    ref = int8_matmul_reference(x, w)
    torch.cuda.synchronize()
    shape = f"M{M} K{K} N{N} ({label})"
    err = (y.double() - ref.double()).abs().max().item()
    require(torch.equal(y, ref), f"i8i8_matmul {shape} differs from its "
            f"plain version: max abs err {err}")
    if fill == "pm127":
        require(int(y[0, 0]) == 127 * 127 * K, f"i8i8_matmul {shape}: the "
                f"all-127 column sums to {int(y[0, 0])}")
    per, splits = i8i8_split(M, K, N, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    row = dict(name="i8i8_matmul", dtype="int8", shape=shape,
               max_abs_err=err, tol="torch.equal", k_splits=splits,
               max_abs_sum=int(ref.abs().max()))
    if not timed:
        return row

    def run():
        return int8_matmul(x, w)
    ms = cuda_ms(run)
    dev_ms, kern_ms = device_ms(run, "i8i8", per_call=1)
    plain = cuda_ms(lambda: int8_matmul_reference(x, w), iters=10)
    reason = int_mm_reason(M, K, N)
    lib = None if reason else cuda_ms(lambda: torch._int_mm(x, w))
    b_ms, b_by = bound(2.0 * M * N * K, M * K + K * N + 4.0 * M * N,
                       torch.int8)
    row.update(ms=ms, device_ms=dev_ms, kernel_device_ms=kern_ms,
               plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
               library="torch._int_mm" if lib is not None else reason)
    return row


def check_int4(M, K, N, dtype, gen, dev, label):
    """``int4_weight_only_matmul`` (the nibble payload unpacked, then the
    weight-only kernel at ``quant_bits=4``) against the plain weight-only
    version on the unpacked payload, with ``check_wo``'s tolerance."""
    x = torch.randn(M, K, generator=gen, device=dev).to(dtype)
    w = torch.randn(K, N, generator=gen, device=dev) * 0.02
    w4, s4 = quantize_channelwise(w, 4)
    packed = pack_int4(w4)
    require(torch.equal(unpack_int4(packed, N), w4), "int4 pack round trip")
    y = int4_weight_only_matmul(x, packed, s4)
    ref = int8_weight_only_matmul_reference(x, w4, s4, quant_bits=4)
    torch.cuda.synchronize()
    diff = (y.float() - ref.float()).abs()
    scaled = (diff / ref.float().abs().clamp_min(1.0)).max().item()
    shape = f"M{M} K{K} N{N} ({label}) int4"
    require(scaled <= TOL[dtype], f"int4_weight_only_matmul {dname(dtype)} "
            f"{shape} disagrees with its plain version: {scaled}")
    return dict(name="int4_weight_only_matmul", dtype=dname(dtype),
                shape=shape, max_abs_err=diff.max().item(),
                scaled_err=scaled, tol=TOL[dtype],
                ms=cuda_ms(lambda: int4_weight_only_matmul(x, packed, s4)),
                packed_bytes=packed.numel())


# significant bits of the half-precision types
HALF_BITS = {torch.bfloat16: 8, torch.float16: 11}


def half_ulp(v, dtype):
    """One ulp of ``dtype`` (bf16 or f16) at |v|."""
    _, e = torch.frexp(v.abs())
    return torch.ldexp(torch.ones_like(v), e - HALF_BITS[dtype])


def ln_err(got, ref, dtype, rel_to_max=False):
    """The worst excess over the limit (<= 0 passes) and the largest
    absolute error. Limits: a bf16 or f16 output within one ulp of its
    type of the larger of the two values, plus 1e-5 of the tensor's largest
    magnitude for values that cancel to near zero (the f32 sums before
    the one rounding run in another order); f32 outputs to 1e-5,
    absolute below 1 and relative above; f32 dgamma/dbeta to 1e-5 of
    their largest magnitude."""
    got, ref = got.float(), ref.float()
    d = (got - ref).abs()
    amax = ref.abs().max()
    if dtype in HALF_BITS:
        lim = half_ulp(torch.maximum(got.abs(), ref.abs()), dtype) \
            + 1e-5 * amax
    elif rel_to_max:
        lim = 1e-5 * amax.clamp_min(1e-30)
    else:
        lim = 1e-5 * ref.abs().clamp_min(1.0)
    return (d - lim).max().item(), d.max().item()


def ln_inputs(R, H, xdt, gdt, gen, dev):
    x = (torch.randn(R, H, generator=gen, device=dev) * 2 + 0.5).to(xdt)
    g, b = (torch.randn(H, generator=gen, device=dev).to(gdt)
            for _ in range(2))
    dy = torch.randn(R, H, generator=gen, device=dev).to(xdt)
    return x, g, b, dy, (1e-12 if H == 768 else 1e-5)


def check_layer_norm(R, H, xdt, gdt, what, gen, dev, timed):
    """The forward and the backward kernels against their plain
    versions; in f32 two backward runs bitwise equal (no atomics). With
    ``timed``, both kernels' times, bounds and library yardsticks."""
    x, g, b, dy, eps = ln_inputs(R, H, xdt, gdt, gen, dev)
    short = {torch.float32: "f32", torch.bfloat16: "bf16",
             torch.float16: "f16"}
    shape = f"R{R} H{H} ({what}) g {short[gdt]}"
    y = layer_norm_fwd(x, g, b, eps)
    dx, dg, db = layer_norm_bwd(x, g, dy, eps)
    y_ref = layer_norm_fwd_reference(x, g, b, eps)
    dx_ref, dg_ref, db_ref = layer_norm_bwd_reference(x, g, dy, eps)
    torch.cuda.synchronize()
    errs = {"y": ln_err(y, y_ref, xdt), "dx": ln_err(dx, dx_ref, xdt),
            "dg": ln_err(dg, dg_ref, gdt, True),
            "db": ln_err(db, db_ref, gdt, True)}
    for k, (excess, err) in errs.items():
        require(excess <= 0, f"layer_norm {dname(xdt)} {shape}: {k} "
                f"disagrees with its plain version (max abs err {err}, "
                f"{excess} past the limit)")
    for t in (y, dx, dg, db):
        require(torch.isfinite(t.float()).all().item(), "non-finite output")
    reproducible = None
    if xdt == torch.float32:
        again = layer_norm_bwd(x, g, dy, eps)
        reproducible = all(torch.equal(a, c) for a, c in
                           zip((dx, dg, db), again))
        require(reproducible, f"layer_norm_bwd f32 {shape}: two runs "
                f"differ (dgamma/dbeta must not depend on timing)")
    rows = [dict(name=n, dtype=dname(xdt), shape=shape,
                 max_abs_err=max(errs[k][1] for k in ks),
                 excess_over_tol=max(errs[k][0] for k in ks),
                 tol="bf16/f16: 1 ulp + 1e-5 max; f32: 1e-5 (dg/db of max)",
                 bitwise_reproducible=reproducible)
            for n, ks in (("layer_norm_fwd", ("y",)),
                          ("layer_norm_bwd", ("dx", "dg", "db")))]
    if not timed:
        return rows
    size, gsize = x.element_size(), g.element_size()
    gx, bx = g.to(xdt), b.to(xdt)
    xr, gr, br = (t.detach().clone().requires_grad_() for t in (x, gx, bx))
    out = F.layer_norm(xr, (H,), gr, br, eps)
    lib_calls = {
        "fwd": lambda: F.layer_norm(x, (H,), gx, bx, eps),
        "bwd": lambda: torch.autograd.grad(out, (xr, gr, br), dy,
                                           retain_graph=True),
        "fwd+bwd": lambda: torch.autograd.grad(
            F.layer_norm(xr, (H,), gr, br, eps), (xr, gr, br), dy)}
    lib = {k: cuda_ms(fn) for k, fn in lib_calls.items()}
    # the device time of every kernel the library call launches
    lib_dev = {k: device_ms(fn, "")[0] for k, fn in lib_calls.items()}
    for row, run, plain, kern, ops, nbytes, which in (
            (rows[0], lambda: layer_norm_fwd(x, g, b, eps),
             lambda: layer_norm_fwd_reference(x, g, b, eps),
             "layer_norm_fwd_kernel", 8.0 * R * H,
             2.0 * R * H * size + 2.0 * H * gsize, "fwd"),
            (rows[1], lambda: layer_norm_bwd(x, g, dy, eps),
             lambda: layer_norm_bwd_reference(x, g, dy, eps),
             "layer_norm_bwd", 16.0 * R * H,
             3.0 * R * H * size + 3.0 * H * gsize, "bwd")):
        dev_ms, kern_ms = device_ms(run, kern)
        # the arithmetic runs in f32 on the CUDA cores whatever x's type
        b_ms, b_by = bound(ops, nbytes, torch.float32)
        row.update(ms=cuda_ms(run), device_ms=dev_ms,
                   kernel_device_ms=kern_ms,
                   plain_ms=cuda_ms(plain, iters=10),
                   library_ms=lib[which], library_device_ms=lib_dev[which],
                   bound_ms=b_ms, bound_by=b_by,
                   library="F.layer_norm (weights in x's dtype)"
                   + (" backward through autograd"
                      if which == "bwd" else ""),
                   library_fwd_bwd_ms=lib["fwd+bwd"],
                   library_fwd_bwd_device_ms=lib_dev["fwd+bwd"],
                   bwd_blocks=bwd_blocks(R, dev))
    return rows


def check_rms_norm(R, H, xdt, wdt, what, gen, dev, timed, eps=1e-6):
    """The RMSNorm forward and backward kernels against their plain
    versions (the backward on the kernel's saved r, as the plain one is
    given it); in f32 two backward runs bitwise equal (no atomics). With
    ``timed``, both kernels' times, bounds and ``F.rms_norm``'s."""
    x = (torch.randn(R, H, generator=gen, device=dev) * 2 + 0.5).to(xdt)
    w = torch.randn(H, generator=gen, device=dev).to(wdt)
    do = torch.randn(R, H, generator=gen, device=dev).to(xdt)
    short = {torch.float32: "f32", torch.bfloat16: "bf16"}
    shape = f"R{R} H{H} ({what}) w {short[wdt]}"
    o, r = rms_norm_fwd(x, w, eps)
    dx, dw = rms_norm_bwd(x, w, r, do)
    o_ref, r_ref = rms_norm_fwd_reference(x, w, eps)
    dx_ref, dw_ref = rms_norm_bwd_reference(x, w, r, do)
    torch.cuda.synchronize()
    errs = {"o": ln_err(o, o_ref, xdt, True),
            "r": ln_err(r, r_ref, torch.float32, True),
            "dx": ln_err(dx, dx_ref, xdt, True),
            "dw": ln_err(dw, dw_ref, wdt, True)}
    for k, (excess, err) in errs.items():
        require(excess <= 0, f"rms_norm {dname(xdt)} {shape}: {k} "
                f"disagrees with its plain version (max abs err {err}, "
                f"{excess} past the limit)")
    for t in (o, r, dx, dw):
        require(torch.isfinite(t.float()).all().item(), "non-finite output")
    reproducible = None
    if xdt == torch.float32:
        again = rms_norm_bwd(x, w, r, do)
        reproducible = all(torch.equal(a, c) for a, c in
                           zip((dx, dw), again))
        require(reproducible, f"rms_norm_bwd f32 {shape}: two runs differ "
                f"(dw must not depend on timing)")
    rows = [dict(name=n, dtype=dname(xdt), shape=shape,
                 max_abs_err=max(errs[k][1] for k in ks),
                 excess_over_tol=max(errs[k][0] for k in ks),
                 tol="bf16: 1 ulp + 1e-5 max; f32: 1e-5 of max",
                 bitwise_reproducible=reproducible)
            for n, ks in (("rms_norm_fwd", ("o", "r")),
                          ("rms_norm_bwd", ("dx", "dw")))]
    if not timed:
        return rows
    size, wsize = x.element_size(), w.element_size()
    wx = w.to(xdt)
    xr, wr = (t.detach().clone().requires_grad_() for t in (x, wx))
    out = F.rms_norm(xr, (H,), wr, eps)
    lib_calls = {
        "fwd": lambda: F.rms_norm(x, (H,), wx, eps),
        "bwd": lambda: torch.autograd.grad(out, (xr, wr), do,
                                           retain_graph=True)}
    lib = {k: cuda_ms(fn) for k, fn in lib_calls.items()}
    lib_dev = {k: device_ms(fn, "")[0] for k, fn in lib_calls.items()}
    for row, run, plain, kern, ops, nbytes, which in (
            (rows[0], lambda: rms_norm_fwd(x, w, eps),
             lambda: rms_norm_fwd_reference(x, w, eps),
             ("rms_norm_fwd_kernel", 1), 4.0 * R * H,
             2.0 * R * H * size + H * wsize + 4.0 * R, "fwd"),
            (rows[1], lambda: rms_norm_bwd(x, w, r, do),
             lambda: rms_norm_bwd_reference(x, w, r, do),
             # the row kernel and the reduction of its partials
             ("rms_norm_bwd", 2), 10.0 * R * H,
             3.0 * R * H * size + 2.0 * H * wsize + 4.0 * R, "bwd")):
        dev_ms, kern_ms = device_ms(run, kern[0], per_call=kern[1])
        # the arithmetic runs in f32 on the CUDA cores whatever x's type
        b_ms, b_by = bound(ops, nbytes, torch.float32)
        row.update(ms=cuda_ms(run), device_ms=dev_ms,
                   kernel_device_ms=kern_ms,
                   plain_ms=cuda_ms(plain, iters=10),
                   library_ms=lib[which], library_device_ms=lib_dev[which],
                   bound_ms=b_ms, bound_by=b_by,
                   library="F.rms_norm (weight in x's dtype)"
                   + (" backward through autograd"
                      if which == "bwd" else ""),
                   bwd_blocks=frn.bwd_blocks(R, dev))
    return rows


def check_rope(B, S, H, D, table, dtype, gen, dev, timed):
    """The RoPE kernel, forward and backward (``negate_sin``), against
    its plain version, bitwise, on the ``_angle_table`` route's tables
    (built in float64, rounded to x's dtype): ``[S, D]``, or gathered by
    random ``position_ids`` to ``[B*S, D]``. With ``timed``, the
    forward's times and bound (no single torch call computes it)."""
    x = torch.randn(B, S, H, D, generator=gen, device=dev).to(dtype)
    cos, sin = IF._angle_table(S, D, 10000.0, False, dtype, dev)
    if table == "pos":
        pos = torch.randint(0, S, (B, S), generator=gen, device=dev)
        cos, sin = (t[pos].reshape(B * S, D) for t in (cos, sin))
    shape = (f"B{B} S{S} H{H} D{D}, "
             f"{'[S, D]' if table == 'S' else 'position_ids [B*S, D]'} "
             f"table")
    for neg in (False, True):
        got = rope(x, cos, sin, negate_sin=neg)
        want = rope_reference(x, cos, sin, negate_sin=neg)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        require(torch.equal(got, want), f"rope {dname(dtype)} {shape} "
                f"({'backward' if neg else 'forward'}): not bitwise equal "
                f"to its plain version (max abs err {err})")
    row = dict(name="rope", dtype=dname(dtype), shape=shape,
               max_abs_err=0.0, tol="bitwise (forward and backward)")
    if not timed:
        return row
    T = cos.shape[0]
    n = x.numel()
    b_ms, b_by = bound(3.0 * n, 2.0 * n * x.element_size()
                       + 2.0 * T * D * cos.element_size(), torch.float32)
    run = lambda: rope(x, cos, sin)
    dev_ms, kern_ms = device_ms(run, "rope_kernel", per_call=1)
    row.update(ms=cuda_ms(run), device_ms=dev_ms, kernel_device_ms=kern_ms,
               plain_ms=cuda_ms(lambda: rope_reference(x, cos, sin),
                                iters=10),
               library_ms=None, library="none", bound_ms=b_ms,
               bound_by=b_by)
    return row


def check_adamw_flat(N, pdt, gen, dev, timed):
    """The flat AdamW against its plain version, bitwise on its four
    outputs, at N elements with params and grads in ``pdt`` and f32
    m, v and master. With ``timed``, its times, bound and
    ``torch._fused_adamw_``'s over an f32 master/m/v of the same N
    (another decay order, so a yardstick of time only)."""
    master = torch.randn(N, generator=gen, device=dev)
    g = torch.randn(N, generator=gen, device=dev).to(pdt)
    m = torch.randn(N, generator=gen, device=dev) * 0.1
    v = torch.rand(N, generator=gen, device=dev) * 0.01
    p = master.to(pdt)
    sc = stage_flat_scalars(1e-4, 0.9, 0.999, 1e-8, 0.01, 3)
    got = adamw_flat(p, g, m, v, master, sc)
    want = adamw_flat_reference(p, g, m, v, master, sc)
    torch.cuda.synchronize()
    shape = f"N {N}, p/g {'bf16' if pdt == torch.bfloat16 else 'f32'}"
    for what, a, b in zip(("p", "m", "v", "master"), got, want):
        require(torch.equal(a, b), f"adamw_flat {shape}: {what} is not "
                f"bitwise equal to its plain version (max "
                f"{(a.float() - b.float()).abs().max().item()})")
    row = dict(name="adamw_flat", dtype=dname(pdt), shape=shape,
               max_abs_err=0.0, tol="bitwise (p, m, v, master)")
    del got, want
    if not timed:
        return row
    run = lambda: adamw_flat(p, g, m, v, master, sc)
    dev_ms, kern_ms = device_ms(run, "adamw_flat_kernel", per_call=1)
    row.update(ms=cuda_ms(run), device_ms=dev_ms, kernel_device_ms=kern_ms,
               plain_ms=cuda_ms(lambda: adamw_flat_reference(
                   p, g, m, v, master, sc), iters=5))
    lp, lg, lm, lv = (t.float().clone() for t in (master, g, m, v))
    steps = [torch.tensor(3.0, device=dev)]
    row.update(library_ms=cuda_ms(lambda: torch._fused_adamw_(
        [lp], [lg], [lm], [lv], [], steps, lr=1e-4, beta1=0.9, beta2=0.999,
        weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False)),
        library="torch._fused_adamw_ (f32 master/m/v)")
    # 16 f32 operations an element; g, m, v, master read and p, m, v,
    # master written: (psize + gsize + 24) bytes; p is never read
    size = p.element_size()
    b_ms, b_by = bound(16.0 * N, (2.0 * size + 24.0) * N, torch.float32)
    row.update(bound_ms=b_ms, bound_by=b_by)
    del lp, lg, lm, lv
    return row


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
                by_group=device_groups(prof, SERVING_GROUPS),
                top=[(e.key[:70], e.device_time_total / 1e3, e.count)
                     for e in top])


def serve(model, econf, prompts, new_tokens):
    """Serve every prompt to completion; returns the generated tokens,
    the launch counts of this run alone, and its timings."""
    eng = ServingEngine(model, econf)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    rids = [eng.submit(p, new_tokens) for p in prompts]
    prefill_s = decode_s = 0.0
    decode_tokens = 0
    ttft = {}
    step_profile = None
    step = prefills = 0
    while not eng.idle():
        t0 = time.perf_counter()
        infos = eng.admit_and_prefill(now=float(step))
        prefills += len(infos)
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
                 prefills=prefills,
                 decode_steps=eng.decode_steps, prefill_s=prefill_s,
                 decode_s=decode_s,
                 decode_programs=eng.num_decode_programs,
                 program_budget=eng.program_budget,
                 kv_high_water_bytes=eng.kv_high_water_bytes(),
                 peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
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
    ``tie``; ``None`` gates nothing); the request is not compared past
    it. Returns the dense tokens and (prompt length, token, margin) at
    the first mismatches."""
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
        require(tie is None or margin < tie,
                f"token {i} of a {len(p)}-token prompt: served {g[i]}, "
                f"dense {dense[i]}, margin {margin:.3g}")
        margins.append((len(p), i, margin))
    return dense_all, margins


def serve_int8(make_model, dtype, econf, prompts, new, fp_gens, tag):
    """One int8 weight-only run over ``make_model()`` (the seed's fp
    model in ``dtype``; the engine quantizes it in place): tokens against
    the quantized model's dense path, ``wo_matmul`` launched once a
    projection and once for the head in every prefill and decode step,
    and in f32 the first-token logits against the quantized model on the
    CPU. Returns the run's record and its launches."""
    model = make_model()
    g8, l8, st = serve(model, EngineConfig(
        **econf, kv_dtype=dname(dtype), weight_only_int8=True,
        weight_only_lm_head=True), prompts, new)
    _, ties = dense_check(model, prompts, g8, new,
                          NEAR_TIE if dtype == torch.float32 else
                          NEAR_TIE_BF16)
    per_pass = 4 * len(model.gpt.h) + 1
    want = per_pass * (st["prefills"] + st["decode_steps"])
    require(l8["wo_matmul"] == want,
            f"{tag}: wo_matmul launched {l8['wo_matmul']} times, want "
            f"{want} ({per_pass} a prefill and a decode step)")
    # a bf16 prefill's block projections (M = the padded prompt, > 8) on
    # the tensor cores; the head (the last row) and decode (M <= 8) not
    want_tc = ((per_pass - 1) * st["prefills"] if dtype == torch.bfloat16
               else 0)
    require(l8["wo_matmul_wgmma"] == want_tc,
            f"{tag}: the tensor-core route launched "
            f"{l8['wo_matmul_wgmma']} times, want {want_tc}")
    st.update(near_ties=len(ties), tie_margins=ties, launches=l8,
              tokens_agreeing_with_fp=sum(
                  a == b for x, y in zip(g8, fp_gens) for a, b in zip(x, y)),
              prefix_agreeing_with_fp=[
                  next((i for i, (a, b) in enumerate(zip(x, y)) if a != b),
                       new) for x, y in zip(g8, fp_gens)])
    if dtype == torch.float32:
        cpu = copy.deepcopy(model).cpu()
        for p in prompts[:2]:
            err = (last_logits(model, p).cpu()
                   - last_logits(cpu, p)).abs().max().item()
            say(f"[engine {tag}] first-token logits vs CPU ({len(p)} "
                f"tokens): max abs err {err:.3g} (atol 1e-3)")
            require(err <= 1e-3, f"{tag}: first-token logits differ from "
                    f"the CPU")
    say(f"[engine {tag}] {st}")
    say(f"[engine {tag}] tokens agreeing with the fp run: "
        f"{st['tokens_agreeing_with_fp']} of {new * len(prompts)} "
        f"(information, not a gate)")
    del model
    torch.cuda.empty_cache()
    return st, l8


# ------------------------------------------------------------- phase 16
# a decode step's device kernels by what they do; "elementwise and other"
# is the rest (PTQ's quantize and dequantize chains, LayerNorm, GELU, the
# residual adds, the KV scatter, argmax)
SERVING_GROUPS = (("i8i8_matmul", ("i8i8",)), ("wo_matmul", ("wo_ge",)),
                  ("paged_decode", ("paged_decode",)), ("flash", ("flash_",)),
                  ("gemm", ("gemm", "gemv", "cutlass", "xmma", "nvjet",
                            "cublas")))


@torch.no_grad()
def ptq_convert(model, prompts):
    """PTQ on every block of ``model`` with ``PTQ_QUANTERS``, one dense
    forward over each prompt to calibrate the observers, then convert;
    returns the count of ``QuantedInferenceLinear`` in the model."""
    ptq = PTQ(QuantConfig(**PTQ_QUANTERS))
    for blk in model.gpt.h:
        ptq.quantize(blk)
    dev = model.gpt.wte.weight.device
    for p in prompts:
        model(torch.as_tensor([p], dtype=torch.long, device=dev))
    for blk in model.gpt.h:
        ptq.convert(blk)
    return sum(isinstance(m, QuantedInferenceLinear)
               for m in model.modules())


class QInputs:
    """Stands in for ``quantization.int8_matmul`` while it is entered:
    "record" keeps a copy of each ``QuantedInferenceLinear``'s int8
    input, in call order; "count" compares each input with the recorded
    one (``flips``: the values that differ, per call); "replay" also
    multiplies the recorded input in its place. A recorded input may
    have more rows than the call's (a prefill padded to 16 rows): its
    first rows are the call's."""

    def __init__(self, rec=None, mode="record"):
        self.rec, self.flips, self.mode, self.i = rec or [], [], mode, 0

    def __enter__(self):
        self.real = quantization.int8_matmul
        quantization.int8_matmul = self
        self.i, self.flips = 0, []
        return self

    def __exit__(self, *exc):
        quantization.int8_matmul = self.real

    def __call__(self, q, w):
        if self.mode == "record":
            self.rec.append(q.clone())
        else:
            card = self.rec[self.i][:q.shape[0]].to(q.device)
            self.i += 1
            require(card.shape == q.shape, "a replayed int8 input of "
                    "another shape")
            self.flips.append(int((card != q).sum()))
            if self.mode == "replay":
                q = card
        return self.real(q, w)


def serve_one_at_a_time(model, econf, dtype, prompts, new):
    """The engine at ``max_batch=1`` (each request prefilled and decoded
    alone), recording every ``QuantedInferenceLinear``'s int8 input.
    Returns the tokens and, per request, its calls' inputs in order (its
    prefill's, then each decode step's)."""
    eng = ServingEngine(model, EngineConfig(**{**econf, "max_batch": 1},
                                            kv_dtype=dname(dtype)))
    rids = [eng.submit(p, new) for p in prompts]
    step = 0
    with QInputs() as qi:
        while not eng.idle():
            eng.tick(now=float(step))
            step += 1
            require(step < 10_000, "engine did not drain")
    per = 4 * model.cfg.num_layers * new
    require(len(qi.rec) == per * len(prompts), f"{len(qi.rec)} int8 "
            f"inputs recorded, want {per} a request")
    return ([eng.sequence(r).generated for r in rids],
            [qi.rec[i * per:(i + 1) * per] for i in range(len(prompts))])


@torch.inference_mode()
def dense_replay(model, prompt, new, rec):
    """The converted model's dense greedy loop (``generate``'s: the KV
    cache, the head on the last row, argmax) with every
    ``QuantedInferenceLinear`` fed the served run's int8 input ``rec``.
    Then the int32 products are the served ones, and so is everything
    after them: the two attentions (flash over a contiguous cache, the
    paged kernel over blocks) differ in f32 sums, but their output is
    quantized again by out_proj, and the served input replaces it.
    Returns the tokens, the top-2 logit margin at each step, and how
    many int8 inputs the dense path would have rounded otherwise."""
    dev = model.gpt.wte.weight.device
    ids = torch.as_tensor([prompt], dtype=torch.long, device=dev)
    caches = [() for _ in range(model.cfg.num_layers)]
    pos, toks, margins = 0, [], []
    with QInputs(rec, "replay") as qi:
        for _ in range(new):
            hidden, caches = model.gpt.decode_step(ids[:, pos:], caches,
                                                   pos)
            pos = ids.shape[1]
            logits = model._head(hidden[:, -1]).float()
            top2 = logits[0].topk(2).values
            margins.append((top2[0] - top2[1]).item())
            nxt = torch.argmax(logits, dim=-1)
            toks.append(int(nxt[0]))
            ids = torch.cat([ids, nxt[:, None]], dim=1)
    require(qi.i == len(rec), "the dense loop did not use every recorded "
            "int8 input")
    return toks, margins, sum(qi.flips)


def first_mismatch(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def ptq_vs_cpu(model, prompts):
    """The converted f32 model's first-token logits on the card against
    the same model on the CPU, for each prompt. Free, the CPU quantizes
    its own activations: a value whose ``a / s_in * qmax`` lies within
    f32 noise of a rounding boundary can round the other way (a flip),
    which moves each output of that layer by ``(s_in / qmax) *
    |w_int8[k, n]| * (w_scale[n] / qmax)``, and the logits by what the
    later layers make of it: counted and printed, not gated. Replayed,
    the CPU multiplies the card's int8 inputs, so the int32 products are
    equal and the rest is f32 sums in another order, as phase 4's fp
    comparison: gated at its atol 1e-3."""
    cpu = copy.deepcopy(model).cpu()
    n_lin = sum(isinstance(m, QuantedInferenceLinear)
                for m in model.modules())
    out = []
    for p in prompts:
        qi = QInputs()
        with qi:
            card = last_logits(model, p).cpu()
        qi.mode = "count"
        with qi:
            free = last_logits(cpu, p)
        qi.mode = "replay"
        with qi:
            replayed = last_logits(cpu, p)
        require(len(qi.rec) == n_lin and qi.i == n_lin,
                "the forwards did not reach every QuantedInferenceLinear")
        rec = dict(tokens=len(p),
                   replayed_err=(card - replayed).abs().max().item(),
                   free_err=(card - free).abs().max().item(),
                   layer0_flips=sum(qi.flips[:4]),
                   layer0_values=sum(t.numel() for t in qi.rec[:4]),
                   flips=sum(qi.flips),
                   values=sum(t.numel() for t in qi.rec))
        say(f"[engine ptq_f32] first-token logits vs CPU ({len(p)} tokens): "
            f"replayed int8 inputs max abs err {rec['replayed_err']:.3g} "
            f"(atol 1e-3); free {rec['free_err']:.3g} with "
            f"{rec['layer0_flips']} of {rec['layer0_values']} layer-0 int8 "
            f"inputs and {rec['flips']} of {rec['values']} in all layers "
            f"rounded the other way (information)")
        require(rec["replayed_err"] <= 1e-3, "ptq_f32: first-token logits "
                "differ from the CPU on the card's int8 inputs")
        out.append(rec)
    del cpu
    return out


def serve_ptq(cfg, dtype, econf, prompts, new, fp_gens, tag):
    """Phase 16, one run: the seed's GPT-3 1.3B in ``dtype`` through PTQ
    (calibrated on ``prompts``), converted and served: ``i8i8_matmul``
    launched 96 times a prefill and a decode step and ``wo_matmul``
    never; the tokens against the dense path fed the served int8 inputs
    (``dense_replay``); in f32 the first-token logits against the CPU
    (``ptq_vs_cpu``). Returns the run's record and its launches."""
    model = GPTForCausalLM(cfg, seed=1234).to(dtype)
    t0 = time.perf_counter()
    n_q = ptq_convert(model, prompts)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    per_pass = 4 * cfg.num_layers
    require(n_q == per_pass, f"{tag}: {n_q} QuantedInferenceLinear, want "
            f"{per_pass}")
    g, lq, st = serve(model, EngineConfig(**econf, kv_dtype=dname(dtype)),
                      prompts, new)
    want = per_pass * (st["prefills"] + st["decode_steps"])
    require(lq["i8i8_matmul"] == want,
            f"{tag}: i8i8_matmul launched {lq['i8i8_matmul']} times, want "
            f"{want} ({per_pass} a prefill and a decode step)")
    require(lq["wo_matmul"] == 0, f"{tag}: wo_matmul launched")
    for n in ("flash_fwd", "paged_decode"):
        require(lq[n] > 0, f"{tag}: {n} never launched")
    # the served tokens against the dense path fed the served int8
    # inputs (one request at a time, so each call's rows are one
    # request's): equal but at near ties of the existing rule; the batched
    # run against the one-at-a-time run (the same int8 inputs row by row):
    # equal but where the replayed margin is a near tie
    tie = NEAR_TIE if dtype == torch.float32 else NEAR_TIE_BF16
    g1, recs = serve_one_at_a_time(model, econf, dtype, prompts, new)
    ties, flips, margins_all = [], 0, []
    for p, gs, gb, rec in zip(prompts, g1, g, recs):
        toks, margins, n_flip = dense_replay(model, p, new, rec)
        flips += n_flip
        margins_all.append(min(margins))
        for what, other in (("one-at-a-time", gs), ("batched", gb)):
            i = first_mismatch(toks, other)
            if i is not None:
                require(margins[i] < tie, f"{tag}: token {i} of a "
                        f"{len(p)}-token prompt: {what} served {other[i]}, "
                        f"dense with the served int8 inputs {toks[i]}, "
                        f"margin {margins[i]:.3g}")
                ties.append((what, len(p), i, margins[i]))
    del recs
    # the dense path rounding its own int8 inputs (information)
    _, free = dense_check(model, prompts, g, new, None)
    st.update(calibration_s=calib_s, quanted_linears=n_q,
              near_ties=len(ties), tie_margins=ties,
              replay_int8_inputs_rounded_otherwise=flips,
              replay_smallest_margin=min(margins_all),
              free_dense_mismatches=free, launches=lq,
              act_scales_layer0=[model.gpt.h[0].get_submodule(n).act_scale
                                 for n in ("attn.qkv", "attn.out_proj",
                                           "mlp.up", "mlp.down")],
              tokens_agreeing_with_fp=sum(
                  a == b for x, y in zip(g, fp_gens) for a, b in zip(x, y)),
              prefix_agreeing_with_fp=[
                  next((i for i, (a, b) in enumerate(zip(x, y)) if a != b),
                       new) for x, y in zip(g, fp_gens)])
    if dtype == torch.float32:
        st["vs_cpu"] = ptq_vs_cpu(model, prompts[:2])
    sp = st["step_profile"]
    say(f"[engine {tag}] decode {st['decode_tok_s']:.1f} tokens/s, prefill "
        f"{st['prefill_tok_s']:.1f} tokens/s, TTFT mean "
        f"{st['ttft_mean_s'] * 1e3:.1f} ms max {st['ttft_max_s'] * 1e3:.1f} "
        f"ms, peak {st['peak_memory_gib']:.2f} GiB; traced decode step "
        f"{sp['device_ms']:.3f} ms of device work, idle share "
        f"{sp['idle_share']:.3f}, by group {json.dumps(sp['by_group'])}; "
        f"tokens agreeing with the fp run {st['tokens_agreeing_with_fp']} of "
        f"{new * len(prompts)} (information, not gates)")
    say(f"[engine {tag}] served tokens == the dense path on the served int8 "
        f"inputs ({st['near_ties']} near ties, smallest replayed margin "
        f"{st['replay_smallest_margin']:.3g}; the dense path alone would "
        f"round {flips} int8 inputs the other way); against the dense path "
        f"rounding its own: first mismatches (prompt, token, margin) "
        f"{free} (information)")
    say(f"[engine {tag}] {st}")
    del model
    torch.cuda.empty_cache()
    return st, lq


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
    profile = step_profile(prof, wall_ms, step_s * 1e3)
    groups = device_groups(prof, STACK_GROUPS)
    run = dict(bench=bench, warmup_loss=warm, losses=losses,
               traced_loss=traced, step_times_s=times,
               first_step_s=first_s, peak_memory_gib=peak_gb,
               backward_route=route,
               launches_per_step={n: launches[n] / steps for n in KERNELS},
               step_profile=profile, device_ms_by_group=groups,
               flash_share_of_device=groups["flash"] / profile["device_ms"])
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


# ------------------------------------------------------- phases 7, 8, 9
def ernie_setup(layers, device, bf16, seed=0):
    """``bench_ernie``'s model and step: ERNIE-3.0-base with dropout
    off and stacked blocks at ``layers`` blocks, AMP O2 bf16 when
    ``bf16``, ``AdamW(2e-5, multi_precision=True)`` with ``fused=None``
    (``FLAGS_fused_optimizer_step`` is off: the eager update), through
    ``jit.train_step``."""
    cfg = ernie3_base(hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                      stacked_blocks=True, num_layers=layers)
    model = ErnieForSequenceClassification(cfg, device=device, seed=seed)
    if bf16:
        model = amp.decorate(model, level="O2", dtype="bfloat16")
    return model, ernie_step(model)


def ernie_step(model):
    opt = AdamW(learning_rate=2e-5, parameters=model.parameters(),
                multi_precision=True)

    def train_fn(ids, labels, mask=None):
        _, loss = model(ids, attention_mask=mask, labels=labels)
        return loss
    return jit.train_step(train_fn, opt)


def ernie_batches(n, batch, device):
    """``bench_ernie``'s batches: ids, then labels, from
    ``RandomState(0)``, as its ``mk`` draws them."""
    rs = np.random.RandomState(0)
    vocab = ernie3_base().vocab_size
    out = []
    for _ in range(n):
        ids = rs.randint(0, vocab, (batch, ERNIE["seq"])).astype(np.int32)
        lbl = rs.randint(0, 2, (batch,)).astype(np.int32)
        out.append((torch.as_tensor(ids, dtype=torch.long, device=device),
                    torch.as_tensor(lbl, dtype=torch.long, device=device)))
    return out


def padding_mask(batch, device, seed=1):
    """SST-2-style padding: row lengths 16..128 from ``seed``."""
    lens = np.random.default_rng(seed).integers(16, ERNIE["seq"] + 1,
                                                size=batch)
    mask = np.arange(ERNIE["seq"])[None, :] < lens[:, None]
    return torch.as_tensor(mask.astype(np.int32), device=device), lens


def ernie_bf16(smi):
    """Phase 7: ERNIE-3.0-base at full width and depth, bf16 O2, stacked
    blocks, ``FLAGS_pallas_layer_norm`` on: 1 warm-up step, 5 timed
    steps, 1 traced step; exact launch counts per step. Returns the run
    record, its launches and the trained model and step (phase 9 goes on
    with them)."""
    model, step = ernie_setup(12, "cuda", bf16=True)
    cfg = model.cfg
    n_params = model.num_params()
    data = ernie_batches(7, ERNIE["batch"], "cuda")
    route = bwd_route(torch.bfloat16)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = float(step(*data[0]))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    losses, times = [], []
    for ids, lbl in data[1:6]:
        t0 = time.perf_counter()
        loss = step(ids, lbl)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        traced = float(step(*data[6]))
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = counts()
    steps = 7
    require(all(np.isfinite([warm, traced] + losses)),
            f"non-finite ERNIE loss: {[warm] + losses + [traced]}")
    n_ln = 1 + 2 * cfg.num_layers
    want = {"layer_norm_fwd": n_ln, "layer_norm_bwd": n_ln,
            "flash_fwd": cfg.num_layers, "adamw_step": 0}
    if route == "fused":
        want["flash_bwd_fused"] = cfg.num_layers
    else:
        want["flash_bwd_split_dkv"] = want["flash_bwd_split_dq"] = \
            cfg.num_layers
    for n, per_step in want.items():
        require(launches[n] == steps * per_step,
                f"ERNIE: {n} launched {launches[n]} times in {steps} "
                f"steps, want {per_step} a step")
    step_s = statistics.mean(times)
    seq, batch = ERNIE["seq"], ERNIE["batch"]
    tok_s = batch * seq / step_s
    flops_per_token = 6 * n_params + 12 * cfg.num_layers * seq * \
        cfg.hidden_size
    bench = dict(metric="ernie_sst2_finetune_tokens_per_sec", value=tok_s,
                 unit="tokens/s", step_time_s=step_s,
                 mfu_vs_chip_peak=tok_s * flops_per_token / PEAK_OPS[
                     torch.bfloat16],
                 model_params_m=n_params / 1e6,
                 config=dict(seq=seq, batch=batch, hidden=cfg.hidden_size,
                             layers=cfg.num_layers),
                 device=torch.cuda.get_device_name(0), nvidia_smi=smi,
                 loss=losses[-1])
    run = dict(bench=bench, warmup_loss=warm, losses=losses,
               traced_loss=traced, step_times_s=times, first_step_s=first_s,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               backward_route=route,
               launches_per_step={n: launches[n] / steps for n in KERNELS},
               step_profile=step_profile(prof, wall_ms, step_s * 1e3))
    return run, launches, model, step


def ernie_padded(model, step):
    """Phase 8: three more bf16 steps of the phase-7 model on padded
    batches (an ``attention_mask`` from row lengths 16..128): finite
    losses, the fused LayerNorm 25 + 25 times a step, and attention on
    the masked route (no flash launch)."""
    mask, lens = padding_mask(ERNIE["batch"], "cuda")
    data = ernie_batches(3, ERNIE["batch"], "cuda")
    reset_counts()
    losses = [float(step(ids, lbl, mask)) for ids, lbl in data]
    torch.cuda.synchronize()
    launches = counts()
    require(all(np.isfinite(losses)), f"non-finite padded losses {losses}")
    n_ln = 1 + 2 * model.cfg.num_layers
    for n in ("layer_norm_fwd", "layer_norm_bwd"):
        require(launches[n] == 3 * n_ln, f"padded run: {n} launched "
                f"{launches[n]} times in 3 steps, want {n_ln} a step")
    require(launches["flash_fwd"] == 0,
            "padded run: a masked call reached the flash kernel")
    return dict(losses=losses, row_lengths=lens.tolist(),
                launches=launches), launches


def ernie_f32_vs_cpu():
    """Phase 9: a 2-layer ERNIE at full width in f32 with the flag on
    (the split backward route), batch 8: two ``train_step`` calls on the
    card and on the CPU (plain versions) from the same weights and ids;
    losses to 1e-4 relative, the first step's gradients to 1e-4 of each
    gradient's largest magnitude. Then a padded forward (the masked
    attention route) on both: sequence output, pooled output and logits
    to 1e-4 (absolute below 1, relative above)."""
    model, step = ernie_setup(2, "cuda", bf16=False, seed=1)
    cpu = copy.deepcopy(model).cpu()
    cpu_step = ernie_step(cpu)
    data = ernie_batches(2, 8, "cpu")
    route = bwd_route(torch.float32)
    reset_counts()
    out = dict(backward_route=route, losses_card=[], losses_cpu=[])
    for i, (ids, lbl) in enumerate(data):
        out["losses_card"].append(float(step(ids.cuda(), lbl.cuda())))
        out["losses_cpu"].append(float(cpu_step(ids, lbl)))
        if i == 0:
            grad_err = max(
                ((p.grad.cpu() - q.grad).abs().max()
                 / q.grad.abs().max().clamp_min(1e-30)).item()
                for p, q in zip(model.parameters(), cpu.parameters()))
    mask, _ = padding_mask(8, "cpu", seed=2)
    ids = data[0][0]
    with torch.no_grad():
        got = model.ernie(ids.cuda(), attention_mask=mask.cuda())
        want = cpu.ernie(ids, attention_mask=mask)
        got += (model.classifier(got[1]),)
        want += (cpu.classifier(want[1]),)
    torch.cuda.synchronize()
    launches = counts()
    rel = [abs(a - b) / abs(b) for a, b in zip(out["losses_card"],
                                              out["losses_cpu"])]
    masked_err = max(((a.cpu() - b).abs() / b.abs().clamp_min(1.0)).max()
                     .item() for a, b in zip(got, want))
    out.update(loss_rel_err=rel, grad_rel_err=grad_err,
               masked_forward_err=masked_err, launches=launches)
    require(max(rel) <= 1e-4, f"ERNIE f32 loss, card vs CPU: relative "
            f"errors {rel} > 1e-4")
    require(grad_err <= 1e-4, f"ERNIE f32 gradients, card vs CPU: "
            f"{grad_err} > 1e-4 of the largest magnitude")
    require(masked_err <= 1e-4, f"ERNIE f32 padded forward, card vs CPU: "
            f"{masked_err} > 1e-4")
    kernels = (("flash_bwd_fused",) if route == "fused" else
               ("flash_bwd_split_dkv", "flash_bwd_split_dq"))
    for n in ("flash_fwd", "layer_norm_fwd", "layer_norm_bwd") + kernels:
        require(launches[n] > 0, f"{n} was not launched by the ERNIE f32 "
                f"run")
    return out, launches


# ------------------------------------------------------- phases 10, 11
# device kernels by what they do, from their names in the profile: the
# convolutions (cuDNN's kernels, its GEMMs and layout transforms),
# reductions (BatchNorm's mean and variance, the loss), pooling, the
# momentum kernel; "elementwise" is everything else (BatchNorm's chain,
# ReLU, the residual adds, casts, copies)
KERNEL_GROUPS = (("momentum_step", ("momentum_step_kernel",)),
                 ("convolution", ("cudnn", "xmma", "gemm", "cutlass",
                                  "implicit", "fprop", "dgrad", "wgrad",
                                  "nchwtonhwc", "nhwctonchw", "conv2d",
                                  "convolution")),
                 ("reduction", ("reduce_kernel",)),
                 ("pooling", ("pool",)))


def device_groups(prof, groups=KERNEL_GROUPS):
    """Device milliseconds of one traced step by kernel group."""
    out = {g: 0.0 for g, _ in groups}
    out["elementwise and other"] = 0.0
    for e in prof.key_averages():
        if e.device_time_total <= 0:
            continue
        key = e.key.lower()
        group = next((g for g, pats in groups
                      if any(p in key for p in pats)),
                     "elementwise and other")
        out[group] += e.device_time_total / 1e3
    return out


def resnet_step(model, fused=None):
    """``bench_resnet50``'s optimizer and step: ``Momentum(0.1, 0.9,
    multi_precision=True)`` (``fused=None`` follows
    ``FLAGS_fused_optimizer_step``) through ``jit.train_step`` over the
    f32 cross-entropy of the logits."""
    opt = Momentum(learning_rate=RESNET["lr"], momentum=RESNET["momentum"],
                   parameters=model.parameters(), multi_precision=True,
                   fused=fused)

    def train_fn(img, labels):
        return cross_entropy(model(img).float(), labels)
    return jit.train_step(train_fn, opt)


def resnet_batches(n, batch, size, classes, device, dtype=torch.float32):
    """``bench_resnet50``'s batches: images ``randn * 0.5``, then int32
    labels, from ``RandomState(0)``, as its ``mk`` draws them."""
    rs = np.random.RandomState(0)
    out = []
    for _ in range(n):
        img = (rs.randn(batch, 3, size, size) * 0.5).astype(np.float32)
        lbl = rs.randint(0, classes, (batch,)).astype(np.int32)
        out.append((torch.as_tensor(img, device=device).to(dtype),
                    torch.as_tensor(lbl, device=device)))
    return out


def resnet50_bf16(smi):
    """Phase 10: ResNet-50 at full width and depth, AMP O2 bf16,
    ``Momentum`` with ``FLAGS_fused_optimizer_step`` on, batch 128 at
    224x224: 1 warm-up step, 5 timed steps, 1 traced step; every loss
    finite, ``momentum_step`` exactly once a step (one launch for all
    161 tensors) and no other kernel. Then the same steps' time with
    ``torch.backends.cudnn.benchmark`` on (two more warm-up steps absorb
    its autotuning), for the record."""
    R = RESNET
    model = amp.decorate(resnet50(num_classes=R["classes"], seed=0),
                         level="O2", dtype="bfloat16")
    n_params = model.num_params()
    n_tensors = len(list(model.parameters()))
    step = resnet_step(model)
    data = resnet_batches(7, R["batch"], R["size"], R["classes"], "cuda",
                          torch.bfloat16)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = float(step(*data[0]))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    losses, times = [], []
    for img, lbl in data[1:6]:
        t0 = time.perf_counter()
        loss = step(img, lbl)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        traced = float(step(*data[6]))
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = 7
    require(all(np.isfinite([warm, traced] + losses)),
            f"non-finite ResNet-50 loss: {[warm] + losses + [traced]}")
    for n in KERNELS:
        per_step = 1 if n == "momentum_step" else 0
        require(launches[n] == steps * per_step,
                f"ResNet-50: {n} launched {launches[n]} times in {steps} "
                f"steps, want {per_step} a step")
    step_s = statistics.mean(times)
    ips = R["batch"] / step_s
    model_flops = ips * 3 * RESNET_FWD_FLOPS
    bench = dict(metric="resnet50_imagenet_images_per_sec", value=ips,
                 unit="images/s", step_time_s=step_s,
                 mfu_vs_chip_peak=model_flops / PEAK_OPS[torch.bfloat16],
                 mfu_2_flops_per_multiply_add=2 * model_flops / PEAK_OPS[
                     torch.bfloat16],
                 model_params_m=n_params / 1e6, param_tensors=n_tensors,
                 config=dict(batch=R["batch"], image=R["size"]),
                 device=torch.cuda.get_device_name(0), nvidia_smi=smi,
                 loss=losses[-1])
    cudnn_default = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        for img, lbl in data[:2]:
            step(img, lbl)
        bench_times = []
        for img, lbl in data[1:6]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(img, lbl)
            torch.cuda.synchronize()
            bench_times.append(time.perf_counter() - t0)
    finally:
        torch.backends.cudnn.benchmark = cudnn_default
    run = dict(bench=bench, warmup_loss=warm, losses=losses,
               traced_loss=traced, step_times_s=times, first_step_s=first_s,
               peak_memory_gib=peak_gb,
               launches_per_step={n: launches[n] / steps for n in KERNELS},
               step_profile=step_profile(prof, wall_ms, step_s * 1e3),
               device_ms_by_group=device_groups(prof),
               cudnn_benchmark=dict(default=cudnn_default,
                                    on_step_times_s=bench_times,
                                    on_step_s=statistics.mean(bench_times)))
    return run, launches


def resnet18_f32_vs_cpu():
    """Phase 11: ``resnet18`` (10 classes) in f32 on 64x64 images, batch
    4 (``bench_resnet50``'s CPU profile), ``Momentum(fused=True)``: two
    ``train_step`` calls on the card and on the CPU (plain versions)
    from the same weights and images; losses to 1e-4 relative, the first
    step's gradients to 1e-4 of each gradient's largest magnitude, every
    ``_mean``/``_variance`` buffer after both steps to 1e-4 (absolute
    below 1, relative above). Then the CPU model's trained state (its
    weights and running statistics) is copied to the card, and an
    eval-mode forward's logits agree to 1e-4 (absolute below 1,
    relative above): on one set of weights, so that the check measures
    the forward and not the spread that cuDNN's nondeterministic
    backward sums leave in each side's weights (two steps from the
    initial running statistics the eval-mode activations grow to
    ~1e4-1e5, which amplifies that spread past 1e-4). An f64 copy on the
    CPU takes the same steps, and the CPU's own f32 gaps to it are
    recorded beside: a ReLU input within f32 rounding of 0 flips its
    unit between two f32 runs of the gradients."""
    C = RESNET_CHECK
    model = resnet18(num_classes=C["classes"], seed=0)
    cpu = copy.deepcopy(model).cpu()
    f64 = copy.deepcopy(cpu).double()
    step = resnet_step(model, fused=True)
    cpu_step = resnet_step(cpu, fused=True)
    f64_step = resnet_step(f64, fused=True)     # the eager chain on f64
    data = resnet_batches(2, C["batch"], C["size"], C["classes"], "cpu")
    reset_counts()
    out = dict(losses_card=[], losses_cpu=[])
    for i, (img, lbl) in enumerate(data):
        out["losses_card"].append(float(step(img.cuda(), lbl.cuda())))
        out["losses_cpu"].append(float(cpu_step(img, lbl)))
        f64_step(img.double(), lbl)
        if i == 0:
            grad_err = max(
                ((p.grad.cpu() - q.grad).abs().max()
                 / q.grad.abs().max().clamp_min(1e-30)).item()
                for p, q in zip(model.parameters(), cpu.parameters()))
            f64_err = max(
                ((q.grad.double() - r.grad).abs().max()
                 / r.grad.abs().max().clamp_min(1e-30)).item()
                for q, r in zip(cpu.parameters(), f64.parameters()))
    buf_err = max(((a.cpu() - b).abs() / b.abs().clamp_min(1.0)).max().item()
                  for a, b in zip(model.buffers(), cpu.buffers()))
    card = copy.deepcopy(cpu).cuda()
    ref64 = copy.deepcopy(cpu).double()
    for m in (card, cpu, ref64):
        m.eval()
    with torch.no_grad():
        got = card(data[0][0].cuda()).cpu()
        want = cpu(data[0][0])
        ref = ref64(data[0][0].double())
    torch.cuda.synchronize()
    launches = counts()

    def of_max(a, b):
        return ((a.double() - b).abs().max() / b.abs().max()).item()

    def per_element(a, b):
        return ((a.double() - b).abs() / b.abs().clamp_min(1.0)).max().item()
    eval_err = per_element(got, want)
    rel = [abs(a - b) / abs(b) for a, b in zip(out["losses_card"],
                                              out["losses_cpu"])]
    out.update(loss_rel_err=rel, grad_rel_err=grad_err,
               cpu_f32_vs_f64_grad_rel_err=f64_err, buffer_err=buf_err,
               eval_logits_err=eval_err,
               eval_logits_of_largest_err=of_max(got, want),
               eval_logits_largest=want.abs().max().item(),
               cpu_f32_vs_f64_eval_err=per_element(want, ref),
               cpu_f32_vs_f64_eval_of_largest_err=of_max(want, ref),
               launches=launches)
    require(max(rel) <= 1e-4, f"resnet18 f32 loss, card vs CPU: relative "
            f"errors {rel} > 1e-4")
    require(grad_err <= 1e-4, f"resnet18 f32 gradients, card vs CPU: "
            f"{grad_err} > 1e-4 of the largest magnitude (the CPU's f32 "
            f"against f64: {f64_err})")
    require(buf_err <= 1e-4, f"resnet18 BatchNorm buffers, card vs CPU: "
            f"{buf_err} > 1e-4")
    require(eval_err <= 1e-4, f"resnet18 eval logits, card vs CPU: "
            f"{eval_err} > 1e-4")
    require(launches["momentum_step"] == 2,
            f"resnet18: momentum_step launched {launches['momentum_step']} "
            f"times in 2 steps, want one a step")
    return out, launches


# ------------------------------------------------------- phases 12, 13
def varlen_meta(lens_q, lens_k, causal, dev):
    """The port's memoized metadata and tile ranges for one packed
    batch, and the block-diagonal keep mask ``[Tq, Tk]`` it encodes."""
    lq = np.asarray(lens_q, np.int64)
    lk = np.asarray(lens_k if lens_k is not None else lens_q, np.int64)
    cu_q = np.concatenate([[0], np.cumsum(lq)])
    cu_k = np.concatenate([[0], np.cumsum(lk)])
    seg_q, off_q, seg_k, off_k, tiles = fa._seg_off_device(
        cu_q, cu_k, lq, lk, causal, dev)
    keep = (seg_q[:, None] == seg_k[None, :]) & \
        (off_k[None, :] <= off_q[:, None])
    return (seg_q, off_q, seg_k, off_k), tiles, keep


# operations per live (query, key) pair and head-dim element, and the
# rows each kernel must read and write in the input dtype: forward q,
# k, v in and o out; dK/dV q, do, k, v in and dk, dv out; dQ q, do, k, v
# in and dq out; the fused backward q, do, k, v in and dq, dk, dv out
# (its f32 dQ buffer is the kernel's choice, left out as in the dense
# row). lse (and delta) add 4 (8) bytes a query row and head, the int32
# seg/off metadata 8 bytes a row on each side
VARLEN_WORK = {
    "flash_varlen_fwd": (4, lambda Tq, Tk: 2 * Tq + 2 * Tk, 4),
    "flash_varlen_bwd_dkv": (8, lambda Tq, Tk: 2 * Tq + 4 * Tk, 8),
    "flash_varlen_bwd_dq": (6, lambda Tq, Tk: 3 * Tq + 2 * Tk, 8),
    "flash_varlen_bwd_fused": (10, lambda Tq, Tk: 3 * Tq + 4 * Tk, 8),
}


def varlen_bound(name, pairs, Tq, Tk, H, D, dtype, size):
    ops_per, elems, stat_bytes = VARLEN_WORK[name]
    ops = ops_per * pairs * D * H
    nbytes = (elems(Tq, Tk) * H * D * size + stat_bytes * Tq * H
              + 8.0 * (Tq + Tk))
    return bound(ops, nbytes, dtype)


def check_varlen_misaligned(gen, dev, H=16, D=128):
    """A bf16 packed batch (the serving lengths) whose q, k and v are
    contiguous views starting 2 bytes past a 16-byte boundary, which TMA
    cannot read in place: ``flash_attention_varlen_packed`` copies them
    and gives, bitwise, what it gives for aligned copies of them."""
    meta, tiles, keep = varlen_meta(VARLEN_SERVING, None, True, dev)
    T = keep.shape[0]
    n = T * H * D
    buf = torch.randn(3 * n + 1, generator=gen, device=dev).to(
        torch.bfloat16)
    q, k, v = (buf[1 + i * n:1 + (i + 1) * n].view(T, H, D)
               for i in range(3))
    require(q.is_contiguous() and q.data_ptr() % 16 != 0,
            "the misaligned varlen check's view is aligned")
    before = flash_varlen_fwd.launches
    o = flash_attention_varlen_packed(q, k, v, *meta, tiles=tiles)
    o_aligned = flash_attention_varlen_packed(
        *(t.clone() for t in (q, k, v)), *meta, tiles=tiles)
    torch.cuda.synchronize()
    require(flash_varlen_fwd.launches == before + 2,
            "the misaligned varlen check did not launch the kernel twice")
    same = torch.equal(o, o_aligned)
    require(same, "a misaligned bf16 packed view differs from its aligned "
            "copy")
    return dict(name="flash_varlen_misaligned", dtype="bfloat16",
                shape=f"T{T} H{H} D{D}, views at +2 bytes", bitwise=same)


def check_varlen(dtype, H, D, lens_q, lens_k, causal, gen, dev, timed):
    """The varlen kernels against their plain versions on one packed
    batch: the forward and the split backward pair, and in bf16 the
    fused backward (tensor cores); the f32 backward twice, bitwise. Rows
    that see no key get dq = 0, keys that no row sees dk = dv = 0. With
    ``timed``, each kernel's row for phase 3's table (the SDPA yardstick
    over the packed rows with the block-diagonal mask) and the densify
    route's time."""
    meta, (q_tiles, k_tiles), keep = varlen_meta(lens_q, lens_k, causal,
                                                 dev)
    Tq, Tk = keep.shape
    q, do = (torch.randn(Tq, H, D, generator=gen, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(Tk, H, D, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    scale = 1.0 / D ** 0.5
    lens = f"lens {lens_q}" + (f" / k {lens_k}" if lens_k else "")
    shape = (VARLEN_LINE_SHAPE if (lens_q == VARLEN_README and D == 128
                                   and causal) else
             f"H{H} D{D} Tq{Tq} Tk{Tk} " + ("causal" if causal
                                             else "non-causal")
             + ("" if timed else f" {lens}"))
    if timed and lens_q == VARLEN_SERVING:
        shape += " (serving prompt lengths)"
    o, lse = flash_varlen_fwd(q, k, v, *meta, q_tiles, scale)
    o_ref, lse_ref = flash_varlen_fwd_reference(q, k, v, *meta, scale)
    delta = (do.float() * o.float()).sum(-1).t().contiguous()
    dk, dv = flash_varlen_bwd_dkv(q, k, v, do, lse, delta, *meta, k_tiles,
                                  scale)
    dq = flash_varlen_bwd_dq(q, k, v, do, lse, delta, *meta, q_tiles, scale)
    grads = {"split": (dq, dk, dv)}
    if dtype == torch.bfloat16:
        grads["fused"] = flash_varlen_bwd_fused(q, k, v, do, lse, delta,
                                                *meta, k_tiles, scale)
    # the plain backward's f32 sums, before the one rounding the kernels
    # also do at their end (see half_step_err)
    dk_ref, dv_ref = flash_varlen_bwd_dkv_reference(
        q, k, v, do, lse, delta, *meta, scale, out_dtype=torch.float32)
    dq_ref = flash_varlen_bwd_dq_reference(q, k, v, do, lse, delta, *meta,
                                           scale, out_dtype=torch.float32)
    torch.cuda.synchronize()
    dead = torch.isinf(lse_ref)
    require(torch.equal(torch.isinf(lse), dead) and
            not o[dead.t()].float().abs().any().item(),
            f"flash_varlen_fwd {dname(dtype)} {shape} {lens}: rows that see "
            f"no key must give o = 0 and lse = -inf")
    fin = ~dead
    fwd_err = max((o.float() - o_ref.float()).abs().max().item(),
                  (lse[fin] - lse_ref[fin]).abs().max().item()
                  if fin.any() else 0.0)
    require(fwd_err <= TOL[dtype], f"flash_varlen_fwd {dname(dtype)} "
            f"{shape} {lens}: {fwd_err} > {TOL[dtype]}")
    tol = BWD_TOL[dtype]
    unseen = ~keep.any(0)
    bwd_err, bwd_abs, fused_stats = {}, {}, None
    for route, (gq, gk, gv) in grads.items():
        require(not gq[dead.t()].any().item() and
                not gk[unseen].any().item() and not gv[unseen].any().item(),
                f"flash_varlen {route} backward {dname(dtype)} {shape} "
                f"{lens}: rows that see no key must give dq = 0, keys no "
                f"row sees dk = dv = 0")
        bwd_err[route], bwd_abs[route] = {}, {}
        for name, got, ref in (("dq", gq, dq_ref), ("dk", gk, dk_ref),
                               ("dv", gv, dv_ref)):
            bwd_abs[route][name] = (got.float() - ref).abs().max().item()
            bwd_err[route][name] = half_step_err(got, ref)
        if route == "fused":
            # near ties flip single dS elements: gate the share of
            # elements off the rounded f32 sums, not the largest error
            fused_stats = varlen_bwd_stats((gq, gk, gv),
                                           (dq_ref, dk_ref, dv_ref))
            require(fused_stats["off_share"] <= VARLEN_OFF_SHARE,
                    f"flash_varlen fused backward {dname(dtype)} {shape} "
                    f"{lens}: {fused_stats['off_share']} of the elements "
                    f"are not the plain f32 sums rounded (limit "
                    f"{VARLEN_OFF_SHARE}; {fused_stats})")
        else:
            require(max(bwd_err[route].values()) <= tol, f"flash_varlen "
                    f"{route} backward {dname(dtype)} {shape} {lens}: "
                    f"{bwd_err[route]} > {tol}")
    unrounded = None
    if timed and dtype == torch.bfloat16:
        # what a backward that skips the P/dS rounding reads: the limit
        # must catch it
        up = [t.float() for t in (q, k, v, do)]
        un = flash_varlen_bwd_dkv_reference(*up, lse, delta, *meta, scale)
        un = (flash_varlen_bwd_dq_reference(*up, lse, delta, *meta, scale),
              *un)
        un = [a.to(dtype) for a in un]
        refs = (dq_ref, dk_ref, dv_ref)
        unrounded = dict(max_err=[half_step_err(a, b)
                                  for a, b in zip(un, refs)],
                         off_share=varlen_bwd_stats(un, refs)["off_share"])
        require(max(unrounded["max_err"]) > tol and
                unrounded["off_share"] > VARLEN_OFF_SHARE,
                f"flash_varlen bf16 {shape}: the plain backward without "
                f"P/dS rounding reads {unrounded}, within the limits {tol} "
                f"(largest, the split pair's) or {VARLEN_OFF_SHARE} (share, "
                f"the fused kernel's)")
        del up, un
    bitwise = None
    if dtype == torch.float32:
        dk2, dv2 = flash_varlen_bwd_dkv(q, k, v, do, lse, delta, *meta,
                                        k_tiles, scale)
        dq2 = flash_varlen_bwd_dq(q, k, v, do, lse, delta, *meta, q_tiles,
                                  scale)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in
                      ((dk, dk2), (dv, dv2), (dq, dq2)))
        require(bitwise, f"flash_varlen f32 backward {shape} {lens} is not "
                f"bitwise reproducible")
    if not timed:
        return [dict(name="flash_varlen", dtype=dname(dtype), shape=shape,
                     fwd_err=fwd_err, dq_dk_dv_err=bwd_err,
                     dq_dk_dv_abs_err=bwd_abs, tol=(TOL[dtype], tol),
                     fused_stats=fused_stats, f32_bwd_bitwise=bitwise)]
    split_abs, split_err = bwd_abs["split"], bwd_err["split"]
    pairs = int(keep.sum().item())
    mask = keep[None, None]

    def sdpa(qq, kk, vv):
        return F.scaled_dot_product_attention(
            qq.transpose(0, 1)[None], kk.transpose(0, 1)[None],
            vv.transpose(0, 1)[None], attn_mask=mask, scale=scale)
    lib_fwd = cuda_ms(lambda: sdpa(q, k, v))
    lib_fwd_dev = device_ms(lambda: sdpa(q, k, v), "")[0]
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o_lib = sdpa(qr, kr, vr)
    do_lib = do.transpose(0, 1)[None]

    def sdpa_bwd():
        return torch.autograd.grad(o_lib, (qr, kr, vr), do_lib,
                                   retain_graph=True)
    lib_bwd = cuda_ms(sdpa_bwd)
    lib_bwd_dev = device_ms(sdpa_bwd, "")[0]
    del qr, kr, vr, o_lib
    runs = {
        "flash_varlen_fwd": (
            lambda: flash_varlen_fwd(q, k, v, *meta, q_tiles, scale),
            lambda: flash_varlen_fwd_reference(q, k, v, *meta, scale),
            fwd_err, None, (lib_fwd, lib_fwd_dev),
            "SDPA, block-diagonal causal mask"),
        "flash_varlen_bwd_dkv": (
            lambda: flash_varlen_bwd_dkv(q, k, v, do, lse, delta, *meta,
                                         k_tiles, scale),
            lambda: flash_varlen_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                   *meta, scale),
            max(split_abs["dk"], split_abs["dv"]), max(split_err.values()),
            (lib_bwd, lib_bwd_dev),
            "SDPA backward (dq, dk, dv), block-diagonal causal mask"),
        "flash_varlen_bwd_dq": (
            lambda: flash_varlen_bwd_dq(q, k, v, do, lse, delta, *meta,
                                        q_tiles, scale),
            lambda: flash_varlen_bwd_dq_reference(q, k, v, do, lse, delta,
                                                  *meta, scale),
            split_abs["dq"], max(split_err.values()), (lib_bwd, lib_bwd_dev),
            "SDPA backward (dq, dk, dv), block-diagonal causal mask"),
    }
    if dtype == torch.bfloat16:
        runs["flash_varlen_bwd_fused"] = (
            lambda: flash_varlen_bwd_fused(q, k, v, do, lse, delta, *meta,
                                           k_tiles, scale),
            lambda: flash_varlen_bwd_fused_reference(q, k, v, do, lse,
                                                     delta, *meta, scale),
            max(bwd_abs["fused"].values()), max(bwd_err["fused"].values()),
            (lib_bwd, lib_bwd_dev),
            "SDPA backward (dq, dk, dv), block-diagonal causal mask")
    rows = []
    for name, (run, plain, err, scaled, (lib, lib_dev),
               lib_what) in runs.items():
        ms = cuda_ms(run)
        dev_ms, kern_ms = device_ms(run, VARLEN_KERNEL_NAMES[name, dtype])
        plain_ms = cuda_ms(plain, iters=3, warmup=1)
        b_ms, b_by = varlen_bound(name, pairs, Tq, Tk, H, D, dtype,
                                  q.element_size())
        fused = name == "flash_varlen_bwd_fused"
        rows.append(dict(name=name, dtype=dname(dtype), shape=shape,
                         max_abs_err=err, scaled_err=scaled,
                         tol=(TOL[dtype] if name.endswith("fwd") else
                              VARLEN_OFF_SHARE if fused else tol),
                         metric="off_share" if fused else None,
                         off_share=fused_stats["off_share"] if fused
                         else None,
                         unrounded_err=unrounded, f32_bwd_bitwise=bitwise,
                         live_pairs=pairs, ms=ms,
                         device_ms=dev_ms, kernel_device_ms=kern_ms,
                         plain_ms=plain_ms, library_ms=lib,
                         library_device_ms=lib_dev, library=lib_what,
                         bound_ms=b_ms, bound_by=b_by))
        torch.cuda.empty_cache()
    if lens_q == VARLEN_README and D == 128:
        cu = torch.as_tensor(np.concatenate([[0], np.cumsum(lens_q)]),
                             dtype=torch.int32, device=dev)
        mx = max(lens_q)

        def public():
            return flash_attn_unpadded(q, k, v, cu, cu, mx, mx, scale,
                                       causal=causal)[0]
        packed_ms = cuda_ms(public, iters=10)
        with sdp_kernel(enable_flash=False):
            densify_ms = cuda_ms(public, iters=5, warmup=1)
        rows[0].update(route_ms=dict(packed=packed_ms, densify=densify_ms))
    return rows


# the fused varlen backward on inputs from {-1, 0, 1}: f32 sums of
# exactly rounded terms in another order than the plain version's
EXACT_TOL = 1e-5
# and on batches with sequences of no rows or no keys: 300 keys that no
# row sees leave two 128-key blocks a walk of nothing (lens_q, lens_k)
VARLEN_EMPTY = [([0, 100], [300, 100]), ([20, 0, 6, 30], [8, 5, 10, 0])]


def check_varlen_exact(H, D, lens_q, lens_k, causal, gen, dev):
    """The bf16 fused backward on q, k, v and dO drawn from {-1, 0, 1}:
    every score and dP sum is an integer, exact in any order, so the
    kernel's P and dS round as the plain version's do, and no bf16 flip
    at a rounding boundary (see ``half_step_err``) can hide a pair seen
    twice or not at all: held to ``EXACT_TOL`` of the plain version's
    f32 sums beyond half a bf16 step."""
    meta, (q_tiles, k_tiles), keep = varlen_meta(lens_q, lens_k, causal,
                                                 dev)
    Tq, Tk = keep.shape

    def draw(T):
        return torch.randint(-1, 2, (T, H, D), generator=gen,
                             device=dev).to(torch.bfloat16)
    q, do, k, v = draw(Tq), draw(Tq), draw(Tk), draw(Tk)
    scale = 1.0 / D ** 0.5
    o, lse = flash_varlen_fwd(q, k, v, *meta, q_tiles, scale)
    delta = (do.float() * o.float()).sum(-1).t().contiguous()
    got = flash_varlen_bwd_fused(q, k, v, do, lse, delta, *meta, k_tiles,
                                 scale)
    ref = flash_varlen_bwd_fused_reference(q, k, v, do, lse, delta, *meta,
                                           scale, out_dtype=torch.float32)
    torch.cuda.synchronize()
    err = {n: half_step_err(g, r) for n, g, r in zip(("dq", "dk", "dv"),
                                                      got, ref)}
    shape = (f"H{H} D{D} Tq{Tq} Tk{Tk} "
             + ("causal" if causal else "non-causal") + f" lens {lens_q}"
             + (f" / k {lens_k}" if lens_k else ""))
    require(max(err.values()) <= EXACT_TOL, f"flash_varlen_bwd_fused "
            f"{shape}, inputs in {{-1, 0, 1}}: {err} > {EXACT_TOL}")
    unseen = ~keep.any(0)
    require(not got[0][torch.isinf(lse).t()].any().item() and
            not got[1][unseen].any().item() and
            not got[2][unseen].any().item(), f"flash_varlen_bwd_fused "
            f"{shape}: rows that see no key must give dq = 0, keys no row "
            f"sees dk = dv = 0")
    return dict(name="flash_varlen_exact", dtype="bfloat16", shape=shape,
                dq_dk_dv_err=err, tol=EXACT_TOL)


def varlen_batches(n, device, seed=0):
    """``n`` packed batches: sequence lengths of ``min_len..max_len``
    from ``RandomState(seed)``, drawn until the next would pass
    ``max_tokens``; activations and targets from the same stream."""
    V = VARLEN_TRAIN
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lens = []
        while True:
            L = int(rs.randint(V["min_len"], V["max_len"] + 1))
            if sum(lens) + L > V["max_tokens"]:
                break
            lens.append(L)
        T = sum(lens)
        x = torch.as_tensor(rs.randn(T, V["hidden"]).astype(np.float32),
                            device=device)
        y = torch.as_tensor(rs.randn(T, V["hidden"]).astype(np.float32),
                            device=device)
        cu = torch.as_tensor(np.concatenate([[0], np.cumsum(lens)]),
                             dtype=torch.int32, device=device)
        out.append((x, y, cu, max(lens)))
    return out


class PackedSelfAttention(torch.nn.Module):
    """A user's self-attention layer over packed sequences: a qkv
    projection, ``nn.functional.flash_attn_unpadded`` (causal), an out
    projection, no biases."""

    def __init__(self, hidden, heads):
        super().__init__()
        self.heads = heads
        self.qkv = torch.nn.Linear(hidden, 3 * hidden, bias=False)
        self.out = torch.nn.Linear(hidden, hidden, bias=False)

    def forward(self, x, cu, max_len, **kw):
        T, hidden = x.shape
        d = hidden // self.heads
        qkv = self.qkv(x).view(T, 3, self.heads, d)
        o, _ = flash_attn_unpadded(qkv[:, 0], qkv[:, 1], qkv[:, 2], cu, cu,
                                   max_len, max_len, 1.0 / d ** 0.5,
                                   causal=True, **kw)
        return self.out(o.reshape(T, hidden))


class PackedModel(torch.nn.Module):

    def __init__(self, hidden, heads, layers):
        super().__init__()
        self.layers = torch.nn.ModuleList(
            PackedSelfAttention(hidden, heads) for _ in range(layers))

    def forward(self, x, cu, max_len):
        for layer in self.layers:
            x = x + layer(x, cu, max_len)
        return x


def varlen_setup(device, bf16, seed=0):
    V = VARLEN_TRAIN
    torch.manual_seed(seed)
    model = PackedModel(V["hidden"], V["heads"], V["layers"]).to(device)
    if bf16:
        model = amp.decorate(model, level="O2", dtype="bfloat16")
    opt = AdamW(1e-4, parameters=model.parameters(), multi_precision=True,
                fused=True)

    def train_fn(x, y, cu, max_len):
        dt = next(model.parameters()).dtype
        out = model(x.to(dt), cu, max_len)
        return ((out.float() - y) ** 2).mean()
    return model, jit.train_step(train_fn, opt, layers=[model])


def varlen_train(smi):
    """Phase 13: the packed model at full width in bf16 O2, 1 warm-up,
    5 timed and 1 traced step, then the first batch again; launch
    counts a step, the memo; one step on the host's trace; then the
    qkvpacked, dropout and ``sdp_kernel`` routes."""
    V = VARLEN_TRAIN
    model, step = varlen_setup("cuda", bf16=True)
    data = varlen_batches(8, "cuda")
    fa._SEG_CACHE.clear()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = float(step(*data[0]))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    losses, times = [], []
    for b in data[1:6]:
        t0 = time.perf_counter()
        loss = step(*b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        traced = float(step(*data[6]))
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    memo = len(fa._SEG_CACHE)
    repeat = float(step(*data[0]))
    torch.cuda.synchronize()
    launches = counts()
    steps = 8
    all_losses = [warm] + losses + [traced, repeat]
    require(all(np.isfinite(all_losses)),
            f"non-finite varlen training loss: {all_losses}")
    require(len(fa._SEG_CACHE) == memo == 7, f"the cu_seqlens memo: "
            f"{memo} entries after 7 batches, {len(fa._SEG_CACHE)} after "
            f"the first again (want 7 and 7)")
    # bf16: the forward and the fused backward once a layer, and no
    # split pair
    want = {n: V["layers"] for n in ("flash_varlen_fwd",
                                      "flash_varlen_bwd_fused")}
    want.update({n: 0 for n in ("flash_varlen_bwd_dkv",
                                "flash_varlen_bwd_dq")})
    want["adamw_step"] = 2 * V["layers"]
    want.update({n: 0 for n in DENSE_FLASH_KERNELS})
    for n, per_step in want.items():
        require(launches[n] == steps * per_step,
                f"{n}: {launches[n]} launches in {steps} varlen steps, want "
                f"{per_step} a step")
    # where the host's time goes in a step over a batch of new lengths
    # (the device trace does not show it): host ops by self CPU time
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as hprof:
        step(*data[7])
        torch.cuda.synchronize()
    host_top = sorted(hprof.key_averages(),
                      key=lambda e: -e.self_cpu_time_total)[:8]
    tokens = [int(b[2][-1]) for b in data[1:6]]
    step_s = statistics.mean(times)
    run = dict(config=dict(V, params=sum(p.numel()
                                         for p in model.parameters())),
               tokens_per_step=tokens, sequences_per_step=[
                   len(b[2]) - 1 for b in data[1:6]],
               tokens_per_s=sum(tokens) / sum(times), step_time_s=step_s,
               step_times_s=times, first_step_s=first_s, warmup_loss=warm,
               losses=losses, traced_loss=traced, repeat_loss=repeat,
               launches_per_step={n: launches[n] / steps for n in KERNELS
                                  if launches[n]},
               step_profile=step_profile(prof, wall_ms, step_s * 1e3),
               host_top_self_cpu_ms=[(e.key[:60], e.self_cpu_time_total / 1e3,
                                      e.count) for e in host_top],
               device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    # the public routes beside the training path, on the first batch
    x, _, cu, mx = data[0]
    T = x.shape[0]
    qkv = torch.randn(T, 3, V["heads"], V["hidden"] // V["heads"],
                      device="cuda").to(torch.bfloat16)
    scale = 1.0 / (V["hidden"] // V["heads"]) ** 0.5
    args = (cu, cu, mx, mx, scale)
    packed, _ = flash_attn_varlen_qkvpacked(qkv, *args, causal=True)
    plain, _ = flash_attn_unpadded(qkv[:, 0], qkv[:, 1], qkv[:, 2], *args,
                                   causal=True)
    require(torch.equal(packed, plain), "flash_attn_varlen_qkvpacked "
            "differs from the unpacked call")
    before = counts()
    dropped, _ = flash_attn_unpadded(qkv[:, 0], qkv[:, 1], qkv[:, 2], *args,
                                     dropout=0.1, causal=True,
                                     generator=torch.Generator(
                                         device="cuda").manual_seed(0))
    with sdp_kernel(enable_flash=False):
        dense, _ = flash_attn_unpadded(qkv[:, 0], qkv[:, 1], qkv[:, 2],
                                       *args, causal=True)
    torch.cuda.synchronize()
    after = counts()
    require(all(after[n] == before[n] for n in VARLEN_KERNELS),
            "dropout or sdp_kernel(enable_flash=False) reached a varlen "
            "kernel")
    # the densify route rounds the scores to bf16 before its softmax
    # (as the JAX package's XLA route): ~1e-2 from the packed route
    dense_err = (dense.float() - plain.float()).abs().max().item()
    require(torch.isfinite(dropped.float()).all().item()
            and dense_err <= 0.1,
            f"the densify route: finite dropout output, and {dense_err} "
            f"from the packed route (limit 0.1)")
    run.update(qkvpacked_equal=True, densify_vs_packed_err=dense_err)
    del qkv, packed, plain, dropped, dense, model, step
    torch.cuda.empty_cache()
    return run, launches


def varlen_f32_vs_cpu(dev):
    """``flash_attn_unpadded``'s output and q/k/v gradients in f32 on
    the card and on the CPU (plain versions), H4 D64, lengths 1, 7, 64,
    100, 200, causal and not: to 1e-4 of each tensor's largest
    magnitude."""
    lens = [1, 7, 64, 100, 200]
    T, H, D = sum(lens), 4, 64
    cu = np.concatenate([[0], np.cumsum(lens)])
    rs = np.random.RandomState(3)
    host = [torch.as_tensor(rs.randn(T, H, D).astype(np.float32))
            for _ in range(4)]
    out = {}
    reset_counts()
    for causal in (True, False):
        res = []
        for device in (dev, "cpu"):
            q, k, v = (t.to(device, copy=True).requires_grad_()
                       for t in host[:3])
            o, _ = flash_attn_unpadded(q, k, v, cu, cu, max(lens), max(lens),
                                       1.0 / D ** 0.5, causal=causal)
            (o * host[3].to(device)).sum().backward()
            res.append([t.detach().cpu() for t in (o, q.grad, k.grad,
                                                   v.grad)])
        errs = [((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(*res)]
        out["causal" if causal else "non-causal"] = errs
        require(max(errs) <= 1e-4, f"varlen f32 card vs CPU (causal="
                f"{causal}): out/dq/dk/dv errors {errs} > 1e-4 of the "
                f"largest magnitude")
    torch.cuda.synchronize()
    launches = counts()
    for n in VARLEN_KERNELS:
        want = 0 if n == "flash_varlen_bwd_fused" else 2
        require(launches[n] == want, f"{n}: {launches[n]} launches in the "
                f"f32 check, want {want}")
    return out, launches


# ------------------------------------------------------- phases 14, 15
# the stack's device kernels by what they do (cuBLAS's GEMMs by their
# names' stems); "elementwise and other" is the rest (casts, the residual
# adds, SwiGLU, the loss, the AdamW copies back)
STACK_GROUPS = (("flash", ("flash_",)), ("rms_norm", ("rms_norm",)),
                ("rope", ("rope_kernel",)), ("adamw_flat", ("adamw_flat",)),
                ("gemm", ("gemm", "cutlass", "xmma", "sm90_xmma", "nvjet",
                          "cublas")))


def stack_params(cfg, seed=0):
    """The stack's weights, f32 on the CPU from ``torch.Generator``
    seeded with ``seed``: for each layer ``w_attn [h]``, ``W_qkv [h,
    3h]``, ``W_o [h, h]``, ``w_mlp [h]``, ``W_1 [h, 2·ffn]`` and ``W_2
    [ffn, h]``, then the final norm's ``w [h]``. Norm weights ``1 +
    N(0, 0.1²)``, matrices ``N(0, 0.02²)``."""
    gen = torch.Generator().manual_seed(seed)
    h, f = cfg["hidden"], cfg["ffn"]
    norm = lambda: 1 + 0.1 * torch.randn(h, generator=gen)
    mat = lambda *shape: 0.02 * torch.randn(*shape, generator=gen)
    out = []
    for _ in range(cfg["layers"]):
        out += [norm(), mat(h, 3 * h), mat(h, h), norm(), mat(h, 2 * f),
                mat(f, h)]
    return out + [norm()]


def stack_setup(host, device, dtype):
    """Parameters in ``dtype`` on ``device`` from the f32 ``host``
    weights, and each one's AdamW state: f32 m and v at 0 and an f32
    master copy."""
    params = [t.to(device=device, dtype=dtype, copy=True).requires_grad_()
              for t in host]
    state = [dict(m=torch.zeros(t.shape, device=device),
                  v=torch.zeros(t.shape, device=device),
                  master=t.to(device=device, copy=True)) for t in host]
    return params, state


def stack_data(cfg, n, seed=0):
    """``n`` input batches ``[batch, seq, hidden]`` from a
    ``torch.Generator`` seeded with ``seed`` and one target from
    ``RandomState(seed)``, f32 on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    shape = (cfg["batch"], cfg["seq"], cfg["hidden"])
    xs = [torch.randn(*shape, generator=gen) for _ in range(n)]
    tgt = torch.from_numpy(np.random.RandomState(seed).randn(*shape)
                           .astype(np.float32))
    return xs, tgt


def stack_loss(params, x, tgt, cfg):
    """The stack from the public functionals: for each layer
    ``y = fused_rms_norm(h, w_attn)``, ``q, k, v = y @ W_qkv``, half-split
    RoPE on q and k, causal ``flash_attention``, ``a = out @ W_o``,
    ``y2, h = fused_rms_norm(a, w_mlp, residual=h)``,
    ``h = h + swiglu(y2 @ W_1) @ W_2``; then a final ``fused_rms_norm``
    and the mean squared error against ``tgt`` in f32."""
    B, S, hid = x.shape
    nh = cfg["heads"]
    h = x
    for i in range(cfg["layers"]):
        w_attn, w_qkv, w_o, w_mlp, w_1, w_2 = params[6 * i:6 * i + 6]
        y = IF.fused_rms_norm(h, w_attn)
        qkv = (y @ w_qkv).reshape(B, S, 3, nh, hid // nh)
        q, k, _ = IF.fused_rotary_position_embedding(
            qkv[:, :, 0], qkv[:, :, 1], use_neox_rotary_style=False)
        o, _ = fa.flash_attention(q, k, qkv[:, :, 2], causal=True)
        a = o.reshape(B, S, hid) @ w_o
        y2, h = IF.fused_rms_norm(a, w_mlp, residual=h)
        h = h + IF.swiglu(y2 @ w_1) @ w_2
    out = IF.fused_rms_norm(h, params[-1])
    return ((out.float() - tgt) ** 2).mean()


def stack_step(params, state, x, tgt, cfg, t, keep_grads=False):
    """One loop step: ``loss.backward()``, then one
    ``fused_adamw_kernel`` (lr ``STACK_LR``, step ``t``) for each tensor,
    its outputs copied back. Returns the loss and, with ``keep_grads``,
    the gradients before the update."""
    loss = stack_loss(params, x, tgt, cfg)
    loss.backward()
    grads = [p.grad.clone() for p in params] if keep_grads else None
    with torch.no_grad():
        for p, st in zip(params, state):
            outs = IF.fused_adamw_kernel(p, p.grad, st["m"], st["v"],
                                         st["master"], STACK_LR, step=t)
            for dst, src in zip((p, st["m"], st["v"], st["master"]), outs):
                dst.copy_(src)
            p.grad = None
    return loss.detach(), grads


def stack_bf16(smi, dev):
    """Phase 14: the stack at GPT-3 1.3B's width in bf16 with f32
    masters, 1 warm-up, 5 timed and 1 traced step; the launches a step;
    then the neox route and ``position_ids`` past S on the card."""
    cfg = STACK
    host = stack_params(cfg)
    n_params = sum(t.numel() for t in host)
    params, state = stack_setup(host, dev, torch.bfloat16)
    del host
    xs, tgt = stack_data(cfg, 7)
    xs = [x.to(dev, torch.bfloat16) for x in xs]
    tgt = tgt.to(dev)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = float(stack_step(params, state, xs[0], tgt, cfg, 1)[0])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    losses, times = [], []
    for t, x in enumerate(xs[1:6], start=2):
        t0 = time.perf_counter()
        loss, _ = stack_step(params, state, x, tgt, cfg, t)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        traced = float(stack_step(params, state, xs[6], tgt, cfg, 7)[0])
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = 7
    all_losses = [warm] + losses + [traced]
    require(all(np.isfinite(all_losses)),
            f"non-finite incubate stack loss: {all_losses}")
    L = cfg["layers"]
    want = {"rms_norm_fwd": 2 * L + 1, "rms_norm_bwd": 2 * L + 1,
            "rope": 4 * L, "adamw_flat": len(params), "flash_fwd": L,
            "flash_bwd_fused": L}
    for n in KERNELS:
        require(launches[n] == steps * want.get(n, 0),
                f"incubate stack: {n} launched {launches[n]} times in "
                f"{steps} steps, want {want.get(n, 0)} a step")
    step_s = statistics.mean(times)
    tokens = cfg["batch"] * cfg["seq"]
    run = dict(config=dict(cfg, params=n_params, param_tensors=len(params),
                           depth_cut="24 layers to 2"),
               tokens_per_s=tokens / step_s, step_time_s=step_s,
               step_times_s=times, first_step_s=first_s, warmup_loss=warm,
               losses=losses, traced_loss=traced, peak_memory_gib=peak_gb,
               launches_per_step={n: launches[n] / steps for n in KERNELS
                                  if launches[n]},
               step_profile=step_profile(prof, wall_ms, step_s * 1e3),
               device_ms_by_group=device_groups(prof, STACK_GROUPS),
               device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    run["flash_share_of_device"] = (run["device_ms_by_group"]["flash"] /
                                    run["step_profile"]["device_ms"])
    del params, state, xs, tgt
    torch.cuda.empty_cache()
    # beside the path: the neox route reaches no RoPE kernel, and
    # positions past S equal the window of a longer sequence
    q = torch.randn(1, 4, 16, 128, generator=torch.Generator(
        device=dev).manual_seed(5), device=dev)
    before = rope.launches
    IF.fused_rotary_position_embedding(q, q, use_neox_rotary_style=True)
    torch.cuda.synchronize()
    require(rope.launches == before,
            "a neox-style RoPE call launched the RoPE kernel")
    pos = (torch.arange(4, device=dev) + 100)[None]
    out, _, _ = IF.fused_rotary_position_embedding(
        q, position_ids=pos, use_neox_rotary_style=False)
    big = torch.cat([torch.zeros(1, 100, 16, 128, device=dev), q], 1)
    ref, _, _ = IF.fused_rotary_position_embedding(
        big, use_neox_rotary_style=False)
    pos_err = (out - ref[:, 100:]).abs().max().item()
    require(pos_err <= 1e-6 * ref.abs().max().item(),
            f"position_ids 100..103: {pos_err} from the window of the "
            f"longer sequence")
    run.update(neox_launched_rope=False, position_ids_past_s_err=pos_err)
    return run, launches


def stack_f32_vs_cpu(dev):
    """Phase 15: the stack at ``STACK_CHECK`` in f32, two loop steps on
    the card and on the CPU (plain versions) from the same weights and
    batches; losses to 1e-4 relative, the first step's gradients to
    1e-4 of each tensor's largest magnitude, every parameter, m, v and
    master after both steps to 1e-5 of its largest magnitude."""
    cfg = STACK_CHECK
    host = stack_params(cfg, seed=1)
    xs, tgt = stack_data(cfg, 2, seed=1)
    reset_counts()
    runs = []
    for device in (dev, "cpu"):
        params, state = stack_setup(host, device, torch.float32)
        losses, grads = [], None
        for t, x in enumerate(xs, start=1):
            loss, g = stack_step(params, state, x.to(device),
                                 tgt.to(device), cfg, t, keep_grads=t == 1)
            losses.append(float(loss))
            grads = grads or g
        runs.append(dict(losses=losses, grads=grads,
                         tensors=[(p.detach(), st["m"], st["v"],
                                   st["master"])
                                  for p, st in zip(params, state)]))
    torch.cuda.synchronize()
    launches = counts()
    card, cpu = runs
    rel = lambda a, b: ((a.cpu() - b).abs().max()
                        / b.abs().max().clamp_min(1e-30)).item()
    loss_err = [abs(a - b) / abs(b) for a, b in
                zip(card["losses"], cpu["losses"])]
    grad_err = max(rel(a, b) for a, b in zip(card["grads"], cpu["grads"]))
    state_err = {what: max(rel(a[i], b[i]) for a, b in
                           zip(card["tensors"], cpu["tensors"]))
                 for i, what in enumerate(("param", "m", "v", "master"))}
    out = dict(config=cfg, losses_card=card["losses"],
               losses_cpu=cpu["losses"], loss_rel_err=loss_err,
               grad_rel_err=grad_err, state_rel_err=state_err,
               launches=launches)
    require(max(loss_err) <= 1e-4, f"incubate stack f32, card vs CPU: "
            f"loss relative errors {loss_err} > 1e-4")
    require(grad_err <= 1e-4, f"incubate stack f32, card vs CPU: first "
            f"step's gradients {grad_err} > 1e-4 of the largest magnitude")
    require(max(state_err.values()) <= 1e-5, f"incubate stack f32, card "
            f"vs CPU: after two steps {state_err} > 1e-5 of the largest "
            f"magnitude")
    for n in INCUBATE_KERNELS:
        require(launches[n] > 0, f"{n} was not launched by the f32 run")
    return out, launches


def kernel_name(mangled):
    """A mangled kernel name as ``name`` or ``name<D>``: the first
    ``<length><identifier>`` in it whose identifier ends in ``_kernel``
    (a digit run may also end an anonymous namespace's id or file hash,
    so every suffix of one is tried as the length), then ``ILi<D>E``
    for a kernel templated on its head dim."""
    for m in re.finditer(r"(?=(\d+))", mangled):
        digits = m.group(1)
        n, at = int(digits), m.start() + len(digits)
        ident = mangled[at:at + n]
        if len(ident) == n and ident.endswith("_kernel") and \
                re.fullmatch(r"[A-Za-z_]\w*", ident):
            t = re.match(r"ILi(\d+)E", mangled[at + n:])
            return ident + (f"<{t.group(1)}>" if t else "")
    return mangled


def ptxas_report(log):
    """ptxas's lines for each kernel of a build log: the kernel (with its
    head dim), its registers and its spills."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_name(m.group(1))
        elif name and ("registers" in line or "spill" in line):
            out.setdefault(name, []).append(line.strip())
    return out


def check_wgmma_build():
    """Phase 2 for the tensor-core kernels: each library's SASS holds
    HGMMA (wgmma) instructions, and ptxas's register and spill lines for
    each of their kernels."""
    cuobjdump = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" /
        "cuobjdump")
    out = {}
    for name in WGMMA_LIBRARIES:
        lib = _build._lib_path(_build.sources()[name])
        sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        hgmma = sum("HGMMA" in line for line in sass.splitlines())
        report = ptxas_report(lib.with_suffix(".log").read_text())
        say(f"[build] {name}: {hgmma} HGMMA instructions in the SASS")
        for kernel, lines in report.items():
            say(f"[build] {kernel}: {'; '.join(lines)}")
        require(hgmma > 0, f"{name}: no HGMMA instruction in {lib.name}: "
                f"the tensor-core kernels do not use wgmma")
        out[name] = dict(hgmma=hgmma, ptxas=report)
    return out


def line_row(rows, n):
    """The row the kernels line reports for kernel ``n``: its main
    path's bf16 shape (the fused AdamW state is f32)."""
    def wanted(r):
        if r["name"] != n:
            return False
        if n in ("adamw_step", "momentum_step"):
            return r["dtype"] == "float32"
        if n == "i8i8_matmul":
            return r["shape"] == I8_LINE_SHAPE
        if r["dtype"] != "bfloat16":
            return False
        if n == "flash_fwd":
            return "B1 H16 S1024" in r["shape"]
        return r["shape"] == LINE_SHAPES.get(n, r["shape"])
    return next(r for r in rows if wanted(r))


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
    wgmma = check_wgmma_build()

    # 3. kernels against their plain versions
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    rows, ragged = [], []
    # the last two slices' kernels first: late in a long run the profiler
    # has been seen to drop records (see device_ms)
    for label, (K, N) in I8_SHAPES.items():
        for M in (8, 1008):
            rows.append(check_i8i8(M, K, N, label, gen, dev))
    ragged.append(check_i8i8(3, 200, 333, "ragged", gen, dev, timed=False))
    ragged.append(check_i8i8(32, 8192, 256, "all +-127", gen, dev,
                             timed=False, fill="pm127"))
    ragged += [check_int4(8, 2048, 8192, dtype, gen, dev, "up")
               for dtype in (torch.bfloat16, torch.float32)]
    torch.cuda.empty_cache()
    for case in RMS_CASES:
        rows += check_rms_norm(*case, gen, dev, timed=True)
    for case in RMS_RAGGED:
        ragged += check_rms_norm(*case, gen, dev, timed=False)
    for dtype in (torch.bfloat16, torch.float32):
        for B, S, H, D, table, timed in ROPE_CASES:
            (rows if timed else ragged).append(
                check_rope(B, S, H, D, table, dtype, gen, dev, timed))
    for N, pdt, timed in ADAMW_FLAT_CASES:
        (rows if timed else ragged).append(
            check_adamw_flat(N, pdt, gen, dev, timed))
        torch.cuda.empty_cache()
    for dtype in (torch.bfloat16, torch.float32):
        for S in (128, 1024, 2048):
            rows.append(check_flash(dtype, S, gen, dev))
        rows.append(check_paged(dtype, gen, dev, rng, split=False))
        rows.append(check_paged(dtype, gen, dev, rng, split=True))
    # the fused backward (the bf16 route) at the serving shapes
    ragged += [r for S in (128, 1024, 2048)
               for r in check_flash_bwd(torch.bfloat16, 1, 16, S, S, 128,
                                        gen, dev, timed=False,
                                        routes=("fused",))]
    # the training path's shapes
    T = TRAIN
    hd = T["hidden"] // T["heads"]
    for dtype in (torch.bfloat16, torch.float32):
        rows.append(check_flash(dtype, T["seq"], gen, dev, B=T["batch"],
                                D=hd))
        rows += check_flash_bwd(dtype, T["batch"], T["heads"], T["seq"],
                                T["seq"], hd, gen, dev, timed=True)
    torch.cuda.empty_cache()
    # the incubate stack's attention (phase 14), bf16
    C = STACK
    rows.append(check_flash(torch.bfloat16, C["seq"], gen, dev,
                            B=C["batch"], D=C["hidden"] // C["heads"]))
    rows += check_flash_bwd(torch.bfloat16, C["batch"], C["heads"],
                            C["seq"], C["seq"], C["hidden"] // C["heads"],
                            gen, dev, timed=True, routes=("fused",))
    torch.cuda.empty_cache()
    # ragged: lengths around the tensor-core kernels' tiles, Sq < Sk
    for dtype in (torch.bfloat16, torch.float32):
        for D in (16, 64, 128):
            for Sq, Sk, causal in FLASH_RAGGED:
                ragged.append(check_flash_ragged(dtype, 2, 4, Sq, Sk, D,
                                                 causal, gen, dev))
                if causal:
                    # the split pair keeps its ragged shape, 200 / 333
                    ragged += check_flash_bwd(
                        dtype, 2, 4, Sq, Sk, D, gen, dev, timed=False,
                        routes=("fused", "split") if Sq == 200
                        else ("fused",))
    shapes = [tuple(p.shape) for p in
              train_setup(T["layers"], dev, bf16=False)[0].parameters()]
    rows.append(check_adamw(shapes, gen, dev))
    torch.cuda.empty_cache()
    o2 = amp.decorate(resnet50(device=dev), level="O2", dtype="bfloat16")
    rows.append(check_momentum([tuple(p.shape) for p in o2.parameters()],
                               [p.dtype for p in o2.parameters()], gen, dev))
    del o2
    torch.cuda.empty_cache()
    int8pack = int8pack_available(dev)
    for dtype in (torch.bfloat16, torch.float32):
        for label, (K, N) in WO_SHAPES.items():
            for M in (1, 8, 128, 1008):
                for with_bias in (False, True):
                    rows.append(check_wo(dtype, M, K, N, with_bias, gen, dev,
                                         label, int8pack))
        torch.cuda.empty_cache()
    ragged += [check_wo(dtype, M, 200, N, with_bias, gen, dev, "ragged",
                        False, timed=False)
               for M, N in ((3, 333), (37, 336))
               for dtype in (torch.bfloat16, torch.float32)
               for with_bias in (False, True)]
    ragged.append(check_wo_all_values(dev))
    for case in LN_CASES:
        rows += check_layer_norm(*case, gen, dev, timed=True)
    for case in LN_RAGGED:
        ragged += check_layer_norm(*case, gen, dev, timed=False)
    torch.cuda.empty_cache()
    # 12. the packed varlen kernels, into phase 3's rows
    for dtype in (torch.bfloat16, torch.float32):
        for lens, D in ((VARLEN_README, 128), (VARLEN_SERVING, 128),
                        (VARLEN_README, 64)):
            rows += check_varlen(dtype, 16, D, lens, None, True, gen, dev,
                                 timed=True)
    ragged += [r for dtype in (torch.bfloat16, torch.float32)
               for D in (16, 64, 128)
               for lens_q, lens_k, causal in VARLEN_RAGGED
               for r in check_varlen(dtype, 4, D, lens_q, lens_k, causal, gen,
                                     dev, timed=False)]
    # the tensor-core forward (bf16) at the timed batches, every head dim,
    # causal and not
    ragged += [r for lens in (VARLEN_README, VARLEN_SERVING)
               for D in (16, 64, 128) for causal in (True, False)
               for r in check_varlen(torch.bfloat16, 16, D, lens, None,
                                     causal, gen, dev, timed=False)]
    # the fused backward on exactly summed inputs: the ragged cases and
    # the timed batches, every head dim, causal and not
    ragged += [check_varlen_exact(4, D, lens_q, lens_k, causal, gen, dev)
               for D in (16, 64, 128)
               for lens_q, lens_k, causal in VARLEN_RAGGED]
    ragged += [check_varlen_exact(16, D, lens, None, causal, gen, dev)
               for lens in (VARLEN_README, VARLEN_SERVING)
               for D in (16, 64, 128) for causal in (True, False)]
    ragged += [check_varlen_exact(4, D, lens_q, lens_k, True, gen, dev)
               for D in (16, 64, 128) for lens_q, lens_k in VARLEN_EMPTY]
    ragged.append(check_varlen_misaligned(gen, dev))
    torch.cuda.empty_cache()
    for r in rows:
        say(f"[kernel] {r['name']} {r['dtype']} {r['shape']}: err "
            f"{r['max_abs_err']:.3g} (tol {r['tol']}) ms {r['ms']:.4f} "
            f"(device {r['device_ms']}, kernel {r['kernel_device_ms']}) "
            f"plain {r['plain_ms']:.4f} library {r['library_ms']} "
            f"(device {r.get('library_device_ms')}) bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']})"
            + (f" host {r['host_ms']:.4f} int8pack {r['int8pack_mm_ms']}"
               if r["name"].startswith("wo_matmul") else "")
            + (f" scaled {r['scaled_err']:.3g}, off the rounded sums "
               f"{r['off_share']:.3g}, unrounded {r['unrounded_err']}"
               if r.get("off_share") is not None else ""))
    for r in ragged:
        if r["name"].startswith(("layer_norm", "rms_norm")):
            say(f"[kernel] {r['name']} {r['dtype']} {r['shape']}: err "
                f"{r['max_abs_err']:.3g} (past the limit by "
                f"{r['excess_over_tol']:.3g}; {r['tol']})")
        elif r["name"] in ("wo_matmul", "wo_matmul_wgmma"):
            say(f"[kernel] wo_matmul {r['dtype']} {r['shape']}: err "
                f"{r['max_abs_err']:.3g} (scaled {r['scaled_err']:.3g}, tol "
                f"{r['tol']})")
        elif r["name"] in ("rope", "adamw_flat"):
            say(f"[kernel] {r['name']} {r['dtype']} {r['shape']}: err "
                f"{r['max_abs_err']:.3g} ({r['tol']})")
        elif r["name"] == "i8i8_matmul":
            say(f"[kernel] i8i8_matmul {r['shape']}: err "
                f"{r['max_abs_err']:.3g} ({r['tol']}), largest |sum| "
                f"{r['max_abs_sum']}, {r['k_splits']} K splits")
        elif r["name"] == "int4_weight_only_matmul":
            say(f"[kernel] int4_weight_only_matmul {r['dtype']} {r['shape']}: "
                f"err {r['max_abs_err']:.3g} (scaled {r['scaled_err']:.3g}, "
                f"tol {r['tol']}) ms {r['ms']:.4f}")
        elif r["name"] == "flash_fwd":
            say(f"[kernel] flash_fwd {r['dtype']} {r['shape']}: err "
                f"{r['max_abs_err']:.3g} (tol {r['tol']})")
        elif r["name"] == "flash_varlen_exact":
            say(f"[kernel] flash_varlen_bwd_fused {r['shape']}, inputs in "
                f"{{-1, 0, 1}}: dq/dk/dv err {r['dq_dk_dv_err']} (tol "
                f"{r['tol']})")
        elif r["name"] == "flash_varlen_misaligned":
            say(f"[kernel] flash_attention_varlen_packed {r['dtype']} "
                f"{r['shape']}: equal to its aligned copy {r['bitwise']}")
        elif r["name"] == "flash_varlen":
            say(f"[kernel] flash_varlen {r['dtype']} {r['shape']}: fwd err "
                f"{r['fwd_err']:.3g}, dq/dk/dv err {r['dq_dk_dv_err']} (tol "
                f"{r['tol']}), f32 backward bitwise {r['f32_bwd_bitwise']}"
                + (f", fused off the rounded sums "
                   f"{r['fused_stats']['off_share']:.3g} (limit "
                   f"{VARLEN_OFF_SHARE})" if r["fused_stats"] else ""))
        else:
            say(f"[kernel] flash_bwd {r['dtype']} {r['shape']}: dq/dk/dv "
                f"err {r['dq_dk_dv_err']} (tol {r['tol']}; the same in "
                f"{r['dtype']}: {r['dq_dk_dv_err_same_dtype']})")
    for r in rows:
        if "route_ms" in r:
            say(f"[kernel] flash_attn_unpadded {r['dtype']} {r['shape']}: "
                f"packed route {r['route_ms']['packed']:.4f} ms, densify "
                f"route {r['route_ms']['densify']:.4f} ms (CUDA events)")
    for r in rows:
        if r["name"] == "i8i8_matmul":
            say(f"[kernel] i8i8_matmul {r['shape']}: library "
                f"{r['library']}, {r['k_splits']} K splits")
    say(f"[kernel] wo_matmul library yardsticks: torch.mm over the weight "
        f"dequantized beforehand; torch._weight_int8pack_mm (w [N, K] int8, "
        f"scales in x's dtype): "
        f"{'timed' if int8pack else 'none on CUDA'}")

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
    # phase 3, on the serving model's real weights (before any engine
    # quantizes it)
    wo_bound = check_wo_bound(model, prompts[1])
    wo_payload = check_wo_payload(model)
    say(f"[kernel] wo_matmul layer-0 payload card == CPU: {wo_payload}")

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

    del model
    torch.cuda.empty_cache()
    for tag, dtype, fp_gens in (("int8_f32", torch.float32, gens),
                                ("int8_bf16", torch.bfloat16, gens16)):
        runs[tag], l8 = serve_int8(
            lambda dtype=dtype: GPTForCausalLM(cfg, seed=1234).to(dtype),
            dtype, econf, prompts, new, fp_gens, tag)
        add(l8)
    say(f"[engine] launches during the engine runs: {launches}")

    # 16. PTQ full-int8 serving at full width
    for tag, dtype, fp_gens in (("ptq_f32", torch.float32, gens),
                                ("ptq_bf16", torch.bfloat16, gens16)):
        runs[tag], lq = serve_ptq(cfg, dtype, econf, prompts, new, fp_gens,
                                  tag)
        add(lq)

    # 5. training at full width and depth
    train_rec, lt = train_bf16(smi)
    add(lt)
    say(f"[train bf16] {json.dumps(train_rec['bench'])}")
    say(f"[train bf16] device {train_rec['step_profile']['device_ms']:.2f} "
        f"ms a step, idle {train_rec['step_profile']['idle_share']:.3f}, "
        f"flash share {train_rec['flash_share_of_device']:.3f}, by group "
        f"{json.dumps(train_rec['device_ms_by_group'])}")
    say(f"[train bf16] {train_rec}")

    # 6. the card against the CPU, f32
    f32run, lf = train_f32_vs_cpu()
    add(lf)
    say(f"[train f32 vs cpu] {f32run}")

    # 7-9. fine-tuning ERNIE-3.0-base with the fused LayerNorm
    flags.set_flags({"pallas_layer_norm": True})
    ernie, le, ernie_model, ernie_train = ernie_bf16(smi)
    add(le)
    say(f"[ernie bf16] {json.dumps(ernie['bench'])}")
    say(f"[ernie bf16] {ernie}")
    padded, lp = ernie_padded(ernie_model, ernie_train)
    add(lp)
    say(f"[ernie padded] {padded}")
    del ernie_model, ernie_train
    torch.cuda.empty_cache()
    ernie32, l32e = ernie_f32_vs_cpu()
    add(l32e)
    say(f"[ernie f32 vs cpu] {ernie32}")
    flags.set_flags({"pallas_layer_norm": False})

    # 10-11. ResNet-50 with the fused Momentum step
    flags.set_flags({"fused_optimizer_step": True})
    resnet, lr50 = resnet50_bf16(smi)
    add(lr50)
    say(f"[resnet50 bf16] {json.dumps(resnet['bench'])}")
    say(f"[resnet50 bf16] {resnet}")
    flags.set_flags({"fused_optimizer_step": False})
    r18, lr18 = resnet18_f32_vs_cpu()
    add(lr18)
    say(f"[resnet18 f32 vs cpu] {r18}")

    # 13. packed varlen training, the public routes, the card vs the CPU
    varlen, lv = varlen_train(smi)
    add(lv)
    say(f"[varlen bf16] tokens/s {varlen['tokens_per_s']:.1f} step "
        f"{varlen['step_time_s'] * 1e3:.2f} ms device "
        f"{varlen['step_profile']['device_ms']:.2f} ms idle "
        f"{varlen['step_profile']['idle_share']:.3f}")
    say(f"[varlen bf16] host ops by self CPU ms, a step of new lengths: "
        f"{varlen['host_top_self_cpu_ms']}")
    say(f"[varlen bf16] {varlen}")
    varlen32, lv32 = varlen_f32_vs_cpu(dev)
    add(lv32)
    say(f"[varlen f32 vs cpu] {varlen32}")

    # 14-15. the incubate slice: the RMSNorm/RoPE/SwiGLU stack
    stack, ls = stack_bf16(smi, dev)
    add(ls)
    say(f"[incubate bf16] tokens/s {stack['tokens_per_s']:.1f} step "
        f"{stack['step_time_s'] * 1e3:.2f} ms device "
        f"{stack['step_profile']['device_ms']:.2f} ms idle "
        f"{stack['step_profile']['idle_share']:.3f} flash share "
        f"{stack['flash_share_of_device']:.3f} by group "
        f"{json.dumps(stack['device_ms_by_group'])}")
    say(f"[incubate bf16] {stack}")
    stack32, ls32 = stack_f32_vs_cpu(dev)
    add(ls32)
    say(f"[incubate f32 vs cpu] {stack32}")

    say(f"[main path] launches: {launches}")
    for n in KERNELS:
        require(launches[n] > 0, f"kernel {n} was never launched on the "
                f"main path")

    line = []
    for n, k in KERNELS.items():
        r = line_row(rows, n)
        line.append(dict(name=n, route="cuda", source=k["source"],
                         replaces=k["replaces"],
                         **{key: k[key] for key in ("also_replaces",
                                                    "f32_source")
                            if key in k},
                         launches=launches[n], shape=r["shape"],
                         dtype=r["dtype"], max_abs_err=r["max_abs_err"],
                         # the error the limit holds, where it is not
                         # max_abs_err (the flash backward's)
                         **{key: r[key] for key in ("scaled_err", "metric",
                                                    "off_share")
                            if r.get(key) is not None},
                         tol=r["tol"], ms=r["ms"], device_ms=r["device_ms"],
                         kernel_device_ms=r["kernel_device_ms"],
                         plain_ms=r["plain_ms"],
                         bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                         library_ms=r["library_ms"]))
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(
        dict(device=kind, nvidia_smi=smi, build_s=build_s,
             wgmma_build=wgmma, kernels=rows,
             ragged=ragged, wo_bound=wo_bound, wo_payload=wo_payload,
             int8pack_mm_on_cuda=int8pack, engine=runs,
             train_bf16=train_rec, train_f32_vs_cpu=f32run,
             ernie_bf16=ernie, ernie_padded=padded,
             ernie_f32_vs_cpu=ernie32, resnet50_bf16=resnet,
             resnet18_f32_vs_cpu=r18, varlen_bf16=varlen,
             varlen_f32_vs_cpu=varlen32, incubate_bf16=stack,
             incubate_f32_vs_cpu=stack32, launches=launches,
             seconds=time.perf_counter() - t_run), indent=1))
    say(f"[done] {time.perf_counter() - t_run:.1f} s")
    say(f"nvidia-smi: {smi}")
    say(json.dumps({"kernels": line}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
