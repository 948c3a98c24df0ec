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
   printed; every instantiation of the norms' vector forwards
   (``rms_norm_fwd_vec_kernel``, ``layer_norm_fwd_vec_kernel``, 45 each)
   must hold 16-byte loads (LDG.E.128), with its registers and spills;
   every kernel of the f32 libraries on the tensor cores (the split
   backward pair's ``flash_bwd_tf32x3``, the forward's
   ``flash_fwd_tf32x3``) and every instantiation of the TF32 prefill
   GEMM ``wo_gemm_tf32_kernel`` (in ``wo_matmul``, 6) and of the f32
   decode GEMV ``wo_gemv_tf32_kernel`` (in ``wo_matmul``, 4) must hold
   TF32 tensor-core instructions (HMMA ... .TF32), with ptxas's registers
   and spills for each (the instantiations the model's path runs spill
   nothing); every instantiation of
   the bf16 decode kernel ``wo_gemv_mma_kernel`` (in ``wo_matmul``, 4)
   must hold HMMA, with its registers and spills; every instantiation of
   the paged decode's ``paged_decode_cluster_kernel`` (2 dtypes x 3 head
   dims x 2 routes) must hold cp.async copies (LDGSTS) and every one of
   the flat AdamW's vector kernel ``adamw_flat_vec_kernel`` (3 x 3
   types) 16-byte loads (LDG.E.128), with their registers and spills;
   both int8 x int8 kernels' instantiations (``i8i8_wgmma_kernel<128,
   256>`` must hold IGMMA, wgmma with s8 operands;
   ``i8i8_gemv_mma_kernel``, 8, IMMA, mma.sync s8), with their registers
   and spills; every instantiation of the LayerNorm vector backward
   ``layer_norm_bwd_vec_kernel`` (30) and of RoPE's vector kernel
   ``rope_vec_kernel`` (18) must hold 16-byte loads (LDG.E.128), with
   their registers and spills.
3. Kernels against their plain versions, on the card, at the main
   path's shapes: the flash forward (B1 H16 D128, S 128/1024/2048,
   causal; bf16 on the wgmma kernel, f32 on the 3xTF32 one, whose rows
   are named ``flash_fwd_tf32x3``, are bounded by 3xTF32 with the CUDA
   cores' bound beside them, must be bitwise equal on a second run, and
   where the plain forward with its products in single-pass TF32 must
   read past the f32 limit),
   the paged decode on both routes (global, and split-K at 8 pages a
   split with the torch merge), in bf16 and f32, at H16 block 16 with
   x7 garbage in every stale slot: B8 D128 with contexts 2048..17 (the
   kernels line's row), B8 all 2048, B1 2048, B8 contexts 1..17, B1
   16,384, and the first shape at D 64 and 16; each bitwise equal on a
   second run, with its cluster plan, and on the first shape the
   wrapper's host time a call. Each prints its error
   against its tolerance, its median time from CUDA events, its device
   time from torch.profiler (all kernels of the call, and the port's
   kernel alone), the plain version's time, one library call's time
   where one computes the same function, its bound, and its launches.
   The flash backward (both routes: the fused kernel and the split
   dK/dV + dQ pair) at the training path's shape (B8 H16 S1024 D64,
   causal) in bf16 and f32 and at Sq 200 / Sk 333, and in f32 not
   causal at both; the fused route
   alone (the bf16 route) at the serving shapes, at the incubate
   stack's (B8 H16 S2048 D128, timed with the forward and SDPA beside
   it) and at S 127 and 129; the forward at those ragged shapes; all
   at head dims 16/64/128. The bf16 fused backward (tensor cores,
   another summation order) is held to the plain version's f32 sums
   beyond half a bf16 step, the split pair to the plain version in the
   input dtype, both with a limit that the plain backward without its
   P/dS rounding must exceed. The f32 split pair runs on the tensor
   cores in 3xTF32 (``flash_bwd_tf32x3.cu``): each f32 run of it is
   repeated and must be bitwise equal, its timed rows are named
   ``flash_bwd_split_dkv_tf32x3`` / ``flash_bwd_split_dq_tf32x3`` and
   bounded by 3xTF32 (3 x operations at 494.7 TFLOP/s; the CUDA cores'
   bound kept beside it), and at the timed shape the plain backward with its products in single-pass
   TF32 must read past the f32 limit; the fused AdamW step against the port's
   eager AdamW, bitwise (``torch.equal``), three steps on the training
   path's 16 parameter leaves (f32, bf16 with f32 masters, and their O2
   dtypes), one multi-tensor launch a step, and one step over the 16
   leaves timed all f32 and in the O2 dtypes (the kernels-line row),
   beside the parent's per-leaf chain rebuilt (widen, a one-tensor
   launch, cast and copy) and ``torch._fused_adamw_`` over the f32
   state, by events and device time. The fused momentum step against the port's
   eager Momentum, bitwise, three steps on ResNet-50's 161 parameter
   shapes (f32 plain, Nesterov, L2 decay 1e-4, bf16 with f32 masters,
   and ResNet-50's O2 list: bf16 convolutions and fc with f32 masters,
   f32 BatchNorm, L2 1e-4 but on the 1-D tensors), one launch a step;
   and one multi-tensor step over the 161 f32 tensors timed against
   ``torch._fused_sgd_`` (CUDA events and device time for both).
   The int8 weight-only matmul at GPT-3 1.3B's five projection shapes
   (qkv, out_proj, up, down, the tied head) at M 1, 8, 128 and 1008, in
   bf16 and f32, and in f32 at M 32 and 144 (the padded prompts of 17
   and 130 tokens), with and without a bias (bf16 at M 128 and 1008 on
   the prefill wgmma route, rows ``wo_matmul_wgmma``; f32 prefill on the
   TF32 tensor-core GEMM, rows ``wo_gemm_tf32``, and f32 decode at M 1
   and 8 on the TF32 decode GEMV ``wo_gemv_tf32_kernel``, rows
   ``wo_matmul``: both bounded by two TF32 passes with the CUDA cores'
   bound beside it, bitwise equal on a second run, and the plain version
   with x in single-pass TF32 must read past the f32 limit; bf16 at M 1
   and 8 on the decode tensor-core route, rows ``wo_gemv_mma``), both
   dtypes at M 2, 3, 4 and 5 at every projection (not timed), and at ragged
   shapes (M 3, K 200, N 333 and M 5, K 1030, N 7 on the decode routes,
   f32 M 8, K 20480, N 34816 in one K split, whose warps walk 5,120 rows
   each, past the 512 after which the f32 decode kernel adds its mma sums
   into a second sum; M 37, K 200, N 336 on the
   tensor cores; M 37, K 200, N 333, M 1008, K 204, N 336 and M 144, K
   20484, N 333, off TMA's rule, on the TF32 GEMM in both dtypes, and f32
   M 1008, K 20480, N 2048, past 8 splits of 2048 rows) and with x and w
   one element
   past a 16-byte boundary (M 8, M 2, M 37 and M 144), timed against
   ``torch.mm`` over the
   weight dequantized beforehand (by events and device time; and
   ``torch._weight_int8pack_mm`` where this torch has it on CUDA), with
   the wrapper's host time a call; every int8 value through the
   tensor-core route's widening, ``torch.equal`` to the plain version.
   Then, on the serving model's real weights and the activations that
   reach them on one prompt: the kernel's product
   stays within ``weight_quant_error_bound`` of ``x @ W`` (f64, on the
   host), a 4-bit payload of the same weight breaks that bound, and the
   bound is below ``max |x @ W|``; the decode routes hold it too on the
   last 1 and 8 rows, in f32 and cast to bf16 (with one bf16 rounding
   step of the output beside it); and layer 0's payload and scales
   quantized on the card equal those quantized on the CPU, bitwise.
   The int8 x int8 matmul at GPT-3 1.3B's four block projections (qkv,
   out_proj, up, down) at M 1, 8, 9 and 16 (decode batches, on the decode
   kernel ``i8i8_gemv_mma_kernel``) and 17, 32, 144 and 1008 (padded
   prefills, on the prefill kernel ``i8i8_wgmma_kernel``), at ragged
   shapes (M 3 and 37 at K 200, N 333, off TMA's rule, on the decode
   kernel; M 37 and 1008 at K 208, N 336 on the prefill kernel), all
   +-127 at K 8192 (the largest sums) and all -128 at K 131,200 (sums
   past 2**31, which wrap) at M 8 and 32, ``torch.equal`` to its plain
   version (the integers are exact), each call counted on the route its
   plan names; M 8, 32, 144 and 1008 timed (events, device time, the
   wrapper's host time) against ``torch._int_mm`` where that call takes
   the shape (M > 16, K and N multiples of 8), their rows named by kernel
   (``i8i8_matmul`` decode, ``i8i8_matmul_wgmma`` prefill); and
   ``int4_weight_only_matmul`` at the up projection (M 8, bf16 and f32;
   M 144 f32, on the TF32 GEMM) against the plain weight-only version on
   the unpacked payload.
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
   and every decode step, by route: the 96 projections of a prefill on
   the prefill tensor-core routes, in bf16 ``wgmma`` and in f32 ``gemm``
   (the TF32 GEMM, row ``wo_gemm_tf32``), every decode launch and each
   prefill's head on the
   decode tensor-core routes, in bf16 ``gemv_mma`` and in f32 ``gemv``
   (the TF32 decode GEMV, row ``wo_matmul``); how many tokens agree with
   the fp runs is printed, not gated.
5. Training at full width and full depth: ``bench.py``'s default GPT
   (vocab 32768, hidden 1024, 24 layers, 16 heads of 64, seq 1024,
   batch 8, labels = ids) with "dots" remat, stacked blocks, the fused
   head loss, AMP O2 bf16 and ``AdamW(1e-4, multi_precision=True,
   fused=True)`` through ``jit.train_step``: 1 warm-up step, 5 timed
   steps and 1 traced step. Every loss must be finite and the 5th timed
   loss below the 1st; each step must launch ``flash_fwd`` exactly 24
   times, the bf16 backward route's kernels 24 times each and
   ``adamw_step`` once (its 16 leaves in one launch). Prints a
   ``bench_gpt``-style line
   (tokens/s, step time, MFU against 989 TFLOP/s).
6. The card against the CPU: the same model at ``num_layers=2`` in f32
   (which takes the other backward route), batch 2: two ``train_step``
   calls on the card and on the CPU (plain versions) from the same
   weights and ids; both losses agree to 1e-4 relative, and the first
   step's gradients to 1e-4 of each gradient's largest magnitude; the
   traced first card step must run the f32 tensor-core kernels of the
   forward and the split pair (``flash_fwd_tf32x3_kernel``,
   ``flash_bwd_dkv_tf32x3_kernel``, ``flash_bwd_dq_tf32x3_kernel``),
   seen by name, and every forward and split launch must be one of
   theirs (the wrappers' ``route_launches``).
7. Fine-tuning at full width and full depth with
   ``FLAGS_pallas_layer_norm`` on: ``bench.py``'s ``bench_ernie``
   (ERNIE-3.0-base, vocab 40000, hidden 768, 12 layers, 12 heads of 64,
   dropout off, stacked blocks, AMP O2 bf16, ``AdamW(2e-5,
   multi_precision=True)`` with ``fused=None``, seq 128, batch 32, ids
   and labels from ``RandomState(0)``) through ``jit.train_step``: 1
   warm-up step, 5 timed steps and 1 traced step. Every loss must be
   finite; each step must launch ``layer_norm_fwd`` and
   ``layer_norm_bwd`` exactly 25 times (``emb_ln`` with f32 and 24
   stacked LayerNorms with bf16 scale and shift), every forward and
   every backward on the vector route (``layer_norm_fwd_vec_kernel``,
   ``layer_norm_bwd_vec_kernel``), ``flash_fwd`` and the
   bf16 backward route's kernel 12 times, and ``adamw_step`` never.
   Prints a ``bench_ernie``-style line (tokens/s, step time, MFU
   against 989 TFLOP/s) and the traced step's device time by kernel
   group (the LayerNorm forwards, the LayerNorm backwards, flash, the
   GEMMs, the rest) with its idle share.
8. Padded batches: three more steps of that model with an
   ``attention_mask`` from row lengths 16..128: finite losses, the
   LayerNorm kernels 25 times each a step (both directions on the
   vector route), attention on the masked
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
    pair never, ``adamw_step`` once, no dense flash kernel, the
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
    loss finite; each step launches exactly 5 RMSNorm forwards (all on
    the vector route, ``rms_norm_fwd_vec_kernel``), 5 RMSNorm
    backwards (all on the vector route, ``rms_norm_bwd_vec_kernel``), 8
    RoPE (4 forward, 4 backward, all on the vector route,
    ``rope_vec_kernel``), 13 flat AdamW (all on
    the vector route, ``adamw_flat_vec_kernel``), 2 dense
    flash forwards and 2 fused flash backwards, and no other kernel.
    Prints tokens/s, the step time, the traced step's device time by
    kernel group and the idle share. Then a neox-style call
    launches no RoPE kernel, and ``position_ids`` 100..103 on a sequence
    of 4 equal the matching window of a longer sequence.
15. The stack on the card against the CPU in f32 (hidden 256, 4 heads
    of 64, seq 256, batch 2, FFN 1024): two loop steps on each device
    from the same numpy weights; losses to 1e-4 relative, the first
    step's gradients to 1e-4 of each tensor's largest magnitude, and
    every parameter, m, v and master after both steps to 1e-5 of its
    largest magnitude.
16. PTQ full-int8 serving at full width (run after phase 4): the seed's
    GPT-3 1.3B at 8 of its 24 layers (``SERVING_CUT_LAYERS``; per-block
    storage) in f32 and in bf16, each
    block through ``PTQ(QuantConfig(FakeQuanterWithAbsMaxObserver,
    FakeQuanterChannelWiseAbsMaxObserver)).quantize``, calibrated by one
    dense forward over each of phase 4's prompts, converted (4
    ``QuantedInferenceLinear`` a layer, checked) and served as in phase 4:
    ``i8i8_matmul`` launched 4 times a layer a prefill and a decode step (the
    prefills' on the prefill kernel, the decode steps' on the decode
    kernel, counted apart), ``wo_matmul`` never, ``flash_fwd`` and
    ``paged_decode`` launched.
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
17. Prefix cache, drafts and admission on GPT-3 1.3B at 8 of its 24
    layers (``SERVING_CUT_LAYERS``; run after phase
    15): the seed's model with ``EngineConfig(block_size=16,
    num_blocks=1024, max_batch=8)``, in bf16 and then in f32, each with
    (a) the prefix cache: 8 requests of one 512-token system prompt (32
    blocks) and private tails of 17..488 tokens, 32 new tokens each; the
    first misses and the other seven hit all 32 shared blocks (fewer
    blocks allocated by exactly 7 x 32), the shared blocks' K and V in
    all its layers stay bitwise as the first prefill wrote them after
    every later round and at the end, ``audit_kv_ledger`` is clean at the
    end, and the tokens equal the cache-off run's but at near ties (the
    dense path's top-2 margin at the first mismatch, phase 4's rule;
    each divergence printed); (b) speculative decoding on phase 4's
    prompts: n-gram drafts (k 3, n-gram 2), an oracle drafter built from
    the plain run's tokens (every draft accepted, fewer decode steps)
    and a wrong one (every draft rejected, the same steps), and n-gram
    drafts on prompts that write a random 64-token span out twice with
    the model's own continuation between the copies (the best 8 of 64
    candidates; the drafter must
    draft, have drafts accepted and take fewer decode steps than its
    plain run), each stream equal to its plain run's but at near ties,
    in no more decode steps;
    (c) the paged decode at a verify step's shape, on both routes: 32
    query rows in groups of 4 that share a block table, at contexts
    p0+1..p0+4, against its plain version at the main shape's tolerance,
    one launch a call, bitwise on a second run, timed with its bound;
    (d) ``swap_weights`` between decode steps to a second seed's weights:
    the requests in flight finish, the later requests' tokens equal a
    fresh engine on the second model's but at near ties, and swapping
    the returned weights back restores the first bitwise. Every run
    launches one flash forward a layer a prefill and one global-route
    paged decode a layer a decode step. After both dtypes an int8
    weight-only f32 engine drafts on every step (the last token
    repeated): its ``wo_matmul`` launches are gated by route step by
    step (verify batches past 8 rows on the TF32 tensor-core GEMM
    ``wo_gemm_tf32_kernel``, the rest on the decode GEMV) and its tokens
    held against the quantized dense path at f32's near-tie rule. Printed with the option on and
    off: decode tokens/s, decode steps, TTFT, peak memory, the
    ``paged_decode`` launches, a traced step's idle share, drafting's
    host time a step, and the host time a step of the engine's table
    check (``_validate_tables``; phase 4's runs print it too).
18. The framework core ("core", run after phase 17): (a) every op case
    of the CPU tests' tables (``tests/torch_core_table_*.py``) once on
    cuda:0 against the same op on the CPU, at the tests' tolerances:
    outputs, dtypes, shapes and, for a differentiable op, the gradients
    of a random cotangent; and every random draw of the CPU tests on the
    card (the CPU draw's shape and dtype, equal draws after equal
    seeds). (b) ``import paddle2_tpu_torch as paddle`` at GPT-3 1.3B's
    width (2 of 24 layers, bf16, ids [4, 1024] from ``to_tensor`` after
    ``paddle.seed`` and ``set_device("gpu")``): ``paddle.grad`` of the
    loss with respect to every parameter twice with
    ``FLAGS_check_nan_inf`` off and once on: with the backward forced
    onto the split pair (no atomics) every gradient must rerun bitwise
    and equal the run with the flag on; on bf16's route (the fused
    backward, whose dQ atomics add in another order each run) each
    gradient must move with the flag no more than between the two runs
    without it plus one bfloat16 step of its magnitude; a hook that
    turns a block's output gradient into NaN must be reported by the op
    it ran (``aten.mul``) from autograd's device thread, and an infinite
    embedding row by ``aten.embedding``. (c) ``paddle.save`` of phase
    4's GPT-3 1.3B (seed 1234, bf16) to a temporary file, ``paddle.load``
    into a model of another seed (every leaf bitwise), a copy with one
    byte flipped raising ``CheckpointCorruptionError``, and the loaded
    model served through ``ServingEngine`` on phase 4's prompts: its
    tokens equal phase 4's bf16 run's, or, were a kernel not
    deterministic, differ first at a near tie of phase 4's bf16 rule;
    the save and load times and the file size are printed. (b) and (c)
    launch the flash forward, the fused flash backward and the paged
    decode.

19. Mixed precision and the optimizer stack ("amp"): float16 training
    of the bench GPT, overflow and resume, O1 against the CPU, packed
    varlen in float16, every optimizer against the CPU.
20. The ``paddle.nn`` layer surface ("nn"): the default
    ``nn.Transformer`` (Transformer-base: d_model 512, 8 heads, 6 + 6
    layers, d_ff 2048, dropout 0.1) built from the public ``nn`` and
    ``optimizer`` API as a user's script builds it (a shared
    ``nn.Embedding(37000, 512)`` scaled by sqrt(512) plus sinusoidal
    positions, ``attn_dropout=0``, a head ``nn.Linear(512, 37000,
    bias_attr=False)``, ``nn.CrossEntropyLoss(label_smoothing=0.1)``,
    ``AdamW(NoamDecay(512, 4000), beta2=0.98, epsilon=1e-9,
    multi_precision=True, fused=True)``), AMP O2 bf16 and
    ``FLAGS_pallas_layer_norm`` on, trained by the eager loop on one
    random batch of 32 pairs of 256 + 256 tokens (the causal target
    mask), the same dropout masks every step: (a) exact launches a
    step: the flash forward 12 (encoder self-attention and
    cross-attention; the masked decoder self-attention takes the plain
    route), its backward 12, the LayerNorm forward and backward 30 each
    and one ``adamw_step``; (b) 1 warm-up, 5 timed and 1 traced step:
    target tokens/s, the step time, the device time by kernel group and
    the idle share; finite losses, the 6th below the 1st; (c) the same
    construction at 2 + 2 layers, dropout 0, f32, 2 pairs of 64 + 64
    tokens: one step on the card and on the CPU (the plain versions),
    the loss and every gradient to 1e-4 of its largest magnitude (at
    least a thousandth of the model's largest), AdamW's update to 1e-4
    of the learning rate beyond one f32 step of the weight; then the
    path's kernels against their plain versions at its shapes (the
    bf16 flash forward and fused backward at B32 H8 S256 D64 without a
    mask, the LayerNorm at 8,192 rows of 512 with f32 gamma, the fused
    AdamW bitwise over the model's 254 leaves, and (c)'s f32 shapes).
21. The rest of ``paddle.nn`` and the vision zoo ("vision and rnn"):
    (a) ``paddle.vision.models.densenet121()`` (1000 classes, 7,978,856
    parameters in 364 tensors) on ``bench_resnet50``'s recipe: AMP O2
    bf16, batch 128 at 224x224, ``Momentum(0.1, 0.9,
    multi_precision=True)`` with ``FLAGS_fused_optimizer_step`` on,
    through ``jit.train_step``, 1 warm-up, 5 timed and 1 traced step:
    finite losses, ``momentum_step`` exactly twice a step (256 tensors a
    launch) and no other kernel; images/s, the step time, device time by
    kernel group, the idle share and peak memory. (b) Phase 10's
    ResNet-50 run with ``FLAGS_conv_prefer_channels_last`` on (the NHWC
    ``conv2d``), one ``momentum_step`` a step, its figures beside phase
    10's. (c) Every case of the nn tables the CPU tests hold the port to
    (``tests/torch_nn_table_functional.py``, ``torch_nn_table_layers.py``,
    ``torch_nn_table_spatial_rnn.py``) on the card against the CPU,
    forward, buffers and gradients, f32 and bf16; then an f32
    ``densenet121(num_classes=10)`` at 64x64, batch 4, two
    ``Momentum(fused=True)`` steps on the card and on the CPU in eval
    mode (losses 1e-4 relative, first-step gradients 1e-4 of each
    gradient's largest magnitude), the same in training mode recorded
    beside an f64 CPU twin (chaotic in f32: not gated). (d) The medium
    PTB LSTM LM of Zaremba et al. 2014 (10,000 words, 650 units, 2
    layers, dropout 0.5, 35 steps, batch 20, clip 5) in f32 on synthetic
    tokens with ``AdamW`` on the fused flag: ``adamw_step`` exactly once
    a step, tokens/s, device time by group; beam search (beam 10, 35
    steps) over its two trained cells on the card and on the CPU: equal
    ids, or at the step where they part the two candidates' CPU scores
    within 1e-5 relative; an f32 step at hidden 64, vocabulary 200
    against the CPU (loss 1e-5, gradients 1e-4). Then the path's kernels
    at its shapes: ``momentum_step`` over DenseNet-121's 364 tensors
    (two launches) and ``adamw_step`` over the LM's 11, bitwise, timed
    against their plain versions and ``torch._fused_sgd_`` /
    ``torch._fused_adamw_``.
22. Observability and remat ("observability and remat"): (a) phase 5's
    bench GPT (hidden 1024, 24 layers, seq 1024, batch 8, AMP O2 bf16,
    the chunked fused head, ``AdamW(multi_precision=True, fused=True)``
    through ``jit.train_step``) from one seed, 1 warm-up and 3 timed
    steps under each remat policy: "dots", "dots_plus",
    "dots_plus_ln", "offload", "full" and "search" (the plan it resolves
    on this card, printed, trained with). Step 1's loss must be equal
    across policies (the forward does not depend on the policy), the
    later steps within 1e-2 relative of "dots"'s; a step launches
    ``flash_fwd`` once a layer (twice under "full", which recomputes
    it), ``flash_bwd_fused`` once a layer and ``adamw_step`` once;
    "offload" must move bytes into pinned host memory. Each policy's
    tokens/s and ``max_memory_allocated``, and one more traced step's
    device time by kernel group and idle share. (b) The "dots" run with
    ``PADDLE_METRICS_DIR`` set to a temporary directory: the port's
    ``tools.perf_doctor`` must count its 4 step records and B·S tokens
    each; its tokens/s is printed beside the synchronised figure (the
    hooks time the host). (c) One "dots" step priced by
    ``observability.cost_model.program_cost``: its FLOPs within 5 % of
    ``bench.py``'s ``(6·N + 12·L·S·H)·tokens``, the ratio and the MFU
    of the timed steps against 989 TFLOP/s. (d) ``FLAGS_check_nan_inf``
    on: ``max_pool2d(..., ceil_mode=True)`` and the causal
    ``flash_attention(..., return_softmax=True)`` on the card return
    the CPU's values.

Phase 12 also holds the bf16 split pair of the packed varlen backward
(``flash_varlen_dkv_kernel``, ``flash_varlen_dq_kernel``) on inputs
from {-1, 0, 1} at the fused kernel's exact cases (to 1e-5 beyond half
a bf16 step), and over 8 random draws each of the README batch and the
serving lengths (their own seeds): each draw's largest error beyond
half a bf16 step must be within 5e-3.

Phase 3 also holds the slice's kernels against their plain versions:
the RMSNorm forward and backward at the ``fused_rms_norm`` docstring's
[8192, 1024] and the stack's [16384, 2048] (bf16, f32, bf16 x with an
f32 weight) and ragged [37, 200], [64, 8192], [4, 16384] (bf16 and
f32), [37, 771] and [5, 1] (bf16 within one ulp plus 1e-5 of the
largest magnitude, f32 to 1e-5 of the largest magnitude, two f32
backward runs bitwise equal),
timed against ``F.rms_norm`` (forward, and its backward through
autograd). The forward and the backward run on both routes at every
case: on x (and do) as given (the vector kernels where 16-byte vectors
take the rows, else the general ones: H 771 and H 1) and on copies one
element past a 16-byte boundary (the general kernels); each call must
count one launch on the route the wrapper's rule names and launch that
route's kernel and not the other's (torch.profiler), and each route is
held and timed (with the wrapper's host time a call, the median of 200
calls without a sync), the f32 backward bitwise on a second run on both.
The same for the LayerNorm forward and backward below. The RoPE
forward and backward bitwise at the docstring's [8, 2048, 16, 128] with
an [S, D] table and a ``position_ids``-gathered [B*S, D] one, at D 64
with an odd H, and at D 6 (a half row that 16-byte vectors cannot
take), in bf16 and f32 (no single torch call computes it), on both
routes the same way: x as given (the vector kernel where 16-byte
vectors take a half row) and a copy one element past a 16-byte boundary
(the general kernel), each call counting one launch on its route and
launching that route's kernel alone, both routes timed (rows
``rope_vec`` and ``rope``);
the flat AdamW bitwise on its four outputs at 84 M elements with f32
and with bf16 params and grads, and at 513, on both routes: fresh
tensors (the vector kernel, row ``adamw_flat_vec``) and copies of g, m,
v and master one element past a 16-byte boundary (the general kernel,
row ``adamw_flat``), each call counting one launch on its route and
launching that route's kernel alone (torch.profiler); timed with the
wrapper's host time a call, against ``torch._fused_adamw_`` over an
f32 master/m/v of the same N (another decay order: a yardstick of time
only).

Phase 3 also holds the fused LayerNorm's forward and backward against
their plain versions at ERNIE's [4096, 768] (bf16 x with f32 and with
bf16 scale and shift, and f32), the GPT bench's [8192, 1024] (bf16 and
f32), ERNIE's shape under AMP float16 (f16 x with f32 and with f16
scale and shift), and ragged [37, 200], [64, 8192] (bf16 and f32),
[37, 771] and [5, 1]: a bf16 or f16 output within one ulp of its type
(plus 1e-5 of the tensor's largest magnitude where sums cancel), f32 to
1e-5 (dγ and dβ to 1e-5 of their largest magnitude), and two f32
backward runs bitwise equal on each route. Both directions run on both
routes as the RMSNorm's do (rows ``layer_norm_bwd_vec`` and
``layer_norm_bwd`` for the backward; H 771 and H 1 take the general
routes on aligned tensors too). Each timed shape records the kernels'
times (both routes of both directions), bounds and ``F.layer_norm``'s
(forward; backward through autograd).

Each main-path run (the serving runs, the training runs, the ERNIE
runs, the ResNet runs, the varlen runs, the incubate stack runs, the
PTQ runs, phase 17's serving runs, phase 18's gradient and serving runs,
phase 20's and phase 21's training runs, each of phase 22's policies)
starts with every launch count at 0 and is read just after;
the kernel checks' launches (and the PTQ phase's one-at-a-time and
dense replays) are not counted.

The line before the last is ``{"kernels": [...]}``: one row a kernel,
at its main path's shape; the paged decode's rows carry the verify
shape (``verify_shape``: bf16, its time, bound and the main path's
launches in verify steps), ``wo_matmul_wgmma`` its launches past 8 rows
in verify steps. A wrapper with several kernels has a row for
each, each counting the launches of its own route; the wrapper's first
row counts every route (``launches_by_route`` splits them). The last
line is ``{"ok": true, "device": {...}}``. A full record of the run is
written to ``chiprun_out/chip_smoke.json``.
"""

import contextlib
import copy
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
from torch.nn import functional as F

import paddle2_tpu_torch as paddle
from paddle2_tpu_torch import amp, flags, jit
from paddle2_tpu_torch.framework import core
from paddle2_tpu_torch.kernels import _build
from paddle2_tpu_torch.kernels import attention as remat_attention
from paddle2_tpu_torch.observability import metrics as obs_metrics
from paddle2_tpu_torch.observability.cost_model import (chip_peak,
                                                        program_cost)
from paddle2_tpu_torch.tools import perf_doctor
from paddle2_tpu_torch.kernels import flash_attn as flash_attn_mod
from paddle2_tpu_torch.kernels.flash_attn import (
    bwd_route, flash_bwd, flash_bwd_fused, flash_bwd_reference,
    flash_bwd_split_dkv, flash_bwd_split_dq, flash_fwd, flash_fwd_reference,
    tf32_matmul)
from paddle2_tpu_torch.kernels.flash_varlen import (
    flash_attention_varlen_packed, flash_varlen_bwd_dkv,
    flash_varlen_bwd_dkv_reference, flash_varlen_bwd_dq,
    flash_varlen_bwd_dq_reference, flash_varlen_bwd_fused,
    flash_varlen_bwd_fused_reference, flash_varlen_fwd,
    flash_varlen_fwd_reference)
from paddle2_tpu_torch.kernels.fused_adamw import (
    adamw_flat, adamw_flat_reference, adamw_step, adamw_step_multi,
    adamw_step_multi_reference, flat_route, stage_flat_scalars,
    stage_scalars)
from paddle2_tpu_torch.kernels import fused_layer_norm as fln
from paddle2_tpu_torch.kernels.fused_layer_norm import (
    bwd_blocks, layer_norm_bwd, layer_norm_bwd_reference, layer_norm_fwd,
    layer_norm_fwd_reference)
from paddle2_tpu_torch.kernels.fused_momentum import (
    MAX_TENSORS as MAX_MOMENTUM_TENSORS, momentum_step, momentum_step_multi,
    momentum_step_reference)
from paddle2_tpu_torch.kernels import fused_rms_norm as frn
from paddle2_tpu_torch.kernels import quant_matmul
from paddle2_tpu_torch.kernels.fused_rms_norm import (
    rms_norm_bwd, rms_norm_bwd_reference, rms_norm_fwd,
    rms_norm_fwd_reference)
from paddle2_tpu_torch.kernels import fused_rope as fr
from paddle2_tpu_torch.kernels.fused_rope import rope, rope_reference
from paddle2_tpu_torch.kernels.quant_matmul import (
    i8i8_route, int4_weight_only_matmul, int8_matmul, int8_matmul_reference,
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
from paddle2_tpu_torch.serving import (EngineConfig, ServingEngine,
                                       SpeculativeConfig, audit_kv_ledger)
from paddle2_tpu_torch.serving.paged_attention import (
    _merge_splits, cluster_plan, paged_attention_reference,
    paged_attention_split_reference, paged_decode,
    paged_decode_split_partials)
from paddle2_tpu_torch.vision.models import densenet121, resnet18, resnet50

# published H100 SXM peaks (NVIDIA data sheet, dense): f32 without TF32
# runs on the CUDA cores; int8 on the tensor cores
PEAK_OPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
            torch.float32: 67e12, torch.int8: 1979e12}
# the 2-byte types the tensor-core flash kernels take
HALF = (torch.bfloat16, torch.float16)
# dense TF32 on the tensor cores: the f32 split pair's three TF32
# products per f32 product run at this rate
TF32_OPS = 494.7e12
HBM_BYTES_PER_S = 3.35e12
# f32: sums of up to 2048 terms in another order than the plain
# version; bf16: outputs and probabilities are rounded to bf16
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# f16: bf16's limits at f16's step (3 more mantissa bits: 2**-11 for
# 2**-8), here and in BWD_TOL
TOL[torch.float16] = TOL[torch.bfloat16] / 8
# the flash backward's dq/dk/dv, absolute below 1 and relative above.
# bf16: the split pair (CUDA cores, the plain version's summation order)
# reads 0 at the training shape against the plain version in bf16; the
# fused tensor-core kernel is held against the plain version's f32 sums
# beyond half a bf16 step (half_step_err); the plain backward without
# the P/dS rounding reads above the limit under both (checked on every
# timed run)
BWD_TOL = {torch.bfloat16: 5e-3, torch.float32: 1e-4}
BWD_TOL[torch.float16] = BWD_TOL[torch.bfloat16] / 8
# the fused varlen backward (tensor cores, bf16) on random inputs: the
# share of dq/dk/dv elements that are not the plain f32 sums correctly
# rounded (varlen_bwd_stats). Its largest error is reported, not gated:
# a dS element whose tensor-core sum lands on the other side of a bf16
# rounding boundary moves whole rows, so single draws read past BWD_TOL
# while the share stays near 2e-3 (H100: 3e-5..5.7e-3 over 37 draws of
# the smoke's batches); the plain backward without P/dS rounding reads
# 0.37-0.42 (phase_runner.py --phase varlen_bwd_draws)
VARLEN_OFF_SHARE = 0.05
# the f16 fused backwards (dense and varlen) are held by the share above
# and by their largest error beyond half an f16 step, at bf16's limit:
# the share alone passes a (batch, head) slice or a tile written wrong
# (under 1 % of the elements at the training shape). H100: up to 7.2e-4
# dense and 1.1e-3 varlen; check_flash_bwd_exact holds them bit for bit
F16_FUSED_MAX = BWD_TOL[torch.bfloat16]
NEAR_TIE = 1e-3
# bf16 logits carry bf16 rounding (2**-6 at magnitudes 2..4), and the
# paged and the dense attention round at different places: a near tie
# in bf16 is a top-2 margin under 4 such steps
NEAR_TIE_BF16 = 0.0625
OUT = Path("chiprun_out")

KERNELS = {
    # every route of the forward's wrapper; its kernels-line row is the
    # bf16 wgmma kernel, the f32 3xTF32 kernel is counted again below
    "flash_fwd": dict(
        source="paddle2_tpu_torch/kernels/csrc/flash_fwd_wgmma.cu",
        replaces="paddle2_tpu/kernels/pallas_flash.py:153",
        also_replaces="paddle2_tpu/kernels/pallas_flash.py:122",
        counter=flash_fwd),
    "flash_fwd_tf32x3": dict(
        source="paddle2_tpu_torch/kernels/csrc/flash_fwd_tf32x3.cu",
        replaces="paddle2_tpu/kernels/pallas_flash.py:153",
        also_replaces="paddle2_tpu/kernels/pallas_flash.py:122",
        counter=flash_fwd, route="tf32x3"),
    "paged_decode": dict(
        source="paddle2_tpu_torch/serving/csrc/paged_decode.cu",
        replaces="paddle2_tpu/serving/paged_attention.py:103",
        counter=paged_decode),
    "paged_decode_split": dict(
        source="paddle2_tpu_torch/serving/csrc/paged_decode.cu",
        replaces="paddle2_tpu/serving/paged_attention.py:231",
        counter=paged_decode_split_partials),
    # every route of the split pair's wrappers; their kernels-line rows
    # are the bf16 CUDA-core kernels, which only route="split" reaches
    # in bf16 (the fused kernel is bf16's route); the f32 tensor-core
    # kernels, f32's route, are counted again below
    "flash_bwd_split_dkv": dict(
        source="paddle2_tpu_torch/kernels/csrc/flash_bwd.cu",
        replaces="paddle2_tpu/kernels/pallas_flash.py:305",
        counter=flash_bwd_split_dkv),
    "flash_bwd_split_dq": dict(
        source="paddle2_tpu_torch/kernels/csrc/flash_bwd.cu",
        replaces="paddle2_tpu/kernels/pallas_flash.py:354",
        counter=flash_bwd_split_dq),
    "flash_bwd_split_dkv_tf32x3": dict(
        source="paddle2_tpu_torch/kernels/csrc/flash_bwd_tf32x3.cu",
        replaces="paddle2_tpu/kernels/pallas_flash.py:305",
        counter=flash_bwd_split_dkv, route="tf32x3"),
    "flash_bwd_split_dq_tf32x3": dict(
        source="paddle2_tpu_torch/kernels/csrc/flash_bwd_tf32x3.cu",
        replaces="paddle2_tpu/kernels/pallas_flash.py:354",
        counter=flash_bwd_split_dq, route="tf32x3"),
    "flash_bwd_fused": dict(
        source="paddle2_tpu_torch/kernels/csrc/flash_bwd_wgmma.cu",
        f32_source="paddle2_tpu_torch/kernels/csrc/flash_bwd.cu",
        replaces="paddle2_tpu/kernels/pallas_flash.py:265",
        counter=flash_bwd_fused),
    "adamw_step": dict(
        source="paddle2_tpu_torch/kernels/csrc/adamw_step.cu",
        replaces="paddle2_tpu/kernels/pallas_fused.py:125",
        counter=adamw_step),
    # every route of the weight-only wrapper; its kernels-line row is the
    # f32 decode kernel (wo_gemv_tf32_kernel, TF32 on the tensor cores);
    # the three other routes (bf16 prefill, f32 prefill, bf16 decode) are
    # counted again below
    "wo_matmul": dict(
        source="paddle2_tpu_torch/kernels/csrc/wo_matmul.cu",
        replaces="paddle2_tpu/kernels/pallas_matmul.py:155",
        counter=int8_weight_only_matmul),
    "wo_gemm_tf32": dict(
        source="paddle2_tpu_torch/kernels/csrc/wo_matmul.cu",
        replaces="paddle2_tpu/kernels/pallas_matmul.py:155",
        counter=int8_weight_only_matmul, route="gemm"),
    "wo_matmul_wgmma": dict(
        source="paddle2_tpu_torch/kernels/csrc/wo_matmul_wgmma.cu",
        replaces="paddle2_tpu/kernels/pallas_matmul.py:155",
        counter=int8_weight_only_matmul, route="wgmma"),
    "wo_gemv_mma": dict(
        source="paddle2_tpu_torch/kernels/csrc/wo_matmul.cu",
        replaces="paddle2_tpu/kernels/pallas_matmul.py:155",
        counter=int8_weight_only_matmul, route="gemv_mma"),
    # every route of the LayerNorm forward wrapper; its kernels-line row
    # is the general route's kernel (an unaligned view), the vector
    # route's is counted again below
    "layer_norm_fwd": dict(
        source="paddle2_tpu_torch/kernels/csrc/layer_norm.cu",
        replaces="paddle2_tpu/kernels/pallas_ln.py:55",
        counter=layer_norm_fwd),
    "layer_norm_fwd_vec": dict(
        source="paddle2_tpu_torch/kernels/csrc/layer_norm.cu",
        replaces="paddle2_tpu/kernels/pallas_ln.py:55",
        counter=layer_norm_fwd, route="vec"),
    # every route of the LayerNorm backward wrapper, as layer_norm_fwd
    "layer_norm_bwd": dict(
        source="paddle2_tpu_torch/kernels/csrc/layer_norm.cu",
        replaces="paddle2_tpu/kernels/pallas_ln.py:65",
        counter=layer_norm_bwd),
    "layer_norm_bwd_vec": dict(
        source="paddle2_tpu_torch/kernels/csrc/layer_norm.cu",
        replaces="paddle2_tpu/kernels/pallas_ln.py:65",
        counter=layer_norm_bwd, route="vec"),
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
    # every route of the RMSNorm forward wrapper, as layer_norm_fwd
    "rms_norm_fwd": dict(
        source="paddle2_tpu_torch/kernels/csrc/rms_norm.cu",
        replaces="paddle2_tpu/kernels/pallas_fused.py:262",
        counter=rms_norm_fwd),
    "rms_norm_fwd_vec": dict(
        source="paddle2_tpu_torch/kernels/csrc/rms_norm.cu",
        replaces="paddle2_tpu/kernels/pallas_fused.py:262",
        counter=rms_norm_fwd, route="vec"),
    # every route of the RMSNorm backward wrapper, as rms_norm_fwd
    "rms_norm_bwd": dict(
        source="paddle2_tpu_torch/kernels/csrc/rms_norm.cu",
        replaces="paddle2_tpu/kernels/pallas_fused.py:290",
        counter=rms_norm_bwd),
    "rms_norm_bwd_vec": dict(
        source="paddle2_tpu_torch/kernels/csrc/rms_norm.cu",
        replaces="paddle2_tpu/kernels/pallas_fused.py:290",
        counter=rms_norm_bwd, route="vec"),
    # every route of the RoPE wrapper, as layer_norm_fwd
    "rope": dict(
        source="paddle2_tpu_torch/kernels/csrc/rope.cu",
        replaces="paddle2_tpu/kernels/pallas_fused.py:369",
        counter=rope),
    "rope_vec": dict(
        source="paddle2_tpu_torch/kernels/csrc/rope.cu",
        replaces="paddle2_tpu/kernels/pallas_fused.py:369",
        counter=rope, route="vec"),
    # every route of the flat AdamW's wrapper; its kernels-line row is the
    # general route's kernel (an offset view), the vector route's is
    # counted again below
    "adamw_flat": dict(
        source="paddle2_tpu_torch/kernels/csrc/adamw_flat.cu",
        replaces="paddle2_tpu/kernels/pallas_fused.py:32",
        counter=adamw_flat),
    "adamw_flat_vec": dict(
        source="paddle2_tpu_torch/kernels/csrc/adamw_flat.cu",
        replaces="paddle2_tpu/kernels/pallas_fused.py:32",
        counter=adamw_flat, route="vec"),
    # every route of the int8 x int8 wrapper; its kernels-line row is the
    # decode kernel's (i8i8_gemv_mma_kernel), the prefill kernel's
    # (i8i8_wgmma_kernel) is counted again below
    "i8i8_matmul": dict(
        source="paddle2_tpu_torch/kernels/csrc/i8i8_matmul.cu",
        replaces="paddle2_tpu/kernels/pallas_matmul.py:252",
        counter=int8_matmul),
    "i8i8_matmul_wgmma": dict(
        source="paddle2_tpu_torch/kernels/csrc/i8i8_matmul.cu",
        replaces="paddle2_tpu/kernels/pallas_matmul.py:252",
        counter=int8_matmul, route="wgmma"),
}
INCUBATE_KERNELS = ("rms_norm_fwd", "rms_norm_fwd_vec", "rms_norm_bwd",
                    "rms_norm_bwd_vec", "rope", "rope_vec", "adamw_flat",
                    "adamw_flat_vec")
# the CUDA kernel of each route of the flat AdamW (the names torch.profiler
# reports)
ADAMW_FLAT_KERNEL_NAMES = {"vec": "adamw_flat_vec_kernel",
                           "general": "adamw_flat_kernel"}
# the CUDA kernel of each route of the norms' forwards and backwards and
# of RoPE (the names torch.profiler reports); the libraries whose vector
# forwards' SASS must hold 16-byte loads (LDG.E.128)
NORM_KERNEL_NAMES = {
    ("rms_norm", "vec"): "rms_norm_fwd_vec_kernel",
    ("rms_norm", "general"): "rms_norm_fwd_kernel",
    ("rms_norm_bwd", "vec"): "rms_norm_bwd_vec_kernel",
    ("rms_norm_bwd", "general"): "rms_norm_bwd_kernel",
    ("layer_norm", "vec"): "layer_norm_fwd_vec_kernel",
    ("layer_norm", "general"): "layer_norm_fwd_kernel",
    ("layer_norm_bwd", "vec"): "layer_norm_bwd_vec_kernel",
    ("layer_norm_bwd", "general"): "layer_norm_bwd_kernel",
    ("rope", "vec"): "rope_vec_kernel",
    ("rope", "general"): "rope_kernel"}
NORM_LIBRARIES = ("rms_norm", "layer_norm")
VARLEN_KERNELS = ("flash_varlen_fwd", "flash_varlen_bwd_dkv",
                  "flash_varlen_bwd_dq", "flash_varlen_bwd_fused")
DENSE_FLASH_KERNELS = ("flash_fwd", "flash_fwd_tf32x3", "flash_bwd_fused",
                       "flash_bwd_split_dkv", "flash_bwd_split_dq",
                       "flash_bwd_split_dkv_tf32x3",
                       "flash_bwd_split_dq_tf32x3")
# the split pair's wrappers in f32 and their tensor-core kernels' rows
SPLIT_TF32X3 = {"flash_bwd_split_dkv": "flash_bwd_split_dkv_tf32x3",
                "flash_bwd_split_dq": "flash_bwd_split_dq_tf32x3"}
# every f32 flash wrapper whose f32 kernel has a row of its own
F32_TC_ROW = {"flash_fwd": "flash_fwd_tf32x3", **SPLIT_TF32X3}
# the CUDA kernel each dense flash wrapper launches, by dtype (the names
# torch.profiler reports): the forward on the tensor cores in both (bf16
# on wgmma, f32 in 3xTF32); the fused backward in bf16 on the tensor
# cores, in f32 on the CUDA cores; the split pair in f32 on the tensor
# cores (3xTF32), in bf16 on the CUDA cores
FLASH_KERNEL_NAMES = {
    ("flash_fwd", torch.bfloat16): "flash_fwd_wgmma_kernel",
    ("flash_fwd", torch.float32): "flash_fwd_tf32x3_kernel",
    ("flash_bwd_fused", torch.bfloat16): "flash_bwd_fused_wgmma_kernel",
    ("flash_bwd_fused", torch.float32): "flash_bwd_fused_kernel",
    ("flash_bwd_split_dkv", torch.bfloat16): "flash_bwd_dkv_kernel",
    ("flash_bwd_split_dkv", torch.float32): "flash_bwd_dkv_tf32x3_kernel",
    ("flash_bwd_split_dq", torch.bfloat16): "flash_bwd_dq_kernel",
    ("flash_bwd_split_dq", torch.float32): "flash_bwd_dq_tf32x3_kernel",
    # f16: the bf16 kernels' templates instantiated for __half, named by
    # their template argument (the profiler's demangled names)
    ("flash_fwd", torch.float16): "flash_fwd_wgmma_kernel<__half",
    ("flash_bwd_fused", torch.float16): "flash_bwd_fused_wgmma_kernel<__half",
    ("flash_bwd_split_dkv", torch.float16): "flash_bwd_dkv_kernel<__half",
    ("flash_bwd_split_dq", torch.float16): "flash_bwd_dq_kernel<__half"}
# the CUDA kernel each varlen wrapper launches, by dtype
VARLEN_KERNEL_NAMES = {
    ("flash_varlen_fwd", torch.bfloat16): "flash_varlen_fwd_wgmma_kernel",
    ("flash_varlen_fwd", torch.float32): "flash_varlen_fwd_kernel",
    ("flash_varlen_bwd_dkv", torch.bfloat16): "flash_varlen_dkv_kernel",
    ("flash_varlen_bwd_dkv", torch.float32): "flash_varlen_dkv_kernel",
    ("flash_varlen_bwd_dq", torch.bfloat16): "flash_varlen_dq_kernel",
    ("flash_varlen_bwd_dq", torch.float32): "flash_varlen_dq_kernel",
    ("flash_varlen_bwd_fused", torch.bfloat16):
        "flash_varlen_bwd_fused_wgmma_kernel",
    ("flash_varlen_fwd", torch.float16):
        "flash_varlen_fwd_wgmma_kernel<__half",
    ("flash_varlen_bwd_dkv", torch.float16): "flash_varlen_dkv_kernel<__half",
    ("flash_varlen_bwd_dq", torch.float16): "flash_varlen_dq_kernel<__half",
    ("flash_varlen_bwd_fused", torch.float16):
        "flash_varlen_bwd_fused_wgmma_kernel<__half"}
# the f32 kernels on the tensor cores, whose SASS must hold TF32 HMMA:
# library -> the kernel's name in it and its instantiations (head dims;
# for the prefill GEMM x's type, the tile it sets and whether x and w are
# read in 16-byte copies; for the decode GEMV whether w is read in
# 16-byte loads and x in one 16-byte load a step)
TF32_KERNELS = {
    "flash_bwd_tf32x3": {f"flash_bwd_{w}_tf32x3_kernel": (16, 64, 128)
                         for w in ("dkv", "dq")},
    "flash_fwd_tf32x3": {"flash_fwd_tf32x3_kernel": (16, 64, 128)},
    "wo_matmul": {"wo_gemm_tf32_kernel": tuple(
        f"f32 32x512 x{xb} w{wb}" for xb in (16, 1) for wb in (16, 1)) + (
        "bf16 128x128 x1 w16", "bf16 128x128 x1 w1"),
        "wo_gemv_tf32_kernel": tuple(f"f32 decode w{wb} x{xb}"
                                     for wb in (16, 1) for xb in (16, 1))}}
# the instantiations the model's path runs (f32 prefill at its 32 x 512
# tile and f32 decode, every GPT-3 1.3B projection within the 16-byte
# rule): ptxas must report no spill there
TF32_MAIN_PATH = (("wo_gemm_tf32_kernel", "f32 32x512 x16 w16"),
                  ("wo_gemv_tf32_kernel", "f32 decode w16 x16"))
# the libraries of the tensor-core kernels, whose SASS must hold HGMMA
WGMMA_LIBRARIES = ("flash_fwd_wgmma", "flash_bwd_wgmma", "flash_varlen_wgmma",
                   "flash_varlen_bwd_wgmma", "wo_matmul_wgmma")
SERVING_KERNELS = ("flash_fwd", "flash_fwd_tf32x3", "paged_decode",
                   "paged_decode_split")
# GPT-3 1.3B's weight-only projections, K x N ([in, out])
WO_SHAPES = {"qkv": (2048, 6144), "out_proj": (2048, 2048),
             "up": (2048, 8192), "down": (8192, 2048), "head": (2048, 50304)}
# the kernels line's wo_matmul rows: a decode step at batch 8 (bf16 on
# mma.sync, f32 on the TF32 decode GEMV), and a 1000-token prompt's
# prefill (padded to 1008; bf16 on wgmma, f32 on the TF32 GEMM), all on
# the tensor cores
WO_LINE_SHAPE = "M8 K2048 N8192 (up) bias"
WO_WGMMA_LINE_SHAPE = "M1008 K2048 N8192 (up) bias"
# the timed rows' batches: decode (1, 8), prefill (128, 1008), and in
# f32 the padded prompts of 17 and 130 tokens (32, 144), whose prefill
# the TF32 GEMM splits along K
WO_ROWS_M = {torch.bfloat16: (1, 8, 128, 1008),
             torch.float32: (1, 8, 32, 128, 144, 1008)}
# the f32 forward's kernels-line row: a 1000-token prompt's prefill
FLASH_TF32_LINE_SHAPE = "B1 H16 S1024 D128 causal"
# the int8 x int8 kernels' rows: GPT-3 1.3B's four block projections at
# decode batches (1, 8; 9 and 16 on two n8 tiles) and prefills (17 and 32
# around the kernels' boundary, 144 and 1008: the padded prompts of 130
# and 1000 tokens); the timed ones (I8_TIMED_M) at a decode step of batch
# 8 and the prefills of 17, 130 and 1000 tokens. The kernels line reports
# the up projection: the decode kernel's row at M 8, the prefill kernel's
# at M 1008
I8_SHAPES = {n: WO_SHAPES[n] for n in ("qkv", "out_proj", "up", "down")}
I8_ROWS_M = (1, 8, 9, 16, 17, 32, 144, 1008)
I8_TIMED_M = (8, 32, 144, 1008)
I8_LINE_SHAPE = "M8 K2048 N8192 (up)"
I8_WGMMA_LINE_SHAPE = "M1008 K2048 N8192 (up)"
# the kernels-line row of each int8 x int8 route, and its CUDA kernel (the
# names torch.profiler reports)
I8_ROW_NAME = {"mma": "i8i8_matmul", "wgmma": "i8i8_matmul_wgmma"}
I8_KERNEL_NAMES = {"mma": "i8i8_gemv_mma_kernel",
                   "wgmma": "i8i8_wgmma_kernel"}
# phases 16 and 17 serve GPT-3 1.3B at full width and this many of its 24
# layers: cut in PR 23 (from 24) to keep the smoke within its time as
# phase 19 joined it; their gates count launches by cfg.num_layers
SERVING_CUT_LAYERS = 8
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
    (64, 8192, torch.float32, torch.float32, "widest H"),
    (5, 1, torch.float32, torch.float32, "H 1"),
    (37, 200, torch.float16, torch.float16, "ragged"),
    # rows that 16-byte vectors cannot take: the general route
    (37, 771, torch.bfloat16, torch.bfloat16, "H 771"),
    (37, 771, torch.float32, torch.float32, "H 771")]
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
    # the widest row: both kernels past 48 KB of shared memory; in f32
    # the vector kernel's row spans all 8 warps of its block
    (4, 16384, torch.bfloat16, torch.float32, "widest H"),
    (4, 16384, torch.float32, torch.float32, "widest H"),
    (5, 1, torch.float32, torch.float32, "H 1"),
    # rows that 16-byte vectors cannot take: the general route
    (37, 771, torch.bfloat16, torch.bfloat16, "H 771"),
    (37, 771, torch.float32, torch.float32, "H 771")]
RMS_LINE_SHAPE = "R16384 H2048 (stack) w bf16"
LN_LINE_SHAPE = "R4096 H768 (ERNIE stacked leaves) g bf16"
# the RoPE checks: B, S, H, D, table ("S": [S, D]; "pos": gathered by
# position_ids to [B*S, D]); the docstring's shape is timed; ragged: an
# odd head count on the vector route (D 64)
ROPE_CASES = [(8, 2048, 16, 128, "S", True), (8, 2048, 16, 128, "pos", True),
              (2, 300, 7, 64, "S", False), (3, 17, 5, 64, "pos", False)]
# a half row that 16-byte vectors cannot take (D 6: the general route even
# on aligned tensors). These draw from a generator of their own, so the
# checks after them keep the inputs they had before these cases existed
ROPE_GENERAL_CASES = [(2, 33, 3, 6, "S"), (2, 33, 3, 6, "pos")]
ROPE_LINE_SHAPE = "B8 S2048 H16 D128, [S, D] table"
# the flat AdamW checks: N, param and grad dtype, timed
ADAMW_FLAT_CASES = [(84_000_000, torch.float32, True),
                    (84_000_000, torch.bfloat16, True),
                    (513, torch.float32, False),
                    (513, torch.bfloat16, False)]
ADAMW_FLAT_LINE_SHAPE = "N 84000000, p/g bf16"
TRAIN_BWD_SHAPE = "B8 H16 Sq1024 Sk1024 D64 causal"
# the fused AdamW row the kernels line reports: one step over the training
# leaves in their O2 dtypes (bf16 parameters with f32 masters and bf16
# gradients, f32 where the model keeps f32), as the main path runs it
ADAMW_LINE_DTYPE = "O2"
# the kernels-line row of each weight-only route
WO_ROW_NAME = {"gemv": "wo_matmul", "gemm": "wo_gemm_tf32",
               "gemv_mma": "wo_gemv_mma", "wgmma": "wo_matmul_wgmma"}
# the decode rows at the batches that only this check takes (the timed
# ones are M 1 and 8), in both dtypes
WO_DECODE_ROWS = (2, 3, 4, 5)
# the f32 decode GEMV in one K split whose warps walk past the 512 rows
# after which they add their mma sums into a second sum (5,120 rows a
# warp; two splits of 272 column tiles would pass three quarters of the
# card's resident blocks)
WO_LONG_DECODE = (8, 20480, 34816)
# the paged decode's shapes: (label, contexts, head dim); bs 16, H 16.
# The first is the main path's (the serving engine's widest decode
# batch, cut to 8 sequences of 2048..17 keys); every shape runs on both
# routes in both dtypes
PAGED_CTX = [2048, 1900, 1500, 1024, 700, 333, 129, 17]
PAGED_CASES = [("main", PAGED_CTX, 128),
               ("B8 all 2048", [2048] * 8, 128),
               ("B1 2048", [2048], 128),
               ("B8 short", [1, 2, 3, 5, 8, 13, 16, 17], 128),
               ("B1 16384", [16384], 128),
               ("D64", PAGED_CTX, 64),
               ("D16", PAGED_CTX, 16)]
PAGED_PPS = 8
PAGED_KERNEL = "paged_decode_cluster_kernel"


def paged_line_shape(ctx, D, split):
    return (f"B{len(ctx)} H16 D{D} bs16 ctx {sum(ctx)} total (max "
            f"{max(ctx)})" + (f" pps{PAGED_PPS}" if split else ""))


LINE_SHAPES = {"flash_bwd_fused": TRAIN_BWD_SHAPE,
               "flash_bwd_split_dkv": TRAIN_BWD_SHAPE,
               "flash_bwd_split_dq": TRAIN_BWD_SHAPE,
               "flash_bwd_split_dkv_tf32x3": TRAIN_BWD_SHAPE,
               "flash_bwd_split_dq_tf32x3": TRAIN_BWD_SHAPE,
               "wo_matmul": WO_LINE_SHAPE,
               "wo_gemv_mma": WO_LINE_SHAPE,
               "wo_matmul_wgmma": WO_WGMMA_LINE_SHAPE,
               "wo_gemm_tf32": WO_WGMMA_LINE_SHAPE,
               "flash_fwd_tf32x3": FLASH_TF32_LINE_SHAPE,
               "i8i8_matmul": I8_LINE_SHAPE,
               "i8i8_matmul_wgmma": I8_WGMMA_LINE_SHAPE,
               "rms_norm_fwd": RMS_LINE_SHAPE + ", unaligned view",
               "rms_norm_fwd_vec": RMS_LINE_SHAPE,
               "rms_norm_bwd": RMS_LINE_SHAPE + ", unaligned view",
               "rms_norm_bwd_vec": RMS_LINE_SHAPE,
               "rope": ROPE_LINE_SHAPE + ", unaligned view",
               "rope_vec": ROPE_LINE_SHAPE,
               "adamw_flat": ADAMW_FLAT_LINE_SHAPE + ", offset view",
               "adamw_flat_vec": ADAMW_FLAT_LINE_SHAPE,
               "paged_decode": paged_line_shape(PAGED_CTX, 128, False),
               "paged_decode_split": paged_line_shape(PAGED_CTX, 128, True),
               "flash_varlen_fwd": VARLEN_LINE_SHAPE,
               "flash_varlen_bwd_dkv": VARLEN_LINE_SHAPE,
               "flash_varlen_bwd_dq": VARLEN_LINE_SHAPE,
               "flash_varlen_bwd_fused": VARLEN_LINE_SHAPE,
               "layer_norm_fwd": LN_LINE_SHAPE + ", unaligned view",
               "layer_norm_fwd_vec": LN_LINE_SHAPE,
               "layer_norm_bwd": LN_LINE_SHAPE + ", unaligned view",
               "layer_norm_bwd_vec": LN_LINE_SHAPE}


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
    windows, then once with a primer call first; if none is whole, both
    times are None (not measured)."""
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
    # some windows lose the first record of a kernel library: one more
    # window whose first call is a primer, of which the last iters *
    # per_call records of ``kernel`` are taken, and every kernel from
    # the first of those on
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters + 1):
            fn()
        torch.cuda.synchronize()
    dev = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    ours = [e for e in dev if kernel in e.name]
    want = iters * per_call
    if len(ours) >= want:
        first = ours[-want].time_range.start
        return (sum(e.time_range.elapsed_us() for e in dev
                    if e.time_range.start >= first) / iters / 1e3,
                sum(e.time_range.elapsed_us() for e in ours[-want:])
                / iters / 1e3)
    say(f"[profiler] {kernel}: fewer than {iters * per_call} launches "
        f"recorded in each of {tries} windows and in a primed one: device "
        f"time not measured")
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
        for route in getattr(k["counter"], "route_launches", ()):
            k["counter"].route_launches[route] = 0


# ------------------------------------------------------------- phase 3
def check_flash(dtype, S, gen, dev, B=1, D=128):
    """The flash forward (causal) against its plain version, timed with
    SDPA beside it (by events and device time). f32 runs the 3xTF32
    kernel: its row (``flash_fwd_tf32x3``) is bounded by three TF32
    products per f32 product, with the CUDA cores' bound beside it and
    the wrapper's host time; a second run must be bitwise equal, and the
    plain forward with its products in single-pass TF32 must read past
    the f32 limit."""
    H = 16
    q, k, v = (torch.randn(B, H, S, D, generator=gen, device=dev)
               .to(dtype) for _ in range(3))
    scale = 1.0 / D ** 0.5

    def run():
        return flash_fwd(q, k, v, scale=scale, causal=True)
    o, lse = run()
    o_ref, lse_ref = flash_fwd_reference(q, k, v, scale, True)
    torch.cuda.synchronize()
    err = max((o.float() - o_ref.float()).abs().max().item(),
              (lse - lse_ref).abs().max().item())
    shape = f"B{B} H{H} S{S} D{D} causal"
    require(err <= TOL[dtype], f"flash_fwd {dname(dtype)} {shape} "
            f"disagrees with its plain version: {err} > {TOL[dtype]}")
    ms = cuda_ms(run)
    dev_ms, kern_ms = device_ms(run, FLASH_KERNEL_NAMES["flash_fwd", dtype])
    plain = cuda_ms(lambda: flash_fwd_reference(q, k, v, scale, True),
                    iters=10)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)
    lib = cuda_ms(sdpa)
    lib_dev = device_ms(sdpa, "")[0]
    ops = 4.0 * causal_pairs(S, S) * D * H * B
    nbytes = 2.0 * (S + S) * H * D * B * q.element_size()
    b_ms, b_by = bound(ops, nbytes, dtype)
    row = dict(name="flash_fwd", dtype=dname(dtype), shape=shape,
               max_abs_err=err, tol=TOL[dtype], ms=ms, device_ms=dev_ms,
               kernel_device_ms=kern_ms, plain_ms=plain, library_ms=lib,
               library_device_ms=lib_dev, bound_ms=b_ms, bound_by=b_by,
               library="SDPA (is_causal=True)")
    if dtype == torch.float32:
        again = run()
        bitwise = torch.equal(o, again[0]) and torch.equal(lse, again[1])
        require(bitwise, f"flash_fwd float32 {shape}: two runs differ")
        one = flash_fwd_reference(
            q, k, v, scale, True,
            matmul=lambda a, b: tf32_matmul(a, b, passes=1))
        single = max((one[0] - o_ref).abs().max().item(),
                     (one[1] - lse_ref).abs().max().item())
        say(f"[kernel] flash_fwd float32 {shape}: the plain forward with "
            f"single-pass TF32 products reads {single} (limit "
            f"{TOL[dtype]})")
        require(single > TOL[dtype], f"flash_fwd float32 {shape}: the "
                f"plain forward with single-pass TF32 products reads "
                f"{single}, within the limit {TOL[dtype]}")
        t_ops = 3 * ops / TF32_OPS * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        row.update(name=F32_TC_ROW["flash_fwd"], bound_cuda_core_ms=b_ms,
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   single_pass_tf32_err=single, host_ms=host_ms(run),
                   bitwise=bitwise)
    return row


def check_flash_ragged(dtype, B, H, Sq, Sk, D, causal, gen, dev):
    """The flash forward against its plain version at lengths that are
    no multiple of a tile (the tensor-core kernels' are 128 or 64 query
    rows and 32 to 128 keys), ``Sq < Sk``, untimed; in f32 a second run
    must be bitwise equal."""
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
    bitwise = None
    if dtype == torch.float32:
        o2, lse2 = flash_fwd(q, k, v, scale=scale, causal=causal)
        bitwise = torch.equal(o, o2) and torch.equal(lse, lse2)
        require(bitwise, f"flash_fwd float32 {shape}: two runs differ")
    return dict(name="flash_fwd", dtype=dname(dtype), shape=shape,
                max_abs_err=err, tol=TOL[dtype], bitwise=bitwise)


def paged_inputs(dtype, gen, dev, rng, ctx, D, H=16, bs=16):
    """Pools with x7 garbage in every stale slot (as in the CPU tests),
    shuffled block tables as wide as the longest context, and the live
    slots' K and V drawn anew."""
    B = len(ctx)
    ctx = np.asarray(ctx, np.int32)
    pages = -(-ctx // bs)
    n_pages = int(pages.max())
    nb = int(pages.sum()) + 1
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((B, n_pages), np.int32)
    blk, slot = [], []
    used = 0
    for b in range(B):
        tables[b, :pages[b]] = perm[used:used + pages[b]]
        used += pages[b]
        t = np.arange(int(ctx[b]))
        blk.append(tables[b, t // bs])
        slot.append(t % bs)
    blk = torch.as_tensor(np.concatenate(blk), device=dev).long()
    slot = torch.as_tensor(np.concatenate(slot), device=dev).long()
    kp = (torch.randn(nb, bs, H, D, generator=gen, device=dev) * 7).to(dtype)
    vp = (torch.randn(nb, bs, H, D, generator=gen, device=dev) * 7).to(dtype)
    for pool in (kp, vp):
        pool[blk, slot] = torch.randn(len(blk), H, D, generator=gen,
                                      device=dev).to(dtype)
    q = torch.randn(B, 1, H, D, generator=gen, device=dev).to(dtype)
    return (q, kp, vp, torch.as_tensor(tables, device=dev),
            torch.as_tensor(ctx, device=dev))


def check_paged(dtype, gen, dev, rng, split, label, ctx, D):
    """The paged decode on one route (global, or split-K with
    ``PAGED_PPS`` pages a split and the torch merge) against its plain
    version, with stale x7 garbage past each context: CUDA events, the
    device time of every kernel of the call and of the decode kernel
    alone, the plain version's time, the bound (the bytes of K and V the
    contexts hold), the cluster plan, and on the main shape the
    wrapper's host time a call."""
    args = paged_inputs(dtype, gen, dev, rng, ctx, D)
    q = args[0]
    B, _, H, D = q.shape
    n_pages = args[3].shape[1]
    scale = 1.0 / D ** 0.5
    if split:
        def run():
            return _merge_splits(*paged_decode_split_partials(
                *args, scale=scale, pages_per_split=PAGED_PPS),
                q.dtype)[:, None]

        def plain():
            return paged_attention_split_reference(
                *args, scale=scale, pages_per_split=PAGED_PPS)
    else:
        def run():
            return paged_decode(*args, scale=scale)

        def plain():
            return paged_attention_reference(*args, scale=scale)
    out, ref = run(), plain()
    torch.cuda.synchronize()
    shape = paged_line_shape(ctx, D, split)
    what = f"paged decode (split={split}) {dname(dtype)} {label}: {shape}"
    require(torch.isfinite(out.float()).all().item(),
            f"{what}: non-finite output")
    err = (out.float() - ref.float()).abs().max().item()
    require(err <= TOL[dtype], f"{what} disagrees with its plain version: "
            f"{err} > {TOL[dtype]}")
    again = run()
    bitwise = torch.equal(out, again)
    require(bitwise, f"{what}: two runs differ")
    ms = cuda_ms(run)
    dev_ms, kern_ms = device_ms(run, PAGED_KERNEL, per_call=1)
    plain_ms = cuda_ms(plain, iters=5, warmup=1)
    total_ctx = sum(ctx)
    ops = 4.0 * total_ctx * H * D
    nbytes = 2.0 * total_ctx * H * D * q.element_size()
    b_ms, b_by = bound(ops, nbytes, dtype)
    cluster, chunk = cluster_plan(PAGED_PPS if split else n_pages, 16)
    row = dict(name="paged_decode_split" if split else "paged_decode",
               dtype=dname(dtype), shape=shape, label=label,
               max_abs_err=err, tol=TOL[dtype], bitwise=bitwise, ms=ms,
               device_ms=dev_ms, kernel_device_ms=kern_ms,
               plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
               bound_by=b_by, cluster=cluster, chunk_pages=chunk)
    if label == "main":
        row.update(host_ms=host_ms(run))
    return row


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
    if got.dtype in HALF_BITS:
        half = torch.exp2(torch.floor(torch.log2(
            ref32.abs().clamp_min(1e-30))) - HALF_BITS[got.dtype])
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
        past += int((e > BWD_TOL[g.dtype]).sum().item())
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


def bwd_ops(name, B, H, Sq, Sk, D, causal=True):
    pairs = causal_pairs(Sq, Sk) if causal else Sq * Sk
    return BWD_WORK[name][0] * pairs * D * H * B


def bwd_bytes(name, B, H, Sq, Sk, D, size):
    return BWD_WORK[name][1](Sq, Sk) * H * D * B * size + 8.0 * Sq * H * B


def bwd_bound(name, B, H, Sq, Sk, D, dtype, size, causal=True):
    return bound(bwd_ops(name, B, H, Sq, Sk, D, causal),
                 bwd_bytes(name, B, H, Sq, Sk, D, size), dtype)


def bwd_bound_3xtf32(name, B, H, Sq, Sk, D, size, causal=True):
    """The f32 split pair's bound on the tensor cores, as ``bwd_bound``
    with three TF32 products per f32 product at the dense TF32 rate."""
    t_ops = 3 * bwd_ops(name, B, H, Sq, Sk, D, causal) / TF32_OPS * 1e3
    t_bytes = bwd_bytes(name, B, H, Sq, Sk, D, size) / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def bwd_inputs(dtype, B, H, Sq, Sk, D, gen, dev, causal=True):
    q = torch.randn(B, H, Sq, D, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(B, H, Sk, D, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    do = torch.randn(B, H, Sq, D, generator=gen, device=dev).to(dtype)
    scale = 1.0 / D ** 0.5
    o, lse = flash_fwd(q, k, v, scale=scale, causal=causal)
    return q, k, v, o, lse, do, scale


def check_flash_bwd(dtype, B, H, Sq, Sk, D, gen, dev, timed,
                    routes=("fused", "split"), causal=True):
    """The backward ``routes`` against the plain backward; with
    ``timed``, the route kernels' times, bounds and the SDPA backward's
    time. The bf16 split pair sums in the plain version's order (at the
    shapes it is held at) and is held to it in the input dtype, as is
    every f32 route (the f32 split pair on the tensor cores in 3xTF32,
    which must also give bitwise-equal outputs on a second run); the
    fused route in bf16 runs on the tensor cores, sums in another order,
    and is held to the plain version's f32 sums beyond half a bf16 step
    (``half_step_err``), as the varlen kernels are."""
    q, k, v, o, lse, do, scale = bwd_inputs(dtype, B, H, Sq, Sk, D, gen,
                                            dev, causal)
    ref = flash_bwd_reference(q, k, v, o, lse, do, scale, causal)
    ref32 = flash_bwd_reference(q, k, v, o, lse, do, scale, causal,
                                out_dtype=torch.float32)
    shape = (f"B{B} H{H} Sq{Sq} Sk{Sk} D{D} "
             + ("causal" if causal else "non-causal"))
    tol = BWD_TOL[dtype]
    half_step = dtype in HALF

    def scaled(got):
        # absolute below 1, relative above: one bf16 rounding step of a
        # gradient of magnitude 8 is 0.03
        diff = [(g.float() - r.float()).abs() for g, r in zip(got, ref)]
        return ([(d / r.float().abs().clamp_min(1.0)).max().item()
                 for d, r in zip(diff, ref)], [d.max().item() for d in diff])
    errs, abs_errs, same_dtype, bitwise = {}, {}, {}, None
    off_share = None
    for route in routes:
        got = flash_bwd(q, k, v, o, lse, do, scale, causal, route=route)
        torch.cuda.synchronize()
        same_dtype[route], abs_errs[route] = scaled(got)
        errs[route] = ([half_step_err(g, r) for g, r in zip(got, ref32)]
                       if route == "fused" and half_step
                       else same_dtype[route])
        if route == "fused" and dtype == torch.float16:
            # f16's step is 8 times finer than bf16's, but a dS element
            # that rounds to its other neighbour (near ties, the tensor
            # cores' f32 sums in another order) moves a gradient by a
            # share that shrinks more slowly: gate the share of elements
            # off the rounded f32 sums, as the fused varlen kernel is
            # gated, and the largest error at F16_FUSED_MAX
            off_share = varlen_bwd_stats(got, ref32)["off_share"]
            require(off_share <= VARLEN_OFF_SHARE,
                    f"flash_bwd fused float16 {shape}: {off_share} of the "
                    f"elements are not the plain f32 sums rounded (limit "
                    f"{VARLEN_OFF_SHARE}; largest error {errs[route]})")
            require(max(errs[route]) <= F16_FUSED_MAX,
                    f"flash_bwd fused float16 {shape}: dq/dk/dv err "
                    f"{errs[route]} > {F16_FUSED_MAX}")
        else:
            require(all(e <= tol for e in errs[route]),
                    f"flash_bwd {route} {dname(dtype)} {shape}: dq/dk/dv "
                    f"err {errs[route]} > {tol}")
        if route == "split" and dtype == torch.float32:
            # no atomics, a fixed summation order: bitwise reproducible
            again = flash_bwd(q, k, v, o, lse, do, scale, causal,
                              route=route)
            bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
            require(bitwise, f"flash_bwd split float32 {shape}: two runs "
                    f"differ")
            del again
        del got
    if not timed:
        return [dict(name="flash_bwd", dtype=dname(dtype), shape=shape,
                     dq_dk_dv_err=errs, dq_dk_dv_abs_err=abs_errs,
                     dq_dk_dv_err_same_dtype=same_dtype, tol=tol,
                     fused_off_share=off_share, f32_split_bitwise=bitwise)]
    unrounded = single_pass = None
    if dtype == torch.float32:
        # what a kernel with single-pass TF32 products reads: the f32
        # limit must catch it (3xTF32 keeps each product to ~2**-21)
        single_pass = scaled(flash_bwd_reference(
            q, k, v, o, lse, do, scale, causal,
            matmul=lambda a, b: tf32_matmul(a, b, passes=1)))[0]
        say(f"[kernel] flash_bwd float32 {shape}: the plain backward with "
            f"single-pass TF32 products reads {single_pass} (limit {tol})")
        require(max(single_pass) > tol,
                f"flash_bwd float32 {shape}: the plain backward with "
                f"single-pass TF32 products reads {single_pass}, within the "
                f"limit {tol}")
    if dtype in HALF:
        # what a kernel that skips the P/dS rounding reads under either
        # metric: the limit must catch it
        plain32 = flash_bwd_reference(q.float(), k.float(), v.float(),
                                      o.float(), lse, do.float(), scale, True)
        unrounded = dict(
            same_dtype=scaled([t.to(dtype) for t in plain32])[0],
            half_step=[half_step_err(a.to(dtype), b)
                       for a, b in zip(plain32, ref32)],
            off_share=varlen_bwd_stats([t.to(dtype) for t in plain32],
                                       ref32)["off_share"])
        del plain32
        if dtype == torch.float16:
            require(unrounded["off_share"] > VARLEN_OFF_SHARE,
                    f"flash_bwd float16 {shape}: the plain backward without "
                    f"P/dS rounding reads {unrounded}, within the limit "
                    f"{VARLEN_OFF_SHARE} (share)")
        for metric in ("same_dtype", "half_step"):
            e = unrounded[metric]
            require(max(e) > tol or dtype == torch.float16,
                    f"flash_bwd {dname(dtype)} {shape}: the plain backward "
                    f"without P/dS rounding reads {e} ({metric}), within the "
                    f"limit {tol}")
        # why the tensor-core route needs the half-step metric: the same
        # backward with float64 sums, against the f32 plain version in
        # bf16, reads past the limit too (one bf16 step where a sum sits
        # on a rounding boundary)
        unrounded["exact_sums_same_dtype"] = scaled(flash_bwd_reference(
            q, k, v, o, lse, do, scale, True, sum_dtype=torch.float64))[0]
        say(f"[kernel] flash_bwd {dname(dtype)} {shape}: the plain backward "
            f"without P/dS rounding, and with float64 sums: {unrounded}")
    del ref32
    delta = (do.float() * o.float()).sum(-1)
    plain = cuda_ms(lambda: flash_bwd_reference(q, k, v, o, lse, do, scale,
                                                causal), iters=5, warmup=1)
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal)

    def lib_call():
        return torch.autograd.grad(o_lib, (qr, kr, vr), do,
                                   retain_graph=True)
    lib = cuda_ms(lib_call)
    lib_dev = device_ms(lib_call, "")[0]
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
            return fn(q, k, v, do, lse, delta, scale, causal)
        ms = cuda_ms(run)
        dev_ms, kern_ms = device_ms(run, FLASH_KERNEL_NAMES[name, dtype])
        b_ms, b_by = bwd_bound(name, B, H, Sq, Sk, D, dtype,
                               q.element_size(), causal)
        tf32 = {}
        if route == "split" and dtype == torch.float32:
            # the tensor-core pair's row: its bound is 3xTF32's (the
            # CUDA cores' kept beside it)
            tf32 = dict(bound_cuda_core_ms=b_ms,
                        single_pass_tf32_err=single_pass,
                        host_ms=host_ms(run), bitwise=bitwise)
            b_ms, b_by = bwd_bound_3xtf32(name, B, H, Sq, Sk, D,
                                          q.element_size(), causal)
            name = SPLIT_TF32X3[name]
        rows.append(dict(name=name, dtype=dname(dtype), shape=shape,
                         max_abs_err=err, scaled_err=scaled_err,
                         same_dtype_err=max(same_dtype[route][outs]),
                         metric=("off_share" if route == "fused" and
                                 dtype == torch.float16 else "half_step"
                                 if route == "fused" and half_step
                                 else "same_dtype"),
                         off_share=off_share if route == "fused" else None,
                         tol=(VARLEN_OFF_SHARE if route == "fused" and
                              dtype == torch.float16 else tol),
                         unrounded_err=unrounded, ms=ms,
                         device_ms=dev_ms, kernel_device_ms=kern_ms,
                         plain_ms=plain, library_ms=lib,
                         library_device_ms=lib_dev, bound_ms=b_ms,
                         bound_by=b_by, **tf32,
                         library=f"SDPA backward (is_causal={causal})"))
    return rows


def check_adamw(leaves, gen, dev, timed=True):
    """Three steps of the fused AdamW against the eager chain, bitwise,
    on parameters of a model's leaves (``leaves``: shape and O2 dtype of
    each; the training path's 16): all f32, all bf16 with f32 masters,
    and in their O2 dtypes (bf16 parameters with f32 masters and bf16
    gradients, f32 where the model keeps f32); one launch a step. Without
    ``timed`` that check's row alone. Then one step over the 16
    leaves timed in two forms, all f32 (the form of the earlier rows) and
    the O2 form the main path runs: the kernel (one launch), the parent's
    chain of the same step rebuilt (per leaf the gradient widened, a
    one-tensor launch of the kernel and the master cast into the bf16
    parameter), the plain version, and ``torch._fused_adamw_`` over the
    f32 state of the same leaves, each by CUDA events and device time,
    with the wrapper's host time a call."""
    n_leaves = len(leaves)
    shapes = [sh for sh, _ in leaves]
    o2 = [dt for _, dt in leaves]
    cases = [("float32", [torch.float32] * n_leaves),
             ("bf16 + f32 masters", [torch.bfloat16] * n_leaves),
             (ADAMW_LINE_DTYPE, o2)]
    for what, dtypes in cases:
        inits = [torch.randn(sh, generator=gen, device=dev).to(dt)
                 for sh, dt in zip(shapes, dtypes)]
        pa = [torch.nn.Parameter(t.clone()) for t in inits]
        pb = [torch.nn.Parameter(t) for t in inits]
        oa = AdamW(1e-3, parameters=pa, weight_decay=0.01,
                   multi_precision=True, fused=True)
        ob = AdamW(1e-3, parameters=pb, weight_decay=0.01,
                   multi_precision=True, fused=False)
        before = adamw_step.launches
        for _ in range(3):
            for a, b in zip(pa, pb):
                g = torch.randn(a.shape, generator=gen, device=dev).to(
                    a.dtype)
                a.grad, b.grad = g, g.clone()
            oa.step()
            ob.step()
        torch.cuda.synchronize()
        require(adamw_step.launches - before == 3,
                f"the fused AdamW ({what}) launched the kernel "
                f"{adamw_step.launches - before} times in 3 steps, want one "
                f"a step")
        for i, (a, b) in enumerate(zip(pa, pb)):
            sa, sb = oa._states[id(a)], ob._states[id(b)]
            pairs = [("param", a, b)]
            if "master" in sa:
                pairs.append(("master", sa["master"], sb["master"]))
                sa, sb = sa["inner"], sb["inner"]
            pairs += [("m", sa["m"], sb["m"]), ("v", sa["v"], sb["v"])]
            for name, x, y in pairs:
                require(torch.equal(x, y), f"adamw_step {what} leaf {i} "
                        f"{tuple(a.shape)}: {name} differs from the eager "
                        f"AdamW (max "
                        f"{(x.float() - y.float()).abs().max().item()})")
        del inits, pa, pb, oa, ob
        torch.cuda.empty_cache()
    if not timed:
        return [dict(name="adamw_step", dtype=", ".join(w for w, _ in cases),
                     shape=f"{n_leaves} leaves, "
                     f"{sum(math.prod(sh) for sh in shapes)} elements, 3 "
                     f"steps, one launch a step", max_abs_err=0.0,
                     tol="bitwise")]
    rows = []
    sc = stage_scalars(1e-4, 0.9, 0.999, 1e-8, 0.01, 3)
    for form, dtypes in cases[::2]:
        W, M, V = [[torch.randn(sh, generator=gen, device=dev)
                    for sh in shapes] for _ in range(3)]
        for v in V:
            v.abs_()
        G = [torch.randn(sh, generator=gen, device=dev).to(dt)
             for sh, dt in zip(shapes, dtypes)]
        G32 = [g.float() for g in G]
        L = [torch.empty(sh, dtype=dt, device=dev)
             if dt != torch.float32 else None
             for sh, dt in zip(shapes, dtypes)]
        decays = [True] * n_leaves

        def run():
            adamw_step_multi(W, G, M, V, L, decays, sc)

        def chain():
            # the parent's route: g.float(), the kernel, .to(p.dtype) and
            # the copy into p, tensor by tensor
            for w, g, m, v, lo in zip(W, G, M, V, L):
                adamw_step(w, g.float() if lo is not None else g, m, v, sc,
                           True)
                if lo is not None:
                    lo.copy_(w.to(lo.dtype))

        def plain():
            adamw_step_multi_reference(W, G, M, V, L, decays, sc)
        steps = [torch.tensor(3.0, device=dev) for _ in shapes]

        def lib_run():
            torch._fused_adamw_(W, G32, M, V, [], steps, lr=1e-4, beta1=0.9,
                                beta2=0.999, weight_decay=0.01, eps=1e-8,
                                amsgrad=False, maximize=False)
        ms = cuda_ms(run)
        dev_ms, kern_ms = device_ms(run, "adamw_step_kernel", per_call=1)
        host = host_ms(run, n=50)
        chain_ms = cuda_ms(chain)
        chain_dev = device_ms(chain, "")[0]
        plain_ms = cuda_ms(plain, iters=5)
        lib = cuda_ms(lib_run)
        lib_dev = device_ms(lib_run, "")[0]
        N = sum(w.numel() for w in W)
        n_low = sum(w.numel() for w, lo in zip(W, L) if lo is not None)
        # 16 f32 operations an element; 28 bytes an element either way:
        # p, g, m, v read and p, m, v written in f32, or a 2-byte g read
        # and a 2-byte parameter written beside the f32 master, m and v
        b_ms, b_by = bound(16.0 * N, 28.0 * N, torch.float32)
        rows.append(dict(
            name="adamw_step", dtype=form,
            shape=f"{n_leaves} leaves, {N} elements ({n_low} of them bf16 "
            f"parameters with f32 masters), largest "
            f"{max(w.numel() for w in W)}, one launch", max_abs_err=0.0, tol="bitwise", ms=ms,
            device_ms=dev_ms, kernel_device_ms=kern_ms, host_ms=host,
            chain_ms=chain_ms, chain_device_ms=chain_dev, plain_ms=plain_ms,
            library_ms=lib, library_device_ms=lib_dev, bound_ms=b_ms,
            bound_by=b_by, library="torch._fused_adamw_ over the f32 "
            "state"))
        del W, M, V, G, G32, L
        torch.cuda.empty_cache()
    return rows


def check_momentum(shapes, o2_dtypes, gen, dev, model="ResNet-50"):
    """Three steps of the fused Momentum against the eager chain,
    bitwise, on parameters of ``model``'s shapes (ResNet-50's 161 in
    phase 3, DenseNet-121's 364 in phase 21: two launches a step): f32
    plain, f32 Nesterov, f32 with L2 decay 1e-4, bf16 with f32 masters,
    and the mixed list of the model under O2 (``o2_dtypes``: bf16
    convolutions and fc with f32 masters, f32 BatchNorm); each step
    one launch per 256 tensors. Then one multi-tensor step over f32
    state of all of them (what a training step runs) timed: the kernel,
    its plain version, and ``torch._fused_sgd_`` (dampening 0: the same
    function) over the same lists, by CUDA events and by device time."""
    n_leaves = len(shapes)
    per_step = -(-n_leaves // MAX_MOMENTUM_TENSORS)
    cases = [("f32", [torch.float32] * n_leaves, False, 0.0),
             ("f32 nesterov", [torch.float32] * n_leaves, True, 0.0),
             ("f32 L2 1e-4", [torch.float32] * n_leaves, False, 1e-4),
             ("bf16 + f32 masters", [torch.bfloat16] * n_leaves, False, 0.0),
             (f"{model} O2 list", o2_dtypes, False, 1e-4)]
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
        require(momentum_step.launches - before == 3 * per_step,
                f"the fused Momentum ({what}) launched the kernel "
                f"{momentum_step.launches - before} times in 3 steps, want "
                f"{per_step} a step")
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
    dev_ms, kern_ms = device_ms(run, "momentum_step_kernel",
                                per_call=per_step)
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
                shape=f"{n_leaves} {model} parameters, {N} f32 elements "
                f"(largest {max(p.numel() for p in P)}), {per_step} "
                f"launch{'es' if per_step > 1 else ''}",
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
             timed=True, offset=False):
    """The weight-only kernel against its plain version at ``M x K x
    N``: error absolute below 1 and relative above (one bf16 rounding
    step of an output of 4 is 0.03); the call must take the route
    ``wo_route`` names (the row is named by it: ``wo_gemv_mma`` for bf16
    decode on the tensor cores, ``wo_matmul_wgmma`` for bf16 prefill).
    ``offset``: x and w are contiguous views one element past a 16-byte
    boundary. On the TF32 kernels (the prefill GEMM, route "gemm", row
    ``wo_gemm_tf32``; the f32 decode GEMV, route "gemv", row
    ``wo_matmul``) a second run must be bitwise equal. With ``timed``,
    its times, the wrapper's host time a call, its bound and the library
    yardsticks (by events and device time); a TF32 row is bounded by its
    TF32 passes (two for f32 x) with the CUDA cores' bound beside it, and
    in f32 the plain version with x in single-pass TF32 must read past
    the f32 limit."""
    x = torch.randn(M, K, generator=gen, device=dev).to(dtype)
    w = torch.randn(K, N, generator=gen, device=dev) * 0.02
    w8, s8 = quantize_channelwise(w)
    if offset:
        x, w8 = unaligned(x), unaligned(w8)
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
    shape = (f"M{M} K{K} N{N} ({label})" + (" bias" if with_bias else "")
             + (", x and w unaligned" if offset else ""))
    require(scaled <= TOL[dtype], f"wo_matmul {dname(dtype)} {shape} "
            f"disagrees with its plain version: {scaled} > {TOL[dtype]}")
    row = dict(name=WO_ROW_NAME[route], route=route, dtype=dname(dtype),
               shape=shape, max_abs_err=err, scaled_err=scaled,
               tol=TOL[dtype])
    tf32 = route in ("gemm", "gemv")
    if tf32:
        # no atomics, a fixed summation order: bitwise reproducible
        row["bitwise"] = torch.equal(y, int8_weight_only_matmul(x, w8, s8,
                                                                bias))
        require(row["bitwise"], f"{row['name']} {dname(dtype)} {shape}: two "
                f"runs differ")
    if not timed:
        return row

    def run():
        return int8_weight_only_matmul(x, w8, s8, bias)
    ms = cuda_ms(run)
    dev_ms, kern_ms = device_ms(run, "wo_ge")
    # the wrapper's host time (checks, the plan, the launch), which the
    # CUDA-event time holds beside the kernel's
    host = host_ms(run, n=50)
    plain = cuda_ms(lambda: int8_weight_only_matmul_reference(
        x, w8, s8, bias), iters=10)
    w_deq = (w8.float() * (s8 / 127.0)).to(dtype)

    def lib_run():
        return torch.addmm(bias, x, w_deq) if with_bias else torch.mm(x,
                                                                      w_deq)
    lib = cuda_ms(lib_run)
    lib_dev = device_ms(lib_run, "")[0]
    pack_ms = None
    if int8pack:
        w_nk, s_x = w8.t().contiguous(), (s8 / 127.0).to(dtype)
        # a yardstick 90-270x slower than the kernel at prefill M 1008
        # (0.23 s a call at the head, ~40 s of the smoke at 24 calls a
        # row): the median of 5 calls
        pack_ms = cuda_ms(lambda: torch._weight_int8pack_mm(x, w_nk, s_x),
                          iters=5, warmup=1)
    size = x.element_size()
    nbytes = (M * K * size + K * N + 4.0 * N + M * N * size
              + (N * size if with_bias else 0))
    b_ms, b_by = bound(2.0 * M * N * K, nbytes, dtype)
    if tf32:
        single = None
        if dtype == torch.float32:
            one = int8_weight_only_matmul_reference(
                x, w8, s8, bias, matmul=lambda a, b: tf32_matmul(a, b, 1))
            single = ((one - ref).abs() / ref.abs().clamp_min(1.0)).max(
            ).item()
            require(single > TOL[dtype], f"{row['name']} float32 {shape}: "
                    f"the plain version with x in single-pass TF32 reads "
                    f"{single}, within the limit {TOL[dtype]}")
        t_ops = (2 if dtype == torch.float32 else 1) * 2.0 * M * N * K \
            / TF32_OPS * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        row.update(bound_cuda_core_ms=bound(2.0 * M * N * K, nbytes,
                                            torch.float32)[0],
                   single_pass_tf32_err=single)
        b_ms = max(t_ops, t_bytes)
        b_by = "operations" if t_ops >= t_bytes else "bytes"
    row.update(ms=ms, device_ms=dev_ms, kernel_device_ms=kern_ms,
               host_ms=host, plain_ms=plain, library_ms=lib,
               library_device_ms=lib_dev, bound_ms=b_ms, bound_by=b_by,
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
    the down projection's 4-bit payload can stay inside the bound.) The
    decode routes are held the same way on the last 1 and 8 rows: f32
    (``wo_matmul``, the TF32 decode GEMV) as they are, bf16
    (``wo_gemv_mma``) cast to bf16, against ``x @ W`` of those rows, with
    one bf16 rounding step of the output (2**-8 |y|) beside the bound in
    bf16."""
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
        for m in (1, 8):
            for dtype in (torch.float32, torch.bfloat16):
                xb = x[-m:].to(dtype).contiguous()
                route = wo_route(m, *w.shape, dtype)
                name = WO_ROW_NAME[route]
                before = int8_weight_only_matmul.route_launches[route]
                yb = int8_weight_only_matmul(xb, w8, s8).double().cpu()
                require(int8_weight_only_matmul.route_launches[route]
                        == before + 1, f"wo_matmul {key} {dname(dtype)} "
                        f"M{m}: not on the {route} decode route")
                exact = xb.double().cpu() @ w.double().cpu()
                bnd = weight_quant_error_bound(xb, s8).double().cpu()
                err = (yb - exact).abs()
                step = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
                drow = dict(weight=key, route=route,
                            shape=f"M{m} K{w.shape[0]} N{w.shape[1]} "
                            f"{dname(dtype)}",
                            max_err=err.max().item(),
                            max_bound=bnd.max().item(),
                            max_abs_y=exact.abs().max().item(),
                            holds=bool((err <= bnd + (step + 1e-4)
                                        * yb.abs()).all()))
                say(f"[kernel] {name} bound {drow}")
                require(drow["holds"], f"{name} {key} {dname(dtype)} M{m}: "
                        f"error past the analytic bound")
                rows.append(drow)
    require(any(r.get("four_bit_violates") for r in rows),
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
    """The int8 x int8 kernels against their plain version at ``M x K x
    N``, ``torch.equal`` (the products are exact integers), on the route
    the wrapper plans (``i8i8_route``: the decode kernel up to 16 rows and
    off TMA's rule, the prefill kernel above), which the call's count must
    show. ``fill`` "pm127": x all 127 and w +-127 with one all-127 column,
    which reaches the largest sums; "m128": both all -128, whose sums pass
    2**31 at K 131,200 and wrap. With ``timed``, its times (CUDA events,
    device time of all kernels and of the route's kernel, the wrapper's
    host time a call), its bound and ``torch._int_mm``'s time where that
    call takes the shape."""
    if fill == "m128":
        x = torch.full((M, K), -128, dtype=torch.int8, device=dev)
        w = torch.full((K, N), -128, dtype=torch.int8, device=dev)
    elif fill == "pm127":
        x = torch.full((M, K), 127, dtype=torch.int8, device=dev)
        w = (torch.randint(0, 2, (K, N), generator=gen, device=dev,
                           dtype=torch.int8) * 2 - 1) * 127
        w[:, 0] = 127
    else:
        x = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-128, 128, (K, N), generator=gen, device=dev,
                          dtype=torch.int8)
    route = i8i8_route(M, K, N)
    before = int8_matmul.route_launches[route]
    y = int8_matmul(x, w)
    require(int8_matmul.route_launches[route] == before + 1,
            f"i8i8_matmul M{M} K{K} N{N}: not on the {route} route")
    ref = int8_matmul_reference(x, w)
    torch.cuda.synchronize()
    shape = f"M{M} K{K} N{N} ({label})"
    err = (y.double() - ref.double()).abs().max().item()
    require(torch.equal(y, ref), f"i8i8_matmul {shape} ({route}) differs "
            f"from its plain version: max abs err {err}")
    if fill == "pm127":
        require(int(y[0, 0]) == 127 * 127 * K, f"i8i8_matmul {shape}: the "
                f"all-127 column sums to {int(y[0, 0])}")
    _, tile, per, splits = quant_matmul._i8_plan(dev, M, K, N)[:4]
    row = dict(name=I8_ROW_NAME[route], dtype="int8", shape=shape,
               route=route, kernel=I8_KERNEL_NAMES[route], tile_n=tile,
               max_abs_err=err, tol="torch.equal", k_splits=splits,
               k_per_split=per, max_abs_sum=int(ref.abs().max()))
    if not timed:
        return row

    def run():
        return int8_matmul(x, w)
    ms = cuda_ms(run)
    dev_ms, kern_ms = device_ms(run, I8_KERNEL_NAMES[route], per_call=1)
    plain = cuda_ms(lambda: int8_matmul_reference(x, w), iters=10)
    reason = int_mm_reason(M, K, N)
    lib = lib_dev = None
    if not reason:
        lib = cuda_ms(lambda: torch._int_mm(x, w))
        lib_dev = device_ms(lambda: torch._int_mm(x, w), "")[0]
    b_ms, b_by = bound(2.0 * M * N * K, M * K + K * N + 4.0 * M * N,
                       torch.int8)
    row.update(ms=ms, device_ms=dev_ms, kernel_device_ms=kern_ms,
               host_ms=host_ms(run), plain_ms=plain, library_ms=lib,
               library_device_ms=lib_dev, bound_ms=b_ms, bound_by=b_by,
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


def unaligned(t):
    """A contiguous copy of ``t`` whose data starts one element past a
    16-byte boundary: the norms' general route takes it."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def launches_kernel(fn, want, other):
    """Whether one call of ``fn`` launches a CUDA kernel named ``want``
    and none named ``other`` (torch.profiler), or None when no window
    recorded either kernel: late in a long run the profiler has been
    seen to drop records (see device_ms), so a window that holds neither
    is taken again, up to three windows."""
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_time_total > 0]
        seen = {k for k in (want, other) if any(k in n for n in names)}
        if seen:
            return seen == {want}
    return None


def host_ms(fn, n=200):
    """The wrapper's host time a call: the median of ``n`` calls without
    a synchronize (the card runs behind)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def norm_fwd_routes(lib, wrapper, route_of, run, x, what):
    """The norm forward ``run(x)`` on ``x`` and on an unaligned copy of
    it: each call counts one launch on the route that ``route_of`` (the
    wrapper's rule, on the call's own tensors) names, launches that
    route's CUDA kernel and not the other's (torch.profiler), and the
    copy takes the general route. Returns ``{route: (x, output,
    kernel seen by name)}``; an aligned x that the general route takes
    gives one entry."""
    out = {}
    for xin in (x, unaligned(x)):
        before = dict(wrapper.route_launches)
        res = run(xin)
        route = route_of(xin, res)
        if xin is not x:
            require(route == "general", f"{what}: an unaligned view takes "
                    f"the {route} route")
        moved = {k: wrapper.route_launches[k] - before[k] for k in before}
        require(moved == {k: int(k == route) for k in before},
                f"{what}: route launches moved by {moved}, want one on "
                f"{route}")
        other = "general" if route == "vec" else "vec"
        seen = launches_kernel(lambda: run(xin),
                               NORM_KERNEL_NAMES[(lib, route)],
                               NORM_KERNEL_NAMES[(lib, other)])
        require(seen is not False, f"{what}: the {route} route did not "
                f"launch {NORM_KERNEL_NAMES[(lib, route)]} alone")
        if seen is None:
            say(f"[profiler] {what}: no kernel recorded in three windows: "
                f"the {route} route's kernel not checked by name")
        out.setdefault(route, (xin, res, seen))
    return out


def norm_fwd_timing(row, run, plain, kern, ops, nbytes, lib_ms, lib_dev,
                    library):
    """A forward row's times: CUDA events, device time (every kernel of
    the call, and ``kern`` alone), the host time a call, the plain
    version's, the library call's, and the bound."""
    dev_ms, kern_ms = device_ms(run, kern, per_call=1)
    # the arithmetic runs in f32 on the CUDA cores whatever x's type
    b_ms, b_by = bound(ops, nbytes, torch.float32)
    row.update(ms=cuda_ms(run), device_ms=dev_ms, kernel_device_ms=kern_ms,
               host_ms=host_ms(run), plain_ms=cuda_ms(plain, iters=10),
               library_ms=lib_ms, library_device_ms=lib_dev,
               bound_ms=b_ms, bound_by=b_by, library=library)


def check_layer_norm(R, H, xdt, gdt, what, gen, dev, timed):
    """The forward and the backward, each on both routes (the vector
    kernels where 16-byte vectors take the rows, and the general kernels
    on unaligned copies), against their plain versions; in f32 two
    backward runs bitwise equal on each route (no atomics). With
    ``timed``, the kernels' times, bounds and library yardsticks."""
    x, g, b, dy, eps = ln_inputs(R, H, xdt, gdt, gen, dev)
    short = {torch.float32: "f32", torch.bfloat16: "bf16",
             torch.float16: "f16"}
    shape = f"R{R} H{H} ({what}) g {short[gdt]}"
    fwd = norm_fwd_routes(
        "layer_norm", layer_norm_fwd,
        lambda xin, y: fln.fwd_route(xin, g, b, y),
        lambda xin: layer_norm_fwd(xin, g, b, eps), x, f"layer_norm {shape}")
    bwd = bwd_routes("layer_norm_bwd", layer_norm_bwd,
                     lambda xin, din: layer_norm_bwd(xin, g, din, eps), x,
                     dy, f"layer_norm_bwd {shape}")
    y_ref = layer_norm_fwd_reference(x, g, b, eps)
    dx_ref, dg_ref, db_ref = layer_norm_bwd_reference(x, g, dy, eps)
    torch.cuda.synchronize()
    errs = {f"y_{route}": ln_err(y, y_ref, xdt)
            for route, (_, y, _) in fwd.items()}
    for route, (_, _, (dx, dg, db), _) in bwd.items():
        errs.update({f"dx_{route}": ln_err(dx, dx_ref, xdt),
                     f"dg_{route}": ln_err(dg, dg_ref, gdt, True),
                     f"db_{route}": ln_err(db, db_ref, gdt, True)})
    for k, (excess, err) in errs.items():
        require(excess <= 0, f"layer_norm {dname(xdt)} {shape}: {k} "
                f"disagrees with its plain version (max abs err {err}, "
                f"{excess} past the limit)")
    for t in ([y for _, y, _ in fwd.values()]
              + [t for _, _, res, _ in bwd.values() for t in res]):
        require(torch.isfinite(t.float()).all().item(), "non-finite output")
    reproducible = {}
    for route, (xin, din, res, _) in bwd.items():
        reproducible[route] = None
        if xdt == torch.float32:
            again = layer_norm_bwd(xin, g, din, eps)
            reproducible[route] = all(torch.equal(a, c) for a, c in
                                      zip(res, again))
            require(reproducible[route], f"layer_norm_bwd f32 {shape} "
                    f"({route} route): two runs differ (dgamma/dbeta must "
                    f"not depend on timing)")
    tol = "bf16/f16: 1 ulp + 1e-5 max; f32: 1e-5 (dg/db of max)"
    names = {"vec": "layer_norm_fwd_vec", "general": "layer_norm_fwd"}
    rows = [dict(name=names[route], dtype=dname(xdt),
                 shape=shape + ("" if xin is x else ", unaligned view"),
                 route=route, kernel_seen=seen,
                 max_abs_err=errs[f"y_{route}"][1],
                 excess_over_tol=errs[f"y_{route}"][0], tol=tol,
                 bitwise_reproducible=None)
            for route, (xin, _, seen) in fwd.items()]
    bnames = {"vec": "layer_norm_bwd_vec", "general": "layer_norm_bwd"}
    brows = [dict(name=bnames[route], dtype=dname(xdt),
                  shape=shape + ("" if xin is x else ", unaligned view"),
                  route=route, kernel_seen=seen,
                  max_abs_err=max(errs[f"{k}_{route}"][1]
                                  for k in ("dx", "dg", "db")),
                  excess_over_tol=max(errs[f"{k}_{route}"][0]
                                      for k in ("dx", "dg", "db")),
                  tol=tol, bitwise_reproducible=reproducible[route])
             for route, (xin, _, _, seen) in bwd.items()]
    if not timed:
        return rows + brows
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
    library = "F.layer_norm (weights in x's dtype)"
    for row in rows:
        xin = fwd[row["route"]][0]
        norm_fwd_timing(
            row, lambda: layer_norm_fwd(xin, g, b, eps),
            lambda: layer_norm_fwd_reference(xin, g, b, eps),
            NORM_KERNEL_NAMES[("layer_norm", row["route"])], 8.0 * R * H,
            2.0 * R * H * size + 2.0 * H * gsize, lib["fwd"], lib_dev["fwd"],
            library)
    b_ms, b_by = bound(16.0 * R * H, 3.0 * R * H * size + 3.0 * H * gsize,
                       torch.float32)
    for row in brows:
        xin, din = bwd[row["route"]][:2]

        def run(xin=xin, din=din):
            return layer_norm_bwd(xin, g, din, eps)
        # either route's row kernel and the reduction of its partials
        dev_ms, kern_ms = device_ms(run, "layer_norm_bwd", per_call=2)
        row.update(ms=cuda_ms(run), device_ms=dev_ms,
                   kernel_device_ms=kern_ms, host_ms=host_ms(run),
                   plain_ms=cuda_ms(lambda: layer_norm_bwd_reference(
                       x, g, dy, eps), iters=10),
                   library_ms=lib["bwd"], library_device_ms=lib_dev["bwd"],
                   bound_ms=b_ms, bound_by=b_by,
                   library=library + " backward through autograd",
                   library_fwd_bwd_ms=lib["fwd+bwd"],
                   library_fwd_bwd_device_ms=lib_dev["fwd+bwd"],
                   bwd_blocks=bwd_blocks(R, dev))
    return rows + brows


def bwd_routes(lib, wrapper, run, x, d, what):
    """The backward ``run(x, d)`` (``d`` the output gradient) on ``x`` and
    ``d`` and on unaligned copies of both: each call counts one launch on
    one route (the wrapper's rule, on the call's own tensors), launches
    that route's CUDA kernel and not the other's (torch.profiler), and the
    copies take the general route. Returns ``{route: (x, d, outputs,
    kernel seen by name)}``; aligned rows that the general route takes
    give one entry."""
    out = {}
    for xin, din in ((x, d), (unaligned(x), unaligned(d))):
        before = dict(wrapper.route_launches)
        res = run(xin, din)
        moved = {k: wrapper.route_launches[k] - before[k] for k in before}
        route = next(k for k, n in moved.items() if n)
        require(moved == {k: int(k == route) for k in before},
                f"{what}: route launches moved by {moved}, want one")
        if xin is not x:
            require(route == "general", f"{what}: an unaligned view takes "
                    f"the {route} route")
        other = "general" if route == "vec" else "vec"
        seen = launches_kernel(lambda: run(xin, din),
                               NORM_KERNEL_NAMES[(lib, route)],
                               NORM_KERNEL_NAMES[(lib, other)])
        require(seen is not False, f"{what}: the {route} route did not "
                f"launch {NORM_KERNEL_NAMES[(lib, route)]} alone")
        if seen is None:
            say(f"[profiler] {what}: no kernel recorded in three windows: "
                f"the {route} route's kernel not checked by name")
        out.setdefault(route, (xin, din, res, seen))
    return out


def check_rms_norm(R, H, xdt, wdt, what, gen, dev, timed, eps=1e-6):
    """The forward and the backward, each on both routes (the vector
    kernels where 16-byte vectors take the rows, and the general kernels
    on unaligned copies), against their plain versions (the backward on
    the vector route's saved r, as the plain one is given it); in f32 two
    backward runs bitwise equal on each route (no atomics). With
    ``timed``, the kernels' times, bounds and ``F.rms_norm``'s."""
    x = (torch.randn(R, H, generator=gen, device=dev) * 2 + 0.5).to(xdt)
    w = torch.randn(H, generator=gen, device=dev).to(wdt)
    do = torch.randn(R, H, generator=gen, device=dev).to(xdt)
    short = {torch.float32: "f32", torch.bfloat16: "bf16"}
    shape = f"R{R} H{H} ({what}) w {short[wdt]}"
    fwd = norm_fwd_routes(
        "rms_norm", rms_norm_fwd,
        lambda xin, res: frn.fwd_route(xin, w, *res),
        lambda xin: rms_norm_fwd(xin, w, eps), x, f"rms_norm {shape}")
    r = next(iter(fwd.values()))[1][1]
    bwd = bwd_routes("rms_norm_bwd", rms_norm_bwd,
                     lambda xin, din: rms_norm_bwd(xin, w, r, din), x, do,
                     f"rms_norm_bwd {shape}")
    o_ref, r_ref = rms_norm_fwd_reference(x, w, eps)
    dx_ref, dw_ref = rms_norm_bwd_reference(x, w, r, do)
    torch.cuda.synchronize()
    errs = {}
    for route, (_, (o, ro), _) in fwd.items():
        errs[f"o_{route}"] = ln_err(o, o_ref, xdt, True)
        errs[f"r_{route}"] = ln_err(ro, r_ref, torch.float32, True)
    for route, (_, _, (dx, dw), _) in bwd.items():
        errs[f"dx_{route}"] = ln_err(dx, dx_ref, xdt, True)
        errs[f"dw_{route}"] = ln_err(dw, dw_ref, wdt, True)
    for k, (excess, err) in errs.items():
        require(excess <= 0, f"rms_norm {dname(xdt)} {shape}: {k} "
                f"disagrees with its plain version (max abs err {err}, "
                f"{excess} past the limit)")
    for t in ([t for _, res, _ in fwd.values() for t in res]
              + [t for _, _, res, _ in bwd.values() for t in res]):
        require(torch.isfinite(t.float()).all().item(), "non-finite output")
    reproducible = {}
    for route, (xin, doin, res, _) in bwd.items():
        reproducible[route] = None
        if xdt == torch.float32:
            again = rms_norm_bwd(xin, w, r, doin)
            reproducible[route] = all(torch.equal(a, c) for a, c in
                                      zip(res, again))
            require(reproducible[route], f"rms_norm_bwd f32 {shape} "
                    f"({route} route): two runs differ (dw must not depend "
                    f"on timing)")
    tol = "bf16: 1 ulp + 1e-5 max; f32: 1e-5 of max"
    names = {"vec": "rms_norm_fwd_vec", "general": "rms_norm_fwd"}
    rows = [dict(name=names[route], dtype=dname(xdt),
                 shape=shape + ("" if xin is x else ", unaligned view"),
                 route=route, kernel_seen=seen,
                 max_abs_err=max(errs[f"{k}_{route}"][1] for k in "or"),
                 excess_over_tol=max(errs[f"{k}_{route}"][0] for k in "or"),
                 tol=tol, bitwise_reproducible=None)
            for route, (xin, _, seen) in fwd.items()]
    bnames = {"vec": "rms_norm_bwd_vec", "general": "rms_norm_bwd"}
    brows = [dict(name=bnames[route], dtype=dname(xdt),
                  shape=shape + ("" if xin is x else ", unaligned view"),
                  route=route, kernel_seen=seen,
                  max_abs_err=max(errs[f"{k}_{route}"][1]
                                  for k in ("dx", "dw")),
                  excess_over_tol=max(errs[f"{k}_{route}"][0]
                                      for k in ("dx", "dw")),
                  tol=tol, bitwise_reproducible=reproducible[route])
             for route, (xin, _, _, seen) in bwd.items()]
    if not timed:
        return rows + brows
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
    library = "F.rms_norm (weight in x's dtype)"
    for row in rows:
        xin = fwd[row["route"]][0]
        norm_fwd_timing(
            row, lambda: rms_norm_fwd(xin, w, eps),
            lambda: rms_norm_fwd_reference(xin, w, eps),
            NORM_KERNEL_NAMES[("rms_norm", row["route"])], 4.0 * R * H,
            2.0 * R * H * size + H * wsize + 4.0 * R, lib["fwd"],
            lib_dev["fwd"], library)
    b_ms, b_by = bound(10.0 * R * H,
                       3.0 * R * H * size + 2.0 * H * wsize + 4.0 * R,
                       torch.float32)
    for row in brows:
        xin, doin = bwd[row["route"]][:2]

        def run(xin=xin, doin=doin):
            return rms_norm_bwd(xin, w, r, doin)
        # either route's row kernel and the reduction of its partials
        dev_ms, kern_ms = device_ms(run, "rms_norm_bwd", per_call=2)
        row.update(ms=cuda_ms(run), device_ms=dev_ms,
                   kernel_device_ms=kern_ms, host_ms=host_ms(run),
                   plain_ms=cuda_ms(lambda: rms_norm_bwd_reference(
                       x, w, r, do), iters=10),
                   library_ms=lib["bwd"], library_device_ms=lib_dev["bwd"],
                   bound_ms=b_ms, bound_by=b_by,
                   library=library + " backward through autograd",
                   bwd_blocks=frn.bwd_blocks(R, dev))
    return rows + brows


def check_rope(B, S, H, D, table, dtype, gen, dev, timed):
    """The RoPE kernels, forward and backward (``negate_sin``), against
    their plain version, bitwise, on the ``_angle_table`` route's tables
    (built in float64, rounded to x's dtype): ``[S, D]``, or gathered by
    random ``position_ids`` to ``[B*S, D]``. Both routes: x as given (the
    vector kernel where 16-byte vectors take a half row) and a copy one
    element past a 16-byte boundary (the general kernel); each call
    counts one launch on the route the wrapper's rule names and launches
    that route's kernel and not the other's (torch.profiler). With
    ``timed``, each route's times and bound (no single torch call
    computes it)."""
    x = torch.randn(B, S, H, D, generator=gen, device=dev).to(dtype)
    cos, sin = IF._angle_table(S, D, 10000.0, False, dtype, dev)
    if table == "pos":
        pos = torch.randint(0, S, (B, S), generator=gen, device=dev)
        cos, sin = (t[pos].reshape(B * S, D) for t in (cos, sin))
    shape = (f"B{B} S{S} H{H} D{D}, "
             f"{'[S, D]' if table == 'S' else 'position_ids [B*S, D]'} "
             f"table")
    rows, done = [], set()
    for xin in (x, unaligned(x)):
        for neg in (False, True):
            before = dict(rope.route_launches)
            got = rope(xin, cos, sin, negate_sin=neg)
            moved = {k: rope.route_launches[k] - before[k] for k in before}
            route = next(k for k, n in moved.items() if n)
            require(moved == {k: int(k == route) for k in before},
                    f"rope {shape}: route launches moved by {moved}, "
                    f"want one")
            require(route == fr.route(xin, cos, sin, got),
                    f"rope {shape}: counted on {route}, the rule names "
                    f"{fr.route(xin, cos, sin, got)}")
            if xin is not x:
                require(route == "general", f"rope {shape}: an unaligned "
                        f"view takes the {route} route")
            want = rope_reference(xin, cos, sin, negate_sin=neg)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            require(torch.equal(got, want), f"rope {dname(dtype)} {shape} "
                    f"({'backward' if neg else 'forward'}, {route} route): "
                    f"not bitwise equal to its plain version (max abs err "
                    f"{err})")
        if route in done:
            continue
        done.add(route)
        other = "general" if route == "vec" else "vec"
        seen = launches_kernel(lambda: rope(xin, cos, sin),
                               NORM_KERNEL_NAMES[("rope", route)],
                               NORM_KERNEL_NAMES[("rope", other)])
        require(seen is not False, f"rope {shape}: the {route} route did "
                f"not launch {NORM_KERNEL_NAMES[('rope', route)]} alone")
        if seen is None:
            say(f"[profiler] rope {shape}: no kernel recorded in three "
                f"windows: the {route} route's kernel not checked by name")
        rows.append(dict(
            name="rope_vec" if route == "vec" else "rope",
            dtype=dname(dtype),
            shape=shape + ("" if xin is x else ", unaligned view"),
            route=route, kernel_seen=seen, max_abs_err=0.0,
            tol="bitwise (forward and backward)", x=xin))
    if timed:
        T = cos.shape[0]
        n = x.numel()
        b_ms, b_by = bound(3.0 * n, 2.0 * n * x.element_size()
                           + 2.0 * T * D * cos.element_size(), torch.float32)
        for row in rows:
            xin = row["x"]

            def run(xin=xin):
                return rope(xin, cos, sin)
            dev_ms, kern_ms = device_ms(
                run, NORM_KERNEL_NAMES[("rope", row["route"])], per_call=1)
            row.update(ms=cuda_ms(run), device_ms=dev_ms,
                       kernel_device_ms=kern_ms, host_ms=host_ms(run),
                       plain_ms=cuda_ms(lambda: rope_reference(x, cos, sin),
                                        iters=10),
                       library_ms=None, library="none", bound_ms=b_ms,
                       bound_by=b_by)
    for row in rows:
        del row["x"]
    return rows


def check_adamw_flat(N, pdt, gen, dev, timed):
    """The flat AdamW on both routes against its plain version, bitwise
    on its four outputs, at N elements with params and grads in ``pdt``
    and f32 m, v and master: on fresh tensors (the vector route, row
    ``adamw_flat_vec``) and on copies of g, m, v and master one element
    past a 16-byte boundary (the general route, row ``adamw_flat``). Each
    call must count one launch on its route and launch that route's
    kernel alone (torch.profiler). With ``timed``, each route's times,
    the bound and ``torch._fused_adamw_``'s over an f32 master/m/v of
    the same N (another decay order, so a yardstick of time only)."""
    master = torch.randn(N, generator=gen, device=dev)
    g = torch.randn(N, generator=gen, device=dev).to(pdt)
    m = torch.randn(N, generator=gen, device=dev) * 0.1
    v = torch.rand(N, generator=gen, device=dev) * 0.01
    p = master.to(pdt)
    sc = stage_flat_scalars(1e-4, 0.9, 0.999, 1e-8, 0.01, 3)
    want = adamw_flat_reference(p, g, m, v, master, sc)
    base = f"N {N}, p/g {'bf16' if pdt == torch.bfloat16 else 'f32'}"
    rows = []
    for route, ins in (("vec", (g, m, v, master)),
                       ("general", tuple(unaligned(t)
                                         for t in (g, m, v, master)))):
        shape = base + (", offset view" if route == "general" else "")
        before = dict(adamw_flat.route_launches)
        got = adamw_flat(p, *ins, sc)
        torch.cuda.synchronize()
        moved = {k: adamw_flat.route_launches[k] - before[k] for k in before}
        require(moved == {k: int(k == route) for k in before},
                f"adamw_flat {shape}: route launches moved by {moved}, want "
                f"one on {route}")
        require(flat_route(*ins, *got) == route, f"adamw_flat {shape}: "
                f"the route rule names {flat_route(*ins, *got)}")
        for what, a, b in zip(("p", "m", "v", "master"), got, want):
            require(torch.equal(a, b), f"adamw_flat {shape}: {what} is not "
                    f"bitwise equal to its plain version (max "
                    f"{(a.float() - b.float()).abs().max().item()})")
        del got
        other = "general" if route == "vec" else "vec"
        run = lambda ins=ins: adamw_flat(p, *ins, sc)
        seen = launches_kernel(run, ADAMW_FLAT_KERNEL_NAMES[route],
                               ADAMW_FLAT_KERNEL_NAMES[other])
        require(seen is not False, f"adamw_flat {shape}: the {route} route "
                f"did not launch {ADAMW_FLAT_KERNEL_NAMES[route]} alone")
        row = dict(name="adamw_flat_vec" if route == "vec" else "adamw_flat",
                   dtype=dname(pdt), shape=shape, route=route,
                   kernel_seen=seen, max_abs_err=0.0,
                   tol="bitwise (p, m, v, master)")
        rows.append(row)
        if not timed:
            continue
        dev_ms, kern_ms = device_ms(run, ADAMW_FLAT_KERNEL_NAMES[route],
                                    per_call=1)
        row.update(ms=cuda_ms(run), device_ms=dev_ms,
                   kernel_device_ms=kern_ms, host_ms=host_ms(run, n=50),
                   plain_ms=cuda_ms(lambda: adamw_flat_reference(
                       p, *ins, sc), iters=5))
    del want
    if not timed:
        return rows
    lp, lg, lm, lv = (t.float().clone() for t in (master, g, m, v))
    steps = [torch.tensor(3.0, device=dev)]

    def library():
        torch._fused_adamw_(
            [lp], [lg], [lm], [lv], [], steps, lr=1e-4, beta1=0.9,
            beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False,
            maximize=False)
    lib_ms = cuda_ms(library)
    lib_dev = device_ms(library, "")[0]
    # 16 f32 operations an element; g, m, v, master read and p, m, v,
    # master written: (psize + gsize + 24) bytes; p is never read
    size = p.element_size()
    b_ms, b_by = bound(16.0 * N, (2.0 * size + 24.0) * N, torch.float32)
    for row in rows:
        row.update(library_ms=lib_ms, library_device_ms=lib_dev,
                   library="torch._fused_adamw_ (f32 master/m/v)",
                   bound_ms=b_ms, bound_by=b_by)
    del lp, lg, lm, lv
    return rows


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


def serve(model, econf, prompts, new_tokens, probe=None):
    """Serve every prompt to completion; returns the generated tokens,
    the launch counts of this run alone, and its timings. ``probe(event,
    eng, data)``, if given, is called with ``"start"`` before the first
    round, ``"round"`` after each (``data``: the round's admissions and
    decode info; outside the timed spans) and ``"end"``. The host time
    of the engine's table check (``_validate_tables``, every decode
    step) is timed apart."""
    eng = ServingEngine(model, econf)
    validate = dict(s=0.0)
    checked = eng._validate_tables

    def timed_check(active):
        t0 = time.perf_counter()
        out = checked(active)
        validate["s"] += time.perf_counter() - t0
        return out
    eng._validate_tables = timed_check
    if probe is not None:
        probe("start", eng, None)
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
        if probe is not None:
            probe("round", eng, (infos, d))
    if probe is not None:
        probe("end", eng, None)
    # the timer holds the engine: drop it, so the engine goes on return
    del eng._validate_tables, checked
    launches = counts()
    wo_routes = dict(int8_weight_only_matmul.route_launches)
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
                 validate_host_ms_a_step=1e3 * validate["s"]
                 / max(eng.decode_steps, 1),
                 decode_programs=eng.num_decode_programs,
                 program_budget=eng.program_budget,
                 kv_high_water_bytes=eng.kv_high_water_bytes(),
                 peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 step_profile=step_profile, wo_route_launches=wo_routes)
    if eng.prefix_cache is not None:
        stats.update(prefix_hits=eng.prefix_cache.hits,
                     prefix_misses=eng.prefix_cache.misses,
                     prefix_evictions=eng.prefix_cache.evictions,
                     kv_blocks_allocated=eng.allocator.total_allocated)
    if eng.config.spec is not None:
        stats.update(spec_accepted=eng.spec_accepted,
                     spec_rejected=eng.spec_rejected)
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
    # a prefill's block projections (M = the padded prompt, > 8): bf16 on
    # wgmma, f32 on the TF32 tensor-core GEMM (gemm); every decode
    # projection and head and each prefill's head (the last row, M <= 8):
    # on the decode tensor-core GEMVs, bf16 gemv_mma, f32 gemv (TF32)
    bf16 = dtype == torch.bfloat16
    prefill = (per_pass - 1) * st["prefills"]
    decode = per_pass * st["decode_steps"] + st["prefills"]
    want_routes = {"wgmma": prefill if bf16 else 0,
                   "gemm": 0 if bf16 else prefill,
                   "gemv_mma": decode if bf16 else 0,
                   "gemv": 0 if bf16 else decode}
    require(st["wo_route_launches"] == want_routes,
            f"{tag}: wo_matmul launches by route "
            f"{st['wo_route_launches']}, want {want_routes}")
    # the f32 prefill's 96 projections a prefill on the TF32 GEMM
    require(l8["wo_gemm_tf32"] == want_routes["gemm"],
            f"{tag}: wo_gemm_tf32 launched {l8['wo_gemm_tf32']} times, want "
            f"{want_routes['gemm']} ({per_pass - 1} a prefill in f32)")
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
    """Phase 16, one run: the seed's GPT-3 1.3B (``cfg``'s depth) in
    ``dtype`` through PTQ (calibrated on ``prompts``), converted and
    served: ``i8i8_matmul`` launched 4 times a layer a prefill and a
    decode step and ``wo_matmul``
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
    # by kernel: a prefill's projections (M the padded prompt, 32..1008)
    # on the prefill kernel, a decode step's (M the batch, <= 8) on the
    # decode kernel
    i8_routes = {"wgmma": lq["i8i8_matmul_wgmma"],
                 "mma": lq["i8i8_matmul"] - lq["i8i8_matmul_wgmma"]}
    want_routes = {"wgmma": per_pass * st["prefills"],
                   "mma": per_pass * st["decode_steps"]}
    require(i8_routes == want_routes, f"{tag}: i8i8_matmul launches by "
            f"kernel {i8_routes}, want {want_routes}")
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
              i8i8_route_launches=i8_routes,
              near_ties=len(ties), tie_margins=ties,
              replay_int8_inputs_rounded_otherwise=flips,
              replay_smallest_margin=min(margins_all),
              free_dense_mismatches=free, launches=lq,
              act_scales_layer0=[model.gpt.h[0].get_submodule(n).act_scale
                                 for n in ("attn.qkv", "attn.out_proj",
                                           "mlp.up", "mlp.down")])
    if fp_gens is not None:
        st.update(tokens_agreeing_with_fp=sum(
                      a == b for x, y in zip(g, fp_gens)
                      for a, b in zip(x, y)),
                  prefix_agreeing_with_fp=[
                      next((i for i, (a, b) in enumerate(zip(x, y))
                            if a != b), new) for x, y in zip(g, fp_gens)])
    if dtype == torch.float32:
        st["vs_cpu"] = ptq_vs_cpu(model, prompts[:2])
    sp = st["step_profile"]
    say(f"[engine {tag}] decode {st['decode_tok_s']:.1f} tokens/s, prefill "
        f"{st['prefill_tok_s']:.1f} tokens/s, TTFT mean "
        f"{st['ttft_mean_s'] * 1e3:.1f} ms max {st['ttft_max_s'] * 1e3:.1f} "
        f"ms, peak {st['peak_memory_gib']:.2f} GiB; traced decode step "
        f"{sp['device_ms']:.3f} ms of device work, idle share "
        f"{sp['idle_share']:.3f}, by group {json.dumps(sp['by_group'])}; "
        f"i8i8_matmul launches by kernel {json.dumps(i8_routes)}"
        + (f"; tokens agreeing with the fp run "
           f"{st['tokens_agreeing_with_fp']} of {new * len(prompts)} "
           f"(information, not gates)" if fp_gens is not None else ""))
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
# ------------------------------------------------------------- phase 17
# the prefix traffic: one 512-token system prompt (32 blocks of 16) and
# eight private tails of 17..488 tokens; the drafts; the swap's seed
PREFIX_SYSTEM = 512
PREFIX_TAILS = [17, 488, 45, 130, 257, 401, 96, 333]
SPEC_K, SPEC_NGRAM = 3, 2
# prompt-lookup traffic for the n-gram drafter: a random span written
# out twice with the model's own continuation between the copies, the
# best of SPAN_POOL candidates a prompt
SPAN_LEN, SPAN_COPY, SPAN_ROUNDS, SPAN_POOL = 64, 16, 6, 8
SWAP_SEED = 4321


def first_divergences(model, prompts, got, want, tie):
    """Hold two served streams against each other: each request's first
    mismatch must be a near tie of the dense path (top-2 margin below
    ``tie`` on the context the two share); the request is not compared
    past it. Returns (request, token, margin) at each."""
    out = []
    for r, (p, a, b) in enumerate(zip(prompts, got, want)):
        if a == b:
            continue
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        top2 = last_logits(model, p + b[:i]).topk(2).values
        margin = (top2[0] - top2[1]).item()
        require(margin < tie, f"request {r} token {i}: {a[i]} against "
                f"{b[i]}, dense margin {margin:.3g} >= {tie}")
        out.append((r, i, margin))
    return out


def gate_engine_launches(tag, model, st, launches):
    """One flash forward a layer a prefill, one global-route paged
    decode a layer a decode step, no split route."""
    L = model.cfg.num_layers
    want = dict(flash_fwd=L * st["prefills"],
                paged_decode=L * st["decode_steps"], paged_decode_split=0)
    got = {n: launches[n] for n in want}
    require(got == want, f"{tag}: launches {got}, want {want}")


def option_figures(st, launches):
    """What phase 17 prints for a run, option on or off."""
    sp = st["step_profile"] or {}
    return dict(decode_tok_s=st["decode_tok_s"],
                decode_steps=st["decode_steps"],
                ttft_mean_s=st["ttft_mean_s"], ttft_max_s=st["ttft_max_s"],
                peak_memory_gib=st["peak_memory_gib"],
                paged_decode_launches=launches["paged_decode"],
                validate_host_ms_a_step=st["validate_host_ms_a_step"],
                traced_step_device_ms=sp.get("device_ms"),
                idle_share=sp.get("idle_share"))


def prefix17(model, dtype, econf, new, tie):
    """Check (a): eight requests sharing one 512-token system prompt,
    the cache off and on. The first misses and the other seven hit all
    32 shared blocks; the shared blocks' K and V, all layers, stay
    bitwise as the first prefill wrote them after every later round and
    at the end; the ledger audits clean; the tokens equal the cache-off
    run but at near ties."""
    V = model.cfg.vocab_size
    bs = econf["block_size"]
    rng = np.random.default_rng(17)
    system = rng.integers(0, V, size=PREFIX_SYSTEM).tolist()
    prompts = [system + rng.integers(0, V, size=n).tolist()
               for n in PREFIX_TAILS]
    base = dict(econf, kv_dtype=dname(dtype))
    allocated = {}

    def count_off(event, eng, data):
        if event == "end":
            allocated["off"] = eng.allocator.total_allocated
    g_off, l_off, st_off = serve(model, EngineConfig(**base), prompts, new,
                                 probe=count_off)
    w = dict(cached=[], checks=0)

    def watch(event, eng, data):
        if event == "round":
            for info in data[0]:
                w["cached"].append(info["cached_tokens"])
                if "idx" not in w:
                    blocks = info["seq"].table.blocks[:PREFIX_SYSTEM // bs]
                    w["idx"] = torch.as_tensor(blocks, device=eng.cache.k
                                               .device)
                    w["k"] = eng.cache.k[:, w["idx"]].clone()
                    w["v"] = eng.cache.v[:, w["idx"]].clone()
        if "idx" in w and event in ("round", "end"):
            require(torch.equal(eng.cache.k[:, w["idx"]], w["k"]) and
                    torch.equal(eng.cache.v[:, w["idx"]], w["v"]),
                    f"prefix {dname(dtype)}: a shared block's K/V changed "
                    f"after round {w['checks']}")
            w["checks"] += 1
        if event == "end":
            w["audit"] = audit_kv_ledger(
                eng.allocator, [s.table.blocks for s in
                                eng.scheduler.running()],
                prefix_cache=eng.prefix_cache)
            allocated["on"] = eng.allocator.total_allocated
    g_on, l_on, st_on = serve(model, EngineConfig(
        **base, enable_prefix_cache=True), prompts, new, probe=watch)
    tag = f"prefix {dname(dtype)}"
    require(w["cached"] == [0] + [PREFIX_SYSTEM] * (len(prompts) - 1),
            f"{tag}: cached tokens by admission {w['cached']}")
    require(st_on["prefix_hits"] == len(prompts) - 1 and
            st_on["prefix_misses"] == 1, f"{tag}: {st_on['prefix_hits']} "
            f"hits, {st_on['prefix_misses']} misses")
    shared = PREFIX_SYSTEM // bs * (len(prompts) - 1)
    require(allocated["off"] - allocated["on"] == shared,
            f"{tag}: blocks allocated {allocated}, want {shared} fewer")
    for t, st, l in ((f"{tag} off", st_off, l_off), (tag, st_on, l_on)):
        gate_engine_launches(t, model, st, l)
    div = first_divergences(model, prompts, g_on, g_off, tie)
    rec = dict(on=option_figures(st_on, l_on),
               off=option_figures(st_off, l_off),
               prefill_s=dict(on=st_on["prefill_s"], off=st_off["prefill_s"]),
               cached_tokens=w["cached"], shared_block_checks=w["checks"],
               audit=w["audit"], blocks_allocated=allocated,
               divergences=div, hits=st_on["prefix_hits"],
               misses=st_on["prefix_misses"])
    say(f"[phase 17 {tag}] {rec}")
    return rec, (l_off, l_on)


def span_prompts(model, n, seed=171):
    """``n`` prompts of the traffic prompt-lookup drafting is made for:
    a random ``SPAN_LEN``-token span written out twice, with between
    the copies ``SPAN_COPY`` tokens ``D``. A trained model continues
    such a prompt by copying what followed the span's first copy;
    random weights do not copy, so ``D`` is made of the model's own
    dense greedy continuation: starting from the continuation of
    ``span + span``, each of ``SPAN_ROUNDS`` rounds replaces ``D`` by
    the continuation of ``span + D + span``. That map need not reach a
    fixed point (``D`` is part of the context it continues), so a
    candidate keeps its best round, the one whose ``D`` agrees with its
    own continuation for the most leading tokens, and the ``n`` best of
    ``SPAN_POOL * n`` candidates are served, in the candidates' order.
    Returns the prompts and, for each, that count of leading tokens."""
    V = model.cfg.vocab_size
    rng = np.random.default_rng(seed)
    span = rng.integers(0, V, size=(SPAN_POOL * n, SPAN_LEN))

    def cont(ctx):
        return model.generate(ctx, max_new_tokens=SPAN_COPY)[
            :, ctx.shape[1]:].cpu().numpy()
    d = cont(np.concatenate([span, span], 1))
    best, stood = d.copy(), np.full(len(span), -1)
    for _ in range(SPAN_ROUNDS):
        nxt = cont(np.concatenate([span, d, span], 1))
        agree = np.argmin(np.concatenate(
            [nxt == d, np.zeros((len(d), 1), bool)], 1), 1)
        better = agree > stood
        best[better], stood[better] = d[better], agree[better]
        d = nxt
    keep = np.sort(np.argsort(-stood, kind="stable")[:n])
    prompts = np.concatenate([span, best, span], 1)[keep]
    return prompts.tolist(), stood[keep].tolist()


def spec17(model, dtype, econf, prompts, new, tie):
    """Check (b): n-gram drafts (k 3, n-gram 2) on phase 4's prompts,
    then an oracle drafter from the plain run's tokens (every draft it
    makes is accepted) and a wrong one (every draft rejected), then
    n-gram drafts on ``span_prompts``, where the drafter must draft and
    save decode steps. Each stream equals its plain run's but at near
    ties, in no more decode steps. Returns the records, the runs'
    launches and the count of paged-decode launches in verify steps."""
    V = model.cfg.vocab_size
    L = model.cfg.num_layers
    base = dict(econf, kv_dtype=dname(dtype))
    tag = f"spec {dname(dtype)}"
    g_off, l_off, st_off = serve(model, EngineConfig(**base), prompts, new)
    gate_engine_launches(f"{tag} off", model, st_off, l_off)
    truth = g_off
    verify = dict(steps=0, rows=[])

    def timed(host):
        def probe(event, eng, data):
            if event == "start":
                inner = eng._drafts

                def drafts(active):
                    t0 = time.perf_counter()
                    out = inner(active)
                    host["draft_s"] += time.perf_counter() - t0
                    return out
                eng._drafts = drafts
            elif event == "round" and data[1] is not None:
                if data[1]["rows"] > data[1]["n_active"]:
                    verify["steps"] += 1
                    verify["rows"].append(data[1]["rows"])
            elif event == "end":
                # the wrapper holds the engine: drop it, so the engine
                # (and its KV pools) go when the run returns
                del eng._drafts
        return probe

    def oracle(seq):
        t, done = truth[seq.req_id], len(seq.generated)
        if seq.generated != t[:done]:
            return []                    # past a near-tie divergence
        return t[done:done + SPEC_K]

    def wrong(seq):
        t, done = truth[seq.req_id], len(seq.generated)
        if seq.generated != t[:done] or done >= len(t):
            return []
        return [(t[done] + 1) % V] * SPEC_K

    out, runs = {}, [l_off]
    for name, fn in (("ngram", None), ("oracle", oracle), ("wrong", wrong)):
        host = dict(draft_s=0.0)
        g, l, st = serve(model, EngineConfig(**base, spec=SpeculativeConfig(
            num_draft_tokens=SPEC_K, ngram=SPEC_NGRAM, draft_fn=fn)),
            prompts, new, probe=timed(host))
        runs.append(l)
        gate_engine_launches(f"{tag} {name}", model, st, l)
        div = first_divergences(model, prompts, g, truth, tie)
        acc, rej = st["spec_accepted"], st["spec_rejected"]
        require(st["decode_steps"] <= st_off["decode_steps"],
                f"{tag} {name}: {st['decode_steps']} decode steps, the "
                f"plain run {st_off['decode_steps']}")
        if name == "oracle":
            require(acc > 0 and rej <= SPEC_K * len(div) and
                    st["decode_steps"] < st_off["decode_steps"],
                    f"{tag} oracle: {acc} accepted, {rej} rejected, "
                    f"{len(div)} divergences, {st['decode_steps']} steps")
        if name == "wrong":
            require(acc == 0 and rej > 0 and
                    st["decode_steps"] == st_off["decode_steps"],
                    f"{tag} wrong drafts: {acc} accepted, {rej} rejected, "
                    f"{st['decode_steps']} steps")
        out[name] = dict(option_figures(st, l), accepted=acc, rejected=rej,
                         divergences=div,
                         draft_host_ms_a_step=1e3 * host["draft_s"]
                         / max(st["decode_steps"], 1))
        say(f"[phase 17 {tag} {name}] {out[name]}")
    # the default drafter on traffic it drafts for: its verify rows,
    # acceptance and truncation must run, and save decode steps
    spans, stood = span_prompts(model, len(prompts))
    g_soff, l_soff, st_soff = serve(model, EngineConfig(**base), spans, new)
    gate_engine_launches(f"{tag} span off", model, st_soff, l_soff)
    host = dict(draft_s=0.0)
    g, l, st = serve(model, EngineConfig(**base, spec=SpeculativeConfig(
        num_draft_tokens=SPEC_K, ngram=SPEC_NGRAM)), spans, new,
        probe=timed(host))
    runs += [l_soff, l]
    gate_engine_launches(f"{tag} ngram span", model, st, l)
    div = first_divergences(model, spans, g, g_soff, tie)
    acc, rej = st["spec_accepted"], st["spec_rejected"]
    require(acc + rej > 0 and acc > 0 and
            st["decode_steps"] < st_soff["decode_steps"],
            f"{tag} ngram span: {acc} accepted, {rej} rejected, "
            f"{st['decode_steps']} decode steps, the plain run "
            f"{st_soff['decode_steps']}; continuations standing {stood}")
    out["ngram_span"] = dict(
        option_figures(st, l), accepted=acc, rejected=rej,
        divergences=div, copy_tokens_standing=stood,
        draft_host_ms_a_step=1e3 * host["draft_s"]
        / max(st["decode_steps"], 1))
    out["span_off"] = option_figures(st_soff, l_soff)
    say(f"[phase 17 {tag} ngram span] {out['ngram_span']}")
    say(f"[phase 17 {tag} span off] {out['span_off']}")
    out["off"] = option_figures(st_off, l_off)
    out["verify_steps"] = verify["steps"]
    out["verify_rows"] = sorted(set(verify["rows"]))
    say(f"[phase 17 {tag} off] {out['off']}")
    return out, runs, L * verify["steps"]


def spec_int8_17(cfg, econf, prompts, new):
    """Weight-only int8 f32 with drafts on every step (the last token
    repeated, k 3): verify batches of 16 and 32 rows move the block
    projections and the head from the decode GEMV (route "gemv", M <= 8)
    to the tensor-core GEMM (route "gemm", ``wo_gemm_tf32_kernel``,
    M > 8). The launches by route are gated step by step; the tokens
    are held against the quantized model's dense path at near ties."""
    model = GPTForCausalLM(cfg, seed=1234)
    buckets = []

    def probe(event, eng, data):
        if event == "round" and data[1] is not None:
            buckets.append(data[1]["bucket"][0])
    g, l, st = serve(model, EngineConfig(
        **econf, weight_only_int8=True, weight_only_lm_head=True,
        spec=SpeculativeConfig(num_draft_tokens=SPEC_K,
                               draft_fn=lambda s: [s.tokens[-1]] * SPEC_K)),
        prompts, new, probe=probe)
    _, ties = dense_check(model, prompts, g, new, NEAR_TIE)
    per_pass = 4 * len(model.gpt.h) + 1
    big = sum(1 for b in buckets if b > 8)
    small = len(buckets) - big
    want = {"wgmma": 0, "gemv_mma": 0,
            "gemm": (per_pass - 1) * st["prefills"] + per_pass * big,
            "gemv": st["prefills"] + per_pass * small}
    require(st["wo_route_launches"] == want, f"int8 spec f32: wo_matmul "
            f"launches by route {st['wo_route_launches']}, want {want}")
    require(l["wo_gemm_tf32"] == want["gemm"], f"int8 spec f32: "
            f"wo_gemm_tf32 launched {l['wo_gemm_tf32']} times, want "
            f"{want['gemm']}")
    require(big > 0, "int8 spec f32: no verify step past 8 rows")
    gate_engine_launches("int8 spec f32", model, st, l)
    rec = dict(option_figures(st, l), accepted=st["spec_accepted"],
               rejected=st["spec_rejected"], near_ties=len(ties),
               tie_margins=ties, step_buckets=sorted(set(buckets)),
               wo_route_launches=st["wo_route_launches"],
               wo_launches_past_8_rows=per_pass * big)
    say(f"[phase 17 int8 spec f32] {rec}")
    del model
    torch.cuda.empty_cache()
    return rec, l


def swap17(model, model_b, dtype, econf, prompts, new, tie):
    """Check (d): four requests in flight, ``swap_weights`` to the second
    seed's weights between decode steps, four more requests: the first
    four finish (nothing dropped), the new weights are the live ones,
    the four later requests' tokens equal a fresh engine on the second
    seed's model but at near ties, and swapping the returned weights
    back restores the first model bitwise."""
    base = dict(econf, kv_dtype=dname(dtype))
    tag = f"swap {dname(dtype)}"
    half = len(prompts) // 2
    eng = ServingEngine(model, EngineConfig(**base))
    first = [eng.submit(p, new) for p in prompts[:half]]
    step = 0
    while step < 6 or eng.scheduler.waiting:
        eng.tick(float(step))
        step += 1
    require(all(0 < len(eng.sequence(r).generated) < new for r in first),
            f"{tag}: the first requests are not in flight at the swap")
    t0 = time.perf_counter()
    prev = eng.swap_weights(model_b)
    torch.cuda.synchronize()
    swap_ms = 1e3 * (time.perf_counter() - t0)
    live = eng.runner.weights()
    require(all(torch.equal(a, b) for a, b in zip(
        live, eng.runner.state_of(model_b))), f"{tag}: weights not swapped")
    later = [eng.submit(p, new) for p in prompts[half:]]
    while not eng.idle():
        eng.tick(float(step))
        step += 1
    require(all(len(eng.sequence(r).generated) == new
                for r in first + later), f"{tag}: a request finished short")
    g_fresh, l_fresh, _ = serve(model_b, EngineConfig(**base),
                                prompts[half:], new)
    div = first_divergences(model_b, prompts[half:],
                            [eng.sequence(r).generated for r in later],
                            g_fresh, tie)
    eng.swap_weights(prev)
    require(all(torch.equal(a, b) for a, b in zip(eng.runner.weights(),
                                                  prev)),
            f"{tag}: the rollback did not restore the weights")
    rec = dict(swap_ms=swap_ms, swapped_tensors=len(prev),
               divergences=div, hot_swaps=eng.hot_swaps,
               decode_steps=eng.decode_steps)
    say(f"[phase 17 {tag}] {rec}")
    del prev, eng
    torch.cuda.empty_cache()
    return rec, l_fresh


def check_paged_verify(dtype, gen, dev, rng, split):
    """Check (c): the paged decode at a verify step's shape, k 3: 32
    query rows in groups of 4 that share a block table, the group's
    rows at contexts p0+1 .. p0+4 (p0 = the main shape's contexts less
    4), against its plain version at the main shape's tolerance; one
    launch a call (exact), bitwise on a second run; events, device time,
    plain time and the bound (the unique K and V bytes the groups hold,
    each read once; the operations of every row)."""
    k1 = SPEC_K + 1
    p0 = [c - k1 for c in PAGED_CTX]
    _, kp, vp, tables8, _ = paged_inputs(dtype, gen, dev, rng,
                                         [p + k1 for p in p0], 128)
    B, H, D = len(p0) * k1, 16, 128
    tables = tables8.repeat_interleave(k1, 0).contiguous()
    ctx_rows = [p + 1 + i for p in p0 for i in range(k1)]
    ctx = torch.as_tensor(ctx_rows, dtype=torch.int32, device=dev)
    q = torch.randn(B, 1, H, D, generator=gen, device=dev).to(dtype)
    args = (q, kp, vp, tables, ctx)
    scale = 1.0 / D ** 0.5
    if split:
        counter = paged_decode_split_partials

        def run():
            return _merge_splits(*paged_decode_split_partials(
                *args, scale=scale, pages_per_split=PAGED_PPS),
                q.dtype)[:, None]

        def plain():
            return paged_attention_split_reference(
                *args, scale=scale, pages_per_split=PAGED_PPS)
    else:
        counter = paged_decode

        def run():
            return paged_decode(*args, scale=scale)

        def plain():
            return paged_attention_reference(*args, scale=scale)
    n0 = counter.launches
    out = run()
    launches = counter.launches - n0
    ref = plain()
    torch.cuda.synchronize()
    shape = (f"B{B} (8 x {k1} rows a table) H16 D128 bs16 ctx "
             f"{sum(ctx_rows)} total (max {max(ctx_rows)})"
             + (f" pps{PAGED_PPS}" if split else ""))
    what = f"paged decode verify (split={split}) {dname(dtype)} {shape}"
    require(launches == 1, f"{what}: {launches} launches a call, want 1")
    require(torch.isfinite(out.float()).all().item(),
            f"{what}: non-finite output")
    err = (out.float() - ref.float()).abs().max().item()
    require(err <= TOL[dtype], f"{what} disagrees with its plain version: "
            f"{err} > {TOL[dtype]}")
    bitwise = torch.equal(out, run())
    require(bitwise, f"{what}: two runs differ")
    ms = cuda_ms(run)
    dev_ms, kern_ms = device_ms(run, PAGED_KERNEL, per_call=1)
    plain_ms = cuda_ms(plain, iters=5, warmup=1)
    ops = 4.0 * sum(ctx_rows) * H * D
    nbytes = 2.0 * sum(p + k1 for p in p0) * H * D * q.element_size()
    b_ms, b_by = bound(ops, nbytes, dtype)
    return dict(name="paged_decode_split" if split else "paged_decode",
                dtype=dname(dtype), shape=shape, label="verify",
                max_abs_err=err, tol=TOL[dtype], bitwise=bitwise,
                launches_a_call=launches, ms=ms, device_ms=dev_ms,
                kernel_device_ms=kern_ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def phase17(dev, prompts, new, rng_seed=170):
    """Prefix cache, drafts and admission on GPT-3 1.3B (seed 1234) at
    full width and ``SERVING_CUT_LAYERS`` deep, bf16 then f32: checks
    (a)-(d) per dtype on
    phase 4's ``prompts`` (``new`` tokens each), the int8 weight-only
    verify routes in bf16. Returns the record, the launches of every
    engine run (for the main path's counts) and the paged-decode
    launches in verify steps."""
    cfg = gpt3_1p3b(num_layers=SERVING_CUT_LAYERS)
    econf = dict(block_size=16, num_blocks=1024, max_batch=8)
    gen = torch.Generator(device=dev).manual_seed(rng_seed)
    krng = np.random.default_rng(rng_seed)
    rec = dict(verify_kernel=[], runs={})
    all_launches = []
    verify_launches = 0
    model32 = GPTForCausalLM(cfg, seed=1234)
    model_b32 = GPTForCausalLM(cfg, seed=SWAP_SEED)
    for dtype in (torch.bfloat16, torch.float32):
        tie = NEAR_TIE_BF16 if dtype == torch.bfloat16 else NEAR_TIE
        for split in (False, True):
            rec["verify_kernel"].append(check_paged_verify(
                dtype, gen, dev, krng, split))
        if dtype == torch.bfloat16:
            model = copy.deepcopy(model32).to(dtype)
            model_b = copy.deepcopy(model_b32).to(dtype)
        else:
            model, model_b = model32, model_b32
        r = rec["runs"][dname(dtype)] = {}
        # one short run first: the first engine run of a model pays for
        # cuBLAS's first calls, which would land on the option-off run
        serve(model, EngineConfig(**econf, kv_dtype=dname(dtype)),
              prompts[:2], 4)
        r["prefix"], ls = prefix17(model, dtype, econf, new, tie)
        all_launches += ls
        r["spec"], ls, v = spec17(model, dtype, econf, prompts, new, tie)
        all_launches += ls
        verify_launches += v
        r["swap"], l = swap17(model, model_b, dtype, econf, prompts, new,
                              tie)
        all_launches.append(l)
        del model, model_b
        torch.cuda.empty_cache()
    del model32, model_b32
    torch.cuda.empty_cache()
    rec["int8_spec_f32"], l = spec_int8_17(cfg, econf, prompts, new)
    all_launches.append(l)
    return rec, all_launches, verify_launches


# ------------------------------------------------------------ phase 18
# (a) the CPU tests' op tables (tests/torch_core_table_*.py), run on the
# card against the CPU
CORE_TABLES = ("math", "manipulation", "linalg", "creation", "logic_misc",
               "extra")
# (b) GPT-3 1.3B's width, 24 layers cut to 2, bf16, ids [batch, seq]
CORE_GRAD = dict(layers=2, batch=4, seq=1024, seed=18)


def core_tables():
    """The op tables of the CPU tests and their JAX-free harness."""
    tests = str(Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import importlib
    cc = importlib.import_module("torch_core_cases")
    tables = {n: importlib.import_module(f"torch_core_table_{n}").CASES
              for n in CORE_TABLES}
    return cc, tables, importlib.import_module("torch_core_table_random")


def core_ops_on_card(dev):
    """(a) Every case of the CPU tests' op tables once on ``dev`` against
    the same op on the CPU (values at the tests' tolerances, dtypes,
    shapes and, for a differentiable op, gradients), and every random
    draw of the random tests on ``dev``: the CPU draw's shape and dtype,
    equal draws after equal seeds."""
    cc, tables, tr = core_tables()
    rec = dict(cases=0, failures=[], max_err={})
    for name, cases in tables.items():
        for case in cases:
            for dt in case.dtypes:
                rec["cases"] += 1
                try:
                    err = cc.run_on_devices(case, dt, paddle, dev)
                    key = f"{case.op} {dt}"
                    rec["max_err"][key] = max(rec["max_err"].get(key, 0.0),
                                              err)
                except Exception as e:      # gathered, then gated below
                    rec["failures"].append(
                        f"{name}: {case.id} {dt}: {type(e).__name__}: "
                        f"{str(e)[:400]}")
    for op, a, kw in tr.DRAWS:
        rec["cases"] += 1
        try:
            outs = []
            for d in ("cpu", "gpu", "gpu"):
                paddle.set_device(d)
                paddle.seed(5)
                args = [paddle.to_tensor(x) if isinstance(x, np.ndarray)
                        else x for x in a]
                outs.append(getattr(paddle, op)(*args, **kw))
            c, g1, g2 = outs
            require(g1.device.type == "cuda", "drawn off the card")
            require(g1.dtype == c.dtype and g1.shape == c.shape,
                    f"{g1.dtype} {tuple(g1.shape)} on the card, {c.dtype} "
                    f"{tuple(c.shape)} on the CPU")
            require(torch.equal(g1, g2), "two draws after seed(5) differ")
        except Exception as e:
            rec["failures"].append(f"random: {op} {a!r:.60}: "
                                   f"{type(e).__name__}: {str(e)[:300]}")
    paddle.set_device("gpu")
    return rec


def core_grads(model, ids, params):
    _, loss = model(ids, labels=ids)
    return loss.detach(), paddle.grad(loss, params)


def core_surface(dev):
    """(b) The public surface at GPT-3 1.3B's width under
    ``FLAGS_check_nan_inf``: ``paddle.seed``, ``set_device("gpu")``,
    ``to_tensor`` ids and labels, a 2-layer bf16 ``GPTForCausalLM``;
    ``paddle.grad`` of the loss with respect to every parameter twice
    with the flag off and once on, first with the backward forced onto
    the split pair (no atomics: every gradient bitwise equal with the
    flag), then on bf16's route, the fused backward (within the rerun
    spread, see below); then the mode seen in autograd's device thread,
    and an infinite embedding row named by the first op that saw it.
    Returns the record and the launches of the gradient runs (a
    main-path run)."""
    C = CORE_GRAD
    paddle.seed(C["seed"])
    paddle.set_device("gpu")
    cfg = gpt3_1p3b(num_layers=C["layers"])
    ids = paddle.to_tensor(np.random.RandomState(C["seed"]).randint(
        0, cfg.vocab_size, (C["batch"], C["seq"])), dtype="int64")
    require(ids.device.type == "cuda" and ids.dtype == torch.int32,
            f"to_tensor gave {ids.dtype} on {ids.device}")
    model = GPTForCausalLM(cfg, seed=C["seed"]).to(torch.bfloat16)
    params = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]
    rec = dict(shape=f"B{C['batch']} S{C['seq']} H{cfg.hidden_size} "
               f"L{C['layers']} bf16")
    reset_counts()

    def off_off_on():
        """Gradients twice with the flag off and once with it on, and
        the seconds of the first and of the last."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs = [core_grads(model, ids, params)]
        torch.cuda.synchronize()
        t_off = time.perf_counter() - t0
        runs.append(core_grads(model, ids, params))
        flags.set_flags({"check_nan_inf": True})
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs.append(core_grads(model, ids, params))
            torch.cuda.synchronize()
            t_on = time.perf_counter() - t0
        finally:
            flags.set_flags({"check_nan_inf": False})
        return runs, t_off, t_on

    # the split backward pair (no atomics): every result reruns
    # bitwise, so the flag must change none
    route = flash_attn_mod.bwd_route
    flash_attn_mod.bwd_route = lambda dtype: "split"
    try:
        runs, t_off, t_on = off_off_on()
    finally:
        flash_attn_mod.bwd_route = route
    (l1, g1), (l2, g2), (l3, g3) = runs
    require(torch.isfinite(l1).item(), "loss not finite")
    for n, a, b, c in zip(names, g1, g2, g3):
        require(torch.equal(a, b), f"{n}: the split backward's gradient "
                f"does not rerun bitwise")
        require(torch.equal(a, c), f"{n}: with FLAGS_check_nan_inf on the "
                f"gradient differs by "
                f"{(a.float() - c.float()).abs().max():.3g}")
    require(torch.equal(l1, l3), "the loss changed with the flag")
    rec.update(loss=l1.item(), split_route_bitwise=len(names),
               grad_s_split=[t_off, t_on])
    # the bf16 route, the fused backward (flash_bwd_wgmma.cu): its dQ
    # atomics add in another order each run, so gradients below the top
    # attention move run to run; the flag must move them no more than a
    # rerun does, plus one bfloat16 rounding step of their magnitude
    runs, t_off, t_on = off_off_on()
    launches = counts()
    (l1, g1), (l2, g2), (l3, g3) = runs
    require(torch.equal(l1, l3), "the loss changed with the flag")
    moved = []
    for n, a, b, c in zip(names, g1, g2, g3):
        spread = (a.float() - b.float()).abs().max().item()
        change = (a.float() - c.float()).abs().max().item()
        step = a.float().abs().max().item() * 2.0 ** -8
        if spread or change:
            moved.append((n, spread, change))
        require(change <= spread + step, f"{n}: the flag moves the "
                f"gradient by {change:.3g}, a rerun without it by "
                f"{spread:.3g} (one bf16 step {step:.3g})")
    rec.update(fused_bitwise=len(names) - len(moved),
               fused_moved=moved, grad_s_fused=[t_off, t_on])
    say(f"[phase 18 b] split backward: {len(names)} of {len(names)} "
        f"gradients bitwise with the flag on and off (s off / on: "
        f"{rec['grad_s_split'][0]:.3f} / {rec['grad_s_split'][1]:.3f}); "
        f"fused backward: {rec['fused_bitwise']} bitwise, rerun spread / "
        f"flag change of the others: "
        + "; ".join(f"{n} {sp:.3g} / {ch:.3g}" for n, sp, ch in moved)
        + f" (s off / on: {t_off:.3f} / {t_on:.3f})")
    # the mode in autograd's device thread: a hook on a block's output
    # makes its gradient NaN inside the backward; only an op checked in
    # that thread can report it
    main = threading.get_ident()
    seen = {}

    def poison(g):
        seen["thread"] = threading.get_ident()
        return g * float("nan")

    def attach(mod, inputs, out):
        out.register_hook(poison)
    h = model.gpt.h[0].register_forward_hook(attach)
    flags.set_flags({"check_nan_inf": True})
    try:
        _, loss = model(ids, labels=ids)
        try:
            loss.backward()
            msg = None
        except FloatingPointError as e:
            msg = str(e)
    finally:
        flags.set_flags({"check_nan_inf": False})
        h.remove()
        model.zero_grad(set_to_none=True)
    rec["backward_error"] = msg
    rec["backward_thread_is_main"] = seen.get("thread") == main
    # the poisoning multiply is the first op to see the NaN; a kernel
    # wrapper would be the first to report it were the mode not active
    # in the device thread
    require(msg is not None and "'aten.mul'" in msg
            and "in the backward of" in msg,
            f"the backward's NaN was not reported by its first op: {msg}")
    require(seen.get("thread") not in (None, main),
            "the poisoned gradient was not in a device thread")
    # an infinite embedding row: the lookup is the first op to see it
    row = int(ids[0, 5])
    with torch.no_grad():
        saved = model.gpt.wte.weight[row].clone()
        model.gpt.wte.weight[row] = float("inf")
    flags.set_flags({"check_nan_inf": True})
    try:
        try:
            model(ids, labels=ids)
            msg = None
        except FloatingPointError as e:
            msg = str(e)
    finally:
        flags.set_flags({"check_nan_inf": False})
        with torch.no_grad():
            model.gpt.wte.weight[row] = saved
    rec["forward_error"] = msg
    require(msg is not None and "aten.embedding" in msg,
            f"the infinite row was not reported by the embedding: {msg}")
    say(f"[phase 18 b] backward: {rec['backward_error']} (thread is the "
        f"main thread: {rec['backward_thread_is_main']}); forward: "
        f"{rec['forward_error']}")
    del model, params, runs, g1, g2, g3
    torch.cuda.empty_cache()
    return rec, launches


def core_checkpoint(prompts, new, want_gens):
    """(c) ``paddle.save`` phase 4's GPT-3 1.3B (seed 1234, bf16) to a
    temporary file, ``paddle.load`` it into a model of another seed
    (every leaf bitwise), a copy with one byte flipped must raise
    ``CheckpointCorruptionError``, and the loaded model serves phase 4's
    prompts: tokens equal phase 4's bf16 run's, or (a kernel not
    deterministic from run to run) differ first at a near tie of phase
    4's bf16 rule. Returns the record and the serving run's launches."""
    import tempfile
    from paddle2_tpu_torch.framework.io_state import \
        CheckpointCorruptionError
    cfg = gpt3_1p3b()
    econf = dict(block_size=16, num_blocks=1024, max_batch=8)
    src = GPTForCausalLM(cfg, seed=1234).to(torch.bfloat16)
    state = src.state_dict()
    rec = {}
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as d:
        path = os.path.join(d, "gpt3_1p3b_bf16.pdparams")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paddle.save(state, path)
        rec["save_s"] = time.perf_counter() - t0
        rec["file_bytes"] = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = paddle.load(path)
        rec["load_s"] = time.perf_counter() - t0
        require(set(loaded) == set(state), "loaded names differ")
        model = GPTForCausalLM(cfg, seed=4321).to(torch.bfloat16)
        model.load_state_dict(loaded)
        after = model.state_dict()
        bad = [k for k, v in state.items()
               if after[k].dtype != v.dtype or not torch.equal(after[k], v)]
        require(not bad, f"leaves differ after load: {bad[:5]}")
        rec["leaves"] = len(state)
        del src, state, loaded, after
        torch.cuda.empty_cache()
        broken = os.path.join(d, "broken.pdparams")
        shutil.copyfile(path, broken)
        with open(broken, "r+b") as f:
            f.seek(rec["file_bytes"] // 2)
            b = f.read(1)
            f.seek(rec["file_bytes"] // 2)
            f.write(bytes([b[0] ^ 0x10]))
        t0 = time.perf_counter()
        try:
            paddle.load(broken)
            err = None
        except CheckpointCorruptionError as e:
            err = str(e)
        rec["corrupt_load_s"] = time.perf_counter() - t0
        rec["corrupt_error"] = err
        require(err is not None, "a flipped byte loaded without error")
    gens, launches, stats = serve(
        model, EngineConfig(**econf, kv_dtype="bfloat16"), prompts, new)
    rec["tokens_equal_phase4"] = gens == want_gens
    rec["decode_tok_s"] = stats["decode_tok_s"]
    if gens != want_gens:
        _, ties = dense_check(model, prompts, gens, new, NEAR_TIE_BF16)
        rec["near_ties"] = ties
    say(f"[phase 18 c] save {rec['save_s']:.2f} s, load "
        f"{rec['load_s']:.2f} s, {rec['file_bytes']} bytes, "
        f"{rec['leaves']} leaves bitwise; flipped byte: "
        f"{rec['corrupt_error']}; served tokens equal phase 4's: "
        f"{rec['tokens_equal_phase4']}")
    del model
    torch.cuda.empty_cache()
    return rec, launches


def phase18(dev, prompts, new, want_gens):
    """Phase 18, "core": (a) the op library on the card, (b) the surface
    at full width under the finite check, (c) save, load and serve.
    Returns the record and the main path's launches ((b) and (c))."""
    rec = {}
    t0 = time.perf_counter()
    rec["ops"] = core_ops_on_card(dev)
    rec["ops_s"] = time.perf_counter() - t0
    say(f"[phase 18 a] {rec['ops']['cases']} op cases on the card against "
        f"the CPU in {rec['ops_s']:.1f} s, {len(rec['ops']['failures'])} "
        f"failures")
    for f in rec["ops"]["failures"]:
        say(f"[phase 18 a] FAILED {f}")
    require(not rec["ops"]["failures"],
            f"{len(rec['ops']['failures'])} ops differ on the card")
    t0 = time.perf_counter()
    rec["surface"], lb = core_surface(dev)
    rec["surface_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["checkpoint"], lc = core_checkpoint(prompts, new, want_gens)
    rec["checkpoint_s"] = time.perf_counter() - t0
    launches = {n: lb[n] + lc[n] for n in lb}
    for n in ("flash_fwd", "flash_bwd_fused", "paged_decode"):
        require(launches[n] > 0, f"phase 18 never launched {n}")
    rec["launches"] = launches
    return rec, launches


def train_setup(layers, device, bf16, seed=0, granularity="dots"):
    """``bench_gpt``'s default model, optimizer and fused step (the
    ``BENCH_FUSED_OPT=1`` variant), at ``layers`` blocks, under the remat
    ``granularity`` (``BENCH_REMAT``)."""
    cfg = GPTConfig(vocab_size=TRAIN["vocab"], hidden_size=TRAIN["hidden"],
                    num_layers=layers, num_heads=TRAIN["heads"],
                    max_position_embeddings=TRAIN["seq"],
                    use_recompute=True, recompute_granularity=granularity,
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
    # the fused AdamW: one multi-tensor launch a step for the 16 leaves
    want = {"flash_fwd": T["layers"], "adamw_step": 1}
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
    1e-4 of each gradient's largest magnitude. The first card step is
    traced: the f32 backward route's kernels must be in it by name."""
    model, step = train_setup(2, "cuda", bf16=False, seed=1)
    cpu = copy.deepcopy(model).cpu()
    cpu_step = optimizer_and_step(cpu)
    ids = batches(2, 2, "cpu")
    route = bwd_route(torch.float32)
    kernels = (("flash_bwd_fused",) if route == "fused" else
               ("flash_bwd_split_dkv", "flash_bwd_split_dq"))
    names = [FLASH_KERNEL_NAMES[n, torch.float32]
             for n in ("flash_fwd",) + kernels]
    reset_counts()
    out = dict(backward_route=route, losses_card=[], losses_cpu=[])
    for i, b in enumerate(ids):
        if i == 0:
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                loss = float(step(b.cuda(), b.cuda()))
                torch.cuda.synchronize()
            keys = [e.key for e in prof.key_averages()]
            out["traced_kernels"] = {n: sum(n in k for k in keys)
                                     for n in names}
        else:
            loss = float(step(b.cuda(), b.cuda()))
        out["losses_card"].append(loss)
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
    require(all(out["traced_kernels"].values()),
            f"the f32 step's trace lacks its flash kernels: "
            f"{out['traced_kernels']}")
    # in f32 the forward's and the split wrappers' launches are their
    # tensor-core kernels'
    for n in ("flash_fwd", "adamw_step") + kernels:
        require(launches[n] > 0, f"{n} was not launched by the f32 run")
        require(launches.get(F32_TC_ROW.get(n), launches[n])
                == launches[n], f"{n}: {launches[n]} launches in f32, "
                f"{launches.get(F32_TC_ROW.get(n))} of them its "
                f"tensor-core kernel's")
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
    # every LayerNorm forward and backward on the vector route
    want = {"layer_norm_fwd": n_ln, "layer_norm_fwd_vec": n_ln,
            "layer_norm_bwd": n_ln, "layer_norm_bwd_vec": n_ln,
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
               step_profile=step_profile(prof, wall_ms, step_s * 1e3),
               device_ms_by_group=device_groups(prof, ERNIE_GROUPS))
    return run, launches, model, step


def ernie_padded(model, step):
    """Phase 8: three more bf16 steps of the phase-7 model on padded
    batches (an ``attention_mask`` from row lengths 16..128): finite
    losses, the fused LayerNorm 25 + 25 times a step (every forward and
    every backward on the vector route), and attention on
    the masked route (no flash launch)."""
    mask, lens = padding_mask(ERNIE["batch"], "cuda")
    data = ernie_batches(3, ERNIE["batch"], "cuda")
    reset_counts()
    losses = [float(step(ids, lbl, mask)) for ids, lbl in data]
    torch.cuda.synchronize()
    launches = counts()
    require(all(np.isfinite(losses)), f"non-finite padded losses {losses}")
    n_ln = 1 + 2 * model.cfg.num_layers
    for n in ("layer_norm_fwd", "layer_norm_fwd_vec", "layer_norm_bwd",
              "layer_norm_bwd_vec"):
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
        require(launches.get(SPLIT_TF32X3.get(n), launches[n])
                == launches[n], f"ERNIE f32: {n}: {launches[n]} launches, "
                f"{launches.get(SPLIT_TF32X3.get(n))} of them its "
                f"tensor-core kernel's")
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


# phase 7's traced ERNIE step by kernel group: the LayerNorm kernels by
# direction (the backward's row kernels and the reduction of their
# partials), the flash kernels, cuBLAS's GEMMs by their names' stems
ERNIE_GROUPS = (("layer_norm_fwd", ("layer_norm_fwd",)),
                ("layer_norm_bwd", ("layer_norm_bwd",)),
                ("flash", ("flash_",)),
                ("gemm", ("gemm", "cutlass", "xmma", "sm90_xmma", "nvjet",
                          "cublas")))


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
    paddle.seed(0)
    with core.place_scope("gpu"):
        model = amp.decorate(resnet50(num_classes=R["classes"]),
                             level="O2", dtype="bfloat16")
    n_params = sum(p.numel() for p in model.parameters())
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
    paddle.seed(0)
    with core.place_scope("gpu"):
        model = resnet18(num_classes=C["classes"])
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
    if dtype in HALF:
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
            require(dtype != torch.float16 or
                    fused_stats["max_err"] <= F16_FUSED_MAX,
                    f"flash_varlen fused backward float16 {shape} {lens}: "
                    f"largest error {fused_stats['max_err']} > "
                    f"{F16_FUSED_MAX}")
        else:
            require(max(bwd_err[route].values()) <= tol, f"flash_varlen "
                    f"{route} backward {dname(dtype)} {shape} {lens}: "
                    f"{bwd_err[route]} > {tol}")
    unrounded = None
    if timed and dtype in HALF:
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
                f"flash_varlen {dname(dtype)} {shape}: the plain backward "
                f"without P/dS rounding reads {unrounded}, within the "
                f"limits {tol} "
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
    if dtype in HALF:
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


def check_varlen_exact(H, D, lens_q, lens_k, causal, gen, dev,
                       dtype=torch.bfloat16):
    """The bf16 fused backward on q, k, v and dO drawn from {-1, 0, 1}:
    every score and dP sum is an integer, exact in any order, so the
    kernel's P and dS round as the plain version's do, and no bf16 flip
    at a rounding boundary (see ``half_step_err``) can hide a pair seen
    twice or not at all: held to ``EXACT_TOL`` of the plain version's
    f32 sums beyond half a step of ``dtype`` (bf16, or f16 for its
    instantiation)."""
    meta, (q_tiles, k_tiles), keep = varlen_meta(lens_q, lens_k, causal,
                                                 dev)
    Tq, Tk = keep.shape

    def draw(T):
        return torch.randint(-1, 2, (T, H, D), generator=gen,
                             device=dev).to(dtype)
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
    return dict(name="flash_varlen_exact", dtype=dname(dtype), shape=shape,
                dq_dk_dv_err=err, tol=EXACT_TOL)


def check_flash_bwd_exact(dtype, B, H, S, D, gen, dev):
    """The dense fused backward on q, k, v and dO drawn from {-1, 0, 1},
    causal, as ``check_varlen_exact`` holds the varlen one: every score
    and dP sum is exact in any order, so P and dS round as the plain
    version's do, and the kernel must equal the plain f32 sums to
    ``EXACT_TOL`` beyond half a step of ``dtype`` in every (batch, head)
    slice and tile."""
    def draw():
        return torch.randint(-1, 2, (B, H, S, D), generator=gen,
                             device=dev).to(dtype)
    q, k, v, do = draw(), draw(), draw(), draw()
    scale = 1.0 / D ** 0.5
    o, lse = flash_fwd(q, k, v, scale=scale, causal=True)
    got = flash_bwd(q, k, v, o, lse, do, scale, True, route="fused")
    ref = flash_bwd_reference(q, k, v, o, lse, do, scale, True,
                              out_dtype=torch.float32)
    torch.cuda.synchronize()
    err = {n: half_step_err(g, r) for n, g, r in zip(("dq", "dk", "dv"),
                                                      got, ref)}
    shape = f"B{B} H{H} S{S} D{D} causal"
    require(max(err.values()) <= EXACT_TOL, f"flash_bwd fused "
            f"{dname(dtype)} {shape}, inputs in {{-1, 0, 1}}: {err} > "
            f"{EXACT_TOL}")
    del q, k, v, do, o, lse, got, ref
    torch.cuda.empty_cache()
    return dict(name="flash_bwd_exact", dtype=dname(dtype), shape=shape,
                dq_dk_dv_err=err, tol=EXACT_TOL)


def check_varlen_split_exact(H, D, lens_q, lens_k, causal, gen, dev):
    """The bf16 split pair (``flash_varlen_dkv_kernel`` and
    ``flash_varlen_dq_kernel``, the CUDA cores) on q, k, v and dO from
    {-1, 0, 1}, as ``check_varlen_exact`` holds the fused kernel: every
    score and dP sum is exact in any order, so P and dS round as the
    plain version's do and the pair must equal the plain f32 sums to
    ``EXACT_TOL`` beyond half a bf16 step."""
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
    dk, dv = flash_varlen_bwd_dkv(q, k, v, do, lse, delta, *meta, k_tiles,
                                  scale)
    dq = flash_varlen_bwd_dq(q, k, v, do, lse, delta, *meta, q_tiles, scale)
    dk_ref, dv_ref = flash_varlen_bwd_dkv_reference(
        q, k, v, do, lse, delta, *meta, scale, out_dtype=torch.float32)
    dq_ref = flash_varlen_bwd_dq_reference(q, k, v, do, lse, delta, *meta,
                                           scale, out_dtype=torch.float32)
    torch.cuda.synchronize()
    err = {n: half_step_err(g, r) for n, g, r in
           (("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref))}
    shape = (f"H{H} D{D} Tq{Tq} Tk{Tk} "
             + ("causal" if causal else "non-causal") + f" lens {lens_q}"
             + (f" / k {lens_k}" if lens_k else ""))
    require(max(err.values()) <= EXACT_TOL, f"flash_varlen split pair "
            f"{shape}, inputs in {{-1, 0, 1}}: {err} > {EXACT_TOL}")
    return dict(name="flash_varlen_split_exact", dtype="bfloat16",
                shape=shape, dq_dk_dv_err=err, tol=EXACT_TOL)


# the bf16 split pair over random draws: seeds of their own generators,
# so no earlier draw of the smoke moves
SPLIT_DRAW_SEEDS = tuple(range(1000, 1008))


def check_varlen_split_draws(dev):
    """The bf16 split pair over ``SPLIT_DRAW_SEEDS`` draws of the README
    batch and of the serving lengths (H16 D128, causal): each draw's
    largest error beyond half a bf16 step against the plain f32 sums
    (``half_step_err``) must be within ``BWD_TOL``."""
    out = []
    for lens in (VARLEN_README, VARLEN_SERVING):
        meta, (q_tiles, k_tiles), keep = varlen_meta(lens, None, True, dev)
        Tq, Tk = keep.shape
        H, D = 16, 128
        scale = 1.0 / D ** 0.5
        for seed in SPLIT_DRAW_SEEDS:
            g = torch.Generator(device=dev).manual_seed(seed)
            q, do = (torch.randn(Tq, H, D, generator=g, device=dev)
                     .to(torch.bfloat16) for _ in range(2))
            k, v = (torch.randn(Tk, H, D, generator=g, device=dev)
                    .to(torch.bfloat16) for _ in range(2))
            o, lse = flash_varlen_fwd(q, k, v, *meta, q_tiles, scale)
            delta = (do.float() * o.float()).sum(-1).t().contiguous()
            dk, dv = flash_varlen_bwd_dkv(q, k, v, do, lse, delta, *meta,
                                          k_tiles, scale)
            dq = flash_varlen_bwd_dq(q, k, v, do, lse, delta, *meta,
                                     q_tiles, scale)
            dk_ref, dv_ref = flash_varlen_bwd_dkv_reference(
                q, k, v, do, lse, delta, *meta, scale,
                out_dtype=torch.float32)
            dq_ref = flash_varlen_bwd_dq_reference(
                q, k, v, do, lse, delta, *meta, scale,
                out_dtype=torch.float32)
            err = {n: half_step_err(got, ref) for n, got, ref in
                   (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                    ("dv", dv, dv_ref))}
            what = ("README" if lens == VARLEN_README else "serving")
            row = dict(name="flash_varlen_split_draw", batch=what,
                       seed=seed, err=err)
            require(max(err.values()) <= BWD_TOL[torch.bfloat16],
                    f"flash_varlen split pair bf16 {what} batch, seed "
                    f"{seed}: {err} > {BWD_TOL[torch.bfloat16]}")
            out.append(row)
            del q, k, v, do, o, lse, delta, dk, dv, dq, dk_ref, dv_ref
            del dq_ref
            torch.cuda.empty_cache()
    return out


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
    # the fused AdamW: one multi-tensor launch a step for the 2 x layers
    # weights
    want["adamw_step"] = 1
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
                ("rope", ("rope_kernel", "rope_vec_kernel")),
                ("adamw_flat", ("adamw_flat",)),
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
    # every RMSNorm forward and backward and every RoPE on the vector
    # route
    want = {"rms_norm_fwd": 2 * L + 1, "rms_norm_fwd_vec": 2 * L + 1,
            "rms_norm_bwd": 2 * L + 1, "rms_norm_bwd_vec": 2 * L + 1,
            "rope": 4 * L, "rope_vec": 4 * L, "adamw_flat": len(params),
            "adamw_flat_vec": len(params), "flash_fwd": L,
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


# ---------------------------------------------------------- phase 19
# float16 pretraining, Paddle's usual GPT recipe: O2 with dynamic loss
# scaling, linear warmup into cosine decay, a global-norm clip of 1.0
AMP_RECIPE = dict(init_loss_scaling=2.0 ** 15, lr=1e-4, T_max=100,
                  warmup_steps=2, clip=1.0)
# the resume check's sequence: one 128-key tile, so each dQ element of
# the fused backward gets one addition and a step is bitwise
# reproducible (longer rows add the key tiles' shares in a run-dependent
# order)
AMP_RESUME = dict(layers=2, batch=2, seq=128)
AMP_O1 = dict(layers=2, batch=2, seq=256)
# f16 against the CPU: the loss to 4 f16 steps relative, each gradient
# to 8 f16 steps of its largest magnitude (the card's flash kernels and
# the CPU's plain versions round the same values, summing in other
# orders), as tests/test_torch_amp.py holds the port against JAX
F16_STEP = 2.0 ** -11
# the f16 instantiations' names in a trace at the training head dim
# (64): demangled, and mangled (as a record may come)
AMP_F16_KERNELS = {
    "flash_fwd": ("flash_fwd_wgmma_kernel<__half, 64>",
                  "flash_fwd_wgmma_kernelI6__halfLi64E"),
    "flash_bwd_fused": ("flash_bwd_fused_wgmma_kernel<__half, 64>",
                        "flash_bwd_fused_wgmma_kernelI6__halfLi64E")}
# the same kernels at the primer's head dim (128), which the names above
# do not match
AMP_F16_PRIMER = {
    "flash_fwd": ("flash_fwd_wgmma_kernel<__half, 128>",
                  "flash_fwd_wgmma_kernelI6__halfLi128E"),
    "flash_bwd_fused": ("flash_bwd_fused_wgmma_kernel<__half, 128>",
                        "flash_bwd_fused_wgmma_kernelI6__halfLi128E")}
# every wrapper of the flash kernels that counts its launches by dtype
DTYPE_COUNTED = (flash_fwd, flash_bwd_fused, flash_bwd_split_dkv,
                 flash_bwd_split_dq, flash_varlen_fwd, flash_varlen_bwd_fused,
                 flash_varlen_bwd_dkv, flash_varlen_bwd_dq)
DTYPE_COUNTED_NAMES = ("flash_fwd", "flash_bwd_fused", "flash_bwd_split_dkv",
                       "flash_bwd_split_dq", "flash_varlen_fwd",
                       "flash_varlen_bwd_fused", "flash_varlen_bwd_dkv",
                       "flash_varlen_bwd_dq")


def f16_counts():
    return {n: fn.dtype_launches[torch.float16]
            for n, fn in zip(DTYPE_COUNTED_NAMES, DTYPE_COUNTED)}


def reset_dtype_counts():
    for fn in DTYPE_COUNTED:
        for dt in fn.dtype_launches:
            fn.dtype_launches[dt] = 0


def amp_schedule(lrmod=paddle.optimizer.lr):
    R = AMP_RECIPE
    return lrmod.LinearWarmup(lrmod.CosineAnnealingDecay(R["lr"],
                                                         T_max=R["T_max"]),
                              warmup_steps=R["warmup_steps"], start_lr=0.0,
                              end_lr=R["lr"])


def amp_setup(layers, device, seed=0, seq=None, o2=True, **scaler_kw):
    """The bench GPT at ``layers`` blocks as a Paddle user sets up float16
    training: ``decorate`` O2 (when ``o2``), AdamW with the scheduler,
    masters, the fused step and the clip, and a ``GradScaler``."""
    cfg = GPTConfig(vocab_size=TRAIN["vocab"], hidden_size=TRAIN["hidden"],
                    num_layers=layers, num_heads=TRAIN["heads"],
                    max_position_embeddings=seq or TRAIN["seq"],
                    use_recompute=True, recompute_granularity="dots",
                    stacked_blocks=True, fused_head_loss=True)
    model = GPTForCausalLM(cfg, device=device, seed=seed)
    if o2:
        model = amp.decorate(model, level="O2", dtype="float16")
    sched = amp_schedule()
    opt = AdamW(learning_rate=sched, parameters=model.parameters(),
                multi_precision=True, fused=True,
                grad_clip=paddle.nn.ClipGradByGlobalNorm(AMP_RECIPE["clip"]))
    scaler = amp.GradScaler(**dict(dict(
        init_loss_scaling=AMP_RECIPE["init_loss_scaling"]), **scaler_kw))
    return model, opt, sched, scaler


def amp_step(model, opt, sched, scaler, ids, level="O2"):
    """One step of the recipe; returns the (unscaled) loss, the learning
    rate the step used and whether the scaler skipped it (the scale
    backed off)."""
    lr_used = opt.get_lr()
    scale = scaler.get_loss_scaling()
    with amp.auto_cast(level=level, dtype="float16"):
        _, loss = model(ids, labels=ids)
    scaler.scale(loss).backward()
    scaler.step(opt)
    scaler.update()
    opt.clear_grad()
    sched.step()
    return loss.detach(), lr_used, scaler.get_loss_scaling() < scale


def opt_tensors(opt):
    """Bitwise copies of every parameter, master, m and v the optimizer
    holds."""
    out = []
    for p in opt._parameter_list():
        out.append(p.detach().clone())
        st = opt._states.get(id(p), {})
        inner = st.get("inner", st)
        out += [t.detach().clone() for t in (st.get("master"),
                                             inner.get("m"), inner.get("v"))
                if t is not None]
    return out


AMP_GROUPS = (("flash", ("flash_",)), ("adamw_step", ("adamw_step",)),
              ("gemm", ("gemm", "cutlass", "xmma", "sm90_xmma", "nvjet",
                        "cublas")),
              ("layer_norm", ("layer_norm", "layernorm")))


def amp_train(smi, bf16_bench):
    """Phase 19 (a): the bench GPT at full width and depth in float16 O2
    with the recipe, 1 warm-up, 5 timed and 1 traced step. Late in a long
    run the profiler has been seen to drop records (see device_ms), so
    each traced window starts with ``prime_f16_flash``; a traced step
    whose f16 flash kernels the trace does not show 24 times each is
    followed by another traced step, up to three; where none shows all
    24, ``amp_short_window``'s count must be exact."""
    T = TRAIN
    model, opt, sched, scaler = amp_setup(T["layers"], "cuda")
    n_params = model.num_params()
    ids = batches(9, T["batch"], "cuda")
    want_lr = amp_schedule()
    reset_counts()
    reset_dtype_counts()
    torch.cuda.synchronize()
    steps, times, windows, primers = [], [], [], []
    prof = None
    for i, b in enumerate(ids):
        traced = i >= 6
        if traced and windows and all(c == T["layers"]
                                      for c in windows[-1].values()):
            break
        adamw_before = adamw_step.launches
        t0 = time.perf_counter()
        if traced:
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                # first records for the window before the step's own
                torch.ones(1, device="cuda").add_(1)
                prime_f16_flash()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, lr_used, skipped = amp_step(model, opt, sched, scaler,
                                                  b)
                torch.cuda.synchronize()
            windows.append(f16_kernel_records(prof))
            primers.append(f16_kernel_records(prof, AMP_F16_PRIMER))
            flash_keys = {e.key[:90]: e.count for e in prof.key_averages()
                          if "flash" in e.key}
        else:
            loss, lr_used, skipped = amp_step(model, opt, sched, scaler, b)
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if 0 < i < 6:
            times.append(dt)
        steps.append(dict(loss=float(loss), lr=lr_used, want_lr=want_lr(),
                          skipped=skipped, scale=scaler.get_loss_scaling(),
                          adamw_launches=adamw_step.launches - adamw_before))
        want_lr.step()
    f16 = f16_counts()
    launches = counts()
    n = len(steps)
    losses = [s["loss"] for s in steps]
    require(all(np.isfinite(losses)), f"f16 training: non-finite losses "
            f"{losses}")
    timed = losses[1:6]
    require(timed[-1] < timed[0], f"f16 training loss did not fall: "
            f"{timed}")
    for i, s in enumerate(steps):
        require(s["lr"] == s["want_lr"], f"f16 step {i}: the optimizer's "
                f"learning rate {s['lr']} is not the schedule's "
                f"{s['want_lr']}")
        require(s["adamw_launches"] == (0 if s["skipped"] else 1),
                f"f16 step {i}: {s['adamw_launches']} adamw_step launches, "
                f"skipped {s['skipped']}")
    for name in ("flash_fwd", "flash_bwd_fused"):
        require(f16[name] == n * T["layers"], f"{name}: {f16[name]} f16 "
                f"launches in {n} f16 steps, want {T['layers']} a step")
    # the launches are counted exactly by the wrappers above; by name the
    # trace must show both f16 kernels, all 24 of each in one of three
    # windows. Where the profiler holds back a record in every window
    # (seen late in the smoke: 23 forward records of 24 in three windows
    # running), all but one, and then a shorter window, one step of a
    # one-block model (traced on every run), must show each exactly once
    whole = all(c == T["layers"] for c in windows[-1].values())
    short, short_primer = amp_short_window()
    require(whole or (all(c >= T["layers"] - 1
                          for c in windows[-1].values())
                      and all(c == 1 for c in short.values())),
            f"the traced f16 steps' flash kernels by name: {windows}, want "
            f"{T['layers']} each in one of them (one-block window: "
            f"{short}; the primers' records {primers}, {short_primer}; "
            f"the last window's flash records {flash_keys})")
    skipped = sum(s["skipped"] for s in steps)
    step_s = statistics.mean(times)
    tok_s = T["batch"] * T["seq"] / step_s
    flops_per_token = 6 * n_params + 12 * T["layers"] * T["seq"] * \
        T["hidden"]
    profile = step_profile(prof, None, step_s * 1e3)
    bench = dict(metric="gpt_lm_train_tokens_per_sec", dtype="float16 O2",
                 value=tok_s, unit="tokens/s", step_time_s=step_s,
                 mfu_vs_chip_peak=tok_s * flops_per_token /
                 PEAK_OPS[torch.float16], model_params_m=n_params / 1e6,
                 device=torch.cuda.get_device_name(0), nvidia_smi=smi,
                 loss=timed[-1], loss_scale=scaler.get_loss_scaling(),
                 skipped_steps=skipped)
    run = dict(bench=bench, bf16_phase5=bf16_bench, steps=steps,
               step_times_s=times, f16_launches=f16,
               traced_f16_kernels=windows, traced_window_whole=whole,
               traced_primer_records=primers,
               traced_one_block_window=short,
               traced_one_block_primer_records=short_primer,
               traced_flash_keys=flash_keys,
               step_profile=profile,
               device_ms_by_group=device_groups(prof, AMP_GROUPS),
               adamw_step_launches=launches["adamw_step"])
    del model, opt
    torch.cuda.empty_cache()
    return run, launches


def f16_kernel_records(prof, kernels=AMP_F16_KERNELS):
    """Each f16 flash kernel's records by name in a profiler window."""
    keys = {e.key: e.count for e in prof.key_averages()}
    return {n: sum(c for k, c in keys.items() if any(p in k for p in pats))
            for n, pats in kernels.items()}


def prime_f16_flash():
    """One launch of each f16 flash kernel at head dim 128 (B1 H1 S128),
    made inside a profiler window before the step it traces; the counts
    are left as they were. A run has lost the first record of the f16
    forward in every window, and that one only (23 of 24 in three
    windows, 0 of 1 in the one-block window, every backward record
    there): the primer's records, which ``AMP_F16_KERNELS`` does not
    match, go first."""
    saved = ([(k["counter"], k["counter"].launches,
               dict(getattr(k["counter"], "route_launches", {})))
              for k in KERNELS.values()],
             [(fn, dict(fn.dtype_launches)) for fn in DTYPE_COUNTED])
    gen = torch.Generator(device="cuda").manual_seed(24)
    q, k, v, do = (torch.randn(1, 1, 128, 128, device="cuda", generator=gen,
                               dtype=torch.float16) for _ in range(4))
    o, lse = flash_fwd(q, k, v)
    delta = (o.float() * do.float()).sum(-1)
    flash_bwd_fused(q, k, v, do, lse, delta, 128 ** -0.5, False)
    for counter, n, routes in saved[0]:
        counter.launches = n
        for route, c in routes.items():
            counter.route_launches[route] = c
    for fn, by_dtype in saved[1]:
        fn.dtype_launches.update(by_dtype)


def amp_short_window():
    """One traced step of the recipe on a one-block model at the
    training batch and length, after an untraced one: each f16 flash
    kernel's records by name (one each when the trace is whole), and the
    primer's."""
    T = TRAIN
    model, opt, sched, scaler = amp_setup(1, "cuda", seed=5)
    ids = batches(2, T["batch"], "cuda")
    amp_step(model, opt, sched, scaler, ids[0])
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        prime_f16_flash()
        torch.cuda.synchronize()
        amp_step(model, opt, sched, scaler, ids[1])
        torch.cuda.synchronize()
    del model, opt
    torch.cuda.empty_cache()
    return (f16_kernel_records(prof),
            f16_kernel_records(prof, AMP_F16_PRIMER))


def amp_overflow_and_resume():
    """Phase 19 (b) at 2 layers: a step at a loss scale of 2**60 is
    skipped and changes nothing, bitwise, launches no adamw_step and
    halves the scale; forced overflows raise ScaleSaturationError after
    ``max_consecutive_skips``; and a run saved after 3 steps, loaded into
    fresh objects, takes 2 more steps bitwise equal to the uninterrupted
    run's."""
    import tempfile
    R = AMP_RESUME
    out = {}
    ids = [b[:, :R["seq"]].contiguous()
           for b in batches(5, R["batch"], "cuda")]
    model, opt, sched, scaler = amp_setup(R["layers"], "cuda", seed=3,
                                          seq=R["seq"])
    amp_step(model, opt, sched, scaler, ids[0])
    before = opt_tensors(opt)
    launches_before = adamw_step.launches
    scaler.set_init_loss_scaling(2.0 ** 60)
    _, _, skipped = amp_step(model, opt, sched, scaler, ids[1])
    torch.cuda.synchronize()
    after = opt_tensors(opt)
    out["overflow"] = dict(
        skipped=skipped, unchanged=len(before) == len(after) and all(
            torch.equal(a, b) for a, b in zip(before, after)),
        tensors=len(before),
        adamw_launches=adamw_step.launches - launches_before,
        scale_after=scaler.get_loss_scaling())
    require(skipped and out["overflow"]["unchanged"]
            and out["overflow"]["adamw_launches"] == 0
            and scaler.get_loss_scaling() == 2.0 ** 59,
            f"the overflowing f16 step: {out['overflow']}")
    sat = amp.GradScaler(init_loss_scaling=2.0 ** 60,
                         max_consecutive_skips=3)
    raised_at = None
    for i in range(5):
        with amp.auto_cast(level="O2", dtype="float16"):
            _, loss = model(ids[2], labels=ids[2])
        sat.scale(loss).backward()
        sat.step(opt)
        opt.clear_grad()
        try:
            sat.update()
        except amp.ScaleSaturationError:
            raised_at = i
            break
    out["saturation_raised_at_update"] = raised_at
    require(raised_at == 2, f"ScaleSaturationError after {raised_at} "
            f"updates, want the 3rd")
    del model, opt, sat
    torch.cuda.empty_cache()

    # resume: 3 steps, save, then 2 steps two ways
    model, opt, sched, scaler = amp_setup(R["layers"], "cuda", seed=4,
                                          seq=R["seq"])
    for b in ids[:3]:
        amp_step(model, opt, sched, scaler, b)
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as d:
        paths = {k: os.path.join(d, k) for k in ("model.pdparams",
                                                 "opt.pdopt",
                                                 "scaler.pdscaler")}
        paddle.save(model.state_dict(), paths["model.pdparams"])
        paddle.save(opt.state_dict(), paths["opt.pdopt"])
        paddle.save(scaler.state_dict(), paths["scaler.pdscaler"])
        m2, o2, s2, sc2 = amp_setup(R["layers"], "cuda", seed=5,
                                    seq=R["seq"])
        m2.load_state_dict(paddle.load(paths["model.pdparams"]))
        o2.set_state_dict(paddle.load(paths["opt.pdopt"]))
        sc2.load_state_dict(paddle.load(paths["scaler.pdscaler"]))
    for b in ids[3:]:
        la = amp_step(model, opt, sched, scaler, b)[0]
        lb = amp_step(m2, o2, s2, sc2, b)[0]
        require(torch.equal(la, lb), f"resumed f16 loss {lb.item()} != "
                f"uninterrupted {la.item()}")
    a, b = opt_tensors(opt), opt_tensors(o2)
    out["resume"] = dict(tensors=len(a), bitwise=len(a) == len(b) and all(
        torch.equal(x, y) for x, y in zip(a, b)),
        lr=(opt.get_lr(), o2.get_lr()),
        scale=(scaler.get_loss_scaling(), sc2.get_loss_scaling()))
    require(out["resume"]["bitwise"] and o2.get_lr() == opt.get_lr()
            and sc2.state_dict() == scaler.state_dict(),
            f"the resumed f16 run differs from the uninterrupted one: "
            f"{out['resume']}")
    del model, opt, m2, o2
    torch.cuda.empty_cache()
    return out


def amp_o1_vs_cpu():
    """Phase 19 (c): f32 parameters under ``auto_cast(O1, float16)`` at 2
    layers, batch 2, seq 256 on the card and on the CPU: loss and
    gradients against the CPU's, the f16 flash kernels launched, white
    ops' outputs f16 and black ops' f32 (the cast mechanism's record);
    then the same with ``custom_black_list={"flash_attention"}``
    launches the f32 kernel."""
    R = AMP_O1
    model, _, _, _ = amp_setup(R["layers"], "cuda", seed=6, seq=R["seq"],
                               o2=False)
    cpu = copy.deepcopy(model).cpu()
    ids = batches(1, R["batch"], "cpu")[0][:, :R["seq"]].contiguous()
    out = {}
    reset_dtype_counts()
    before32 = flash_fwd.dtype_launches[torch.float32]
    grads, secs = [], []
    for m, x in ((model, ids.cuda()), (cpu, ids)):
        t0 = time.perf_counter()
        with amp.auto_cast(level="O1", dtype="float16"):
            with amp.record_casts() as rec:
                _, loss = m(x, labels=x)
        loss.backward()
        grads.append(([p.grad.detach().float().cpu()
                       for p in m.parameters()], loss.item(), rec))
        secs.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    out["forward_backward_s"] = dict(card=secs[0], cpu=secs[1])
    (gc, lc, rec_c), (gh, lh, rec_h) = grads
    f16 = f16_counts()
    rel = abs(lc - lh) / abs(lh)
    gerr = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
               for a, b in zip(gc, gh))
    white = sorted({(n, str(d)) for n, dts in rec_c for d in dts
                    if n in amp.amp_lists.WHITE_LIST})
    black = sorted({(n, str(d)) for n, dts in rec_c for d in dts
                    if n in amp.amp_lists.BLACK_LIST})
    out.update(loss_card=lc, loss_cpu=lh, loss_rel_err=rel,
               grad_rel_err=gerr, white_ops=white, black_ops=black,
               f16_launches=f16, same_record=[r[0] for r in rec_c] ==
               [r[0] for r in rec_h])
    require(rel <= 4 * F16_STEP and gerr <= 8 * F16_STEP,
            f"O1 f16 card vs CPU: loss {rel}, gradients {gerr} (limits "
            f"{4 * F16_STEP}, {8 * F16_STEP})")
    require(f16["flash_fwd"] == R["layers"] and
            f16["flash_bwd_fused"] == R["layers"],
            f"O1: the f16 flash kernels' launches {f16}")
    require(white and all(d == "torch.float16" for _, d in white) and
            black and all(d == "torch.float32" for _, d in black),
            f"O1 casts: white {white}, black {black}")
    require(out["same_record"], "O1: the card and the CPU cast other ops")
    opt_free = copy.deepcopy(model)
    with amp.auto_cast(level="O1", dtype="float16",
                       custom_black_list={"flash_attention"}):
        opt_free(ids.cuda(), labels=ids.cuda())
    torch.cuda.synchronize()
    out["black_flash_f32_launches"] = \
        flash_fwd.dtype_launches[torch.float32] - before32
    require(out["black_flash_f32_launches"] == R["layers"],
            f"custom_black_list={{'flash_attention'}}: "
            f"{out['black_flash_f32_launches']} f32 flash launches")
    del model, cpu, opt_free
    torch.cuda.empty_cache()
    return out


def amp_varlen():
    """Phase 19 (d): phase 13's packed two-layer stack in O2 float16 with
    a GradScaler, 3 steps: finite losses, the f16 varlen forward and
    fused backward twice a step each."""
    V = VARLEN_TRAIN
    torch.manual_seed(0)
    model = PackedModel(V["hidden"], V["heads"], V["layers"]).to("cuda")
    model = amp.decorate(model, level="O2", dtype="float16")
    opt = AdamW(1e-4, parameters=model.parameters(), multi_precision=True,
                fused=True)
    scaler = amp.GradScaler(init_loss_scaling=AMP_RECIPE[
        "init_loss_scaling"])
    data = varlen_batches(3, "cuda", seed=1)
    reset_dtype_counts()
    losses = []
    for x, y, cu, max_len in data:
        with amp.auto_cast(level="O2", dtype="float16"):
            out = model(x, cu, max_len)
        loss = ((out.float() - y) ** 2).mean()
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        losses.append(loss.item())
    torch.cuda.synchronize()
    f16 = f16_counts()
    rec = dict(losses=losses, f16_launches=f16,
               tokens=[int(d[2][-1]) for d in data],
               scale=scaler.get_loss_scaling())
    require(all(np.isfinite(losses)), f"f16 varlen losses {losses}")
    for name in ("flash_varlen_fwd", "flash_varlen_bwd_fused"):
        require(f16[name] == 3 * V["layers"], f"{name}: {f16[name]} f16 "
                f"launches in 3 steps, want {V['layers']} a step")
    del model, opt
    torch.cuda.empty_cache()
    return rec


# optimizer -> (learning rate, extra arguments), phase 19 (f); Adagrad
# starts its accumulator at 0.1 here, and from 0 (its default) in
# adagrad_default_vs_cpu
AMP_OPTS = {"SGD": (0.05, {}), "Momentum": (0.05, dict(momentum=0.8)),
            "Adam": (0.01, {}), "AdamW": (0.01, {}), "Adamax": (0.01, {}),
            "Adagrad": (0.05, dict(initial_accumulator_value=0.1)),
            "Adadelta": (0.5, {}),
            "RMSProp": (0.01, dict(momentum=0.5, centered=True)),
            "Lamb": (0.01, {}), "Lion": (0.003, {}), "NAdam": (0.01, {}),
            "RAdam": (0.01, {}), "ASGD": (0.05, dict(batch_num=2)),
            "Rprop": (0.01, {})}
# Adagrad from a zero accumulator: its first update is
# lr * g / (|g| + eps), which swings from 0 to lr across |g| ~ eps =
# 1e-6, and later ones g_t / sqrt(sum g^2) swing as much where every g
# so far was small, so a gradient a rounding apart on the two devices
# (the clip's norm summed in another order, the L2 decay of a bf16
# parameter a step apart) can move such an element by up to lr. The
# default run is held on the elements whose update gradient stays at
# ADAGRAD_G_MIN (100 eps) or more on every step of both devices; the
# rest are reported by band
ADAGRAD_G_MIN = 1e-4
ADAGRAD_BANDS = (0.0, 1e-5, 1e-4, 1e-3)


def opt_run(cls, lr, extra, dtype, dev, host, grads, sig, record=None):
    """``cls`` for ``len(grads)`` steps on copies of ``host`` in ``dtype``
    on ``dev``, with a global-norm clip and an L2Decay (where it takes
    one) and masters for bf16 (where it takes them); ``record(i, g)``
    sees each tensor's update gradient (clip and decay applied) a step.
    Returns the parameters, then the masters, on the CPU."""
    ps = [torch.nn.Parameter(t.to(device=dev, dtype=dtype, copy=True))
          for t in host]
    kw = dict(extra, grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    if "weight_decay" in sig:
        kw["weight_decay"] = paddle.regularizer.L2Decay(0.01)
    if "multi_precision" in sig and dtype != torch.float32:
        kw["multi_precision"] = True
    o = cls(learning_rate=lr, parameters=ps, **kw)
    if record is not None:
        # the generic update visits the tensors in order, once a step
        calls = iter(range(len(grads) * len(ps)))
        update_one = o._update_one

        def spy(param, grad, state, lr_, step):
            record(next(calls) % len(ps), grad)
            return update_one(param, grad, state, lr_, step)
        o._update_one = spy
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = g.to(device=dev, dtype=dtype)
        o.step()
    st = [o._states[id(p)].get("master") for p in ps]
    return ([p.detach().cpu() for p in ps]
            + [m.cpu() for m in st if m is not None])


def adagrad_default_vs_cpu(host, grads, sig):
    """Adagrad from its default zero accumulator, card against CPU, f32
    and bf16, as ``amp_optimizers_vs_cpu`` runs it: each element's
    smallest update gradient over the steps and both devices, the share
    of elements below 1e-5 (10 eps), the error by band of that gradient
    (``ADAGRAD_BANDS``), the smallest gradient of the worst element, and
    the share of the parameters apart after the first step. Held: every
    element in f32, the elements at ``ADAGRAD_G_MIN`` or above in bf16."""
    import paddle2_tpu_torch.optimizer as topt
    out, bad = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        mins = {}

        def record(i, g):
            g = g.detach().float().abs().cpu()
            mins[i] = g if i not in mins else torch.minimum(mins[i], g)
        first = [opt_run(topt.Adagrad, 0.05, {}, dtype, dev, host,
                         grads[:1], sig) for dev in ("cuda", "cpu")]
        finals = [opt_run(topt.Adagrad, 0.05, {}, dtype, dev, host, grads,
                          sig, record) for dev in ("cuda", "cpu")]
        limit = 1e-5 if dtype == torch.float32 else 3 * 2 ** -8
        bands = {f">={lo:g}": 0.0 for lo in ADAGRAD_BANDS}
        small = n = 0
        worst, worst_g, held, held_n = 0.0, None, 0.0, 0
        for i, (a, b) in enumerate(zip(*finals)):
            d = (a.float() - b.float()).abs() / \
                b.float().abs().max().clamp_min(1e-30)
            g = mins[i]
            n += g.numel()
            small += int((g < 1e-5).sum())
            for lo, hi in zip(ADAGRAD_BANDS, ADAGRAD_BANDS[1:] + (np.inf,)):
                m = (g >= lo) & (g < hi)
                if m.any():
                    key = f">={lo:g}"
                    bands[key] = max(bands[key], d[m].max().item())
            if d.max().item() > worst:
                worst = d.max().item()
                worst_g = g.flatten()[d.argmax()].item()
            keep = g >= (0.0 if dtype == torch.float32 else ADAGRAD_G_MIN)
            held_n += int(keep.sum())
            if keep.any():
                held = max(held, d[keep].max().item())
        apart = sum(int((a != b).sum()) for a, b in zip(*first)) / n
        name = f"Adagrad default {dname(dtype)}"
        out[name] = dict(err=worst, held_err=held, limit=limit,
                         held_share=held_n / n, small_share=small / n,
                         err_by_min_grad=bands, worst_min_grad=worst_g,
                         apart_after_step1=apart)
        if held > limit:
            bad.append(f"{name}: {held} > {limit} on the elements held")
    return out, bad


def amp_optimizers_vs_cpu():
    """Phase 19 (f): each optimizer for 3 steps on the incubate stack's
    leaves (phase 15's widths), with an L2Decay (where it takes one) and a
    global-norm clip, on the card and on the CPU from the same
    parameters and gradients, f32 and bf16 (``multi_precision=True``
    where the constructor takes it); Adagrad also from its default
    accumulator (``adagrad_default_vs_cpu``); LBFGS on a quadratic with a
    closure. f32 tensors (parameters, masters) to 1e-5 of each one's
    largest magnitude; a bf16 parameter to one bf16 step (2**-8) of its
    largest magnitude a step, three in all (without a master every op of
    the update rounds to bf16 on each device, and the card's bf16 sqrt
    and division may round to the other neighbour); Lion's bf16 sign
    flips as in tests/test_torch_optimizers_all.py."""
    import inspect
    import paddle2_tpu_torch.optimizer as topt
    host = stack_params(STACK_CHECK, seed=19)
    rng = np.random.default_rng(19)
    grads = [[torch.from_numpy((rng.standard_normal(tuple(t.shape)) * 0.05)
                               .astype(np.float32)) for t in host]
             for _ in range(3)]
    worst, bad = {}, []
    for name, (lr, extra) in AMP_OPTS.items():
        cls = getattr(topt, name)
        sig = inspect.signature(cls.__init__).parameters
        for dtype in (torch.float32, torch.bfloat16):
            finals = [opt_run(cls, lr, extra, dtype, dev, host, grads, sig)
                      for dev in ("cuda", "cpu")]
            errs = []
            for a, b in zip(*finals):
                d = (a.float() - b.float()).abs()
                scale = b.float().abs().max().clamp_min(1e-30)
                if a.dtype == torch.float32:
                    errs.append((d.max() / scale).item())
                    if errs[-1] > 1e-5:
                        bad.append(f"{name} f32 tensor: {errs[-1]} > 1e-5")
                elif name == "Lion":
                    off = (d > 2 ** -8 * scale).float().mean().item()
                    errs.append(off)
                    if off > 0.1 or d.max().item() > 2 * lr * 3:
                        bad.append(f"Lion bf16: {off} of the elements off, "
                                   f"largest {d.max().item()}")
                else:
                    errs.append((d.max() / scale).item())
                    if errs[-1] > 3 * 2 ** -8:
                        bad.append(f"{name} bf16: {errs[-1]} > 3 * 2**-8")
            worst[f"{name} {dname(dtype)}"] = max(errs)
    default, default_bad = adagrad_default_vs_cpu(
        host, grads, inspect.signature(topt.Adagrad.__init__).parameters)
    worst.update(default)
    bad += default_bad
    A = torch.from_numpy(rng.standard_normal((8, 5)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    w0 = torch.from_numpy(rng.standard_normal(5).astype(np.float32))
    finals = []
    for dev in ("cuda", "cpu"):
        w = torch.nn.Parameter(w0.to(dev))
        o = topt.LBFGS(learning_rate=0.05, parameters=[w], history_size=4)
        AA, bb = A.to(dev), b.to(dev)

        def closure():
            o.clear_grad()
            loss = ((AA @ w - bb) ** 2).sum()
            loss.backward()
            return loss
        for _ in range(3):
            o.step(closure)
        finals.append(w.detach().cpu())
    err = ((finals[0] - finals[1]).abs().max()
           / finals[1].abs().max()).item()
    if err > 1e-5:
        bad.append(f"LBFGS: {err} > 1e-5")
    worst["LBFGS float32"] = err
    require(not bad, f"optimizers card vs CPU: {bad}")
    return worst


def phase19(smi, bf16_bench):
    """Phase 19, "amp": (a) float16 pretraining of the bench GPT, (b)
    overflow, saturation and resume, (c) O1 against the CPU, (d) packed
    varlen in float16, (f) every optimizer against the CPU ((e), the f16
    kernels against their plain versions, is in phases 3 and 12).
    Returns the record and the main path's launches."""
    rec = {}
    rec["train"], launches = amp_train(smi, bf16_bench)
    b = rec["train"]["bench"]
    say(f"[phase 19 a] {smi}: f16 O2 tokens/s {b['value']:.1f} step "
        f"{b['step_time_s'] * 1e3:.2f} ms MFU {b['mfu_vs_chip_peak']:.4f} "
        f"(989 TFLOP/s), idle "
        f"{rec['train']['step_profile']['idle_share']:.3f}, loss scale "
        f"{b['loss_scale']}, skipped {b['skipped_steps']}; bf16 phase 5 "
        f"tokens/s {bf16_bench['value']:.1f} step "
        f"{bf16_bench['step_time_s'] * 1e3:.2f} ms MFU "
        f"{bf16_bench['mfu_vs_chip_peak']:.4f}; device ms by group "
        f"{json.dumps(rec['train']['device_ms_by_group'])}; f16 flash "
        f"records by name: {rec['train']['traced_f16_kernels']}, one-block "
        f"window {rec['train']['traced_one_block_window']}, the primers' "
        f"{rec['train']['traced_primer_records']}")
    f16 = rec["train"]["f16_launches"]
    rec["overflow_resume"] = amp_overflow_and_resume()
    say(f"[phase 19 b] {json.dumps(rec['overflow_resume'])}")
    rec["o1_vs_cpu"] = amp_o1_vs_cpu()
    say(f"[phase 19 c] {json.dumps(rec['o1_vs_cpu'])}")
    rec["varlen"] = amp_varlen()
    say(f"[phase 19 d] {json.dumps(rec['varlen'])}")
    for n, c in rec["varlen"]["f16_launches"].items():
        f16[n] += c
    rec["optimizers"] = amp_optimizers_vs_cpu()
    say(f"[phase 19 f] optimizers card vs CPU, largest error a tensor: "
        f"{json.dumps(rec['optimizers'])}")
    rec["main_path_f16_launches"] = f16
    return rec, launches


# ------------------------------------------------------------- phase 20
# the default nn.Transformer (Transformer-base of Vaswani et al. 2017:
# d_model 512, 8 heads, 6 + 6 layers, d_ff 2048, dropout 0.1) over the
# paper's shared BPE vocabulary of about 37,000 tokens; 32 pairs of 256
# source and 256 target tokens a step; NoamDecay's 4000 warm-up steps
NN_TRANSFORMER = dict(vocab=37000, batch=32, src=256, tgt=256, warmup=4000)
# the f32 check against the CPU: the same construction at 2 + 2 layers,
# dropout 0, 2 pairs of 64 + 64 tokens
NN_TRANSFORMER_F32 = dict(layers=2, batch=2, src=64, tgt=64)
# phase 20's traced step by kernel group
NN_GROUPS = (("flash", ("flash_",)),
             ("layer_norm_fwd", ("layer_norm_fwd",)),
             ("layer_norm_bwd", ("layer_norm_bwd",)),
             ("adamw_step", ("adamw_step",)),
             ("gemm", ("gemm", "cutlass", "xmma", "sm90_xmma", "nvjet",
                       "cublas")))


def sinusoid(length, d):
    """The paper's positional encodings ``[length, d]``."""
    pos = np.arange(length)[:, None]
    ang = pos / np.power(10000.0, 2 * np.arange(d // 2)[None, :] / d)
    pe = np.zeros((length, d), np.float32)
    pe[:, 0::2] = np.sin(ang)
    pe[:, 1::2] = np.cos(ang)
    return pe


class TransformerBase(paddle.nn.Layer):
    """A translation model as a user's script builds it from the port's
    public ``nn`` API: one ``nn.Embedding`` shared by source and target,
    drawn from N(0, d_model**-0.5) (``ParamAttr`` with an initializer)
    and scaled by sqrt(d_model), so its rows enter at unit scale as in
    the paper's implementations, plus sinusoidal positions and dropout;
    ``nn.Transformer`` with its defaults (``attn_dropout=0``); a head
    ``nn.Linear(d_model, vocab, bias_attr=False)``."""

    def __init__(self, vocab, dropout=0.1, **geometry):
        super().__init__()
        self.transformer = paddle.nn.Transformer(
            dropout=dropout, attn_dropout=0.0, **geometry)
        d = self.transformer.d_model
        self.emb = paddle.nn.Embedding(
            vocab, d, weight_attr=paddle.ParamAttr(
                initializer=paddle.nn.initializer.Normal(0.0, d ** -0.5)))
        self.head = paddle.nn.Linear(d, vocab, bias_attr=False)
        self.register_buffer("pe", paddle.to_tensor(sinusoid(1024, d)),
                             persistable=False)
        self._dropout = dropout

    def embed(self, ids):
        x = self.emb(ids) * math.sqrt(self.transformer.d_model)
        x = x + self.pe[:ids.shape[1]].astype(x.dtype)
        return paddle.nn.functional.dropout(x, self._dropout,
                                            training=self.training)

    def forward(self, src, tgt, tgt_mask):
        return self.head(self.transformer(self.embed(src), self.embed(tgt),
                                          tgt_mask=tgt_mask))


def nn_transformer_setup(layers, dropout, bf16, seed=20):
    """The model (weights from ``paddle.seed(seed)`` on the current
    place), ``nn.CrossEntropyLoss(label_smoothing=0.1)``, ``AdamW`` with
    the paper's betas and epsilon on ``NoamDecay(512, 4000)``,
    ``multi_precision`` and ``fused`` (one ``adamw_step`` launch a
    step), and AMP O2 bf16 when ``bf16``."""
    paddle.seed(seed)
    model = TransformerBase(NN_TRANSFORMER["vocab"], dropout,
                            num_encoder_layers=layers,
                            num_decoder_layers=layers)
    if bf16:
        model = paddle.amp.decorate(model, level="O2", dtype="bfloat16")
    sched = paddle.optimizer.lr.NoamDecay(512, NN_TRANSFORMER["warmup"])
    opt = paddle.optimizer.AdamW(
        learning_rate=sched, beta1=0.9, beta2=0.98, epsilon=1e-9,
        weight_decay=0.0, parameters=model.parameters(),
        multi_precision=True, fused=True)
    loss_fn = paddle.nn.CrossEntropyLoss(label_smoothing=0.1)
    return model, opt, sched, loss_fn


def nn_transformer_batch(batch, src, tgt, seed=20):
    """Random token ids from a seed (no data is downloaded): source,
    target input and target labels, and the causal target mask."""
    rng = np.random.default_rng(seed)
    v = NN_TRANSFORMER["vocab"]
    ids = [paddle.to_tensor(rng.integers(0, v, (batch, n)).astype(np.int32))
           for n in (src, tgt, tgt)]
    return ids + [paddle.nn.Transformer.generate_square_subsequent_mask(tgt)]


def nn_transformer_loss(model, loss_fn, src, tgt, lbl, mask):
    logits = model(src, tgt, mask)
    # the loss in f32 (the logits are bf16 under O2)
    return loss_fn(logits.reshape([-1, NN_TRANSFORMER["vocab"]])
                   .astype("float32"), lbl.reshape([-1]))


def nn_transformer_step(model, opt, sched, loss_fn, batch):
    """The eager Paddle loop: ``loss.backward(); opt.step();
    opt.clear_grad()`` and the scheduler's step. Every step reseeds, so
    each draws the same dropout masks on the same batch: the loss moves
    with the weights alone."""
    paddle.seed(21)
    loss = nn_transformer_loss(model, loss_fn, *batch)
    loss.backward()
    opt.step()
    opt.clear_grad()
    sched.step()
    return loss


def nn_transformer_bf16(smi):
    """Phase 20 (a)-(b): the default ``nn.Transformer`` trained at full
    width and depth in bf16 O2 with ``FLAGS_pallas_layer_norm`` on: 1
    warm-up step, 5 timed steps, 1 traced step. Exact launches a step:
    the flash forward 12 (6 encoder self-attention, 6 cross-attention;
    the decoder's masked self-attention takes the plain route), its
    backward 12, the LayerNorm forward and backward 30 each, one
    ``adamw_step``. The losses are finite and the 6th below the 1st.
    Returns the record, the launches and the parameters' shapes and
    dtypes."""
    cfg = NN_TRANSFORMER
    model, opt, sched, loss_fn = nn_transformer_setup(6, 0.1, bf16=True)
    n_params = sum(p.numel() for p in model.parameters())
    batch = nn_transformer_batch(cfg["batch"], cfg["src"], cfg["tgt"])
    route = bwd_route(torch.bfloat16)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [nn_transformer_step(model, opt, sched, loss_fn, batch).item()]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        loss = nn_transformer_step(model, opt, sched, loss_fn, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        losses.append(nn_transformer_step(model, opt, sched, loss_fn,
                                          batch).item())
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = counts()
    steps = 7
    require(all(np.isfinite(losses)), f"non-finite Transformer loss: "
            f"{losses}")
    require(losses[5] < losses[0], f"Transformer: the 6th step's loss "
            f"{losses[5]} is not below the 1st's {losses[0]}")
    n_ln = 2 * 6 + 3 * 6
    want = {"flash_fwd": 12, "layer_norm_fwd": n_ln, "layer_norm_bwd": n_ln,
            "adamw_step": 1}
    if route == "fused":
        want["flash_bwd_fused"] = 12
    else:
        want["flash_bwd_split_dkv"] = want["flash_bwd_split_dq"] = 12
    for n, per_step in want.items():
        require(launches[n] == steps * per_step,
                f"Transformer: {n} launched {launches[n]} times in "
                f"{steps} steps, want {per_step} a step")
    step_s = statistics.mean(times)
    tok_s = cfg["batch"] * cfg["tgt"] / step_s
    return dict(
        config=dict(cfg, d_model=512, heads=8, layers="6+6", d_ff=2048,
                    dropout=0.1, params_m=n_params / 1e6),
        device=torch.cuda.get_device_name(0), nvidia_smi=smi,
        target_tokens_per_s=tok_s, step_time_s=step_s, step_times_s=times,
        first_step_s=first_s, losses=losses, backward_route=route,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches_per_step={n: launches[n] / steps for n in KERNELS
                           if launches[n]},
        step_profile=step_profile(prof, wall_ms, step_s * 1e3),
        device_ms_by_group=device_groups(prof, NN_GROUPS)), launches, [
            (tuple(p.shape), p.dtype) for p in model.parameters()]


def rel_errs_floored(pairs):
    """``[(error, name)]``, largest first: ``|got - want|`` over each
    ``(name, got, want)`` triple, relative to ``want``'s largest
    magnitude, floored at a thousandth of the largest magnitude over
    all of them."""
    top = max(b.abs().max().item() for _, _, b in pairs)
    return sorted((((a - b).abs().max() / max(b.abs().max().item(),
                                              1e-3 * top)).item(), n)
                  for n, a, b in pairs)[::-1]


def nn_transformer_f32_vs_cpu():
    """Phase 20 (c): the same construction at full width with 2 + 2
    layers, dropout 0, in f32 with the LayerNorm flag on: one step on
    the card (the kernels) and the same step on the CPU (their plain
    versions) from the same weights and ids; each kernel of the path
    launched. The loss to 1e-4, every gradient to 1e-4 of its largest
    magnitude, floored at a thousandth of the model's largest (the key
    projections' biases have a zero gradient but for rounding: softmax
    ignores a shift shared by a query's logits).

    The AdamW update ``w_after - w_before`` to 1e-4 of the learning rate
    beyond one f32 step of the weight. Adam's first step moves each
    weight by ``lr * g / (|g| + eps)``, so the sign of the gradient sets
    it: where the CPU's gradient lies within the gradient check's limit
    (rounding noise, which either device may give either sign) the update
    is held only to Adam's bound, ``|update| <= lr`` beyond that step, and
    those elements are counted."""
    c = NN_TRANSFORMER_F32
    model, opt, sched, loss_fn = nn_transformer_setup(c["layers"], 0.0,
                                                      bf16=False, seed=22)
    cpu = copy.deepcopy(model).cpu()
    cpu_opt = paddle.optimizer.AdamW(
        learning_rate=paddle.optimizer.lr.NoamDecay(512, 4000), beta1=0.9,
        beta2=0.98, epsilon=1e-9, weight_decay=0.0,
        parameters=cpu.parameters(), multi_precision=True, fused=True)
    batch = nn_transformer_batch(c["batch"], c["src"], c["tgt"], seed=22)
    route = bwd_route(torch.float32)
    reset_counts()
    losses = []
    for m, b in ((model, batch), (cpu, [t.cpu() for t in batch])):
        loss = nn_transformer_loss(m, loss_fn, *b)
        loss.backward()
        losses.append(loss.item())
    torch.cuda.synchronize()
    grads = [(n, p.grad.cpu(), q.grad) for (n, p), q in zip(
        model.named_parameters(), cpu.parameters())]
    before = [q.detach().clone() for q in cpu.parameters()]
    lr = opt.get_lr()
    require(cpu_opt.get_lr() == lr, f"Transformer f32: the learning rates "
            f"differ: {lr} on the card, {cpu_opt.get_lr()} on the CPU")
    opt.step()
    cpu_opt.step()
    torch.cuda.synchronize()
    launches = counts()
    loss_err = abs(losses[0] - losses[1]) / abs(losses[1])
    grad_errs = rel_errs_floored(grads)
    grad_err, grad_worst = grad_errs[0]
    upd = adamw_update_errs(grads, before, [p.detach().cpu() for p in
                                            model.parameters()],
                            [q.detach() for q in cpu.parameters()], lr)
    require(loss_err <= 1e-4, f"Transformer f32 loss, card vs CPU: "
            f"{losses}")
    require(grad_err <= 1e-4, f"Transformer f32 gradients, card vs CPU: "
            f"{grad_err} > 1e-4 of the largest magnitude ({grad_worst})")
    require(upd["update_err"] <= 1e-4, f"Transformer f32 AdamW update, "
            f"card vs CPU: {upd['update_err']} of lr {lr} > 1e-4 beyond one "
            f"f32 step of the weight ({upd['update_worst']})")
    require(upd["noise_update_over_lr"] <= 1 + 1e-4, f"Transformer f32 "
            f"AdamW: an element whose gradient is rounding noise moved "
            f"{upd['noise_update_over_lr']} of lr {lr} "
            f"({upd['noise_worst']})")
    kernels = (("flash_bwd_fused",) if route == "fused" else
               ("flash_bwd_split_dkv", "flash_bwd_split_dq"))
    for n in ("flash_fwd", "layer_norm_fwd", "layer_norm_bwd",
              "adamw_step") + kernels:
        require(launches[n] > 0, f"{n} was not launched by the "
                f"Transformer f32 run")
    for n in ("flash_fwd",) + kernels:
        require(launches.get(F32_TC_ROW.get(n), launches[n]) == launches[n],
                f"Transformer f32: {n}: {launches[n]} launches, "
                f"{launches.get(F32_TC_ROW.get(n))} of them its "
                f"tensor-core kernel's")
    return dict(losses=losses, loss_rel_err=loss_err, grad_rel_err=grad_err,
                grad_worst=grad_worst, grad_rel_err_top=grad_errs[:6],
                lr=lr, **upd, backward_route=route,
                launches={n: v for n, v in launches.items() if v}), launches


def adamw_update_errs(grads, before, card, cpu, lr):
    """The AdamW first step's update on the card against the CPU's,
    element by element, in units of ``lr``: ``|d_card - d_cpu|`` less one
    f32 step of the weight (the update is rounded into it), where the
    CPU's gradient is past the gradient check's limit (1e-4 of the
    tensor's largest magnitude, floored at a thousandth of the model's
    largest: ``rel_errs_floored``'s); ``|d_card|`` less that step where
    it is within it. ``grads`` holds ``(name, card gradient, CPU
    gradient)``."""
    top = max(g.abs().max().item() for _, _, g in grads)
    err, worst, noise, noise_worst = 0.0, None, 0.0, None
    n_held = n_noise = n_differ = 0
    for (name, _, g), w0, wc, wr in zip(grads, before, card, cpu):
        dc = wc.double() - w0.double()
        dr = wr.double() - w0.double()
        _, e = torch.frexp(torch.maximum(w0.abs(), wr.abs()))
        ulp = torch.ldexp(torch.ones_like(dc), e.long() - 24)
        held = g.abs() > 1e-4 * max(g.abs().max().item(), 1e-3 * top)
        n_held += int(held.sum())
        n_noise += int((~held).sum())
        n_differ += int((dc != dr).sum())
        if held.any():
            e_held = (((dc - dr).abs() - ulp).clamp_min(0)[held].max()
                      / lr).item()
            if e_held >= err:
                err, worst = e_held, name
        if (~held).any():
            e_noise = ((dc.abs() - ulp).clamp_min(0)[~held].max()
                       / lr).item()
            if e_noise >= noise:
                noise, noise_worst = e_noise, name
    return dict(update_err=err, update_worst=worst,
                update_elements_held=n_held, noise_elements=n_noise,
                noise_update_over_lr=noise, noise_worst=noise_worst,
                update_elements_differing=n_differ)


def nn_transformer_kernels(leaves, gen, dev):
    """Phase 20's kernels against their plain versions at the shapes its
    main path gives them: the flash forward and its backward route in
    bf16 at B32 H8 S256 D64 without a mask (the encoder's self-attention
    and the decoder's cross-attention, source and target 256), the
    LayerNorm forward and backward at 32 x 256 rows of 512 (bf16 x, f32
    gamma and beta under O2), the fused AdamW over the model's leaves in
    their O2 dtypes; and (c)'s f32 shapes (B2 H8 S64 D64, 128 rows).
    Their launches count in no phase's gates."""
    cfg, c = NN_TRANSFORMER, NN_TRANSFORMER_F32
    rows = []
    for dtype, B, S in ((torch.bfloat16, cfg["batch"], cfg["src"]),
                        (torch.float32, c["batch"], c["src"])):
        rows.append(check_flash_ragged(dtype, B, 8, S, S, 64, False, gen,
                                       dev))
        rows += check_flash_bwd(dtype, B, 8, S, S, 64, gen, dev, timed=False,
                                routes=(bwd_route(dtype),), causal=False)
        rows += check_layer_norm(B * S, 512, dtype, torch.float32,
                                 "Transformer-base", gen, dev, timed=False)
        torch.cuda.empty_cache()
    rows += check_adamw(leaves, gen, dev, timed=False)
    torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def on_card(**flag_values):
    """The block runs on ``paddle.set_device("gpu")`` with the flags
    given; the place and the flags' earlier values come back after it."""
    before_place = paddle.get_device()
    before = flags.get_flags(list(flag_values))
    paddle.set_device("gpu")
    flags.set_flags(flag_values)
    try:
        yield
    finally:
        flags.set_flags(before)
        paddle.set_device(before_place)


def phase20(smi):
    """Phase 20, "nn": the ``paddle.nn`` layer surface on the default
    ``nn.Transformer`` (Transformer-base): (a)-(b) bf16 O2 training at
    full width and depth, (c) an f32 step against the CPU, then the
    path's kernels against their plain versions at its shapes. Returns
    the record and the main path's launches ((a)-(b)'s)."""
    with on_card(pallas_layer_norm=True):
        rec, launches, leaves = nn_transformer_bf16(smi)
        p = rec["step_profile"]
        say(f"[phase 20 a-b] {smi}: Transformer-base bf16 O2 target "
            f"tokens/s {rec['target_tokens_per_s']:.1f} step "
            f"{rec['step_time_s'] * 1e3:.2f} ms device {p['device_ms']:.2f}"
            f" ms idle {p['idle_share']:.3f} losses {rec['losses']} "
            f"launches a step {json.dumps(rec['launches_per_step'])} by "
            f"group {json.dumps(rec['device_ms_by_group'])} top "
            f"{p['top'][:5]}")
        torch.cuda.empty_cache()
        rec["f32_vs_cpu"], _ = nn_transformer_f32_vs_cpu()
        say(f"[phase 20 c] {json.dumps(rec['f32_vs_cpu'])}")
        dev = torch.device("cuda:0")
        rec["kernel_checks"] = nn_transformer_kernels(
            leaves, torch.Generator(device=dev).manual_seed(20), dev)
        for r in rec["kernel_checks"]:
            say(f"[phase 20 kernel] {r['name']} {r['dtype']} {r['shape']}: "
                f"err {r.get('max_abs_err', r.get('dq_dk_dv_err'))} (tol "
                f"{r['tol']})")
    return rec, launches


# ------------------------------------------------------------- phase 21
# (d) the "medium" PTB language model of Zaremba et al. 2014
# (arXiv:1409.2329; PaddleNLP's examples/language_model/rnnlm builds the
# same): 10,000 words, 650 units, 2 LSTM layers, dropout 0.5, 35 steps
# unrolled, batch 20, gradients clipped at global norm 5. The data is
# synthetic tokens from the seed (PTB is not in the repository); the
# optimizer is AdamW (the paper's SGD has no kernel of its own here)
LSTM_LM = dict(vocab=10000, hidden=650, layers=2, dropout=0.5, steps=35,
               batch=20, clip=5.0, lr=1e-3, seed=21)
# the f32 check against the CPU at a small width, dropout off (the card
# and the CPU draw different masks)
LSTM_LM_CHECK = dict(vocab=200, hidden=64, layers=2, dropout=0.0,
                     steps=12, batch=4, clip=5.0, lr=1e-3, seed=21)
# the beam search over the trained cells: 4 sequences primed on 35
# tokens each, beam 10, at most 35 steps
BEAM = dict(batch=4, beam=10, max_step_num=35, start=0, end=1)
# where the card's and the CPU's tokens part at a step (the same
# history before it), the CPU's scores of the two candidates that part
# must be within this, relative: f32 noise (a score sums up to 35
# log-probabilities, ~-9.2 each for an LM that has learnt little)
BEAM_MARGIN = 1e-5
# (c) DenseNet-121 in f32 against the CPU
DENSENET_CHECK = dict(batch=4, size=64, classes=10)
LSTM_GROUPS = (("adamw_step", ("adamw_step",)),
               ("gemm", ("gemm", "cutlass", "xmma", "sm90_xmma", "nvjet",
                         "cublas")),
               ("reduction", ("reduce_kernel",)))
# (c) the JAX-free case tables the CPU tests hold the port to, by module
# and name: the functionals (run by run_on_devices) and the layers (run
# by run_layer_on_devices)
NN_CASE_TABLES = (("torch_nn_table_functional",
                   ("ACTIVATIONS", "COMMON", "SPATIAL", "NORM", "LOSSES",
                    "EXTRA")),
                  ("torch_nn_table_spatial_rnn",
                   ("CONV", "POOL", "VISION_OPS")))
NN_LAYER_TABLES = (("torch_nn_table_layers",
                    ("ACTIVATION_LAYERS", "COMMON_LAYERS", "NORM_LAYERS",
                     "LOSS_LAYERS")),
                   ("torch_nn_table_spatial_rnn",
                    ("CONV_LAYERS", "POOL_LAYERS", "RNN_LAYERS")))


def densenet121_bf16(smi):
    """Phase 21 (a): ``paddle.vision.models.densenet121()`` at full width
    and depth (1000 classes, 7,978,856 parameters in 364 tensors) on
    ``bench_resnet50``'s recipe: AMP O2 bf16, batch 128 at 224x224
    (``resnet_batches``), ``Momentum(0.1, 0.9, multi_precision=True)``
    with ``FLAGS_fused_optimizer_step`` on, through ``jit.train_step``:
    1 warm-up step, 5 timed steps, 1 traced step. Every loss finite;
    ``momentum_step`` exactly twice a step (364 tensors at 256 a launch)
    and no other kernel of the port. Returns the record, the launches
    and the parameters' shapes and O2 dtypes."""
    R = RESNET
    paddle.seed(0)
    with core.place_scope("gpu"):
        model = amp.decorate(densenet121(num_classes=R["classes"]),
                             level="O2", dtype="bfloat16")
    n_params = sum(p.numel() for p in model.parameters())
    leaves = [(tuple(p.shape), p.dtype) for p in model.parameters()]
    per_step = -(-len(leaves) // MAX_MOMENTUM_TENSORS)
    require(len(leaves) == 364 and per_step == 2,
            f"DenseNet-121 has {len(leaves)} parameter tensors, "
            f"{per_step} launches a step")
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
    steps = 7
    require(all(np.isfinite([warm, traced] + losses)),
            f"non-finite DenseNet-121 loss: {[warm] + losses + [traced]}")
    for n in KERNELS:
        want = per_step if n == "momentum_step" else 0
        require(launches[n] == steps * want,
                f"DenseNet-121: {n} launched {launches[n]} times in {steps} "
                f"steps, want {want} a step")
    step_s = statistics.mean(times)
    return dict(
        config=dict(batch=R["batch"], image=R["size"],
                    classes=R["classes"], params=n_params,
                    param_tensors=len(leaves)),
        device=torch.cuda.get_device_name(0), nvidia_smi=smi,
        images_per_s=R["batch"] / step_s, step_time_s=step_s,
        step_times_s=times, first_step_s=first_s, warmup_loss=warm,
        losses=losses, traced_loss=traced,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches_per_step={n: launches[n] / steps for n in KERNELS
                           if launches[n]},
        step_profile=step_profile(prof, wall_ms, step_s * 1e3),
        device_ms_by_group=device_groups(prof)), launches, leaves


def densenet121_f32_vs_cpu():
    """Phase 21 (c): ``densenet121(num_classes=10)`` in f32, 64x64, batch
    4, ``Momentum(fused=True)``: two ``train_step`` calls on the card and
    on the CPU (plain versions) from the same weights and images. In
    training mode the last dense block normalises 4 values a channel
    (2x2, batch 4) and the f32 arithmetic is chaotic: the CPU's own f32
    gradients land up to 36 % of the largest magnitude from an f64 run
    of the same model. So the gated run is in eval mode (BatchNorm on
    its running statistics; f32 against f64 reads ~1e-6): the losses to
    1e-4 relative, the first step's gradients to 1e-4 of each gradient's
    largest magnitude, ``momentum_step`` twice a step on the card. The
    training-mode run is recorded beside, card and CPU against an f64
    CPU twin, ungated."""
    C = DENSENET_CHECK
    paddle.seed(0)
    with core.place_scope("gpu"):
        model = densenet121(num_classes=C["classes"])
    data = resnet_batches(2, C["batch"], C["size"], C["classes"], "cpu")
    rec = {}
    for mode in ("eval", "train"):
        card = copy.deepcopy(model)
        cpu = copy.deepcopy(model).cpu()
        f64 = copy.deepcopy(cpu).double()
        nets = (card, cpu, f64)
        for m in nets:
            m.train() if mode == "train" else m.eval()
        steps = [resnet_step(m, fused=True) for m in nets]
        reset_counts()
        losses = [[], [], []]
        for i, (img, lbl) in enumerate(data):
            for k, (m, st) in enumerate(zip(nets, steps)):
                x = img.cuda() if k == 0 else \
                    (img.double() if k == 2 else img)
                losses[k].append(float(st(x, lbl.cuda() if k == 0
                                          else lbl)))
            if i == 0:
                grad = [max(
                    ((p.grad.cpu().double() - q.grad.double()).abs().max()
                     / q.grad.double().abs().max().clamp_min(1e-30)).item()
                    for p, q in zip(a.parameters(), b.parameters()))
                    for a, b in ((card, cpu), (cpu, f64))]
        launches = counts()
        rel = [abs(a - b) / abs(b) for a, b in zip(losses[0], losses[1])]
        rec[mode] = dict(losses_card=losses[0], losses_cpu=losses[1],
                         losses_cpu_f64=losses[2], loss_rel_err=rel,
                         grad_rel_err=grad[0],
                         cpu_f32_vs_f64_grad_rel_err=grad[1],
                         momentum_step_launches=launches["momentum_step"])
        del card, cpu, f64, nets, steps
        torch.cuda.empty_cache()
    ev = rec["eval"]
    require(max(ev["loss_rel_err"]) <= 1e-4,
            f"DenseNet-121 f32 eval-mode losses, card vs CPU: "
            f"{ev['loss_rel_err']} > 1e-4")
    require(ev["grad_rel_err"] <= 1e-4,
            f"DenseNet-121 f32 eval-mode gradients, card vs CPU: "
            f"{ev['grad_rel_err']} > 1e-4 of the largest magnitude (the "
            f"CPU's f32 against f64: {ev['cpu_f32_vs_f64_grad_rel_err']})")
    require(ev["momentum_step_launches"] == 4,
            f"DenseNet-121: momentum_step launched "
            f"{ev['momentum_step_launches']} times in 2 steps, want 2 a "
            f"step")
    return rec


def nn_tables_on_card(dev):
    """Phase 21 (c): every case of the nn tables the CPU tests hold the
    port to (the layer surface's functionals and layers, the conv, pooling,
    vision-op and recurrent ones) on ``dev`` against the same call on
    the CPU: forward, dtypes, buffers and gradients, f32 and bf16, at the
    tests' tolerances."""
    cc = core_tables()[0]
    import importlib
    rec = dict(cases=0, failures=[], max_err={})

    def run(what, fn, items):
        for item in items:
            for dt in item.dtypes:
                rec["cases"] += 1
                try:
                    err = fn(item, dt, paddle, dev)
                    key = f"{item.id} {dt}"
                    rec["max_err"][key] = err
                except Exception as e:      # gathered, then gated below
                    rec["failures"].append(
                        f"{what}: {item.id} {dt}: {type(e).__name__}: "
                        f"{str(e)[:400]}")
    for mod, names in NN_CASE_TABLES:
        m = importlib.import_module(mod)
        for name in names:
            run(f"{mod}.{name}", cc.run_on_devices, getattr(m, name))
    for mod, names in NN_LAYER_TABLES:
        m = importlib.import_module(mod)
        for name in names:
            run(f"{mod}.{name}", cc.run_layer_on_devices, getattr(m, name))
    paddle.set_device("gpu")
    return rec


class LSTMLM(paddle.nn.Layer):
    """The PTB language model of ``LSTM_LM``: embedding, dropout, a
    stacked ``nn.LSTM`` (dropout between its layers), dropout, the
    output projection."""

    def __init__(self, vocab, hidden, layers, dropout):
        super().__init__()
        self.embedding = paddle.nn.Embedding(vocab, hidden)
        self.lstm = paddle.nn.LSTM(hidden, hidden, num_layers=layers,
                                   dropout=dropout)
        self.dropout = paddle.nn.Dropout(dropout)
        self.fc = paddle.nn.Linear(hidden, vocab)

    def forward(self, ids, states=None):
        out, final = self.lstm(self.dropout(self.embedding(ids)), states)
        return self.fc(self.dropout(out)), final


class StackedCells(paddle.nn.Layer):
    """The LM's trained ``LSTMCell``s as one cell for the decoder: the
    states are one ``(h, c)`` pair a layer."""

    def __init__(self, cells):
        super().__init__()
        self.cells = paddle.nn.LayerList(cells)

    def forward(self, x, states):
        new = []
        for cell, st in zip(self.cells, states):
            x, st = cell(x, st)
            new.append(st)
        return x, tuple(new)


def lstm_lm_setup(cfg, device):
    paddle.seed(cfg["seed"])
    with core.place_scope(device):
        model = LSTMLM(cfg["vocab"], cfg["hidden"], cfg["layers"],
                       cfg["dropout"])
    opt = AdamW(cfg["lr"], parameters=model.parameters())
    return model, opt


def lstm_lm_batches(cfg, n, seed=0):
    """``n`` batches of ``[batch, steps + 1]`` synthetic tokens (inputs
    and the next-token labels)."""
    rs = np.random.RandomState(seed)
    return [torch.as_tensor(rs.randint(0, cfg["vocab"], (
        cfg["batch"], cfg["steps"] + 1)).astype(np.int64))
        for _ in range(n)]


def lstm_lm_loss(model, tokens):
    logits, _ = model(tokens[:, :-1])
    return cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         tokens[:, 1:].reshape(-1))


def lstm_lm_step(model, opt, tokens, clip):
    loss = lstm_lm_loss(model, tokens)
    loss.backward()
    paddle.nn.utils.clip_grad_norm_(model.parameters(), clip)
    opt.step()
    opt.clear_grad()
    return loss.detach()


class RecordingBeamSearch(paddle.nn.BeamSearchDecoder):
    """``BeamSearchDecoder`` that keeps, a step, the tokens, the parents
    and every candidate's score."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.record = []

    def _scores(self, logits, log_probs, finished):
        self._last = super()._scores(logits, log_probs, finished)
        return self._last

    def step(self, time, tokens, states, log_probs, finished):
        out = super().step(time, tokens, states, log_probs, finished)
        self.record.append((out[0].cpu(), out[4].cpu(), self._last.cpu()))
        return out


def lstm_lm_decode(model, prime, device):
    """``dynamic_decode`` of a ``BeamSearchDecoder`` over the model's
    two trained cells, from the states the LM leaves after ``prime``:
    the ids, the lengths and the decoder's per-step record (tokens,
    parents, top-k margins)."""
    cells = StackedCells([r.cell for r in model.lstm.rnns])
    with torch.no_grad():
        _, final = model(prime.to(device))
        dec = RecordingBeamSearch(cells, BEAM["start"], BEAM["end"],
                                  BEAM["beam"],
                                  embedding_fn=model.embedding,
                                  output_fn=model.fc)
        ids, lens = paddle.nn.dynamic_decode(
            dec, inits=tuple((h, c) for h, c in final),
            max_step_num=BEAM["max_step_num"], return_length=True)
    return ids.cpu(), lens.cpu(), dec.record


def lstm_lm_train(smi):
    """Phase 21 (d): the LSTM LM at ``LSTM_LM``'s size in f32 with
    ``FLAGS_fused_optimizer_step`` on (AdamW's step one ``adamw_step``
    launch over the 11 tensors): 1 warm-up, 5 timed and 1 traced step,
    every loss finite, ``adamw_step`` exactly once a step and no other
    kernel. Returns the record, the launches and the trained model."""
    cfg = LSTM_LM
    model, opt = lstm_lm_setup(cfg, "gpu")
    n_params = sum(p.numel() for p in model.parameters())
    leaves = [(tuple(p.shape), p.dtype) for p in model.parameters()]
    data = [b.cuda() for b in lstm_lm_batches(cfg, 7)]
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [lstm_lm_step(model, opt, data[0], cfg["clip"]).item()]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    times = []
    for b in data[1:6]:
        t0 = time.perf_counter()
        loss = lstm_lm_step(model, opt, b, cfg["clip"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        losses.append(lstm_lm_step(model, opt, data[6], cfg["clip"]).item())
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = counts()
    steps = 7
    require(all(np.isfinite(losses)), f"non-finite LSTM LM loss: {losses}")
    for n in KERNELS:
        want = 1 if n == "adamw_step" else 0
        require(launches[n] == steps * want,
                f"LSTM LM: {n} launched {launches[n]} times in {steps} "
                f"steps, want {want} a step")
    step_s = statistics.mean(times)
    return dict(
        config=dict(cfg, params=n_params, param_tensors=len(leaves)),
        device=torch.cuda.get_device_name(0), nvidia_smi=smi,
        tokens_per_s=cfg["batch"] * cfg["steps"] / step_s,
        step_time_s=step_s, step_times_s=times, first_step_s=first_s,
        losses=losses,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches_per_step={n: launches[n] / steps for n in KERNELS
                           if launches[n]},
        step_profile=step_profile(prof, wall_ms, step_s * 1e3),
        device_ms_by_group=device_groups(prof, LSTM_GROUPS)), launches, \
        model, leaves


def beam_search_vs_cpu(model):
    """Phase 21 (d): beam search over the trained LM's cells on the card
    and on a CPU copy: the ids and lengths equal, or, where a step's
    tokens or parents part, that step's top-k margin on the CPU below
    ``BEAM_MARGIN``. Each such step is recorded."""
    model.eval()
    cpu = copy.deepcopy(model).cpu()
    prime = lstm_lm_batches(dict(LSTM_LM, batch=BEAM["batch"]), 1,
                            seed=7)[0][:, :-1]
    ids, lens, rec = lstm_lm_decode(model, prime, "cuda")
    ids_c, lens_c, rec_c = lstm_lm_decode(cpu, prime, "cpu")
    parted = []
    V = LSTM_LM["vocab"]
    for t, ((tok, par, _), (tok_c, par_c, sc_c)) in enumerate(
            zip(rec, rec_c)):
        if torch.equal(tok, tok_c) and torch.equal(par, par_c):
            continue
        # the same history up to step t: each parted row's first
        # candidate that differs, scored on the CPU against the CPU's own
        flat = (par.long() * V + tok.reshape(par.shape).long())
        flat_c = (par_c.long() * V + tok_c.reshape(par_c.shape).long())
        for b in range(flat.shape[0]):
            k = (flat[b] != flat_c[b]).nonzero()
            if not len(k):
                continue
            k = int(k[0])
            mine, theirs = sc_c[b, flat[b, k]], sc_c[b, flat_c[b, k]]
            parted.append(dict(step=t, row=b, beam=k,
                               cpu_score=theirs.item(),
                               card_choice_cpu_score=mine.item(),
                               rel_margin=((theirs - mine).abs()
                                           / theirs.abs()).item()))
        break
    same = torch.equal(ids, ids_c) and torch.equal(lens, lens_c) and \
        len(rec) == len(rec_c)
    require(same or (parted and all(p["rel_margin"] < BEAM_MARGIN
                                    for p in parted)),
            f"beam search ids differ from the CPU's with no near tie: "
            f"{parted}")
    return dict(ids_equal=same, steps=len(rec), steps_cpu=len(rec_c),
                parted=parted, ids_shape=list(ids.shape),
                lengths=lens.tolist())


def lstm_lm_f32_vs_cpu():
    """Phase 21 (d): one step of the LM at ``LSTM_LM_CHECK``'s size on the
    card and on a CPU copy (plain versions): the loss to 1e-5 relative
    and every gradient to 1e-4 of its largest magnitude."""
    cfg = LSTM_LM_CHECK
    model, _ = lstm_lm_setup(cfg, "gpu")
    cpu = copy.deepcopy(model).cpu()
    tokens = lstm_lm_batches(cfg, 1)[0]
    lc = lstm_lm_loss(model, tokens.cuda())
    lc.backward()
    lh = lstm_lm_loss(cpu, tokens)
    lh.backward()
    rel = abs(lc.item() - lh.item()) / abs(lh.item())
    grad = max(((p.grad.cpu() - q.grad).abs().max()
                / q.grad.abs().max().clamp_min(1e-30)).item()
               for p, q in zip(model.parameters(), cpu.parameters()))
    require(rel <= 1e-5, f"LSTM LM f32 loss, card vs CPU: {rel} > 1e-5")
    require(grad <= 1e-4, f"LSTM LM f32 gradients, card vs CPU: {grad} > "
            f"1e-4 of the largest magnitude")
    return dict(loss_card=lc.item(), loss_cpu=lh.item(), loss_rel_err=rel,
                grad_rel_err=grad)


def vision_rnn_kernels(dense_leaves, lm_leaves, gen, dev):
    """Phase 21's kernels against their plain versions at the shapes its
    main paths give them: the fused Momentum over DenseNet-121's 364
    tensors (two launches a step; O2 dtypes as (a) trains them) and the
    fused AdamW over the LSTM LM's 11 f32 tensors, both bitwise against
    the eager chains and timed (the kernel, its plain version, and
    ``torch._fused_sgd_`` / ``torch._fused_adamw_`` over the same
    tensors). Their launches count in no phase's gates."""
    rows = [check_momentum([sh for sh, _ in dense_leaves],
                           [dt for _, dt in dense_leaves], gen, dev,
                           model="DenseNet-121")]
    torch.cuda.empty_cache()
    rows += check_adamw(lm_leaves, gen, dev)
    torch.cuda.empty_cache()
    return rows


def phase21(smi, resnet_nchw):
    """Phase 21, "vision and rnn": (a) DenseNet-121 trained at full width
    and depth through ``momentum_step``; (b) ResNet-50 as phase 10 with
    ``FLAGS_conv_prefer_channels_last`` on, beside phase 10's NCHW
    figures (``resnet_nchw``); (c) the nn case tables and an f32
    DenseNet-121 against the CPU; (d) the LSTM LM through ``adamw_step``,
    beam search against the CPU and a small f32 step against the CPU;
    then the path's kernels at its shapes. Returns the record and the
    main paths' launches ((a), (b) and (d)'s training steps)."""
    t0 = time.perf_counter()
    launches = {n: 0 for n in KERNELS}

    def add(l):
        for n, c in l.items():
            launches[n] += c
    rec = {}
    with on_card(fused_optimizer_step=True):
        rec["densenet121_bf16"], l, dense_leaves = densenet121_bf16(smi)
        add(l)
        r = rec["densenet121_bf16"]
        say(f"[phase 21 a] {smi}: DenseNet-121 bf16 O2 images/s "
            f"{r['images_per_s']:.1f} step {r['step_time_s'] * 1e3:.2f} ms "
            f"device {r['step_profile']['device_ms']:.2f} ms idle "
            f"{r['step_profile']['idle_share']:.3f} peak "
            f"{r['peak_memory_gib']:.2f} GiB losses {r['losses']} launches "
            f"a step {json.dumps(r['launches_per_step'])} by group "
            f"{json.dumps(r['device_ms_by_group'])}")
        torch.cuda.empty_cache()
    with on_card(fused_optimizer_step=True, conv_prefer_channels_last=True):
        nhwc, l = resnet50_bf16(smi)
        add(l)
    rec["resnet50_nhwc"] = nhwc
    rec["resnet50_nchw_phase10"] = dict(
        images_per_s=resnet_nchw["bench"]["value"],
        step_time_s=resnet_nchw["bench"]["step_time_s"],
        device_ms_by_group=resnet_nchw["device_ms_by_group"],
        device_ms=resnet_nchw["step_profile"]["device_ms"])
    say(f"[phase 21 b] {smi}: ResNet-50 bf16 O2 images/s NHWC "
        f"{nhwc['bench']['value']:.1f} (phase 10 NCHW "
        f"{resnet_nchw['bench']['value']:.1f}), step "
        f"{nhwc['bench']['step_time_s'] * 1e3:.2f} ms (NCHW "
        f"{resnet_nchw['bench']['step_time_s'] * 1e3:.2f} ms), device "
        f"{nhwc['step_profile']['device_ms']:.2f} ms (NCHW "
        f"{resnet_nchw['step_profile']['device_ms']:.2f} ms), by group "
        f"{json.dumps(nhwc['device_ms_by_group'])} (NCHW "
        f"{json.dumps(resnet_nchw['device_ms_by_group'])})")
    torch.cuda.empty_cache()
    with on_card():
        dev = torch.device("cuda:0")
        tables = nn_tables_on_card(dev)
        rec["tables"] = dict(cases=tables["cases"],
                             failures=tables["failures"],
                             largest_err=max(tables["max_err"].values(),
                                             default=0.0))
        say(f"[phase 21 c] nn tables on the card: {tables['cases']} cases, "
            f"{len(tables['failures'])} failures, largest output error "
            f"{rec['tables']['largest_err']:.3g}")
        for f in tables["failures"]:
            say(f"[phase 21 c] FAILED {f}")
        require(not tables["failures"], f"{len(tables['failures'])} nn "
                f"table cases differ between the card and the CPU")
        rec["densenet121_f32_vs_cpu"] = densenet121_f32_vs_cpu()
        say(f"[phase 21 c] DenseNet-121 f32 vs CPU: "
            f"{json.dumps(rec['densenet121_f32_vs_cpu'])}")
    with on_card(fused_optimizer_step=True):
        lm, l, model, lm_leaves = lstm_lm_train(smi)
        add(l)
        rec["lstm_lm"] = lm
        say(f"[phase 21 d] {smi}: LSTM LM f32 tokens/s "
            f"{lm['tokens_per_s']:.1f} step {lm['step_time_s'] * 1e3:.2f} ms "
            f"device {lm['step_profile']['device_ms']:.2f} ms idle "
            f"{lm['step_profile']['idle_share']:.3f} losses {lm['losses']} "
            f"launches a step {json.dumps(lm['launches_per_step'])} by group "
            f"{json.dumps(lm['device_ms_by_group'])}")
        rec["beam_search"] = beam_search_vs_cpu(model)
        say(f"[phase 21 d] beam search vs CPU: "
            f"{json.dumps(rec['beam_search'])}")
        del model
        rec["lstm_lm_f32_vs_cpu"] = lstm_lm_f32_vs_cpu()
        say(f"[phase 21 d] LSTM LM f32 vs CPU: "
            f"{json.dumps(rec['lstm_lm_f32_vs_cpu'])}")
        torch.cuda.empty_cache()
        rec["kernel_checks"] = vision_rnn_kernels(
            dense_leaves, lm_leaves,
            torch.Generator(device=dev).manual_seed(21), dev)
        for r in rec["kernel_checks"]:
            say(f"[phase 21 kernel] {smi}: {r['name']} {r['dtype']} "
                f"{r['shape']}: err {r['max_abs_err']} ({r['tol']}) ms "
                f"{r['ms']:.4f} kernel device {r['kernel_device_ms']} plain "
                f"{r['plain_ms']:.4f} bound {r['bound_ms']:.4f} "
                f"({r['bound_by']}) library {r['library_ms']}")
    rec["seconds"] = time.perf_counter() - t0
    say(f"[phase 21] {rec['seconds']:.1f} s")
    return rec, launches


# ------------------------------------------------------------ phase 22
REMAT_POLICIES = ("dots", "dots_plus", "dots_plus_ln", "offload", "full",
                  "search")
# 1 warm-up and 3 timed steps a policy, then 1 traced step
REMAT_STEPS = 4
# phase 5's kernel groups, and the copies to and from the host
REMAT_GROUPS = STACK_GROUPS + (("memcpy", ("memcpy",)),)
# bench.py's formula against the FLOPs the counter finds in one step
COST_MODEL_TOL = 0.05


def remat_train(gran, ids, metrics_dir=None):
    """Phase 22 (a): the bench GPT under the remat policy ``gran``,
    ``REMAT_STEPS`` steps (the first a warm-up) on the batches ``ids``,
    each step synchronised, with the metrics plane on around them when
    ``metrics_dir`` is given; then one traced step (its device time by
    kernel group and the idle share against the timed steps). Returns
    the record, the launches, and the model and step (for (c))."""
    T = TRAIN
    model, step = train_setup(T["layers"], "cuda", bf16=True,
                              granularity=gran)
    plan = model.gpt.remat_plan(T["batch"], T["seq"])
    offloaded = remat_attention.offload_to_host.bytes
    if metrics_dir is not None:
        os.environ[obs_metrics.METRICS_DIR_ENV] = metrics_dir
        obs_metrics.enable(rank=0, flush_steps=1)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    try:
        for b in ids:
            t0 = time.perf_counter()
            loss = step(b, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
    finally:
        if metrics_dir is not None:
            obs_metrics.disable()
            del os.environ[obs_metrics.METRICS_DIR_ENV]
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.mean(times[1:])
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        traced = float(step(ids[-1], ids[-1]))
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = counts()
    steps = REMAT_STEPS + 1
    require(all(np.isfinite(losses + [traced])),
            f"{gran}: non-finite losses {losses + [traced]}")
    L = T["layers"]
    want = {"flash_fwd": 2 * L if gran == "full" else L,
            "flash_bwd_fused": L, "adamw_step": 1}
    for n, per_step in want.items():
        require(launches[n] == steps * per_step,
                f"{gran}: {n} launched {launches[n]} times in {steps} "
                f"steps, want {per_step} a step")
    rec = dict(losses=losses, traced_loss=traced, step_times_s=times,
               step_time_s=step_s,
               tokens_per_s=T["batch"] * T["seq"] / step_s,
               max_memory_allocated=peak,
               step_profile=step_profile(prof, wall_ms, step_s * 1e3),
               device_ms_by_group=device_groups(prof, REMAT_GROUPS),
               launches_per_step={n: launches[n] / steps for n in want},
               offloaded_bytes=(remat_attention.offload_to_host.bytes
                                - offloaded))
    if plan is not None:
        rec["plan"] = dict(policy=plan.policy, granularity=plan.granularity,
                           fits=plan.fits, total_bytes=plan.total_bytes,
                           overhead_s=plan.overhead_s,
                           budget_bytes=plan.budget_bytes)
    return rec, launches, model, step


def finite_check_on_card(dev="cuda"):
    """Phase 22 (d): the two routes that build their own ``-inf`` pads
    and masks, under ``FLAGS_check_nan_inf`` on ``dev`` and on the CPU:
    both must return, with the CPU's values."""
    rs = np.random.RandomState(0)
    x = rs.randn(1, 2, 5, 5).astype(np.float32)
    q = rs.randn(1, 8, 2, 16).astype(np.float32)
    out = []
    flags.set_flags({"check_nan_inf": True})
    try:
        for where in (dev, "cpu"):
            tx = torch.from_numpy(x).to(where)
            tq = torch.from_numpy(q).to(where)
            pooled = paddle.nn.functional.max_pool2d(tx, 2, 2,
                                                     ceil_mode=True)
            o, sm = fa.flash_attention(tq, tq, tq, causal=True,
                                       return_softmax=True)
            out.append([t.cpu() for t in (pooled, o, sm)])
    finally:
        flags.set_flags({"check_nan_inf": False})
    errs = [float((a - b).abs().max()) for a, b in zip(*out)]
    require(tuple(out[0][0].shape) == (1, 2, 3, 3),
            f"max_pool2d(ceil_mode=True) gave {out[0][0].shape}")
    # f32 on the card: the flash forward's 3xTF32 sums (TOL) and torch's
    # own pooling and softmax
    require(max(errs) <= TOL[torch.float32],
            f"the card's values under the check differ from the CPU's: "
            f"{errs}")
    return dict(pool_shape=list(out[0][0].shape), max_abs_err=errs)


def phase22(smi):
    """Phase 22, "observability and remat": (a) the bench GPT under each
    remat policy; (b) the "dots" run through the metrics plane and
    ``tools.perf_doctor``; (c) one "dots" step priced by the cost model;
    (d) the finite check's own infinities on the card. Returns the
    record and the main path's launches (the policies' training
    steps)."""
    t_start = time.perf_counter()
    T = TRAIN
    tokens = T["batch"] * T["seq"]
    launches = {n: 0 for n in KERNELS}
    ids = batches(REMAT_STEPS, T["batch"], "cuda")
    rec = {"policies": {}}
    mdir = tempfile.mkdtemp(prefix="metrics_")
    try:
        for gran in REMAT_POLICIES:
            r, l, model, step = remat_train(
                gran, ids, metrics_dir=mdir if gran == "dots" else None)
            for n, c in l.items():
                launches[n] += c
            rec["policies"][gran] = r
            if gran == "dots":
                # (b) the stream the dots steps wrote, through the doctor
                streams = perf_doctor.load_streams(mdir)
                doc = perf_doctor.summarize(streams)
                steps = streams[0]["steps"]
                require(len(steps) == REMAT_STEPS and all(
                    s.get("tokens") == tokens for s in steps),
                    f"perf_doctor read {len(steps)} step records, tokens "
                    f"{[s.get('tokens') for s in steps]}; want "
                    f"{REMAT_STEPS} of {tokens}")
                require(doc["aggregate"]["steps"] == REMAT_STEPS - 1,
                        f"perf_doctor counts {doc['aggregate']['steps']} "
                        f"steps past its warm-up, want {REMAT_STEPS - 1}")
                rec["perf_doctor"] = dict(
                    steps=len(steps), tokens_a_step=tokens,
                    tokens_per_s=doc["aggregate"].get(
                        "tokens_per_s_total"),
                    breakdown_pct=doc["aggregate"].get("breakdown_pct"),
                    synchronised_tokens_per_s=r["tokens_per_s"])
                # (c) one more step, priced by the cost model
                n_params = model.num_params()
                cost = program_cost(step, (ids[0], ids[0]))
                bench_flops = (6 * n_params + 12 * T["layers"] * T["seq"]
                               * T["hidden"]) * tokens
                ratio = cost["flops"] / bench_flops
                rec["cost_model"] = dict(
                    flops=cost["flops"], bench_formula_flops=bench_flops,
                    ratio=ratio, flops_by_op={k: v for k, v in cost.items()
                                              if k != "flops"},
                    mfu=cost["flops"] / (r["step_time_s"] * PEAK_OPS[
                        torch.bfloat16]),
                    chip_peak=list(chip_peak()))
                require(abs(ratio - 1.0) <= COST_MODEL_TOL,
                        f"program_cost counts {cost['flops']:.4g} FLOPs a "
                        f"step, {ratio:.4f} x bench.py's formula "
                        f"(limit {COST_MODEL_TOL})")
            del model, step
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(mdir, ignore_errors=True)
    dots = rec["policies"]["dots"]["losses"]
    first = {g: r["losses"][0] for g, r in rec["policies"].items()}
    require(len(set(first.values())) == 1,
            f"step 1's loss differs across policies: {first}")
    diffs = {g: max(abs(a - b) / abs(b) for a, b in
                    zip(r["losses"][1:], dots[1:]))
             for g, r in rec["policies"].items()}
    rec["largest_rel_diff_vs_dots"] = diffs
    require(max(diffs.values()) <= 1e-2,
            f"steps 2-{REMAT_STEPS} part from dots's by {diffs}")
    require(rec["policies"]["offload"]["offloaded_bytes"] > 0,
            "offload moved no bytes into pinned host memory")
    rec["finite_check"] = finite_check_on_card()
    for g, r in rec["policies"].items():
        say(f"[phase 22 a] {smi}: {g}: tokens/s {r['tokens_per_s']:.1f} "
            f"step {r['step_time_s'] * 1e3:.2f} ms, traced step: device "
            f"{r['step_profile']['device_ms']:.2f} ms idle "
            f"{r['step_profile']['idle_share']:.3f} by group "
            f"{json.dumps(r['device_ms_by_group'])}; max_memory_allocated "
            f"{r['max_memory_allocated'] / 2 ** 30:.3f} GiB losses "
            f"{r['losses']} (largest difference from dots after step 1: "
            f"{diffs[g]:.3g}) launches a step "
            f"{json.dumps(r['launches_per_step'])}"
            + (f" offloaded {r['offloaded_bytes']} bytes to pinned host "
               f"memory" if g == "offload" else "")
            + (f" plan {json.dumps(r['plan'])}" if "plan" in r else ""))
    d = rec["perf_doctor"]
    say(f"[phase 22 b] perf_doctor: {d['steps']} steps of "
        f"{d['tokens_a_step']} tokens, tokens/s {d['tokens_per_s']} (host "
        f"clock) against {d['synchronised_tokens_per_s']:.1f} "
        f"(synchronised), breakdown {json.dumps(d['breakdown_pct'])}")
    c = rec["cost_model"]
    say(f"[phase 22 c] {smi}: program_cost {c['flops']:.6g} FLOPs a step, "
        f"{c['ratio']:.4f} x bench.py's {c['bench_formula_flops']:.6g}; MFU "
        f"{c['mfu']:.4f} of 989 TFLOP/s; by op {json.dumps(c['flops_by_op'])}")
    say(f"[phase 22 d] FLAGS_check_nan_inf on the card: "
        f"{json.dumps(rec['finite_check'])}")
    rec["seconds"] = time.perf_counter() - t_start
    say(f"[phase 22] {rec['seconds']:.1f} s")
    return rec, launches


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
            if t:
                return ident + f"<{t.group(1)}>"
            # templated on the element type and the head dim
            t = re.match(r"I(13__nv_bfloat16|6__half)Li(\d+)E",
                         mangled[at + n:])
            if t:
                kind = "bf16" if "bfloat" in t.group(1) else "f16"
                return ident + f"<{kind}, {t.group(2)}>"
            return ident
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


def sass(name):
    """The built library ``name`` and its SASS (``cuobjdump -sass``)."""
    cuobjdump = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" /
        "cuobjdump")
    lib = _build._lib_path(_build.sources()[name])
    return lib, subprocess.run([cuobjdump, "-sass", str(lib)],
                               capture_output=True, text=True, check=True,
                               timeout=120).stdout


# the flash libraries instantiated for f16 as well as bf16
F16_WGMMA_LIBRARIES = ("flash_fwd_wgmma", "flash_bwd_wgmma",
                       "flash_varlen_wgmma", "flash_varlen_bwd_wgmma")


def sass_functions(sass_text):
    """``cuobjdump -sass`` output split by function: mangled name -> its
    lines."""
    out, name = {}, None
    for line in sass_text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return out


def hgmma_types(sass_text):
    """Each element type's kernels in a flash library and their HGMMA
    instructions' operand types (the suffix after ``.F32``: ``BF16``, or
    none for f16, SASS's default): {"bf16"|"f16": {suffixes}}, from the
    kernels' mangled names (``13__nv_bfloat16`` / ``6__half``)."""
    out = {}
    for fn, lines in sass_functions(sass_text).items():
        kind = ("bf16" if "13__nv_bfloat16" in fn else
                "f16" if "6__half" in fn else None)
        if kind is None:
            continue
        for line in lines:
            m = re.search(r"HGMMA\.\w+\.F32(\.\w+)?", line)
            if m:
                out.setdefault(kind, set()).add(m.group(1) or "")
    return out


def check_wgmma_build():
    """Phase 2 for the tensor-core kernels: each library's SASS holds
    HGMMA (wgmma) instructions, and ptxas's register and spill lines for
    each of their kernels. The four flash libraries hold both
    instantiations: HGMMA on bf16 operands in the bf16 kernels and on
    f16 operands (no BF16 suffix) in the f16 ones."""
    out = {}
    for name in WGMMA_LIBRARIES:
        lib, sass_text = sass(name)
        hgmma = sum("HGMMA" in line for line in sass_text.splitlines())
        report = ptxas_report(lib.with_suffix(".log").read_text())
        say(f"[build] {name}: {hgmma} HGMMA instructions in the SASS")
        for kernel, lines in report.items():
            say(f"[build] {kernel}: {'; '.join(lines)}")
        require(hgmma > 0, f"{name}: no HGMMA instruction in {lib.name}: "
                f"the tensor-core kernels do not use wgmma")
        out[name] = dict(hgmma=hgmma, ptxas=report)
        if name in F16_WGMMA_LIBRARIES:
            types = hgmma_types(sass_text)
            say(f"[build] {name}: HGMMA operand types by instantiation "
                f"{ {k: sorted(v) for k, v in types.items()} }")
            require(types.get("bf16") and
                    all("BF16" in t for t in types["bf16"]) and
                    types.get("f16") and
                    not any("BF16" in t for t in types["f16"]),
                    f"{name}: HGMMA operand types {types}: want BF16 in "
                    f"the bf16 kernels and f16 in the f16 ones")
            out[name]["hgmma_types"] = {k: sorted(v)
                                        for k, v in types.items()}
    return out


def tf32_instance(mangled):
    """A TF32 kernel's (name, instantiation) from its mangled name: the
    head dim of a flash kernel; x's type, the tile and the bytes a copy
    of x and of w reads (16, or 1: element by element) of the prefill
    GEMM; the bytes a load of w and of x reads (16, or 1) of the decode
    GEMV."""
    m = re.search(r"(wo_gemm_tf32_kernel)I(13__nv_bfloat16|f)"
                  r"Lb([01])ELb([01])E", mangled)
    if m:
        f32 = m.group(2) == "f"
        return m.group(1), (f"{'f32 32x512' if f32 else 'bf16 128x128'} "
                            f"x{16 if m.group(3) == '1' else 1} "
                            f"w{16 if m.group(4) == '1' else 1}")
    m = re.search(r"(wo_gemv_tf32_kernel)ILb([01])ELb([01])E", mangled)
    if m:
        return m.group(1), (f"f32 decode w{16 if m.group(2) == '1' else 1} "
                            f"x{16 if m.group(3) == '1' else 1}")
    m = re.fullmatch(r"(\w+)<(\d+)>", kernel_name(mangled))
    return (m.group(1), int(m.group(2))) if m else (mangled, None)


def check_tf32_build():
    """Phase 2 for the f32 kernels on the tensor cores (``TF32_KERNELS``:
    the split backward pair, the forward, the prefill GEMM, the decode
    GEMV): every instantiation holds TF32 tensor-core instructions (HMMA
    with .TF32) in its SASS, ptxas's register and spill lines are
    printed for each, and the ones the model's path runs
    (``TF32_MAIN_PATH``) spill nothing."""
    out = {}
    for name, kernels in TF32_KERNELS.items():
        lib, sass_text = sass(name)
        hmma, ptxas, fn = {}, {}, None
        for line in sass_text.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = tf32_instance(m.group(1))
                fn = fn if fn[0] in kernels else None
                if fn:
                    hmma[fn] = 0
            elif fn and "HMMA" in line and ".TF32" in line:
                hmma[fn] += 1
        for line in lib.with_suffix(".log").read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = tf32_instance(m.group(1))
                fn = fn if fn[0] in kernels else None
            elif fn and ("registers" in line or "spill" in line):
                ptxas.setdefault(fn, []).append(line.strip())
        want = {(k, i) for k, insts in kernels.items() for i in insts}
        label = {k: f"{k[0]}<{k[1]}>" for k in want}
        counted = {label.get(k, str(k)): n for k, n in hmma.items()}
        say(f"[build] {name}: TF32 HMMA instructions in the SASS of each "
            f"instantiation: {json.dumps(counted)}")
        for kernel, lines in sorted(ptxas.items(), key=str):
            say(f"[build] {label.get(kernel, kernel)}: {'; '.join(lines)}")
        require(set(hmma) == want, f"{name}: TF32 instantiations "
                f"{sorted(map(str, hmma))} in the SASS, want "
                f"{sorted(map(str, want))}")
        require(all(n > 0 for n in hmma.values()),
                f"{name}: no TF32 HMMA in "
                f"{[label[k] for k, n in hmma.items() if not n]}")
        out[name] = dict(hmma_tf32={label[k]: n for k, n in hmma.items()},
                         ptxas={label[k]: v for k, v in ptxas.items()})
        for inst in TF32_MAIN_PATH:
            if inst not in want:
                continue
            main_path = ptxas.get(inst, [])
            require(main_path and not any(
                re.search(r"\b[1-9]\d* bytes spill", line)
                for line in main_path), f"{label[inst]}: the "
                f"model's path spills: {main_path}")
    return out


def check_wo_mma_build():
    """Phase 2 for the bf16 decode kernel: every instantiation of
    ``wo_gemv_mma_kernel`` (16-byte or byte-wise w, 8-byte or element-wise
    x) in the ``wo_matmul`` library holds bf16 tensor-core instructions
    (HMMA) in its SASS, and ptxas's registers and spills for each are
    printed."""
    lib, sass_text = sass("wo_matmul")
    hmma, fn = {}, None
    for line in sass_text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if "wo_gemv_mma_kernel" in m.group(1) else None
            if fn:
                hmma[fn] = 0
        elif fn and "HMMA" in line:
            hmma[fn] += 1
    ptxas, fn = {}, None
    for line in lib.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1) if "wo_gemv_mma_kernel" in m.group(1) else None
        elif fn and ("registers" in line or "spill" in line):
            ptxas.setdefault(fn, []).append(line.strip())
    say(f"[build] wo_gemv_mma_kernel: HMMA in the SASS of each "
        f"instantiation: {json.dumps(hmma)}")
    for kernel, lines in sorted(ptxas.items()):
        say(f"[build] {kernel}: {'; '.join(lines)}")
    require(len(hmma) == 4, f"wo_matmul: {len(hmma)} instantiations of "
            f"wo_gemv_mma_kernel in the SASS, want 4")
    require(all(n > 0 for n in hmma.values()),
            f"wo_gemv_mma_kernel: no HMMA in "
            f"{[k for k, n in hmma.items() if not n]}")
    return dict(hmma=hmma, ptxas=ptxas)


def vec_args(mangled):
    """A vector norm kernel's template arguments from its mangled name:
    x's type, the parameters' type and the vectors a lane."""
    m = re.search(r"(?:fwd|bwd)_vec_kernelI(.*?)Li(\d+)EE", mangled)
    if not m:
        return mangled
    types = re.findall(r"13__nv_bfloat16|6__half|S\d*_|f", m.group(1))
    short = {"13__nv_bfloat16": "bf16", "6__half": "f16", "f": "f32"}
    named = [short.get(t) for t in types]
    named = [n if n else named[0] for n in named]
    return f"<{', '.join(named)}, {m.group(2)}>"


def check_norm_build():
    """Phase 2 for the norms' vector forwards: the SASS of every
    instantiation of ``rms_norm_fwd_vec_kernel`` and
    ``layer_norm_fwd_vec_kernel`` holds 16-byte global loads
    (LDG.E.128), and ptxas's registers and spills for each are
    printed (x type, parameter type, vectors a lane)."""
    out = {}
    for name in NORM_LIBRARIES:
        kernel = f"{name}_fwd_vec_kernel"
        lib, sass_text = sass(name)
        ldg, fn = {}, None
        for line in sass_text.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1) if kernel in m.group(1) else None
                if fn:
                    ldg[fn] = 0
            elif fn and "LDG.E.128" in line:
                ldg[fn] += 1
        ptxas, fn = {}, None
        for line in lib.with_suffix(".log").read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = m.group(1) if kernel in m.group(1) else None
            elif fn and ("registers" in line or "spill" in line):
                ptxas.setdefault(vec_args(fn), []).append(line.strip())
        require(len(ldg) == 45, f"{name}: {len(ldg)} instantiations of "
                f"{kernel} in the SASS, want 45 (3 x 3 types x 5 widths)")
        short = {vec_args(f): n for f, n in ldg.items()}
        say(f"[build] {kernel}: LDG.E.128 in the SASS of each "
            f"instantiation: {json.dumps(short)}")
        for args, lines in sorted(ptxas.items()):
            say(f"[build] {kernel}{args}: {'; '.join(lines)}")
        require(all(n > 0 for n in ldg.values()),
                f"{kernel}: no 16-byte load (LDG.E.128) in "
                f"{[a for a, n in short.items() if not n]}")
        out[kernel] = dict(ldg_e_128=short, ptxas=ptxas)
    return out


def decode_instance(mangled):
    """A paged decode, flat AdamW vector, int8 x int8, LayerNorm vector
    backward or RoPE vector kernel's instantiation from its mangled name:
    ``<dtype, D, route>``, ``<p type, g type>``, ``<BN>`` (the prefill
    tile's width), ``<NT8, VEC, XVEC>`` (the decode kernel's n8 tiles,
    16-byte w and 8-byte x loads), ``<x type, g type, vectors a lane>``
    or ``<x type, table type, backward>``."""
    short = {"13__nv_bfloat16": "bf16", "6__half": "f16", "f": "f32"}
    m = re.search(r"rope_vec_kernelI(.*?)Lb([01])EE", mangled)
    if m:
        named = [short.get(t) for t in
                 re.findall(r"13__nv_bfloat16|6__half|S\d*_|f", m.group(1))]
        named = [n if n else named[0] for n in named]
        return f"<{', '.join(named)}, {m.group(2) == '1'}>"
    if "layer_norm_bwd_vec_kernel" in mangled:
        return vec_args(mangled)
    m = re.search(r"i8i8_wgmma_kernelILi(\d+)E", mangled)
    if m:
        return f"<{m.group(1)}>"
    m = re.search(r"i8i8_gemv_mma_kernelILi(\d)ELb([01])ELb([01])E",
                  mangled)
    if m:
        return f"<{m.group(1)}, {m.group(2) == '1'}, {m.group(3) == '1'}>"
    m = re.search(r"paged_decode_cluster_kernelI(f|13__nv_bfloat16)Li(\d+)"
                  r"ELb([01])E", mangled)
    if m:
        return (f"<{short[m.group(1)]}, {m.group(2)}, "
                f"{'split' if m.group(3) == '1' else 'global'}>")
    m = re.search(r"adamw_flat_vec_kernelI(.*?)EEv", mangled)
    if m:
        named = [short.get(t) for t in
                 re.findall(r"13__nv_bfloat16|6__half|S\d*_|f", m.group(1))]
        named = [n if n else named[0] for n in named]
        return f"<{', '.join(named)}>"
    return mangled


# the kernels whose SASS phase 2 checks: library, kernel, instantiations,
# the instruction each must hold (cp.async: LDGSTS; a 16-byte load; wgmma
# with s8 operands: IGMMA, the integer form of HGMMA; mma.sync s8: IMMA).
# The LayerNorm vector backward: 3 x types x 3 g types x vectors a lane 1,
# 2, 4 (and 8 for f32 x); the RoPE vector kernel: 3 x 3 types x 2
# directions
DECODE_BUILD = (("paged_decode", "paged_decode_cluster_kernel", 12,
                 "LDGSTS"),
                ("adamw_flat", "adamw_flat_vec_kernel", 9, "LDG.E.128"),
                ("i8i8_matmul", "i8i8_wgmma_kernel", 2, "IGMMA"),
                ("i8i8_matmul", "i8i8_gemv_mma_kernel", 8, "IMMA"),
                ("layer_norm", "layer_norm_bwd_vec_kernel", 30, "LDG.E.128"),
                ("rope", "rope_vec_kernel", 18, "LDG.E.128"))


def check_decode_build():
    """Phase 2 for the paged decode (``paged_decode_cluster_kernel``: 2
    dtypes x 3 head dims x 2 routes), the flat AdamW's vector route
    (``adamw_flat_vec_kernel``: 3 p types x 3 g types), the int8 x int8
    kernels (``i8i8_wgmma_kernel``: 2 tile widths;
    ``i8i8_gemv_mma_kernel``: 2 x 2 x 2), the LayerNorm vector backward
    (``layer_norm_bwd_vec_kernel``: 30) and RoPE's vector route
    (``rope_vec_kernel``: 18): every instantiation's SASS
    holds its copies (LDGSTS, cp.async), its 16-byte loads (LDG.E.128)
    or its tensor-core instructions (IGMMA, IMMA), and ptxas's registers
    and spills for each are printed."""
    out = {}
    for name, kernel, count, op in DECODE_BUILD:
        lib, sass_text = sass(name)
        found, fn = {}, None
        for line in sass_text.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1) if kernel in m.group(1) else None
                if fn:
                    found[fn] = 0
            elif fn and op in line:
                found[fn] += 1
        ptxas, fn = {}, None
        for line in lib.with_suffix(".log").read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = m.group(1) if kernel in m.group(1) else None
            elif fn and ("registers" in line or "spill" in line):
                ptxas.setdefault(decode_instance(fn), []).append(
                    line.strip())
        short = {decode_instance(f): n for f, n in found.items()}
        say(f"[build] {kernel}: {op} in the SASS of each instantiation: "
            f"{json.dumps(short)}")
        for args, lines in sorted(ptxas.items()):
            say(f"[build] {kernel}{args}: {'; '.join(lines)}")
        require(len(found) == count, f"{name}: {len(found)} instantiations "
                f"of {kernel} in the SASS, want {count}")
        require(all(n > 0 for n in found.values()),
                f"{kernel}: no {op} in {[a for a, n in short.items() if not n]}")
        out[kernel] = {op: short, "ptxas": ptxas}
    return out


def launches_by_route(n, launches):
    """The main-path ``launches`` of wrapper row ``n`` split by route:
    each route with a row of its own reads that row's count, and what is
    left goes to the one remaining route (to the remaining routes
    together, named by ``+``, where several remain)."""
    counter = KERNELS[n]["counter"]
    by = {k["route"]: launches[m] for m, k in KERNELS.items()
          if k["counter"] is counter and "route" in k}
    rest = [r for r in counter.route_launches if r not in by]
    if rest:
        by["+".join(rest)] = launches[n] - sum(by.values())
    return by


def f16_entry(rows, n, p19):
    """A flash kernel's f16 instantiation in the kernels line: its row at
    the bf16 row's shape (phase 3 or 12) and its f16 launches on the main
    path (phase 19)."""
    bf16 = line_row(rows, n)
    r = next((x for x in rows if x["name"] == n and x["dtype"] == "float16"
              and x["shape"] == bf16["shape"]), None)
    out = dict(launches=p19["main_path_f16_launches"][n])
    if r is not None:
        out.update({key: r[key] for key in (
            "shape", "max_abs_err", "tol", "ms", "device_ms",
            "kernel_device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms") if key in r})
        for key in ("scaled_err", "metric", "off_share"):
            if r.get(key) is not None:
                out[key] = r[key]
    return out


def line_row(rows, n):
    """The row the kernels line reports for kernel ``n``: its main
    path's bf16 shape (the fused AdamW step over the training leaves in
    their O2 dtypes; the momentum state and the f32 tensor-core kernels
    (the forward, the split pair, the prefill GEMM, the decode GEMV) are
    f32)."""
    def wanted(r):
        if r["name"] != n:
            return False
        if n == "momentum_step":
            return r["dtype"] == "float32"
        if n == "adamw_step":
            return r["dtype"] == ADAMW_LINE_DTYPE
        if n == "wo_matmul":
            return r["dtype"] == "float32" and r["shape"] == LINE_SHAPES[n]
        if n in F32_TC_ROW.values() or n == "wo_gemm_tf32":
            return r["dtype"] == "float32" and r["shape"] == LINE_SHAPES[n]
        if n in I8_ROW_NAME.values():
            return r["shape"] == LINE_SHAPES[n]
        if r["dtype"] != "bfloat16":
            return False
        if n == "flash_fwd":
            return "B1 H16 S1024" in r["shape"]
        return r["shape"] == LINE_SHAPES.get(n, r["shape"])
    return next(r for r in rows if wanted(r))


def main():
    t_run = time.perf_counter()
    # seconds from the start at the end of each phase (against the run's
    # time budget)
    marks = {}

    def mark(phase):
        marks[phase] = time.perf_counter() - t_run
        say(f"[time] {phase} done at {marks[phase]:.1f} s")

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
    norm_build = check_norm_build()
    tf32_build = check_tf32_build()
    wo_mma_build = check_wo_mma_build()
    decode_build = check_decode_build()

    mark("1-2 device, build")

    # 3. kernels against their plain versions
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    rows, ragged = [], []
    # the last slices' kernels first (the int8 x int8 matmul, the norms,
    # whose routes are checked by kernel name): late in a long run the
    # profiler has been seen to drop records (see device_ms)
    for label, (K, N) in I8_SHAPES.items():
        for M in I8_ROWS_M:
            (rows if M in I8_TIMED_M else ragged).append(
                check_i8i8(M, K, N, label, gen, dev, timed=M in I8_TIMED_M))
    # ragged: both kernels off and on TMA's rule; the largest sums; and
    # sums past 2**31, which wrap as the plain version's int32 adds do
    ragged += [check_i8i8(M, K, N, "ragged", gen, dev, timed=False)
               for M, K, N in ((3, 200, 333), (37, 200, 333), (37, 208, 336),
                               (1008, 208, 336))]
    ragged += [check_i8i8(M, K, 256 if K == 8192 else 16, label, gen, dev,
                          timed=False, fill=fill)
               for M in (8, 32)
               for K, label, fill in ((8192, "all +-127", "pm127"),
                                      (131200, "all -128", "m128"))]
    ragged += [check_int4(8, 2048, 8192, dtype, gen, dev, "up")
               for dtype in (torch.bfloat16, torch.float32)]
    torch.cuda.empty_cache()
    for case in RMS_CASES:
        rows += check_rms_norm(*case, gen, dev, timed=True)
    for case in RMS_RAGGED:
        ragged += check_rms_norm(*case, gen, dev, timed=False)
    for case in LN_CASES:
        rows += check_layer_norm(*case, gen, dev, timed=True)
    for case in LN_RAGGED:
        ragged += check_layer_norm(*case, gen, dev, timed=False)
    torch.cuda.empty_cache()
    rope_gen = torch.Generator(device=dev).manual_seed(1)
    for dtype in (torch.bfloat16, torch.float32):
        for B, S, H, D, table, timed in ROPE_CASES:
            (rows if timed else ragged).extend(
                check_rope(B, S, H, D, table, dtype, gen, dev, timed))
        for B, S, H, D, table in ROPE_GENERAL_CASES:
            ragged += check_rope(B, S, H, D, table, dtype, rope_gen, dev,
                                 False)
    for N, pdt, timed in ADAMW_FLAT_CASES:
        (rows if timed else ragged).extend(
            check_adamw_flat(N, pdt, gen, dev, timed))
        torch.cuda.empty_cache()
    for dtype in (torch.bfloat16, torch.float32):
        for S in (128, 1024, 2048):
            rows.append(check_flash(dtype, S, gen, dev))
        for label, ctx, D in PAGED_CASES:
            for split in (False, True):
                rows.append(check_paged(dtype, gen, dev, rng, split, label,
                                        ctx, D))
    # f16 (the bf16 kernels' f16 instantiations) at the serving shapes
    for S in (128, 1024, 2048):
        rows.append(check_flash(torch.float16, S, gen, dev))
    torch.cuda.empty_cache()
    # the fused backward (the bf16 and f16 route) at the serving shapes
    ragged += [r for dtype in HALF for S in (128, 1024, 2048)
               for r in check_flash_bwd(dtype, 1, 16, S, S, 128,
                                        gen, dev, timed=False,
                                        routes=("fused",))]
    # the training path's shapes
    T = TRAIN
    hd = T["hidden"] // T["heads"]
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        rows.append(check_flash(dtype, T["seq"], gen, dev, B=T["batch"],
                                D=hd))
        rows += check_flash_bwd(dtype, T["batch"], T["heads"], T["seq"],
                                T["seq"], hd, gen, dev, timed=True)
    # f32 not causal at the training shape: every tile of the walks full
    ragged += check_flash_bwd(torch.float32, T["batch"], T["heads"],
                              T["seq"], T["seq"], hd, gen, dev, timed=False,
                              causal=False)
    torch.cuda.empty_cache()
    # the incubate stack's attention (phase 14), bf16
    C = STACK
    for dtype in HALF:
        rows.append(check_flash(dtype, C["seq"], gen, dev, B=C["batch"],
                                D=C["hidden"] // C["heads"]))
        rows += check_flash_bwd(dtype, C["batch"], C["heads"], C["seq"],
                                C["seq"], C["hidden"] // C["heads"], gen,
                                dev, timed=True, routes=("fused",))
    torch.cuda.empty_cache()
    # the f16 fused backward on exact inputs at the training and incubate
    # shapes (generators of their own: no later draw moves)
    ragged += [check_flash_bwd_exact(
        torch.float16, B, H, S, D,
        torch.Generator(device=dev).manual_seed(230 + i), dev)
        for i, (B, H, S, D) in enumerate((
            (T["batch"], T["heads"], T["seq"], hd),
            (C["batch"], C["heads"], C["seq"], C["hidden"] // C["heads"])))]
    # ragged: lengths around the tensor-core kernels' tiles, Sq < Sk
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        for D in (16, 64, 128):
            for Sq, Sk, causal in FLASH_RAGGED:
                ragged.append(check_flash_ragged(dtype, 2, 4, Sq, Sk, D,
                                                 causal, gen, dev))
                if causal or (Sq == 200 and dtype == torch.float32):
                    # the split pair keeps its ragged shape, 200 / 333
                    # (in f32 not causal too)
                    ragged += check_flash_bwd(
                        dtype, 2, 4, Sq, Sk, D, gen, dev, timed=False,
                        routes=("fused", "split") if Sq == 200
                        else ("fused",), causal=causal)
    leaves = [(tuple(p.shape), p.dtype) for p in
              train_setup(T["layers"], dev, bf16=True)[0].parameters()]
    rows += check_adamw(leaves, gen, dev)
    torch.cuda.empty_cache()
    with core.place_scope(dev):
        o2 = amp.decorate(resnet50(), level="O2", dtype="bfloat16")
    rows.append(check_momentum([tuple(p.shape) for p in o2.parameters()],
                               [p.dtype for p in o2.parameters()], gen, dev))
    del o2
    torch.cuda.empty_cache()
    int8pack = int8pack_available(dev)
    for dtype in (torch.bfloat16, torch.float32):
        for label, (K, N) in WO_SHAPES.items():
            for M in WO_ROWS_M[dtype]:
                for with_bias in (False, True):
                    rows.append(check_wo(dtype, M, K, N, with_bias, gen, dev,
                                         label, int8pack))
        torch.cuda.empty_cache()
    ragged += [check_wo(dtype, M, 200, N, with_bias, gen, dev, "ragged",
                        False, timed=False)
               for M, N in ((3, 333), (37, 336))
               for dtype in (torch.bfloat16, torch.float32)
               for with_bias in (False, True)]
    # decode on the tensor cores at the batches the timed rows skip, at
    # every projection in both dtypes; then ragged K and N, and x and w
    # one element past a 16-byte boundary (both decode kernels); the f32
    # decode in one K split past 512 rows a warp
    ragged += [check_wo(dtype, M, K, N, with_bias, gen, dev, label,
                        False, timed=False)
               for dtype in (torch.bfloat16, torch.float32)
               for label, (K, N) in WO_SHAPES.items()
               for M in WO_DECODE_ROWS for with_bias in (False, True)]
    ragged.append(check_wo(torch.float32, *WO_LONG_DECODE, True, gen, dev,
                           "long K, one split", False, timed=False))
    ragged += [check_wo(dtype, M, K, N, True, gen, dev, label, False,
                        timed=False, offset=offset)
               for M, K, N, label, offset in (
                   (5, 1030, 7, "ragged", False),
                   (8, 2048, 2048, "out_proj", True),
                   (2, 200, 333, "ragged", True),
                   (37, 200, 333, "ragged", True),
                   (144, 2048, 2048, "out_proj", True))
               for dtype in (torch.bfloat16, torch.float32)]
    # off TMA's 16-byte rule (N % 16, K % 8): the TF32 GEMM in both dtypes,
    # and past 8 splits of 2048 rows (each split's accumulators go into a
    # second sum every 2048 rows)
    ragged += [check_wo(dtype, M, K, N, with_bias, gen, dev, "ragged", False,
                        timed=False)
               for M, K, N in ((37, 200, 333), (1008, 204, 336),
                               (144, 20484, 333))
               for dtype in (torch.bfloat16, torch.float32)
               for with_bias in (False, True)]
    ragged += [check_wo(torch.float32, 1008, 20480, 2048, True, gen, dev,
                        "long K", False, timed=False)]
    ragged.append(check_int4(144, 2048, 8192, torch.float32, gen, dev, "up"))
    ragged.append(check_wo_all_values(dev))
    mark("3 kernels")

    # 12. the packed varlen kernels, into phase 3's rows
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        for lens, D in ((VARLEN_README, 128), (VARLEN_SERVING, 128),
                        (VARLEN_README, 64)):
            rows += check_varlen(dtype, 16, D, lens, None, True, gen, dev,
                                 timed=True)
    ragged += [r for dtype in (torch.bfloat16, torch.float32, torch.float16)
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
    # the f16 instantiation of the fused backward on the same exact cases
    ragged += [check_varlen_exact(4, D, lens_q, lens_k, causal, gen, dev,
                                  torch.float16)
               for D in (16, 64, 128)
               for lens_q, lens_k, causal in VARLEN_RAGGED + [
                   (q_, k_, True) for q_, k_ in VARLEN_EMPTY]]
    ragged.append(check_varlen_misaligned(gen, dev))
    torch.cuda.empty_cache()
    # the bf16 split pair: on exactly summed inputs (the cases the fused
    # kernel's exact check takes), and over random draws; their own
    # generators
    split_gen = torch.Generator(device=dev).manual_seed(2)
    ragged += [check_varlen_split_exact(4, D, lens_q, lens_k, causal,
                                        split_gen, dev)
               for D in (16, 64, 128)
               for lens_q, lens_k, causal in VARLEN_RAGGED]
    ragged += [check_varlen_split_exact(16, D, lens, None, causal,
                                        split_gen, dev)
               for lens in (VARLEN_README, VARLEN_SERVING)
               for D in (16, 64, 128) for causal in (True, False)]
    split_draws = check_varlen_split_draws(dev)
    for r in split_draws:
        say(f"[kernel] flash_varlen split pair bf16 {r['batch']} seed "
            f"{r['seed']}: err {r['err']} (limit "
            f"{BWD_TOL[torch.bfloat16]})")
    for r in rows:
        say(f"[kernel] {r['name']} {r['dtype']} {r['shape']}: err "
            f"{r['max_abs_err']:.3g} (tol {r['tol']}) ms {r['ms']:.4f} "
            f"(device {r['device_ms']}, kernel {r['kernel_device_ms']}) "
            f"plain {r['plain_ms']:.4f} library {r['library_ms']} "
            f"(device {r.get('library_device_ms')}) bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']})"
            + (f" host {r['host_ms']:.4f} int8pack {r['int8pack_mm_ms']}"
               if r["name"] in WO_ROW_NAME.values() else "")
            + (f" host {r['host_ms']:.4f} parent's chain "
               f"{r['chain_ms']:.4f} (device {r['chain_device_ms']})"
               if r["name"] == "adamw_step" else "")
            + (f" host {r['host_ms']:.4f} ({r['route']} route, its kernel "
               f"seen by name: {r['kernel_seen']})" if "kernel_seen" in r
               else "")
            + (f" cluster {r['cluster']} x {r['chunk_pages']} pages, a rerun "
               f"bitwise {r['bitwise']}" + (f" host {r['host_ms']:.4f}"
                                            if "host_ms" in r else "")
               if "cluster" in r else "")
            + (f" scaled {r['scaled_err']:.3g}, off the rounded sums "
               f"{r['off_share']:.3g}, unrounded {r['unrounded_err']}"
               if r.get("off_share") is not None else "")
            + (f" (TF32 tensor cores; CUDA-core bound "
               f"{r['bound_cuda_core_ms']:.4f})"
               f" host {r['host_ms']:.4f} single-pass TF32 "
               f"{r['single_pass_tf32_err']} bitwise {r['bitwise']}"
               if "bound_cuda_core_ms" in r else ""))
    for r in ragged:
        if r["name"].startswith(("layer_norm", "rms_norm")):
            say(f"[kernel] {r['name']} {r['dtype']} {r['shape']}: err "
                f"{r['max_abs_err']:.3g} (past the limit by "
                f"{r['excess_over_tol']:.3g}; {r['tol']})"
                + (f"; {r['route']} route, its kernel seen by name: "
                   f"{r['kernel_seen']}" if "kernel_seen" in r else ""))
        elif r["name"] in WO_ROW_NAME.values():
            say(f"[kernel] {r['name']} {r['dtype']} {r['shape']}: err "
                f"{r['max_abs_err']:.3g} (scaled {r['scaled_err']:.3g}, tol "
                f"{r['tol']})" + (f", bitwise on a second run "
                                  f"{r['bitwise']}" if "bitwise" in r
                                  else ""))
        elif r["name"] in ("rope", "rope_vec", "adamw_flat",
                           "adamw_flat_vec"):
            say(f"[kernel] {r['name']} {r['dtype']} {r['shape']}: err "
                f"{r['max_abs_err']:.3g} ({r['tol']})"
                + (f"; {r['route']} route, its kernel seen by name: "
                   f"{r['kernel_seen']}" if "kernel_seen" in r else ""))
        elif r["name"] in I8_ROW_NAME.values():
            say(f"[kernel] {r['name']} {r['shape']}: err "
                f"{r['max_abs_err']:.3g} ({r['tol']}), largest |sum| "
                f"{r['max_abs_sum']}, {r['kernel']}, tile {r['tile_n']}, "
                f"{r['k_splits']} K splits")
        elif r["name"] == "int4_weight_only_matmul":
            say(f"[kernel] int4_weight_only_matmul {r['dtype']} {r['shape']}: "
                f"err {r['max_abs_err']:.3g} (scaled {r['scaled_err']:.3g}, "
                f"tol {r['tol']}) ms {r['ms']:.4f}")
        elif r["name"] == "flash_fwd":
            say(f"[kernel] flash_fwd {r['dtype']} {r['shape']}: err "
                f"{r['max_abs_err']:.3g} (tol {r['tol']})"
                + (f", bitwise on a second run {r['bitwise']}"
                   if r["bitwise"] is not None else ""))
        elif r["name"] in ("flash_varlen_exact", "flash_bwd_exact",
                           "flash_varlen_split_exact"):
            say(f"[kernel] "
                + {"flash_varlen_exact": "flash_varlen_bwd_fused",
                   "flash_bwd_exact": "flash_bwd_fused",
                   "flash_varlen_split_exact": "flash_varlen split pair"}[
                       r["name"]]
                + f" {r['dtype']} {r['shape']}, inputs in {{-1, 0, 1}}: "
                f"dq/dk/dv err "
                f"{r['dq_dk_dv_err']} (tol {r['tol']})")
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
                f"{r['dtype']}: {r['dq_dk_dv_err_same_dtype']})"
                + (f", f32 split pair bitwise on a second run "
                   f"{r['f32_split_bitwise']}"
                   if r["f32_split_bitwise"] is not None else ""))
    for r in rows:
        if "route_ms" in r:
            say(f"[kernel] flash_attn_unpadded {r['dtype']} {r['shape']}: "
                f"packed route {r['route_ms']['packed']:.4f} ms, densify "
                f"route {r['route_ms']['densify']:.4f} ms (CUDA events)")
    for r in rows:
        if r["name"] in I8_ROW_NAME.values():
            say(f"[kernel] {r['name']} {r['shape']}: {r['kernel']}, tile "
                f"{r['tile_n']}, {r['k_splits']} K splits, host "
                f"{r['host_ms']:.4f} ms; library {r['library']} (device "
                f"{r['library_device_ms']})")
    say(f"[kernel] wo_matmul library yardsticks: torch.mm over the weight "
        f"dequantized beforehand; torch._weight_int8pack_mm (w [N, K] int8, "
        f"scales in x's dtype): "
        f"{'timed' if int8pack else 'none on CUDA'}")

    mark("12 varlen kernels")

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

    mark("4 engine")

    # 16. PTQ full-int8 serving at full width, SERVING_CUT_LAYERS deep
    cut = gpt3_1p3b(num_layers=SERVING_CUT_LAYERS)
    for tag, dtype in (("ptq_f32", torch.float32),
                       ("ptq_bf16", torch.bfloat16)):
        runs[tag], lq = serve_ptq(cut, dtype, econf, prompts, new, None,
                                  tag)
        add(lq)

    mark("16 PTQ serving")

    # 5. training at full width and depth
    train_rec, lt = train_bf16(smi)
    add(lt)
    say(f"[train bf16] {json.dumps(train_rec['bench'])}")
    say(f"[train bf16] device {train_rec['step_profile']['device_ms']:.2f} "
        f"ms a step, idle {train_rec['step_profile']['idle_share']:.3f}, "
        f"flash share {train_rec['flash_share_of_device']:.3f}, by group "
        f"{json.dumps(train_rec['device_ms_by_group'])}")
    say(f"[train bf16] {train_rec}")

    mark("5 training")

    # 6. the card against the CPU, f32
    f32run, lf = train_f32_vs_cpu()
    add(lf)
    say(f"[train f32 vs cpu] {f32run}")

    mark("6 f32 vs the CPU")

    # 7-9. fine-tuning ERNIE-3.0-base with the fused LayerNorm
    flags.set_flags({"pallas_layer_norm": True})
    ernie, le, ernie_model, ernie_train = ernie_bf16(smi)
    add(le)
    say(f"[ernie bf16] {json.dumps(ernie['bench'])}")
    say(f"[ernie bf16] traced step: device "
        f"{ernie['step_profile']['device_ms']:.2f} ms, idle "
        f"{ernie['step_profile']['idle_share']:.3f}, by group "
        f"{json.dumps(ernie['device_ms_by_group'])}")
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

    mark("7-9 ERNIE")

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

    mark("10-11 ResNet")

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

    mark("13 varlen training")

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

    mark("14-15 incubate")

    # 17. prefix cache, drafts and admission on GPT-3 1.3B
    p17, l17, verify_launches = phase17(dev, prompts, new)
    for l in l17:
        add(l)
    for r in p17["verify_kernel"]:
        say(f"[kernel] {r['name']} {r['dtype']} {r['shape']} (verify): err "
            f"{r['max_abs_err']:.3g} (tol {r['tol']}) ms {r['ms']:.4f} "
            f"(device {r['device_ms']}, kernel {r['kernel_device_ms']}) "
            f"plain {r['plain_ms']:.4f} bound {r['bound_ms']:.4f} "
            f"({r['bound_by']}), {r['launches_a_call']} launch a call, "
            f"bitwise {r['bitwise']}")
    for dt, r in p17["runs"].items():
        say(f"[phase 17 {dt}] {smi}: prefix on/off decode tok/s "
            f"{r['prefix']['on']['decode_tok_s']:.1f} / "
            f"{r['prefix']['off']['decode_tok_s']:.1f}, TTFT mean "
            f"{r['prefix']['on']['ttft_mean_s']:.4f} / "
            f"{r['prefix']['off']['ttft_mean_s']:.4f} s, peak "
            f"{r['prefix']['on']['peak_memory_gib']:.3f} / "
            f"{r['prefix']['off']['peak_memory_gib']:.3f} GiB, "
            f"divergences {len(r['prefix']['divergences'])}; spec "
            f"on/off decode tok/s {r['spec']['ngram']['decode_tok_s']:.1f}"
            f" / {r['spec']['off']['decode_tok_s']:.1f}, decode steps "
            f"{r['spec']['ngram']['decode_steps']} / "
            f"{r['spec']['off']['decode_steps']}, accepted "
            f"{r['spec']['ngram']['accepted']} rejected "
            f"{r['spec']['ngram']['rejected']}, paged_decode launches "
            f"{r['spec']['ngram']['paged_decode_launches']} / "
            f"{r['spec']['off']['paged_decode_launches']}, divergences "
            f"{len(r['spec']['ngram']['divergences'])}; oracle accepted "
            f"{r['spec']['oracle']['accepted']} rejected "
            f"{r['spec']['oracle']['rejected']} in "
            f"{r['spec']['oracle']['decode_steps']} steps; wrong accepted "
            f"{r['spec']['wrong']['accepted']} rejected "
            f"{r['spec']['wrong']['rejected']}; n-gram on span prompts "
            f"decode tok/s {r['spec']['ngram_span']['decode_tok_s']:.1f} / "
            f"{r['spec']['span_off']['decode_tok_s']:.1f}, decode steps "
            f"{r['spec']['ngram_span']['decode_steps']} / "
            f"{r['spec']['span_off']['decode_steps']}, accepted "
            f"{r['spec']['ngram_span']['accepted']} rejected "
            f"{r['spec']['ngram_span']['rejected']}; table check host ms a "
            f"step prefix on/off "
            f"{r['prefix']['on']['validate_host_ms_a_step']:.4f} / "
            f"{r['prefix']['off']['validate_host_ms_a_step']:.4f}, "
            f"n-gram span "
            f"{r['spec']['ngram_span']['validate_host_ms_a_step']:.4f}; "
            f"swap divergences {len(r['swap']['divergences'])}")
    say(f"[phase 17] paged_decode launches in verify steps: "
        f"{verify_launches}; int8 spec f32 wo_matmul launches past 8 "
        f"rows (wo_gemm_tf32): "
        f"{p17['int8_spec_f32']['wo_launches_past_8_rows']}")

    mark("17 prefix cache, drafts, admission")

    # 18. the framework core: the op library, the surface, save and load
    p18, l18 = phase18(dev, prompts, new, gens16)
    add(l18)
    say(f"[phase 18] {json.dumps({k: v for k, v in p18.items() if k != 'ops'})}")

    mark("18 core")

    # 19. mixed precision and the optimizer stack: float16 training
    p19, l19 = phase19(smi, train_rec["bench"])
    add(l19)

    mark("19 amp")

    # 20. the nn layer surface: the default nn.Transformer
    p20, l20 = phase20(smi)
    add(l20)

    mark("20 nn")

    # 21. the rest of nn and the vision zoo: DenseNet-121, ResNet-50 in
    # NHWC, the LSTM LM and beam search
    p21, l21 = phase21(smi, resnet)
    add(l21)

    mark("21 vision and rnn")

    # 22. observability and remat: the bench GPT under each remat policy,
    # the metrics plane read by perf_doctor, the cost model, the finite
    # check on the card
    p22, l22 = phase22(smi)
    add(l22)

    mark("22 observability and remat")

    say(f"[main path] launches: {launches}")
    say("[main path] launches by route: " + "; ".join(
        f"{n} {launches[n + '_vec']} vec, "
        f"{launches[n] - launches[n + '_vec']} general"
        for n in ("rms_norm_fwd", "rms_norm_bwd", "layer_norm_fwd",
                  "layer_norm_bwd", "rope", "adamw_flat")))
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
                         **({"wrapper_route": r["route"]} if "route" in r
                            else {}),
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
                         **{key: r[key] for key in ("bound_cuda_core_ms",)
                            if key in r},
                         library_ms=r["library_ms"],
                         **({"launches_by_route": launches_by_route(
                             n, launches)}
                            if "route" not in k and hasattr(
                                k["counter"], "route_launches") else {}),
                         **({"f16": f16_entry(rows, n, p19)}
                            if n in p19["main_path_f16_launches"]
                            else {})))
    # the paged decode at a verify step's shape (bf16 rows), and the
    # weight-only GEMM's launches past 8 rows in verify steps
    for entry in line:
        if entry["name"] in ("paged_decode", "paged_decode_split"):
            r = next(x for x in p17["verify_kernel"]
                     if x["name"] == entry["name"]
                     and x["dtype"] == "bfloat16")
            entry["verify_shape"] = dict(
                {key: r[key] for key in ("shape", "dtype", "max_abs_err",
                                         "tol", "ms", "device_ms",
                                         "kernel_device_ms", "plain_ms",
                                         "bound_ms", "bound_by")},
                launches=(verify_launches if entry["name"] ==
                          "paged_decode" else 0))
        if entry["name"] == "wo_gemm_tf32":
            entry["verify_launches_past_8_rows"] = \
                p17["int8_spec_f32"]["wo_launches_past_8_rows"]
    mark("the kernels line")
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(
        dict(device=kind, nvidia_smi=smi, build_s=build_s,
             wgmma_build=wgmma, norm_build=norm_build,
             tf32_build=tf32_build, wo_mma_build=wo_mma_build,
             decode_build=decode_build, kernels=rows,
             ragged=ragged, wo_bound=wo_bound, wo_payload=wo_payload,
             int8pack_mm_on_cuda=int8pack, engine=runs,
             train_bf16=train_rec, train_f32_vs_cpu=f32run,
             ernie_bf16=ernie, ernie_padded=padded,
             ernie_f32_vs_cpu=ernie32, resnet50_bf16=resnet,
             resnet18_f32_vs_cpu=r18, varlen_bf16=varlen,
             varlen_f32_vs_cpu=varlen32, incubate_bf16=stack,
             incubate_f32_vs_cpu=stack32, phase17=p17,
             varlen_split_draws=split_draws, core=p18, amp=p19,
             nn_transformer=p20, vision_rnn=p21, observability_remat=p22,
             launches=launches,
             phase_s=marks, seconds=time.perf_counter() - t_run), indent=1))
    say(f"[done] {time.perf_counter() - t_run:.1f} s")
    say(f"nvidia-smi: {smi}")
    say(json.dumps({"kernels": line}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
