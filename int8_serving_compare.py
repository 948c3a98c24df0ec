#!/usr/bin/env python3
"""Time int8 weight-only serving of GPT-3 1.3B in bf16 and the
weight-only matmul wrapper, for the port checked out at ``--root``.

    python3 int8_serving_compare.py --root DIR --tag NAME

Run on a machine with one CUDA GPU. The process imports the port and
``chip_smoke.py`` from ``DIR`` and builds ``DIR``'s kernels, so two
commits are compared by running it once per checkout, in turns
(parent, change, change, parent), on one card. It serves the smoke's
phase-4 requests (8 prompts of 17..1000 tokens, 32 new tokens each,
``EngineConfig(block_size=16, num_blocks=1024, max_batch=8)``) with
``weight_only_int8=True, weight_only_lm_head=True`` twice on one model
and reports the second run's ``serve()`` figures; then times
``int8_weight_only_matmul`` at the up projection (K 2048, N 8192, with a
bias) at M 8 (decode) and M 1008 (a padded 1000-token prefill), in bf16
and f32: CUDA events, device time from torch.profiler, and the
wrapper's host time a call (the median of 200 calls without a sync).
Prints the card's name and power limit, then one JSON line.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--tag", required=True)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("int8_serving_compare: no CUDA device")
    import chip_smoke as cs
    from paddle2_tpu_torch.kernels import _build
    from paddle2_tpu_torch.kernels import quant_matmul as qm
    from paddle2_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
    from paddle2_tpu_torch.serving import EngineConfig

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"[{args.tag}] {smi}; root {root}", flush=True)
    build_s = _build.build_all()

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
    print(json.dumps(dict(tag=args.tag, root=str(root), nvidia_smi=smi,
                          kind=torch.cuda.get_device_name(0),
                          build_s=build_s, serve=runs[1],
                          serve_first=runs[0],
                          wo_up_k2048_n8192_bias=wo)), flush=True)


if __name__ == "__main__":
    main()
