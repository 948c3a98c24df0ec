"""ServingEngine: continuous batching + paged KV over a GPT model.

Counterpart of ``paddle2_tpu/serving/engine.py``. Requests come in via
:meth:`ServingEngine.submit`; :meth:`~ServingEngine.admit_and_prefill`
prefills admitted requests (the flash kernel) into paged KV blocks;
every :meth:`~ServingEngine.decode_once` runs one decode step over the
whole running batch (the paged-decode kernels), padded to a
(batch, pages) bucket. Admissions and evictions happen between steps.
Greedy decoding; time enters only through the caller's ``now`` stamps.

This slice serves one live ``GPTForCausalLM`` whose parameter dtype
equals ``kv_dtype``. ``weight_only_int8`` and ``weight_only_lm_head``
quantize the block projections and the logits matmul to int8 weight-only
(:mod:`paddle2_tpu_torch.quantization`), in place, as the JAX engine
does. The options below raise ``NotImplementedError`` and wait for the
serving queue in ROADMAP.md (item numbers in the messages): the prefix
cache, speculative decoding, KV spill, admission control
(``reliability``) and loading a saved artifact. The metrics, flight
recorder and tracing hooks are left out with them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence as Seq, Tuple

import numpy as np

from ..device import resolve_device
from ..quantization import quantize_lm_head, weight_only_quantize
from .block_cache import (BlockAllocator, PagedKVCache, blocks_for_tokens,
                          GARBAGE_BLOCK)
from .model_runner import PagedGPTRunner
from .reliability import (EngineFailedError, PromptTooLongError,
                          RequestRejected)
from .scheduler import (ContinuousBatchingScheduler, Request,
                        SchedulerConfig, Sequence)

__all__ = ["EngineConfig", "ServingEngine"]

# option -> (value that means "off", ROADMAP serving-queue item)
_DEFERRED = {
    "enable_prefix_cache": (False, "item 1 (prefix cache)"),
    "spec": (None, "item 2 (speculative decoding)"),
    "enable_kv_spill": (False, "item 3 (KV spill / host tier)"),
    "reliability": (None, "item 5 (admission control)"),
}


def _pow2_ladder(lo: int, hi: int) -> Tuple[int, ...]:
    out, v = [], lo
    while v < hi:
        out.append(v)
        v *= 2
    out.append(hi)
    return tuple(sorted(set(out)))


@dataclass
class EngineConfig:
    """The JAX package's engine configuration, field for field and with
    the same defaults, less its ``interpret`` flag (a Pallas notion: the
    port's CPU path is each kernel's plain version)."""
    block_size: int = 16
    num_blocks: int = 64
    max_batch: int = 8
    # None -> power-of-two ladders from max_batch / max_model_len; the
    # count of distinct decode shapes is bounded by their product
    batch_buckets: Optional[Tuple[int, ...]] = None
    page_buckets: Optional[Tuple[int, ...]] = None
    prefill_budget_tokens: int = 512
    weight_only_int8: bool = False
    weight_only_lm_head: bool = False
    max_model_len: Optional[int] = None
    kv_dtype: str = "float32"
    reliability: Optional[object] = None
    enable_prefix_cache: bool = False
    prefix_cache_blocks: Optional[int] = None
    spec: Optional[object] = None
    # split-K width for the paged-attention kernels (None = the
    # shared-memory fit dispatch)
    split_pages: Optional[int] = None
    enable_kv_spill: bool = False
    host_tier_blocks: Optional[int] = None
    host_link_gbps: Optional[float] = None


class ServingEngine:
    """Continuous-batching serving engine over one GPT model.

    ``device`` defaults to ``cuda`` and raises without a GPU; the model
    must already lie on it. With ``weight_only_int8`` the engine swaps
    every block's ``nn.Linear`` (qkv, out_proj, up, down) for a
    ``WeightOnlyLinear``, and with ``weight_only_lm_head`` installs the
    model's ``_wo_head``: it changes the model it is given, in place."""

    def __init__(self, model=None, config: Optional[EngineConfig] = None,
                 device=None, *, artifact_path: Optional[str] = None):
        if artifact_path is not None:
            raise NotImplementedError(
                "loading a saved artifact is not ported yet (ROADMAP "
                "serving queue, item 6 (artifact load))")
        if model is None:
            raise ValueError("pass model=")
        self.config = config or EngineConfig()
        for name, (off, item) in _DEFERRED.items():
            if getattr(self.config, name) != off:
                raise NotImplementedError(
                    f"EngineConfig.{name} is not ported yet (ROADMAP "
                    f"serving queue, {item})")
        self.device = resolve_device(device)
        cfg = model.cfg
        param = model.gpt.wte.weight
        if param.device.type != self.device.type:
            raise ValueError(f"the model lies on {param.device}, the engine "
                             f"on {self.device}")
        if str(param.dtype) != f"torch.{self.config.kv_dtype}":
            raise ValueError(f"model dtype {param.dtype} differs from "
                             f"kv_dtype {self.config.kv_dtype!r}")
        self.cache = PagedKVCache(
            cfg.num_layers, self.config.num_blocks, self.config.block_size,
            cfg.num_heads, cfg.head_dim, dtype=self.config.kv_dtype,
            device=self.device)
        self.model = model
        model.eval()
        self.max_model_len = int(self.config.max_model_len
                                 or cfg.max_position_embeddings)
        if self.max_model_len > cfg.max_position_embeddings:
            raise ValueError(
                f"max_model_len {self.max_model_len} exceeds the model's "
                f"max_position_embeddings {cfg.max_position_embeddings}")
        if self.config.weight_only_int8:
            if cfg.stacked_blocks:
                raise ValueError(
                    "weight_only_int8 needs addressable blocks; rebuild "
                    "the model with stacked_blocks=False")
            # the projections inside the blocks; the embeddings and the
            # head stay fp unless weight_only_lm_head opts the head in
            for block in model.gpt.h:
                weight_only_quantize(block)
        if self.config.weight_only_lm_head:
            quantize_lm_head(model)
        self.allocator = BlockAllocator(self.config.num_blocks,
                                        self.config.block_size)
        max_pages = blocks_for_tokens(self.max_model_len,
                                      self.config.block_size)
        self.scheduler = ContinuousBatchingScheduler(SchedulerConfig(
            max_batch=self.config.max_batch,
            batch_buckets=(self.config.batch_buckets
                           or _pow2_ladder(1, self.config.max_batch)),
            page_buckets=(self.config.page_buckets
                          or _pow2_ladder(1, max_pages)),
            prefill_budget_tokens=self.config.prefill_budget_tokens),
            self.allocator)
        self.runner = PagedGPTRunner(model, cfg.num_heads, cfg.head_dim,
                                     split_pages=self.config.split_pages)
        self._next_req_id = 0
        self._seqs: Dict[int, Sequence] = {}
        self.decode_steps = 0
        self.failed = False
        self.fail_reason: Optional[str] = None

    # -- request intake --------------------------------------------------
    def submit(self, prompt: Seq[int], max_new_tokens: int,
               arrival_t: float = 0.0) -> int:
        """Submit one request; returns its id. Raises
        :class:`~.reliability.PromptTooLongError` when the request can
        never fit the model's context."""
        self._check_alive()
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise RequestRejected("empty prompt")
        if max_new_tokens < 1:
            raise RequestRejected(
                "max_new_tokens must be >= 1 (prefill always produces "
                "the first token)")
        if len(prompt) + max_new_tokens > self.max_model_len:
            raise PromptTooLongError(
                f"prompt({len(prompt)}) + max_new({max_new_tokens}) "
                f"exceeds max_model_len {self.max_model_len}")
        rid = self._next_req_id
        self._next_req_id += 1
        seq = Sequence(Request(rid, prompt, int(max_new_tokens), arrival_t),
                       self.allocator)
        self.scheduler.submit(seq)
        self._seqs[rid] = seq
        return rid

    def sequence(self, req_id: int) -> Sequence:
        return self._seqs[req_id]

    # -- failure ---------------------------------------------------------
    def _check_alive(self) -> None:
        if self.failed:
            raise EngineFailedError(f"engine failed: {self.fail_reason}")

    def _run(self, fn, *args):
        """Run one device step. A fault inside it leaves the pools in an
        unknown state, so the engine fails and refuses further work."""
        try:
            return fn(*args)
        except (RuntimeError, ValueError) as e:
            self.failed = True
            self.fail_reason = f"{type(e).__name__}: {e}"
            raise EngineFailedError(self.fail_reason) from e

    # -- admission + prefill ---------------------------------------------
    def admit_and_prefill(self, now: float = 0.0) -> List[dict]:
        """One admission round: FIFO-admit within the prefill budget,
        prefill each admitted sequence (all its tokens — first admission
        or recompute after eviction), scatter its K/V into its blocks and
        take its next token. Returns one info dict per admission."""
        self._check_alive()
        out = []
        for seq in self.scheduler.admit():
            n = len(seq.tokens)
            tok, k_stack, v_stack = self._run(self.runner.prefill,
                                              seq.tokens)
            row = np.asarray(seq.table.blocks, np.int64)
            bs = self.cache.block_size
            PagedKVCache.scatter_prefill(self.cache.k, k_stack, row, n, bs)
            PagedKVCache.scatter_prefill(self.cache.v, v_stack, row, n, bs)
            seq.table.num_tokens = n
            seq.tokens.append(tok)
            if seq.first_token_t is None:
                seq.first_token_t = now
            self.scheduler.mark_running(seq)
            if seq.done:
                self.scheduler.finish(seq, now)
            out.append({"seq": seq, "prompt_tokens": n,
                        "padded_len": self.runner.prefill_padded_len(n)})
        return out

    # -- one decode step -------------------------------------------------
    def decode_once(self, now: float = 0.0) -> Optional[dict]:
        """Run ONE decode step over every running sequence. Returns a
        step info dict, or None when nothing runs."""
        self._check_alive()
        if not self.scheduler.running():
            return None
        victims = self.scheduler.reserve_decode_slots()
        active = self.scheduler.running()
        if not active:
            return None
        b_bucket, p_bucket = self.scheduler.decode_bucket(active)
        ids = np.zeros((b_bucket, 1), np.int64)
        positions = np.zeros((b_bucket,), np.int64)
        tables = np.full((b_bucket, p_bucket), GARBAGE_BLOCK, np.int32)
        for i, s in enumerate(active):
            p0 = s.num_cached
            ids[i, 0] = s.tokens[p0]
            positions[i] = p0
            tables[i] = s.table.padded(p_bucket)
        toks = self._run(self.runner.decode, self.cache, ids, positions,
                         tables)
        self.decode_steps += 1
        for i, s in enumerate(active):
            s.table.append_slot()
            s.tokens.append(int(toks[i]))
            if s.done:
                self.scheduler.finish(s, now)
        return {"bucket": (b_bucket, p_bucket), "n_active": len(active),
                "tokens": len(active), "evictions": len(victims)}

    def tick(self, now: float = 0.0) -> Optional[dict]:
        """Admissions then one decode step, both stamped with ``now``."""
        self.admit_and_prefill(now)
        return self.decode_once(now)

    # -- reporting -------------------------------------------------------
    @property
    def num_decode_programs(self) -> int:
        return self.runner.num_decode_programs

    @property
    def program_budget(self) -> int:
        return self.scheduler.config.program_budget

    def kv_high_water_bytes(self) -> int:
        return self.cache.bytes_for_blocks(self.allocator.high_water)

    def idle(self) -> bool:
        return not self.scheduler.waiting and not self.scheduler.running()
