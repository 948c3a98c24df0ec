"""ServingEngine: continuous batching + paged KV over a GPT model.

Counterpart of ``paddle2_tpu/serving/engine.py``. Requests come in via
:meth:`ServingEngine.submit`; :meth:`~ServingEngine.admit_and_prefill`
prefills admitted requests (the flash kernel) into paged KV blocks;
every :meth:`~ServingEngine.decode_once` runs one decode step over the
whole running batch (the paged-decode kernels), padded to a
(batch, pages) bucket. Admissions and evictions happen between steps.
Greedy decoding; time enters only through the caller's ``now`` stamps.

The engine serves one live ``GPTForCausalLM`` whose parameter dtype
equals ``kv_dtype``, with the JAX engine's options:

* ``weight_only_int8`` / ``weight_only_lm_head`` quantize the block
  projections and the logits matmul to int8 weight-only
  (:mod:`paddle2_tpu_torch.quantization`), in place.
* ``enable_prefix_cache`` (``prefix_cache_blocks``): prompts that share
  a block-aligned prefix share its KV blocks, refcounted
  (:class:`~.block_cache.PrefixCache`). The prefill still computes the
  whole prompt; only the private tail is scattered.
* ``spec`` (:class:`~.spec.SpeculativeConfig`): n-gram self-drafting;
  the drafts ride as extra rows of the decode step, sharing their
  sequence's block table, and :func:`~.spec.accept_drafts` keeps the
  greedy stream.
* ``reliability`` (:class:`~.reliability.ReliabilityConfig`): a bounded
  queue with priority shedding, deadlines and an SLO ledger;
  :meth:`~ServingEngine.fail`, :meth:`~ServingEngine.recover_inflight`,
  :meth:`~ServingEngine.adopt` and :meth:`~ServingEngine.swap_weights`
  (with :class:`~.reliability.HotSwapController`).

Still raising ``NotImplementedError``, with their ROADMAP serving-queue
items: ``enable_kv_spill`` (the host tier, item 3) and loading a saved
artifact (item 6). The failover router and the serving simulator
(``serving/simulate.py``), the metrics, flight-recorder and tracing
hooks, and the chaos hooks are left out with them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence as Seq, Tuple

import numpy as np

from ..device import resolve_device
from ..quantization import quantize_lm_head, weight_only_quantize
from .block_cache import (BlockAllocator, PagedKVCache, PrefixCache,
                          blocks_for_tokens, GARBAGE_BLOCK)
from .model_runner import PagedGPTRunner
from .reliability import (EngineFailedError, PromptTooLongError,
                          QueueFullError, ReliabilityConfig,
                          RequestRejected)
from .scheduler import (ContinuousBatchingScheduler, Request,
                        SchedulerConfig, Sequence, SeqState)
from .spec import SpeculativeConfig, accept_drafts, ngram_draft

__all__ = ["EngineConfig", "ServingEngine"]

# option -> (value that means "off", ROADMAP serving-queue item)
_DEFERRED = {
    "enable_kv_spill": (False, "item 3 (KV spill / host tier)"),
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
    # admission control and load shedding (None: unbounded queue)
    reliability: Optional[ReliabilityConfig] = None
    # copy-on-write prefix caching; prefix_cache_blocks bounds the cache
    # (None: bounded only by reclaim under pressure)
    enable_prefix_cache: bool = False
    prefix_cache_blocks: Optional[int] = None
    # speculative decoding (None: off)
    spec: Optional[SpeculativeConfig] = None
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
        # a verify round brings k extra rows a sequence: the batch ladder
        # must cover the widest verify batch
        max_rows = self.config.max_batch
        if self.config.spec is not None:
            max_rows *= 1 + self.config.spec.num_draft_tokens
            if self.config.batch_buckets is not None and \
                    max(self.config.batch_buckets) < max_rows:
                raise ValueError(
                    f"batch_buckets {self.config.batch_buckets} cannot "
                    f"cover speculative verify rows (max_batch "
                    f"{self.config.max_batch} x (1 + "
                    f"{self.config.spec.num_draft_tokens} drafts) = "
                    f"{max_rows})")
        self.scheduler = ContinuousBatchingScheduler(SchedulerConfig(
            max_batch=self.config.max_batch,
            batch_buckets=(self.config.batch_buckets
                           or _pow2_ladder(1, max_rows)),
            page_buckets=(self.config.page_buckets
                          or _pow2_ladder(1, max_pages)),
            prefill_budget_tokens=self.config.prefill_budget_tokens,
            reliability=self.config.reliability),
            self.allocator)
        self.prefix_cache: Optional[PrefixCache] = None
        if self.config.enable_prefix_cache:
            self.prefix_cache = PrefixCache(
                self.allocator, max_blocks=self.config.prefix_cache_blocks)
            self.scheduler.prefix_cache = self.prefix_cache
        self.runner = PagedGPTRunner(model, cfg.num_heads, cfg.head_dim,
                                     split_pages=self.config.split_pages)
        self.spec_accepted = 0
        self.spec_rejected = 0
        self.hot_swaps = 0
        self._next_req_id = 0
        self._seqs: Dict[int, Sequence] = {}
        self.decode_steps = 0
        self.failed = False
        self.fail_reason: Optional[str] = None

    # -- request intake --------------------------------------------------
    def submit(self, prompt: Seq[int], max_new_tokens: int,
               arrival_t: float = 0.0, priority: Optional[int] = None,
               deadline_s: Optional[float] = None,
               trace_id: Optional[int] = None) -> int:
        """Submit one request; returns its id. Raises
        :class:`~.reliability.PromptTooLongError` when the request can
        never fit the model's context and
        :class:`~.reliability.QueueFullError` when the bounded queue is
        full and nothing of a lower priority can be shed. ``priority``
        and ``deadline_s`` (relative to ``arrival_t``) default from the
        engine's :class:`~.reliability.ReliabilityConfig`; ``trace_id``
        defaults to the request id."""
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
        rel = self.scheduler.reliability
        rid = self._next_req_id
        self._next_req_id += 1
        req = Request(rid, prompt, int(max_new_tokens), arrival_t,
                      priority=(rel.default_priority if priority is None
                                else int(priority)),
                      deadline_t=rel.deadline_for(arrival_t, deadline_s),
                      trace_id=rid if trace_id is None else trace_id)
        seq = Sequence(req, self.allocator)
        self.scheduler.submit(seq)      # may shed, may raise QueueFull
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
            self.fail(f"{type(e).__name__}: {e}")
            raise EngineFailedError(self.fail_reason) from e

    def fail(self, reason: str, now: float = 0.0) -> None:
        """Mark the engine dead (idempotent). Its pools count as lost;
        its host state (token logs, the scheduler) survives for
        :meth:`recover_inflight`. ``now`` (here, in :meth:`adopt` and
        :meth:`swap_weights`) is the caller's stamp, taken for the JAX
        engine's signature; the port records no spans."""
        if self.failed:
            return
        self.failed = True
        self.fail_reason = reason

    def recover_inflight(self) -> List[Sequence]:
        """Harvest every unfinished sequence of a failed engine, running
        ones first (admission order), then the waiting queue in order.
        Their tables died with the engine; each sequence's accepted
        tokens are in its token log, and prefilling that log again on
        another engine reproduces the lost KV."""
        if not self.failed:
            raise EngineFailedError(
                "recover_inflight is only valid on a failed engine")
        running = list(self.scheduler._running)
        waiting = [s for s in self.scheduler.waiting
                   if s.state is SeqState.WAITING]
        self.scheduler._running = []
        self.scheduler.waiting = []
        for s in running:
            # only admitted work counts as recovered: it is exempt from
            # shedding and deadlines on the adopter
            s.state = SeqState.WAITING
            s.recoveries += 1
        return running + waiting

    def adopt(self, seq: Sequence, now: Optional[float] = None) -> int:
        """Adopt a sequence recovered from a dead engine: a new request
        id here (``trace_id`` stays), a fresh table on this allocator.
        Admitted work requeues at the front, past the queue bound; a
        never-admitted arrival goes through the bounded ``submit`` and
        is shed with the typed error if refused. Returns the new id."""
        self._check_alive()
        rid = self._next_req_id
        self._next_req_id += 1
        seq.request.req_id = rid
        seq.rebind(self.allocator)
        self._seqs[rid] = seq
        if self.scheduler._in_flight(seq):
            self.scheduler.requeue_front(seq)
        else:
            try:
                self.scheduler.submit(seq)
            except QueueFullError as e:
                self.scheduler.mark_shed(seq, e)
        return rid

    # -- weight hot swap -------------------------------------------------
    def swap_weights(self, weights, now: float = 0.0) -> List:
        """Copy new weights into the running model between decode steps:
        ``weights`` is a model of the same structure, or a list of
        tensors as :meth:`PagedGPTRunner.weights` gives. A quantized
        engine takes a model quantized the same way (its int8 payloads
        and scales are the weights). Raises
        :class:`~.reliability.WeightSwapError`, changing nothing, on a
        mismatch. Returns the previous weights (the rollback payload)."""
        self._check_alive()
        tensors = weights
        if hasattr(weights, "state_dict"):      # a live model
            tensors = PagedGPTRunner.state_of(weights)
        prev = self.runner.swap_weights(tensors)
        self.hot_swaps += 1
        return prev

    # -- admission + prefill ---------------------------------------------
    def admit_and_prefill(self, now: float = 0.0) -> List[dict]:
        """One admission round: shed expired deadlines, admit FIFO
        within the prefill budget, prefill each admitted sequence (all
        its tokens: first admission or recompute after eviction),
        scatter its K/V into its blocks and take its next token. A
        prefix hit's shared blocks already hold their K/V and belong to
        every sharer, so only positions from ``prefix_cached_tokens`` on
        are scattered. Returns one info dict per admission."""
        self._check_alive()
        out = []
        admitted = self.scheduler.admit(now)
        for i, seq in enumerate(admitted):
            n = len(seq.tokens)
            try:
                tok, k_stack, v_stack = self._run(self.runner.prefill,
                                                  seq.tokens)
            except EngineFailedError:
                # the engine died: the round's unprefilled admissions wait
                # again, for recover_inflight to harvest
                for s in reversed(admitted[i:]):
                    self.scheduler.requeue_front(s)
                raise
            row = np.asarray(seq.table.blocks, np.int64)
            bs = self.cache.block_size
            start = min(seq.prefix_cached_tokens, n)
            PagedKVCache.scatter_prefill(self.cache.k, k_stack, row, n, bs,
                                         start=start)
            PagedKVCache.scatter_prefill(self.cache.v, v_stack, row, n, bs,
                                         start=start)
            seq.table.num_tokens = n
            seq.tokens.append(tok)
            if seq.first_token_t is None:
                seq.first_token_t = now
            self.scheduler.mark_running(seq)
            if seq.done:
                self.scheduler.finish(seq, now)
            out.append({"seq": seq, "prompt_tokens": n, "cached_tokens":
                        start, "padded_len": self.runner.prefill_padded_len(n)})
        return out

    # -- block-table integrity --------------------------------------------
    def _validate_tables(self, active: List[Sequence]) -> List[Sequence]:
        """Check every running table before a decode step reads it: ids
        in range, coverage of the cached tokens, no id twice in one
        table, and no block claimed by more tables (plus the prefix
        cache's hold) than its refcount covers. Violators are requeued
        to prefill again from their token logs, and the allocator is
        rebuilt from the surviving claims. Returns the still-running
        part of ``active``."""
        claimants: Dict[int, List[Sequence]] = {}
        bad: List[Sequence] = []
        for s in self.scheduler.running():
            ok = len(s.table.blocks) >= blocks_for_tokens(
                max(s.table.num_tokens, 1), self.config.block_size)
            seen = set()
            for b in s.table.blocks:
                if not 0 < b < self.config.num_blocks or b in seen:
                    ok = False
                    break
                seen.add(b)
                claimants.setdefault(b, []).append(s)
            if not ok:
                bad.append(s)
        held = (set(self.prefix_cache.held_blocks())
                if self.prefix_cache is not None else ())
        for b, owners in claimants.items():
            hold = 1 if b in held else 0
            if len(owners) + hold > self.allocator.refcount(b):
                # an alias cannot say which table was scribbled: every
                # claimant prefills again
                for s in owners:
                    if s not in bad:
                        bad.append(s)
        if not bad:
            return active
        for s in bad:
            self.scheduler.requeue_corrupt(s)
        survivors = [s.table.blocks for s in self.scheduler.running()]
        if self.prefix_cache is not None:
            survivors.append(self.prefix_cache.held_blocks())
        self.allocator.rebuild_free_list(survivors)
        return [s for s in active if s.state is SeqState.RUNNING]

    def _drafts(self, active: List[Sequence]) -> Dict[int, List[int]]:
        """Each sequence's drafts for this round (host, deterministic):
        up to k, and never more than its remaining budget less one."""
        spec = self.config.spec
        drafts: Dict[int, List[int]] = {}
        if spec is None:
            return drafts
        for s in active:
            room = s.request.max_new_tokens - len(s.generated)
            k = min(spec.num_draft_tokens, room - 1)
            if k < 1:
                continue
            d = (spec.draft_fn(s) if spec.draft_fn is not None
                 else ngram_draft(s.tokens, spec.ngram, k))
            d = [int(t) for t in d][:k]
            if d:
                drafts[id(s)] = d
        return drafts

    # -- one decode step -------------------------------------------------
    def decode_once(self, now: float = 0.0) -> Optional[dict]:
        """Run ONE decode step over every running sequence; with
        ``spec``, each sequence's drafts ride as extra rows and the
        accepted ones are emitted with the model's next token. Returns a
        step info dict, or None when nothing runs."""
        self._check_alive()
        active = self.scheduler.running()
        if not active:
            return None
        active = self._validate_tables(active)
        if not active:
            return None
        victims = self.scheduler.reserve_decode_slots(active)
        active = [s for s in active if s.state is SeqState.RUNNING]
        if not active:
            return None
        drafts = self._drafts(active)
        if drafts:
            # the step scatters every row's K/V: verify rows reserve
            # their slots up front; a rejected tail rolls back below
            slots = [1 + len(drafts.get(id(s), ())) for s in active]
            spec_victims = self.scheduler.reserve_decode_slots(active,
                                                               slots=slots)
            if spec_victims:
                victims += spec_victims
                active = [s for s in active if s.state is SeqState.RUNNING]
                live = {id(s) for s in active}
                drafts = {k: v for k, v in drafts.items() if k in live}
            if not active:
                return None
        rows = []                      # (seq, token, position)
        for s in active:
            p0 = s.num_cached
            rows.append((s, s.tokens[p0], p0))
            for i, d in enumerate(drafts.get(id(s), ())):
                rows.append((s, d, p0 + 1 + i))
        b_bucket = self.scheduler.config.batch_bucket(len(rows))
        p_bucket = self.scheduler.decode_bucket(active)[1]
        ids = np.zeros((b_bucket, 1), np.int64)
        positions = np.zeros((b_bucket,), np.int64)
        tables = np.full((b_bucket, p_bucket), GARBAGE_BLOCK, np.int32)
        for i, (s, tok_in, pos) in enumerate(rows):
            ids[i, 0] = tok_in
            positions[i] = pos
            tables[i] = s.table.padded(p_bucket)
        toks = self._run(self.runner.decode, self.cache, ids, positions,
                         tables)
        self.decode_steps += 1
        emitted_total = accepted_total = rejected_total = 0
        ri = 0
        for s in active:
            d = drafts.get(id(s), ())
            outs = [int(toks[ri + j]) for j in range(1 + len(d))]
            ri += 1 + len(d)
            if d:
                room = s.request.max_new_tokens - len(s.generated)
                accepted, bonus = accept_drafts(d, outs, room)
                emitted = accepted + [bonus]
                accepted_total += len(accepted)
                rejected_total += len(d) - len(accepted)
            else:
                emitted = outs
            for tok in emitted:
                s.table.append_slot()
                s.tokens.append(tok)
            if d:
                # the rejected tail's K/V lies past num_tokens and is
                # written again before any read; surplus blocks go back
                s.table.truncate()
            emitted_total += len(emitted)
            if s.done:
                self.scheduler.finish(s, now)
        self.spec_accepted += accepted_total
        self.spec_rejected += rejected_total
        return {"bucket": (b_bucket, p_bucket), "n_active": len(active),
                "rows": len(rows), "tokens": emitted_total,
                "evictions": len(victims), "spec_accepted": accepted_total,
                "spec_rejected": rejected_total}

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
