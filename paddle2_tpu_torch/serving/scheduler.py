"""Continuous-batching scheduler: admit and evict at every decode step.

Counterpart of ``paddle2_tpu/serving/scheduler.py`` (the Orca
iteration-level scheduling model). The decode batch is formed anew at
every step: finished sequences leave at once, and waiting requests join
as soon as a batch slot and KV blocks are free. All host-side and
deterministic:

* **Admission** (FIFO + prefill budget): waiting requests are admitted
  oldest first while (a) a decode slot is free, (b) the allocator can
  cover their blocks and (c) the round's prefill token budget lasts.
* **Preemption by eviction** (LIFO victim): when a running sequence
  needs a block and the free list is empty, the newest running sequence
  is evicted — its blocks freed, its state back to WAITING at the FRONT
  of the queue, to re-prefill prompt + generated tokens on re-admission.
* **Bucketed shapes**: the decode batch is padded to (batch, pages)
  buckets, so the count of distinct decode shapes is bounded by
  ``len(batch_buckets) * len(page_buckets)``.

Admission control and load shedding (``reliability=``), the prefix
cache and the metrics/flight-recorder/tracing hooks wait for the
serving queue in ROADMAP.md.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional, Tuple

from .block_cache import (BlockAllocator, BlockTable, OutOfBlocksError,
                          blocks_for_tokens)

__all__ = ["Request", "Sequence", "SeqState", "SchedulerConfig",
           "ContinuousBatchingScheduler"]


@dataclass
class Request:
    """One generation request as submitted by a client."""
    req_id: int
    prompt: List[int]
    max_new_tokens: int
    arrival_t: float = 0.0


class SeqState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"


class Sequence:
    """Scheduler-side state of one request."""

    def __init__(self, request: Request, allocator: BlockAllocator):
        self.request = request
        self.tokens: List[int] = list(request.prompt)
        self.table = BlockTable(allocator)
        self.state = SeqState.WAITING
        self.first_token_t: Optional[float] = None
        self.finish_t: Optional[float] = None
        self.evictions = 0

    @property
    def req_id(self) -> int:
        return self.request.req_id

    @property
    def num_cached(self) -> int:
        return self.table.num_tokens

    @property
    def generated(self) -> List[int]:
        return self.tokens[len(self.request.prompt):]

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.request.max_new_tokens

    def __repr__(self):
        return (f"Sequence(req={self.req_id}, state={self.state.value}, "
                f"tokens={len(self.tokens)}, cached={self.num_cached})")


@dataclass
class SchedulerConfig:
    max_batch: int = 8
    # padded shapes key the decode steps, so these two ladders bound
    # the count of distinct decode shapes
    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8)
    page_buckets: Tuple[int, ...] = (2, 4, 8, 16)
    # max prompt tokens admitted per scheduling round (0 = unlimited)
    prefill_budget_tokens: int = 512
    reliability: Optional[object] = None

    def __post_init__(self):
        if self.reliability is not None:
            raise NotImplementedError(
                "admission control / load shedding is not ported yet "
                "(ROADMAP serving queue, item 5)")
        self.batch_buckets = tuple(sorted(set(self.batch_buckets)))
        self.page_buckets = tuple(sorted(set(self.page_buckets)))
        if self.batch_buckets[-1] < self.max_batch:
            raise ValueError("largest batch bucket must cover max_batch")

    @property
    def program_budget(self) -> int:
        return len(self.batch_buckets) * len(self.page_buckets)

    def batch_bucket(self, n: int) -> int:
        for b in self.batch_buckets:
            if n <= b:
                return b
        raise ValueError(f"batch {n} exceeds largest bucket "
                         f"{self.batch_buckets[-1]}")

    def page_bucket(self, n: int) -> int:
        for p in self.page_buckets:
            if n <= p:
                return p
        raise ValueError(f"{n} pages exceed largest bucket "
                         f"{self.page_buckets[-1]}")


class ContinuousBatchingScheduler:
    """Host scheduling core; the engine owns the compute. The engine
    drives it as::

        admitted = sched.admit()            # -> seqs to prefill
        ...prefill each, mark_running...
        victims = sched.reserve_decode_slots()   # may evict
        ...run one decode step over sched.running()...
    """

    def __init__(self, config: SchedulerConfig, allocator: BlockAllocator):
        self.config = config
        self.allocator = allocator
        self.waiting: List[Sequence] = []
        self._running: List[Sequence] = []      # admission order
        self.total_evictions = 0

    def running(self) -> List[Sequence]:
        return list(self._running)

    def submit(self, seq: Sequence) -> None:
        self.waiting.append(seq)

    def requeue_front(self, seq: Sequence) -> None:
        """Put a previously admitted sequence back at the FRONT of the
        queue: preempted work resumes before new arrivals."""
        seq.state = SeqState.WAITING
        self.waiting.insert(0, seq)

    def admit(self) -> List[Sequence]:
        """Pick waiting sequences to prefill this round: FIFO, bounded by
        free decode slots, allocator coverage for the whole current
        token list plus the first generated token, and the prefill
        budget. Admitted sequences get their blocks here; the engine
        prefills them and marks them RUNNING. A request whose blocks
        cannot be covered blocks the queue (FIFO — skipping it would
        starve long prompts)."""
        admitted: List[Sequence] = []
        budget = self.config.prefill_budget_tokens or float("inf")
        spent = 0
        while self.waiting:
            seq = self.waiting[0]
            if len(self._running) + len(admitted) >= self.config.max_batch:
                break
            need_tokens = len(seq.tokens)
            need_blocks = blocks_for_tokens(need_tokens + 1,
                                            self.allocator.block_size)
            if spent and spent + need_tokens > budget:
                break                      # budget spent: next round
            if not self.allocator.can_allocate(need_blocks):
                break                      # head-of-line until blocks free
            self.waiting.pop(0)
            seq.table.ensure_capacity(need_tokens + 1)
            spent += need_tokens
            admitted.append(seq)
        return admitted

    def mark_running(self, seq: Sequence) -> None:
        seq.state = SeqState.RUNNING
        self._running.append(seq)

    def reserve_decode_slots(self, seqs: Optional[List[Sequence]] = None
                             ) -> List[Sequence]:
        """Make sure every sequence in ``seqs`` (default: all running)
        has a block slot for the token the next decode step appends,
        evicting LIFO on exhaustion. Returns the evicted sequences
        (already requeued at the front)."""
        victims: List[Sequence] = []
        todo = list(self._running) if seqs is None else list(seqs)
        i = 0
        while i < len(todo):
            seq = todo[i]
            if seq.state is not SeqState.RUNNING:
                i += 1      # evicted while reserving an earlier seq
                continue
            try:
                seq.table.ensure_capacity(seq.num_cached + 1)
                i += 1
            except OutOfBlocksError:
                victim = self._running[-1]
                self._evict(victim)
                victims.append(victim)
        return victims

    def _evict(self, seq: Sequence) -> None:
        self._running.remove(seq)
        seq.table.release()
        seq.evictions += 1
        self.total_evictions += 1
        self.requeue_front(seq)

    def finish(self, seq: Sequence, now: float = 0.0) -> None:
        self._running.remove(seq)
        seq.table.release()
        seq.state = SeqState.FINISHED
        seq.finish_t = now

    def decode_bucket(self, seqs: Optional[List[Sequence]] = None
                      ) -> Tuple[int, int]:
        """(batch_bucket, page_bucket) of the next decode step over
        ``seqs`` (default: all running)."""
        seqs = self._running if seqs is None else seqs
        pages = max((len(s.table.blocks) for s in seqs), default=1)
        return (self.config.batch_bucket(max(len(seqs), 1)),
                self.config.page_bucket(max(pages, 1)))
