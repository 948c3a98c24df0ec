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
* **Admission control and load shedding** (``SchedulerConfig.
  reliability``): a bounded queue with per-request priorities and
  deadlines. A full queue sheds the lowest-priority waiting request
  (ties: the youngest) for a strictly higher-priority arrival; admitted
  work is never shed (eviction requeues it). Expired deadlines are shed
  at every admission boundary against the caller's clock. With an
  :class:`~.reliability.SLOConfig`, finished and shed requests feed a
  good/bad ledger (``slo_good``, ``slo_bad``, :meth:`slo_burn_rate`).
* **Prefix cache** (engine-installed): admission looks the prompt up,
  shares the cached blocks into the new table and counts only the
  missing blocks against the free list, then publishes the prompt's
  full blocks for later arrivals.

The metrics and tracing planes exist
(:mod:`paddle2_tpu_torch.observability`); the scheduler's metrics,
flight-recorder and tracing hooks come with the serving hooks (ROADMAP
queue 1 item 5).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional, Tuple

from .block_cache import (BlockAllocator, BlockTable, OutOfBlocksError,
                          blocks_for_tokens)
from .reliability import (DeadlineExceeded, QueueFullError,
                          ReliabilityConfig, ServingError)

__all__ = ["Request", "Sequence", "SeqState", "SchedulerConfig",
           "ContinuousBatchingScheduler"]


@dataclass
class Request:
    """One generation request as submitted by a client. ``priority``
    (higher is more important) and ``deadline_t`` (an absolute stamp on
    the caller's clock, None for none) drive admission control;
    ``trace_id`` is the id that survives a move to another engine."""
    req_id: int
    prompt: List[int]
    max_new_tokens: int
    arrival_t: float = 0.0
    priority: int = 0
    deadline_t: Optional[float] = None
    trace_id: Optional[int] = None


class SeqState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"
    SHED = "shed"


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
        self.recoveries = 0          # rebuilds after corruption or failover
        self.error: Optional[ServingError] = None   # set when shed
        # leading tokens whose KV came from the prefix cache at the last
        # admission (the engine scatters only past them)
        self.prefix_cached_tokens = 0

    def check(self) -> "Sequence":
        """Raise the typed error a shed recorded; returns self when
        healthy."""
        if self.error is not None:
            raise self.error
        return self

    def rebind(self, allocator: BlockAllocator) -> None:
        """Point the sequence at a fresh empty table on ``allocator``
        without releasing the old blocks (the old table cannot be
        trusted, or died with its engine). The token log survives;
        re-admission prefills it again."""
        self.table = BlockTable(allocator)
        self.prefix_cached_tokens = 0

    @property
    def req_id(self) -> int:
        return self.request.req_id

    @property
    def trace_id(self) -> Optional[int]:
        return self.request.trace_id

    @property
    def priority(self) -> int:
        return self.request.priority

    @property
    def deadline_t(self) -> Optional[float]:
        return self.request.deadline_t

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
    # admission control and load shedding (None: unbounded queue, no
    # deadlines)
    reliability: Optional[ReliabilityConfig] = None

    def __post_init__(self):
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

        admitted = sched.admit(now)         # -> seqs to prefill
        ...prefill each, mark_running...
        victims = sched.reserve_decode_slots()   # may evict
        ...run one decode step over sched.running()...
    """

    def __init__(self, config: SchedulerConfig, allocator: BlockAllocator):
        self.config = config
        self.allocator = allocator
        self.reliability = config.reliability or ReliabilityConfig()
        # the engine's prefix cache (None: no sharing)
        self.prefix_cache = None
        self.waiting: List[Sequence] = []
        self._running: List[Sequence] = []      # admission order
        self.finished: List[Sequence] = []
        self.shed: List[Sequence] = []
        self.total_evictions = 0
        self.total_shed = 0
        self.deadline_shed = 0
        # the SLO ledger (reliability.slo set): good and bad requests
        self.slo_good = 0
        self.slo_bad = 0

    def running(self) -> List[Sequence]:
        return list(self._running)

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    @staticmethod
    def _in_flight(seq: Sequence) -> bool:
        """True once a sequence was ever admitted (evicted or recovered
        work waiting to resume): never shed, and its deadline no longer
        applies."""
        return seq.evictions > 0 or seq.recoveries > 0

    # -- submission ------------------------------------------------------
    def submit(self, seq: Sequence) -> None:
        """Enqueue a request. At a full bounded queue, shed the
        lowest-priority waiting request (the youngest among equals) if
        its priority is strictly lower than the arrival's, else raise
        :class:`~.reliability.QueueFullError`. In-flight sequences are
        never candidates."""
        depth = self.reliability.max_queue_depth
        if depth is not None and len(self.waiting) >= depth:
            victim = None
            sheddable = [s for s in self.waiting if not self._in_flight(s)]
            if self.reliability.shed_on_full and sheddable:
                victim = min(reversed(sheddable), key=lambda s: s.priority)
            if victim is None or victim.priority >= seq.priority:
                raise QueueFullError(
                    f"admission queue full ({len(self.waiting)} >= "
                    f"{depth}) and no waiting request has priority < "
                    f"{seq.priority}")
            self._shed(victim, QueueFullError(
                f"shed (priority {victim.priority}) for arrival req "
                f"{seq.req_id} (priority {seq.priority})"))
        self.waiting.append(seq)

    def requeue_front(self, seq: Sequence) -> None:
        """Put a previously admitted sequence back at the FRONT of the
        queue, past the admission bound: preempted work resumes before
        new arrivals."""
        seq.state = SeqState.WAITING
        self.waiting.insert(0, seq)

    # -- load shedding ---------------------------------------------------
    def _shed(self, seq: Sequence, err: ServingError) -> None:
        self.waiting.remove(seq)
        self.mark_shed(seq, err)

    def mark_shed(self, seq: Sequence, err: ServingError) -> None:
        """Shed a sequence that is not in the waiting queue (an adopted
        arrival that the bounded queue refuses)."""
        seq.state = SeqState.SHED
        seq.error = err
        self.shed.append(seq)
        self.total_shed += 1
        if isinstance(err, DeadlineExceeded):
            self.deadline_shed += 1
        if self.reliability.slo is not None:
            self.slo_bad += 1

    def expire_deadlines(self, now: float) -> List[Sequence]:
        """Shed every never-admitted waiting sequence whose deadline lies
        before ``now`` (a deadline equal to ``now`` has not passed)."""
        expired = [s for s in self.waiting
                   if s.deadline_t is not None and s.deadline_t < now
                   and not self._in_flight(s)]
        for s in expired:
            self._shed(s, DeadlineExceeded(
                f"req {s.req_id} deadline {s.deadline_t:.6f} < now "
                f"{now:.6f} before admission"))
        return expired

    # -- admission -------------------------------------------------------
    def admit(self, now: float = 0.0) -> List[Sequence]:
        """Pick waiting sequences to prefill this round: FIFO, bounded
        by free decode slots, allocator coverage for the whole current
        token list plus the first generated token (less the blocks a
        prefix hit shares), and the prefill budget. Expired deadlines
        are shed first. Admitted sequences get their blocks here; the
        engine prefills them and marks them RUNNING. A request whose
        blocks cannot be covered blocks the queue (skipping it would
        starve long prompts)."""
        self.expire_deadlines(now)
        admitted: List[Sequence] = []
        budget = self.config.prefill_budget_tokens or float("inf")
        spent = 0
        bs = self.allocator.block_size
        while self.waiting:
            seq = self.waiting[0]
            if len(self._running) + len(admitted) >= self.config.max_batch:
                break
            need_tokens = len(seq.tokens)
            cached: List[int] = []
            if self.prefix_cache is not None and not seq.table.blocks:
                # look first: the hit commits only once admission is
                # certain, so a blocked head of line holds no references
                cached, _ = self.prefix_cache.lookup(seq.tokens,
                                                     share=False)
            need_blocks = blocks_for_tokens(need_tokens + 1, bs) - len(cached)
            if spent and spent + need_tokens > budget:
                break                      # budget spent: next round
            if not self.allocator.can_allocate(need_blocks):
                break                      # head-of-line until blocks free
            self.waiting.pop(0)
            seq.prefix_cached_tokens = 0
            shared: List[int] = []
            if self.prefix_cache is not None:
                shared, n_cached = self.prefix_cache.lookup(seq.tokens)
                if shared:
                    seq.table.attach_shared(shared)
                    seq.prefix_cached_tokens = n_cached
            try:
                seq.table.ensure_capacity(need_tokens + 1)
            except OutOfBlocksError:
                # can_allocate counted reclaimable cached blocks, and the
                # hit just pinned this request's own prefix among them:
                # undo the hit, keep the request at the head
                if shared:
                    self.allocator.free(shared)
                seq.table.blocks = []
                seq.prefix_cached_tokens = 0
                self.waiting.insert(0, seq)
                break
            if self.prefix_cache is not None:
                # publish the prompt's full blocks now: a sibling admitted
                # in the same round shares them, and every prefill of the
                # round scatters before any decode reads
                self.prefix_cache.insert(seq.request.prompt,
                                         seq.table.blocks,
                                         len(seq.request.prompt))
            spent += need_tokens
            admitted.append(seq)
        return admitted

    def mark_running(self, seq: Sequence) -> None:
        seq.state = SeqState.RUNNING
        self._running.append(seq)

    def reserve_decode_slots(self, seqs: Optional[List[Sequence]] = None,
                             slots: Optional[List[int]] = None
                             ) -> List[Sequence]:
        """Make sure every sequence in ``seqs`` (default: all running)
        has block slots for the tokens the next decode step appends,
        ``slots[i]`` for sequence ``i`` (default 1; a verify round
        reserves ``1 + len(drafts)``), evicting LIFO on exhaustion.
        Returns the evicted sequences (already requeued at the front)."""
        victims: List[Sequence] = []
        todo = list(self._running) if seqs is None else list(seqs)
        want = [1] * len(todo) if slots is None else \
            [max(1, int(s)) for s in slots]
        if len(want) != len(todo):
            raise ValueError("slots must parallel seqs")
        i = 0
        while i < len(todo):
            seq = todo[i]
            if seq.state is not SeqState.RUNNING:
                i += 1      # evicted while reserving an earlier seq
                continue
            try:
                seq.table.ensure_capacity(seq.num_cached + want[i])
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

    def requeue_corrupt(self, seq: Sequence) -> None:
        """Pull a RUNNING sequence whose block table cannot be trusted:
        the table is rebound, not released (freeing corrupt ids could
        free a live block twice). The caller rebuilds the allocator from
        the surviving tables."""
        self._running.remove(seq)
        seq.rebind(self.allocator)
        seq.recoveries += 1
        self.requeue_front(seq)

    def finish(self, seq: Sequence, now: float = 0.0) -> None:
        self._running.remove(seq)
        seq.table.release()
        seq.state = SeqState.FINISHED
        seq.finish_t = now
        self.finished.append(seq)
        self._note_slo(seq, now)

    # -- SLO ledger ------------------------------------------------------
    def _note_slo(self, seq: Sequence, now: float) -> None:
        """Judge one finished request against the SLO targets (TTFT,
        TPOT, end to end) on the caller's clock."""
        slo = self.reliability.slo
        if slo is None:
            return
        arrival = seq.request.arrival_t
        first = seq.first_token_t if seq.first_token_t is not None else now
        gen = len(seq.generated)
        dims = {"ttft": (slo.ttft_target_s, first - arrival),
                "tpot": (slo.tpot_target_s,
                         (now - first) / (gen - 1) if gen > 1 else 0.0),
                "e2e": (slo.e2e_target_s, now - arrival)}
        good = all(value <= target for target, value in dims.values()
                   if target is not None)
        if good:
            self.slo_good += 1
        else:
            self.slo_bad += 1

    def slo_burn_rate(self) -> float:
        """``bad_fraction / error_budget`` (0 before any verdict; 0
        without an SLO)."""
        slo = self.reliability.slo
        total = self.slo_good + self.slo_bad
        if slo is None or not total:
            return 0.0
        return (self.slo_bad / total) / slo.error_budget

    def decode_bucket(self, seqs: Optional[List[Sequence]] = None
                      ) -> Tuple[int, int]:
        """(batch_bucket, page_bucket) of the next decode step over
        ``seqs`` (default: all running)."""
        seqs = self._running if seqs is None else seqs
        pages = max((len(s.table.blocks) for s in seqs), default=1)
        return (self.config.batch_bucket(max(len(seqs), 1)),
                self.config.page_bucket(max(pages, 1)))
