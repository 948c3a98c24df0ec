"""Serving reliability: typed errors, admission control and weight
hot swap.

Counterpart of ``paddle2_tpu/serving/reliability.py``. Host-side and
deterministic; time enters only through the caller's ``now`` stamps.

* **Typed errors**: every way a request can fail is its own exception
  type. :class:`RequestRejected` subclasses are raised at submit time;
  :class:`DeadlineExceeded` and :class:`QueueFullError` also land on
  ``Sequence.error`` when a waiting request is shed, and
  ``Sequence.check`` raises them.
* **Admission control** (:class:`ReliabilityConfig`): a bounded queue
  with per-request priorities and deadlines. A full queue sheds the
  lowest-priority waiting request (ties: the youngest) for a
  strictly higher-priority arrival, and never touches admitted work.
  Expired deadlines are shed at each admission boundary.
  :class:`SLOConfig` opts the scheduler into a good/bad ledger.
* **Weight hot swap** (:class:`HotSwapController`): staged rollout of
  new weights across running engines, with rollback. The port's engine
  copies the new weights into the live parameters in place between
  decode steps, so a swap launches nothing new and changes no decode
  bucket.
* **Spans** (:func:`flight_record`): the one emitter of every serving
  span (scheduler, engine, router, hot swap), into the flight ring and
  the request-tracing plane at once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence as Seq

__all__ = ["ServingError", "RequestRejected", "QueueFullError",
           "PromptTooLongError", "DeadlineExceeded", "EngineFailedError",
           "WeightSwapError", "ReliabilityConfig", "SLOConfig",
           "HotSwapController", "flight_record"]


def flight_record(**fields) -> None:
    """One shared emitter for every serving flight-recorder span
    (``kind="serving"``): the scheduler, the engine, the router and the
    hot swap all go through here, so the span format has one owner.
    Spans that carry a clock stamp (``t=``) and a trace id (``tid=`` /
    ``tids=``) also go to the request-tracing plane
    (:func:`~paddle2_tpu_torch.observability.tracing.serving_span`), so
    the flight ring, the per-request traces and the chrome view share
    one set of instrumentation sites and event names. Each plane is one
    attribute load when it is off."""
    from ..distributed.fault_tolerance import flight_recorder
    from ..observability import tracing
    # None-valued fields (an unstamped clock, an untraced request) are
    # dropped rather than written as nulls in every dump
    fields = {k: v for k, v in fields.items() if v is not None}
    flight_recorder.record("serving", **fields)
    tracing.serving_span(fields)


# ---------------------------------------------------------------- errors
class ServingError(RuntimeError):
    """Base of every typed serving failure."""


class RequestRejected(ServingError, ValueError):
    """The request was refused at (or after) submission. Also a
    ``ValueError``, as in the JAX package."""


class QueueFullError(RequestRejected):
    """The bounded admission queue is full and no waiting request of a
    lower priority could be shed."""


class PromptTooLongError(RequestRejected):
    """``len(prompt) + max_new_tokens`` exceeds ``max_model_len``."""


class DeadlineExceeded(ServingError):
    """The request's deadline passed before it was admitted."""


class EngineFailedError(ServingError):
    """The engine died: it refuses all further work. Its unfinished
    sequences can be harvested with ``ServingEngine.recover_inflight``
    and adopted by another engine."""


class WeightSwapError(ServingError):
    """A hot-swap payload does not match the running model (count,
    shape or dtype): nothing is applied."""


# ------------------------------------------------------------------ SLOs
@dataclass
class SLOConfig:
    """Per-request service-level objectives, judged on the engine's
    clock when a request finishes: TTFT (arrival to first token), TPOT
    (mean seconds a generated token after the first) and end-to-end
    latency. ``None`` skips a dimension. A request is good when every
    set dimension meets its target; shed requests are bad. The burn
    rate is ``bad_fraction / (1 - availability_target)``."""
    ttft_target_s: Optional[float] = None
    tpot_target_s: Optional[float] = None
    e2e_target_s: Optional[float] = None
    availability_target: float = 0.99

    @property
    def error_budget(self) -> float:
        return max(1.0 - float(self.availability_target), 1e-9)


# ------------------------------------------------------ admission control
@dataclass
class ReliabilityConfig:
    """Admission control for one engine. ``max_queue_depth=None`` keeps
    the queue unbounded. Priorities are ints, higher is more important.
    ``default_deadline_s`` is relative to each request's ``arrival_t``.
    ``shed_on_full=False`` always rejects the arrival at a full queue."""
    max_queue_depth: Optional[int] = None
    default_priority: int = 0
    default_deadline_s: Optional[float] = None
    shed_on_full: bool = True
    slo: Optional[SLOConfig] = None

    def deadline_for(self, arrival_t: float,
                     deadline_s: Optional[float]) -> Optional[float]:
        d = self.default_deadline_s if deadline_s is None else deadline_s
        return None if d is None else float(arrival_t) + float(d)


# ------------------------------------------------------------- hot swap
class HotSwapController:
    """Staged rollout of new weights across running engines::

        ctl = HotSwapController(engines, new_weights)
        while ctl.stage_next(now) is not None:   # one engine a stage
            ...serve...
        # ctl.state == "committed", or after a bad canary:
        ctl.rollback(now)

    Each stage swaps one engine between its decode steps and keeps that
    engine's previous weights, so ``rollback`` is another swap, applied
    newest stage first. An engine that died before its stage is
    skipped. ``verify(engine) -> bool`` runs after every stage; False
    rolls every stage back (state ``"rolled_back"``).

    A swap copies into the engine's model in place, so the engines must
    serve distinct model objects: the first stage would swap every
    engine sharing one, and a shared model raises ``ValueError``. Each
    stage keeps a copy of its engine's previous weights on the device
    (the rollback payload) for as long as the controller lives.

    ``source`` (``{"session", "generation", "step"}``, the shape of the
    JAX package's ``CheckpointManager.swap_source()``) names the
    checkpoint lineage of the new weights: every hot-swap span (stage,
    commit, canary failed, rollback, and the engine's ``hot_swap`` span
    that reaches each in-flight request's trace) carries its restart
    generation."""

    def __init__(self, engines: Seq, new_weights,
                 verify: Optional[Callable] = None,
                 source: Optional[dict] = None):
        self.engines = list(engines)
        models = [id(e.runner.model) for e in self.engines]
        if len(set(models)) != len(models):
            raise ValueError("two engines serve one model object: a "
                             "staged swap would reach both at once")
        self.new_weights = new_weights
        self.verify = verify
        self.source = dict(source) if source else None
        self._prev = {}              # engine index -> pre-swap weights
        self.staged: List[int] = []
        self.state = "pending"       # rolling | committed | rolled_back

    def _record(self, event: str, **fields) -> None:
        # the lineage flattened into the span, so that a field scan of a
        # dump finds it
        if self.source is not None:
            fields.setdefault("generation", self.source.get("generation"))
            fields.setdefault("ckpt_step", self.source.get("step"))
            fields.setdefault("session", self.source.get("session"))
        flight_record(event=event, **fields)

    def _commit(self, now: float) -> None:
        """The one owner of the commit transition (idempotent)."""
        if self.state != "committed":
            self.state = "committed"
            self._record("hot_swap_commit", t=now,
                         stages=len(self.staged))

    def _done_staging(self) -> bool:
        return all(i in self._prev or getattr(e, "failed", False)
                   for i, e in enumerate(self.engines))

    def stage_next(self, now: float = 0.0) -> Optional[int]:
        """Swap the next alive, unstaged engine and return its index, or
        None when nothing is left to stage (state ``"committed"`` if any
        engine was staged)."""
        if self.state in ("committed", "rolled_back"):
            return None
        self.state = "rolling"
        for idx, eng in enumerate(self.engines):
            if idx in self._prev or getattr(eng, "failed", False):
                continue
            self._prev[idx] = eng.swap_weights(self.new_weights, now=now,
                                               source=self.source)
            self.staged.append(idx)
            self._record("hot_swap_stage", engine=idx, t=now,
                         stage=len(self.staged))
            if self.verify is not None and not self.verify(eng):
                self._record("hot_swap_canary_failed", engine=idx, t=now)
                self.rollback(now)
                return idx
            if self._done_staging():
                self._commit(now)
            return idx
        if self.staged:
            # a fleet that was wholly dead never reports a commit
            self._commit(now)
        return None

    def rollback(self, now: float = 0.0) -> List[int]:
        """Restore the previous weights on every staged engine that is
        still alive, newest stage first; returns their indices. A
        rollback before any stage changes nothing."""
        if not self.staged:
            return []
        rolled = []
        for idx in reversed(self.staged):
            eng = self.engines[idx]
            if getattr(eng, "failed", False):
                continue
            eng.swap_weights(self._prev[idx], now=now)
            rolled.append(idx)
        self.state = "rolled_back"
        self._record("hot_swap_rollback", t=now, engines=rolled)
        return rolled
