"""Always-on metrics plane: typed registry + per-rank JSONL stream.

The counterpart of ``paddle2_tpu/observability/metrics.py``, with the
same names, the same JSONL schema and the same file names
(``PADDLE_METRICS_DIR/metrics_rank_N.jsonl`` and its ``.prom``
sibling), so the stdlib-only ``tools/perf_doctor`` of either package
reads a stream that either package wrote. The module is stdlib-only.

It answers "where does the step time go while the job lives": cheap,
structured, always-on telemetry that :mod:`paddle2_tpu_torch.tools.
perf_doctor` reads. Three metric kinds, Prometheus-shaped:

* :class:`Counter` — monotonically increasing totals (steps, skipped
  AMP steps, retries);
* :class:`Gauge` — last-written values (the AMP loss scale);
* :class:`Histogram` — bucketed distributions (save seconds).

All three carry labels (``inc("collectives_total", op="all_reduce")``).

**Step windows.** The plane slices wall time into consecutive *step
windows*: everything between two ``step_end()`` calls belongs to one
step, and instrumented spans inside the window (:func:`phase`) classify
it — ``input`` (dataloader wait), ``compute`` (the step's forward,
backward and update), ``collective`` (eager collective dispatch and
wait). The remainder is ``host`` (python bookkeeping). Because ``host``
is the residual and phases attribute time to the INNERMOST open phase
only, the four components sum to the recorded total *exactly*. Every
step window is written as one ``{"type": "step", ...}`` record in the
JSONL stream. The clock is the host's (``time.perf_counter``): on a
CUDA card a phase measures the host's enqueue, not the device's work,
unless the caller synchronises inside it, as the JAX package's phases
measure its dispatch.

**Overhead contract** (the JAX package's): when the plane is off every
hook is ONE module-attribute load (``if _ACTIVE is None: return``) — no
locks, no allocation, no device syncs. When on, an event is a dict
upsert on preallocated structures; writes are buffered and flushed
every ``PADDLE_METRICS_FLUSH_STEPS`` windows (never inside a phase).
``events_recorded`` counts every event, and :data:`EVENT_COST_OPS` is
the JAX package's nominal host cost of one, kept so that a gate can
multiply the two without a wall clock.

Enable by setting ``PADDLE_METRICS_DIR`` (auto-enabled at import on a
worker that also has ``PADDLE_TRAINER_ID``, as in the JAX package) or
explicitly::

    from paddle2_tpu_torch.observability import metrics
    metrics.enable("/tmp/metrics")
    ... train ...
    metrics.flush()              # JSONL snapshot + step records
    metrics.export_prometheus()  # textfile-collector .prom sibling
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from contextlib import nullcontext
from typing import Any, Dict, List, Optional, Tuple

METRICS_DIR_ENV = "PADDLE_METRICS_DIR"
METRICS_FLUSH_ENV = "PADDLE_METRICS_FLUSH_STEPS"

_DEFAULT_FLUSH_STEPS = 50

# hard cap on records held across failed flushes: a persistently
# unwritable metrics dir (disk full, dir deleted) must never grow the
# buffer — and the training process — without bound
_MAX_BUFFER_RECORDS = 10_000

# the JAX package's nominal host-op-equivalent cost of ONE metric
# event (a dict upsert + float add + tuple hash), charged as generic
# "ops" so that an overhead gate can compare events-per-step x cost
# against step FLOPs without wall clocks; a nominal figure, not a
# measurement of this port
EVENT_COST_OPS = 5000.0

# step-window phase names (everything else lands in the "host" residual)
PHASES = ("input", "compute", "collective")

_HIST_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, float("inf"))


def process_rank() -> int:
    """This process's rank: ``PADDLE_TRAINER_ID``, else ``RANK``, else
    that of an initialised ``torch.distributed`` group, else 0 (the JAX
    package's ``distributed.env.get_rank`` order, with torch's group in
    place of JAX's process index)."""
    v = os.environ.get("PADDLE_TRAINER_ID") or os.environ.get("RANK")
    if v is not None:
        try:
            return int(v)
        except ValueError:
            return 0
    import sys
    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_str: str = ""):
        self.name = name
        self.help = help_str
        self.values: Dict[Tuple, float] = {}

    def labels_list(self) -> List[Tuple[Tuple, float]]:
        return sorted(self.values.items())

    def snapshot(self) -> Dict[str, float]:
        return {_fmt_labels(k): v for k, v in self.labels_list()}


class Counter(_Metric):
    """Monotonic total. ``inc`` with negative amounts raises."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = _label_key(labels)
        self.values[key] = self.values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return self.values.get(_label_key(labels), 0.0)


class Gauge(_Metric):
    """Last-written value."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self.values[_label_key(labels)] = float(value)

    def value(self, **labels) -> float:
        return self.values.get(_label_key(labels), 0.0)


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics: each bucket
    counts observations <= its upper bound; +Inf == count)."""

    kind = "histogram"

    def __init__(self, name: str, help_str: str = "",
                 buckets: Tuple[float, ...] = _HIST_BUCKETS):
        super().__init__(name, help_str)
        self.buckets = tuple(buckets)
        if self.buckets[-1] != float("inf"):
            self.buckets = self.buckets + (float("inf"),)
        # per-labelset: [counts per bucket], sum, count
        self.series: Dict[Tuple, Dict[str, Any]] = {}

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        s = self.series.get(key)
        if s is None:
            s = {"counts": [0] * len(self.buckets), "sum": 0.0,
                 "count": 0}
            self.series[key] = s
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                s["counts"][i] += 1
        s["sum"] += float(value)
        s["count"] += 1

    def labels_list(self):
        return sorted(self.series.items())

    def snapshot(self) -> Dict[str, Any]:
        # per-bucket CUMULATIVE counts ride the JSONL snapshot too (the
        # Prometheus export always had them): sum/count alone cannot
        # reconstruct percentiles downstream, which left perf_doctor
        # without p50/p99 lanes. The +Inf upper bound serializes as
        # None — a bare Infinity literal breaks strict-JSON consumers.
        return {_fmt_labels(k): {
            "sum": s["sum"], "count": s["count"],
            "buckets": [None if ub == float("inf") else ub
                        for ub in self.buckets],
            "counts": list(s["counts"]),
        } for k, s in self.labels_list()}


def _fmt_labels(key: Tuple) -> str:
    if not key:
        return ""
    return ",".join(f'{k}="{v}"' for k, v in key)


# Reusable no-op context for disabled-plane phase() calls.
_NULL_PHASE = nullcontext()


class _Phase:
    __slots__ = ("_plane", "_name")

    def __init__(self, plane: "MetricsPlane", name: str):
        self._plane = plane
        self._name = name

    def __enter__(self):
        self._plane.phase_enter(self._name)
        return self

    def __exit__(self, *exc):
        self._plane.phase_exit()
        return False


class MetricsPlane:
    """Per-rank metric registry + step-window clock + JSONL writer."""

    def __init__(self, directory: str, rank: Optional[int] = None,
                 flush_steps: Optional[int] = None):
        if rank is None:
            rank = process_rank()
        self.dir = directory
        self.rank = int(rank)
        if flush_steps is None:
            try:
                flush_steps = int(os.environ.get(
                    METRICS_FLUSH_ENV, _DEFAULT_FLUSH_STEPS))
            except ValueError:
                flush_steps = _DEFAULT_FLUSH_STEPS
        self.flush_steps = max(1, int(flush_steps))
        self._metrics: Dict[str, _Metric] = {}
        self._mu = threading.RLock()
        self._buffer: List[str] = []
        # step-window state: wall-clock origin of the current window,
        # the innermost-phase stack, and per-phase accumulators
        self._win_t0 = time.perf_counter()
        self._stack: List[List] = []      # [name, segment_start]
        self._phases: Dict[str, float] = {}
        self._step_no = 0
        # deterministic overhead accounting: every metric event (inc /
        # set / observe / phase pair / step record) bumps this — the
        # a gate multiplies by EVENT_COST_OPS instead of timing
        self.events_recorded = 0

    # -- registry --------------------------------------------------------
    def _get(self, name: str, cls, help_str: str = "") -> _Metric:
        m = self._metrics.get(name)
        if m is None:
            with self._mu:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(name, help_str)
                    self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, not {cls.kind}")
        return m

    def counter(self, name: str, help_str: str = "") -> Counter:
        return self._get(name, Counter, help_str)

    def gauge(self, name: str, help_str: str = "") -> Gauge:
        return self._get(name, Gauge, help_str)

    def histogram(self, name: str, help_str: str = "") -> Histogram:
        return self._get(name, Histogram, help_str)

    def inc(self, name: str, amount: float = 1.0, **labels) -> None:
        # _mu (reentrant) serializes writers against the flush/snapshot
        # iteration in step_end/export: background threads (health
        # prober, watchdog) inc concurrently with the training thread,
        # and an unguarded label upsert during a snapshot's
        # sorted(values.items()) would raise out of step_end
        with self._mu:
            self.events_recorded += 1
            self.counter(name).inc(amount, **labels)

    def set_gauge(self, name: str, value: float, **labels) -> None:
        with self._mu:
            self.events_recorded += 1
            self.gauge(name).set(value, **labels)

    def observe(self, name: str, value: float, **labels) -> None:
        with self._mu:
            self.events_recorded += 1
            self.histogram(name).observe(value, **labels)

    # -- step windows ----------------------------------------------------
    def phase(self, name: str) -> _Phase:
        return _Phase(self, name)

    def phase_enter(self, name: str) -> None:
        """Open a phase span. Time is attributed to the INNERMOST open
        phase only (an eager collective inside the compute span moves
        its wall time from compute to collective), which keeps the
        per-phase spans disjoint — the exact-sum invariant depends on
        it."""
        now = time.perf_counter()
        with self._mu:
            if self._stack:
                parent = self._stack[-1]
                self._phases[parent[0]] = self._phases.get(
                    parent[0], 0.0) + (now - parent[1])
                # reset the parent's segment origin: its pre-child span
                # is credited, so an abnormal close (step_end draining
                # a still-open stack) must not re-credit it
                parent[1] = now
            self._stack.append([name, now])

    def phase_exit(self) -> None:
        now = time.perf_counter()
        with self._mu:
            if not self._stack:
                return
            name, seg = self._stack.pop()
            self._phases[name] = self._phases.get(name, 0.0) + (now - seg)
            if self._stack:
                self._stack[-1][1] = now
            self.events_recorded += 1

    def step_end(self, tokens: Optional[int] = None,
                 samples: Optional[int] = None,
                 loss_scale: Optional[float] = None,
                 **extra) -> Dict[str, Any]:
        """Close the current step window and open the next one. Writes
        one ``{"type": "step"}`` record whose four components sum to
        ``total_s`` exactly (``host_s`` is the residual)."""
        now = time.perf_counter()
        with self._mu:
            # close any phase still open (defensive: an exception path
            # that skipped a phase_exit must not leak into forever).
            # Only the INNERMOST frame holds unattributed time: enter
            # and exit both reset the parent's segment origin when a
            # child takes over, so outer frames are fully credited
            if self._stack:
                name, seg = self._stack[-1]
                self._phases[name] = self._phases.get(
                    name, 0.0) + (now - seg)
                self._stack = []
            total = now - self._win_t0
            comp = {p: self._phases.get(p, 0.0) for p in PHASES}
            other = sum(v for k, v in self._phases.items()
                        if k not in PHASES)
            host = total - sum(comp.values()) - other
            rec: Dict[str, Any] = {
                "type": "step", "t": time.time(), "rank": self.rank,
                "step": self._step_no, "total_s": total,
                "input_wait_s": comp["input"],
                "compute_s": comp["compute"],
                "collective_s": comp["collective"],
                "host_s": host + other,
            }
            if tokens is not None:
                rec["tokens"] = int(tokens)
                if total > 0:
                    rec["tokens_per_s"] = tokens / total
            if samples is not None:
                rec["samples"] = int(samples)
            if loss_scale is not None:
                rec["loss_scale"] = float(loss_scale)
            rec.update(extra)
            self._buffer.append(json.dumps(rec))
            self._step_no += 1
            self._phases = {}
            self._win_t0 = time.perf_counter()
            self.events_recorded += 1
            self.inc("steps_total")
            if self._step_no % self.flush_steps == 0:
                self._flush_locked(snapshot=True)
        return rec

    def step_window_reset(self) -> None:
        """Re-open the step window NOW, discarding time accrued since
        the last ``step_end``. Training loops call this at epoch
        boundaries: eval passes, callbacks, and checkpoint saves run
        between the last step of epoch N and the first step of epoch
        N+1, and without a reset all of it lands in that first step's
        ``host_s`` — a many-second outlier that corrupts perf_doctor
        means (warmup exclusion only drops the first record per RANK,
        not per epoch). No record is written; open phases are
        discarded with the window."""
        with self._mu:
            self._phases = {}
            self._stack = []
            self._win_t0 = time.perf_counter()

    @property
    def step_no(self) -> int:
        return self._step_no

    # -- output ----------------------------------------------------------
    @property
    def stream_path(self) -> str:
        return os.path.join(self.dir, f"metrics_rank_{self.rank}.jsonl")

    @property
    def prom_path(self) -> str:
        return os.path.join(self.dir, f"metrics_rank_{self.rank}.prom")

    def snapshot(self) -> Dict[str, Any]:
        """Every registered metric's current values, JSON-shaped."""
        with self._mu:
            out: Dict[str, Any] = {"counters": {}, "gauges": {},
                                   "histograms": {}}
            for name, m in sorted(self._metrics.items()):
                slot = {"counter": "counters", "gauge": "gauges",
                        "histogram": "histograms"}[m.kind]
                out[slot][name] = m.snapshot()
            return out

    def _flush_locked(self, snapshot: bool = False) -> None:
        if snapshot:
            rec = {"type": "metrics", "t": time.time(),
                   "rank": self.rank, "step": self._step_no}
            rec.update(self.snapshot())
            self._buffer.append(json.dumps(rec))
        if not self._buffer:
            return
        lines, self._buffer = self._buffer, []
        try:
            os.makedirs(self.dir, exist_ok=True)
            with open(self.stream_path, "a") as f:
                f.write("\n".join(lines) + "\n")
        except OSError:
            # telemetry is best-effort, never a failure source — keep
            # the records for the next flush attempt, bounded (oldest
            # dropped first)
            self._buffer = (lines + self._buffer)[-_MAX_BUFFER_RECORDS:]

    def flush(self, snapshot: bool = True) -> None:
        with self._mu:
            self._flush_locked(snapshot=snapshot)

    def export_prometheus(self, path: Optional[str] = None) -> str:
        """Write the registry in Prometheus text exposition format (the
        node_exporter textfile-collector contract) and return the
        path."""
        with self._mu:
            lines: List[str] = []
            for name, m in sorted(self._metrics.items()):
                if m.help:
                    lines.append(f"# HELP {name} {m.help}")
                lines.append(f"# TYPE {name} {m.kind}")
                if isinstance(m, Histogram):
                    for key, s in m.labels_list():
                        base = _fmt_labels(key)
                        cum = 0
                        for ub, c in zip(m.buckets, s["counts"]):
                            cum = c
                            le = "+Inf" if ub == float("inf") else repr(ub)
                            lbl = (base + "," if base else "") + \
                                f'le="{le}"'
                            lines.append(
                                f"{name}_bucket{{{lbl}}} {cum}")
                        lines.append(
                            f"{name}_sum{{{base}}} {s['sum']}"
                            if base else f"{name}_sum {s['sum']}")
                        lines.append(
                            f"{name}_count{{{base}}} {s['count']}"
                            if base else f"{name}_count {s['count']}")
                else:
                    for key, v in m.labels_list():
                        base = _fmt_labels(key)
                        lines.append(f"{name}{{{base}}} {v}"
                                     if base else f"{name} {v}")
            text = "\n".join(lines) + "\n"
        out = path or self.prom_path
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        tmp = out + ".tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, out)
        return out


# ---------------------------------------------------------------- module
_ACTIVE: Optional[MetricsPlane] = None
_atexit_installed = False


def enable(directory: Optional[str] = None, rank: Optional[int] = None,
           flush_steps: Optional[int] = None) -> MetricsPlane:
    """Turn the metrics plane on for this process. ``directory``
    defaults to ``PADDLE_METRICS_DIR``. Idempotent per directory."""
    global _ACTIVE, _atexit_installed
    d = directory or os.environ.get(METRICS_DIR_ENV)
    if not d:
        raise ValueError(
            f"metrics plane needs a directory: pass one or set "
            f"{METRICS_DIR_ENV}")
    prev = _ACTIVE
    if prev is not None:
        if prev.dir == d and (rank is None or rank == prev.rank):
            # idempotent: keep counters + buffer, but honor an explicit
            # flush cadence — the auto-enabled plane defaults to a lazy
            # cadence, and a caller asking for flush_steps=1 wants
            # per-step durability, not the old setting.
            if flush_steps is not None:
                # same clamp as the constructor: flush_steps=0 must
                # mean "every step", not a ZeroDivisionError in step_end
                prev.flush_steps = max(1, int(flush_steps))
            return prev
        try:
            prev.flush()           # don't drop the old plane's records
        except Exception:
            pass
    _ACTIVE = MetricsPlane(d, rank=rank, flush_steps=flush_steps)
    if not _atexit_installed:
        _atexit_installed = True
        atexit.register(_atexit_flush)
    return _ACTIVE


def disable() -> None:
    """Flush and stop recording."""
    global _ACTIVE
    pl, _ACTIVE = _ACTIVE, None
    if pl is not None:
        try:
            pl.flush()
        except Exception:
            pass


def active() -> Optional[MetricsPlane]:
    return _ACTIVE


def _atexit_flush() -> None:
    pl = _ACTIVE
    if pl is not None:
        try:
            pl.flush()
            pl.export_prometheus()
        except Exception:
            pass


# -- hot-path hooks (the one-attribute-load contract) --------------------
def inc(name: str, amount: float = 1.0, **labels) -> None:
    pl = _ACTIVE
    if pl is None:
        return
    pl.inc(name, amount, **labels)


def set_gauge(name: str, value: float, **labels) -> None:
    pl = _ACTIVE
    if pl is None:
        return
    pl.set_gauge(name, value, **labels)


def observe(name: str, value: float, **labels) -> None:
    pl = _ACTIVE
    if pl is None:
        return
    pl.observe(name, value, **labels)


def phase(name: str):
    pl = _ACTIVE
    if pl is None:
        return _NULL_PHASE
    return pl.phase(name)


def step_end(**kwargs) -> Optional[Dict[str, Any]]:
    pl = _ACTIVE
    if pl is None:
        return None
    return pl.step_end(**kwargs)


def flush() -> None:
    pl = _ACTIVE
    if pl is not None:
        pl.flush()


def export_prometheus(path: Optional[str] = None) -> Optional[str]:
    pl = _ACTIVE
    if pl is None:
        return None
    return pl.export_prometheus(path)


# auto-enable: the launcher (or operator) sets PADDLE_METRICS_DIR for
# the gang; the PADDLE_TRAINER_ID guard keeps an operator shell running
# perf_doctor against the same env from masquerading as rank 0
if os.environ.get(METRICS_DIR_ENV) and os.environ.get("PADDLE_TRAINER_ID"):
    try:
        enable(os.environ[METRICS_DIR_ENV])
    except (OSError, ValueError):
        pass


__all__ = ["Counter", "Gauge", "Histogram", "MetricsPlane", "enable",
           "disable", "active", "inc", "set_gauge", "observe", "phase",
           "step_end", "flush", "export_prometheus", "METRICS_DIR_ENV",
           "METRICS_FLUSH_ENV", "EVENT_COST_OPS", "PHASES", "process_rank"]
