"""Request-lifecycle tracing: per-request span trees for serving, with
an exact tail-latency decomposition.

The counterpart of ``paddle2_tpu/observability/tracing.py``, with the
same names and the same record format (``PADDLE_TRACE_DIR/
trace_rank_N.jsonl``, ``{"type": "span", "event": ..., "tid": ...,
"t": ...}``), so the ``serve_doctor`` of either package reads a stream
that either package wrote. The module is stdlib-only.

The serving stack records lifecycle events keyed by a stable
per-request **trace id** — submit, admission, prefill, per-round
decode, eviction/requeue, failover-adopt, hot-swap pause, finish — and
the decomposition pass (:func:`decompose`) turns each finished
request's event list into the component split the ``serve_doctor`` CLI
attributes tails with::

    queue_wait + prefill + decode_compute + eviction_stall
        + failover_stall + swap_stall + spill_fetch + migration_stall
        + host == e2e latency

``host`` is the residual (scheduling gaps), the rule the metrics
plane's step windows use. The sum is EXACT, not to a tolerance: the
decomposition does its interval arithmetic in **integer picoseconds**
(:data:`PS_PER_S`), so a nonnegative ``host`` and nonnegative
components prove that no interval was counted twice or lost.

Time enters ONLY through the caller's ``t=`` stamps: a simulator
passes its virtual clock (traces are then bit-stable across runs), a
live engine its wall clock. The port's serving producers (the engine's
spans through :func:`serving_span`) come with the serving hooks
(ROADMAP queue 1 item 5); until then records come from callers.

Overhead contract (the metrics plane's): when the plane is off, every
module-level hook is ONE module-attribute load (``if _ACTIVE is None:
return``). When on, an event is a dict + list append.

Outputs:

* the per-rank JSONL stream (no wall-clock fields: byte-stable);
* :meth:`TracePlane.export_chrome_trace` — a ``chrome://tracing`` /
  Perfetto view (one lane per engine, one track per request).

Enable with ``PADDLE_TRACE_DIR`` (with the ``PADDLE_TRAINER_ID``
guard, exactly like the metrics plane) or explicitly::

    from paddle2_tpu_torch.observability import tracing
    tracing.enable("/tmp/traces")
    ... serve ...
    tracing.flush()
    tracing.active().export_chrome_trace()
"""

from __future__ import annotations

import atexit
import json
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

from .metrics import process_rank

TRACE_DIR_ENV = "PADDLE_TRACE_DIR"
TRACE_FLUSH_ENV = "PADDLE_TRACE_FLUSH_EVENTS"
TRACE_MAX_EVENTS_ENV = "PADDLE_TRACE_MAX_EVENTS"

_DEFAULT_FLUSH_EVENTS = 512
# same bounded-buffer posture as the metrics plane: an unwritable dir
# must never grow the process without bound
_MAX_BUFFER_RECORDS = 100_000
# in-memory retention for export_chrome_trace()/in-process decompose:
# newest N events (a live engine serving for days must not grow RSS
# without bound; the JSONL stream is the durable full record)
_DEFAULT_MAX_EVENTS = 200_000

# integer-picosecond quantum for the exact decomposition: fine enough
# that a 1-ulp float difference at second scale (~2e-16 s) can never
# move a boundary, coarse enough that clocks up to ~2.5 hours stay
# exactly representable in the 53-bit mantissa on the way in
PS_PER_S = 10 ** 12

# decomposition components, canonical order (host is the residual).
# spill_fetch_s: KV-tier promotion stalls (host-link / peer-node
# fetches at admission); migration_stall_s: failover KV migration
# transfers — both exact intervals, not residuals.
COMPONENTS = ("queue_wait_s", "prefill_s", "decode_compute_s",
              "eviction_stall_s", "failover_stall_s", "swap_stall_s",
              "spill_fetch_s", "migration_stall_s", "host_s")

# which waiting-interval cause feeds which component
_WAIT_COMPONENT = {"queue": "queue_wait_s", "evict": "eviction_stall_s",
                   "failover": "failover_stall_s"}


def _ps(t: float) -> int:
    return int(round(float(t) * PS_PER_S))


class TracePlane:
    """Per-rank request-lifecycle event recorder + JSONL writer."""

    def __init__(self, directory: str, rank: Optional[int] = None,
                 flush_events: Optional[int] = None):
        if rank is None:
            rank = process_rank()
        self.dir = directory
        self.rank = int(rank)
        if flush_events is None:
            try:
                flush_events = int(os.environ.get(
                    TRACE_FLUSH_ENV, _DEFAULT_FLUSH_EVENTS))
            except ValueError:
                flush_events = _DEFAULT_FLUSH_EVENTS
        self.flush_events = max(1, int(flush_events))
        try:
            self.max_events = max(1024, int(os.environ.get(
                TRACE_MAX_EVENTS_ENV, _DEFAULT_MAX_EVENTS)))
        except ValueError:
            self.max_events = _DEFAULT_MAX_EVENTS
        self._mu = threading.RLock()
        self._buffer: List[str] = []
        # in-memory event window (newest max_events) for chrome export
        # / in-process decomposition; the JSONL stream is the durable
        # FULL copy — a long-lived live engine must not grow RSS
        # unboundedly just because tracing is on
        self._events: List[Dict[str, Any]] = []
        self._n = 0
        # deterministic overhead accounting: one bump per recorded
        # event — a gate multiplies by metrics.EVENT_COST_OPS
        self.events_recorded = 0

    # -- recording (hot path) -------------------------------------------
    def event(self, name: str, t: float, tid=None, dur: float = 0.0,
              tids: Optional[List] = None, **fields) -> None:
        """Record one lifecycle event. ``t`` is the caller's clock
        (virtual in the simulators, wall in a live engine); ``tid`` is
        the stable trace id of ONE request, ``tids`` a list when the
        event covers a whole batch (decode steps, engine death). An
        interval event carries ``dur`` — or an explicit ``end=`` field
        when the end stamp must match another event's ``t`` bitwise."""
        rec: Dict[str, Any] = {"type": "span", "event": name,
                               "t": float(t)}
        if tid is not None:
            rec["tid"] = tid
        if tids is not None:
            rec["tids"] = list(tids)
        if dur:
            rec["dur"] = float(dur)
        for k, v in fields.items():
            if v is not None:
                rec[k] = v
        with self._mu:
            rec["n"] = self._n           # per-rank causal order
            self._n += 1
            self.events_recorded += 1
            self._events.append(rec)
            if len(self._events) > self.max_events:
                # drop the oldest half in one slice (amortized O(1)
                # per event) — readers needing the full history read
                # the JSONL stream
                del self._events[:self.max_events // 2]
            self._buffer.append(json.dumps(rec))
            if len(self._buffer) >= self.flush_events:
                self._flush_locked()

    # -- introspection ---------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        with self._mu:
            return list(self._events)

    # -- output ----------------------------------------------------------
    @property
    def stream_path(self) -> str:
        return os.path.join(self.dir, f"trace_rank_{self.rank}.jsonl")

    def _flush_locked(self) -> None:
        if not self._buffer:
            return
        lines, self._buffer = self._buffer, []
        try:
            os.makedirs(self.dir, exist_ok=True)
            with open(self.stream_path, "a") as f:
                f.write("\n".join(lines) + "\n")
        except OSError:
            self._buffer = (lines + self._buffer)[-_MAX_BUFFER_RECORDS:]

    def flush(self) -> None:
        with self._mu:
            self._flush_locked()

    def export_chrome_trace(self, path: Optional[str] = None) -> str:
        """Write the event list as a chrome://tracing / Perfetto JSON:
        one process lane per engine, one thread track per trace id,
        interval events as ``X`` slices and instants as ``i`` marks.
        The event names match the flight ring and the metrics phases,
        so the three timelines line up in one viewer."""
        out = path or os.path.join(self.dir,
                                   f"trace_rank_{self.rank}.trace.json")
        events = self.events()
        tev: List[Dict[str, Any]] = []
        seen_lanes = set()
        for rec in events:
            pid = int(rec.get("engine", 0) or 0)
            if pid not in seen_lanes:
                seen_lanes.add(pid)
                tev.append({"ph": "M", "pid": pid, "name": "process_name",
                            "args": {"name": f"engine {pid}"}})
            tids = rec.get("tids")
            targets = tids if tids is not None else [rec.get("tid", 0)]
            end = rec.get("end")
            dur = (end - rec["t"]) if end is not None \
                else rec.get("dur", 0.0)
            args = {k: v for k, v in rec.items()
                    if k not in ("type", "event", "t", "dur", "end",
                                 "tid", "tids", "n")}
            for tid in targets:
                base = {"name": rec["event"], "pid": pid,
                        "tid": tid if tid is not None else 0,
                        "ts": rec["t"] * 1e6, "args": args}
                if dur > 0:
                    tev.append({**base, "ph": "X", "dur": dur * 1e6})
                else:
                    tev.append({**base, "ph": "i", "s": "t"})
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        tmp = out + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"traceEvents": tev}, f)
        os.replace(tmp, out)
        return out


# ---------------------------------------------------------------- module
_ACTIVE: Optional[TracePlane] = None
_atexit_installed = False


def enable(directory: Optional[str] = None, rank: Optional[int] = None,
           flush_events: Optional[int] = None) -> TracePlane:
    """Turn request tracing on for this process. ``directory``
    defaults to ``PADDLE_TRACE_DIR``. Idempotent per directory."""
    global _ACTIVE, _atexit_installed
    d = directory or os.environ.get(TRACE_DIR_ENV)
    if not d:
        raise ValueError(f"tracing needs a directory: pass one or set "
                         f"{TRACE_DIR_ENV}")
    prev = _ACTIVE
    if prev is not None:
        if prev.dir == d and (rank is None or rank == prev.rank):
            if flush_events is not None:
                prev.flush_events = max(1, int(flush_events))
            return prev
        try:
            prev.flush()
        except Exception:
            pass
    _ACTIVE = TracePlane(d, rank=rank, flush_events=flush_events)
    if not _atexit_installed:
        _atexit_installed = True
        atexit.register(_atexit_flush)
    return _ACTIVE


def disable() -> None:
    global _ACTIVE
    pl, _ACTIVE = _ACTIVE, None
    if pl is not None:
        try:
            pl.flush()
        except Exception:
            pass


def active() -> Optional[TracePlane]:
    return _ACTIVE


def _atexit_flush() -> None:
    pl = _ACTIVE
    if pl is not None:
        try:
            pl.flush()
        except Exception:
            pass


# -- hot-path hooks (the one-attribute-load contract) --------------------
def event(name: str, t: float, tid=None, dur: float = 0.0,
          tids: Optional[List] = None, **fields) -> None:
    pl = _ACTIVE
    if pl is None:
        return
    pl.event(name, t, tid=tid, dur=dur, tids=tids, **fields)


def serving_span(fields: Dict[str, Any]) -> None:
    """Adapter for :func:`serving.reliability.flight_record`: every
    serving flight span that carries a clock stamp (``t``) is mirrored
    into the trace stream, so the flight ring and the request traces
    share ONE set of instrumentation sites and event names. Spans
    without a stamp (or with neither ``tid`` nor ``tids``) are
    flight-only."""
    pl = _ACTIVE
    if pl is None:
        return
    f = dict(fields)
    name = f.pop("event", None)
    t = f.pop("t", None)
    tid = f.pop("tid", None)
    tids = f.pop("tids", None)
    if name is None or t is None or (tid is None and tids is None):
        return
    pl.event(name, t, tid=tid, dur=f.pop("dur", 0.0), tids=tids, **f)


def flush() -> None:
    pl = _ACTIVE
    if pl is not None:
        pl.flush()


# ------------------------------------------------------------- assembly
def load_trace_dir(directory: str) -> List[Dict[str, Any]]:
    """Every span record from ``trace_rank_N.jsonl`` files under
    ``directory`` (a single file path is accepted too), merged in
    ``(t, rank, n)`` order. Unparseable lines are skipped."""
    paths: List[Tuple[int, str]] = []
    if os.path.isfile(directory):
        paths.append((0, directory))
    elif os.path.isdir(directory):
        for name in sorted(os.listdir(directory)):
            if name.startswith("trace_rank_") and name.endswith(".jsonl"):
                stem = name[len("trace_rank_"):-len(".jsonl")]
                paths.append((int(stem) if stem.isdigit() else 0,
                              os.path.join(directory, name)))
    records: List[Dict[str, Any]] = []
    for rank, p in paths:
        try:
            with open(p) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if rec.get("type") == "span":
                        rec["rank"] = rank
                        records.append(rec)
        except OSError:
            continue
    records.sort(key=lambda r: (r.get("t", 0.0), r.get("rank", 0),
                                r.get("n", 0)))
    return records


def assemble(records: List[Dict[str, Any]]) -> Dict[Any, List[dict]]:
    """Group span records per trace id, preserving order. Batch-scoped
    records (``tids`` lists: decode steps, engine death) are expanded
    to every member request."""
    out: Dict[Any, List[dict]] = {}
    for rec in records:
        tids = rec.get("tids")
        if tids is not None:
            for tid in tids:
                out.setdefault(tid, []).append(rec)
        elif "tid" in rec:
            out.setdefault(rec["tid"], []).append(rec)
    return out


# -------------------------------------------------------- decomposition
def decompose_request(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """One request's event list (time-ordered) -> its exact latency
    decomposition. All interval arithmetic happens in integer
    picoseconds; ``host_s`` is the residual that closes the sum, and
    ``exact`` asserts the whole invariant: the request finished, every
    component is nonnegative, and the ordered component sum equals the
    e2e latency EXACTLY (integer arithmetic — bitwise stable).

    Waiting intervals are attributed to their CAUSE: submit -> first
    admission is ``queue_wait``; eviction (and block-table-corruption
    requeue) -> re-admission is ``eviction_stall``; engine death ->
    re-admission on the adopter is ``failover_stall`` (probe-detection
    latency included, since the wait starts at the DEATH stamp).
    Prefill spans cover admission -> first-token-ready on the prefill
    lane (lane queueing included — disaggregation means decode never
    waits on it); decode spans are the modeled per-round step costs,
    dropped (chaos-retried) rounds included; ``swap_stall`` sums
    hot-swap pause stamps (zero for the arg-swap engines, a real pause
    for engines that must quiesce)."""
    comps_ps = {c: 0 for c in COMPONENTS}
    submit_ps: Optional[int] = None
    finish_ps: Optional[int] = None
    first_token_ps: Optional[int] = None
    wait_start_ps: Optional[int] = None
    wait_cause = "queue"
    # end/component of the most recent charged work interval: a stall
    # that opens BEFORE it completes (an engine dying mid-prefill, an
    # eviction of a still-prefilling sequence) invalidates the
    # uncompleted tail — that work never happened for this request and
    # must be clipped back out, or the components would overlap the
    # stall and overrun the e2e total
    last_fwd_end_ps: Optional[int] = None
    last_fwd_comp: Optional[str] = None
    counts = {"evictions": 0, "retries": 0, "failovers": 0,
              "corruptions": 0, "swaps": 0, "spill_fetches": 0,
              "migrations": 0}
    shed = False
    error = None
    tokens: Optional[int] = None
    engines = set()

    def _end_ps(rec) -> int:
        if "end" in rec:
            return _ps(rec["end"])
        # t + dur as FLOATS first: the engine computes its finish stamp
        # as the same float sum, so the two quantize identically
        return _ps(rec["t"] + rec.get("dur", 0.0))

    for rec in events:
        name = rec.get("event")
        t_ps = _ps(rec.get("t", 0.0))
        if "engine" in rec:
            engines.add(rec["engine"])
        if name == "submit":
            submit_ps = t_ps
            wait_start_ps = t_ps
            wait_cause = "queue"
        elif name == "admit":
            if wait_start_ps is not None:
                comps_ps[_WAIT_COMPONENT[wait_cause]] += \
                    t_ps - wait_start_ps
                wait_start_ps = None
        elif name == "prefill":
            end = _end_ps(rec)
            comps_ps["prefill_s"] += end - t_ps
            last_fwd_end_ps, last_fwd_comp = end, "prefill_s"
            if first_token_ps is None:
                first_token_ps = end
        elif name == "spill_fetch":
            # KV-tier promotion (host-link or peer-node fetch): starts
            # exactly where the prefill interval ends, so it charges
            # its own component without overlapping prefill_s. It IS
            # forward work — the clip rule applies if a stall opens
            # mid-fetch — and it delays the first token when it backs
            # the first prefill.
            end = _end_ps(rec)
            comps_ps["spill_fetch_s"] += end - t_ps
            if first_token_ps == last_fwd_end_ps and \
                    last_fwd_end_ps == t_ps:
                first_token_ps = end
            last_fwd_end_ps, last_fwd_comp = end, "spill_fetch_s"
            counts["spill_fetches"] += 1
        elif name == "migrate":
            # failover KV migration: the transfer rides
            # INSIDE the failover wait window, so the open wait is
            # credited up to the migration start, the transfer gets
            # its own exact component, and the wait reopens at the
            # transfer's end (admission is gated on kv_ready_t, so
            # the re-admit stamp can never precede it)
            end = _end_ps(rec)
            if wait_start_ps is not None:
                comps_ps[_WAIT_COMPONENT[wait_cause]] += \
                    t_ps - wait_start_ps
            comps_ps["migration_stall_s"] += end - t_ps
            wait_start_ps = end
            wait_cause = "failover"
            counts["migrations"] += 1
        elif name in ("decode_step", "decode_step_dropped"):
            end = _end_ps(rec)
            comps_ps["decode_compute_s"] += end - t_ps
            last_fwd_end_ps, last_fwd_comp = end, "decode_compute_s"
            if name == "decode_step_dropped":
                counts["retries"] += 1
        elif name in ("evict", "table_corrupt", "engine_failed"):
            # a wait already open (a WAITING request on a dying
            # engine) is credited to its own cause first — the new
            # stall starts HERE, it does not swallow the queue time
            if wait_start_ps is not None:
                comps_ps[_WAIT_COMPONENT[wait_cause]] += \
                    t_ps - wait_start_ps
            # clip work the stall invalidated (e.g. a prefill whose
            # lane completion lay beyond the engine's death: its KV
            # died unborn, the adopter re-prefills from scratch)
            if last_fwd_end_ps is not None and last_fwd_end_ps > t_ps:
                comps_ps[last_fwd_comp] -= last_fwd_end_ps - t_ps
                if first_token_ps == last_fwd_end_ps:
                    # the first token died with its prefill; TTFT is
                    # whenever the re-prefill actually delivers one
                    first_token_ps = None
                last_fwd_end_ps = None
            wait_start_ps = t_ps
            if name == "evict":
                wait_cause = "evict"
                counts["evictions"] += 1
            elif name == "table_corrupt":
                # corruption recovery is requeue-for-re-prefill — same
                # mechanics (and component) as an eviction stall
                wait_cause = "evict"
                counts["corruptions"] += 1
            else:
                wait_cause = "failover"
        elif name == "adopt":
            counts["failovers"] += 1
            if wait_start_ps is None:
                wait_start_ps = t_ps
            wait_cause = "failover"
        elif name == "hot_swap":
            pause = float(rec.get("pause_s", 0.0) or 0.0)
            if pause:
                comps_ps["swap_stall_s"] += _ps(rec["t"] + pause) - t_ps
            counts["swaps"] += 1
        elif name == "shed":
            shed = True
            error = rec.get("reason")
        elif name == "finish":
            finish_ps = t_ps
            if "tokens" in rec:
                tokens = int(rec["tokens"])

    finished = finish_ps is not None and submit_ps is not None
    out: Dict[str, Any] = {"finished": finished, "shed": shed,
                           "error": error, "tokens": tokens,
                           "engines": sorted(engines), **counts}
    if not finished:
        out.update({"exact": False, "e2e_s": None})
        return out
    e2e_ps = finish_ps - submit_ps
    measured_ps = sum(comps_ps[c] for c in COMPONENTS[:-1])
    comps_ps["host_s"] = e2e_ps - measured_ps
    # the exactness invariant: ordered integer sum == e2e (true by
    # residual construction) AND nothing negative — a negative host or
    # component means intervals overlapped or leaked, i.e. the
    # bookkeeping, not the arithmetic, is wrong
    total_ps = sum(comps_ps[c] for c in COMPONENTS)
    out["exact"] = (total_ps == e2e_ps
                    and all(v >= 0 for v in comps_ps.values()))
    out["e2e_ps"] = e2e_ps
    out["e2e_s"] = e2e_ps / PS_PER_S
    for c in COMPONENTS:
        out[c[:-2] + "_ps"] = comps_ps[c]
        out[c] = comps_ps[c] / PS_PER_S
    if first_token_ps is not None:
        out["ttft_s"] = (first_token_ps - submit_ps) / PS_PER_S
        if tokens and tokens > 1:
            out["tpot_s"] = ((finish_ps - first_token_ps)
                             / (tokens - 1)) / PS_PER_S
    return out


def decompose(records: List[Dict[str, Any]]) -> Dict[Any, Dict[str, Any]]:
    """``load_trace_dir`` output -> per-trace-id decompositions."""
    return {tid: decompose_request(evs)
            for tid, evs in sorted(assemble(records).items(),
                                   key=lambda kv: str(kv[0]))}


__all__ = ["TracePlane", "enable", "disable", "active", "event",
           "serving_span", "flush", "load_trace_dir", "assemble",
           "decompose", "decompose_request", "COMPONENTS", "PS_PER_S",
           "TRACE_DIR_ENV", "TRACE_FLUSH_ENV"]


# auto-enable: same posture as the metrics plane — the launcher (or
# operator) sets PADDLE_TRACE_DIR for the gang; the PADDLE_TRAINER_ID
# guard keeps operator shells from masquerading as rank 0
if os.environ.get(TRACE_DIR_ENV) and os.environ.get("PADDLE_TRAINER_ID"):
    try:
        enable(os.environ[TRACE_DIR_ENV])
    except (OSError, ValueError):
        pass
