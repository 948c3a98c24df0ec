"""Black-box flight recorder: per-rank event rings and crash dumps.

The counterpart of ``paddle2_tpu/distributed/fault_tolerance/
flight_recorder.py``, with the same names, the same JSON schema and the
same file names (``PADDLE_FLIGHT_DIR/rank_N.jsonl`` and its
``rank_N.stacks`` sibling), so the stdlib-only ``tools/flight_doctor``
of either package reads a dump that either package wrote. The module is
stdlib-only.

Every rank keeps a fixed-size ring of structured events and, on a
terminal fault, dumps the ring and every thread's stack, where
``python -m paddle2_tpu_torch.tools.flight_doctor`` merges the per-rank
dumps into a diagnosis (desynced collective sequences, stragglers, the
last good step of each rank).

Event sources in the port: the serving plane (scheduler, engine, router
and hot swap, through ``serving.reliability.flight_record``) and the
chaos injector (:mod:`.chaos`, every injected fault).
:meth:`FlightRecorder.collective_enter` / ``collective_exit`` keep the
JAX module's per-rank collective sequence numbers for the distributed
plane (ROADMAP queue 1 item 6), which has no caller in the port yet.

Overhead contract: when recording is off, every hook is one module
attribute load (``if _ACTIVE is None: return``): no locks, no
allocation, no device syncs. When on, an event is one lock acquisition
and one tuple store into a preallocated ring.

Dump triggers (installed by :func:`enable`): an unhandled exception (a
chained ``sys.excepthook``) and hard faults (SIGSEGV/SIGABRT:
``faulthandler`` writes raw stacks to ``rank_N.stacks`` beside the
jsonl); callers dump on their own faults with :func:`dump`.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

# directory for per-rank dumps; set it (operator or launcher) to turn
# recording ON for every worker in the gang
FLIGHT_DIR_ENV = "PADDLE_FLIGHT_DIR"
# ring capacity override (events kept per rank)
FLIGHT_EVENTS_ENV = "PADDLE_FLIGHT_EVENTS"
# launcher restart generation (also the checkpoint fencing stamp)
GENERATION_ENV = "PADDLE_RESTART_GENERATION"

_DEFAULT_CAPACITY = 2048


def _generation() -> int:
    try:
        return int(os.environ.get(GENERATION_ENV, "0") or 0)
    except ValueError:
        return 0


def _world_size() -> int:
    """``PADDLE_TRAINERS_NUM``, else ``WORLD_SIZE``, else the size of an
    initialised ``torch.distributed`` group, else 1 (the JAX package's
    ``distributed.env.get_world_size`` order)."""
    v = (os.environ.get("PADDLE_TRAINERS_NUM")
         or os.environ.get("WORLD_SIZE"))
    if v is not None:
        try:
            return int(v)
        except ValueError:
            return 1
    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_available() and dist.is_initialized():
        return int(dist.get_world_size())
    return 1


class FlightRecorder:
    """Fixed-size ring of structured events for ONE rank.

    Events are ``(n, wall_time, kind, fields)`` tuples where ``n`` is a
    monotonically increasing per-rank event number — the ring keeps the
    newest ``capacity`` of them. Collectives additionally carry a
    per-rank collective sequence number (``cseq``) that increments once
    per dispatched collective; because every rank of a correct SPMD
    program dispatches the same collectives in the same order, equal
    ``cseq`` across ranks must describe the SAME logical collective —
    any disagreement IS the desync.
    """

    def __init__(self, directory: str, rank: Optional[int] = None,
                 capacity: Optional[int] = None):
        from ...observability.metrics import process_rank
        self.dir = directory
        self.rank = int(process_rank() if rank is None else rank)
        self.world = _world_size()
        cap = capacity
        if cap is None:
            try:
                cap = int(os.environ.get(FLIGHT_EVENTS_ENV,
                                         _DEFAULT_CAPACITY))
            except ValueError:
                cap = _DEFAULT_CAPACITY
        if cap < 8:
            raise ValueError("flight recorder capacity must be >= 8")
        self.capacity = int(cap)
        self._ring: List[Optional[Tuple[int, float, str, dict]]] = \
            [None] * self.capacity
        self._n = 0                      # events ever recorded
        self._cseq = 0                   # collective sequence counter
        # REENTRANT: a signal handler that records and dumps runs on the
        # main thread between bytecodes, possibly while that thread
        # already holds the lock inside record(). A plain Lock would
        # deadlock there; with an RLock the interrupted record() can at
        # worst lose one event to a same-slot overwrite, which is
        # acceptable for a black box.
        self._mu = threading.RLock()
        self._last_dump: Optional[str] = None

    # -- recording (hot path) -------------------------------------------
    def record(self, kind: str, **fields) -> None:
        t = time.time()
        with self._mu:
            n = self._n
            self._n = n + 1
            self._ring[n % self.capacity] = (n, t, kind, fields)

    def collective_enter(self, op: str, group: str, shape=None,
                         dtype: Optional[str] = None) -> int:
        """Record a collective dispatch; returns its per-rank sequence
        number (pass to :meth:`collective_exit`)."""
        t = time.time()
        with self._mu:
            self._cseq += 1
            cseq = self._cseq
            n = self._n
            self._n = n + 1
            self._ring[n % self.capacity] = (
                n, t, "collective_enter",
                {"cseq": cseq, "op": op, "group": group,
                 "shape": shape, "dtype": dtype})
        return cseq

    def collective_exit(self, cseq: int, op: str) -> None:
        if cseq <= 0:
            return
        self.record("collective_exit", cseq=cseq, op=op)

    # -- introspection ---------------------------------------------------
    def events(self) -> List[Tuple[int, float, str, dict]]:
        """Retained events, oldest first."""
        with self._mu:
            out = [e for e in self._ring if e is not None]
        return sorted(out, key=lambda e: e[0])

    def events_recorded(self) -> int:
        with self._mu:
            return self._n

    @property
    def dump_file(self) -> str:
        return os.path.join(self.dir, f"rank_{self.rank}.jsonl")

    @property
    def stacks_file(self) -> str:
        return os.path.join(self.dir, f"rank_{self.rank}.stacks")

    # -- dumping ---------------------------------------------------------
    def _thread_stacks(self) -> List[dict]:
        """Every live thread's stack, faulthandler-style but structured
        (json-parseable) instead of free text."""
        names = {t.ident: (t.name, t.daemon)
                 for t in threading.enumerate()}
        out = []
        for ident, frame in sys._current_frames().items():
            name, daemon = names.get(ident, (f"thread-{ident}", False))
            frames = [{"file": f.filename, "line": f.lineno,
                       "func": f.name, "code": (f.line or "").strip()}
                      for f in traceback.extract_stack(frame)]
            out.append({"name": name, "ident": ident,
                        "daemon": bool(daemon), "frames": frames})
        return out

    def dump(self, reason: str) -> str:
        """Write the ring + thread stacks to ``rank_N.jsonl`` (atomic
        tmp+replace; a later dump for a later fault overwrites — the
        ring carries the full history either way). Returns the path."""
        with self._mu:
            events = sorted((e for e in self._ring if e is not None),
                            key=lambda e: e[0])
            n = self._n
        import socket
        header = {
            "type": "header", "rank": self.rank, "world": self.world,
            "pid": os.getpid(), "reason": reason,
            # quarantine identity (PADDLE_NODE_ID is launcher-stamped):
            # lets the doctor map a convicted rank to the HOST the
            # operator must drain — inlined to keep dump() import-free
            "node": os.environ.get("PADDLE_NODE_ID")
            or socket.gethostname(),
            "generation": _generation(), "wall_time": time.time(),
            "events_recorded": n,
            "events_dropped": max(0, n - len(events)),
            "capacity": self.capacity,
        }
        os.makedirs(self.dir, exist_ok=True)
        tmp = self.dump_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps(header) + "\n")
            for num, t, kind, fields in events:
                rec = {"type": "event", "n": num, "t": t, "kind": kind}
                rec.update(_jsonable(fields))
                f.write(json.dumps(rec) + "\n")
            f.write(json.dumps({"type": "stacks",
                                "threads": self._thread_stacks()}) + "\n")
        os.replace(tmp, self.dump_file)
        self._last_dump = self.dump_file
        return self.dump_file


def _jsonable(fields: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in fields.items():
        if isinstance(v, (str, int, float, bool, type(None))):
            out[k] = v
        elif isinstance(v, (tuple, list)):
            out[k] = [x if isinstance(x, (str, int, float, bool,
                                          type(None))) else repr(x)
                      for x in v]
        else:
            out[k] = repr(v)
    return out


# ---------------------------------------------------------------- module
_ACTIVE: Optional[FlightRecorder] = None
_prev_excepthook = None
_faulthandler_fh = None


def enable(directory: Optional[str] = None, rank: Optional[int] = None,
           capacity: Optional[int] = None,
           install_hooks: bool = True) -> FlightRecorder:
    """Turn recording on for this process. ``directory`` defaults to
    ``PADDLE_FLIGHT_DIR``. Installs the crash hooks (chained
    ``sys.excepthook`` dump + ``faulthandler`` hard-fault stacks) unless
    ``install_hooks=False`` (tests)."""
    global _ACTIVE
    d = directory or os.environ.get(FLIGHT_DIR_ENV)
    if not d:
        raise ValueError(
            f"flight recorder needs a dump directory: pass one or set "
            f"{FLIGHT_DIR_ENV}")
    _ACTIVE = FlightRecorder(d, rank=rank, capacity=capacity)
    _ACTIVE.record("recorder_enabled", generation=_generation())
    if install_hooks:
        _install_hooks(_ACTIVE)
    return _ACTIVE


def disable() -> None:
    """Stop recording and uninstall the crash hooks."""
    global _ACTIVE, _prev_excepthook, _faulthandler_fh
    _ACTIVE = None
    if _prev_excepthook is not None:
        sys.excepthook = _prev_excepthook
        _prev_excepthook = None
    if _faulthandler_fh is not None:
        try:
            import faulthandler
            faulthandler.disable()
            _faulthandler_fh.close()
        except Exception:
            pass
        _faulthandler_fh = None


def active() -> Optional[FlightRecorder]:
    return _ACTIVE


def suspend() -> Optional[FlightRecorder]:
    """Pause recording WITHOUT discarding the ring (A/B benches, scoped
    exclusions); returns the recorder to hand back to :func:`resume`."""
    global _ACTIVE
    fr, _ACTIVE = _ACTIVE, None
    return fr


def resume(fr: Optional[FlightRecorder]) -> None:
    """Reinstate a recorder captured by :func:`suspend`."""
    global _ACTIVE
    _ACTIVE = fr


def _install_hooks(fr: FlightRecorder) -> None:
    global _prev_excepthook, _faulthandler_fh
    if _prev_excepthook is None:
        _prev_excepthook = sys.excepthook

        def _hook(exc_type, exc, tb):
            rec = _ACTIVE
            if rec is not None:
                try:
                    rec.record("unhandled_exception",
                               exc=exc_type.__name__, msg=str(exc)[:500])
                    rec.dump(f"unhandled_exception:{exc_type.__name__}")
                except Exception:
                    pass
            _prev_excepthook(exc_type, exc, tb)

        sys.excepthook = _hook
    if _faulthandler_fh is None:
        try:
            import faulthandler
            os.makedirs(fr.dir, exist_ok=True)
            # append: a non-worker process (or a restarted worker) that
            # enables against the same dir must never truncate a prior
            # crash's stacks — they are evidence
            _faulthandler_fh = open(fr.stacks_file, "a")
            faulthandler.enable(file=_faulthandler_fh)
        except Exception:
            _faulthandler_fh = None


# -- hot-path hooks (the one-attribute-load contract) --------------------
def record(kind: str, **fields) -> None:
    fr = _ACTIVE
    if fr is None:
        return
    fr.record(kind, **fields)


def collective_enter(op: str, group: str, shape=None,
                     dtype: Optional[str] = None) -> int:
    fr = _ACTIVE
    if fr is None:
        return -1
    return fr.collective_enter(op, group, shape=shape, dtype=dtype)


def collective_exit(cseq: int, op: str) -> None:
    fr = _ACTIVE
    if fr is None or cseq <= 0:
        return
    fr.collective_exit(cseq, op)


def dump(reason: str) -> Optional[str]:
    """Dump the active ring; None when recording is off."""
    fr = _ACTIVE
    if fr is None:
        return None
    try:
        return fr.dump(reason)
    except OSError:
        return None


def dump_path() -> Optional[str]:
    fr = _ACTIVE
    return fr.dump_file if fr is not None else None


def dump_hint() -> str:
    """Suffix for terminal-fault exception messages: points the
    operator's first stack trace at the evidence. Empty when recording
    is off."""
    fr = _ACTIVE
    if fr is None:
        return ""
    return (f"; flight-recorder dump: {fr.dump_file} (diagnose with "
            f"`python -m paddle2_tpu_torch.tools.flight_doctor {fr.dir}`)")


# dumps younger than this survive a scale-in prune: the departed
# rank's dump written SECONDS ago is the evidence of the very failure
# the launcher is reacting to — the operator must get to read it
_PRUNE_MIN_AGE_S = 300.0


def prune_ranks(live_world: int, directory: Optional[str] = None,
                min_age_s: float = _PRUNE_MIN_AGE_S) -> List[int]:
    """Elastic scale-in hygiene: delete per-rank dump/stack files of
    ranks that left the gang (``rank >= live_world``) so a LATER
    post-mortem diagnoses the live lineage instead of mixing in a
    long-departed rank's evidence. Files newer than ``min_age_s`` are
    kept — the dump of the failure that caused THIS scale-in is the
    one thing the operator was just told to read (they age out at the
    next scale event; the doctor's stale-generation fence excludes
    them from the cross-rank join meanwhile). The launcher calls this
    (alongside ``watchdog.prune_gossip``) before respawning at a
    smaller world. Returns the pruned rank ids."""
    d = directory or os.environ.get(FLIGHT_DIR_ENV)
    pruned: List[int] = []
    if not d or not os.path.isdir(d):
        return pruned
    now = time.time()
    for name in os.listdir(d):
        for suffix in (".jsonl", ".stacks"):
            if name.startswith("rank_") and name.endswith(suffix):
                stem = name[len("rank_"):-len(suffix)]
                if stem.isdigit() and int(stem) >= int(live_world):
                    full = os.path.join(d, name)
                    try:
                        if now - os.path.getmtime(full) < min_age_s:
                            continue
                        os.remove(full)
                        if int(stem) not in pruned:
                            pruned.append(int(stem))
                    except OSError:
                        pass
    return sorted(pruned)


# launcher-side structured event stream: the launcher has no event ring
# of its own (it never calls enable()), but scale events are exactly
# what a post-mortem of an elastic job needs a timeline of
ELASTIC_LOG = "elastic_events.jsonl"


def append_elastic_event(kind: str, directory: Optional[str] = None,
                         **fields) -> None:
    """Append one ``elastic.*`` event to ``elastic_events.jsonl`` under
    the flight dir (auto-prefixed; silently a no-op without a directory
    — evidence is best-effort, never a failure source). Workers record
    ``elastic.*`` through their rings instead; this is the LAUNCHER's
    half of the stream: rendezvous outcomes, scale events, respawns,
    MTTR accounting."""
    d = directory or os.environ.get(FLIGHT_DIR_ENV)
    if not d:
        return
    if not kind.startswith("elastic."):
        kind = f"elastic.{kind}"
    rec = {"type": "event", "kind": kind, "t": time.time(),
           "generation": _generation()}
    rec.update(_jsonable(fields))
    try:
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, ELASTIC_LOG), "a") as f:
            f.write(json.dumps(rec) + "\n")
    except OSError:
        pass


def list_dumps(directory: Optional[str] = None) -> List[str]:
    """Per-rank dump files present under ``directory`` (defaults to
    ``PADDLE_FLIGHT_DIR``), rank order. Used by the launcher to collect
    surviving dumps when the gang dies — imports nothing heavy."""
    d = directory or os.environ.get(FLIGHT_DIR_ENV)
    if not d or not os.path.isdir(d):
        return []
    out = []
    for name in os.listdir(d):
        if name.startswith("rank_") and name.endswith(".jsonl"):
            stem = name[len("rank_"):-len(".jsonl")]
            if stem.isdigit():
                out.append((int(stem), os.path.join(d, name)))
    return [p for _, p in sorted(out)]


# auto-enable: the launcher (or operator) sets PADDLE_FLIGHT_DIR for the
# whole gang and every WORKER starts recording at import. Guarded on
# PADDLE_TRAINER_ID (the launcher sets it on workers only): the
# launcher's own import — and an operator running flight_doctor against
# the same env — must not masquerade as rank 0 and overwrite the real
# rank-0 worker's evidence. Standalone runs without a launcher opt in
# with an explicit enable() (or by exporting PADDLE_TRAINER_ID=0).
if os.environ.get(FLIGHT_DIR_ENV) and os.environ.get("PADDLE_TRAINER_ID"):
    try:
        enable(os.environ[FLIGHT_DIR_ENV])
    except (OSError, ValueError):
        pass


__all__ = ["FlightRecorder", "enable", "disable", "active", "record",
           "collective_enter", "collective_exit", "dump", "dump_path",
           "dump_hint", "list_dumps", "prune_ranks",
           "append_elastic_event", "ELASTIC_LOG", "FLIGHT_DIR_ENV",
           "FLIGHT_EVENTS_ENV", "GENERATION_ENV"]
