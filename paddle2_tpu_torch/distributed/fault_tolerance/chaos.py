"""Deterministic chaos injection: the spec grammar and the serving hooks.

The counterpart of ``paddle2_tpu/distributed/fault_tolerance/chaos.py``.
The injector (:class:`ChaosInjector`), its spec grammar, ``FLAGS_chaos``
and every kind of :data:`KINDS` are the JAX module's: an armed spec
parses the same way, ticks the same counters and fires on the same
occurrence. A fault fires on an exact Nth occurrence of its kind, so a
failing chaos run replays identically.

The port has the hooks of the serving plane: :func:`maybe_kill_engine`,
:func:`maybe_drop_decode_step`, :func:`maybe_corrupt_block_table`,
:func:`maybe_corrupt_spill_block` (the serving engine) and
:func:`maybe_drop_migration` (the failover router). The kinds whose
hooks live in the training, checkpoint, collective, data-loader,
parameter-server, expert and sequence planes parse and arm, and fire
nowhere until those planes are ported (ROADMAP queue 1 item 7).

Spec grammar (flag ``FLAGS_chaos`` or :func:`arm`)::

    kind[:nth[:param]][,kind...]     (';' separates like ',')

    corrupt_shard:2        flip bytes of the 2nd shard file written
    truncate_shard:1       write only half of the 1st shard file
    fail_commit:1          raise IOError at the 1st metadata commit
    poison_loss:3          NaN the 3rd step's loss
    delay_collective:1:0.8 sleep 0.8 s inside the 1st watched collective
    worker_crash:3:1       SIGKILL DataLoader worker 1 at the 3rd fetch
    poison_grads:2         NaN the gradients at the 2nd unscale/check
    stall_collective:1:30  hold the 1st deadline-watched collective 30 s
    kill_rank:4:1          SIGKILL rank 1's process at its 4th step
                           (node-loss simulation: no dump, no cleanup)
    kill_engine:3:1        fail serving engine 1 at ITS 3rd decode
                           step (param selects the victim engine id,
                           default 0) — in-flight sequences must be
                           recovered from their host token logs
    drop_decode_step:2     the 2nd decode step's tokens are computed
                           then DISCARDED (a transient step failure);
                           the engine retries by recomputing the same
                           positions next step — token-for-token
                           identical, one step's cost wasted
    corrupt_block_table:4:1  at the 4th decode round, scribble an
                           out-of-range id into the table of active
                           sequence index 1 (param, default 0) — the
                           engine's table validator must catch it and
                           rebuild the sequence by re-prefill
    flip_bits:WHERE:N      flip N mantissa bits at WHERE ('grads': in
                           the victim's gradients as the optimizer
                           reads them; 'collective': in the tensor the
                           victim feeds its next collective) — the
                           silent-data-corruption simulation: values
                           shift, nothing crashes, no NaN appears.
                           Optional :RANK (victim, default 0) and :NTH
                           (victim's Nth occurrence, default 1) pieces:
                           flip_bits:grads:3:1:2 = 3 bits, rank 1,
                           2nd optimizer step

One armed value may carry MANY specs — comma- or semicolon-separated,
including several of the same kind — and each spec keeps its own
independent one-shot occurrence counter and victim gate. A whole-day
drill arms every fault family once up front::

    kill_engine:40:1;kill_engine:90:0;drop_decode_step:25;
    corrupt_block_table:60;corrupt_spill_block:3;drop_migration:1;
    kill_rank:7:1;flip_bits:grads:3:0:11

Here engine 1 dies at ITS 40th decode step and engine 0 at its 90th:
two ``kill_engine`` specs, two counters, two fires.

Clean-path cost is a single module-attribute load per hook site: every
hook starts with ``if _ACTIVE is None: return`` — no device syncs, no
flag lookups, no allocation when chaos is disarmed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ...flags import define_flag, flag_value

# kinds the injector understands (the JAX module's): the port's hooks
# are the serving ones below; the rest have no hook site yet
KINDS = ("corrupt_shard", "truncate_shard", "fail_commit", "poison_loss",
         "delay_collective", "worker_crash", "poison_grads",
         "stall_collective", "kill_rank", "flip_bits",
         "kill_engine", "drop_decode_step", "corrupt_block_table",
         "corrupt_spill_block", "drop_migration",
         "kill_ps_server", "corrupt_shard_delta", "drop_push",
         "kill_expert_host", "kill_seq_host")

_FLIP_WHERES = ("grads", "collective")


class _Spec:
    """One armed chaos spec: an independent one-shot occurrence counter
    plus its param and (for flip_bits) sub-grammar fields. Several
    specs — including several of the same kind — coexist in one
    injector; each ticks and fires on its own clock."""

    __slots__ = ("kind", "nth", "param", "count", "flip")

    def __init__(self, kind: str, nth: int,
                 param: Optional[float] = None,
                 flip: Optional[Dict[str, Any]] = None):
        self.kind = kind
        self.nth = nth
        self.param = param
        self.count = 0
        self.flip = flip

    def __repr__(self) -> str:
        return (f"_Spec({self.kind}, nth={self.nth}, "
                f"param={self.param}, count={self.count})")


class ChaosInjector:
    """Per-spec occurrence counters + the fired-event log.

    ``specs`` holds every armed spec in declaration order. The legacy
    single-spec views stay for callers that predate multi-spec arming:
    ``targets[kind]`` and ``flip`` reflect the FIRST spec of each kind,
    ``counts[kind]`` aggregates ticks across all specs of the kind."""

    def __init__(self, spec: str):
        self.spec = spec
        self.specs: List[_Spec] = []
        self._by_kind: Dict[str, List[_Spec]] = {}
        self.targets: Dict[str, Tuple[int, Optional[float]]] = {}
        self.counts: Dict[str, int] = {}
        self.fired: List[Tuple[str, str]] = []
        # flip_bits rides its own grammar (WHERE is a word, not an nth):
        # flip_bits:WHERE:N[:RANK[:NTH]]
        self.flip: Optional[Dict[str, Any]] = None
        for part in spec.replace(";", ",").split(","):
            part = part.strip()
            if not part:
                continue
            pieces = part.split(":")
            kind = pieces[0]
            if kind not in KINDS:
                raise ValueError(
                    f"unknown chaos kind {kind!r}; valid: {KINDS}")
            if kind == "flip_bits":
                where = pieces[1] if len(pieces) > 1 else "grads"
                if where not in _FLIP_WHERES:
                    raise ValueError(
                        f"flip_bits WHERE must be one of {_FLIP_WHERES},"
                        f" got {where!r}")
                fl = {
                    "where": where,
                    "bits": int(pieces[2]) if len(pieces) > 2 else 1,
                    "rank": int(pieces[3]) if len(pieces) > 3 else 0,
                    "nth": int(pieces[4]) if len(pieces) > 4 else 1,
                }
                sp = _Spec(kind, fl["nth"], float(fl["bits"]), fl)
                if self.flip is None:
                    self.flip = fl
            else:
                nth = int(pieces[1]) if len(pieces) > 1 else 1
                param = float(pieces[2]) if len(pieces) > 2 else None
                sp = _Spec(kind, nth, param)
            self.specs.append(sp)
            self._by_kind.setdefault(kind, []).append(sp)
            if kind not in self.targets:
                self.targets[kind] = (sp.nth, sp.param)
            self.counts.setdefault(kind, 0)

    def armed(self, kind: str) -> bool:
        return kind in self._by_kind

    def should_fire(self, kind: str, gate=None) -> Optional[_Spec]:
        """Tick every armed spec of ``kind`` that ``gate`` admits at
        this site (``gate=None`` admits all) and return the spec whose
        counter just hit its nth — or None. A spec fires exactly once:
        the counter keeps ticking past nth, it just can't equal it
        again. Specs of the same kind tick independently, so two
        ``kill_engine`` specs with different victim params coexist —
        the hook's gate decides which specs this occurrence belongs
        to. Truthiness matches the old bool contract."""
        fired = None
        for sp in self._by_kind.get(kind, ()):
            if gate is not None and not gate(sp):
                continue
            sp.count += 1
            self.counts[kind] = self.counts.get(kind, 0) + 1
            if sp.count == sp.nth and fired is None:
                fired = sp
        return fired

    def param(self, kind: str, default: float) -> float:
        tgt = self.targets.get(kind)
        return default if tgt is None or tgt[1] is None else tgt[1]

    def record(self, kind: str, detail: str) -> None:
        self.fired.append((kind, detail))
        # chaos events land in the flight ring too: a post-mortem must
        # distinguish an injected fault from an organic one
        from . import flight_recorder
        flight_recorder.record("chaos", fault=kind, detail=detail)


_ACTIVE: Optional[ChaosInjector] = None


def arm(spec: str) -> ChaosInjector:
    """Arm the injector with a spec string; returns it for inspection."""
    global _ACTIVE
    _ACTIVE = ChaosInjector(spec) if spec else None
    return _ACTIVE


def disarm() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[ChaosInjector]:
    return _ACTIVE


def fired_log() -> List[Tuple[str, str]]:
    return list(_ACTIVE.fired) if _ACTIVE is not None else []


define_flag("chaos", "",
            "Chaos-injection spec 'kind[:nth[:param]],...' (kinds: "
            + ", ".join(KINDS) + "); empty disarms.",
            on_change=arm)
if flag_value("chaos"):          # env FLAGS_chaos was set before import
    arm(str(flag_value("chaos")))


# ------------------------------------------------------- serving faults
def maybe_kill_engine(engine_id: int, step: int = -1) -> bool:
    """Serving-engine step hook (``ServingEngine.decode_once``): True
    when THIS engine must die now. The occurrence counter ticks only on
    the victim engine (the ``kill_rank`` idiom), so ``nth`` means "the
    victim's nth decode step" regardless of what the rest of the fleet
    is doing. The engine marks itself failed and raises
    ``EngineFailedError`` — the failover router recovers its in-flight
    sequences from their host token logs."""
    if _ACTIVE is None or not _ACTIVE.armed("kill_engine"):
        return False
    eid = int(engine_id)
    sp = _ACTIVE.should_fire(
        "kill_engine",
        gate=lambda s: eid == (0 if s.param is None else int(s.param)))
    if sp is not None:
        _ACTIVE.record("kill_engine", f"engine{eid}:step{step}")
        return True
    return False


def maybe_drop_decode_step(engine_id: int = 0) -> bool:
    """Serving-engine step hook: True when this decode step's freshly
    computed tokens must be DISCARDED — a transient step failure (a
    dropped readback, a preempted device). Because the engine only
    advances sequence state AFTER a successful step, the retry is
    implicit: the next step recomputes the same positions (same
    inputs, same weights — same tokens, and the KV rewrite is
    idempotent), costing one extra step of modeled time."""
    if _ACTIVE is None:
        return False
    if not _ACTIVE.armed("drop_decode_step"):
        return False
    if _ACTIVE.should_fire("drop_decode_step"):
        _ACTIVE.record("drop_decode_step", f"engine{engine_id}")
        return True
    return False


# deterministic far-out-of-range id the table validator must reject
CORRUPT_BLOCK_ID = 1_000_003


def maybe_corrupt_block_table(block_lists) -> Optional[int]:
    """Serving-engine step hook: scribble :data:`CORRUPT_BLOCK_ID`
    into the middle of one active sequence's block-id list (param
    selects which active index, default 0; wraps). Mutates in place and
    returns the corrupted index, or None. Ticks only when there is a
    table to corrupt, so the one-shot fire is never consumed by an
    empty round."""
    if _ACTIVE is None or not block_lists:
        return None
    if not _ACTIVE.armed("corrupt_block_table"):
        return None
    sp = _ACTIVE.should_fire("corrupt_block_table")
    if sp is None:
        return None
    pos = (0 if sp.param is None else int(sp.param)) % len(block_lists)
    blocks = block_lists[pos]
    if blocks:
        blocks[len(blocks) // 2] = CORRUPT_BLOCK_ID
    else:
        blocks.append(CORRUPT_BLOCK_ID)
    _ACTIVE.record("corrupt_block_table", f"seq_pos{pos}")
    return pos


def maybe_corrupt_spill_block(host_tier) -> Optional[tuple]:
    """Serving-engine step hook (the host tier): flip one byte of
    the oldest spilled block's payload while keeping its stored CRC —
    the deterministic stand-in for a host-DMA scribble. The next fetch
    of that prefix MUST detect the mismatch and fall back to
    re-prefill. Ticks only when the tier holds something to corrupt,
    so the one-shot fire is never consumed by an empty tier. Returns
    the corrupted prefix key, or None."""
    if _ACTIVE is None or host_tier is None or len(host_tier) == 0:
        return None
    if not _ACTIVE.armed("corrupt_spill_block"):
        return None
    if not _ACTIVE.should_fire("corrupt_spill_block"):
        return None
    key = host_tier.corrupt_one()
    _ACTIVE.record("corrupt_spill_block", f"{len(key)} prefix tokens"
                   if key is not None else "empty")
    return key


def maybe_drop_migration() -> bool:
    """Failover-router hook: lose one KV migration transfer
    on the virtual DCN — the adopter must fall back to re-prefilling
    from the harvested token log, costing time, never tokens."""
    if _ACTIVE is None:
        return False
    if not _ACTIVE.armed("drop_migration"):
        return False
    if _ACTIVE.should_fire("drop_migration"):
        _ACTIVE.record("drop_migration", "kv transfer dropped")
        return True
    return False


__all__ = ["KINDS", "ChaosInjector", "arm", "disarm", "active",
           "fired_log", "maybe_kill_engine", "maybe_drop_decode_step",
           "maybe_corrupt_block_table", "maybe_corrupt_spill_block",
           "maybe_drop_migration", "CORRUPT_BLOCK_ID"]
