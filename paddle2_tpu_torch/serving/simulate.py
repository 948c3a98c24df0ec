"""Deterministic discrete-event serving simulation (cost x rate).

Counterpart of ``paddle2_tpu/serving/simulate.py``. The simulators drive
the real engine (real scheduler, real paged blocks, real kernels making
real tokens) under a VIRTUAL clock: each decode step advances time by the
step's modeled cost (the runner's FLOPs and bytes through
``observability.cost_model.StepCost``, at the card's rates from
``chip_peak``), and arrivals come from a seeded Poisson trace. Every
time in a report is cost-model output, "modeled" seconds, and a pure
function of (program costs, trace seed); no wall clock is read anywhere.

Two lanes, per the prefill/decode disaggregation design: admitted
prompts are prefilled on the PREFILL lane (its own clock) and join the
decode batch when that lane finishes them; the decode clock pays only
decode steps.

* :func:`simulate_serving` — one engine through a trace;
* :func:`simulate_predictor_baseline` — the one-request-at-a-time
  ``Predictor`` loop over the same trace and cost primitives;
* :class:`FleetKVRegistry` — the peer KV tier: a miss is fetched from
  another engine's tiers when the modeled transfer beats the modeled
  prefill;
* :class:`EngineFailoverRouter` and :func:`simulate_router` — a fleet
  under one clock with session and prefix affinity, health probes,
  failover from host token logs, and KV migration from a dead engine's
  host tier instead of prefilling again.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

__all__ = ["poisson_trace", "diurnal_poisson_trace", "ServingSimReport",
           "simulate_serving", "simulate_predictor_baseline",
           "cost_seconds",
           "EngineFailoverRouter", "RouterSimReport", "simulate_router",
           "FleetKVRegistry"]


def poisson_trace(n_requests: int, rate_per_s: float,
                  prompt_lens, gen_tokens, vocab: int, seed: int = 0
                  ) -> List[dict]:
    """Seeded synthetic heavy-traffic trace: exponential interarrivals
    at ``rate_per_s``, prompt lengths/gen budgets cycled from the
    given lists, token ids uniform over ``vocab``. Deterministic in
    ``seed``."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate_per_s))
        plen = int(prompt_lens[i % len(prompt_lens)])
        out.append({
            "arrival_t": t,
            "prompt": rng.integers(0, vocab, size=plen).tolist(),
            "max_new_tokens": int(gen_tokens[i % len(gen_tokens)]),
        })
    return out


def diurnal_poisson_trace(n_requests: int, day_s: float,
                          prompt_lens, gen_tokens, vocab: int,
                          seed: int = 0, peak_hour: float = 14.0,
                          trough_frac: float = 0.25,
                          cohorts=()) -> List[dict]:
    """Seeded NON-homogeneous Poisson trace over one simulated day:
    arrival intensity follows a raised-cosine diurnal curve (peak at
    ``peak_hour`` local, trough at ``trough_frac`` of the peak rate),
    sampled by inverting the numeric rate integral — order statistics
    of a day-long inhomogeneous Poisson process conditioned on
    ``n_requests`` arrivals. Deterministic in ``seed``.

    ``cohorts`` optionally injects shared-prefix sessions (the
    fleet-KV exercise): each entry is ``(prefix_tokens, arrival_ts)``
    and adds one request per listed arrival time whose prompt starts
    with that exact prefix — same-prefix requests route by affinity
    and exercise the prefix-cache / host-tier / migration ladder.
    Every request carries a ``session`` id; arrivals come out sorted."""
    rng = np.random.default_rng(seed)
    hours = np.linspace(0.0, 24.0, 1441)
    rate = trough_frac + (1.0 - trough_frac) * 0.5 * (
        1.0 + np.cos(2.0 * np.pi * (hours - peak_hour) / 24.0))
    cum = np.concatenate(
        ([0.0], np.cumsum((rate[1:] + rate[:-1]) * 0.5)))
    cum /= cum[-1]
    u = np.sort(rng.random(n_requests))
    arrivals = np.interp(u, cum, hours) / 24.0 * day_s
    out = []
    for i, t in enumerate(arrivals):
        plen = int(prompt_lens[i % len(prompt_lens)])
        out.append({
            "arrival_t": float(t),
            "prompt": rng.integers(0, vocab, size=plen).tolist(),
            "max_new_tokens": int(gen_tokens[i % len(gen_tokens)]),
            "session": f"day-{i}",
        })
    for c, (prefix, times) in enumerate(cohorts):
        for j, t in enumerate(times):
            out.append({
                "arrival_t": float(t),
                "prompt": list(prefix),
                "max_new_tokens": int(gen_tokens[j % len(gen_tokens)]),
                "session": f"cohort-{c}-{j}",
            })
    out.sort(key=lambda r: (r["arrival_t"], r["session"]))
    return out


def cost_seconds(cost: Optional[Dict[str, float]],
                 fallback_s: float = 1e-3) -> float:
    """A runner's cost dict -> modeled seconds: ``max(compute, memory)``
    under the card's rates (``cost_model.chip_peak``; the CPU has a
    fixed nominal pair, so the figure is deterministic everywhere).
    ``fallback_s`` stands in for a key that counted nothing."""
    if not cost or not cost.get("flops"):
        return fallback_s
    from ..observability.cost_model import StepCost
    sc = StepCost(flops=cost.get("flops", 0.0),
                  hbm_bytes=cost.get("bytes accessed", 0.0))
    return sc.step_time_modeled_s()


@dataclass
class ServingSimReport:
    total_tokens: int = 0
    makespan_s: float = 0.0
    tokens_per_s: float = 0.0
    ttft_s: List[float] = field(default_factory=list)
    p99_ttft_s: float = 0.0
    mean_ttft_s: float = 0.0
    decode_steps: int = 0
    evictions: int = 0
    kv_high_water_bytes: int = 0
    contiguous_cache_bytes: int = 0
    kv_ratio: float = 0.0
    decode_programs: int = 0
    program_budget: int = 0
    mean_batch_occupancy: float = 0.0
    # total modeled FLOPs executed (prefills + decode steps)
    modeled_flops: float = 0.0
    # prefix-cache economics: KV blocks actually MATERIALIZED (allocator
    # handouts, not shares), and their bytes a request
    kv_allocated_blocks: int = 0
    kv_allocated_bytes: int = 0
    kv_bytes_per_request: float = 0.0
    prefix_hits: int = 0
    prefix_misses: int = 0
    # speculative-decoding ledger: drafts the verify pass kept/killed
    spec_accepted: int = 0
    spec_rejected: int = 0
    spec_acceptance: float = 0.0

    def finalize(self, first_arrival: float, last_finish: float):
        self.makespan_s = max(last_finish - first_arrival, 1e-12)
        self.tokens_per_s = self.total_tokens / self.makespan_s
        if self.ttft_s:
            self.p99_ttft_s = float(np.percentile(self.ttft_s, 99))
            self.mean_ttft_s = float(np.mean(self.ttft_s))
        proposed = self.spec_accepted + self.spec_rejected
        self.spec_acceptance = (self.spec_accepted / proposed
                                if proposed else 0.0)
        return self


def simulate_serving(engine, trace: List[dict],
                     max_steps: int = 100_000) -> ServingSimReport:
    """Drive ``engine`` through ``trace`` under the virtual clock.
    Requests are submitted at their arrival times; the report carries
    every gated quantity. The engine does REAL compute — final tokens
    are available via ``engine.sequence(rid).generated``."""
    pending = sorted(trace, key=lambda r: r["arrival_t"])
    first_arrival = pending[0]["arrival_t"] if pending else 0.0
    decode_clock = float(first_arrival)
    prefill_clock = 0.0
    evictions_before = engine.scheduler.total_evictions
    alloc_before = engine.allocator.total_allocated
    spec_before = (engine.spec_accepted, engine.spec_rejected)
    pfx_before = ((engine.prefix_cache.hits, engine.prefix_cache.misses)
                  if engine.prefix_cache is not None else (0, 0))
    submitted: List[int] = []
    occupancy: List[float] = []
    rep = ServingSimReport()

    def submit_due(now: float):
        while pending and pending[0]["arrival_t"] <= now:
            r = pending.pop(0)
            submitted.append(engine.submit(
                r["prompt"], r["max_new_tokens"],
                arrival_t=r["arrival_t"]))

    for _ in range(max_steps):
        submit_due(decode_clock)
        if engine.idle() and not pending:
            break

        def lane_ready(info):
            # prefill lane: starts no earlier than the admission
            # instant or the lane's previous completion. The lane pays
            # the CHARGED cost when the engine provides one (KV
            # tiering scales the charge to the uncached prompt tail;
            # absent tiering the key is absent and this is info["cost"]
            # bit-for-bit).
            nonlocal prefill_clock
            start = max(prefill_clock, decode_clock,
                        info["seq"].request.arrival_t)
            prefill_clock = start + cost_seconds(
                info.get("charged_cost") or info["cost"])
            return prefill_clock

        infos = engine.admit_and_prefill(decode_clock,
                                         ready_at_fn=lane_ready)
        rep.modeled_flops += sum(
            (i["cost"] or {}).get("flops", 0.0) for i in infos)

        step = engine.decode_once(decode_clock)
        if step is not None:
            decode_clock += cost_seconds(step["cost"])
            rep.modeled_flops += (step["cost"] or {}).get("flops", 0.0)
            occupancy.append(step["n_active"]
                             / engine.scheduler.config.max_batch)
        else:
            # nothing ready: jump to the next event (arrival or a
            # prefill completing on its lane)
            nxt = []
            if pending:
                nxt.append(pending[0]["arrival_t"])
            nxt.extend(getattr(s, "ready_at", 0.0)
                       for s in engine.scheduler.running())
            if not nxt:
                if engine.scheduler.waiting:
                    raise RuntimeError(
                        "head-of-line request can never be admitted "
                        "(prompt needs more blocks than the pool has)")
                break
            decode_clock = max(decode_clock, min(nxt)) + 1e-9
    else:
        raise RuntimeError(f"simulation did not converge in "
                           f"{max_steps} steps")

    finished = [engine.sequence(rid) for rid in submitted]
    last_finish = max((s.finish_t or 0.0) for s in finished) \
        if finished else 0.0
    # every generated token counts — including each request's FIRST
    # token, produced by its prefill (the baseline counts all of
    # max_new_tokens too; counting only decode-step tokens would bias
    # the throughput ratio against continuous batching)
    rep.total_tokens = sum(len(s.generated) for s in finished)
    # from the scheduler's own ledger, not per-step info dicts: an
    # eviction that empties the ready batch aborts the step and would
    # otherwise go uncounted
    rep.evictions = engine.scheduler.total_evictions - evictions_before
    rep.ttft_s = [max(0.0, s.first_token_t - s.request.arrival_t)
                  for s in finished if s.first_token_t is not None]
    rep.decode_steps = engine.decode_steps
    rep.kv_high_water_bytes = engine.kv_high_water_bytes()
    rep.contiguous_cache_bytes = engine.contiguous_cache_bytes()
    rep.kv_ratio = (rep.kv_high_water_bytes
                    / max(rep.contiguous_cache_bytes, 1))
    rep.decode_programs = engine.num_decode_programs
    rep.program_budget = engine.program_budget
    rep.mean_batch_occupancy = float(np.mean(occupancy)) if occupancy \
        else 0.0
    rep.kv_allocated_blocks = (engine.allocator.total_allocated
                               - alloc_before)
    rep.kv_allocated_bytes = engine.cache.bytes_for_blocks(
        rep.kv_allocated_blocks)
    rep.kv_bytes_per_request = (rep.kv_allocated_bytes
                                / max(len(submitted), 1))
    rep.spec_accepted = engine.spec_accepted - spec_before[0]
    rep.spec_rejected = engine.spec_rejected - spec_before[1]
    if engine.prefix_cache is not None:
        rep.prefix_hits = engine.prefix_cache.hits - pfx_before[0]
        rep.prefix_misses = engine.prefix_cache.misses - pfx_before[1]
    return rep.finalize(first_arrival, last_finish)


# ------------------------------------------------- fleet-global KV tier
class FleetKVRegistry:
    """Fleet-global KV coordination: the peer tier over the cross-node
    link (``"dcn"``) plus the prefix advertisement the affinity router
    consults.

    Wires every engine's :class:`PrefixCache` with a peer-fetch
    source: on a local HBM+host miss, the registry scans the other
    alive engines for the longest contiguous run of the missing chain
    (HBM or host tier), prices the transfer with the alpha+beta
    :class:`~paddle2_tpu_torch.observability.cost_model.LinkModel`,
    prices the re-prefill of the same tokens with the engine's own
    runner costs, and fetches ONLY when the modeled transfer beats the
    modeled recompute: a deterministic cost-model decision, which
    :attr:`decisions` records. The same LinkModel prices failover KV
    migration (:meth:`EngineFailoverRouter._maybe_migrate`)."""

    def __init__(self, engines: List, link=None):
        from ..observability.cost_model import (
            LinkModel, DEFAULT_DCN_LATENCY_US)
        self.engines = list(engines)
        # alpha+beta: DCN latency term ON (a prefix fetch is one RPC;
        # pricing it latency-free would make tiny transfers free and
        # break the gated-both-ways decision)
        self.link = link if link is not None else LinkModel(
            dcn_latency_us=DEFAULT_DCN_LATENCY_US)
        self.peer_fetches = 0
        self.peer_fetch_blocks = 0
        self.peer_declined = 0
        # one record per priced fetch: blocks, t_fetch, t_prefill and
        # whether the fetch won
        self.decisions: List[dict] = []
        for e in self.engines:
            if e.prefix_cache is not None:
                e.prefix_cache.set_peer_source(self._source_for(e))

    def modeled_prefill_s(self, eng, n_tokens: int,
                          total_tokens: int) -> float:
        """Modeled seconds re-prefilling ``n_tokens`` of a
        ``total_tokens`` prompt would cost on ``eng`` — the same
        linear-in-tokens charge the tiering clock uses, so the
        fetch-vs-recompute decision and the clock agree."""
        if total_tokens <= 0 or n_tokens <= 0:
            return 0.0
        padded = eng.runner.prefill_padded_len(total_tokens)
        full = cost_seconds(eng.runner.prefill_cost(padded))
        return full * (n_tokens / total_tokens)

    def _source_for(self, eng):
        def fetch(missing_keys):
            # longest contiguous run any alive peer can serve
            best, best_n = None, 0
            for peer in self.engines:
                if peer is eng or peer.failed \
                        or peer.prefix_cache is None:
                    continue
                pc = peer.prefix_cache
                n = 0
                for key in missing_keys:
                    if key in pc._entries or (
                            pc.host_tier is not None
                            and key in pc.host_tier):
                        n += 1
                    else:
                        break
                if n > best_n:
                    best, best_n = peer, n
            if best is None or best_n == 0:
                return [], 0.0
            bs = eng.cache.block_size
            total = len(missing_keys[-1])    # keys ARE token prefixes
            t_fetch = self.link.seconds(
                best_n * eng.cache.block_bytes, axes=("dcn",))
            t_prefill = self.modeled_prefill_s(eng, best_n * bs, total)
            self.decisions.append(dict(blocks=best_n, t_fetch=t_fetch,
                                       t_prefill=t_prefill,
                                       fetch=t_fetch < t_prefill))
            if t_fetch >= t_prefill:
                self.peer_declined += 1
                return [], 0.0
            payloads = best.prefix_cache.export_chain(
                list(missing_keys[:best_n]))
            if not payloads:
                return [], 0.0
            self.peer_fetches += 1
            self.peer_fetch_blocks += len(payloads)
            # export may stop short (corrupt host entry): charge the
            # transfer pro-rata for what actually moved
            return payloads, t_fetch * (len(payloads) / best_n)
        return fetch


# ------------------------------------------------- multi-engine failover
class EngineFailoverRouter:
    """Deterministic multi-engine router with session affinity, health
    probes, and engine-failure recovery.

    Routing: a request with a ``session`` sticks to its session's
    engine (KV/prefix locality); otherwise the least-loaded alive
    engine wins (ties: lowest index). Health is probed on a fixed
    virtual-clock cadence using the ``fault_tolerance/health.py``
    idiom — each sweep yields one :class:`HealthReport` per engine —
    and a probe that finds an engine dead triggers failover: every
    in-flight sequence is harvested from the dead engine's host-side
    token logs (``recover_inflight``) and adopted at the FRONT of a
    healthy engine's queue, preserving admission order. Re-prefill of
    the token log reproduces the lost KV exactly, so recovered
    requests complete token-for-token identical to a fault-free run.
    MTTR (engine death -> every recovered sequence re-prefilled and
    producing tokens again) is measured on the virtual clock."""

    def __init__(self, engines: List, probe_interval_s: float = 1e-3,
                 kv_registry: Optional[FleetKVRegistry] = None):
        if not engines:
            raise ValueError("need at least one engine")
        if not probe_interval_s > 0.0:
            # maybe_probe advances in probe_interval_s steps; a
            # non-positive cadence would spin forever
            raise ValueError(
                f"probe_interval_s must be > 0, got {probe_interval_s}")
        self.engines = list(engines)
        for i, e in enumerate(self.engines):
            e.engine_id = i
        # fleet KV tier: enables prefix-affinity routing and
        # migrate-instead-of-re-prefill failover (None: neither)
        self.kv_registry = kv_registry
        self.kv_migrated_blocks = 0
        self.migrations = 0
        self.migrations_declined = 0
        self.probe_interval_s = float(probe_interval_s)
        # anchored lazily to the FIRST maybe_probe stamp: a fixed 0.0
        # anchor would make a first call at a large `now` spin through
        # one catch-up sweep per interval since time zero
        self._next_probe_t: Optional[float] = None
        self._affinity: Dict[object, int] = {}
        self._seqs: Dict[int, object] = {}      # global rid -> Sequence
        self._home: Dict[int, int] = {}         # global rid -> engine idx
        self._next_rid = 0
        self._handled_failures: set = set()
        self.failovers: List[dict] = []
        self.probes = 0

    # -- routing ---------------------------------------------------------
    def alive(self) -> List[int]:
        return [i for i, e in enumerate(self.engines) if not e.failed]

    def _load(self, idx: int) -> int:
        e = self.engines[idx]
        return len(e.scheduler.running()) + len(e.scheduler.waiting)

    def _pick(self, session=None, prompt=None) -> int:
        alive = self.alive()
        if not alive:
            from .reliability import EngineFailedError
            raise EngineFailedError("no alive engine to route to")
        if session is not None:
            idx = self._affinity.get(session)
            if idx is not None and not self.engines[idx].failed:
                return idx
        if prompt is not None and self.kv_registry is not None:
            # prefix affinity: the engine already holding the longest
            # cached prefix (HBM or host tier) serves the request —
            # ties break least-loaded then lowest index; zero cached
            # tokens everywhere falls through to least-loaded
            cached = {
                i: self.engines[i].prefix_cache.cached_prefix_tokens(
                    prompt)
                for i in alive
                if self.engines[i].prefix_cache is not None}
            if cached:
                idx = min(cached,
                          key=lambda i: (-cached[i], self._load(i), i))
                if cached[idx] > 0:
                    if session is not None:
                        self._affinity[session] = idx
                    return idx
        idx = min(alive, key=lambda i: (self._load(i), i))
        if session is not None:
            self._affinity[session] = idx
        return idx

    def submit(self, prompt, max_new_tokens: int, arrival_t: float = 0.0,
               session=None, priority: Optional[int] = None,
               deadline_s: Optional[float] = None) -> int:
        """Route one request; returns a router-global request id.
        Typed rejections (queue full, prompt too long) propagate from
        the target engine."""
        idx = self._pick(session, prompt=prompt
                         if self.kv_registry is not None else None)
        rid = self._next_rid
        local = self.engines[idx].submit(
            prompt, max_new_tokens, arrival_t=arrival_t,
            priority=priority, deadline_s=deadline_s,
            trace_id=rid)      # fleet-global span identity
        self._next_rid += 1
        self._seqs[rid] = self.engines[idx].sequence(local)
        self._home[rid] = idx
        return rid

    def sequence(self, rid: int):
        return self._seqs[rid]

    def home_of(self, rid: int) -> int:
        """Engine index currently serving ``rid`` (updated when a
        failover re-homes the sequence)."""
        return self._home[rid]

    # -- health + failover -----------------------------------------------
    def maybe_probe(self, now: float) -> None:
        """Run every probe sweep whose cadence stamp has passed; the
        cadence anchors at the first call's ``now``."""
        if self._next_probe_t is None:
            self._next_probe_t = float(now)
        while now >= self._next_probe_t:
            self.probe(self._next_probe_t)
            self._next_probe_t += self.probe_interval_s

    def probe(self, now: float) -> List:
        """One health sweep (``health.py`` HealthReport idiom); a
        newly-dead engine fails over HERE — detection latency is part
        of the MTTR."""
        from ..distributed.fault_tolerance.health import HealthReport
        self.probes += 1
        reports = []
        for i, e in enumerate(self.engines):
            rep = HealthReport(ok=not e.failed,
                               reason=e.fail_reason or "",
                               probe="serving_engine")
            reports.append(rep)
            if not rep.ok and i not in self._handled_failures:
                # no adopter alive -> leave the failure UNhandled (and
                # the dead engine's sequences unharvested, so nothing
                # is lost); a later sweep retries once capacity exists
                if not self.alive():
                    continue
                self._handled_failures.add(i)
                self._failover(i, now)
        return reports

    def _failover(self, dead_idx: int, now: float) -> None:
        from ..observability import metrics
        from .reliability import flight_record
        alive = self.alive()
        if not alive:
            from .reliability import EngineFailedError
            raise EngineFailedError(
                "no alive engine to adopt recovered sequences")
        dead = self.engines[dead_idx]
        recovered = dead.recover_inflight()
        # drop dead-engine affinity; sessions re-pin on next submit
        for sess in [s for s, i in self._affinity.items()
                     if i == dead_idx]:
            del self._affinity[sess]
        # assign targets in recovery order, least-loaded alive first
        # with each assignment counted (so a big recovery spreads
        # across the fleet instead of piling on one engine), then
        # adopt per target in REVERSE so front-insertion preserves the
        # original in-flight order
        loads = {i: self._load(i) for i in alive}
        targets: Dict[int, List] = {}
        for seq in recovered:
            idx = min(alive, key=lambda i: (loads[i], i))
            loads[idx] += 1
            targets.setdefault(idx, []).append(seq)
        rid_of = {id(s): rid for rid, s in self._seqs.items()}
        for idx, seqs in sorted(targets.items()):
            eng = self.engines[idx]
            # adopt() front-inserts ever-ADMITTED work and APPENDS
            # never-admitted arrivals (normal bounded submit), so the
            # two groups need opposite iteration orders to preserve
            # the original admission/FIFO order on the adopter
            inflight = [s for s in seqs if eng.scheduler._in_flight(s)]
            fresh = [s for s in seqs if not eng.scheduler._in_flight(s)]
            # migrate instead of prefilling again: before the
            # adopter re-queues each sequence, pull its surviving
            # host-tier KV across DCN when the modeled transfer beats
            # the modeled re-prefill — the migrate span lands BEFORE
            # the adopt span at the same stamp so the decomposition
            # charges migration_stall then reopens the failover wait
            for seq in inflight + fresh:
                self._maybe_migrate(dead, eng, seq, now)
            for seq in list(reversed(inflight)) + fresh:
                eng.adopt(seq, now=now)
                if id(seq) in rid_of:       # keep home_of() truthful
                    self._home[rid_of[id(seq)]] = idx
        metrics.inc("serving_failovers_total")
        flight_record(
            event="failover", engine=dead_idx, t=now,
            failed_t=dead.failed_t, recovered=len(recovered),
            tids=[s.trace_id for s in recovered
                  if s.trace_id is not None] or None,
            targets={str(k): len(v) for k, v in targets.items()})
        self.failovers.append({
            "engine": dead_idx, "failed_t": dead.failed_t,
            "detected_t": now, "seqs": recovered,
            "recovered": len(recovered), "recovered_t": None,
            "mttr_s": None})

    def _maybe_migrate(self, dead, eng, seq, now: float) -> int:
        """KV migration instead of re-prefill: the dead engine's device
        memory is gone, but its host-memory spill tier survives
        the device. If it holds a leading run of ``seq``'s prefix
        chain, price moving those blocks to the adopter over DCN
        against the modeled re-prefill of the same tokens; migrate
        only when the transfer wins. Migrated payloads are CRC-checked
        into fresh blocks in the ADOPTER's prefix cache (cache-owned,
        refcount 1), and ``seq.kv_ready_t`` holds the sequence out of
        admission until the modeled transfer lands — so admission
        re-prefills only the tail, and the decomposition's
        migration-stall component is exact. A chaos-dropped or corrupt
        transfer degrades to plain re-prefill. Returns blocks moved."""
        if self.kv_registry is None:
            return 0
        tier = getattr(dead, "host_tier", None)
        pc = eng.prefix_cache
        if tier is None or len(tier) == 0 or pc is None:
            return 0
        from ..distributed.fault_tolerance import chaos
        from ..observability import metrics
        from .block_cache import OutOfBlocksError
        from .reliability import flight_record
        keys = pc._keys(seq.tokens)
        n = 0
        for key in keys:
            if key in pc._entries:
                # adopter already holds it (an earlier migration of a
                # shared prefix) — admission's lookup will hit it
                n += 1
                continue
            if key in tier:
                n += 1
            else:
                break
        todo = [k for k in keys[:n] if k not in pc._entries]
        if not todo:
            return 0
        t_mig = self.kv_registry.link.seconds(
            len(todo) * eng.cache.block_bytes, axes=("dcn",))
        t_re = self.kv_registry.modeled_prefill_s(
            eng, len(todo) * eng.cache.block_size, len(seq.tokens))
        if t_mig >= t_re:
            # short context / cheap recompute: re-prefill wins, by
            # the same model the clock charges — counted, not silent
            self.migrations_declined += 1
            flight_record(event="migrate_declined",
                          engine=eng.engine_id, tid=seq.trace_id,
                          t=now, blocks=len(todo),
                          src=getattr(dead, "engine_id", None))
            return 0
        if chaos.maybe_drop_migration():
            # injected transfer loss: fall back to re-prefill — the
            # token log still reproduces the KV exactly
            flight_record(event="migration_dropped",
                          engine=eng.engine_id, tid=seq.trace_id,
                          t=now, blocks=len(todo),
                          chaos="drop_migration")
            return 0
        moved = 0
        for key in todo:
            payload = tier.get(key)     # CRC-verified; corrupt -> None
            if payload is None:
                break                   # tail re-prefills
            try:
                nb = eng.allocator.allocate(1)[0]
            except OutOfBlocksError:
                break
            eng._kv_scatter_block(nb, payload[0], payload[1])
            pc._entries[key] = nb       # cache-owned: allocate's ref
            pc._lru[key] = nb
            tier.pop(key)               # one tier owns a prefix
            moved += 1
        if not moved:
            return 0
        stall = t_mig * (moved / len(todo))
        seq.kv_ready_t = max(getattr(seq, "kv_ready_t", 0.0),
                             now + stall)
        self.migrations += 1
        self.kv_migrated_blocks += moved
        metrics.inc("serving_kv_migrated_blocks_total", moved)
        flight_record(event="migrate", engine=eng.engine_id,
                      tid=seq.trace_id, t=now, dur=stall,
                      blocks=moved,
                      src=getattr(dead, "engine_id", None))
        return moved

    def note_recovery(self, now: float) -> None:
        """Stamp MTTR for failovers whose every recovered sequence has
        SETTLED: re-prefilled (RUNNING with a fresh ``ready_at``),
        finished, or shed by the adopter's admission control (a
        never-admitted fresh arrival refused at adoption counts as
        settled — recovery is about resuming ACCEPTED work)."""
        from .scheduler import SeqState
        settled = (SeqState.RUNNING, SeqState.FINISHED, SeqState.SHED)
        for fo in self.failovers:
            if fo["recovered_t"] is not None:
                continue
            seqs = fo["seqs"]
            if all(s.state in settled for s in seqs):
                done = max((getattr(s, "ready_at", now) for s in seqs
                            if s.state is not SeqState.SHED),
                           default=now)
                fo["recovered_t"] = done
                fo["mttr_s"] = done - (fo["failed_t"] or 0.0)

    @property
    def mttr_s(self) -> float:
        """Worst recovered-failover MTTR (0.0 when none)."""
        vals = [fo["mttr_s"] for fo in self.failovers
                if fo["mttr_s"] is not None]
        return max(vals) if vals else 0.0


@dataclass
class RouterSimReport(ServingSimReport):
    engines: int = 0
    completed: int = 0
    submitted: int = 0
    rejected: int = 0
    shed: int = 0
    failovers: int = 0
    recovered_seqs: int = 0
    mttr_s: float = 0.0
    probes: int = 0
    hot_swaps: int = 0
    rids: List[int] = field(default_factory=list)
    # fleet-global KV ladder
    kv_spilled_blocks: int = 0
    kv_fetch_host_blocks: int = 0
    kv_fetch_peer_blocks: int = 0
    kv_migrated_blocks: int = 0
    kv_migrations: int = 0
    kv_migrations_declined: int = 0
    kv_host_tier_blocks: int = 0


def simulate_router(router: EngineFailoverRouter, trace: List[dict],
                    max_rounds: int = 100_000,
                    on_round=None) -> RouterSimReport:
    """Drive a fleet through ``trace`` under ONE virtual clock,
    lockstep: each round, every alive engine admits+prefills (its own
    prefill lane) and runs at most one decode step; the clock advances
    by the SLOWEST engine's step cost that round (engines run in
    parallel, so a round costs its straggler — conservative for every
    gated quantity). Health probes fire on their cadence at round
    boundaries; a chaos ``kill_engine`` fires inside ``decode_once``
    and surfaces as ``EngineFailedError``, which the loop absorbs —
    the ROUTER only learns at its next probe, so detection latency is
    inside the MTTR. Trace entries may carry ``session``,
    ``priority``, ``deadline_s``; typed rejections are counted, not
    raised. ``on_round(router, clock, round_idx)`` is the
    deterministic hook the hot-swap drill uses to stage rollouts."""
    from .reliability import EngineFailedError, RequestRejected
    from .scheduler import SeqState

    pending = sorted(trace, key=lambda r: r["arrival_t"])
    first_arrival = pending[0]["arrival_t"] if pending else 0.0
    clock = float(first_arrival)
    prefill_clocks = [0.0] * len(router.engines)
    rep = RouterSimReport(engines=len(router.engines))
    # per-engine snapshots so the report carries THIS simulation's
    # deltas, not lifetime totals (an engine warmed by a prior sim
    # must not inflate the figures)
    before = {id(e): (e.allocator.total_allocated, e.spec_accepted,
                      e.spec_rejected,
                      (e.prefix_cache.hits, e.prefix_cache.misses)
                      if e.prefix_cache is not None else (0, 0),
                      (e.prefix_cache.spills,
                       e.prefix_cache.host_fetches,
                       e.prefix_cache.peer_fetches)
                      if e.prefix_cache is not None else (0, 0, 0))
              for e in router.engines}
    mig_before = (router.kv_migrated_blocks, router.migrations,
                  router.migrations_declined)

    def submit_due(now: float):
        while pending and pending[0]["arrival_t"] <= now:
            r = pending.pop(0)
            try:
                rid = router.submit(
                    r["prompt"], r["max_new_tokens"],
                    arrival_t=r["arrival_t"], session=r.get("session"),
                    priority=r.get("priority"),
                    deadline_s=r.get("deadline_s"))
                rep.rids.append(rid)
                rep.submitted += 1
            except (RequestRejected, EngineFailedError):
                # typed rejections are COUNTED, not raised — including
                # "no alive engine to route to" under total fleet death
                rep.rejected += 1

    def lane_ready_fn(idx: int, now: float):
        def lane_ready(info):
            start = max(prefill_clocks[idx], now,
                        info["seq"].request.arrival_t)
            # charged_cost (KV tiering: pay for the uncached tail
            # only) when present; identical to info["cost"] otherwise
            prefill_clocks[idx] = start + cost_seconds(
                info.get("charged_cost") or info["cost"])
            return prefill_clocks[idx]
        return lane_ready

    for round_idx in range(max_rounds):
        router.maybe_probe(clock)
        submit_due(clock)
        if on_round is not None:
            on_round(router, clock, round_idx)
        costs = []
        for idx in router.alive():
            eng = router.engines[idx]
            try:
                infos = eng.admit_and_prefill(
                    clock, ready_at_fn=lane_ready_fn(idx, clock))
                rep.modeled_flops += sum(
                    (i["cost"] or {}).get("flops", 0.0) for i in infos)
                step = eng.decode_once(clock)
            except EngineFailedError:
                continue            # died this round; next probe sees it
            if step is not None:
                costs.append(cost_seconds(step["cost"]))
                rep.modeled_flops += (step["cost"] or {}).get(
                    "flops", 0.0)
        router.note_recovery(clock)
        if not router.alive():
            # total fleet death: nothing can ever serve the remainder
            rep.rejected += len(pending)
            pending.clear()
            break
        busy = any(not router.engines[i].idle() for i in router.alive())
        undetected = [i for i, e in enumerate(router.engines)
                      if e.failed and i not in router._handled_failures]
        if not pending and not busy and not undetected:
            break
        if costs:
            clock += max(costs)
        else:
            # legible stall diagnosis (simulate_serving's twin): an
            # idle engine whose head-of-line prompt needs more blocks
            # than its whole pool holds can never make progress
            from .block_cache import blocks_for_tokens
            for i in router.alive():
                eng = router.engines[i]
                w = eng.scheduler.waiting
                if w and not eng.scheduler.running() and not pending:
                    need = blocks_for_tokens(
                        len(w[0].tokens) + 1, eng.cache.block_size)
                    if need > eng.allocator.num_blocks - 1:
                        raise RuntimeError(
                            "head-of-line request can never be "
                            "admitted (prompt needs more blocks than "
                            "the pool has)")
            nxt = [r["arrival_t"] for r in pending[:1]]
            if (undetected or busy) and router._next_probe_t is not None:
                nxt.append(router._next_probe_t)
            for i in router.alive():
                nxt.extend(getattr(s, "ready_at", 0.0) for s in
                           router.engines[i].scheduler.running())
                # a migrated sequence is admission-gated until its KV
                # transfer lands — wake at that stamp or the gate
                # deadlocks an otherwise-idle fleet
                nxt.extend(
                    s.kv_ready_t
                    for s in router.engines[i].scheduler.waiting
                    if getattr(s, "kv_ready_t", 0.0) > clock)
            if not nxt:
                break
            clock = max(clock, min(nxt)) + 1e-9
    else:
        raise RuntimeError(
            f"router simulation did not converge in {max_rounds} rounds")

    seqs = [router.sequence(rid) for rid in rep.rids]
    done = [s for s in seqs if s.state is SeqState.FINISHED]
    rep.completed = len(done)
    rep.shed = sum(e.scheduler.total_shed for e in router.engines)
    rep.total_tokens = sum(len(s.generated) for s in done)
    rep.ttft_s = [max(0.0, s.first_token_t - s.request.arrival_t)
                  for s in done if s.first_token_t is not None]
    rep.decode_steps = sum(e.decode_steps for e in router.engines)
    rep.evictions = sum(e.scheduler.total_evictions
                        for e in router.engines)
    for e in router.engines:
        alloc0, acc0, rej0, (hit0, miss0), (sp0, fh0, fp0) = before[id(e)]
        blocks = e.allocator.total_allocated - alloc0
        rep.kv_allocated_blocks += blocks
        rep.kv_allocated_bytes += e.cache.bytes_for_blocks(blocks)
        rep.spec_accepted += e.spec_accepted - acc0
        rep.spec_rejected += e.spec_rejected - rej0
        if e.prefix_cache is not None:
            rep.prefix_hits += e.prefix_cache.hits - hit0
            rep.prefix_misses += e.prefix_cache.misses - miss0
            rep.kv_spilled_blocks += e.prefix_cache.spills - sp0
            rep.kv_fetch_host_blocks += e.prefix_cache.host_fetches - fh0
            rep.kv_fetch_peer_blocks += e.prefix_cache.peer_fetches - fp0
        if getattr(e, "host_tier", None) is not None:
            rep.kv_host_tier_blocks += len(e.host_tier)
    rep.kv_migrated_blocks = router.kv_migrated_blocks - mig_before[0]
    rep.kv_migrations = router.migrations - mig_before[1]
    rep.kv_migrations_declined = (router.migrations_declined
                                  - mig_before[2])
    rep.kv_bytes_per_request = (rep.kv_allocated_bytes
                                / max(rep.submitted, 1))
    rep.failovers = len(router.failovers)
    rep.recovered_seqs = sum(fo["recovered"] for fo in router.failovers)
    rep.mttr_s = router.mttr_s
    rep.probes = router.probes
    alive = router.alive()
    rep.decode_programs = sum(router.engines[i].num_decode_programs
                              for i in alive)
    rep.program_budget = sum(router.engines[i].program_budget
                             for i in alive)
    last_finish = max((s.finish_t or 0.0) for s in done) if done else 0.0
    return rep.finalize(first_arrival, last_finish)


def simulate_predictor_baseline(engine, trace: List[dict]
                                ) -> ServingSimReport:
    """The one-request-at-a-time ``create_predictor`` loop over the
    SAME trace and cost primitives: serve requests in arrival order,
    each paying its full prefill then ``max_new_tokens - 1`` decode
    steps at batch 1, next request waits. Both are priced by the
    runner's reckoning (:meth:`~.model_runner.PagedGPTRunner.prefill_cost`,
    :meth:`~.model_runner.PagedGPTRunner.decode_cost_of` at (1, max
    pages)), which runs nothing, so the engine's pools and its decode
    census stay untouched."""
    from .block_cache import blocks_for_tokens
    runner = engine.runner
    bs = engine.cache.block_size
    max_pages = blocks_for_tokens(engine.max_model_len, bs)
    decode_s = cost_seconds(runner.decode_cost_of(1, max_pages, bs))

    rep = ServingSimReport()
    t = 0.0
    first_arrival = min(r["arrival_t"] for r in trace) if trace else 0.0
    last_finish = 0.0
    for r in sorted(trace, key=lambda x: x["arrival_t"]):
        n = len(r["prompt"])
        padded = runner.prefill_padded_len(n)
        start = max(t, r["arrival_t"])
        first_tok = start + cost_seconds(runner.prefill_cost(padded))
        rep.ttft_s.append(first_tok - r["arrival_t"])
        t = first_tok + max(0, r["max_new_tokens"] - 1) * decode_s
        rep.total_tokens += r["max_new_tokens"]
        last_finish = t
    # contiguous max-seq-len cache, one slot: that IS the predictor's
    # KV footprint per in-flight request
    rep.kv_high_water_bytes = engine.cache.contiguous_bytes(
        1, engine.max_model_len)
    rep.contiguous_cache_bytes = rep.kv_high_water_bytes
    rep.kv_ratio = 1.0
    return rep.finalize(first_arrival, last_finish)
