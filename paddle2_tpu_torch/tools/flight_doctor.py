"""flight_doctor: merge per-rank flight-recorder dumps into a diagnosis.

::

    python -m paddle2_tpu_torch.tools.flight_doctor /path/to/flight_dir
    python -m paddle2_tpu_torch.tools.flight_doctor --json flight_dir

Reads every ``rank_N.jsonl`` the flight recorder (or the launcher's
collection pass) left behind and answers the three post-mortem
questions a hung or dead gang raises:

1. **Which rank diverged, in which op?** Every rank records its
   collectives with a per-rank sequence number; a correct SPMD program
   dispatches the same collectives in the same order on every rank, so
   the merged per-seq view must agree. The doctor reports the FIRST
   sequence number where it doesn't — a rank that called a different
   op / shape / dtype (op-order desync), and ranks whose rings end
   early ("rank 3 never entered all_reduce seq 412").
2. **Who was slow?** Straggler attribution joins collective-enter
   wall-clock spreads (the last seq every rank reached) with the
   step-time gossip dir (``rank.N`` files, ``k * median`` rule).
3. **Where was everyone?** Last known-good step per rank (validated by
   ReliableStep's deferred check), each rank's in-flight collective at
   death, and the dumped thread stacks.

Exit code: 0 when the merged view is consistent, 3 when a desync was
diagnosed (script-friendly: CI chaos drills assert on it).

This module itself is stdlib-only (``load_dump``/``diagnose`` are
importable anywhere the dumps land); running it via ``-m`` pulls the
parent package, which is why auto-recording is guarded on
``PADDLE_TRAINER_ID`` — the doctor must never write into the directory
it is diagnosing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

DESYNC_EXIT = 3
# straggler rule shared with watchdog.StragglerDetector's default
_STRAGGLER_K = 2.0


# ---------------------------------------------------------------- loading
def load_dump(path: str) -> Dict[str, Any]:
    """Parse one ``rank_N.jsonl``: {"header", "events", "stacks"}.
    Unparseable lines are skipped (a dump is evidence, not a contract)."""
    header: Dict[str, Any] = {}
    events: List[Dict[str, Any]] = []
    stacks: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            t = rec.get("type")
            if t == "header":
                header = rec
            elif t == "event":
                events.append(rec)
            elif t == "stacks":
                stacks = rec.get("threads", [])
    events.sort(key=lambda e: e.get("n", 0))
    return {"header": header, "events": events, "stacks": stacks,
            "path": path}


def load_dumps(directory: str) -> Dict[int, Dict[str, Any]]:
    """All ``rank_N.jsonl`` dumps under ``directory``, keyed by rank."""
    out: Dict[int, Dict[str, Any]] = {}
    for name in sorted(os.listdir(directory)):
        if not (name.startswith("rank_") and name.endswith(".jsonl")):
            continue
        stem = name[len("rank_"):-len(".jsonl")]
        if not stem.isdigit():
            continue
        out[int(stem)] = load_dump(os.path.join(directory, name))
    return out


def load_gossip(directory: Optional[str]) -> Dict[int, float]:
    """Step-time gossip files (``rank.N`` -> seconds), empty if absent."""
    times: Dict[int, float] = {}
    if not directory or not os.path.isdir(directory):
        return times
    for name in os.listdir(directory):
        if not name.startswith("rank."):
            continue
        try:
            r = int(name.split(".", 1)[1])
            with open(os.path.join(directory, name)) as f:
                times[r] = float(f.read().strip())
        except (OSError, ValueError):
            continue
    return times


def load_quarantine(directory: Optional[str]) -> List[Dict[str, Any]]:
    """Verdicts in the persistent quarantine store (``q_<node>.json``
    under ``PADDLE_QUARANTINE_DIR``), oldest first; empty if absent.
    Read directly (stdlib-only) so the doctor never imports the
    package it is diagnosing."""
    out: List[Dict[str, Any]] = []
    if not directory or not os.path.isdir(directory):
        return out
    for name in sorted(os.listdir(directory)):
        if not (name.startswith("q_") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                out.append(json.load(f))
        except (OSError, ValueError):
            continue
    return sorted(out, key=lambda r: r.get("ts", 0))


def load_elastic_events(directory: Optional[str]) -> List[Dict[str, Any]]:
    """The launcher's ``elastic.*`` event stream
    (``elastic_events.jsonl``: rendezvous outcomes, scale events,
    respawns, restart latency), empty if absent or unreadable."""
    out: List[Dict[str, Any]] = []
    if not directory:
        return out
    path = os.path.join(directory, "elastic_events.jsonl")
    try:
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and \
                        str(rec.get("kind", "")).startswith("elastic."):
                    out.append(rec)
    except OSError:
        pass
    return out


# ---------------------------------------------------------------- analysis
def _collective_sig(ev: Dict[str, Any]) -> Tuple:
    shape = ev.get("shape")
    if isinstance(shape, list):
        shape = tuple(shape)
    return (ev.get("op"), shape, ev.get("dtype"), ev.get("group"))


def _sig_str(sig: Tuple) -> str:
    op, shape, dtype, group = sig
    bits = [str(op)]
    if shape is not None:
        bits.append(f"shape={tuple(shape)}")
    if dtype:
        bits.append(f"dtype={dtype}")
    if group:
        bits.append(f"group={group}")
    return " ".join(bits)


def _rank_list(ranks) -> str:
    return ",".join(str(r) for r in sorted(ranks))


def diagnose(dumps: Dict[int, Dict[str, Any]],
             gossip: Optional[Dict[int, float]] = None,
             elastic: Optional[List[Dict[str, Any]]] = None,
             quarantine: Optional[List[Dict[str, Any]]] = None
             ) -> Dict[str, Any]:
    """Merge per-rank dumps into a structured diagnosis (the JSON the
    CLI prints with ``--json``; the text report renders the same dict).
    ``elastic`` is the launcher's scale-event timeline — evidence of
    WHY the world looks the way it does (rescales, give-ups, restart
    latency), kept in the report verbatim (newest 20)."""
    gossip = gossip or {}
    ranks = sorted(dumps)
    report: Dict[str, Any] = {
        "ranks": ranks,
        "world": max((d["header"].get("world", 0) for d in dumps.values()),
                     default=0),
        "reasons": {r: dumps[r]["header"].get("reason") for r in ranks},
        "generations": {r: dumps[r]["header"].get("generation", 0)
                        for r in ranks},
        "missing_dumps": [],
        "stale_dumps": [],
        "last_good_step": {},
        "inflight": {},
        "desyncs": [],
        "guilty": [],
        "straggler": {},
        "elastic_events": list(elastic or [])[-20:],
        "quarantine": list(quarantine or []),
        "nodes": {r: dumps[r]["header"].get("node") for r in ranks},
        "sdc": [],
        "serving": {},
        "ps": {},
        "moe": {},
        "sep": {},
    }
    # serving plane: scheduler admit/evict/requeue/shed, engine
    # decode steps, failures/failovers, and hot-swap events — per-event
    # counts plus the newest few, so a serving crash post-mortem shows
    # what the reliability plane was doing when the engine died
    serving_counts: Dict[str, int] = {}
    serving_tail: List[Dict[str, Any]] = []
    for r in ranks:
        for ev in dumps[r]["events"]:
            if ev.get("kind") != "serving":
                continue
            name = ev.get("event", "?")
            serving_counts[name] = serving_counts.get(name, 0) + 1
            serving_tail.append({"rank": r, **{k: v for k, v in ev.items()
                                               if k != "kind"}})
    if serving_counts:
        report["serving"] = {"counts": serving_counts,
                             "last": serving_tail[-10:]}
    # parameter-server plane: pull/push spans plus the
    # failure narrative (server_kill -> stale_read/retry -> failover ->
    # resync), each span carrying shard + server ids so a dead drill is
    # attributable to a specific modeled host
    ps_counts: Dict[str, int] = {}
    ps_tail: List[Dict[str, Any]] = []
    for r in ranks:
        for ev in dumps[r]["events"]:
            if ev.get("kind") != "ps":
                continue
            name = ev.get("event", "?")
            ps_counts[name] = ps_counts.get(name, 0) + 1
            ps_tail.append({"rank": r, **{k: v for k, v in ev.items()
                                          if k != "kind"}})
    if ps_counts:
        report["ps"] = {"counts": ps_counts, "last": ps_tail[-10:]}
    # expert-parallel MoE plane: the failure narrative
    # (host_kill -> failover -> resync), router_collapse trips, and
    # ledger_violation markers, each span carrying expert + host ids so
    # a dead drill is attributable to a specific modeled expert host
    moe_counts: Dict[str, int] = {}
    moe_tail: List[Dict[str, Any]] = []
    for r in ranks:
        for ev in dumps[r]["events"]:
            if ev.get("kind") != "moe":
                continue
            name = ev.get("event", "?")
            moe_counts[name] = moe_counts.get(name, 0) + 1
            moe_tail.append({"rank": r, **{k: v for k, v in ev.items()
                                           if k != "kind"}})
    if moe_counts:
        report["moe"] = {"counts": moe_counts, "last": moe_tail[-10:]}
    # sequence-parallel plane: the failure narrative
    # (host_kill -> failover -> ring_reform -> resync) plus
    # lse_ledger_breach markers, each span carrying shard + host ids
    # so a dead ring pass is attributable to a specific modeled host
    sep_counts: Dict[str, int] = {}
    sep_tail: List[Dict[str, Any]] = []
    for r in ranks:
        for ev in dumps[r]["events"]:
            if ev.get("kind") != "sep":
                continue
            name = ev.get("event", "?")
            sep_counts[name] = sep_counts.get(name, 0) + 1
            sep_tail.append({"rank": r, **{k: v for k, v in ev.items()
                                           if k != "kind"}})
    if sep_counts:
        report["sep"] = {"counts": sep_counts, "last": sep_tail[-10:]}
    # SDC evidence: fingerprint-vote mismatches and self-evictions the
    # workers recorded. Deduped by (rank, step) — every voter records
    # the same verdict; the report wants the verdict once per witness.
    for r in ranks:
        for ev in dumps[r]["events"]:
            kind = ev.get("kind")
            if kind == "sdc.fingerprint_mismatch":
                report["sdc"].append({
                    "witness": r, "step": ev.get("step"),
                    "attempt": ev.get("attempt"),
                    "suspects": ev.get("suspects"),
                    "digests": ev.get("digests")})
            elif kind in ("sdc.evict", "elastic.quarantine"):
                report["sdc"].append({
                    "witness": r, "kind": kind,
                    "step": ev.get("step"), "host": ev.get("host"),
                    "reason": ev.get("reason")})
    world = report["world"] or (max(ranks) + 1 if ranks else 0)
    report["missing_dumps"] = [r for r in range(world) if r not in dumps]
    # restart-generation fence for the ANALYSIS itself: a surviving dump
    # from a PRE-restart generation records a different incarnation of
    # the program — its cseq counters restarted, so joining it against
    # current-generation rings would convict an innocent rank. Stale
    # dumps stay in the inventory but are excluded from the cross-rank
    # sequence join and straggler arrival.
    current_gen = max((int(g or 0)
                       for g in report["generations"].values()),
                      default=0)
    report["current_generation"] = current_gen
    report["stale_dumps"] = sorted(
        r for r, g in report["generations"].items()
        if int(g or 0) < current_gen)

    # per-rank collective ledgers
    enters: Dict[int, Dict[int, Dict[str, Any]]] = {}
    exits: Dict[int, set] = {}
    for r in ranks:
        enters[r] = {}
        exits[r] = set()
        last_good = None
        for ev in dumps[r]["events"]:
            kind = ev.get("kind")
            if kind == "collective_enter":
                enters[r][int(ev["cseq"])] = ev
            elif kind == "collective_exit":
                exits[r].add(int(ev["cseq"]))
            elif kind == "step_ok":
                s = ev.get("step")
                if s is not None and (last_good is None or s > last_good):
                    last_good = s
        report["last_good_step"][r] = last_good
        # in-flight at death: entered, never exited (newest last)
        report["inflight"][r] = [
            {"cseq": c, "desc": _sig_str(_collective_sig(e)),
             "t": e.get("t")}
            for c, e in sorted(enters[r].items())
            if c not in exits[r]]

    # the comparable window: per-rank cseq is contiguous, but the ring
    # drops old events — only compare seqs every surviving ring holds
    stale = set(report["stale_dumps"])
    with_colls = [r for r in ranks if enters[r] and r not in stale]
    if len(with_colls) >= 2:
        lo = max(min(enters[r]) for r in with_colls)
        hi = max(max(enters[r]) for r in with_colls)
        first_div = None
        for s in range(lo, hi + 1):
            present = {r: enters[r][s] for r in with_colls
                       if s in enters[r]}
            absent = [r for r in with_colls if s not in enters[r]]
            sigs: Dict[Tuple, List[int]] = {}
            for r, ev in present.items():
                sigs.setdefault(_collective_sig(ev), []).append(r)
            entry = None
            if len(sigs) > 1:
                # op-order / shape / dtype desync: minority is guilty
                ordered = sorted(sigs.items(), key=lambda kv: -len(kv[1]))
                majority_sig, majority_ranks = ordered[0]
                minority = [(sig, rs) for sig, rs in ordered[1:]]
                entry = {
                    "seq": s, "kind": "mismatch",
                    "majority": {"ranks": sorted(majority_ranks),
                                 "desc": _sig_str(majority_sig)},
                    "minority": [{"ranks": sorted(rs),
                                  "desc": _sig_str(sig)}
                                 for sig, rs in minority],
                }
                for _, rs in minority:
                    for r in rs:
                        if r not in report["guilty"]:
                            report["guilty"].append(r)
            elif absent and present:
                # ranks whose ring ENDS before s: they never entered
                tail_missing = [r for r in absent if max(enters[r]) < s]
                if tail_missing:
                    sig, rs = next(iter(sigs.items()))
                    entry = {
                        "seq": s, "kind": "never_entered",
                        "entered": {"ranks": sorted(present),
                                    "desc": _sig_str(sig)},
                        "never_entered": sorted(tail_missing),
                        "last_seen": {
                            r: {"cseq": max(enters[r]),
                                "desc": _sig_str(_collective_sig(
                                    enters[r][max(enters[r])]))}
                            for r in tail_missing},
                    }
                    for r in tail_missing:
                        if r not in report["guilty"]:
                            report["guilty"].append(r)
            if entry is not None:
                if first_div is None:
                    first_div = s
                report["desyncs"].append(entry)
                if len(report["desyncs"]) >= 10:
                    break
        report["first_divergence_seq"] = first_div

        # arrival spread at the last seq EVERY rank entered
        common_hi = min(max(enters[r]) for r in with_colls)
        common = None
        for s in range(common_hi, lo - 1, -1):
            if all(s in enters[r] for r in with_colls):
                common = s
                break
        if common is not None:
            arrivals = {r: enters[r][common].get("t")
                        for r in with_colls}
            if all(t is not None for t in arrivals.values()):
                t0 = min(arrivals.values())
                report["straggler"]["arrival"] = {
                    "seq": common,
                    "desc": _sig_str(_collective_sig(
                        enters[with_colls[0]][common])),
                    "delays": {r: round(arrivals[r] - t0, 6)
                               for r in with_colls},
                    "slowest": max(arrivals, key=arrivals.get),
                }

    # gossip-based straggler suspects (k * median of last step times)
    if len(gossip) >= 2:
        vals = sorted(gossip.values())
        mid = len(vals) // 2
        median = (vals[mid] if len(vals) % 2
                  else 0.5 * (vals[mid - 1] + vals[mid]))
        suspects = sorted((r for r, t in gossip.items()
                           if median > 0 and t > _STRAGGLER_K * median),
                          key=lambda r: -gossip[r])
        report["straggler"]["gossip"] = {
            "times": {r: gossip[r] for r in sorted(gossip)},
            "median": median, "suspects": suspects,
        }
    return report


# ---------------------------------------------------------------- report
def _format_elastic_timeline(report: Dict[str, Any]) -> List[str]:
    ev = report.get("elastic_events") or []
    if not ev:
        return []
    L = ["ELASTIC TIMELINE (launcher)"]
    for e in ev:
        extra = {k: v for k, v in e.items()
                 if k not in ("type", "kind", "t")}
        detail = " ".join(f"{k}={v}" for k, v in sorted(extra.items()))
        L.append(f"  t={e.get('t', 0):.3f} {e.get('kind')} {detail}")
    return L


def format_report(report: Dict[str, Any], directory: str) -> str:
    L: List[str] = []
    ranks = report["ranks"]
    L.append(f"flight_doctor: merged {len(ranks)} rank dump(s) from "
             f"{directory}")
    if not ranks:
        L.append("  no rank_N.jsonl dumps found — is PADDLE_FLIGHT_DIR "
                 "set on the workers? (a SIGKILLed gang leaves none; "
                 "the launcher timeline below may still explain it)")
        L.extend(_format_elastic_timeline(report))
        return "\n".join(L)
    L.append(f"  ranks: {_rank_list(ranks)} (world "
             f"{report['world'] or '?'}) generations: "
             + " ".join(f"r{r}={g}"
                        for r, g in sorted(report["generations"].items())))
    for r in ranks:
        L.append(f"  rank {r}: dumped for {report['reasons'][r]!r}")
    if report["missing_dumps"]:
        L.append(f"  MISSING dumps from rank(s) "
                 f"{_rank_list(report['missing_dumps'])} — reaped "
                 f"before dumping (SIGKILL/OOM?); their silence is "
                 f"itself a clue")
    if report["stale_dumps"]:
        L.append(f"  STALE dumps from rank(s) "
                 f"{_rank_list(report['stale_dumps'])} (restart "
                 f"generation < {report.get('current_generation')}): "
                 f"pre-restart evidence, excluded from the sequence "
                 f"join")
    lg = report["last_good_step"]
    if any(v is not None for v in lg.values()):
        L.append("  last known-good step: "
                 + " ".join(f"rank{r}={lg[r]}"
                            for r in ranks if lg[r] is not None))
    inflight = {r: v for r, v in report["inflight"].items() if v}
    if inflight:
        L.append("  in-flight at death:")
        for r, ops in sorted(inflight.items()):
            newest = ops[-1]
            L.append(f"    rank {r}: seq {newest['cseq']} "
                     f"{newest['desc']} (entered, never exited)")

    if report["desyncs"]:
        L.append("DESYNC DIAGNOSIS")
        for d in report["desyncs"]:
            if d["kind"] == "mismatch":
                L.append(f"  seq {d['seq']}: ranks "
                         f"{_rank_list(d['majority']['ranks'])} called "
                         f"{d['majority']['desc']}")
                for m in d["minority"]:
                    L.append(f"    but rank(s) {_rank_list(m['ranks'])} "
                             f"called {m['desc']} — op-order/shape/"
                             f"dtype desync")
            else:
                L.append(f"  seq {d['seq']}: rank(s) "
                         f"{_rank_list(d['never_entered'])} never "
                         f"entered {d['entered']['desc']} (ranks "
                         f"{_rank_list(d['entered']['ranks'])} did)")
                for r, last in sorted(d["last_seen"].items()):
                    L.append(f"    rank {r} last dispatched seq "
                             f"{last['cseq']}: {last['desc']}")
        if report["guilty"]:
            L.append(f"  verdict: rank(s) "
                     f"{_rank_list(report['guilty'])} diverged first "
                     f"(seq {report.get('first_divergence_seq')}) — "
                     f"inspect their thread stacks in the dump")
    else:
        L.append("collective sequences: consistent across ranks "
                 "(no desync in the retained window)")

    s = report.get("straggler", {})
    if s:
        L.append("STRAGGLER ATTRIBUTION")
        if "arrival" in s:
            a = s["arrival"]
            delays = ", ".join(f"rank{r}=+{a['delays'][r]:.3f}s"
                               for r in sorted(a["delays"]))
            L.append(f"  arrival at seq {a['seq']} ({a['desc']}): "
                     f"{delays}; slowest: rank {a['slowest']}")
        if "gossip" in s:
            g = s["gossip"]
            times = ", ".join(f"rank{r}={g['times'][r]:.3f}s"
                              for r in sorted(g["times"]))
            L.append(f"  step-time gossip: {times} "
                     f"(median {g['median']:.3f}s)")
            if g["suspects"]:
                L.append(f"  suspected straggler rank(s): "
                         f"{_rank_list(g['suspects'])} "
                         f"(step time > {_STRAGGLER_K:g} x median)")

    L.extend(_format_serving(report))
    L.extend(_format_ps(report))
    L.extend(_format_moe(report))
    L.extend(_format_sep(report))
    L.extend(_format_quarantine(report))
    L.extend(_format_elastic_timeline(report))
    return "\n".join(L)


def _format_ps(report: Dict[str, Any]) -> List[str]:
    """PARAMETER SERVER section: the sharded-table plane's spans —
    pull/push volume plus the failure narrative (``server_kill`` ->
    ``stale_read``/retry -> ``failover`` -> ``resync``). The shard and
    server ids lead each event so a drill post-mortem attributes every
    promotion and resync to a specific modeled host."""
    psr = report.get("ps") or {}
    if not psr:
        return []
    L = ["PARAMETER SERVER"]
    counts = psr.get("counts") or {}
    L.append("  events: " + " ".join(f"{k}={counts[k]}"
                                     for k in sorted(counts)))
    for ev in (psr.get("last") or [])[-10:]:
        rank = ev.get("rank", "?")
        lead = []
        if "shard" in ev:
            lead.append(f"shard={ev['shard']}")
        if "server" in ev:
            lead.append(f"server={ev['server']}")
        if "t" in ev:
            lead.append(f"t={ev['t']:.9f}")
        detail = " ".join(f"{k}={ev[k]}" for k in sorted(ev)
                          if k not in ("rank", "event", "shard",
                                       "server", "t"))
        L.append(f"  rank {rank}: {ev.get('event', '?')} "
                 + " ".join(lead + [detail]).strip())
    return L


def _format_moe(report: Dict[str, Any]) -> List[str]:
    """EXPERT-PARALLEL MOE section: the expert-fleet plane's spans —
    the failure narrative (``host_kill`` -> ``failover`` -> ``resync``)
    plus ``router_collapse`` and ``ledger_violation`` markers. The
    expert and host ids lead each event so a drill post-mortem
    attributes every promotion and resync to a specific modeled expert
    host."""
    mr = report.get("moe") or {}
    if not mr:
        return []
    L = ["EXPERT-PARALLEL MOE"]
    counts = mr.get("counts") or {}
    L.append("  events: " + " ".join(f"{k}={counts[k]}"
                                     for k in sorted(counts)))
    for ev in (mr.get("last") or [])[-10:]:
        rank = ev.get("rank", "?")
        lead = []
        if "expert" in ev:
            lead.append(f"expert={ev['expert']}")
        if "host" in ev:
            lead.append(f"host={ev['host']}")
        if "t" in ev:
            lead.append(f"t={ev['t']:.9f}")
        detail = " ".join(f"{k}={ev[k]}" for k in sorted(ev)
                          if k not in ("rank", "event", "expert",
                                       "host", "t"))
        L.append(f"  rank {rank}: {ev.get('event', '?')} "
                 + " ".join(lead + [detail]).strip())
    return L


def _format_sep(report: Dict[str, Any]) -> List[str]:
    """SEQUENCE PARALLEL section: what the long-context plane recorded
    — host_kill / failover / ring_reform / resync spans and
    lse_ledger_breach markers — per-event counts plus the newest few,
    each carrying shard + host ids and the virtual clock stamp, so an
    aborted ring pass post-mortem shows which host died mid-rotation
    and when the ring re-formed."""
    sp = report.get("sep") or {}
    if not sp:
        return []
    L = ["SEQUENCE PARALLEL"]
    counts = sp.get("counts") or {}
    L.append("  events: " + " ".join(f"{k}={counts[k]}"
                                     for k in sorted(counts)))
    for ev in (sp.get("last") or [])[-10:]:
        rank = ev.get("rank", "?")
        lead = []
        if "shard" in ev:
            lead.append(f"shard={ev['shard']}")
        if "host" in ev:
            lead.append(f"host={ev['host']}")
        if "t" in ev:
            lead.append(f"t={ev['t']:.9f}")
        detail = " ".join(f"{k}={ev[k]}" for k in sorted(ev)
                          if k not in ("rank", "event", "shard",
                                       "host", "t"))
        L.append(f"  rank {rank}: {ev.get('event', '?')} "
                 + " ".join(lead + [detail]).strip())
    return L


def _format_serving(report: Dict[str, Any]) -> List[str]:
    """SERVING section: what the serving reliability plane recorded —
    admit/evict/requeue/shed counts, decode steps, engine failures,
    failovers, hot-swap stages, and the fleet-KV ladder's spans
    (``kv_spill``/``spill_fetch``/``migrate``/``migrate_declined``/
    ``migration_dropped``) — plus the newest events with their trace
    id and clock stamp leading, so a flight dump JOINS the
    request-tracing streams (``serve_doctor``'s trace_rank_N.jsonl)
    on ``tid``/``t`` instead of dead-ending at per-event counts."""
    sv = report.get("serving") or {}
    if not sv:
        return []
    L = ["SERVING"]
    counts = sv.get("counts") or {}
    L.append("  events: " + " ".join(f"{k}={counts[k]}"
                                     for k in sorted(counts)))
    for ev in (sv.get("last") or [])[-10:]:
        rank = ev.get("rank", "?")
        # the JOIN KEYS lead: tid (stable across failover re-keying,
        # shared with the trace streams) and the virtual-clock stamp
        join = []
        if "tid" in ev:
            join.append(f"tid={ev['tid']}")
        elif "tids" in ev:
            join.append(f"tids={ev['tids']}")
        if "t" in ev:
            join.append(f"t={ev['t']:.9f}")
        detail = " ".join(f"{k}={ev[k]}" for k in sorted(ev)
                          if k not in ("rank", "event", "tid", "tids",
                                       "t"))
        L.append(f"  rank {rank}: {ev.get('event', '?')} "
                 + " ".join(join + [detail]).strip())
    return L


def _format_quarantine(report: Dict[str, Any]) -> List[str]:
    """QUARANTINE section: the persistent store's verdicts plus the
    workers' sdc.* evidence (fingerprint-vote mismatches, evictions) —
    the silent-data-corruption half of the post-mortem."""
    verdicts = report.get("quarantine") or []
    sdc = report.get("sdc") or []
    if not verdicts and not sdc:
        return []
    L = ["QUARANTINE"]
    for v in verdicts:
        age = ""
        if v.get("ts"):
            age = f" ({time.time() - v['ts']:.0f}s ago)"
        ev = v.get("evidence") or {}
        detail = " ".join(f"{k}={ev[k]}" for k in sorted(ev)
                          if isinstance(ev[k], (str, int, float)))
        L.append(f"  node {v.get('host')}: {v.get('reason')}"
                 f"{' rank ' + str(v['rank']) if v.get('rank') is not None else ''}"
                 f"{age}{' — ' + detail if detail else ''}")
    seen = set()
    for e in sdc:
        key = (e.get("kind"), e.get("step"), str(e.get("suspects")),
               e.get("host"))
        if key in seen:
            continue
        seen.add(key)
        if e.get("kind") in ("sdc.evict", "elastic.quarantine"):
            L.append(f"  rank {e['witness']} recorded {e['kind']}: "
                     f"host {e.get('host')} ({e.get('reason')})")
        else:
            L.append(f"  fingerprint mismatch at step {e.get('step')}"
                     f" (witness rank {e['witness']}): suspect rank(s) "
                     f"{e.get('suspects')} digests {e.get('digests')}")
    if verdicts:
        L.append("  a quarantined node is excluded from every "
                 "re-formation until its q_<node>.json is removed")
    return L


# ---------------------------------------------------------------- CLI
def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="paddle2_tpu_torch.tools.flight_doctor",
        description="merge per-rank flight-recorder dumps and diagnose "
                    "cross-rank desyncs, stragglers, and last-known-good "
                    "state")
    p.add_argument("flight_dir", nargs="?",
                   default=os.environ.get("PADDLE_FLIGHT_DIR"),
                   help="directory holding rank_N.jsonl dumps "
                        "(default: $PADDLE_FLIGHT_DIR)")
    p.add_argument("--gossip-dir",
                   default=os.environ.get("PADDLE_STEP_GOSSIP_DIR"),
                   help="step-time gossip dir for straggler attribution "
                        "(default: $PADDLE_STEP_GOSSIP_DIR)")
    p.add_argument("--quarantine-dir",
                   default=os.environ.get("PADDLE_QUARANTINE_DIR"),
                   help="persistent node-quarantine store for the "
                        "QUARANTINE section "
                        "(default: $PADDLE_QUARANTINE_DIR)")
    p.add_argument("--json", action="store_true",
                   help="emit the structured diagnosis as JSON")
    args = p.parse_args(argv)
    if not args.flight_dir:
        p.error("no flight dir: pass one or set PADDLE_FLIGHT_DIR")
    if not os.path.isdir(args.flight_dir):
        print(f"flight_doctor: {args.flight_dir!r} is not a directory",
              file=sys.stderr)
        return 2
    dumps = load_dumps(args.flight_dir)
    report = diagnose(dumps, load_gossip(args.gossip_dir),
                      load_elastic_events(args.flight_dir),
                      load_quarantine(args.quarantine_dir))
    if args.json:
        print(json.dumps(report, indent=2, default=str))
    else:
        print(format_report(report, args.flight_dir))
    return DESYNC_EXIT if report["desyncs"] else 0


if __name__ == "__main__":
    sys.exit(main())
