"""serve_doctor: exact tail-latency attribution for the serving fleet.

The serving sibling of ``perf_doctor`` (which answers "where did the
STEP time go" for training): this CLI answers "which lifecycle stage
owns the TAIL" for requests, from the per-rank span streams the
request-tracing plane writes (``trace_rank_N.jsonl`` under
``PADDLE_TRACE_DIR``)::

    python -m paddle2_tpu_torch.tools.serve_doctor /path/to/trace_dir
    python -m paddle2_tpu_torch.tools.serve_doctor diff BASE_DIR CAND_DIR
    python -m paddle2_tpu_torch.tools.serve_doctor --json trace_dir

Three triage answers:

1. **Where does each request's latency go?** Every finished request is
   decomposed into ``queue_wait + prefill + decode_compute +
   eviction_stall + failover_stall + swap_stall + host`` summing
   EXACTLY to its e2e latency (integer-picosecond accounting, host =
   residual — the step-window rule applied per request). Violations
   are a report section, not a silent skip.
2. **Who owns the tail?** The p99-vs-p50 gap is attributed by
   comparing the decomposition of the request AT p99 (nearest-rank)
   against the one at p50: the component with the largest positive
   delta owns the gap. An injected overload names ``queue_wait``; a
   dropped-decode chaos fault names ``decode_compute`` — and the CHAOS
   section lists exactly which trace ids each injected fault touched
   (the flight ring's chaos spans carry ``tids``).
3. **What regressed?** ``diff BASE CAND`` compares per-request
   component means and the e2e p50/p99, names the top regressed
   component, and exits ``REGRESSION_EXIT`` (4) when the p99 (or
   mean) e2e regression passes the threshold. Traces from the
   virtual-clock simulators are bit-deterministic, so identical code
   diffs at EXACTLY 0%% — the CI-gating primitive.

``--metrics-dir`` joins the metrics plane's SLO ledger
(``serving_slo_*`` counters + burn-rate gauge) into the report, so
one view carries both "who is slow" and "are we burning budget".

Stdlib-only analysis (the flight_doctor/perf_doctor posture); span
parsing and decomposition are delegated to
``observability.tracing`` — ONE reader owns the span format.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

REGRESSION_EXIT = 4

_COMPONENT_LABEL = {
    "queue_wait_s": "queue-wait",
    "prefill_s": "prefill",
    "decode_compute_s": "decode-compute",
    "eviction_stall_s": "eviction-stall",
    "failover_stall_s": "failover-stall",
    "swap_stall_s": "swap-stall",
    "spill_fetch_s": "spill-fetch",
    "migration_stall_s": "migration-stall",
    "host_s": "host",
}

# chaos span shapes the attribution section knows how to blame
_CHAOS_EVENTS = ("decode_step_dropped", "table_corrupt", "engine_failed")


def _components():
    from ..observability import tracing
    return tracing.COMPONENTS


def _mean(vals: List[float]) -> float:
    return sum(vals) / len(vals) if vals else 0.0


def _rank_at(sorted_vals: List, q: float) -> int:
    """Nearest-rank index for quantile ``q`` in [0, 100] — integer
    arithmetic, deterministic, no interpolation."""
    n = len(sorted_vals)
    if n == 0:
        return 0
    return min(n - 1, max(0, -(-int(q * n) // 100) - 1))


# ---------------------------------------------------------------- analysis
def summarize(records: List[Dict[str, Any]],
              metrics_dir: Optional[str] = None) -> Dict[str, Any]:
    """Span records (``tracing.load_trace_dir`` output) -> the triage
    report dict."""
    from ..observability import tracing
    decomps = tracing.decompose(records)
    comps = _components()
    finished = {t: c for t, c in decomps.items() if c["finished"]}
    shed = [t for t, c in decomps.items() if c.get("shed")]
    unfinished = [t for t, c in decomps.items()
                  if not c["finished"] and not c.get("shed")]
    violations = [t for t, c in finished.items() if not c["exact"]]

    report: Dict[str, Any] = {
        "requests": len(decomps), "finished": len(finished),
        "shed": len(shed), "unfinished": len(unfinished),
        "exactness": {"checked": len(finished),
                      "violations": sorted(violations, key=str)},
        "decompositions": decomps,
    }
    if finished:
        by_e2e = sorted(finished, key=lambda t: (finished[t]["e2e_ps"],
                                                 str(t)))
        e2e = [finished[t]["e2e_s"] for t in by_e2e]
        stats: Dict[str, Any] = {
            "e2e": {"mean_s": _mean(e2e),
                    "p50_s": e2e[_rank_at(e2e, 50)],
                    "p99_s": e2e[_rank_at(e2e, 99)]}}
        for c in comps:
            vals = [finished[t][c] for t in by_e2e]
            stats[c] = {"mean_s": _mean(vals),
                        "share_pct": (100.0 * _mean(vals)
                                      / stats["e2e"]["mean_s"]
                                      if stats["e2e"]["mean_s"] else 0.0)}
        ttfts = sorted(c["ttft_s"] for c in finished.values()
                       if c.get("ttft_s") is not None)
        if ttfts:
            stats["ttft"] = {"p50_s": ttfts[_rank_at(ttfts, 50)],
                             "p99_s": ttfts[_rank_at(ttfts, 99)]}
        report["stats"] = stats
        # tail attribution: the request AT p99 vs the one AT p50
        t50 = by_e2e[_rank_at(by_e2e, 50)]
        t99 = by_e2e[_rank_at(by_e2e, 99)]
        gap = {c: finished[t99][c] - finished[t50][c] for c in comps}
        owner = max(comps, key=lambda c: gap[c])
        report["tail"] = {
            "p50_tid": t50, "p99_tid": t99,
            "gap_s": finished[t99]["e2e_s"] - finished[t50]["e2e_s"],
            "component_gaps_s": gap,
            "owner": owner,
            "owner_label": _COMPONENT_LABEL[owner],
            "owner_gap_s": gap[owner],
        }
        report["counters"] = {
            k: sum(c[k] for c in finished.values())
            for k in ("evictions", "retries", "failovers",
                      "corruptions", "swaps", "spill_fetches",
                      "migrations")}
    # chaos attribution: which injected fault touched which requests
    chaos: Dict[str, List] = {}
    for rec in records:
        name = rec.get("event")
        if name in _CHAOS_EVENTS or "chaos" in rec:
            key = rec.get("chaos") or name
            tids = rec.get("tids") or (
                [rec["tid"]] if "tid" in rec else [])
            chaos.setdefault(key, []).extend(tids)
    if chaos:
        report["chaos"] = {k: sorted(set(v), key=str)
                           for k, v in sorted(chaos.items())}
    if metrics_dir:
        report["slo"] = load_slo(metrics_dir)
        report["throughput"] = load_throughput(metrics_dir)
    return report


def load_slo(metrics_dir: str) -> Dict[str, Any]:
    """Join the metrics plane's SLO ledger: good/bad totals,
    per-dimension check verdicts, and the burn-rate gauge, read from
    the newest metrics snapshot of every rank stream."""
    from . import perf_doctor
    streams = perf_doctor.load_streams(metrics_dir)
    out: Dict[str, Any] = {"good": 0.0, "bad": 0.0, "checks": {},
                           "burn_rate": None}
    for s in streams.values():
        snap = s.get("snapshot") or {}
        out["good"] += perf_doctor._counter_total(
            snap, "serving_slo_good_total")
        out["bad"] += perf_doctor._counter_total(
            snap, "serving_slo_bad_total")
        checks = (snap.get("counters") or {}).get(
            "serving_slo_checks_total") or {}
        for labels, v in checks.items():
            out["checks"][labels] = out["checks"].get(labels, 0.0) + v
        gauges = (snap.get("gauges") or {}).get(
            "serving_slo_burn_rate") or {}
        for v in gauges.values():
            # the WORST rank's burn rate — summed good/bad totals next
            # to one arbitrary rank's gauge would be inconsistent
            if out["burn_rate"] is None or v > out["burn_rate"]:
                out["burn_rate"] = v
    total = out["good"] + out["bad"]
    out["attainment"] = out["good"] / total if total else None
    return out


def load_throughput(metrics_dir: str) -> Dict[str, Any]:
    """Join the serving-throughput economics from the
    metrics snapshots: prefix-cache hits/misses (+ the shared-KV-bytes
    gauge) and the speculative-decoding accepted/rejected ledger with
    its derived acceptance rate — the one number an acceptance-rate
    regression moves first."""
    from . import perf_doctor
    streams = perf_doctor.load_streams(metrics_dir)
    out: Dict[str, Any] = {"prefix_hits": 0.0, "prefix_misses": 0.0,
                           "shared_kv_bytes": None,
                           "spec_accepted": 0.0, "spec_rejected": 0.0}
    for s in streams.values():
        snap = s.get("snapshot") or {}
        out["prefix_hits"] += perf_doctor._counter_total(
            snap, "serving_prefix_hits_total")
        out["prefix_misses"] += perf_doctor._counter_total(
            snap, "serving_prefix_misses_total")
        out["spec_accepted"] += perf_doctor._counter_total(
            snap, "serving_spec_accepted_total")
        out["spec_rejected"] += perf_doctor._counter_total(
            snap, "serving_spec_rejected_total")
        gauges = (snap.get("gauges") or {}).get(
            "serving_shared_kv_bytes") or {}
        for v in gauges.values():
            out["shared_kv_bytes"] = (v if out["shared_kv_bytes"] is None
                                      else out["shared_kv_bytes"] + v)
    lookups = out["prefix_hits"] + out["prefix_misses"]
    out["prefix_hit_rate"] = (out["prefix_hits"] / lookups
                              if lookups else None)
    proposed = out["spec_accepted"] + out["spec_rejected"]
    out["spec_acceptance"] = (out["spec_accepted"] / proposed
                              if proposed else None)
    return out


def diff(base: Dict[str, Any], new: Dict[str, Any],
         threshold_pct: float = 10.0) -> Dict[str, Any]:
    """Compare two summarize() reports: per-component mean-per-request
    deltas, e2e p50/p99 deltas, the top regressed component, and the
    regression verdict (p99-first — tails are the product here)."""
    comps = _components()
    a, b = base.get("stats") or {}, new.get("stats") or {}
    out: Dict[str, Any] = {"components": {}, "threshold_pct":
                           threshold_pct}
    top, top_delta = None, 0.0
    for c in comps:
        va = (a.get(c) or {}).get("mean_s", 0.0)
        vb = (b.get(c) or {}).get("mean_s", 0.0)
        delta = vb - va
        out["components"][_COMPONENT_LABEL[c]] = {
            "base_s": va, "new_s": vb, "delta_s": delta,
            "delta_pct": (100.0 * delta / va) if va > 0
            else (None if delta > 0 else 0.0)}
        if delta > top_delta:
            top, top_delta = _COMPONENT_LABEL[c], delta
    out["top_regressed"] = top
    for lane in ("p50_s", "p99_s", "mean_s"):
        va = (a.get("e2e") or {}).get(lane, 0.0)
        vb = (b.get("e2e") or {}).get(lane, 0.0)
        out[f"e2e_{lane[:-2]}"] = {
            "base_s": va, "new_s": vb,
            "delta_pct": (100.0 * (vb - va) / va) if va > 0 else 0.0}
    p99 = out["e2e_p99"]["delta_pct"]
    mean = out["e2e_mean"]["delta_pct"]
    out["regressed"] = (p99 > threshold_pct or mean > threshold_pct)
    out["verdict_source"] = "p99" if p99 >= mean else "mean"
    out["total_delta_pct"] = max(p99, mean)
    # counter deltas (retries eat steps, failovers eat re-prefills)
    cdeltas = {}
    for k in ("evictions", "retries", "failovers", "corruptions",
              "swaps", "spill_fetches", "migrations"):
        va = (base.get("counters") or {}).get(k, 0)
        vb = (new.get("counters") or {}).get(k, 0)
        if va != vb:
            cdeltas[k] = {"base": va, "new": vb}
    out["counter_deltas"] = cdeltas
    out["exactness_ok"] = (
        not (base.get("exactness") or {}).get("violations")
        and not (new.get("exactness") or {}).get("violations"))
    return out


# ---------------------------------------------------------------- report
def _fmt_s(v: Optional[float]) -> str:
    if v is None:
        return "n/a"
    if v >= 1.0:
        return f"{v:.4f}s"
    if v >= 1e-3:
        return f"{v * 1e3:.3f}ms"
    return f"{v * 1e6:.1f}us"


def format_summary(report: Dict[str, Any], directory: str) -> str:
    L: List[str] = []
    L.append(f"serve_doctor: {report['requests']} request trace(s) "
             f"from {directory} — {report['finished']} finished, "
             f"{report['shed']} shed, {report['unfinished']} unfinished")
    if not report["finished"]:
        L.append("  no finished requests — is PADDLE_TRACE_DIR set on "
                 "the serving process (and did it flush)?")
        return "\n".join(L)
    ex = report["exactness"]
    if ex["violations"]:
        L.append(f"DECOMPOSITION VIOLATIONS: {len(ex['violations'])}/"
                 f"{ex['checked']} finished request(s) do NOT sum "
                 f"exactly: tids {ex['violations']} — the span "
                 f"bookkeeping (not the arithmetic) is broken")
    else:
        L.append(f"  decomposition exact on all {ex['checked']} "
                 f"finished requests (components + host == e2e, "
                 f"integer-ps)")
    st = report["stats"]
    e2e = st["e2e"]
    L.append(f"  e2e: mean {_fmt_s(e2e['mean_s'])}  p50 "
             f"{_fmt_s(e2e['p50_s'])}  p99 {_fmt_s(e2e['p99_s'])}")
    if "ttft" in st:
        L.append(f"  ttft: p50 {_fmt_s(st['ttft']['p50_s'])}  p99 "
                 f"{_fmt_s(st['ttft']['p99_s'])}")
    parts = "  ".join(
        f"{_COMPONENT_LABEL[c]} {_fmt_s(st[c]['mean_s'])} "
        f"({st[c]['share_pct']:.1f}%)" for c in _components())
    L.append(f"  mean breakdown: {parts}")
    tail = report["tail"]
    L.append(f"TAIL (p99-p50 gap {_fmt_s(tail['gap_s'])}, request "
             f"{tail['p99_tid']} vs {tail['p50_tid']}): owned by "
             f"{tail['owner_label']} "
             f"(+{_fmt_s(tail['owner_gap_s'])})")
    gaps = tail["component_gaps_s"]
    L.append("  gap by component: " + "  ".join(
        f"{_COMPONENT_LABEL[c]} {gaps[c] * 1e6:+.1f}us"
        for c in _components()))
    cnt = report.get("counters") or {}
    if any(cnt.values()):
        L.append("  lifecycle counters: " + "  ".join(
            f"{k}={v}" for k, v in sorted(cnt.items()) if v))
    ch = report.get("chaos")
    if ch:
        L.append("CHAOS ATTRIBUTION (injected faults -> requests)")
        for fault, tids in ch.items():
            L.append(f"  {fault}: tids {tids}")
    thr = report.get("throughput")
    if thr and (thr["prefix_hits"] or thr["prefix_misses"]
                or thr["spec_accepted"] or thr["spec_rejected"]):
        L.append("THROUGHPUT (prefix cache / speculation)")
        if thr["prefix_hits"] or thr["prefix_misses"]:
            hr = thr.get("prefix_hit_rate")
            shared = thr.get("shared_kv_bytes")
            L.append(
                f"  prefix cache: {thr['prefix_hits']:g} hits / "
                f"{thr['prefix_misses']:g} misses"
                + (f" ({hr:.1%} hit rate)" if hr is not None else "")
                + (f", {shared:,.0f} B KV shared"
                   if shared else ""))
        if thr["spec_accepted"] or thr["spec_rejected"]:
            acc = thr.get("spec_acceptance")
            L.append(
                f"  speculation: {thr['spec_accepted']:g} accepted / "
                f"{thr['spec_rejected']:g} rejected drafts"
                + (f" ({acc:.1%} acceptance rate)"
                   if acc is not None else ""))
    slo = report.get("slo")
    if slo and (slo["good"] or slo["bad"]):
        att = slo.get("attainment")
        L.append(f"SLO: {slo['good']:g} good / {slo['bad']:g} bad "
                 f"({att:.1%} attainment)" if att is not None
                 else f"SLO: {slo['good']:g} good / {slo['bad']:g} bad")
        for labels, v in sorted((slo.get("checks") or {}).items()):
            L.append(f"  checks[{labels}]: {v:g}")
        if slo.get("burn_rate") is not None:
            br = slo["burn_rate"]
            tag = "  (BUDGET BURNING)" if br > 1.0 else ""
            L.append(f"  burn rate: {br:.2f}x sustainable{tag}")
    return "\n".join(L)


def format_diff(d: Dict[str, Any]) -> str:
    L: List[str] = []
    p50, p99, mean = d["e2e_p50"], d["e2e_p99"], d["e2e_mean"]
    L.append(f"serve_doctor diff: e2e mean "
             f"{_fmt_s(mean['base_s'])} -> {_fmt_s(mean['new_s'])} "
             f"({mean['delta_pct']:+.2f}%)  p50 "
             f"{_fmt_s(p50['base_s'])} -> {_fmt_s(p50['new_s'])} "
             f"({p50['delta_pct']:+.2f}%)  p99 "
             f"{_fmt_s(p99['base_s'])} -> {_fmt_s(p99['new_s'])} "
             f"({p99['delta_pct']:+.2f}%)")
    for name, c in d["components"].items():
        pct = c["delta_pct"]
        pct_s = f"{pct:+.2f}%" if pct is not None else "new"
        L.append(f"  {name:<14} {_fmt_s(c['base_s'])} -> "
                 f"{_fmt_s(c['new_s'])} ({pct_s})")
    if d["top_regressed"]:
        L.append(f"TOP REGRESSED COMPONENT: {d['top_regressed']} "
                 f"(+{_fmt_s(d['components'][d['top_regressed']]['delta_s'])}"
                 f" per request)")
    else:
        L.append("no component regressed")
    for name, c in sorted(d.get("counter_deltas", {}).items()):
        L.append(f"  counter {name}: {c['base']:g} -> {c['new']:g}")
    if not d.get("exactness_ok", True):
        L.append("  WARNING: one side has decomposition violations")
    src = d["verdict_source"]
    L.append("verdict: "
             + (f"REGRESSION ({src} {d['total_delta_pct']:+.2f}% > "
                f"{d['threshold_pct']:g}% threshold)" if d["regressed"]
                else f"ok ({src} {d['total_delta_pct']:+.2f}% within "
                     f"{d['threshold_pct']:g}%)"))
    return "\n".join(L)


# ---------------------------------------------------------------- CLI
def _load(directory: str) -> List[Dict[str, Any]]:
    from ..observability import tracing
    return tracing.load_trace_dir(directory)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "diff":
        return _main_diff(argv[1:])
    if argv and argv[0] == "summary":
        argv = argv[1:]
    p = argparse.ArgumentParser(
        prog="paddle2_tpu_torch.tools.serve_doctor",
        description="per-request latency decomposition + tail "
                    "attribution from the request-tracing plane "
                    "(see also: the `diff` subcommand)")
    p.add_argument("trace_dir", nargs="?",
                   default=os.environ.get("PADDLE_TRACE_DIR"),
                   help="directory holding trace_rank_N.jsonl "
                        "(default: $PADDLE_TRACE_DIR)")
    p.add_argument("--metrics-dir",
                   default=os.environ.get("PADDLE_METRICS_DIR"),
                   help="metrics dir to join the SLO ledger from "
                        "(default: $PADDLE_METRICS_DIR)")
    p.add_argument("--json", action="store_true",
                   help="emit the structured report as JSON")
    args = p.parse_args(argv)
    if not args.trace_dir:
        p.error("no trace dir: pass one or set PADDLE_TRACE_DIR")
    report = summarize(_load(args.trace_dir),
                       metrics_dir=args.metrics_dir)
    if args.json:
        report = dict(report)
        report.pop("decompositions", None)     # bulky; --json is triage
        print(json.dumps(report, indent=2, default=str))
    else:
        print(format_summary(report, args.trace_dir))
    if report["exactness"]["violations"]:
        return 3
    return 0 if report["finished"] else 2


def _main_diff(argv: List[str]) -> int:
    p = argparse.ArgumentParser(
        prog="paddle2_tpu_torch.tools.serve_doctor diff",
        description="diff two trace streams; exits "
                    f"{REGRESSION_EXIT} on regression (CI gate)")
    p.add_argument("base_dir", help="baseline trace dir (or file)")
    p.add_argument("new_dir", help="candidate trace dir (or file)")
    p.add_argument("--threshold", type=float, default=10.0,
                   help="e2e regression %% (p99 or mean) that fails "
                        "the gate (default 10)")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    base = summarize(_load(args.base_dir))
    new = summarize(_load(args.new_dir))
    if not base["finished"] or not new["finished"]:
        print("serve_doctor diff: one side has no finished requests",
              file=sys.stderr)
        return 2
    d = diff(base, new, threshold_pct=args.threshold)
    if args.json:
        print(json.dumps(d, indent=2, default=str))
    else:
        print(format_diff(d))
    return REGRESSION_EXIT if d["regressed"] else 0


if __name__ == "__main__":
    sys.exit(main())
