"""perf_doctor: triage "where did the step time go" from metrics streams.

The performance sibling of ``flight_doctor``::

    python -m paddle2_tpu_torch.tools.perf_doctor /path/to/metrics_dir
    python -m paddle2_tpu_torch.tools.perf_doctor diff BASELINE_DIR NEW_DIR
    python -m paddle2_tpu_torch.tools.perf_doctor --json metrics_dir

Reads the per-rank JSONL streams the always-on metrics plane writes
(``metrics_rank_N.jsonl`` under ``PADDLE_METRICS_DIR``) and answers the
three triage questions a slow training job raises:

1. **Where does the step go?** Per-rank step-time breakdown — mean
   input-wait / compute / collective / host seconds (components that by
   construction sum to the step total), tokens/s, plus the reliability
   counter set (retries, SDC convictions, quarantines, worker respawns,
   compile-cache hits) so the detect->recover loop is VISIBLE, not just
   logged post-mortem.
2. **Who is slow, and why?** Straggler attribution: ranks whose mean
   step time exceeds ``k x median`` across ranks; slow-INPUT
   attribution: ranks whose input-wait share of the step is an outlier
   (a straggler whose extra time is input wait has a data problem, not
   a chip problem).
3. **What regressed?** ``diff A B`` aligns two streams and names the
   top regressed breakdown component by mean per-step delta, exiting
   ``REGRESSION_EXIT`` (4) when the total regression passes the
   threshold — the CI-gating primitive.

Joins (optional, both best-effort):

* ``--flight-dir`` — flight-recorder rank dumps: step retries, worker
  respawns, chaos events, and dump reasons land in the report, so one
  triage view correlates perf and health;
* ``--trace`` — a merged chrome trace (``profiler.merge_traces``
  output): per-lane ``ProfileStep#`` span means cross-check the
  metrics-plane step totals against the profiler's deep view.

Stdlib-only (the same posture as ``flight_doctor``): runs anywhere the
JSONL lands, never imports torch. The port's own copy of
``paddle2_tpu/tools/perf_doctor.py``: the same reports from the same
streams, so it reads a stream that either package wrote.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from typing import Any, Dict, List, Optional, Tuple

REGRESSION_EXIT = 4
COMPONENTS = ("input_wait_s", "compute_s", "collective_s", "host_s")
_COMPONENT_LABEL = {"input_wait_s": "input-wait", "compute_s": "compute",
                    "collective_s": "collective", "host_s": "host"}
# straggler rule shared with flight_doctor / watchdog defaults
_STRAGGLER_K = 2.0
# reliability counters surfaced in every report (when present)
_RELIABILITY_COUNTERS = (
    "steps_total", "step_retries_total", "reliability_snapshots_total",
    "reliability_restores_total", "sdc_mismatches_total",
    "sdc_convictions_total", "quarantines_total",
    "data_worker_respawns_total", "amp_skipped_steps_total",
    "compiles_total", "compile_cache_hits_total",
    "train_step_compiles_total", "checkpoint_saves_total",
    "checkpoint_restores_total", "checkpoint_save_failures_total",
    "checkpoint_restore_failures_total",
    # serving reliability plane: shed/retry/failover lanes —
    # a serving regression often shows up here before it shows up in
    # step time (sheds eat requests, failovers eat re-prefill compute)
    "serving_shed_total", "serving_deadline_exceeded_total",
    "serving_retries_total", "serving_evictions_total",
    "serving_engine_failures_total", "serving_failovers_total",
    "serving_recovered_seqs_total", "serving_table_corruptions_total",
    "serving_hot_swaps_total",
    # SLO ledger: good/bad requests against the configured
    # TTFT/TPOT/e2e targets — the burn-rate gauge rides the snapshot
    "serving_slo_good_total", "serving_slo_bad_total",
    # serving throughput plane: a prefix-cache hit-rate or
    # speculation acceptance-rate regression is a silent KV-bytes /
    # tokens-per-second regression — surfacing the raw counters in
    # diff makes it NAMEABLE before the modeled throughput moves
    "serving_prefix_hits_total", "serving_prefix_misses_total",
    "serving_prefix_hit_blocks_total",
    "serving_spec_accepted_total", "serving_spec_rejected_total",
    # fleet-global KV ladder: tier traffic — a spill surge
    # is HBM cache pressure, a host/peer-fetch surge is the pressure
    # being absorbed (fetch, not recompute), migrated blocks are
    # failovers resuming without re-prefill
    "serving_kv_spill_blocks_total", "serving_kv_fetch_host_blocks_total",
    "serving_kv_fetch_peer_blocks_total", "serving_kv_migrated_blocks_total",
    # parameter-server plane: pull/push volume, server
    # failures vs failovers (they should pair 1:1 per dead primary),
    # stale reads (bounded-staleness degradation, not an error — but a
    # surge means shards are re-forming), resyncs (corrupt deltas or
    # follower recruits), and the staleness gauge
    "ps_pulls_total", "ps_pushes_total", "ps_server_failures_total",
    "ps_failovers_total", "ps_stale_reads_total", "ps_resyncs_total",
    # expert-parallel MoE plane: routed vs capacity-dropped
    # picks (a drop surge is a capacity-factor/balance problem, not an
    # error — the ledger still closes), host failures vs failovers
    # (pair per dead primary), resyncs (follower recruits), and router
    # collapses (typed watchdog trips — ALWAYS worth reading back)
    "moe_steps_total", "moe_tokens_routed_total",
    "moe_tokens_dropped_total", "moe_expert_fetches_total",
    "moe_expert_stores_total", "moe_expert_host_failures_total",
    "moe_failovers_total", "moe_resyncs_total",
    "moe_router_collapses_total",
    # sequence-parallel plane: ring passes per step (one
    # per layer per attention call — a shortfall vs steps means passes
    # are aborting), host failures vs failovers (pair per dead
    # primary), ring re-formations (each one is a topology change —
    # read the flight recorder), replayed steps (chaos healed through
    # ReliableStep), resyncs (follower recruits), and LSE-merge ledger
    # audits (one per pass; fewer than passes means audits are skipped)
    "sep_steps_total", "sep_ring_passes_total",
    "sep_ring_reformations_total", "sep_replayed_steps_total",
    "sep_lse_audits_total", "sep_host_failures_total",
    "sep_failovers_total", "sep_resyncs_total",
)


# ---------------------------------------------------------------- loading
def load_stream(path: str) -> Dict[str, Any]:
    """Parse one ``metrics_rank_N.jsonl``: step records in order plus
    the LAST metrics snapshot (counters are cumulative — the newest
    snapshot is the total). Unparseable lines are skipped."""
    steps: List[Dict[str, Any]] = []
    snapshot: Dict[str, Any] = {}
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
            if t == "step":
                steps.append(rec)
            elif t == "metrics":
                snapshot = rec
    steps.sort(key=lambda r: r.get("step", 0))
    return {"steps": steps, "snapshot": snapshot, "path": path}


def load_streams(directory: str) -> Dict[int, Dict[str, Any]]:
    """Every ``metrics_rank_N.jsonl`` under ``directory``, keyed by
    rank. A single FILE path is accepted too (rank parsed from the
    name, else 0)."""
    out: Dict[int, Dict[str, Any]] = {}
    if os.path.isfile(directory):
        out[_rank_of(os.path.basename(directory))] = load_stream(directory)
        return out
    if not os.path.isdir(directory):
        return out
    for name in sorted(os.listdir(directory)):
        if name.startswith("metrics_rank_") and name.endswith(".jsonl"):
            out[_rank_of(name)] = load_stream(
                os.path.join(directory, name))
    return out


def _rank_of(name: str) -> int:
    stem = name[len("metrics_rank_"):-len(".jsonl")] \
        if name.startswith("metrics_rank_") else ""
    return int(stem) if stem.isdigit() else 0


def _counter_total(snapshot: Dict[str, Any], name: str) -> float:
    """Sum a counter over all its label sets in a metrics snapshot."""
    series = (snapshot.get("counters") or {}).get(name)
    if not isinstance(series, dict):
        return 0.0
    return sum(v for v in series.values()
               if isinstance(v, (int, float)))


def load_flight_counters(flight_dir: Optional[str]) -> Dict[str, Any]:
    """Best-effort join with flight-recorder dumps: event-kind counts
    and per-rank dump reasons. Parsing is delegated to
    ``flight_doctor.load_dumps`` — ONE reader owns the dump format."""
    out: Dict[str, Any] = {"reasons": {}, "event_counts": {}}
    if not flight_dir or not os.path.isdir(flight_dir):
        return out
    from . import flight_doctor
    try:
        dumps = flight_doctor.load_dumps(flight_dir)
    except OSError:
        return out
    for rank, dump in dumps.items():
        out["reasons"][rank] = dump["header"].get("reason")
        for ev in dump["events"]:
            k = ev.get("kind")
            out["event_counts"][k] = out["event_counts"].get(k, 0) + 1
    return out


def load_trace_steps(trace_path: Optional[str]) -> Dict[str, Any]:
    """Per-lane ``ProfileStep#`` span stats from a (merged) chrome
    trace — the profiler's view of the same step cadence."""
    out: Dict[str, Any] = {}
    if not trace_path or not os.path.isfile(trace_path):
        return out
    try:
        with open(trace_path) as f:
            trace = json.load(f)
    except (OSError, ValueError):
        return out
    lanes: Dict[Any, str] = {}
    spans: Dict[Any, List[float]] = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "M" and e.get("name") == "process_name":
            lanes[e.get("pid")] = (e.get("args") or {}).get("name")
        elif str(e.get("name", "")).startswith("ProfileStep#"):
            spans.setdefault(e.get("pid"), []).append(
                float(e.get("dur", 0.0)) / 1e6)
    for pid, durs in sorted(spans.items()):
        out[str(lanes.get(pid, pid))] = {
            "steps": len(durs),
            "mean_step_s": sum(durs) / len(durs) if durs else 0.0}
    return out


# ---------------------------------------------------------------- analysis
def hist_quantile(buckets: List[Optional[float]], counts: List[float],
                  q: float) -> Optional[float]:
    """Prometheus-style ``histogram_quantile``: cumulative per-bucket
    counts (``None`` upper bound = +Inf) -> the ``q``-quantile
    estimate, linearly interpolated inside the owning bucket. The
    +Inf bucket returns the highest finite bound (the standard
    convention — the true value is only known to be beyond it)."""
    if not counts or counts[-1] <= 0 or len(buckets) != len(counts):
        return None
    total = counts[-1]
    target = q / 100.0 * total
    prev_cum, prev_ub = 0.0, 0.0
    for ub, cum in zip(buckets, counts):
        if cum >= target:
            if ub is None:                 # +Inf bucket owns it
                return prev_ub
            in_bucket = cum - prev_cum
            if in_bucket <= 0:
                return float(ub)
            frac = (target - prev_cum) / in_bucket
            return prev_ub + (float(ub) - prev_ub) * frac
        prev_cum = cum
        if ub is not None:
            prev_ub = float(ub)
    return prev_ub


def histogram_lanes(streams: Dict[int, Dict[str, Any]]
                    ) -> Dict[str, Dict[str, Any]]:
    """Merge every rank's newest histogram snapshot into p50/p99 lanes
    (bucket counts are cumulative AND mergeable: same bucket layout ->
    element-wise sum). Series without bucket counts (older
    streams) are skipped — sum/count alone cannot give percentiles."""
    merged: Dict[Tuple[str, str], Dict[str, Any]] = {}
    for s in streams.values():
        hists = (s.get("snapshot") or {}).get("histograms") or {}
        for name, series in hists.items():
            if not isinstance(series, dict):
                continue
            for labels, h in series.items():
                if not isinstance(h, dict) or "counts" not in h:
                    continue
                key = (name, labels)
                m = merged.get(key)
                if m is None:
                    merged[key] = {"buckets": list(h["buckets"]),
                                   "counts": list(h["counts"]),
                                   "sum": float(h.get("sum", 0.0)),
                                   "count": float(h.get("count", 0)),
                                   "skipped_series": 0}
                elif m["buckets"] == list(h["buckets"]):
                    m["counts"] = [a + b for a, b in
                                   zip(m["counts"], h["counts"])]
                    m["sum"] += float(h.get("sum", 0.0))
                    m["count"] += float(h.get("count", 0))
                else:
                    # mismatched bucket layout (mixed builds): counts
                    # cannot merge — SAY so instead of silently
                    # presenting one rank's view as the fleet's
                    m["skipped_series"] += 1
    out: Dict[str, Dict[str, Any]] = {}
    for (name, labels), m in sorted(merged.items()):
        if m["count"] <= 0:
            continue
        key = f"{name}{{{labels}}}" if labels else name
        out[key] = {
            "count": m["count"],
            "mean": m["sum"] / m["count"],
            "p50": hist_quantile(m["buckets"], m["counts"], 50.0),
            "p99": hist_quantile(m["buckets"], m["counts"], 99.0),
        }
        if m["skipped_series"]:
            out[key]["skipped_series"] = m["skipped_series"]
    return out


def _mean(vals: List[float]) -> float:
    return statistics.fmean(vals) if vals else 0.0


def _median(vals: List[float]) -> float:
    return statistics.median(vals) if vals else 0.0


def summarize(streams: Dict[int, Dict[str, Any]],
              warmup: int = 1) -> Dict[str, Any]:
    """Merge per-rank streams into the triage report dict. The first
    ``warmup`` step records per rank are excluded from the means (step
    0 carries compile+first-dispatch; averaging it in would misname
    compute as the top component of every short run)."""
    report: Dict[str, Any] = {"ranks": sorted(streams), "per_rank": {},
                              "aggregate": {}, "counters": {},
                              "straggler": {}, "warmup_excluded": warmup}
    totals_by_rank: Dict[int, float] = {}
    input_share_by_rank: Dict[int, float] = {}
    all_counters: Dict[str, float] = {}
    for r, s in sorted(streams.items()):
        short = len(s["steps"]) <= warmup
        steps = s["steps"] if short else s["steps"][warmup:]
        if not steps:
            continue
        entry: Dict[str, Any] = {
            "steps": len(steps),
            # a stream shorter than the warmup window can only report
            # its compile-tainted records — flag it rather than hide it
            "warmup_included": short,
            "mean_total_s": _mean([x.get("total_s", 0.0)
                                   for x in steps]),
        }
        for c in COMPONENTS:
            entry[f"mean_{c}"] = _mean([x.get(c, 0.0) for x in steps])
        # exposed-comm %: wire time that EXTENDED the step. Prefer the
        # modeled figure (cost-model overlap accounting stamped into
        # step records as `exposed_comm_s` by cost x rate benches);
        # fall back to the measured collective phase — eager collective
        # dispatch wall time is exposed by construction (the host
        # blocked on it), while compiled-step collectives never show up
        # there at all.
        exp = [x["exposed_comm_s"] for x in steps
               if "exposed_comm_s" in x]
        if exp:
            entry["mean_exposed_comm_s"] = _mean(exp)
            entry["exposed_comm_source"] = "modeled"
        else:
            entry["mean_exposed_comm_s"] = entry["mean_collective_s"]
            entry["exposed_comm_source"] = "collective-wall"
        if entry["mean_total_s"] > 0:
            entry["exposed_comm_pct"] = (
                100.0 * entry["mean_exposed_comm_s"]
                / entry["mean_total_s"])
        # ICI-vs-DCN components of the exposed-comm lane (cost x rate
        # benches stamp exposed_comm_ici_s/exposed_comm_dcn_s from the
        # cost model's per-link-class overlap split): a cross-slice DCN
        # overlap regression is nameable as such instead of collapsing
        # both wire classes into one number
        for cls in ("ici", "dcn"):
            key = f"exposed_comm_{cls}_s"
            vals = [x[key] for x in steps if key in x]
            if vals:
                entry[f"mean_{key}"] = _mean(vals)
                if entry["mean_total_s"] > 0:
                    entry[f"exposed_comm_{cls}_pct"] = (
                        100.0 * entry[f"mean_{key}"]
                        / entry["mean_total_s"])
        toks = [x["tokens"] for x in steps if "tokens" in x]
        secs = [x["total_s"] for x in steps if "tokens" in x]
        if toks and sum(secs) > 0:
            entry["tokens_per_s"] = sum(toks) / sum(secs)
        # modeled step cost (cost x rate benches — the serving engine
        # stamps `modeled_step_s` per decode step): deterministic, so
        # diffing it across runs carries zero shared-host wall-clock noise
        mod = [x["modeled_step_s"] for x in steps
               if "modeled_step_s" in x]
        if mod:
            entry["mean_modeled_step_s"] = _mean(mod)
            mtoks = [x["tokens"] for x in steps
                     if "modeled_step_s" in x and "tokens" in x]
            if mtoks and sum(mod) > 0:
                entry["modeled_tokens_per_s"] = sum(mtoks) / sum(mod)
        # MFU / roofline lane: records stamped with the cost model's
        # (modeled_flops, roofline_s, peak_flops) triple — modeled
        # FLOPs over the roofline time, as a fraction of the chip
        # peak. Deterministic (pure function of program + rate model),
        # so the diff verdict below can gate on it without wall-clock
        # noise.
        mfus = [x["modeled_flops"] / (x["roofline_s"] * x["peak_flops"])
                for x in steps
                if x.get("modeled_flops") and x.get("roofline_s")
                and x.get("peak_flops")]
        if mfus:
            entry["mfu_modeled"] = _mean(mfus)
        # cost x rate economics lane: records stamped with
        # (chip_seconds, served_tokens) pairs — modeled chip-seconds
        # spent over tokens delivered. Deterministic like the modeled
        # step, so the diff verdict can gate on COST PER SERVED TOKEN
        # with zero wall-clock noise. The raw sums ride along so the
        # aggregate below can divide fleet chips by fleet tokens
        # instead of averaging per-rank ratios.
        cpairs = [(x["chip_seconds"], x["served_tokens"]) for x in steps
                  if "chip_seconds" in x and "served_tokens" in x]
        if cpairs:
            chip_sum = sum(c for c, _ in cpairs)
            tok_sum = sum(t for _, t in cpairs)
            entry["chip_seconds_total"] = chip_sum
            entry["served_tokens_total"] = tok_sum
            if tok_sum > 0:
                entry["cost_per_served_token"] = chip_sum / tok_sum
        samp = [x["samples"] for x in steps if "samples" in x]
        if samp and entry["mean_total_s"] > 0:
            entry["samples_per_s"] = _mean(samp) / entry["mean_total_s"]
        if any("loss_scale" in x for x in steps):
            entry["last_loss_scale"] = [
                x["loss_scale"] for x in steps
                if "loss_scale" in x][-1]
        report["per_rank"][r] = entry
        totals_by_rank[r] = entry["mean_total_s"]
        if entry["mean_total_s"] > 0:
            input_share_by_rank[r] = (entry["mean_input_wait_s"]
                                      / entry["mean_total_s"])
        for cname in _RELIABILITY_COUNTERS:
            v = _counter_total(s.get("snapshot") or {}, cname)
            if v:
                all_counters[cname] = all_counters.get(cname, 0.0) + v
    report["counters"] = all_counters
    per = report["per_rank"]
    if per:
        agg = {"steps": sum(e["steps"] for e in per.values()),
               "mean_total_s": _mean([e["mean_total_s"]
                                      for e in per.values()])}
        for c in COMPONENTS:
            agg[f"mean_{c}"] = _mean([e[f"mean_{c}"]
                                      for e in per.values()])
        tps = [e["tokens_per_s"] for e in per.values()
               if "tokens_per_s" in e]
        if tps:
            agg["tokens_per_s_total"] = sum(tps)
        pcts = [e["exposed_comm_pct"] for e in per.values()
                if "exposed_comm_pct" in e]
        if pcts:
            agg["exposed_comm_pct"] = _mean(pcts)
            srcs = {e["exposed_comm_source"] for e in per.values()
                    if "exposed_comm_source" in e}
            agg["exposed_comm_source"] = (srcs.pop() if len(srcs) == 1
                                          else "mixed")
        # per-link-class lanes aggregate only when EVERY rank carries
        # them (same gating as the modeled/MFU lanes: a mixed stream
        # would average a cost model against nothing)
        for cls in ("ici", "dcn"):
            cvals = [e.get(f"exposed_comm_{cls}_pct")
                     for e in per.values()]
            if cvals and all(v is not None for v in cvals):
                agg[f"exposed_comm_{cls}_pct"] = _mean(cvals)
        # aggregate modeled lane only when EVERY rank carries it —
        # a mixed stream would average a cost model against nothing
        mods = [e.get("mean_modeled_step_s") for e in per.values()]
        if mods and all(m is not None for m in mods):
            agg["mean_modeled_step_s"] = _mean(mods)
            mtps = [e["modeled_tokens_per_s"] for e in per.values()
                    if "modeled_tokens_per_s" in e]
            if mtps:
                agg["modeled_tokens_per_s_total"] = sum(mtps)
        # MFU lane aggregates only when EVERY rank carries it — one
        # rank's cost model averaged against nothing is not a fleet MFU
        mfu_vals = [e.get("mfu_modeled") for e in per.values()]
        if mfu_vals and all(m is not None for m in mfu_vals):
            agg["mfu_modeled"] = _mean(mfu_vals)
        # cost lane aggregates only when EVERY rank carries it, and as
        # fleet-chips / fleet-tokens (NOT a mean of ratios: a rank that
        # served 10 tokens would weigh as much as one that served 10k)
        cost_vals = [e.get("cost_per_served_token") for e in per.values()]
        if cost_vals and all(c is not None for c in cost_vals):
            fleet_chips = sum(e["chip_seconds_total"]
                              for e in per.values())
            fleet_toks = sum(e["served_tokens_total"]
                             for e in per.values())
            if fleet_toks > 0:
                agg["cost_per_served_token"] = fleet_chips / fleet_toks
                agg["served_tokens_total"] = fleet_toks
                agg["chip_seconds_total"] = fleet_chips
        if agg["mean_total_s"] > 0:
            agg["breakdown_pct"] = {
                _COMPONENT_LABEL[c]: 100.0 * agg[f"mean_{c}"]
                / agg["mean_total_s"] for c in COMPONENTS}
        report["aggregate"] = agg

    # histogram p50/p99 lanes from the cumulative bucket counts the
    # snapshots carry (checkpoint-save seconds, serving TTFT, ...)
    report["histograms"] = histogram_lanes(streams)

    # straggler + slow-input attribution (>= 2 ranks to compare)
    if len(totals_by_rank) >= 2:
        med = _median(list(totals_by_rank.values()))
        report["straggler"]["step_time"] = {
            "median_s": med,
            "suspects": sorted(
                (r for r, t in totals_by_rank.items()
                 if med > 0 and t > _STRAGGLER_K * med),
                key=lambda r: -totals_by_rank[r])}
        med_share = _median(list(input_share_by_rank.values()))
        report["straggler"]["input_wait"] = {
            "median_share": med_share,
            "suspects": sorted(
                (r for r, sh in input_share_by_rank.items()
                 if sh > max(_STRAGGLER_K * med_share, 0.05)),
                key=lambda r: -input_share_by_rank[r])}
    return report


def diff(base: Dict[str, Any], new: Dict[str, Any],
         threshold_pct: float = 10.0) -> Dict[str, Any]:
    """Compare two summarize() reports: per-component mean-step deltas,
    the top regressed component, and the regression verdict."""
    a = base.get("aggregate") or {}
    b = new.get("aggregate") or {}
    comps: Dict[str, Dict[str, float]] = {}
    top: Optional[str] = None
    top_delta = 0.0
    for c in COMPONENTS:
        va, vb = a.get(f"mean_{c}", 0.0), b.get(f"mean_{c}", 0.0)
        delta = vb - va
        # None = "new component" (base was 0): inf would serialize as
        # a bare Infinity literal and break --json consumers
        comps[_COMPONENT_LABEL[c]] = {
            "base_s": va, "new_s": vb, "delta_s": delta,
            "delta_pct": (100.0 * delta / va) if va > 0 else
            (None if delta > 0 else 0.0)}
        if delta > top_delta:
            top_delta = delta
            top = _COMPONENT_LABEL[c]
    ta, tb = a.get("mean_total_s", 0.0), b.get("mean_total_s", 0.0)
    total_delta_pct = (100.0 * (tb - ta) / ta) if ta > 0 else 0.0
    out = {
        "components": comps,
        "top_regressed": top,
        "base_total_s": ta, "new_total_s": tb,
        "total_delta_pct": total_delta_pct,
        "threshold_pct": threshold_pct,
        "regressed": total_delta_pct > threshold_pct,
        "verdict_source": "wall",
    }
    # when BOTH streams carry the modeled-step lane (cost x rate
    # benches, the serving engine), the regression verdict uses the
    # MODELED delta: it is a pure function of (program, rate model),
    # so CI diffs of identical code are exactly 0% instead of shared-host
    # wall-clock noise tripping the threshold
    ma = a.get("mean_modeled_step_s")
    mb = b.get("mean_modeled_step_s")
    if ma is not None or mb is not None:
        comparable = ma is not None and mb is not None
        mdelta = (100.0 * (mb - ma) / ma) if comparable and ma > 0 \
            else None
        out["modeled_step"] = {
            "base_s": ma, "new_s": mb, "delta_pct": mdelta,
            "comparable": comparable,
            "base_tokens_per_s": a.get("modeled_tokens_per_s_total"),
            "new_tokens_per_s": b.get("modeled_tokens_per_s_total"),
        }
        if mdelta is not None:
            out["total_delta_pct"] = mdelta
            out["regressed"] = mdelta > threshold_pct
            out["verdict_source"] = "modeled"
    # MFU / roofline delta: deterministic like the modeled step, so a
    # drop IS a program-shape regression (a remat policy that stopped
    # fitting, a fast path that fell back) — comparable only when both
    # streams carry the lane, and then it FAILS the gate exactly like
    # a modeled-step regression does
    fa = a.get("mfu_modeled")
    fb = b.get("mfu_modeled")
    if fa is not None or fb is not None:
        comparable = fa is not None and fb is not None
        drop_pct = (100.0 * (fa - fb) / fa) if comparable and fa > 0 \
            else None
        out["mfu_modeled"] = {
            "base": fa, "new": fb, "drop_pct": drop_pct,
            "comparable": comparable,
            "regressed": bool(drop_pct is not None
                              and drop_pct > threshold_pct)}
        if out["mfu_modeled"]["regressed"] and not out["regressed"]:
            out["regressed"] = True
            out["verdict_source"] = "mfu"
            out["total_delta_pct"] = drop_pct
    # cost-per-served-token delta: deterministic economics —
    # a RISE is a regression (more chip-seconds bought per token
    # delivered). Comparable only when both streams carry the lane, and
    # then it fails the gate exactly like a modeled-step regression.
    ca = a.get("cost_per_served_token")
    cb = b.get("cost_per_served_token")
    if ca is not None or cb is not None:
        comparable = ca is not None and cb is not None
        rise_pct = (100.0 * (cb - ca) / ca) if comparable and ca > 0 \
            else None
        out["cost_per_served_token"] = {
            "base": ca, "new": cb, "delta_pct": rise_pct,
            "comparable": comparable,
            "base_served_tokens": a.get("served_tokens_total"),
            "new_served_tokens": b.get("served_tokens_total"),
            "regressed": bool(rise_pct is not None
                              and rise_pct > threshold_pct)}
        if out["cost_per_served_token"]["regressed"] \
                and not out["regressed"]:
            out["regressed"] = True
            out["verdict_source"] = "cost"
            out["total_delta_pct"] = rise_pct
    # exposed-comm % delta: an overlap regression (a bucket that
    # stopped hiding under backward, a prefetch that went eager) shows
    # up HERE even when total step time moved for other reasons too.
    # Only COMPARABLE when both sides measured it the same way — a
    # modeled stream diffed against a collective-wall fallback stream
    # is a metric-source change, not an overlap change.
    if "exposed_comm_pct" in a or "exposed_comm_pct" in b:
        sa = a.get("exposed_comm_source")
        sb = b.get("exposed_comm_source")
        out["exposed_comm_pct"] = {
            "base": a.get("exposed_comm_pct", 0.0),
            "new": b.get("exposed_comm_pct", 0.0),
            "base_source": sa, "new_source": sb,
            "comparable": sa == sb and sa is not None
            and sa != "mixed"}
        # per-link-class deltas ride along when both streams carry the
        # split, so the OVERLAP REGRESSION marker can name WHICH wire
        # class stopped hiding (a grown DCN share is a cross-slice
        # hierarchy/bucketing problem; a grown ICI share is in-slice)
        for cls in ("ici", "dcn"):
            ka = a.get(f"exposed_comm_{cls}_pct")
            kb = b.get(f"exposed_comm_{cls}_pct")
            if ka is not None and kb is not None:
                out["exposed_comm_pct"][cls] = {"base": ka, "new": kb}
    # counter deltas that explain a regression (retries eat wall time)
    cdeltas = {}
    for cname in _RELIABILITY_COUNTERS:
        va = (base.get("counters") or {}).get(cname, 0.0)
        vb = (new.get("counters") or {}).get(cname, 0.0)
        if vb != va:
            cdeltas[cname] = {"base": va, "new": vb}
    out["counter_deltas"] = cdeltas
    return out


# ---------------------------------------------------------------- report
def _fmt_s(v: float) -> str:
    if v >= 1.0:
        return f"{v:.3f}s"
    return f"{v * 1e3:.3f}ms"


def format_summary(report: Dict[str, Any], directory: str) -> str:
    L: List[str] = []
    ranks = report["ranks"]
    L.append(f"perf_doctor: merged {len(ranks)} rank stream(s) from "
             f"{directory}")
    if not report["per_rank"]:
        L.append("  no step records found — is PADDLE_METRICS_DIR set "
                 "on the workers (and did the run call metrics.flush() "
                 "or exit cleanly)?")
        return "\n".join(L)
    agg = report["aggregate"]
    L.append(f"  steps: {agg['steps']} (first {report['warmup_excluded']}"
             f" per rank excluded as warmup)   mean step: "
             f"{_fmt_s(agg['mean_total_s'])}")
    if "breakdown_pct" in agg:
        parts = "  ".join(
            f"{name} {_fmt_s(agg['mean_' + c])} "
            f"({agg['breakdown_pct'][name]:.1f}%)"
            for c, name in _COMPONENT_LABEL.items())
        L.append(f"  breakdown: {parts}")
    if "tokens_per_s_total" in agg:
        L.append(f"  throughput: {agg['tokens_per_s_total']:,.0f} "
                 f"tokens/s aggregate")
    if "exposed_comm_pct" in agg:
        split = ""
        if ("exposed_comm_ici_pct" in agg
                or "exposed_comm_dcn_pct" in agg):
            split = (f" [ici {agg.get('exposed_comm_ici_pct', 0.0):.1f}%"
                     f" + dcn "
                     f"{agg.get('exposed_comm_dcn_pct', 0.0):.1f}%]")
        L.append(f"  exposed-comm: {agg['exposed_comm_pct']:.1f}% of "
                 f"step (wire time NOT hidden under compute){split}")
    if "mfu_modeled" in agg:
        L.append(f"  MFU (modeled): {100.0 * agg['mfu_modeled']:.1f}% "
                 f"of chip peak over the roofline step time "
                 f"(deterministic cost model)")
    if "cost_per_served_token" in agg:
        L.append(f"  cost: {agg['cost_per_served_token']:.3e} "
                 f"chip-seconds per served token "
                 f"({agg['chip_seconds_total']:,.0f} chip-s over "
                 f"{agg['served_tokens_total']:,.0f} tokens, modeled)")
    for r, e in sorted(report["per_rank"].items()):
        extra = ""
        if "tokens_per_s" in e:
            extra = f"  {e['tokens_per_s']:,.0f} tok/s"
        if "exposed_comm_pct" in e:
            extra += (f"  exposed-comm {e['exposed_comm_pct']:.1f}% "
                      f"[{e['exposed_comm_source']}]")
            if "exposed_comm_dcn_pct" in e:
                extra += (f" (ici "
                          f"{e.get('exposed_comm_ici_pct', 0.0):.1f}%"
                          f"/dcn {e['exposed_comm_dcn_pct']:.1f}%)")
        if "mfu_modeled" in e:
            extra += f"  MFU {100.0 * e['mfu_modeled']:.1f}%"
        if "cost_per_served_token" in e:
            extra += (f"  cost {e['cost_per_served_token']:.3e} "
                      f"chip-s/token")
        if e.get("warmup_included"):
            extra += "  [WARMUP INCLUDED: stream shorter than warmup]"
        L.append(f"  rank {r}: {e['steps']} steps, mean "
                 f"{_fmt_s(e['mean_total_s'])} (input "
                 f"{_fmt_s(e['mean_input_wait_s'])}, compute "
                 f"{_fmt_s(e['mean_compute_s'])}, collective "
                 f"{_fmt_s(e['mean_collective_s'])}, host "
                 f"{_fmt_s(e['mean_host_s'])}){extra}")
    if report["counters"]:
        L.append("RELIABILITY COUNTERS")
        for name, v in sorted(report["counters"].items()):
            L.append(f"  {name}: {v:g}")
    if report.get("histograms"):
        L.append("HISTOGRAMS (p50/p99 from cumulative bucket counts)")
        for name, h in report["histograms"].items():
            p50 = _fmt_s(h["p50"]) if h["p50"] is not None else "n/a"
            p99 = _fmt_s(h["p99"]) if h["p99"] is not None else "n/a"
            tag = (f"  [INCOMPLETE: {h['skipped_series']} series "
                   f"with a different bucket layout skipped]"
                   if h.get("skipped_series") else "")
            L.append(f"  {name}: n={h['count']:g} "
                     f"mean={_fmt_s(h['mean'])} p50~{p50} p99~{p99}"
                     f"{tag}")
    s = report.get("straggler", {})
    st = s.get("step_time", {})
    si = s.get("input_wait", {})
    if st.get("suspects"):
        L.append(f"STRAGGLER: rank(s) "
                 f"{','.join(map(str, st['suspects']))} mean step time "
                 f"> {_STRAGGLER_K:g}x the {_fmt_s(st['median_s'])} "
                 f"median")
    if si.get("suspects"):
        L.append(f"SLOW INPUT: rank(s) "
                 f"{','.join(map(str, si['suspects']))} input-wait "
                 f"share is an outlier (median share "
                 f"{si['median_share']:.1%}) — a data-pipeline "
                 f"problem, not a chip problem")
    fl = report.get("flight") or {}
    if fl.get("reasons") or fl.get("event_counts"):
        L.append("FLIGHT-RECORDER JOIN")
        for r, reason in sorted(fl.get("reasons", {}).items()):
            L.append(f"  rank {r} dumped for {reason!r}")
        interesting = {k: v for k, v in fl.get("event_counts",
                                               {}).items()
                       if k in ("step_retry", "worker_respawn", "chaos",
                                "collective_timeout", "watchdog_overrun",
                                "scale_update", "compile")}
        if interesting:
            L.append("  events: " + "  ".join(
                f"{k}={v}" for k, v in sorted(interesting.items())))
    tr = report.get("trace") or {}
    if tr:
        L.append("MERGED-TRACE JOIN (ProfileStep spans)")
        for lane, e in sorted(tr.items()):
            L.append(f"  {lane}: {e['steps']} steps, mean "
                     f"{_fmt_s(e['mean_step_s'])}")
    return "\n".join(L)


def format_diff(d: Dict[str, Any]) -> str:
    L: List[str] = []
    L.append(f"perf_doctor diff: mean step {_fmt_s(d['base_total_s'])} "
             f"-> {_fmt_s(d['new_total_s'])} "
             f"({d['total_delta_pct']:+.1f}%)")
    for name, c in d["components"].items():
        pct = c["delta_pct"]
        pct_s = f"{pct:+.1f}%" if pct is not None else "new"
        L.append(f"  {name:<11} {_fmt_s(c['base_s'])} -> "
                 f"{_fmt_s(c['new_s'])} ({pct_s})")
    if d["top_regressed"]:
        L.append(f"TOP REGRESSED COMPONENT: {d['top_regressed']} "
                 f"(+{_fmt_s(d['components'][d['top_regressed']]['delta_s'])}"
                 f" per step)")
    else:
        L.append("no component regressed")
    ec = d.get("exposed_comm_pct")
    if ec:
        if ec.get("comparable"):
            tag = ""
            if ec["new"] > ec["base"] + 1.0:
                # name the wire class that stopped hiding when the
                # split lanes are present — a DCN regression is a
                # cross-slice hierarchy/bucketing problem, an ICI one
                # is in-slice overlap
                cls_tags = [cls.upper() for cls in ("dcn", "ici")
                            if ec.get(cls)
                            and ec[cls]["new"] > ec[cls]["base"] + 1.0]
                tag = (f"  ({' + '.join(cls_tags)} OVERLAP REGRESSION)"
                       if cls_tags else "  (OVERLAP REGRESSION)")
        else:
            tag = (f"  [incomparable: {ec['base_source']} vs "
                   f"{ec['new_source']}]")
        L.append(f"  exposed-comm: {ec['base']:.1f}% -> "
                 f"{ec['new']:.1f}% of step{tag}")
        for cls in ("ici", "dcn"):
            if ec.get(cls):
                L.append(f"    {cls}: {ec[cls]['base']:.1f}% -> "
                         f"{ec[cls]['new']:.1f}%")
    mf = d.get("mfu_modeled")
    if mf:
        if mf.get("comparable"):
            tag = "  (MFU REGRESSION)" if mf["regressed"] else ""
            L.append(f"  MFU (modeled): {100.0 * mf['base']:.1f}% -> "
                     f"{100.0 * mf['new']:.1f}% of peak{tag}")
        else:
            L.append("  MFU (modeled): [incomparable: only one stream "
                     "carries the roofline lane]")
    co = d.get("cost_per_served_token")
    if co:
        if co.get("comparable"):
            tag = "  (COST REGRESSION)" if co["regressed"] else ""
            L.append(f"  cost/served-token: {co['base']:.3e} -> "
                     f"{co['new']:.3e} chip-s "
                     f"({co['delta_pct']:+.2f}%, deterministic){tag}")
        else:
            L.append("  cost/served-token: [incomparable: only one "
                     "stream carries the cost lane]")
    ms = d.get("modeled_step")
    if ms:
        if ms.get("comparable"):
            L.append(f"  modeled step: {_fmt_s(ms['base_s'])} -> "
                     f"{_fmt_s(ms['new_s'])} "
                     f"({ms['delta_pct']:+.2f}%, deterministic)")
            if ms.get("base_tokens_per_s") and ms.get("new_tokens_per_s"):
                L.append(f"  modeled tokens/s: "
                         f"{ms['base_tokens_per_s']:,.0f} -> "
                         f"{ms['new_tokens_per_s']:,.0f}")
        else:
            L.append("  modeled step: [incomparable: only one stream "
                     "carries modeled_step_s]")
    for name, c in sorted(d.get("counter_deltas", {}).items()):
        L.append(f"  counter {name}: {c['base']:g} -> {c['new']:g}")
    src = d.get("verdict_source", "wall")
    L.append(f"verdict: "
             + (f"REGRESSION ({src} {d['total_delta_pct']:+.1f}% > "
                f"{d['threshold_pct']:g}% threshold)" if d["regressed"]
                else f"ok ({src} {d['total_delta_pct']:+.1f}% within "
                     f"{d['threshold_pct']:g}%)"))
    return "\n".join(L)


# ---------------------------------------------------------------- CLI
def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "diff":
        return _main_diff(argv[1:])
    if argv and argv[0] == "summary":
        argv = argv[1:]
    p = argparse.ArgumentParser(
        prog="paddle2_tpu_torch.tools.perf_doctor",
        description="step-time breakdown, throughput, and reliability-"
                    "counter triage from the always-on metrics plane "
                    "(see also: the `diff` subcommand)")
    p.add_argument("metrics_dir", nargs="?",
                   default=os.environ.get("PADDLE_METRICS_DIR"),
                   help="directory holding metrics_rank_N.jsonl "
                        "(default: $PADDLE_METRICS_DIR)")
    p.add_argument("--flight-dir",
                   default=os.environ.get("PADDLE_FLIGHT_DIR"),
                   help="flight-recorder dump dir to join "
                        "(default: $PADDLE_FLIGHT_DIR)")
    p.add_argument("--trace", default=None,
                   help="merged chrome trace (profiler.merge_traces "
                        "output) to cross-check step spans against")
    p.add_argument("--warmup", type=int, default=1,
                   help="per-rank step records excluded from means "
                        "(default 1: the compile step)")
    p.add_argument("--json", action="store_true",
                   help="emit the structured report as JSON")
    args = p.parse_args(argv)
    if not args.metrics_dir:
        p.error("no metrics dir: pass one or set PADDLE_METRICS_DIR")
    streams = load_streams(args.metrics_dir)
    report = summarize(streams, warmup=max(0, args.warmup))
    report["flight"] = load_flight_counters(args.flight_dir)
    report["trace"] = load_trace_steps(args.trace)
    if args.json:
        print(json.dumps(report, indent=2, default=str))
    else:
        print(format_summary(report, args.metrics_dir))
    return 0 if report["per_rank"] else 2


def _main_diff(argv: List[str]) -> int:
    p = argparse.ArgumentParser(
        prog="paddle2_tpu_torch.tools.perf_doctor diff",
        description="diff two metrics streams; exits "
                    f"{REGRESSION_EXIT} on regression (CI gate)")
    p.add_argument("base_dir", help="baseline metrics dir (or file)")
    p.add_argument("new_dir", help="candidate metrics dir (or file)")
    p.add_argument("--threshold", type=float, default=10.0,
                   help="total mean-step regression %% that fails the "
                        "gate (default 10)")
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    base = summarize(load_streams(args.base_dir),
                     warmup=max(0, args.warmup))
    new = summarize(load_streams(args.new_dir),
                    warmup=max(0, args.warmup))
    if not base["per_rank"] or not new["per_rank"]:
        print("perf_doctor diff: one side has no step records",
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
