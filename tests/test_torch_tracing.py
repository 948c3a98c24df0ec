"""The port's request tracing (paddle2_tpu_torch.observability.tracing)
against the JAX package's (paddle2_tpu.observability.tracing).

The hand-built span records of ``tests/test_tracing.py`` (and cases for
the spill-fetch, migration, hot-swap and shed events) decompose to equal
reports in both modules, bit for bit (integer picoseconds); a
``TracePlane`` of either package writes the same JSONL stream and chrome
trace for the same events, and either package's ``load_trace_dir``
reads the other's stream. The serving producers of these spans come
with the serving hooks; no case here needs a model."""

import dis
import json

import pytest

from paddle2_tpu.observability import tracing as jtracing
from paddle2_tpu_torch.observability import tracing as ttracing

MODS = {"jax": jtracing, "torch": ttracing}


@pytest.fixture(autouse=True)
def _clean_planes():
    yield
    for m in MODS.values():
        m.disable()


def _rec(event, t, **kw):
    return {"type": "span", "event": event, "t": t, **kw}


CASES = {
    "basic_lifecycle": [
        _rec("submit", 1.0, tid=7), _rec("admit", 1.25, tid=7),
        _rec("prefill", 1.25, end=1.5, tid=7),
        _rec("decode_step", 1.5, dur=0.1, tids=[7]),
        _rec("decode_step", 1.7, dur=0.1, tids=[7]),
        _rec("finish", 1.8, tid=7, tokens=3)],
    "eviction_and_failover": [
        _rec("submit", 0.0, tid=1), _rec("admit", 0.1, tid=1),
        _rec("prefill", 0.1, end=0.2, tid=1), _rec("evict", 0.3, tid=1),
        _rec("admit", 0.5, tid=1), _rec("prefill", 0.5, end=0.7, tid=1),
        _rec("engine_failed", 0.8, tids=[1]), _rec("adopt", 0.9, tid=1),
        _rec("admit", 1.0, tid=1), _rec("prefill", 1.0, end=1.1, tid=1),
        _rec("finish", 1.1, tid=1, tokens=1)],
    "midflight_death_clips_prefill": [
        _rec("submit", 0.0, tid=3), _rec("admit", 0.1, tid=3),
        _rec("prefill", 0.1, end=0.6, tid=3),
        _rec("engine_failed", 0.3, tids=[3]), _rec("adopt", 0.4, tid=3),
        _rec("admit", 0.5, tid=3), _rec("prefill", 0.5, end=0.7, tid=3),
        _rec("finish", 0.7, tid=3, tokens=1)],
    "overlapping_bookkeeping": [
        _rec("submit", 0.0, tid=9), _rec("admit", 0.0, tid=9),
        _rec("decode_step", 0.0, dur=2.0, tids=[9]),
        _rec("finish", 1.0, tid=9, tokens=1)],
    "dropped_decode": [
        _rec("submit", 0.0, tid=2), _rec("admit", 0.0, tid=2),
        _rec("prefill", 0.0, end=0.1, tid=2),
        _rec("decode_step_dropped", 0.1, dur=0.1, tids=[2],
             chaos="drop_decode_step"),
        _rec("decode_step", 0.2, dur=0.1, tids=[2]),
        _rec("finish", 0.3, tid=2, tokens=2)],
    "spill_migrate_swap": [
        _rec("submit", 0.0, tid=4, engine=0), _rec("admit", 0.05, tid=4),
        _rec("prefill", 0.05, end=0.15, tid=4),
        _rec("spill_fetch", 0.15, end=0.2, tid=4),
        _rec("hot_swap", 0.2, tid=4, pause_s=0.03),
        _rec("engine_failed", 0.3, tids=[4]),
        _rec("migrate", 0.35, end=0.45, tid=4),
        _rec("adopt", 0.5, tid=4, engine=1), _rec("admit", 0.55, tid=4),
        _rec("decode_step", 0.55, dur=0.1, tids=[4]),
        _rec("finish", 0.7, tid=4, tokens=2)],
    "shed_and_unfinished": [
        _rec("submit", 0.0, tid=5), _rec("shed", 0.1, tid=5,
                                         reason="queue_full"),
        _rec("submit", 0.0, tid=6), _rec("admit", 0.2, tid=6)],
}


@pytest.mark.parametrize("case", list(CASES))
def test_records_decompose_the_same_way_in_both(case):
    recs = CASES[case]
    want = jtracing.decompose(recs)
    got = ttracing.decompose(recs)
    assert got == want
    assert ttracing.assemble(recs) == jtracing.assemble(recs)
    for c in got.values():
        if c.get("exact"):
            total = sum(c[k[:-2] + "_ps"] for k in ttracing.COMPONENTS)
            assert total == c["e2e_ps"]


def test_the_packages_export_the_same_names():
    assert ttracing.__all__ == jtracing.__all__
    assert ttracing.COMPONENTS == jtracing.COMPONENTS
    assert ttracing.PS_PER_S == jtracing.PS_PER_S


def test_disabled_hooks_are_one_attribute_load():
    assert ttracing.active() is None
    ttracing.event("admit", 1.0, tid=1)
    ttracing.serving_span({"event": "admit", "t": 1.0, "tid": 1})
    ttracing.flush()
    for fn in (ttracing.event, ttracing.serving_span):
        loads = [o.argval for o in dis.get_instructions(fn)
                 if o.opname == "LOAD_GLOBAL"]
        assert loads[0] == "_ACTIVE", fn


def _record(mod, directory):
    pl = mod.enable(str(directory), rank=2, flush_events=4)
    for case in ("basic_lifecycle", "spill_migrate_swap"):
        for r in CASES[case]:
            f = {k: v for k, v in r.items() if k not in ("type", "event",
                                                         "t")}
            if "tid" in f and "tids" not in f and r["event"] in (
                    "admit", "finish"):
                mod.serving_span({"event": r["event"], "t": r["t"], **f})
            else:
                mod.event(r["event"], r["t"], **f)
    mod.flush()
    chrome = json.load(open(pl.export_chrome_trace()))
    mod.disable()
    return open(pl.stream_path).read(), chrome


def test_planes_write_the_same_stream_and_read_each_other(tmp_path):
    (js, jc), (ts, tc) = (_record(m, tmp_path / n)
                          for n, m in MODS.items())
    assert ts == js and tc == jc
    assert (tmp_path / "torch" / "trace_rank_2.jsonl").exists()
    for reader in MODS.values():
        a = reader.load_trace_dir(str(tmp_path / "jax"))
        b = reader.load_trace_dir(str(tmp_path / "torch"))
        assert a == b and len(a) == len(CASES["basic_lifecycle"]) + len(
            CASES["spill_migrate_swap"])
        assert ttracing.decompose(b) == jtracing.decompose(a)
