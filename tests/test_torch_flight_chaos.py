"""The port's flight recorder, chaos injector and probe report
(paddle2_tpu_torch.distributed.fault_tolerance) held against the JAX
package's: every spec example of the JAX chaos docstring parses to the
same specs, counters and views; the five serving hooks fire on the same
occurrences and leave the same fired log; and a dump of either recorder
is read alike by both packages' flight_doctor. Stdlib and numpy only:
no model runs here."""

import dis
import json
import os
import re

import numpy as np
import pytest

import paddle2_tpu.distributed.fault_tolerance.chaos as jchaos
import paddle2_tpu.distributed.fault_tolerance.flight_recorder as jflight
import paddle2_tpu.serving as jserving
from paddle2_tpu.distributed.fault_tolerance.health import \
    HealthReport as JaxReport
from paddle2_tpu.tools import flight_doctor as jdoctor
import paddle2_tpu_torch.distributed.fault_tolerance.chaos as tchaos
import paddle2_tpu_torch.distributed.fault_tolerance.flight_recorder as \
    tflight
import paddle2_tpu_torch.serving as tserving
from paddle2_tpu_torch.distributed.fault_tolerance import (HealthReport,
                                                           node_id)
from paddle2_tpu_torch.tools import flight_doctor as tdoctor

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

CHAOS = {"jax": jchaos, "port": tchaos}


@pytest.fixture(autouse=True)
def _clean():
    yield
    for m in (jchaos, tchaos):
        m.disarm()
    for m in (jflight, tflight):
        m.disable()


def _docstring_examples():
    """Every spec the JAX module's docstring shows, in order (the
    grammar table's templates among them), and the whole-day drill."""
    doc = jchaos.__doc__
    found = []
    for tok in re.findall(r"([a-z_]+(?::[\w.]+)+)", doc):
        if tok.split(":")[0] in jchaos.KINDS and tok not in found:
            found.append(tok)
    drill = doc.split("up front::")[1].split("\n\n")[1]
    return found + ["".join(drill.split())]


EXAMPLES = _docstring_examples()


def _parsed(inj):
    return ([(s.kind, s.nth, s.param, s.count, s.flip) for s in inj.specs],
            inj.targets, inj.counts, inj.flip, inj.spec)


def test_docstring_examples_are_found():
    assert len(EXAMPLES) >= 14 and EXAMPLES[-1].count(";") == 7
    assert "flip_bits:grads:3:1:2" in EXAMPLES
    assert tchaos.KINDS == jchaos.KINDS


@pytest.mark.parametrize("spec", EXAMPLES)
def test_chaos_grammar_matches_jax(spec):
    """The same specs, or (a template such as ``flip_bits:WHERE:N``) the
    same refusal."""
    try:
        want = _parsed(jchaos.arm(spec))
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            tchaos.arm(spec)
        return
    assert _parsed(tchaos.arm(spec)) == want


@pytest.mark.parametrize("bad", ["nope:1", "flip_bits:nowhere:1",
                                 "kill_engine:x"])
def test_chaos_grammar_refuses_alike(bad):
    for mod in CHAOS.values():
        with pytest.raises(ValueError):
            mod.arm(bad)


def test_flag_arms_and_disarms():
    from paddle2_tpu_torch import flags
    flags.set_flags({"FLAGS_chaos": "drop_migration:2"})
    assert tchaos.active().targets == {"drop_migration": (2, None)}
    flags.set_flags({"FLAGS_chaos": ""})
    assert tchaos.active() is None and tchaos.fired_log() == []


def _drive(pkg):
    """A fixed sequence of serving-hook calls; returns every result,
    the mutated tables, the tier's state and the fired log."""
    mod = CHAOS[pkg]
    tier = (jserving if pkg == "jax" else tserving).HostKVTier()
    mod.arm("kill_engine:2:1;kill_engine:3:0;drop_decode_step:2;"
            "corrupt_block_table:2:1;corrupt_spill_block:2;"
            "drop_migration:2")
    out, tables = [], []
    for step in range(1, 5):
        for eid in (0, 1):
            out.append(mod.maybe_kill_engine(eid, step))
        out.append(mod.maybe_drop_decode_step(step % 2))
        lists = [[3, 4, 5], [6, 7], []]
        out.append(mod.maybe_corrupt_block_table(lists))
        out.append(mod.maybe_corrupt_block_table([]))     # no tick
        tables.append(lists)
        out.append(mod.maybe_corrupt_spill_block(tier))   # empty: no tick
        tier.put(("k", step), np.full(4, float(step), np.float32),
                 np.zeros(4, np.float32))
        out.append(mod.maybe_corrupt_spill_block(tier))
        out.append(mod.maybe_drop_migration())
    got = [tier.get(k) is None for k in tier.keys()]
    return out, tables, got, tier.corrupt_drops, mod.fired_log(), \
        dict(mod.active().counts)


def test_serving_hooks_fire_on_the_same_occurrences():
    jax_run, port_run = _drive("jax"), _drive("port")
    assert jax_run == port_run
    out, tables, corrupt, drops, fired, counts = port_run
    assert [k for k, _ in fired] == [
        "kill_engine", "drop_decode_step", "corrupt_block_table",
        "corrupt_spill_block", "drop_migration", "kill_engine"]
    assert tables[1][1][1] == tchaos.CORRUPT_BLOCK_ID
    assert drops == 1 and corrupt.count(True) == 1


@pytest.mark.parametrize("hook", ["maybe_kill_engine",
                                  "maybe_drop_decode_step",
                                  "maybe_corrupt_block_table",
                                  "maybe_corrupt_spill_block",
                                  "maybe_drop_migration"])
def test_disarmed_hooks_are_one_attribute_load(hook):
    fn = getattr(tchaos, hook)
    loads = [o.argval for o in dis.get_instructions(fn)
             if o.opname in ("LOAD_GLOBAL", "LOAD_FAST")]
    assert "_ACTIVE" in loads[:2]
    assert fn(*{"maybe_kill_engine": (0, 1), "maybe_drop_decode_step": (),
                "maybe_corrupt_block_table": ([[1]],),
                "maybe_corrupt_spill_block": (None,),
                "maybe_drop_migration": ()}[hook]) in (False, None)


# ------------------------------------------------------------- the ring
def _record_run(flight, chaos, directory, rank):
    """One rank's run: serving spans, a chaos fault, collectives; then
    the dump."""
    fr = flight.enable(str(directory), rank=rank, capacity=16,
                       install_hooks=False)
    for i in range(6):
        flight.record("serving", event="admit", req=i, tid=i, t=0.5 * i,
                      engine=rank, tokens=[1, 2], blocks=(3, 4))
    chaos.arm("drop_migration:1")
    chaos.maybe_drop_migration()
    for op in ("all_reduce", "all_gather"):
        cseq = flight.collective_enter(op, "dp", shape=[2, 3],
                                       dtype="float32")
        if rank == 0 or op == "all_reduce":
            flight.collective_exit(cseq, op)
    flight.record("step", step=rank + 3, ok=True, obj=object)
    path = flight.dump("test")
    assert flight.dump_path() == path and flight.dump_hint()
    assert fr.events_recorded() == len(fr.events()) == 13 - rank
    flight.disable()
    return path


def _strip(rec):
    return {k: v for k, v in rec.items()
            if k not in ("t", "wall_time", "pid", "threads", "node")}


def _no_wall(obj):
    """``obj`` less its wall-clock figures (event stamps, arrival
    delays), which differ from run to run."""
    if isinstance(obj, dict):
        return {k: _no_wall(v) for k, v in obj.items()
                if k not in ("t", "delays")}
    if isinstance(obj, list):
        return [_no_wall(v) for v in obj]
    return obj


def test_dumps_read_alike_by_both_doctors(tmp_path):
    """Two ranks dumped by each package: the dumps hold the same records
    (less wall-clock stamps and process ids), and each package's
    flight_doctor makes the same diagnosis of either package's dumps,
    the serving plane's counts and its collective desync included."""
    dirs = {}
    for name, flight in (("jax", jflight), ("port", tflight)):
        d = tmp_path / name
        for rank in (0, 1):
            _record_run(flight, CHAOS[name], d, rank)
        dirs[name] = str(d)
    assert tflight.list_dumps(dirs["port"]) == [
        os.path.join(dirs["port"], f"rank_{r}.jsonl") for r in (0, 1)]
    lines = {n: [[_strip(json.loads(x)) for x in open(p)]
                 for p in jflight.list_dumps(d)] for n, d in dirs.items()}
    assert lines["jax"] == lines["port"]
    reports = {}
    for name, d in dirs.items():
        got = [reader.diagnose(reader.load_dumps(d))
               for reader in (jdoctor, tdoctor)]
        assert got[0] == got[1]             # one reading of each dump
        reports[name] = _no_wall(got[1])
    assert reports["jax"] == reports["port"]
    base = reports["port"]
    assert base["serving"]["counts"] == {"admit": 12}
    assert base["inflight"][1][0]["cseq"] == 2
    assert base["straggler"]["arrival"]["slowest"] == 1
    for reader in (jdoctor, tdoctor):
        assert reader.main([dirs["port"]]) in (0, 1, 2)


def test_recorder_api(tmp_path, monkeypatch):
    """Suspend and resume keep the ring; the hooks are no-ops when off;
    elastic events append; prune keeps fresh evidence and drops departed
    ranks' old dumps, as in the JAX package."""
    assert tflight.dump("x") is None and tflight.dump_hint() == ""
    assert tflight.collective_enter("all_reduce", "dp") == -1
    fr = tflight.enable(str(tmp_path), rank=0, install_hooks=False)
    tflight.record("a")
    held = tflight.suspend()
    tflight.record("lost")
    tflight.resume(held)
    tflight.record("b")
    assert [e[2] for e in fr.events()] == ["recorder_enabled", "a", "b"]
    with pytest.raises(ValueError):
        tflight.FlightRecorder(str(tmp_path), rank=0, capacity=4)
    tflight.append_elastic_event("rescale", str(tmp_path), world=2)
    ev = [json.loads(x) for x in open(tmp_path / tflight.ELASTIC_LOG)]
    assert ev[0]["kind"] == "elastic.rescale" and ev[0]["world"] == 2
    for r in (0, 3):
        (tmp_path / f"rank_{r}.jsonl").write_text("{}\n")
    assert tflight.prune_ranks(1, str(tmp_path)) == []       # fresh
    assert tflight.prune_ranks(1, str(tmp_path), min_age_s=0.0) == [3]
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    assert tflight.FlightRecorder(str(tmp_path), rank=2).world == 4


def test_health_report_and_node_id(monkeypatch):
    for kw in (dict(ok=True), dict(ok=False, reason="dead",
                                   probe="serving_engine")):
        a, b = HealthReport(**kw), JaxReport(**kw)
        assert a.as_dict() == b.as_dict() and repr(a) == repr(b)
    monkeypatch.setenv("PADDLE_NODE_ID", "host-7/s1")
    assert node_id() == "host-7/s1"
