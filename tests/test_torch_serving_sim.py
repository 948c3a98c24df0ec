"""The port's serving simulator, failover router and runner costs
(paddle2_tpu_torch.serving.simulate, model_runner), held against the JAX
package on the CPU: the traces are equal bitwise; the simulators'
reports, the routers' decisions, the span records and the tokens are
equal on the same gpt_tiny weights and one shared cost table
(tests/torch_serving_twins.py); both packages' serve_doctor read the
port's streams alike. The router cases mirror
tests/test_serving_reliability.py."""

import types

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import paddle2_tpu.serving as jax_serving
import paddle2_tpu_torch.serving as port_serving
from paddle2_tpu.distributed.fault_tolerance import chaos as jax_chaos
from paddle2_tpu.observability import metrics as jax_metrics
from paddle2_tpu.observability import tracing as jax_tracing
from paddle2_tpu.tools import serve_doctor as jax_doctor
from paddle2_tpu_torch.distributed.fault_tolerance import chaos as port_chaos
from paddle2_tpu_torch.observability import metrics as port_metrics
from paddle2_tpu_torch.observability.cost_model import program_cost
from paddle2_tpu_torch.observability import tracing as port_tracing
from paddle2_tpu_torch.serving.paged_attention import (
    paged_attention_op, paged_attention_flops, paged_attention_reference,
    paged_attention_split_reference)
from paddle2_tpu_torch.tools import serve_doctor as port_doctor

from torch_serving_twins import (one_thread, patch_costs, share_jax_programs,
                                 twin_models)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

# tests/test_serving_reliability.py's engine
KW = dict(block_size=8, num_blocks=32, max_batch=4,
          prefill_budget_tokens=64, max_model_len=64)


def _reliability(s, rel):
    """A package's ReliabilityConfig from a dict (``slo`` a dict too)."""
    if rel is None:
        return None
    rel = dict(rel)
    if isinstance(rel.get("slo"), dict):
        rel["slo"] = s.SLOConfig(**rel["slo"])
    return s.ReliabilityConfig(**rel)


@pytest.fixture(scope="module")
def pkgs():
    jm, tm, _ = twin_models()

    def jax_engine(reliability=None, **over):
        e = jax_serving.ServingEngine(jm, config=jax_serving.EngineConfig(
            **{**KW, **over},
            reliability=_reliability(jax_serving, reliability)))
        share_jax_programs(e)
        return patch_costs(e)[0]

    def port_engine(reliability=None, **over):
        e = port_serving.ServingEngine(tm, port_serving.EngineConfig(
            **{**KW, **over},
            reliability=_reliability(port_serving, reliability)),
            device="cpu")
        return patch_costs(e)[0]

    return [types.SimpleNamespace(name="jax", s=jax_serving, chaos=jax_chaos,
                                  tracing=jax_tracing, metrics=jax_metrics,
                                  engine=jax_engine, model=jm),
            types.SimpleNamespace(name="port", s=port_serving,
                                  chaos=port_chaos, tracing=port_tracing,
                                  metrics=port_metrics, engine=port_engine,
                                  model=tm)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    yield from one_thread()


@pytest.fixture(autouse=True)
def _disarm_chaos():
    yield
    for m in (jax_chaos, port_chaos):
        m.disarm()
    for m in (jax_tracing, port_tracing, jax_metrics, port_metrics):
        m.disable()


def _both(pkgs, fn):
    got = [fn(p) for p in pkgs]
    assert got[0] == got[1]
    return got[1]


def _trace(n, seed, rate=2000.0, max_new=6, size=10, session_mod=None,
           vocab=128):
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    for i in range(n):
        t += float(rng.exponential(1.0 / rate))
        out.append({"arrival_t": t,
                    "prompt": rng.integers(0, vocab, size=size).tolist(),
                    "max_new_tokens": max_new,
                    "session": None if session_mod is None
                    else i % session_mod})
    return out


def test_serving_exports_the_jax_names_in_order():
    """``__all__`` starts with the JAX package's, in its order; the
    simulator module's too."""
    from paddle2_tpu.serving import simulate as jsim
    from paddle2_tpu_torch.serving import simulate as tsim
    n = len(jax_serving.__all__)
    assert port_serving.__all__[:n] == jax_serving.__all__
    assert tsim.__all__ == jsim.__all__
    assert all(hasattr(port_serving, name) for name in port_serving.__all__)


# ----------------------------------------------------------------- traces
@pytest.mark.parametrize("seed,rate", [(0, 50.0), (7, 3000.0)])
def test_poisson_trace_bitwise(seed, rate):
    args = (24, rate, [17, 45, 130], [4, 32], 50304)
    assert port_serving.poisson_trace(*args, seed=seed) == \
        jax_serving.poisson_trace(*args, seed=seed)


@pytest.mark.parametrize("cohorts", [(), (((1, 2, 3), (10.0, 30.5)),
                                          ((9, 9), (5.0,)))])
def test_diurnal_trace_bitwise(cohorts):
    args = (40, 86400.0, [16, 64], [8], 1000)
    kw = dict(seed=3, peak_hour=13.5, trough_frac=0.2, cohorts=cohorts)
    assert port_serving.diurnal_poisson_trace(*args, **kw) == \
        jax_serving.diurnal_poisson_trace(*args, **kw)


# ------------------------------------------------------------- simulators
@pytest.mark.parametrize("case", ["plain", "prefix_slo"])
def test_simulate_serving_and_baseline_match_jax(pkgs, case):
    """One engine through a trace, and the one-at-a-time baseline over
    it: the reports field by field, the tokens token for token."""
    over = {} if case == "plain" else dict(
        enable_prefix_cache=True,
        reliability=dict(max_queue_depth=6, slo=dict(
            ttft_target_s=2e-3, e2e_target_s=4e-3)))
    trace = _trace(10, seed=5, rate=5000.0)
    if case != "plain":
        for r in trace[1::2]:
            r["prompt"] = trace[0]["prompt"][:8] + r["prompt"]

    def run(pkg):
        eng = pkg.engine(**over)
        rep = pkg.s.simulate_serving(eng, [dict(r) for r in trace])
        base = pkg.s.simulate_predictor_baseline(eng, trace)
        toks = [eng.sequence(i).generated for i in range(len(trace))]
        return (vars(rep), vars(base), toks, eng.num_decode_programs,
                (eng.scheduler.slo_good, eng.scheduler.slo_bad))
    rep, base, toks, census, slo = _both(pkgs, run)
    assert rep["total_tokens"] == sum(r["max_new_tokens"] for r in trace)
    assert base["tokens_per_s"] > 0 and 0 < census <= rep["program_budget"]


@pytest.mark.parametrize("drill", ["clean", "kill", "transient",
                                   "overload"])
def test_simulate_router_matches_jax(pkgs, tmp_path, drill):
    """A fleet through a trace under chaos: the report field by field,
    the tokens, every span record the tracing planes wrote, and every
    ``serving_*`` counter, gauge and histogram of the metrics planes."""
    n_eng, rel, n, rate = 2, None, 10, 2000.0
    spec = {"kill": "kill_engine:3:1",
            "transient": "drop_decode_step:2,corrupt_block_table:4"}.get(
                drill)
    if drill == "transient":
        n_eng = 1
    if drill == "overload":
        rel, n_eng, n, rate = dict(max_queue_depth=3), 1, 12, 1e6
    trace = _trace(n, seed=23 if drill != "overload" else 31, rate=rate)
    if drill == "overload":
        for i, r in enumerate(trace):
            r["priority"] = 1 if i % 3 == 0 else 0

    def run(pkg):
        d = str(tmp_path / f"{pkg.name}_{drill}")
        pkg.tracing.enable(d, rank=0)
        plane = pkg.metrics.enable(str(tmp_path / f"m_{pkg.name}"), rank=0)
        if spec:
            pkg.chaos.arm(spec)
        router = pkg.s.EngineFailoverRouter(
            [pkg.engine(reliability=rel) for _ in range(n_eng)],
            probe_interval_s=1e-4)
        rep = pkg.s.simulate_router(router, [dict(r) for r in trace])
        fired = pkg.chaos.fired_log()
        snap = {kind: {k: v for k, v in vals.items()
                       if k.startswith("serving_")}
                for kind, vals in plane.snapshot().items()}
        pkg.metrics.disable()
        pkg.tracing.flush()
        pkg.tracing.disable()
        recs = pkg.tracing.load_trace_dir(d)
        dec = pkg.tracing.decompose(recs)
        fin = [c for c in dec.values() if c["finished"]]
        assert len(fin) == rep.completed > 0
        assert all(c["exact"] for c in fin)
        toks = [router.sequence(r).generated for r in rep.rids]
        shed = [type(s.error).__name__ for e in router.engines
                for s in e.scheduler.shed]
        return vars(rep), toks, fired, recs, shed, snap
    rep, toks, fired, _, shed, snap = _both(pkgs, run)
    assert snap["counters"]["serving_decode_tokens_total"]
    if drill == "kill":
        assert rep["failovers"] == 1 and rep["completed"] == n
        assert rep["mttr_s"] > 0
    if drill == "overload":
        assert rep["rejected"] + rep["shed"] > 0
        assert rep["completed"] == rep["submitted"] - rep["shed"]
    if spec:
        assert fired


def test_router_kill_failover_token_for_token(pkgs):
    """An engine killed mid-decode: every request completes with the
    clean run's tokens, through re-prefill on the survivor."""
    trace = _trace(10, seed=23)
    pkg = pkgs[1]
    clean = pkg.s.EngineFailoverRouter([pkg.engine() for _ in range(2)],
                                       probe_interval_s=1e-4)
    rep0 = pkg.s.simulate_router(clean, list(trace))
    pkg.chaos.arm("kill_engine:3:1")
    router = pkg.s.EngineFailoverRouter([pkg.engine() for _ in range(2)],
                                        probe_interval_s=1e-4)
    rep = pkg.s.simulate_router(router, list(trace))
    assert rep.failovers == 1 and rep.recovered_seqs >= 1
    assert [router.sequence(r).generated for r in rep.rids] == \
        [clean.sequence(r).generated for r in rep0.rids]


def test_router_session_affinity_and_remap(pkgs):
    def run(pkg):
        router = pkg.s.EngineFailoverRouter([pkg.engine(), pkg.engine()],
                                            probe_interval_s=1e-4)
        p = _trace(1, seed=29)[0]["prompt"]
        r1 = router.submit(p, 4, arrival_t=0.0, session="alice")
        r2 = router.submit(p, 4, arrival_t=0.0, session="alice")
        home = router.home_of(r1)
        assert router.home_of(r2) == home
        other = router.submit(p, 4, arrival_t=0.0, session="bob")
        assert router.home_of(other) != home
        router.engines[home].fail("test", now=0.0)
        router.probe(now=0.0)
        assert router.home_of(r1) != home
        r3 = router.submit(p, 4, arrival_t=0.0, session="alice")
        assert not router.engines[router.home_of(r3)].failed
        return [router.home_of(r) for r in (r1, r2, other, r3)], \
            [dict(fo, seqs=len(fo["seqs"])) for fo in router.failovers]
    _both(pkgs, run)


def test_router_whole_fleet_dead_defers_failover(pkgs):
    def run(pkg):
        router = pkg.s.EngineFailoverRouter([pkg.engine(), pkg.engine()],
                                            probe_interval_s=1e-4)
        rid = router.submit(_trace(1, seed=53)[0]["prompt"], 4)
        home = router.home_of(rid)
        for e in router.engines:
            e.fail("test", now=0.0)
        reports = router.probe(now=0.0)           # must not raise
        assert router._handled_failures == set() and not router.failovers
        assert router.sequence(rid) in router.engines[home].scheduler.waiting
        with pytest.raises(ValueError):
            pkg.s.EngineFailoverRouter([pkg.engine()], probe_interval_s=0.0)
        return [r.as_dict() for r in reports]
    _both(pkgs, run)


def test_failover_preserves_fifo_of_never_admitted_work(pkgs):
    def run(pkg):
        router = pkg.s.EngineFailoverRouter([pkg.engine(), pkg.engine()],
                                            probe_interval_s=1e-4)
        p = _trace(1, seed=59)[0]["prompt"]
        rids = [router.submit(p, 4, session="x") for _ in range(3)]
        home = router.home_of(rids[0])
        seqs = [router.sequence(r) for r in rids]
        router.engines[home].fail("test", now=0.0)
        router.probe(now=0.0)
        assert router.engines[1 - home].scheduler.waiting == seqs
        return [router.home_of(r) for r in rids]
    _both(pkgs, run)


# ------------------------------------------------------------ serve_doctor
def test_both_doctors_read_the_ports_streams_alike(pkgs, tmp_path):
    """The port's router under chaos, with its metrics and tracing planes
    on: both packages' serve_doctor summarize its trace directory and
    its metrics directory alike, and the report closes exactly."""
    pkg = pkgs[1]
    tdir, mdir = str(tmp_path / "trace"), str(tmp_path / "metrics")
    port_tracing.enable(tdir, rank=0)
    port_metrics.enable(mdir, rank=0)
    port_chaos.arm("kill_engine:3:1")
    router = pkg.s.EngineFailoverRouter(
        [pkg.engine(enable_prefix_cache=True,
                    reliability=dict(slo=dict(ttft_target_s=2e-3,
                                              e2e_target_s=4e-3)))
         for _ in range(2)], probe_interval_s=1e-4)
    trace = _trace(10, seed=23)
    for r in trace[::2]:
        r["prompt"] = trace[1]["prompt"][:8] + r["prompt"]
    rep = pkg.s.simulate_router(router, trace)
    port_tracing.flush()
    port_metrics.flush()
    port_tracing.disable()
    port_metrics.disable()
    got = [d.summarize(d._load(tdir), metrics_dir=mdir)
           for d in (jax_doctor, port_doctor)]
    assert got[0] == got[1]
    assert got[1]["finished"] == rep.completed and \
        not got[1]["exactness"]["violations"]
    assert got[1]["counters"]["failovers"] >= 1
    assert got[1]["slo"]["good"] + got[1]["slo"]["bad"] == rep.completed
    assert got[1]["throughput"]["prefix_hits"] > 0
    assert [d.main([tdir]) for d in (jax_doctor, port_doctor)] == [0, 0]


def test_hot_swap_lineage_rides_the_spans(pkgs, tmp_path):
    """``HotSwapController(source=)``: every span of the controller and
    the staged engines' ``hot_swap`` spans carry the producing
    checkpoint's generation; the flight rings hold the same spans as the
    JAX package's, and the tracing planes the same records."""
    from paddle2_tpu.distributed.fault_tolerance import (
        flight_recorder as jax_flight)
    from paddle2_tpu_torch.distributed.fault_tolerance import (
        flight_recorder as port_flight)
    src = {"session": "s1", "generation": 3, "step": 40}

    def run(pkg):
        flight = jax_flight if pkg.name == "jax" else port_flight
        fr = flight.enable(str(tmp_path / f"f_{pkg.name}"), rank=0,
                           install_hooks=False)
        pkg.tracing.enable(str(tmp_path / f"t_{pkg.name}"), rank=0)
        try:
            a, b = pkg.engine(), pkg.engine()
            if pkg.name == "port":      # the port swaps in place
                b.runner.model = b.model = type(a.model)(a.model.cfg,
                                                         device="cpu")
                b.model.load_state_dict(a.model.state_dict())
                new = [t * 1.001 for t in a.runner.weights()]
            else:
                new = [w * 1.001 for w in a.runner._weights()]
            a.submit([1, 2, 3], 3, trace_id=5)
            a.tick(now=0.0)
            ctl = pkg.s.HotSwapController([a, b], new, source=src)
            ctl.stage_next(now=1.0)
            ctl.stage_next(now=2.0)
            ctl.rollback(now=3.0)
            pkg.tracing.flush()
        finally:
            pkg.tracing.disable()
            flight.disable()
        spans = [f for _, _, kind, f in fr.events()
                 if kind == "serving" and "swap" in f["event"]]
        return spans, pkg.tracing.load_trace_dir(str(tmp_path /
                                                     f"t_{pkg.name}"))
    spans, recs = _both(pkgs, run)
    ctl = [f for f in spans if f["event"] != "hot_swap"]
    assert [f["event"] for f in ctl] == [
        "hot_swap_stage", "hot_swap_stage", "hot_swap_commit",
        "hot_swap_rollback"]
    assert all(f["generation"] == 3 and f["ckpt_step"] == 40 for f in ctl)
    staged = [f for f in spans if f["event"] == "hot_swap"][:2]
    assert all(f["generation"] == 3 for f in staged)
    assert any(r["event"] == "hot_swap" and r.get("generation") == 3
               for r in recs)


# ------------------------------------------------------------ runner costs
def test_runner_costs(pkgs):
    """The port runner's own costs, worked out from the configuration,
    held against ``program_cost`` of the real calls they price: every
    prefill and decode the engine runs is counted as it runs and must
    equal its key's reckoning. A decode's ``"bytes accessed"`` is at
    least the parameters' bytes and holds the formula; its FLOPs are
    ``2·N·tokens`` plus attention within 5 %; a prefill likewise."""
    tm = pkgs[1].model
    eng = port_serving.ServingEngine(tm, port_serving.EngineConfig(**KW),
                                     device="cpu")
    r, cfg = eng.runner, tm.cfg
    counted = {}

    def counting(name, key_of):
        fn = getattr(r, name)

        def run(*args):
            out = []
            cost = program_cost(lambda *a: out.append(fn(*a)), args)
            counted.setdefault((name, key_of(*args)), cost)
            return out[0]
        setattr(r, name, run)
    counting("prefill", lambda ids: r.prefill_padded_len(len(ids)))
    counting("decode", lambda cache, ids, pos, tables: tables.shape)
    eng.submit(list(range(1, 20)), 3)
    eng.submit(list(range(5, 14)), 3)
    while not eng.idle():
        eng.tick(0.0)
    assert {n for n, _ in counted} == {"prefill", "decode"}
    for (name, key), cost in counted.items():
        want = (r.prefill_cost(key) if name == "prefill"
                else r.decode_cost(key))
        assert want["flops"] == cost["flops"], (name, key)
    # N: the parameters of the matrix products (the blocks' and the tied
    # head's; not the position table, the biases or the norms)
    params = sum(p.numel() for n, p in tm.named_parameters()
                 if p.dim() == 2 and "wpe" not in n)
    pbytes = sum(t.numel() * t.element_size() for t in r.weights())
    b, p = next(k for n, k in counted if n == "decode")
    cost = r.decode_cost((b, p))
    attn = cfg.num_layers * paged_attention_flops(b, cfg.num_heads, p,
                                                  KW["block_size"],
                                                  cfg.head_dim)
    dense = 2 * params * b
    assert abs(cost["flops"] - (dense + attn)) <= 0.05 * (dense + attn)
    assert cost["bytes accessed"] >= pbytes
    assert cost["bytes accessed"] == r.decode_bytes(b, p, KW["block_size"])
    padded = next(k for n, k in counted if n == "prefill")
    pc = r.prefill_cost(padded)
    dense = 2 * params * padded
    assert abs(pc["flops"] - dense) <= 0.05 * dense + 4 * padded ** 2 * \
        cfg.hidden_size * cfg.num_layers
    assert pc["bytes accessed"] == r.prefill_bytes(padded) >= pbytes


@pytest.mark.parametrize("pps", [None, 2])
def test_paged_decode_counts_alike_plain_and_formula(pps):
    """The paged decode is one custom op with a flop formula: the count
    ``FlopCounterMode`` gives it equals the count of the plain version's
    own products, on either route (the split route's plain version pads
    its last split)."""
    g = torch.Generator().manual_seed(0)
    B, H, D, bs, N, P = 3, 4, 16, 8, 12, 5
    q = torch.randn(B, 1, H, D, generator=g)
    k = torch.randn(N, bs, H, D, generator=g)
    v = torch.randn(N, bs, H, D, generator=g)
    tables = torch.randint(1, N, (B, P), generator=g, dtype=torch.int32)
    ctx = torch.tensor([3, 17, 40], dtype=torch.int32)
    plain = (paged_attention_reference if pps is None else
             lambda *a: paged_attention_split_reference(
                 *a, pages_per_split=pps))
    with FlopCounterMode(display=False) as op_count:
        out = paged_attention_op(q, k, v, tables, ctx, D ** -0.5, pps)
    with FlopCounterMode(display=False) as plain_count:
        ref = plain(q, k, v, tables, ctx, D ** -0.5)
    assert op_count.get_total_flops() == plain_count.get_total_flops() == \
        paged_attention_flops(B, H, P, bs, D, pps)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
