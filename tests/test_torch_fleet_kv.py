"""The port's fleet-global KV tiers (paddle2_tpu_torch.serving: the host
tier, peer fetch, KV migration and prefix-affinity routing) held against
the JAX package's on the CPU. Each case of tests/test_fleet_kv.py runs
on a JAX fleet and on the port's, built on the same gpt_tiny weights and
priced by one shared cost table (tests/torch_serving_twins.py), and
their tokens, tier counters, decisions, clocks and ledgers must agree
exactly; the port's tokens must also equal those of an engine without
the tier."""

import types

import numpy as np
import pytest

import paddle2_tpu.serving as jax_serving
import paddle2_tpu_torch.serving as port_serving
from paddle2_tpu.distributed.fault_tolerance import chaos as jax_chaos
from paddle2_tpu.observability import cost_model as jax_cost
from paddle2_tpu.observability import tracing as jax_tracing
from paddle2_tpu_torch.distributed.fault_tolerance import chaos as port_chaos
from paddle2_tpu_torch.observability import cost_model as port_cost
from paddle2_tpu_torch.observability import tracing as port_tracing
from paddle2_tpu_torch.serving.simulate import cost_seconds

from torch_serving_twins import (one_thread, patch_costs, share_jax_programs,
                                 twin_models)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

BASE = dict(block_size=16, num_blocks=24, max_batch=4,
            prefill_budget_tokens=128, max_model_len=128,
            host_link_gbps=25.0)
TIERED = dict(enable_prefix_cache=True, enable_kv_spill=True,
              host_tier_blocks=64)


def _link(pkg):
    # one link for both packages (each has its own card's defaults)
    return pkg.cost.LinkModel(dcn_gbps=12.5, dcn_latency_us=250.0)


@pytest.fixture(scope="module")
def pkgs():
    jm, tm, _ = twin_models()

    def jax_engine(**over):
        e = jax_serving.ServingEngine(
            jm, config=jax_serving.EngineConfig(**{**BASE, **over}))
        share_jax_programs(e)
        return patch_costs(e)[0]

    def port_engine(**over):
        e = port_serving.ServingEngine(
            tm, port_serving.EngineConfig(**{**BASE, **over}), device="cpu")
        return patch_costs(e)[0]

    return [types.SimpleNamespace(name="jax", s=jax_serving, chaos=jax_chaos,
                                  tracing=jax_tracing, cost=jax_cost,
                                  engine=jax_engine, vocab=jm.cfg.vocab_size),
            types.SimpleNamespace(name="port", s=port_serving,
                                  chaos=port_chaos, tracing=port_tracing,
                                  cost=port_cost, engine=port_engine,
                                  vocab=tm.cfg.vocab_size)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    yield from one_thread()


@pytest.fixture(autouse=True)
def _disarm_chaos():
    yield
    jax_chaos.disarm()
    port_chaos.disarm()


def _both(pkgs, fn):
    """``fn(pkg)`` for the JAX package and the port: equal results."""
    got = [fn(p) for p in pkgs]
    assert got[0] == got[1]
    return got[1]


def _prompt(vocab, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=n).tolist()


def _ab_trace(vocab, n=8, seed=3, spacing=0.05):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, vocab, size=32).tolist()
    b = rng.integers(0, vocab, size=32).tolist()
    out, t = [], 0.0
    for i in range(n):
        t += spacing
        tail = rng.integers(0, vocab, size=16).tolist()
        out.append({"arrival_t": t, "prompt": (a if i % 2 == 0 else b)
                    + tail, "max_new_tokens": 8})
    return out


def _drain(eng, max_steps=500):
    step = 0
    while not eng.idle() and step < max_steps:
        eng.tick(now=float(step))
        step += 1
    assert eng.idle(), "engine did not drain"


def _audit(pkg, eng):
    return pkg.s.audit_kv_ledger(
        eng.allocator, [s.table.blocks for s in eng.scheduler.running()],
        prefix_cache=eng.prefix_cache, host_tier=eng.host_tier)


# ------------------------------------------------------- host tier unit
def test_host_tier_crc_round_trip_and_eviction(pkgs):
    def run(pkg):
        tier = pkg.s.HostKVTier(capacity_blocks=2)
        k = np.arange(8, dtype=np.float32).reshape(2, 4)
        v = k * 2.0
        tier.put(("a",), k, v)
        got = tier.get(("a",))
        ok = [np.array_equal(got[0], k), np.array_equal(got[1], v)]
        k[0, 0] = 99.0                      # the tier holds copies
        ok.append(float(tier.get(("a",))[0].ravel()[0]))
        tier.put(("b",), k, v)
        tier.put(("c",), k, v)              # capacity 2: LRU evicts "a"
        ok.append((("a",) in tier, tier.evictions))
        tier.pop(("b",))                    # promotion retires the entry
        ok.append((("b",) in tier, tier.fetched))
        key = tier.corrupt_one()            # a flipped byte, same CRC
        ok += [key, tier.get(key), tier.corrupt_drops, len(tier),
               tier.spilled]
        return ok
    assert _both(pkgs, run) == [True, True, 0.0, (False, 1), (False, 1),
                                ("c",), None, 1, 0, 3]


# ------------------------------------------------- spill/fetch exactness
def test_spill_fetch_token_for_token(pkgs):
    """Cache pressure degrades to host-tier fetches, not recompute: the
    stream equals the untiered engine's token for token, the ledger
    closes, and both packages spill and fetch the same blocks."""
    def run(pkg):
        trace = _ab_trace(pkg.vocab)
        e0 = pkg.engine()
        r0 = pkg.s.simulate_serving(e0, [dict(r) for r in trace])
        e1 = pkg.engine(prefix_cache_blocks=3, **TIERED)
        r1 = pkg.s.simulate_serving(e1, [dict(r) for r in trace])
        toks0 = [e0.sequence(i).generated for i in range(len(trace))]
        toks1 = [e1.sequence(i).generated for i in range(len(trace))]
        assert toks1 == toks0
        assert e1.prefix_cache.spills > 0 and \
            e1.prefix_cache.host_fetches > 0 and len(e1.host_tier) > 0
        return (toks1, e1.prefix_cache.spills, e1.prefix_cache.host_fetches,
                len(e1.host_tier), _audit(pkg, e1), vars(r0), vars(r1))
    _both(pkgs, run)


def test_spill_fetch_charges_clock_exactly(pkgs, tmp_path):
    """The spill-fetch stall is charged on the clock as its own span,
    ``host_blocks x block_bytes / host_link_bps`` exactly, and the
    integer-picosecond decomposition closes; both packages write the
    same span records."""
    def run(pkg):
        d = str(tmp_path / pkg.name)
        pkg.tracing.enable(d, rank=0)
        try:
            trace = _ab_trace(pkg.vocab)
            e2 = pkg.engine(prefix_cache_blocks=3, **TIERED)
            step = 0
            for i, r in enumerate(trace):
                e2.submit(r["prompt"], r["max_new_tokens"],
                          arrival_t=float(step), trace_id=i)
                while not e2.idle():
                    e2.tick(now=float(step))
                    step += 1
                    assert step < 2000
            pkg.tracing.flush()
        finally:
            pkg.tracing.disable()
        recs = pkg.tracing.load_trace_dir(d)
        fetches = [r for r in recs if r.get("event") == "spill_fetch"]
        assert fetches
        for r in fetches:
            assert r["end"] == r["t"] + (r["host_blocks"]
                                         * e2.cache.block_bytes
                                         / e2.host_link_bps)
        dec = pkg.tracing.decompose(recs)
        fin = {t: c for t, c in dec.items() if c["finished"]}
        assert fin and all(c["exact"] for c in fin.values())
        assert sum(c["spill_fetches"] for c in fin.values()) > 0
        return recs, dec
    _both(pkgs, run)


# ------------------------------------------------- cross-tier ledger law
def test_cross_tier_ledger_property(pkgs):
    """Across randomized spill / fetch / evict / insert / corrupt steps
    the ledger closes after every one, identically in both packages,
    and ``rebuild_free_list`` restores a clean allocator at the end."""
    def run(pkg):
        rng = np.random.default_rng(11)
        alloc = pkg.s.BlockAllocator(num_blocks=24, block_size=4)
        tier = pkg.s.HostKVTier(capacity_blocks=16)
        pc = pkg.s.PrefixCache(alloc, host_tier=tier)
        store = {}
        pc.set_spill_io(lambda b: store[b],
                        lambda b, k, v: store.__setitem__(
                            b, (np.array(k), np.array(v))))
        live, census = [], []
        for step in range(300):
            op = rng.integers(0, 5)
            if op == 0:
                try:
                    b = alloc.allocate(1)[0]
                except Exception:
                    continue
                k = np.full((2, 2), float(step), np.float32)
                store[b] = (k, k + 0.5)
                toks = [int(x) for x in rng.integers(0, 50, size=4)]
                live.append([b])
                pc.insert(toks, live[-1])
            elif op == 1 and live:
                alloc.free(live.pop(rng.integers(0, len(live))))
            elif op == 2:
                pc.reclaim(int(rng.integers(1, 4)))
            elif op == 3 and tier.keys():
                blocks, _ = pc.lookup(list(tier.keys()[0]))
                if blocks:
                    live.append(blocks)
            elif op == 4 and tier.keys():
                assert tier.get(tier.corrupt_one()) is None
            census.append(pkg.s.audit_kv_ledger(alloc, live,
                                                prefix_cache=pc,
                                                host_tier=tier))
        alloc.rebuild_free_list(live + [pc.held_blocks()])
        census.append(pkg.s.audit_kv_ledger(alloc, live, prefix_cache=pc,
                                            host_tier=tier))
        return census, pc.spills, pc.host_fetches, tier.corrupt_drops
    _both(pkgs, run)


# ------------------------------------------------------- peer tier (DCN)
def test_peer_fetch_cost_gated_both_ways(pkgs):
    """A cold engine fetches a long warm prefix from its peer (modeled
    transfer below modeled prefill) and prefills a short one (the link's
    latency loses): the same decisions in both packages, token for
    token."""
    def run(pkg):
        e0, e1 = pkg.engine(**TIERED), pkg.engine(**TIERED)
        reg = pkg.s.FleetKVRegistry([e0, e1], link=_link(pkg))
        P = _prompt(pkg.vocab, 96, seed=5)
        S = _prompt(pkg.vocab, 16, seed=6)
        e0.submit(P, 2)
        e0.submit(S, 2)
        _drain(e0)
        e1.submit(_prompt(pkg.vocab, 16, seed=7), 2)
        _drain(e1)
        ref = pkg.engine()
        ref.submit(P, 4)
        _drain(ref)
        rid = e1.submit(P, 4)
        _drain(e1)
        assert e1.prefix_cache.peer_fetches > 0 and reg.peer_fetch_blocks > 0
        assert e1.sequence(rid).generated == ref.sequence(0).generated
        declined0 = reg.peer_declined
        e1.submit(S, 2)
        _drain(e1)
        assert reg.peer_declined > declined0
        return (e1.sequence(rid).generated, reg.peer_fetches,
                reg.peer_fetch_blocks, reg.peer_declined,
                e1.prefix_cache.peer_fetches, _audit(pkg, e0),
                _audit(pkg, e1))
    _both(pkgs, run)


# --------------------------------------------- migration instead of re-prefill
def _migration_drill(pkg, arm=None, arm_early=False, prompt_len=96):
    """Warm engine 0 with a long prefix, spill it to its host tier by
    cache pressure, queue a same-prefix request on it, then kill it:
    the adopter decides migration against prefilling again."""
    P = _prompt(pkg.vocab, prompt_len, seed=5)
    filler = _prompt(pkg.vocab, 48, seed=8)
    short = _prompt(pkg.vocab, 16, seed=12)
    clean = pkg.engine()
    clean.submit(P, 4)
    _drain(clean)
    engs = [pkg.engine(max_batch=1, prefix_cache_blocks=2, **TIERED)
            for _ in range(2)]
    reg = pkg.s.FleetKVRegistry(engs, link=_link(pkg))
    router = pkg.s.EngineFailoverRouter(engs, probe_interval_s=1e-4,
                                        kv_registry=reg)
    if arm and arm_early:
        pkg.chaos.arm(arm)
    warm = [{"arrival_t": 1e-4, "prompt": P, "max_new_tokens": 4},
            {"arrival_t": 0.1, "prompt": short, "max_new_tokens": 4},
            {"arrival_t": 0.1, "prompt": list(reversed(short)),
             "max_new_tokens": 4},
            {"arrival_t": 0.2, "prompt": filler, "max_new_tokens": 4},
            {"arrival_t": 0.21, "prompt": filler[:32], "max_new_tokens": 4},
            {"arrival_t": 0.22, "prompt": filler[:16], "max_new_tokens": 4}]
    warm_rep = pkg.s.simulate_router(router, warm)
    e0 = router.engines[0]
    assert all(k in e0.host_tier for k in e0.prefix_cache._keys(P))
    if arm and not arm_early:
        pkg.chaos.arm(arm)
    rid = router.submit(P, 4, arrival_t=1.0)
    assert router.home_of(rid) == 0
    e0.fail("drill", now=1.0)
    router.probe(now=1.0)
    return router, rid, clean.sequence(0).generated, vars(warm_rep)


def _finish_rid(router, rid, t0=1.0):
    seq = router.sequence(rid)
    eng = router.engines[router.home_of(rid)]
    t = max(t0, seq.kv_ready_t) + 1e-6
    for step in range(500):
        eng.tick(now=t + step * 1e-3)
        if seq.state.name == "FINISHED":
            return seq
    raise AssertionError("recovered sequence did not finish")


def _drill_record(pkg, router, rid, clean, warm):
    seq = router.sequence(rid)
    ready = seq.kv_ready_t
    got = _finish_rid(router, rid).generated
    assert got == clean
    return dict(tokens=got, kv_ready_t=ready, migrations=router.migrations,
                migrated=router.kv_migrated_blocks,
                declined=router.migrations_declined,
                fired=pkg.chaos.fired_log(), warm=warm)


def test_migration_beats_reprefill_long_context(pkgs):
    def run(pkg):
        router, rid, clean, warm = _migration_drill(pkg)
        assert router.migrations == 1 and router.kv_migrated_blocks >= 5
        seq = router.sequence(rid)
        eng = router.engines[router.home_of(rid)]
        full = cost_seconds(eng.runner.prefill_cost(
            eng.runner.prefill_padded_len(len(seq.tokens))))
        assert 0.0 < seq.kv_ready_t - 1.0 < full
        return _drill_record(pkg, router, rid, clean, warm)
    _both(pkgs, run)


def test_migration_declines_short_context(pkgs):
    def run(pkg):
        router, rid, clean, warm = _migration_drill(pkg, prompt_len=16)
        assert router.migrations == 0 and router.migrations_declined >= 1
        assert router.sequence(rid).kv_ready_t == 0.0
        return _drill_record(pkg, router, rid, clean, warm)
    _both(pkgs, run)


def test_migration_chaos_drop_falls_back(pkgs):
    def run(pkg):
        router, rid, clean, warm = _migration_drill(pkg,
                                                    arm="drop_migration:1")
        assert ("drop_migration", "kv transfer dropped") in \
            pkg.chaos.fired_log()
        assert router.migrations == 0
        assert router.sequence(rid).kv_ready_t == 0.0
        return _drill_record(pkg, router, rid, clean, warm)
    _both(pkgs, run)


def test_migration_corrupt_spill_falls_back(pkgs):
    def run(pkg):
        router, rid, clean, warm = _migration_drill(
            pkg, arm="corrupt_spill_block:1", arm_early=True)
        assert any(k == "corrupt_spill_block"
                   for k, _ in pkg.chaos.fired_log())
        rec = _drill_record(pkg, router, rid, clean, warm)
        eng = router.engines[router.home_of(rid)]
        eng.allocator.rebuild_free_list(
            [s.table.blocks for s in eng.scheduler.running()]
            + [eng.prefix_cache.held_blocks()])
        rec["audit"] = _audit(pkg, eng)
        return rec
    _both(pkgs, run)


# --------------------------------------------------- prefix-affinity routing
def test_router_prefix_affinity(pkgs):
    """Routing prefers the engine holding the longest cached prefix (HBM
    or host tier) over least-loaded; with no holder it falls back to
    least-loaded."""
    def run(pkg):
        engs = [pkg.engine(**TIERED) for _ in range(2)]
        reg = pkg.s.FleetKVRegistry(engs, link=_link(pkg))
        router = pkg.s.EngineFailoverRouter(engs, probe_interval_s=1e-4,
                                            kv_registry=reg)
        P = _prompt(pkg.vocab, 96, seed=5)
        homes = [router.home_of(router.submit(P, 2, arrival_t=0.0))]
        _drain(engs[0])
        router.submit(_prompt(pkg.vocab, 48, seed=9), 2, arrival_t=0.1)
        homes.append(router.home_of(router.submit(P, 2, arrival_t=0.2)))
        homes.append(router.home_of(router.submit(
            _prompt(pkg.vocab, 32, seed=10), 2, arrival_t=0.3)))
        return homes
    assert _both(pkgs, run) == [0, 0, 1]


def test_fleet_sim_with_tiers_matches_jax(pkgs):
    """A fleet of two tiered engines under the router and the registry
    through a cohort trace: the same report, field by field, and the
    same tokens as the engines serving as independent caches."""
    def run(pkg):
        rng = np.random.default_rng(21)
        heads = [rng.integers(0, pkg.vocab, size=32).tolist()
                 for _ in range(2)]
        trace = pkg.s.poisson_trace(8, 4000.0, [16, 24], [4, 6],
                                    pkg.vocab, seed=4)
        for i, r in enumerate(trace):
            r["prompt"] = heads[i % 2] + r["prompt"]
        engs = [pkg.engine(prefix_cache_blocks=3, **TIERED)
                for _ in range(2)]
        reg = pkg.s.FleetKVRegistry(engs, link=_link(pkg))
        router = pkg.s.EngineFailoverRouter(engs, probe_interval_s=1e-4,
                                            kv_registry=reg)
        rep = pkg.s.simulate_router(router, [dict(r) for r in trace])
        solo = [pkg.engine(**TIERED) for _ in range(2)]
        plain = pkg.s.EngineFailoverRouter(solo, probe_interval_s=1e-4)
        rep0 = pkg.s.simulate_router(plain, [dict(r) for r in trace])
        toks = [router.sequence(r).generated for r in rep.rids]
        assert toks == [plain.sequence(r).generated for r in rep0.rids]
        return toks, vars(rep), vars(rep0), reg.peer_fetch_blocks
    _both(pkgs, run)
