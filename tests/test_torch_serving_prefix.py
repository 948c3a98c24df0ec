"""The port's copy-on-write KV blocks and prefix cache
(paddle2_tpu_torch.serving.block_cache, the scheduler's prefix lookup
and the engine's prefix hits), held against the JAX package on the CPU:
the same operations give the same refcounts, free lists, tables and
counters, and the engine with the cache on serves the JAX engine's
tokens exactly, round by round. The host-side cases mirror
tests/test_serving_throughput.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle2_tpu.serving import BlockAllocator as JaxAllocator
from paddle2_tpu.serving import BlockTable as JaxTable
from paddle2_tpu.serving import PagedKVCache as JaxCache
from paddle2_tpu.serving import PrefixCache as JaxPrefixCache
from paddle2_tpu.serving import audit_kv_ledger as jax_audit
from paddle2_tpu.serving.block_cache import BlockFreeError as JaxFreeError
from paddle2_tpu.serving.scheduler import (
    ContinuousBatchingScheduler as JaxScheduler, Request as JaxRequest,
    SchedulerConfig as JaxSchedulerConfig, Sequence as JaxSequence)
from paddle2_tpu_torch.serving import (
    BlockAllocator, BlockFreeError, BlockTable, ContinuousBatchingScheduler,
    GARBAGE_BLOCK, OutOfBlocksError, PagedKVCache, PrefixCache, Request,
    SchedulerConfig, Sequence, audit_kv_ledger)

from torch_serving_twins import (engines, generated, lockstep, shared_trace,
                                 twin_models)


@pytest.fixture(scope="module")
def models():
    return twin_models()


def _alloc_state(a):
    return dict(sorted(a._rc.items())), list(a._free), a.high_water, \
        a.total_allocated


# ----------------------------------------------- allocator and tables
# each script runs on a JAX and a port allocator; states agree after
# every op, and an op raises on both or on neither
SCRIPTS = {
    "share_free": [("alloc", 2), ("share", [1, 2]), ("free", [1, 2]),
                   ("free", [1, 2]), ("free", [1, 2]), ("share", [1]),
                   ("share", [0]), ("share", [99])],
    "lifo_reuse": [("alloc", 3), ("free", [2]), ("alloc", 1),
                   ("share", [3]), ("free", [3, 3]), ("free", [3]),
                   ("alloc", 4)],
    "exhaust": [("alloc", 6), ("alloc", 2), ("share", [6]), ("free", [6]),
                ("alloc", 1), ("free", [1, 2, 3, 4, 5, 6])],
    "rebuild": [("alloc", 4), ("share", [1, 2]),
                ("rebuild", [[1, 2, 3], [1], [2]]), ("free", [4]),
                ("free", [1]), ("rebuild", [[0, 55]])],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_allocator_scripts_match_jax(name):
    j, t = JaxAllocator(8, 4), BlockAllocator(8, 4)
    for op, arg in SCRIPTS[name]:
        outs = []
        for a in (j, t):
            fn = {"alloc": a.allocate, "share": a.share, "free": a.free,
                  "rebuild": a.rebuild_free_list}[op]
            try:
                outs.append(("ok", fn(arg)))
            except Exception as e:          # noqa: BLE001 - compared below
                outs.append((type(e).__name__, None))
        assert outs[0] == outs[1], (op, arg, outs)
        assert _alloc_state(j) == _alloc_state(t), (op, arg)


def test_allocator_share_free_refcounts():
    a = BlockAllocator(num_blocks=8, block_size=16)
    blocks = a.allocate(2)
    assert a.total_allocated == 2
    a.share(blocks)
    assert all(a.refcount(b) == 2 for b in blocks)
    a.free(blocks)
    assert a.free_count == 5 and all(a.refcount(b) == 1 for b in blocks)
    a.free(blocks)
    assert a.free_count == 7
    with pytest.raises(BlockFreeError):
        a.free(blocks)
    with pytest.raises(BlockFreeError):
        a.share([blocks[0]])
    with pytest.raises(BlockFreeError):
        a.share([GARBAGE_BLOCK])


def _table_ops(alloc_cls, table_cls):
    """Fork twice off a 10-token parent, release interleaved, then a
    speculative over-reserve and truncate: the refcounts along the way."""
    a = alloc_cls(12, 4)
    parent = table_cls(a)
    for _ in range(10):
        parent.append_slot()
    f1, c1 = parent.fork()
    f2, c2 = parent.fork()
    log = [(c1, c2, list(f1.blocks), list(f2.blocks),
            dict(sorted(a._rc.items())))]
    f1.release()
    log.append(dict(sorted(a._rc.items())))
    parent.release()
    log.append(dict(sorted(a._rc.items())))
    for _ in range(3):
        f2.append_slot()
    f2.ensure_capacity(f2.num_tokens + 5)
    log.append((list(f2.blocks), f2.truncate(), list(f2.blocks)))
    f2.release()
    log.append((a.free_count, list(a._free)))
    return log


def test_fork_release_truncate_match_jax():
    assert _table_ops(JaxAllocator, JaxTable) == \
        _table_ops(BlockAllocator, BlockTable)


def test_double_fork_then_interleaved_release():
    a = BlockAllocator(num_blocks=12, block_size=4)
    parent = BlockTable(a)
    for _ in range(10):                 # 2 full blocks + 2-token tail
        parent.append_slot()
    f1, copy1 = parent.fork()
    f2, copy2 = parent.fork()
    assert copy1 is not None and copy2 is not None
    shared = parent.blocks[:2]
    assert all(a.refcount(b) == 3 for b in shared)
    f1.release()
    assert all(a.refcount(b) == 2 for b in shared)
    parent.release()
    assert all(a.refcount(b) == 1 for b in shared)
    assert f2.blocks[:2] == shared
    f2.release()
    assert a.free_count == a.num_blocks - 1
    aligned = BlockTable(a)
    for _ in range(8):
        aligned.append_slot()
    _, copy = aligned.fork()
    assert copy is None                 # block-aligned: nothing to copy


def test_append_into_shared_block_refused():
    a = BlockAllocator(num_blocks=8, block_size=4)
    t = BlockTable(a)
    for _ in range(6):
        t.append_slot()
    a.share([t.blocks[1]])              # a bookkeeping bug
    with pytest.raises(BlockFreeError):
        t.append_slot()
    with pytest.raises(BlockFreeError):
        t.attach_shared([1])            # only on an empty table


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fork_tail_copy_matches_jax(dtype):
    """The fork's partial tail block is copied in place on both pools,
    byte for byte as the JAX copy, and a write into the fork's tail
    leaves the parent's bytes alone."""
    rng = np.random.default_rng(0)
    base = rng.normal(size=(2, 8, 4, 2, 3)).astype(np.float32)
    pool = torch.from_numpy(base).to(dtype)
    a = BlockAllocator(num_blocks=8, block_size=4)
    t = BlockTable(a)
    for _ in range(6):
        t.append_slot()
    f, (src, dst) = t.fork()
    ptr = pool.data_ptr()
    PagedKVCache.copy_block(pool, src, dst)
    assert pool.data_ptr() == ptr       # in place
    jpool = JaxCache.copy_block(jnp.asarray(base).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32), src, dst)
    assert np.array_equal(pool.float().numpy(),
                          np.asarray(jpool, np.float32))
    before = pool[:, src].clone()
    pool[:, dst, 2] = -1.0
    assert torch.equal(pool[:, src], before)


def test_scatter_prefill_from_start_leaves_the_prefix():
    """``start`` skips the shared prefix: positions below it keep their
    bytes, positions from it on equal the JAX scatter."""
    rng = np.random.default_rng(1)
    pool0 = rng.normal(size=(2, 8, 4, 2, 3)).astype(np.float32)
    kv = rng.normal(size=(2, 16, 2, 3)).astype(np.float32)
    row = np.asarray([5, 2, 7, 1], np.int64)
    pool = torch.from_numpy(pool0.copy())
    PagedKVCache.scatter_prefill(pool, torch.from_numpy(kv), row, 13, 4,
                                 start=8)
    jpool = JaxCache.scatter_prefill(jnp.asarray(pool0), jnp.asarray(kv),
                                     row, 13, 4, start=8)
    assert np.array_equal(pool.numpy(), np.asarray(jpool))
    assert np.array_equal(pool.numpy()[:, [5, 2]], pool0[:, [5, 2]])


# ---------------------------------------------------------- prefix cache
def _cache_ops(alloc_cls, table_cls, cache_cls):
    a = alloc_cls(16, 4)
    c = cache_cls(a, max_blocks=3)
    t = table_cls(a)
    toks = list(range(16))
    t.ensure_capacity(16)
    t.num_tokens = 16
    log = [c.insert(toks, t.blocks), len(c), c.insert(toks, t.blocks)]
    hit = c.lookup(toks[:12] + [77, 78])
    log.append((hit, c.hits, c.misses, c.reclaimable()))
    a.free(hit[0])
    log.append(c.lookup([99] + toks[1:12]))
    log.append((c.lookup(toks, share=False), c.hits, c.misses))
    t.release()
    log.append((c.reclaimable(), len(c)))
    # the bound trims least recently used first once blocks are free
    c.reclaim(len(c) - c.max_blocks)
    log.append((sorted(c.held_blocks()), c.evictions, len(c)))
    other = table_cls(a)
    other.ensure_capacity(4 * (a.free_count + 2))   # reclaim under pressure
    log.append((sorted(c.held_blocks()), c.evictions, a.free_count,
                dict(sorted(a._rc.items()))))
    return log


def test_prefix_cache_ops_match_jax():
    assert _cache_ops(JaxAllocator, JaxTable, JaxPrefixCache) == \
        _cache_ops(BlockAllocator, BlockTable, PrefixCache)


def test_shared_block_eviction_deferred():
    a = BlockAllocator(num_blocks=8, block_size=4)
    cache = PrefixCache(a)
    t = BlockTable(a)
    toks = list(range(8))
    t.ensure_capacity(8)
    t.num_tokens = 8
    cache.insert(toks, t.blocks)
    blocks, n = cache.lookup(toks)
    t2 = BlockTable(a)
    t2.attach_shared(blocks)
    t2.num_tokens = 8
    assert all(a.refcount(b) == 3 for b in t.blocks)
    t.release()
    assert a.refcount(t2.blocks[0]) == 2
    assert cache.reclaimable() == 0 and cache.reclaim(2) == 0
    t2.release()
    assert cache.reclaimable() == 2
    assert cache.reclaim(1) == 1 and len(cache) == 1
    assert audit_kv_ledger(a, [], prefix_cache=cache)["claimed"] == 1


def test_unported_tiers_raise():
    """Once refused, now ported: a host tier, spill I/O and a peer
    source wire into the prefix cache, and the audit counts the tier,
    as in the JAX package: a reclaim spills, a lookup promotes back
    from the host tier, then extends from the peer."""
    from paddle2_tpu.serving import HostKVTier as JaxTier
    from paddle2_tpu_torch.serving import HostKVTier
    out = []
    for alloc_cls, cache_cls, tier_cls, audit in (
            (JaxAllocator, JaxPrefixCache, JaxTier, jax_audit),
            (BlockAllocator, PrefixCache, HostKVTier, audit_kv_ledger)):
        a = alloc_cls(8, 4)
        tier = tier_cls()
        c = cache_cls(a, host_tier=tier)
        store = {}
        c.set_spill_io(lambda b: store[b],
                       lambda b, k, v: store.__setitem__(b, (k, v)))
        peer = [(np.full(2, 7.0), np.full(2, 8.0))]
        c.set_peer_source(lambda keys: (peer, 0.5))
        t = alloc_cls.allocate(a, 2)
        for i, b in enumerate(t):
            store[b] = (np.full(2, float(i)), np.full(2, -float(i)))
        toks = list(range(12))
        c.insert(toks[:8], t)
        a.free(t)
        assert c.reclaim(2) == 2 and len(tier) == 2
        census = audit(a, [], prefix_cache=c, host_tier=tier,
                       in_migration=())
        blocks, n = c.lookup(toks)
        out.append((census, n, c.spills, c.host_fetches, c.peer_fetches,
                    c.last_peer_fetch_s, [store[b][0].tolist()
                                          for b in blocks]))
        audit(a, [blocks], prefix_cache=c, host_tier=tier)
    assert out[0] == out[1]
    assert out[1][1:6] == (12, 2, 2, 1, 0.5)


def test_audit_kv_ledger_matches_jax_and_catches_leaks():
    for alloc_cls, table_cls, audit, err in (
            (JaxAllocator, JaxTable, jax_audit, JaxFreeError),
            (BlockAllocator, BlockTable, audit_kv_ledger, BlockFreeError)):
        a = alloc_cls(10, 4)
        t1, t2 = table_cls(a), table_cls(a)
        t1.ensure_capacity(8)
        a.share(t1.blocks[:1])
        t2.attach_shared(t1.blocks[:1])
        t2.ensure_capacity(8)
        census = audit(a, [t1.blocks, t2.blocks])
        # the JAX census also counts the host tier and migrations (0)
        assert {k: census[k] for k in ("free", "claimed")} == \
            {"free": 6, "claimed": 3}
        with pytest.raises(err):
            audit(a, [t1.blocks])           # t2's blocks leak
        with pytest.raises(err):
            audit(a, [t1.blocks, t2.blocks, t2.blocks[1:]])


def _undo_hit(alloc_cls, table_cls, cache_cls, sched_cls, cfg_cls, req_cls,
              seq_cls):
    a = alloc_cls(8, 4)
    cache = cache_cls(a)
    sched = sched_cls(cfg_cls(max_batch=4, batch_buckets=(4,),
                              page_buckets=(8,), prefill_budget_tokens=0), a)
    sched.prefix_cache = cache
    prefix = list(range(8))
    t = table_cls(a)
    t.ensure_capacity(8)
    t.num_tokens = 8
    cache.insert(prefix, t.blocks)
    t.release()                          # the 2 cached blocks are the
    hog = table_cls(a)                   # only headroom
    hog.ensure_capacity(20)
    seq = seq_cls(req_cls(0, prefix + [9, 9, 9, 9], 4), a)
    sched.submit(seq)
    first = (sched.admit(0.0), list(seq.table.blocks),
             seq.prefix_cached_tokens,
             [a.refcount(b) for b in cache.held_blocks()])
    hog.release()
    second = ([s.req_id for s in sched.admit(1.0)], list(seq.table.blocks),
              seq.prefix_cached_tokens)
    return first, second


def test_admit_undoes_hit_when_own_prefix_is_the_headroom():
    got = _undo_hit(BlockAllocator, BlockTable, PrefixCache,
                    ContinuousBatchingScheduler, SchedulerConfig, Request,
                    Sequence)
    assert got == _undo_hit(JaxAllocator, JaxTable, JaxPrefixCache,
                            JaxScheduler, JaxSchedulerConfig, JaxRequest,
                            JaxSequence)
    (admitted, blocks, cached, rcs), (again, _, cached2) = got
    assert admitted == [] and blocks == [] and cached == 0
    assert rcs == [1, 1] and again == [0] and cached2 == 8


# ------------------------------------------------------------- the engine
@pytest.mark.parametrize("arrive_every", [0, 2])
def test_engine_prefix_cache_matches_jax_round_by_round(models,
                                                        arrive_every):
    """Tokens, tables, refcounts, free lists and the cache's hits and
    misses equal the JAX engine's after every round, the tokens equal
    the cache-off run, fewer blocks are materialised, and the ledger
    audits clean at every round."""
    jm, tm, _ = models
    trace = shared_trace(tm.cfg.vocab_size)
    jeng, teng = engines(jm, tm, enable_prefix_cache=True)

    def audit(rnd, j, t):
        live = [s.table.blocks for s in t.scheduler.running()]
        audit_kv_ledger(t.allocator, live, prefix_cache=t.prefix_cache)

    _, rids = lockstep(jeng, teng, trace, arrive_every=arrive_every,
                       on_round=audit)
    assert generated(teng, rids) == generated(jeng, rids)
    joff, off = engines(jm, tm)
    _, off_rids = lockstep(joff, off, trace, arrive_every=arrive_every)
    assert generated(teng, rids) == generated(off, off_rids)
    pc = teng.prefix_cache
    assert pc.hits >= len(trace) - 1 and pc.misses >= 1
    assert teng.allocator.total_allocated < off.allocator.total_allocated
    held = pc.held_blocks()
    assert held and all(teng.allocator.refcount(b) == 1 for b in held)


def test_engine_hit_scatters_only_the_tail(models):
    """A hitting request's prefill leaves the shared blocks' bytes
    untouched in every layer, and its own tail lands in its own blocks."""
    jm, tm, _ = models
    trace = shared_trace(tm.cfg.vocab_size, n=2)
    _, teng = engines(jm, tm, enable_prefix_cache=True)
    first = teng.submit(trace[0]["prompt"], 4)
    teng.admit_and_prefill(0.0)
    shared = teng.sequence(first).table.blocks[:3]
    k0, v0 = teng.cache.k[:, shared].clone(), teng.cache.v[:, shared].clone()
    second = teng.submit(trace[1]["prompt"], 4)
    info = teng.admit_and_prefill(1.0)
    seq = teng.sequence(second)
    assert info[0]["cached_tokens"] == 48
    assert seq.prefix_cached_tokens == 48 and seq.table.blocks[:3] == shared
    assert torch.equal(teng.cache.k[:, shared], k0)
    assert torch.equal(teng.cache.v[:, shared], v0)
    while not teng.idle():
        teng.tick(2.0)
    assert torch.equal(teng.cache.k[:, shared], k0)
    assert torch.equal(teng.cache.v[:, shared], v0)


def test_engine_lru_reclaim_under_pressure_matches_jax(models):
    """A pool too small to keep every cached prefix: the cache gives
    blocks back least recently used first, exactly as the JAX one."""
    jm, tm, _ = models
    rng = np.random.default_rng(11)
    trace = []
    for i in range(6):
        sys_prompt = rng.integers(0, tm.cfg.vocab_size, size=32).tolist()
        trace.append(dict(prompt=sys_prompt + [i + 1] * 8,
                          max_new_tokens=6))
    trace += [dict(trace[0]), dict(trace[5])]
    jeng, teng = engines(jm, tm, enable_prefix_cache=True, num_blocks=12,
                         max_batch=2, prefix_cache_blocks=4)
    _, rids = lockstep(jeng, teng, trace, arrive_every=3)
    assert teng.prefix_cache.evictions > 0
    assert teng.prefix_cache.evictions == jeng.prefix_cache.evictions
    assert len(teng.prefix_cache) <= 4
    assert generated(teng, rids) == generated(jeng, rids)


def test_engine_prefix_cache_eviction_recovery(models):
    """An eviction of a prefix-sharing sequence mid-decode: re-admission
    finds the cached prefix again, and the stream equals the JAX
    engine's under the same eviction."""
    jm, tm, _ = models
    trace = shared_trace(tm.cfg.vocab_size, n=3, gen=10)
    jeng, teng = engines(jm, tm, enable_prefix_cache=True,
                         prefill_budget_tokens=512)

    def evict(rnd, j, t):
        if rnd == 3:
            j.scheduler._evict(j.scheduler.running()[-1], now=float(rnd))
            t.scheduler._evict(t.scheduler.running()[-1])

    _, rids = lockstep(jeng, teng, trace, on_round=evict)
    assert sum(teng.sequence(r).evictions for r in rids) == 1
    assert generated(teng, rids) == generated(jeng, rids)


def test_validate_tables_allows_sharing_and_catches_a_scribble(models):
    jm, tm, _ = models
    trace = shared_trace(tm.cfg.vocab_size, n=3, gen=6)
    outs = []
    for eng in engines(jm, tm, enable_prefix_cache=True,
                       prefill_budget_tokens=512):
        for r in trace:
            eng.submit(r["prompt"], r["max_new_tokens"])
        eng.admit_and_prefill(0.0)
        running = eng.scheduler.running()
        shared = set(running[0].table.blocks) & set(running[1].table.blocks)
        assert shared
        assert len(eng._validate_tables(list(running))) == len(running)
        victim, other = running[0], running[1]
        victim.table.blocks[-1] = [b for b in other.table.blocks
                                   if b not in shared][0]
        left = eng._validate_tables(list(eng.scheduler.running()))
        outs.append(([s.req_id for s in left],
                     [s.recoveries for s in running],
                     dict(sorted(eng.allocator._rc.items())),
                     list(eng.allocator._free)))
    assert outs[0] == outs[1]
    assert outs[1][0] == [2] and outs[1][1] == [1, 1, 0]
