"""The port's serving stack (paddle2_tpu_torch.serving): block cache,
scheduler and ServingEngine, held against the JAX package's engine and
against the port's own greedy generate, on the CPU (plain versions of
the kernels). The host-side cases mirror tests/test_serving.py."""

import numpy as np
import pytest
import torch

import paddle2_tpu as paddle
from paddle2_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle2_tpu.models.gpt import gpt_tiny as jax_tiny
from paddle2_tpu.serving import EngineConfig as JaxEngineConfig
from paddle2_tpu.serving import ServingEngine as JaxEngine
from paddle2_tpu_torch.models import (GPTForCausalLM, gpt_state_from_reference,
                                      gpt_tiny)
from paddle2_tpu_torch.serving import (
    BlockAllocator, BlockFreeError, BlockTable, ContinuousBatchingScheduler,
    EngineConfig, EngineFailedError, GARBAGE_BLOCK, OutOfBlocksError,
    PagedKVCache, PromptTooLongError, Request, SchedulerConfig, Sequence,
    SeqState, ServingEngine)


# ------------------------------------------------------------ block cache
def test_allocator_free_list_and_high_water():
    a = BlockAllocator(num_blocks=8, block_size=16)
    assert a.free_count == 7                # block 0 reserved
    b1 = a.allocate(3)
    assert GARBAGE_BLOCK not in b1
    a.allocate(2)
    assert a.high_water == 5
    a.free(b1)
    assert a.free_count == 5
    assert a.high_water == 5                # sticky peak
    with pytest.raises(OutOfBlocksError):
        a.allocate(6)
    with pytest.raises(BlockFreeError):
        a.free(b1)                          # double free
    with pytest.raises(BlockFreeError):
        a.free([0])                         # reserved block
    with pytest.raises(BlockFreeError):
        a.free([a.allocate(1)[0]] * 2)      # duplicate in one call


def test_block_table_append_and_padding():
    a = BlockAllocator(num_blocks=16, block_size=4)
    t = BlockTable(a)
    slots = [t.append_slot() for _ in range(6)]
    assert t.num_tokens == 6 and len(t.blocks) == 2
    assert slots[0] == (t.blocks[0], 0)
    assert slots[4] == (t.blocks[1], 0)
    row = t.padded(5)
    assert list(row[:2]) == t.blocks
    assert all(row[2:] == GARBAGE_BLOCK)
    t.release()
    assert t.num_tokens == 0 and a.used_count == 0


def test_paged_cache_scatter_in_place_and_gather():
    cache = PagedKVCache(num_layers=2, num_blocks=8, block_size=4,
                         num_heads=2, head_dim=4, device="cpu")
    pool = cache.k
    kv = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 7, 2, 4)).astype(np.float32))
    row = np.asarray([3, 5], np.int64)
    PagedKVCache.scatter_prefill(cache.k, kv, row, 7, 4)
    assert cache.k is pool                   # in place, no new pool
    dense = PagedKVCache.gather_dense(cache.k[0], row, 2)
    assert torch.equal(dense[:7], kv[0])
    new = torch.ones(2, 2, 4)
    PagedKVCache.scatter_decode(cache.k, 1, torch.tensor([5, 0]),
                                torch.tensor([3, 0]), new)
    assert torch.equal(cache.k[1, 5, 3], new[0])
    assert cache.block_bytes == 2 * 2 * 4 * 2 * 4 * 4


# -------------------------------------------------------------- scheduler
def _mk_seq(alloc, rid, prompt_len, max_new=4):
    return Sequence(Request(rid, list(range(1, prompt_len + 1)), max_new),
                    alloc)


def test_scheduler_admit_fifo_and_budget():
    alloc = BlockAllocator(num_blocks=64, block_size=4)
    sched = ContinuousBatchingScheduler(SchedulerConfig(
        max_batch=4, batch_buckets=(1, 2, 4), page_buckets=(2, 4, 8),
        prefill_budget_tokens=10), alloc)
    for i, n in enumerate([4, 4, 6]):
        sched.submit(_mk_seq(alloc, i, n))
    assert [s.req_id for s in sched.admit()] == [0, 1]
    assert [s.req_id for s in sched.admit()] == [2]


def test_scheduler_admit_respects_batch_and_blocks():
    alloc = BlockAllocator(num_blocks=5, block_size=4)   # 4 usable
    sched = ContinuousBatchingScheduler(SchedulerConfig(
        max_batch=2, batch_buckets=(1, 2), page_buckets=(2, 4),
        prefill_budget_tokens=0), alloc)
    for i in range(3):
        sched.submit(_mk_seq(alloc, i, 6))  # needs 2 blocks (7 tokens)
    admitted = sched.admit()
    assert [s.req_id for s in admitted] == [0, 1]
    for s in admitted:
        sched.mark_running(s)
    assert sched.admit() == []              # batch full
    sched.finish(admitted[0])
    assert [s.req_id for s in sched.admit()] == [2]


def test_scheduler_evicts_lifo_and_requeues_front():
    alloc = BlockAllocator(num_blocks=5, block_size=4)   # 4 usable
    sched = ContinuousBatchingScheduler(SchedulerConfig(
        max_batch=4, batch_buckets=(1, 2, 4), page_buckets=(1, 2, 4),
        prefill_budget_tokens=0), alloc)
    a, b = _mk_seq(alloc, 0, 7, max_new=8), _mk_seq(alloc, 1, 7, max_new=8)
    for s in (a, b):
        sched.submit(s)
    for s in sched.admit():
        s.table.num_tokens = 7
        sched.mark_running(s)
    assert alloc.free_count == 0
    a.table.num_tokens = 8
    b.table.num_tokens = 8
    assert sched.reserve_decode_slots() == [b]
    assert b.state is SeqState.WAITING and b.evictions == 1
    assert b.num_cached == 0 and not b.table.blocks
    assert sched.waiting[0] is b            # requeued at the FRONT
    assert a.state is SeqState.RUNNING and len(a.table.blocks) == 3


def test_scheduler_bucket_shapes():
    cfg = SchedulerConfig(max_batch=8, batch_buckets=(1, 2, 4, 8),
                          page_buckets=(2, 4, 8))
    assert cfg.batch_bucket(3) == 4
    assert cfg.page_bucket(5) == 8
    assert cfg.program_budget == 12
    with pytest.raises(ValueError):
        cfg.page_bucket(9)
    with pytest.raises(ValueError):
        SchedulerConfig(max_batch=8, batch_buckets=(1, 2))


# ------------------------------------------------------------- the engine
@pytest.fixture(scope="module")
def models():
    """The JAX gpt_tiny and the port's gpt_tiny with the same weights."""
    paddle.seed(0)
    jm = JaxGPT(jax_tiny(use_scan=False))
    tm = GPTForCausalLM(gpt_tiny(), device="cpu")
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm.load_state_dict(gpt_state_from_reference(state))
    return jm, tm


ENGINE_KW = dict(block_size=8, num_blocks=32, max_batch=4,
                 prefill_budget_tokens=64, max_model_len=64)


def _engine(model, **over):
    return ServingEngine(model, EngineConfig(**{**ENGINE_KW, **over}),
                         device="cpu")


def _drain(eng, max_steps=300):
    steps = 0
    while not eng.idle() and steps < max_steps:
        eng.tick(now=float(steps))
        steps += 1
    assert eng.idle(), "engine did not drain"


def _prompts(seed, vocab, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).tolist() for n in lens]


def test_engine_matches_jax_engine_and_generate(models):
    """Token for token: the port's engine == the JAX engine == the
    port's dense greedy generate, from the same weights."""
    jm, tm = models
    prompts = _prompts(0, tm.cfg.vocab_size, [12, 5, 20])
    eng = _engine(tm)
    jeng = JaxEngine(jm, config=JaxEngineConfig(**ENGINE_KW))
    rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    jrids = [jeng.submit(p, max_new_tokens=6) for p in prompts]
    _drain(eng)
    _drain(jeng)
    for p, r, jr in zip(prompts, rids, jrids):
        got = eng.sequence(r).generated
        assert got == jeng.sequence(jr).generated
        dense = tm.generate(np.asarray([p]), max_new_tokens=6)
        assert got == dense[0, len(p):].tolist()


def test_engine_split_k_matches_generate(models):
    _, tm = models
    prompts = _prompts(1, tm.cfg.vocab_size, [30, 9])
    eng = _engine(tm, split_pages=1)
    rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    _drain(eng)
    for p, r in zip(prompts, rids):
        dense = tm.generate(np.asarray([p]), max_new_tokens=6)
        assert eng.sequence(r).generated == dense[0, len(p):].tolist()


def test_engine_eviction_exactness(models):
    """Block exhaustion -> eviction -> requeue -> re-prefill, with the
    final tokens identical to an uncontended run."""
    _, tm = models
    prompts = _prompts(3, tm.cfg.vocab_size, [14] * 4)

    def run(num_blocks):
        eng = _engine(tm, num_blocks=num_blocks)
        rids = [eng.submit(p, max_new_tokens=8) for p in prompts]
        _drain(eng)
        return eng, rids

    big, rids_big = run(64)
    tight, rids_tight = run(10)             # 9 usable blocks
    assert tight.scheduler.total_evictions >= 1
    for a, b in zip(rids_big, rids_tight):
        assert big.sequence(a).generated == tight.sequence(b).generated


def test_engine_decode_shapes_bounded(models):
    _, tm = models
    eng = _engine(tm)
    rng = np.random.default_rng(5)
    for wave in ([6, 10], [8], [5, 7, 9]):
        for n in wave:
            eng.submit(rng.integers(0, tm.cfg.vocab_size, size=n).tolist(),
                       max_new_tokens=4)
        _drain(eng)
    assert 0 < eng.num_decode_programs <= eng.program_budget
    cfg = eng.scheduler.config
    assert eng.runner._decode_buckets <= {
        (b, p) for b in cfg.batch_buckets for p in cfg.page_buckets}
    assert eng.kv_high_water_bytes() > 0


def test_engine_needs_a_device_by_default(models, monkeypatch):
    _, tm = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(tm, EngineConfig(**ENGINE_KW))


@pytest.mark.parametrize("option,value", [("enable_kv_spill", True)])
def test_unported_options_raise(models, option, value):
    _, tm = models
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _engine(tm, **{option: value})


def test_artifact_path_and_dtype_mismatch_raise(models):
    _, tm = models
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServingEngine(tm, device="cpu", artifact_path="some/model")
    with pytest.raises(ValueError, match="kv_dtype"):
        _engine(tm, kv_dtype="bfloat16")


def test_submit_rejections_and_failed_engine(models):
    _, tm = models
    eng = _engine(tm)
    with pytest.raises(PromptTooLongError):
        eng.submit(list(range(60)), max_new_tokens=8)
    with pytest.raises(ValueError):
        eng.submit([], max_new_tokens=1)
    eng.failed, eng.fail_reason = True, "test"
    with pytest.raises(EngineFailedError):
        eng.submit([1, 2], max_new_tokens=1)


def test_engine_bf16_serves(models):
    """bf16 model + bf16 KV: the engine serves and agrees with the
    port's bf16 generate on the first token (later tokens may part at
    bf16 rounding)."""
    _, tm = models
    m16 = GPTForCausalLM(gpt_tiny(), device="cpu", dtype=torch.bfloat16)
    m16.load_state_dict(tm.state_dict())
    eng = _engine(m16, kv_dtype="bfloat16")
    p = _prompts(7, tm.cfg.vocab_size, [11])[0]
    rid = eng.submit(p, max_new_tokens=4)
    _drain(eng)
    gen = eng.sequence(rid).generated
    assert len(gen) == 4 and all(0 <= t < tm.cfg.vocab_size for t in gen)
    dense = m16.generate(np.asarray([p]), max_new_tokens=4)
    assert gen[0] == int(dense[0, len(p)])
