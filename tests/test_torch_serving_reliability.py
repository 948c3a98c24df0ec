"""The port's serving reliability (paddle2_tpu_torch.serving.reliability,
the scheduler's bounded queue and the engine's failure, recovery,
adoption and weight hot swap), held against the JAX package on the CPU:
the same requests shed in the same order with the same error types, the
SLO ledgers agree, and recovered, adopted and hot-swapped engines serve
the JAX engines' tokens. The cases mirror tests/test_serving_reliability.py
where they need no EngineFailoverRouter (serving/simulate.py is not
ported)."""

import numpy as np
import pytest
import torch

from paddle2_tpu.serving import EngineFailedError as JaxFailed
from paddle2_tpu.serving import HotSwapController as JaxHotSwap
from paddle2_tpu.serving import ReliabilityConfig as JaxRel
from paddle2_tpu.serving import SLOConfig as JaxSLO
from paddle2_tpu.serving.block_cache import BlockAllocator as JaxAllocator
from paddle2_tpu.serving.scheduler import (
    ContinuousBatchingScheduler as JaxScheduler, Request as JaxRequest,
    SchedulerConfig as JaxSchedulerConfig, Sequence as JaxSequence)
from paddle2_tpu_torch.serving import (
    BlockAllocator, ContinuousBatchingScheduler, DeadlineExceeded,
    EngineFailedError, HotSwapController, PromptTooLongError,
    QueueFullError, ReliabilityConfig, Request, RequestRejected, SLOConfig,
    SchedulerConfig, SeqState, Sequence, ServingError, WeightSwapError)

from torch_serving_twins import (engines, generated, lockstep, plain_trace,
                                 port_model, twin_models)

JAX = (JaxAllocator, JaxScheduler, JaxSchedulerConfig, JaxRequest,
       JaxSequence, JaxRel)
PORT = (BlockAllocator, ContinuousBatchingScheduler, SchedulerConfig,
        Request, Sequence, ReliabilityConfig)


@pytest.fixture(scope="module")
def models():
    return twin_models()


def _rel(**kw):
    """The same reliability settings for both engines."""
    slo = kw.pop("slo", None)
    return dict(reliability=ReliabilityConfig(
        slo=SLOConfig(**slo) if slo else None, **kw),
        jax_reliability=JaxRel(slo=JaxSLO(**slo) if slo else None, **kw))


def test_error_types():
    assert issubclass(QueueFullError, RequestRejected)
    assert issubclass(PromptTooLongError, RequestRejected)
    assert issubclass(RequestRejected, ValueError)
    for e in (RequestRejected, DeadlineExceeded, EngineFailedError,
              WeightSwapError):
        assert issubclass(e, ServingError)
    assert ReliabilityConfig(default_deadline_s=2.0).deadline_for(
        3.0, None) == 5.0
    assert ReliabilityConfig().deadline_for(3.0, 1.5) == 4.5
    assert ReliabilityConfig().deadline_for(3.0, None) is None
    assert SLOConfig(availability_target=0.9).error_budget == \
        pytest.approx(0.1)


# ----------------------------------------------------- admission control
def _shed_script(classes, **rel):
    """Submit a priority mix to a bounded queue, evict one admitted
    sequence back into it, expire deadlines and admit: who was shed,
    with which error, and who waits or runs, in order."""
    alloc_cls, sched_cls, cfg_cls, req_cls, seq_cls, rel_cls = classes
    alloc = alloc_cls(64, 4)
    sched = sched_cls(cfg_cls(max_batch=2, batch_buckets=(1, 2),
                              page_buckets=(2, 4, 8, 16),
                              prefill_budget_tokens=0,
                              reliability=rel_cls(**rel)), alloc)
    log = []
    specs = [(0, 0, None), (1, 0, 9.0), (2, 0, None), (3, 5, None),
             (4, 1, 2.0), (5, 5, None), (6, 0, None), (7, 9, 50.0)]
    seqs = {}
    for rid, prio, deadline in specs:
        s = seq_cls(req_cls(rid, list(range(1, 7)), 4, 0.0, priority=prio,
                            deadline_t=deadline), alloc)
        seqs[rid] = s
        try:
            sched.submit(s)
            log.append(("ok", rid))
        except ValueError as e:         # either package's QueueFull
            log.append((type(e).__name__, rid))
        if rid == 2:
            # one admitted sequence comes back, evicted: in flight
            first = sched.admit(0.0)
            for a in first:
                sched.mark_running(a)
            sched._evict(first[-1])
            log.append(("evicted", first[-1].req_id))
    log.append(("expired", [s.req_id for s in sched.expire_deadlines(
        5.0)]))
    log.append(("admit", [s.req_id for s in sched.admit(6.0)]))
    log.append(("waiting", [s.req_id for s in sched.waiting]))
    log.append(("shed", [(s.req_id, type(s.error).__name__)
                         for s in sched.shed]))
    log.append(("states", {r: s.state.value for r, s in seqs.items()}))
    return log, sched.total_shed


@pytest.mark.parametrize("rel", [dict(max_queue_depth=2),
                                 dict(max_queue_depth=3),
                                 dict(max_queue_depth=2,
                                      shed_on_full=False),
                                 dict()], ids=["depth2", "depth3",
                                               "reject", "unbounded"])
def test_shedding_order_matches_jax(rel):
    assert _shed_script(PORT, **rel) == _shed_script(JAX, **rel)


def _sched(max_queue_depth=None, **rel):
    alloc = BlockAllocator(num_blocks=64, block_size=4)
    cfg = SchedulerConfig(
        max_batch=2, batch_buckets=(1, 2), page_buckets=(2, 4, 8, 16),
        prefill_budget_tokens=0,
        reliability=ReliabilityConfig(max_queue_depth=max_queue_depth,
                                      **rel))
    return ContinuousBatchingScheduler(cfg, alloc), alloc


def _seq(alloc, rid, n=6, priority=0, deadline_t=None):
    return Sequence(Request(rid, list(range(1, n + 1)), 4, 0.0,
                            priority=priority, deadline_t=deadline_t), alloc)


def test_bounded_queue_sheds_lowest_priority_first():
    sched, alloc = _sched(max_queue_depth=2)
    lo, lo2 = _seq(alloc, 0), _seq(alloc, 1)
    sched.submit(lo)
    sched.submit(lo2)
    with pytest.raises(QueueFullError):
        sched.submit(_seq(alloc, 2))        # equal priority: rejected
    hi = _seq(alloc, 3, priority=5)
    sched.submit(hi)
    assert sched.waiting == [lo, hi]
    assert lo2.state is SeqState.SHED and isinstance(lo2.error,
                                                     QueueFullError)
    with pytest.raises(QueueFullError):
        lo2.check()
    assert hi.check() is hi and sched.total_shed == 1


def test_expired_deadline_is_shed_never_admitted():
    sched, alloc = _sched()
    dead = _seq(alloc, 0, deadline_t=1.0)
    live = _seq(alloc, 1, deadline_t=50.0)
    sched.submit(dead)
    sched.submit(live)
    assert sched.admit(now=2.0) == [live]
    assert dead.state is SeqState.SHED and dead.table.blocks == []
    with pytest.raises(DeadlineExceeded):
        dead.check()
    assert sched.deadline_shed == 1
    sched2, alloc2 = _sched()
    edge = _seq(alloc2, 0, deadline_t=2.0)
    sched2.submit(edge)
    assert sched2.admit(now=2.0) == [edge]  # == now has not passed


def test_engine_deadline_and_priority_defaults(models):
    jm, tm, _ = models
    outs = []
    for eng in engines(jm, tm, **_rel(default_deadline_s=5.0,
                                      default_priority=3)):
        rid = eng.submit([1, 2, 3], max_new_tokens=2, arrival_t=10.0)
        rid2 = eng.submit([1, 2, 3], max_new_tokens=2, arrival_t=10.0,
                          priority=7, deadline_s=1.0)
        seq, seq2 = eng.sequence(rid), eng.sequence(rid2)
        eng.admit_and_prefill(now=100.0)
        outs.append((seq.priority, seq.deadline_t, seq2.priority,
                     seq2.deadline_t, seq.state.value,
                     type(seq.error).__name__, seq2.state.value))
    assert outs[0] == outs[1] == (3, 15.0, 7, 11.0, "shed",
                                  "DeadlineExceeded", "shed")


def test_engine_queue_full_matches_jax(models):
    """A burst past a bounded queue: the same arrivals are rejected or
    shed, and the rest are served with the JAX engine's tokens."""
    jm, tm, _ = models
    trace = plain_trace(tm.cfg.vocab_size, 8, lens=(10,), gen=(4,), seed=31)
    outs = []
    eng_pair = engines(jm, tm, max_batch=2, **_rel(max_queue_depth=3))
    for eng in eng_pair:
        got = []
        for i, r in enumerate(trace):
            try:
                got.append(eng.submit(r["prompt"], 4,
                                      priority=1 if i % 3 == 0 else 0))
            except ValueError as e:         # either package's QueueFull
                got.append(type(e).__name__)
        steps = 0
        while not eng.idle():
            eng.tick(float(steps))
            steps += 1
        sched = eng.scheduler
        outs.append((got, [(s.req_id, s.priority) for s in sched.shed],
                     [(s.req_id, s.generated) for s in sched.finished]))
    assert outs[0] == outs[1]
    assert outs[1][1] and all(p == 0 for _, p in outs[1][1])


def test_evicted_sequence_exempt_from_shed_and_deadline():
    sched, alloc = _sched(max_queue_depth=2)
    evicted = _seq(alloc, 0, deadline_t=1.0)
    evicted.table.ensure_capacity(4)
    sched.mark_running(evicted)
    sched._evict(evicted)
    fresh = _seq(alloc, 1)
    sched.submit(fresh)
    sched.submit(_seq(alloc, 2, priority=5))
    assert fresh.state is SeqState.SHED
    assert evicted.state is SeqState.WAITING
    assert sched.expire_deadlines(now=100.0) == []


@pytest.mark.parametrize("slo", [
    dict(ttft_target_s=2.5), dict(e2e_target_s=6.5),
    dict(ttft_target_s=3.5, tpot_target_s=0.9, e2e_target_s=9.5)],
    ids=["ttft", "e2e", "all"])
def test_slo_ledger_matches_jax(models, slo):
    """Good and bad verdicts over finished and shed requests: the port's
    ledger counts what the JAX scheduler counts."""
    jm, tm, _ = models
    trace = plain_trace(tm.cfg.vocab_size, 6, lens=(10, 14), gen=(3, 5),
                        seed=41)
    res = []
    for eng in engines(jm, tm, max_batch=2,
                       **_rel(slo=slo, max_queue_depth=3)):
        for i, r in enumerate(trace):
            try:
                eng.submit(r["prompt"], r["max_new_tokens"],
                           priority=i % 2)
            except ValueError as e:         # either package's QueueFull
                assert type(e).__name__ == "QueueFullError"
        steps = 0
        while not eng.idle():
            eng.tick(float(steps))
            steps += 1
        res.append((eng.scheduler.slo_good, eng.scheduler.slo_bad))
    assert res[0] == res[1]
    assert sum(res[1]) >= len(trace) - 1
    good, bad = res[1]
    assert eng.scheduler.slo_burn_rate() == pytest.approx(
        bad / (good + bad) / 0.01)


# ------------------------------------------- failure, recovery, adoption
def test_fail_recover_adopt_token_for_token(models):
    """Fail an engine after three rounds, harvest its sequences, adopt
    them into a second engine: the streams equal an uninterrupted run,
    and both packages harvest, re-key and finish them alike."""
    jm, tm, _ = models
    trace = plain_trace(tm.cfg.vocab_size, 5, seed=23)
    jclean, tclean = engines(jm, tm)
    _, rids = lockstep(jclean, tclean, trace)
    clean = generated(tclean, rids)
    res = []
    first = engines(jm, tm)
    second = engines(jm, tm)
    for side in (0, 1):
        eng, target = first[side], second[side]
        ids = [eng.submit(r["prompt"], r["max_new_tokens"]) for r in trace]
        for step in range(3):
            eng.tick(float(step))
        failed = (EngineFailedError, JaxFailed)
        with pytest.raises(failed):
            eng.recover_inflight()          # only on a failed engine
        eng.fail("test", now=3.0)
        with pytest.raises(failed):
            eng.submit([1, 2], 2)
        with pytest.raises(failed):
            eng.decode_once(4.0)
        done = {r: list(eng.sequence(r).generated) for r in ids
                if eng.sequence(r).state is SeqState.FINISHED}
        harvested = eng.recover_inflight()
        order = [(s.req_id, s.recoveries, s.state.value)
                 for s in harvested]
        new_ids = {s.req_id: target.adopt(s, now=3.0) for s in harvested}
        steps = 4
        while not target.idle():
            target.tick(float(steps))
            steps += 1
        final = dict(done)
        for old, new in new_ids.items():
            final[old] = target.sequence(new).generated
        res.append((order, sorted(new_ids.items()), final,
                    [s.trace_id for s in harvested]))
    assert res[0] == res[1]
    assert [res[1][2][r] for r in rids] == clean
    assert any(rec for _, rec, _ in res[1][0])


def test_recover_inflight_keeps_waiting_seqs_sheddable(models):
    jm, tm, _ = models
    for eng, target in zip(engines(jm, tm), engines(jm, tm)):
        rid = eng.submit([1, 2, 3], max_new_tokens=2, arrival_t=0.0,
                         deadline_s=1.0)
        eng.fail("test", now=0.0)
        (seq,) = eng.recover_inflight()
        assert seq.recoveries == 0 and rid == 0
        target.adopt(seq)
        target.scheduler.expire_deadlines(now=5.0)
        assert seq.state.value == "shed"
        assert type(seq.error).__name__ == "DeadlineExceeded"


def test_adopt_into_a_full_queue_sheds_typed(models):
    jm, tm, _ = models
    outs = []
    for eng, target in zip(engines(jm, tm), engines(
            jm, tm, **_rel(max_queue_depth=1))):
        eng.submit([4, 5, 6], 2)
        target.submit([1, 2, 3], 2)
        eng.fail("test")
        (seq,) = eng.recover_inflight()
        target.adopt(seq)
        outs.append((seq.state.value, type(seq.error).__name__,
                     target.scheduler.total_shed, seq.trace_id))
    assert outs[0] == outs[1] == ("shed", "QueueFullError", 1, 0)


def test_device_fault_fails_the_engine(models):
    """A fault inside a prefill fails the engine; the sequences admitted
    that round are harvested with the rest and finish elsewhere."""
    jm, tm, _ = models
    _, eng = engines(jm, tm)
    rids = [eng.submit(p, 3) for p in ([1, 2, 3], [4, 5, 6, 7])]

    def boom(*a):
        raise RuntimeError("device fault")

    eng.runner.prefill = boom
    with pytest.raises(EngineFailedError, match="device fault"):
        eng.admit_and_prefill(0.0)
    assert eng.failed
    harvested = eng.recover_inflight()
    assert [s.req_id for s in harvested] == rids
    _, target = engines(jm, tm)
    for s in harvested:
        target.adopt(s)
    while not target.idle():
        target.tick(1.0)
    assert all(len(s.generated) == 3 for s in harvested)


# ------------------------------------------------------------- hot swap
def _scaled_state(state, scale):
    return {k: (v * scale).astype(v.dtype) if v.dtype.kind == "f" else v
            for k, v in state.items()}


def _jax_model_with(state):
    from paddle2_tpu.models.gpt import GPTForCausalLM as JaxGPT
    from paddle2_tpu.models.gpt import gpt_tiny as jax_tiny
    from torch_serving_twins import MAX_POS
    jm = JaxGPT(jax_tiny(use_scan=False, max_position_embeddings=MAX_POS))
    jm.set_state_dict({k: v for k, v in state.items()})
    return jm


def test_hot_swap_changes_tokens_and_rollback_restores(models):
    """Swap to weights x 4, serve, roll back, serve: each phase equals
    the JAX engine doing the same, and the rollback restores the
    original tokens and bytes."""
    jm, _, state = models
    tm = port_model(state)
    new_state = _scaled_state(state, 4.0)
    jnew, tnew = _jax_model_with(new_state), port_model(new_state)
    jeng, teng = engines(jm, tm)
    before = [t.clone() for t in teng.runner.weights()]
    p = plain_trace(tm.cfg.vocab_size, 1, seed=41)[0]["prompt"]
    seen = []
    for eng, new in ((jeng, jnew), (teng, tnew)):
        r0 = eng.submit(p, 4)
        while not eng.idle():
            eng.tick(0.0)
        prev = eng.swap_weights(new)
        r1 = eng.submit(p, 4)
        while not eng.idle():
            eng.tick(1.0)
        eng.swap_weights(prev)
        r2 = eng.submit(p, 4)
        while not eng.idle():
            eng.tick(2.0)
        seen.append([eng.sequence(r).generated for r in (r0, r1, r2)])
    assert seen[0] == seen[1]
    base, swapped, back = seen[1]
    assert swapped != base and back == base
    assert all(torch.equal(a, b) for a, b in
               zip(teng.runner.weights(), before))
    assert teng.hot_swaps == 2


def test_hot_swap_mismatch_is_atomic_typed(models):
    _, _, state = models
    tm = port_model(state)
    _, eng = engines(models[0], tm)
    good = [t.clone() for t in eng.runner.weights()]
    with pytest.raises(WeightSwapError):
        eng.swap_weights(good[:-1])
    bad = [t * 2 for t in good]
    bad[-1] = torch.zeros(3, 3)
    with pytest.raises(WeightSwapError):
        eng.swap_weights(bad)
    bad[-1] = good[-1].to(torch.float64)
    with pytest.raises(WeightSwapError):
        eng.swap_weights(bad)
    assert all(torch.equal(a, b) for a, b in
               zip(eng.runner.weights(), good))      # nothing applied
    with pytest.raises(WeightSwapError):
        eng.swap_weights(port_model(state).to(torch.bfloat16))


def _controller_run(models, make_ctl, n=3, fail_idx=None):
    """Stage a controller over ``n`` engines (one model each); the
    controller's state, staged list and each engine's weights after."""
    jm, _, state = models
    new_state = _scaled_state(state, 1.5)
    out = []
    for side in ("jax", "port"):
        engs = []
        for _ in range(n):
            if side == "jax":
                engs.append(engines(_jax_model_with(state),
                                    port_model(state))[0])
            else:
                engs.append(engines(jm, port_model(state))[1])
        if fail_idx is not None:
            engs[fail_idx].fail("test")
        new = (_jax_model_with(new_state) if side == "jax"
               else port_model(new_state))
        ctl = make_ctl(side, engs, new)
        trail = []
        while True:
            i = ctl.stage_next(now=1.0)
            trail.append((i, ctl.state))
            if i is None or ctl.state == "rolled_back":
                break
        out.append((trail, list(ctl.staged), ctl.state))
    return out


def test_hot_swap_controller_stage_commit_rollback(models):
    def make(side, engs, new):
        return (JaxHotSwap if side == "jax" else HotSwapController)(
            engs, new)
    (jax_run, port_run) = _controller_run(models, make, fail_idx=1)
    assert jax_run == port_run
    assert port_run[2] == "committed" and port_run[1] == [0, 2]


def test_hot_swap_controller_canary_rolls_back(models):
    def make(side, engs, new):
        return (JaxHotSwap if side == "jax" else HotSwapController)(
            engs, new, verify=lambda e: False)
    jax_run, port_run = _controller_run(models, make, n=2)
    assert jax_run == port_run and port_run[2] == "rolled_back"
    # the canary's weights are back
    _, _, state = models
    eng = engines(models[0], port_model(state))[1]
    before = [t.clone() for t in eng.runner.weights()]
    ctl = HotSwapController([eng], port_model(_scaled_state(state, 1.5)),
                            verify=lambda e: False)
    assert ctl.stage_next() == 0 and ctl.state == "rolled_back"
    assert all(torch.equal(a, b) for a, b in
               zip(eng.runner.weights(), before))
    assert ctl.rollback() == [0]


def test_hot_swap_controller_refuses_a_shared_model(models):
    """Engines on one model object would all take the first stage's
    in-place swap: the controller refuses them and swaps nothing."""
    _, _, state = models
    tm = port_model(state)
    a, b = engines(models[0], tm)[1], engines(models[0], tm)[1]
    before = [t.clone() for t in tm.parameters()]
    with pytest.raises(ValueError, match="one model object"):
        HotSwapController([a, b], port_model(_scaled_state(state, 1.5)))
    assert all(torch.equal(x, y) for x, y in zip(tm.parameters(), before))
    other = engines(models[0], port_model(state))[1]
    assert HotSwapController([a, other], [0]).state == "pending"


def test_hot_swap_all_dead_fleet_never_commits(models):
    _, _, state = models
    eng = engines(models[0], port_model(state))[1]
    eng.fail("test")
    ctl = HotSwapController([eng], [0])
    assert ctl.stage_next(now=0.0) is None
    assert ctl.state != "committed" and ctl.staged == []
    assert ctl.rollback(now=0.0) == []
