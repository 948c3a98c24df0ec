"""Shared by the port's serving tests: a JAX gpt_tiny and the port's
gpt_tiny on the same numpy weights, engines built on each from one
configuration, and a lockstep runner that feeds both engines the same
requests and clock and compares their host state after every round."""

import numpy as np
import torch

import paddle2_tpu as paddle
from paddle2_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle2_tpu.models.gpt import gpt_tiny as jax_tiny
from paddle2_tpu.serving import EngineConfig as JaxEngineConfig
from paddle2_tpu.serving import ServingEngine as JaxEngine
from paddle2_tpu_torch.models import (GPTForCausalLM, gpt_state_from_reference,
                                      gpt_tiny)
from paddle2_tpu_torch.serving import EngineConfig, ServingEngine

MAX_POS = 128
ENGINE_KW = dict(block_size=16, num_blocks=48, max_batch=4,
                 prefill_budget_tokens=64, max_model_len=MAX_POS)


def twin_models(seed=0):
    """``(jax_model, port_model, state)``: gpt_tiny (128 positions) with
    the JAX model's seeded weights, ``state`` as numpy arrays."""
    paddle.seed(seed)
    jm = JaxGPT(jax_tiny(use_scan=False, max_position_embeddings=MAX_POS))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = port_model(state)
    return jm, tm, state


def port_model(state, dtype=torch.float32):
    tm = GPTForCausalLM(gpt_tiny(max_position_embeddings=MAX_POS),
                        device="cpu", dtype=dtype)
    tm.load_state_dict({k: v.to(dtype) for k, v in
                        gpt_state_from_reference(state).items()})
    return tm


def engines(jm, tm, **over):
    """One JAX engine and one port engine from the same configuration;
    ``jax_spec``/``jax_reliability`` replace the port's objects for the
    JAX engine (each package has its own classes)."""
    kw = {**ENGINE_KW, **over}
    jax_kw = dict(kw)
    for name in ("spec", "reliability"):
        if f"jax_{name}" in kw:
            jax_kw[name] = jax_kw.pop(f"jax_{name}")
            kw.pop(f"jax_{name}")
    jax_kw = {k: v for k, v in jax_kw.items() if not k.startswith("jax_")}
    return (JaxEngine(jm, config=JaxEngineConfig(**jax_kw)),
            ServingEngine(tm, EngineConfig(**kw), device="cpu"))


def shared_trace(vocab, n=6, sys_len=48, gen=8, seed=3):
    """``n`` requests that share one ``sys_len``-token system prompt,
    each with its own 8- or 16-token tail."""
    rng = np.random.default_rng(seed)
    sys_prompt = rng.integers(0, vocab, size=sys_len).tolist()
    return [dict(prompt=sys_prompt + rng.integers(
        0, vocab, size=8 if i % 2 else 16).tolist(), max_new_tokens=gen)
        for i in range(n)]


def plain_trace(vocab, n, lens=(16, 24), gen=(10, 14), seed=7):
    rng = np.random.default_rng(seed)
    return [dict(prompt=rng.integers(0, vocab, size=lens[i % len(lens)])
                 .tolist(), max_new_tokens=gen[i % len(gen)])
            for i in range(n)]


def host_state(eng):
    """What the two engines must agree on after a round: every
    sequence's state, tokens, table and token count, the allocator's
    refcounts, free list and high water, and the counters."""
    seqs = {rid: (s.state.value, list(s.tokens), list(s.table.blocks),
                  s.table.num_tokens, s.evictions, s.prefix_cached_tokens)
            for rid, s in eng._seqs.items()}
    a = eng.allocator
    pc = eng.prefix_cache
    return dict(
        seqs=seqs, rc=dict(sorted(a._rc.items())), free=list(a._free),
        high_water=a.high_water, total_allocated=a.total_allocated,
        cache=None if pc is None else (pc.hits, pc.misses, pc.evictions,
                                       sorted(pc.held_blocks())),
        spec=(eng.spec_accepted, eng.spec_rejected),
        decode_steps=eng.decode_steps,
        evictions=eng.scheduler.total_evictions,
        waiting=[s.req_id for s in eng.scheduler.waiting],
        running=[s.req_id for s in eng.scheduler.running()])


def lockstep(jeng, teng, trace, arrive_every=0, max_rounds=500,
             on_round=None):
    """Submit ``trace`` to both engines (request ``i`` at round
    ``i * arrive_every``) and run rounds of ``admit_and_prefill`` +
    ``decode_once`` at ``now = round`` until both are idle, asserting
    equal host state after every round. ``on_round(round, jeng, teng)``
    runs after each round's checks. Returns the rounds and the request
    ids."""
    rids = []
    rnd = 0
    pending = list(enumerate(trace))
    while pending or not (jeng.idle() and teng.idle()):
        while pending and pending[0][0] * arrive_every <= rnd:
            _, r = pending.pop(0)
            jr = jeng.submit(r["prompt"], r["max_new_tokens"],
                             arrival_t=float(rnd))
            tr = teng.submit(r["prompt"], r["max_new_tokens"],
                             arrival_t=float(rnd))
            assert jr == tr
            rids.append(tr)
        now = float(rnd)
        ja = jeng.admit_and_prefill(now)
        ta = teng.admit_and_prefill(now)
        assert [i["seq"].req_id for i in ja] == \
            [i["seq"].req_id for i in ta]
        jd = jeng.decode_once(now)
        td = teng.decode_once(now)
        assert (jd is None) == (td is None)
        if td is not None:
            assert jd["bucket"] == td["bucket"]
            assert jd["tokens"] == td["tokens"]
        assert host_state(jeng) == host_state(teng), f"round {rnd}"
        if on_round is not None:
            on_round(rnd, jeng, teng)
        rnd += 1
        assert rnd < max_rounds, "engines did not drain"
    return rnd, rids


def generated(eng, rids):
    return [eng.sequence(r).generated for r in rids]


# ---------------------------------------------------- costs and programs
# One cost table for both packages' runners: the JAX runner prices a
# program by XLA's analysis, the port's by its reckoning from the
# configuration, so a test that compares clocks, tier decisions or
# reports across the packages gives both this table. Every key is
# priced, run or not, as the port's runner prices it.
def prefill_table(padded):
    return {"flops": 1e6 * padded, "bytes accessed": 4e4 * padded}


def decode_table(batch, pages):
    return {"flops": 2e5 * batch + 1e4 * batch * pages,
            "bytes accessed": 2e6 + 1e4 * batch * pages}


def patch_costs(*engs):
    """Point every engine's runner at the shared cost table. The JAX
    runner's own analysis (a compile a key) is skipped; its batch-1
    baseline program is priced from the table by its table's shape, the
    port's by ``decode_cost_of``."""
    for e in engs:
        r = e.runner
        r.prefill_cost = lambda p: prefill_table(int(p))
        r.decode_cost = lambda b: decode_table(*b)
        if hasattr(r, "_cost_of"):           # the JAX runner
            r._cost_of = (lambda fn, args: decode_table(*args[-1].shape)
                          if len(args) == 6 else {})
        else:
            r.decode_cost_of = lambda b, p, bs: decode_table(b, p)
    return engs


class _SharedPrograms(dict):
    """A JAX runner's program cache that draws on a store shared by the
    runners of one model (weights are the programs' arguments, so one
    compiled program serves them all); ``len`` counts the keys this
    runner used, as its own cache would."""

    def __init__(self, store):
        super().__init__()
        self.store = store

    def get(self, key, default=None):
        fn = self.store.get(key)
        if fn is None:
            return default
        dict.__setitem__(self, key, fn)
        return fn

    def __setitem__(self, key, fn):
        self.store[key] = fn
        dict.__setitem__(self, key, fn)


_JAX_PROGRAMS = {}


def share_jax_programs(*engs):
    """Let JAX engines on one model reuse each other's compiled prefill
    and decode programs (each runner would otherwise compile its own)."""
    for e in engs:
        r = e.runner
        key = (id(r.model), e.cache.block_size, r.split_pages, r.interpret)
        dec, pre = _JAX_PROGRAMS.setdefault(key, ({}, {}))
        r._decode_programs = _SharedPrograms(dec)
        r._prefill_programs = _SharedPrograms(pre)
    return engs


def one_thread():
    """For a module-scoped fixture: torch on one thread while a module's
    gpt_tiny engines run (their ops are too small to split, and the
    suite's workers share the cores), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
