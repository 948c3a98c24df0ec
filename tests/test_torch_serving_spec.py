"""The port's speculative decoding (paddle2_tpu_torch.serving.spec and
the engine's verify rows), held against the JAX package on the CPU:
``ngram_draft`` and ``accept_drafts`` against the JAX functions under
hypothesis, and the engine with ``spec`` against the JAX engine with
``spec``, round by round (tokens, tables, refcounts, accepted and
rejected drafts, decode steps, decode buckets). The engine cases mirror
tests/test_serving_throughput.py."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from paddle2_tpu.serving import SpeculativeConfig as JaxSpec
from paddle2_tpu.serving import accept_drafts as jax_accept
from paddle2_tpu.serving import ngram_draft as jax_draft
from paddle2_tpu_torch.serving import (SpeculativeConfig, accept_drafts,
                                       ngram_draft)

from torch_serving_twins import (engines, generated, lockstep, plain_trace,
                                 shared_trace, twin_models)


@pytest.fixture(scope="module")
def models():
    return twin_models()


# -------------------------------------------------- drafting, acceptance
@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 5), max_size=30), st.integers(1, 4),
       st.integers(0, 5))
def test_ngram_draft_matches_jax(tokens, ngram, k):
    assert ngram_draft(tokens, ngram, k) == jax_draft(tokens, ngram, k)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 3), max_size=6), st.data(),
       st.integers(-1, 8))
def test_accept_drafts_matches_jax(drafts, data, budget):
    outs = data.draw(st.lists(st.integers(0, 3), min_size=len(drafts) + 1,
                              max_size=len(drafts) + 1))
    try:
        want = jax_accept(drafts, outs, budget)
    except ValueError:
        with pytest.raises(ValueError):
            accept_drafts(drafts, outs, budget)
        return
    assert accept_drafts(drafts, outs, budget) == want


def test_ngram_draft_and_accept():
    assert ngram_draft([5, 6, 7, 8, 5, 6], 2, 3) == [7, 8, 5]
    assert ngram_draft([1, 2], 2, 3) == []
    assert ngram_draft([1, 2, 3, 4], 2, 3) == []
    assert accept_drafts([7, 8, 5], [7, 8, 9, 4], budget=10) == ([7, 8], 9)
    assert accept_drafts([7, 8, 5], [7, 8, 5, 4], budget=2) == ([7], 8)
    assert accept_drafts([], [3], budget=5) == ([], 3)
    for bad in (dict(num_draft_tokens=0), dict(ngram=0)):
        with pytest.raises(ValueError):
            SpeculativeConfig(**bad)


# -------------------------------------------------------------- the engine
def _spec(k=3, ngram=2, draft_fn=None):
    return dict(spec=SpeculativeConfig(num_draft_tokens=k, ngram=ngram,
                                       draft_fn=draft_fn),
                jax_spec=JaxSpec(num_draft_tokens=k, ngram=ngram,
                                 draft_fn=draft_fn))


def _repetitive_trace(vocab, n=4, seed=5):
    """Prompts that repeat a short motif, so n-gram drafts are found
    and some are accepted."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        motif = rng.integers(0, vocab, size=5).tolist()
        out.append(dict(prompt=(motif * 5)[:20 + 2 * i],
                        max_new_tokens=12 + i))
    return out


@pytest.mark.parametrize("trace_kind", ["plain", "repetitive"])
def test_spec_engine_matches_jax_and_the_plain_stream(models, trace_kind):
    """With n-gram drafts: tokens, tables, refcounts, accepted and
    rejected counts and decode steps equal the JAX engine's after every
    round; the tokens equal the non-speculative run in no more decode
    steps; the allocator drains clean."""
    jm, tm, _ = models
    vocab = tm.cfg.vocab_size
    trace = (plain_trace(vocab, 6) if trace_kind == "plain"
             else _repetitive_trace(vocab))
    jeng, teng = engines(jm, tm, **_spec())
    _, rids = lockstep(jeng, teng, trace)
    joff, off = engines(jm, tm)
    _, off_rids = lockstep(joff, off, trace)
    assert generated(teng, rids) == generated(off, off_rids)
    assert teng.spec_accepted + teng.spec_rejected > 0
    assert (teng.spec_accepted, teng.spec_rejected) == \
        (jeng.spec_accepted, jeng.spec_rejected)
    assert teng.decode_steps <= off.decode_steps
    if trace_kind == "repetitive":
        assert teng.spec_accepted > 0
        assert teng.decode_steps < off.decode_steps
    assert teng.allocator.free_count == teng.allocator.num_blocks - 1


def test_spec_oracle_and_wrong_drafts(models):
    """An oracle drafter built from the plain run's tokens: every draft
    accepted and fewer steps; an always-wrong drafter: every draft
    rejected and the tokens unchanged. Both equal the JAX engine."""
    jm, tm, _ = models
    trace = plain_trace(tm.cfg.vocab_size, 4, seed=9)
    joff, off = engines(jm, tm)
    _, off_rids = lockstep(joff, off, trace)
    truth = generated(off, off_rids)

    def oracle(seq):
        done = len(seq.generated)
        return truth[seq.req_id][done:done + 3]

    def wrong(seq):
        t = truth[seq.req_id]
        done = len(seq.generated)
        nxt = t[done] if done < len(t) else 0
        return [(int(nxt) + 1) % tm.cfg.vocab_size]

    jeng, teng = engines(jm, tm, **_spec(draft_fn=oracle))
    _, rids = lockstep(jeng, teng, trace)
    assert generated(teng, rids) == truth
    assert teng.spec_rejected == 0 and teng.spec_accepted > 0
    assert teng.decode_steps < off.decode_steps
    jeng, teng = engines(jm, tm, **_spec(k=1, draft_fn=wrong))
    _, rids = lockstep(jeng, teng, trace)
    assert generated(teng, rids) == truth
    assert teng.spec_accepted == 0 and teng.spec_rejected > 0


def test_spec_bucket_census(models):
    """The batch ladder widens to max_batch * (k + 1); the decode
    buckets the port ran equal the JAX engine's compiled programs and
    stay inside the grid."""
    jm, tm, _ = models
    jeng, teng = engines(jm, tm, **_spec())
    lockstep(jeng, teng, _repetitive_trace(tm.cfg.vocab_size))
    cfg = teng.scheduler.config
    assert cfg.batch_buckets == jeng.scheduler.config.batch_buckets
    assert cfg.batch_buckets[-1] == 4 * (1 + 3)
    assert teng.runner._decode_buckets == set(jeng.runner._decode_programs)
    assert any(b > 4 for b, _ in teng.runner._decode_buckets)
    assert teng.num_decode_programs <= teng.program_budget


def test_custom_buckets_plus_spec_fail_fast(models):
    jm, tm, _ = models
    with pytest.raises(ValueError, match="verify rows"):
        engines(jm, tm, batch_buckets=(1, 2, 4), **_spec())
    _, teng = engines(jm, tm, batch_buckets=(1, 4, 16), **_spec())
    assert teng.scheduler.config.batch_buckets[-1] == 16


def test_verify_rows_share_their_table(models):
    """One verify step: a sequence's k + 1 rows carry its table and the
    positions p0 .. p0 + k; the reserved surplus block goes back."""
    jm, tm, _ = models
    _, teng = engines(jm, tm, **_spec(draft_fn=lambda s: [1, 2, 3]))
    seen = {}
    decode = teng.runner.decode

    def spy(cache, ids, positions, tables):
        seen.update(ids=ids.copy(), positions=positions.copy(),
                    tables=tables.copy())
        return decode(cache, ids, positions, tables)

    teng.runner.decode = spy
    rid = teng.submit(list(range(1, 16)), 8)
    teng.admit_and_prefill(0.0)
    seq = teng.sequence(rid)
    p0 = seq.num_cached
    assert p0 == 15 and len(seq.table.blocks) == 1
    teng.decode_once(0.0)
    assert list(seen["positions"][:4]) == [15, 16, 17, 18]
    assert list(seen["ids"][1:4, 0]) == [1, 2, 3]
    assert (seen["tables"][:4] == seen["tables"][0]).all()
    assert seen["tables"][0, 1] != 0          # the reserved second block
    n = seq.table.num_tokens
    assert len(seq.table.blocks) == -(-n // 16)   # surplus truncated


def test_prefix_and_spec_compose(models):
    jm, tm, _ = models
    trace = shared_trace(tm.cfg.vocab_size, n=5, gen=8)
    jeng, teng = engines(jm, tm, enable_prefix_cache=True, **_spec())
    _, rids = lockstep(jeng, teng, trace, arrive_every=1)
    joff, off = engines(jm, tm)
    _, off_rids = lockstep(joff, off, trace, arrive_every=1)
    assert generated(teng, rids) == generated(off, off_rids)
    assert teng.prefix_cache.hits > 0
