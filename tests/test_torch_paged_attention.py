"""The port's paged-attention decode (paddle2_tpu_torch.serving.
paged_attention) held against the JAX package's Pallas decode bodies,
run in interpret mode, and against its dense split reference.

On the CPU the port's wrappers run their plain versions; chip_smoke.py
holds the CUDA kernels against the same plain versions on the card.
Tolerances: f32 1e-5 (summation order only); bf16 2e-2 (the JAX tests'
bf16 tolerance: scores and probabilities are rounded to bf16 at the
same places, but bf16 dot products round differently across
frameworks). The setup mirrors tests/test_serving.py: fragmented,
shuffled block tables and finite x7 garbage in every stale slot.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle2_tpu.serving.paged_attention import (
    paged_attention_decode as jax_decode,
    paged_attention_split_reference as jax_split_reference)
from paddle2_tpu_torch.serving import (blocks_for_tokens,
                                       paged_attention_decode,
                                       paged_attention_reference,
                                       paged_attention_split_reference,
                                       paged_decode,
                                       paged_decode_split_partials)
from paddle2_tpu_torch.serving.paged_attention import (
    SMEM_BYTES, _merge_splits, auto_pages_per_split,
    decode_scratch_smem_bytes, fits_single_softmax)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _fragmented_setup(rng, bs, ctx_lens, H, D, num_blocks=32):
    """Pools + non-contiguous (shuffled) block tables, with finite stale
    garbage in every unused slot to prove masking."""
    B = len(ctx_lens)
    n_pages = max(blocks_for_tokens(c, bs) for c in ctx_lens)
    perm = rng.permutation(np.arange(1, num_blocks))
    tables = np.zeros((B, n_pages), np.int32)
    kp = (rng.normal(size=(num_blocks, bs, H, D)) * 7).astype(np.float32)
    vp = (rng.normal(size=(num_blocks, bs, H, D)) * 7).astype(np.float32)
    used = 0
    for b, c in enumerate(ctx_lens):
        nb = blocks_for_tokens(c, bs)
        blks = perm[used:used + nb]
        used += nb
        tables[b, :nb] = blks
        ks = rng.normal(size=(c, H, D)).astype(np.float32)
        vs = rng.normal(size=(c, H, D)).astype(np.float32)
        for i, blk in enumerate(blks):
            lo, hi = i * bs, min(c, (i + 1) * bs)
            kp[blk, :hi - lo] = ks[lo:hi]
            vp[blk, :hi - lo] = vs[lo:hi]
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    return q, kp, vp, tables


def _both(arrays, dtype):
    """The same arrays as JAX and as torch inputs of ``dtype``."""
    q, kp, vp, tables, ctx = arrays
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)
    jx = (jnp.asarray(q, jd), jnp.asarray(kp, jd), jnp.asarray(vp, jd),
          jnp.asarray(tables), jnp.asarray(ctx, jnp.int32))
    tx = (torch.from_numpy(q).to(td), torch.from_numpy(kp).to(td),
          torch.from_numpy(vp).to(td), torch.from_numpy(tables),
          torch.from_numpy(np.asarray(ctx, np.int32)))
    return jx, tx


def _close(out, ref, dtype):
    tol = TOL[dtype]
    if isinstance(ref, torch.Tensor):
        ref = ref.float().numpy()
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs", [16, 64])
def test_single_split_matches_pallas_fragmented(bs, dtype):
    rng = np.random.default_rng(0)
    ctx = [24, 5, 72]                               # ragged
    q, kp, vp, tables = _fragmented_setup(rng, bs, ctx, H=2, D=16)
    jx, tx = _both((q, kp, vp, tables, ctx), dtype)
    ref = jax_decode(*jx, interpret=True)
    out = paged_attention_decode(*tx)
    assert out.shape == (3, 1, 2, 16) and out.dtype == tx[0].dtype
    _close(out, ref, dtype)
    assert torch.equal(out, paged_attention_reference(*tx))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs,pps", [(16, 2), (16, 1), (64, 1)])
def test_split_k_matches_pallas_and_split_reference(bs, pps, dtype):
    rng = np.random.default_rng(1)
    ctx = [70, 17, 33]
    q, kp, vp, tables = _fragmented_setup(rng, bs, ctx, H=2, D=16)
    jx, tx = _both((q, kp, vp, tables, ctx), dtype)
    out = paged_attention_decode(*tx, pages_per_split=pps)
    if pps < tables.shape[1]:
        _close(out, jax_decode(*jx, interpret=True, pages_per_split=pps),
               dtype)
    _close(out, jax_split_reference(*jx, pages_per_split=pps), dtype)
    assert torch.equal(out, paged_attention_split_reference(
        *tx, pages_per_split=pps))
    # split-K vs the global softmax: the same function, reassociated
    _close(out, paged_attention_reference(*tx), dtype)


@pytest.mark.parametrize("D", [64, 128])
def test_head_dims_of_the_served_models(D):
    rng = np.random.default_rng(2)
    ctx = [40, 9]
    q, kp, vp, tables = _fragmented_setup(rng, 16, ctx, H=2, D=D)
    jx, tx = _both((q, kp, vp, tables, ctx), "float32")
    _close(paged_attention_decode(*tx), jax_decode(*jx, interpret=True),
           "float32")
    _close(paged_attention_decode(*tx, pages_per_split=1),
           jax_decode(*jx, interpret=True, pages_per_split=1), "float32")


def test_dead_split_emits_neutral_partials():
    """A split wholly past the context emits (-inf, 0, 0) and drops out
    of the merge."""
    rng = np.random.default_rng(3)
    q, kp, vp, tables = _fragmented_setup(rng, 16, [20, 70], H=2, D=16)
    _, tx = _both((q, kp, vp, tables, [20, 70]), "float32")
    o, m, l = paged_decode_split_partials(*tx, scale=0.25,
                                          pages_per_split=2)
    assert m.shape == (2, 2, 3) and o.shape == (2, 2, 3, 16)
    # sequence 0 has 20 keys: split 0 live, splits 1 and 2 dead
    assert torch.all(m[0, :, 1:] == float("-inf"))
    assert torch.all(l[0, :, 1:] == 0) and torch.all(o[0, :, 1:] == 0)
    assert torch.all(torch.isfinite(m[1]))
    merged = _merge_splits(o, m, l, torch.float32)[:, None]
    _close(merged, paged_attention_reference(*tx, scale=0.25).numpy(),
           "float32")


def test_decode_ignores_physical_placement():
    """Same K/V values in two physical layouts -> identical output."""
    rng = np.random.default_rng(4)
    bs, H, D, c = 16, 2, 16, 48
    ks = rng.normal(size=(c, H, D)).astype(np.float32)
    vs = rng.normal(size=(c, H, D)).astype(np.float32)
    q = torch.from_numpy(rng.normal(size=(1, 1, H, D)).astype(np.float32))
    outs = []
    for blocks in ([1, 2, 3], [9, 4, 7]):
        kp = np.zeros((12, bs, H, D), np.float32)
        vp = np.zeros((12, bs, H, D), np.float32)
        for i, blk in enumerate(blocks):
            kp[blk] = ks[i * bs:(i + 1) * bs]
            vp[blk] = vs[i * bs:(i + 1) * bs]
        args = (q, torch.from_numpy(kp), torch.from_numpy(vp),
                torch.tensor([blocks], dtype=torch.int32),
                torch.tensor([c], dtype=torch.int32))
        outs.append((paged_attention_decode(*args),
                     paged_attention_decode(*args, pages_per_split=1)))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_smem_switch_arithmetic():
    """The single/split switch follows the H100's 227 KB per block: a
    cluster of up to 16 blocks shares the table, and a block holds a
    16 KB ring plus 4 * (keys + pages + D + 180) bytes of scores, page ids
    and scratch for its chunk."""
    assert decode_scratch_smem_bytes(128, 128, 16) == \
        16384 + 4 * (128 + 8 + 128 + 180)
    assert fits_single_softmax(128, 16, 128)           # 2048 positions
    # a chunk holds up to 3,159 pages of 16 at D 128; 16 chunks a table
    max_pages = ((SMEM_BYTES - 16384) // 4 - 128 - 180) // 17
    assert max_pages == 3159
    assert fits_single_softmax(16 * max_pages, 16, 128)
    assert not fits_single_softmax(16 * max_pages + 1, 16, 128)
    pps = auto_pages_per_split(65536, 16, 128)        # 1,048,576 keys
    assert fits_single_softmax(pps, 16, 128) and pps < 65536


def test_cpu_wrappers_launch_nothing():
    rng = np.random.default_rng(5)
    q, kp, vp, tables = _fragmented_setup(rng, 16, [20], H=2, D=16)
    _, tx = _both((q, kp, vp, tables, [20]), "float32")
    before = (paged_decode.launches, paged_decode_split_partials.launches)
    paged_attention_decode(*tx)
    paged_attention_decode(*tx, pages_per_split=1)
    assert (paged_decode.launches,
            paged_decode_split_partials.launches) == before


def test_rejects_what_the_kernels_do_not_take():
    q = torch.zeros(1, 1, 2, 16)
    pool = torch.zeros(4, 16, 2, 16)
    ok_t = torch.zeros(1, 1, dtype=torch.int32)
    ok_c = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        paged_attention_decode(q, pool, pool, ok_t.long(), ok_c)
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention_decode(torch.zeros(1, 1, 2, 32),
                               torch.zeros(4, 16, 2, 32),
                               torch.zeros(4, 16, 2, 32), ok_t, ok_c)
    with pytest.raises(ValueError, match="dtypes"):
        paged_attention_decode(q.half(), pool.half(), pool.half(), ok_t,
                               ok_c)
