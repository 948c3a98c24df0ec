"""The cluster design of the port's paged decode kernel
(paddle2_tpu_torch/serving/csrc/paged_decode.cu), checked on the CPU.

There is no card here, so the kernel itself runs only in chip_smoke.py.
These tests hold what surrounds it:

- a host model of its plan and its index arithmetic (``cluster_plan``,
  each block's chunk of pages, the tiles of its ring): every live key of
  every sequence is read by exactly one block, once for K and once for
  V; a cluster has at most 16 blocks; a block's shared memory fits the
  H100's 232,448 bytes; the plan depends on the table's width alone;
- a plain model of its arithmetic (per-block max, the cluster's max,
  per-block sums added in rank order, p rounded, per-block p.V added in
  rank order) against the port's plain versions (f32 1e-6: summation
  order only; bf16 2e-2, the JAX tests' bf16 tolerance) and against the
  JAX package's ``paged_attention_decode`` with its Pallas bodies in
  interpret mode, on the same numpy inputs (at
  tests/test_torch_paged_attention.py's TOL);
- that both routes reach their C entries, with arguments that do not
  depend on the context lengths, through a stand-in library; and that
  an error the C entry reports raises.
"""

import contextlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle2_tpu.serving.paged_attention import (
    paged_attention_decode as jax_decode)
from paddle2_tpu_torch.kernels import _build
from paddle2_tpu_torch.serving import paged_attention as pa

TOL = {"float32": 1e-5, "bfloat16": 2e-2}      # against the JAX package
PLAIN_TOL = {"float32": 1e-6, "bfloat16": 2e-2}  # against the plain versions

# csrc/paged_decode.cu: threads a block, a tile's bytes
NT, TILE_BYTES = 128, 8192


# ------------------------------------------------------------ host model
def block_chunks(ctx, P, bs, range_pages):
    """The kernel's live blocks for one sequence of context ``ctx`` and a
    table of ``P`` pages: ``(range, rank, first key, keys)`` for every
    block of every range's cluster that does not exit at once
    (paged_decode_cluster_kernel's prologue: rank r < CL, the ranks whose
    chunk starts below the context, and rank 0). A block that exits must
    have no key."""
    C, chunk = pa.cluster_plan(range_pages, bs)
    ranges = -(-P // range_pages)
    ctx = min(ctx, P * bs)
    out = []
    for sp in range(ranges):
        range_lo = sp * range_pages
        live_pages = min(range_pages, -(-ctx // bs) - range_lo)
        CL = max(1, min(C, -(-live_pages // chunk)))
        for r in range(C):
            page_lo = range_lo + r * chunk
            page_hi = min(page_lo + chunk, range_lo + range_pages, P)
            t0 = page_lo * bs
            n = max(0, min(ctx, page_hi * bs) - t0)
            if r >= CL:
                assert n == 0
                continue
            assert n > 0 or r == 0
            out.append((sp, r, t0, n))
    return out


def tile_keys(n, D, size):
    """The chunk keys each tile's copies read (the kernel's ``issue``):
    tile i covers keys ``i*TK ..``, copy c reads key ``c // LPK``."""
    row = D * size
    tk, lpk = TILE_BYTES // row, row // 16
    nk = -(-n // tk)
    seen = []
    for i in range(nk):
        for c in range(tk * lpk):
            j = i * tk + c // lpk
            if j < n and c % lpk == 0:
                seen.append(j)
    return seen


PLAN_CASES = [(P, bs) for bs in (8, 16, 64) for P in
              (1, 2, 3, 7, 8, 9, 16, 17, 65, 128, 129, 256, 1024, 2048)]


@pytest.mark.parametrize("P,bs", PLAN_CASES)
def test_every_live_key_is_read_by_one_block(P, bs):
    """On both routes (the whole table, and splits of 1, 8 and 48 pages)
    the blocks' key ranges tile [0, ctx) exactly, every block's keys lie
    in its range's pages, and a cluster has at most 16 blocks."""
    rng = np.random.default_rng(P * 100 + bs)
    ctxs = sorted({0, 1, bs - 1, bs, bs + 1, P * bs - 1, P * bs,
                   P * bs + 5, int(rng.integers(1, P * bs + 1))})
    for range_pages in sorted({P, 1, min(8, P), min(48, P)}):
        C, chunk = pa.cluster_plan(range_pages, bs)
        assert 1 <= C <= pa.MAX_CLUSTER and C & (C - 1) == 0
        assert C * chunk >= range_pages
        for ctx in ctxs:
            hits = np.zeros(P * bs, np.int64)
            for sp, r, t0, n in block_chunks(ctx, P, bs, range_pages):
                assert n >= 0 and r < C
                if n:
                    assert t0 % bs == 0
                    assert sp * range_pages * bs <= t0
                    assert t0 + n <= (sp + 1) * range_pages * bs
                    hits[t0:t0 + n] += 1
            live = min(ctx, P * bs)
            assert np.all(hits[:live] == 1) and np.all(hits[live:] == 0)


@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("size", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("n", [0, 1, 7, 8, 17, 128, 129, 1000])
def test_the_ring_reads_each_key_once(D, size, n):
    """A block's tiles of 8 KB read each of its n keys once (in each of
    the K and the V pass); the score rounds and the p.V groups cover a
    tile: four rounds of 4 warps, NT / D key groups."""
    assert tile_keys(n, D, size) == list(range(n))
    row = D * size
    tk, lpk = TILE_BYTES // row, row // 16
    kpw = 32 // lpk
    assert tk == 4 * 4 * kpw and tk % (NT // D) == 0


@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("bs", [8, 16, 64])
def test_plan_fits_the_h100_and_ignores_the_contexts(D, bs):
    """Whenever the dispatcher sends a table to a route, its blocks fit
    232,448 bytes of shared memory; the plan and the smem arithmetic
    take only host ints (the table's width), and the last width the
    global route takes is followed by one it refuses."""
    for P in (1, 8, 128, 1024, 4096, 50544, 50545, 100_000):
        C, chunk = pa.cluster_plan(P, bs)
        smem = pa.decode_scratch_smem_bytes(chunk * bs, D, bs)
        assert pa.fits_single_softmax(P, bs, D) == (smem <= 232448)
        if not pa.fits_single_softmax(P, bs, D):
            pps = pa.auto_pages_per_split(P, bs, D)
            _, chunk = pa.cluster_plan(pps, bs)
            assert pa.decode_scratch_smem_bytes(chunk * bs, D, bs) \
                <= pa.SMEM_BYTES
    widest = max(P for P in range(1, 200_000, 97)
                 if pa.fits_single_softmax(P, bs, D))
    assert pa.cluster_plan(widest, bs)[0] == 16


def test_plan_values():
    """The smoke's shapes: 128 pages of 16 (2,048 keys) take a cluster
    of 16 blocks of 8 pages; a split of 8 pages one block; 65 pages (the
    engine's widest bucket) 8 blocks of 9 pages."""
    assert pa.cluster_plan(128, 16) == (16, 8)
    assert pa.cluster_plan(8, 16) == (1, 8)
    assert pa.cluster_plan(65, 16) == (8, 9)
    assert pa.cluster_plan(1024, 16) == (16, 64)
    assert pa.cluster_plan(1, 16) == (1, 1)


# ------------------------------------------------------ arithmetic model
def cluster_model(q, k_pool, v_pool, tables, ctx_lens, scale, pps=None):
    """The kernel's arithmetic in plain torch: per block (the plan's
    chunks) the rounded scores and their max; the cluster's max M; per
    block the sum of exp(s - M); the sums added in rank order (L); p =
    round(e / L) on the global route, round(e) on the split route; per
    block p.V in f32, the blocks' o added in rank order. Returns the
    global output ``[B, 1, H, D]`` or the split partials ``(o, m, l)``."""
    B, _, H, D = q.shape
    bs = k_pool.shape[1]
    P = tables.shape[1]
    dt = q.dtype
    rp = P if pps is None else pps
    ranges = -(-P // rp)
    scores = pa._dense_scores(q, pa.gathered_dense_kv(k_pool, tables),
                              scale)                       # [B, H, S]
    vd = pa.gathered_dense_kv(v_pool, tables).float()      # [B, S, H, D]
    out = torch.zeros(B, H, D)
    o_parts = torch.zeros(B, H, ranges, D)
    m_out = torch.full((B, H, ranges), float("-inf"))
    l_out = torch.zeros(B, H, ranges)
    for b in range(B):
        blocks = block_chunks(int(ctx_lens[b]), P, bs, rp)
        for sp in range(ranges):
            mine = [(t0, n) for s_, _, t0, n in blocks if s_ == sp]
            M = torch.full((H,), float("-inf"))
            for t0, n in mine:
                if n:
                    M = torch.maximum(M, scores[b, :, t0:t0 + n].amax(-1))
            es = [torch.exp(scores[b, :, t0:t0 + n] - M[:, None])
                  for t0, n in mine]
            L = torch.zeros(H)
            for e in es:
                L = L + e.sum(-1)
            o = torch.zeros(H, D)
            for (t0, n), e in zip(mine, es):
                p = (e / L[:, None]) if pps is None else e
                p = p.to(dt).float()
                o = o + torch.einsum("hs,shd->hd", p, vd[b, t0:t0 + n])
            if pps is None:
                out[b] = o
            else:
                o_parts[b, :, sp], m_out[b, :, sp], l_out[b, :, sp] = o, M, L
    if pps is None:
        return out.to(dt)[:, None]
    return o_parts, m_out, l_out


def _setup(rng, bs, ctx_lens, H, D):
    """Pools with x7 garbage in every stale slot, shuffled tables of
    width ceil(max(ctx) / bs) (so some rows have dead splits)."""
    B = len(ctx_lens)
    pages = [max(1, -(-c // bs)) for c in ctx_lens]
    P = max(pages)
    nb = sum(pages) + 1
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((B, P), np.int32)
    kp = (rng.normal(size=(nb, bs, H, D)) * 7).astype(np.float32)
    vp = (rng.normal(size=(nb, bs, H, D)) * 7).astype(np.float32)
    used = 0
    for b, c in enumerate(ctx_lens):
        blks = perm[used:used + pages[b]]
        used += pages[b]
        tables[b, :pages[b]] = blks
        for i, blk in enumerate(blks):
            hi = min(bs, c - i * bs)
            if hi > 0:
                kp[blk, :hi] = rng.normal(size=(hi, H, D))
                vp[blk, :hi] = rng.normal(size=(hi, H, D))
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    return q, kp, vp, tables, np.asarray(ctx_lens, np.int32)


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = (want.float().numpy() if isinstance(want, torch.Tensor)
            else np.asarray(want, np.float32))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


ARITH_CASES = [(dt, bs, D, split) for dt in ("float32", "bfloat16")
               for bs in (8, 16) for D in (16, 64, 128)
               for split in (False, True)]


@pytest.mark.parametrize("dtype,bs,D,split", ARITH_CASES,
                         ids=[f"{dt[:4]}-bs{bs}-D{D}-{'split' if s else 'global'}"
                              for dt, bs, D, s in ARITH_CASES])
def test_cluster_arithmetic_matches_plain_and_pallas(dtype, bs, D, split):
    """Contexts 1, 17, a page edge (4 pages) and 2,048 in one batch: the
    global route's table is 2,048 keys wide (a cluster of 16 blocks); the
    split route's splits are 768 keys (4 blocks), the last one partial,
    and the short rows' later splits dead ((-inf, 0, 0))."""
    rng = np.random.default_rng(bs * 1000 + D)
    q, kp, vp, tables, ctx = _setup(rng, bs, [1, 17, 4 * bs, 2048], 2, D)
    td = getattr(torch, dtype)
    tx = (torch.from_numpy(q).to(td), torch.from_numpy(kp).to(td),
          torch.from_numpy(vp).to(td), torch.from_numpy(tables),
          torch.from_numpy(ctx))
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jx = (jnp.asarray(q, jd), jnp.asarray(kp, jd), jnp.asarray(vp, jd),
          jnp.asarray(tables), jnp.asarray(ctx))
    scale = 1.0 / D ** 0.5
    P = tables.shape[1]
    if not split:
        assert pa.cluster_plan(P, bs)[0] == 16
        got = cluster_model(*tx, scale)
        _close(got, pa.paged_attention_reference(*tx, scale=scale),
               PLAIN_TOL[dtype])
        _close(got, jax_decode(*jx, interpret=True), TOL[dtype])
        return
    pps = 768 // bs
    assert pa.cluster_plan(pps, bs)[0] == 4 and P % pps
    o, m, l = cluster_model(*tx, scale, pps=pps)
    ro, rm, rl = pa._split_partials_reference(*tx, scale, pps)
    assert torch.equal(m, rm)       # the same rounded scores' max
    _close(l, rl, PLAIN_TOL["float32"] * 10)   # sums of up to 768 terms
    _close(o, ro, PLAIN_TOL[dtype] * (10 if dtype == "float32" else 1))
    dead = m == float("-inf")
    assert dead[0].any() and torch.all(l[dead] == 0)
    assert torch.all(o[dead] == 0)
    got = pa._merge_splits(o, m, l, td)[:, None]
    _close(got, pa.paged_attention_split_reference(
        *tx, scale=scale, pages_per_split=pps), PLAIN_TOL[dtype])
    _close(got, jax_decode(*jx, interpret=True, pages_per_split=pps),
           TOL[dtype])


def test_zero_context_gives_zeros():
    """A row of context 0 (every block dead) comes out as zeros on the
    global route and as (-inf, 0, 0) partials on the split route."""
    rng = np.random.default_rng(7)
    q, kp, vp, tables, ctx = _setup(rng, 16, [0, 40], 2, 16)
    tx = tuple(torch.from_numpy(a) for a in (q, kp, vp, tables, ctx))
    assert torch.all(cluster_model(*tx, 0.25)[0] == 0)
    o, m, l = cluster_model(*tx, 0.25, pps=1)
    assert torch.all(m[0] == float("-inf")) and torch.all(l[0] == 0)
    assert torch.all(o[0] == 0)


# ---------------------------------------------- the C entries, stand-in
class _StandInLibrary:
    """Records the C entries' arguments in place of the built library;
    returns ``err`` from each."""

    def __init__(self, err=0):
        self.calls, self.err = [], err

    def error_string(self, err):
        return b"stand-in launch failure"

    def __getattr__(self, entry):
        return lambda *args: self.calls.append((entry, args)) or self.err


@pytest.fixture
def card(monkeypatch):
    """The wrappers told their tensors are on the card; a stand-in
    library in place of the built one; the plain versions must not
    run."""
    lib = _StandInLibrary()
    monkeypatch.setattr(_build, "on_card", lambda what, *t: True)
    monkeypatch.setattr(_build, "library", lambda name, sigs: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=None))
    for name in ("paged_attention_reference", "_split_partials_reference"):
        monkeypatch.setattr(pa, name,
                            lambda *a, **k: pytest.fail("plain version ran"))
    return lib


def _inputs(ctx, dtype=torch.bfloat16, bs=16, P=128, H=4, D=128):
    q = torch.zeros(len(ctx), 1, H, D, dtype=dtype)
    pool = torch.zeros(P * len(ctx) + 1, bs, H, D, dtype=dtype)
    tables = torch.arange(1, 1 + P * len(ctx),
                          dtype=torch.int32).reshape(len(ctx), P)
    return q, pool, pool.clone(), tables, torch.tensor(ctx,
                                                       dtype=torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_both_routes_reach_their_c_entries(card, dtype):
    """The dispatcher sends a 128-page table to ``paged_decode`` (global)
    and, with ``pages_per_split=8``, to ``paged_decode_split`` with 16
    splits; each call counts one launch, and the scalar arguments are
    the table's (B, H, D, bs, P[, pps, splits], dtype, scale), the same
    for other context lengths."""
    lib = card
    for ctx in ([2048, 17], [1, 1], [999, 2048]):
        args = _inputs(ctx, dtype)
        g0 = pa.paged_decode.launches
        s0 = pa.paged_decode_split_partials.launches
        out = pa.paged_attention_decode(*args)
        assert out.shape == args[0].shape and out.dtype == dtype
        assert pa.paged_decode.launches == g0 + 1
        o, m, l = pa.paged_decode_split_partials(*args, scale=0.5,
                                                 pages_per_split=8)
        assert o.shape == (2, 4, 16, 128) and m.shape == l.shape == (2, 4, 16)
        assert pa.paged_decode_split_partials.launches == s0 + 1
    code = 0 if dtype == torch.float32 else 1
    scalars = set()
    for entry, a in lib.calls:
        if entry == "paged_decode":
            scalars.add((entry,) + a[6:13])
            assert a[6:12] == (2, 4, 128, 16, 128, code)
            assert a[12] == pytest.approx(128 ** -0.5)
        else:
            assert entry == "paged_decode_split"
            scalars.add((entry,) + a[8:17])
            assert a[8:16] == (2, 4, 128, 16, 128, 8, 16, code)
            assert a[16] == 0.5
    assert len(lib.calls) == 6 and len(scalars) == 2


def test_the_c_entries_get_the_tensors_pointers(card):
    lib = card
    q, kp, vp, tables, ctx = _inputs([40, 7])
    out = pa.paged_decode(q, kp, vp, tables, ctx, scale=0.25)
    o, m, l = pa.paged_decode_split_partials(q, kp, vp, tables, ctx,
                                             scale=0.25, pages_per_split=3)
    (e1, a1), (e2, a2) = lib.calls
    ptrs = tuple(t.data_ptr() for t in (q, kp, vp, tables, ctx))
    assert a1[:6] == ptrs + (out.data_ptr(),)
    assert a2[:8] == ptrs + (o.data_ptr(), m.data_ptr(), l.data_ptr())
    assert a2[13:15] == (3, 43)          # pps, ceil(128 / 3) splits


def test_a_launch_error_raises(card):
    card.err = 1
    args = _inputs([5, 6])
    with pytest.raises(RuntimeError, match="paged_decode: CUDA error 1"):
        pa.paged_attention_decode(*args)
    with pytest.raises(RuntimeError, match="paged_decode_split: CUDA error"):
        pa.paged_attention_decode(*args, pages_per_split=4)


def test_the_wrapper_refuses_what_the_kernel_does_not_take(card):
    """An unaligned pool, or a table whose chunks exceed a block's shared
    memory on the global route, raise before any launch."""
    q, kp, vp, tables, ctx = _inputs([5, 6], torch.float32, P=4)
    buf = torch.zeros(kp.numel() + 4)
    off = buf[1:1 + kp.numel()].view(kp.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        pa.paged_decode(q, off, vp, tables, ctx, scale=1.0)
    wide = torch.zeros(2, 50545, dtype=torch.int32)
    with pytest.raises(ValueError, match="exceed a cluster"):
        pa.paged_decode(q, kp, vp, wide, ctx, scale=1.0)
    assert card.calls == []
