"""The fused packed varlen backward (``csrc/flash_varlen_bwd_wgmma.cu``,
``kernels/flash_varlen.py`` ``flash_varlen_bwd_fused``), held on the CPU.

- A host model of the kernel's index arithmetic (128-key blocks walking
  the union of their two ``k_tiles`` entries in query tiles that start
  at the range's first row, the sentinel ids, the transposed mask-skip
  rule, the longest-walk-first block order) lets every live (query,
  key) pair into P exactly once and no other pair.
- Its plain version, which a CPU tensor runs, against the Pallas pair
  (``flash_attention_varlen_packed(..., interpret=True)``'s VJP) at head
  dims 16, 64 and 128: f32 to 1e-4 and bf16 to 2e-2 of max(1, the
  reference's largest magnitude) (f32 sums in another order; P and dS
  rounded to bf16 at different places), with rows that see no key and
  keys no row sees getting exact zeros; and bitwise equal to the split
  pair's plain versions, which it is built from.
- The routes on a stand-in card: a bf16 backward reaches
  ``flash_varlen_bwd_fused_wgmma`` once and nothing else, f32 keeps the
  CUDA-core pair, and a launch error raises.
- The smoke's gate for the kernel on random inputs
  (``chip_smoke.varlen_bwd_stats``: the share of elements off the
  rounded f32 sums) reads 0 for the plain version, one element for one
  flipped step, and far past its limit for a backward without the P/dS
  rounding.

Sizes stay small (T <= 128 for the Pallas side): the interpret-mode
kernels run their grid step by step.
"""

import ast
import contextlib
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle2_tpu.kernels.pallas_flash import \
    flash_attention_varlen_packed as jax_packed
from paddle2_tpu_torch.kernels import _build
from paddle2_tpu_torch.kernels import flash_varlen as fv

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _meta(lens_q, lens_k, causal):
    """Per-row (segment, offset) metadata as the functional layer builds
    it: offsets shifted by ``len_k - len_q`` when causal, else 2**30."""
    lens_q, lens_k = np.asarray(lens_q), np.asarray(lens_k)
    seg_q = np.repeat(np.arange(len(lens_q)), lens_q)
    seg_k = np.repeat(np.arange(len(lens_k)), lens_k)
    off_q = np.concatenate([np.arange(n) for n in lens_q])
    off_k = np.concatenate([np.arange(n) for n in lens_k])
    if causal:
        off_q = off_q + np.repeat(lens_k - lens_q, lens_q)
    else:
        off_q = np.full_like(off_q, 2 ** 30)
    return [a.astype(np.int32) for a in (seg_q, off_q, seg_k, off_k)]


def _live(meta):
    seg_q, off_q, seg_k, off_k = (np.asarray(a, np.int64) for a in meta)
    return (seg_q[:, None] == seg_k[None, :]) & \
        (off_k[None, :] <= off_q[:, None])


# ------------------------------------------------ the kernel's index model

# csrc/flash_varlen_bwd_wgmma.cu: keys a block, query rows a tile by head
# dim, and the sentinel segment ids
_BKEY = 128
_BQ = {16: 128, 64: 128, 128: 64}
_INT_MIN, _INT_MAX = -2 ** 31, 2 ** 31 - 1
_PAST_K, _PAST_Q, _MIXED_K, _MIXED_Q = (_INT_MIN + i for i in range(4))


def _walk(k_tiles, kb, Tk):
    """``walk_range``: the union of key tile ``kb``'s two k_tiles
    entries."""
    lo, hi = k_tiles[2 * kb]
    if 2 * kb + 1 < -(-Tk // fv.TILE):
        lo, hi = min(lo, k_tiles[2 * kb + 1, 0]), max(hi,
                                                      k_tiles[2 * kb + 1, 1])
    return int(lo), int(hi)


def _block_order(k_tiles, Tk, BQ):
    """``varlen_bwd_order_kernel``: block y takes the key tile of rank y,
    longest walk first, ties by tile index."""
    nkb = -(-Tk // _BKEY)
    walks = []
    for kb in range(nkb):
        lo, hi = _walk(k_tiles, kb, Tk)
        walks.append(-(-(hi - lo) // BQ) if hi > lo else 0)
    order = [0] * nkb
    for b in range(nkb):
        rank = sum(w > walks[b] or (w == walks[b] and j < b)
                   for j, w in enumerate(walks))
        order[rank] = b
    return order, walks


def _fused_backward_pairs(meta, BQ):
    """The fused kernel's (query, key) pairs that reach P: for each block
    (in launch order) its query tiles of ``BQ`` rows from the first row
    of its walk, and for each warp of 16 keys and each query tile the
    skip rule, else the per-score check against the sentinel-filled rows.
    A row past the walk (or Tq) takes lse +inf, so P = 0 there. Returns
    the [Tq, Tk] counts, the pairs that fell outside [Tq, Tk], and the
    walks in launch order."""
    seg_q, off_q, seg_k, off_k = (np.asarray(a, np.int64) for a in meta)
    Tq, Tk = len(seg_q), len(seg_k)
    _, k_tiles = fv.tile_ranges(*(torch.as_tensor(a) for a in meta))
    k_tiles = k_tiles.numpy()
    order, walks = _block_order(k_tiles, Tk, BQ)
    seen = np.zeros((Tq, Tk), np.int16)
    outside = 0
    for kb in order:
        k0 = kb * _BKEY
        lo, hi = _walk(k_tiles, kb, Tk)
        n_iter = -(-(hi - lo) // BQ) if hi > lo else 0
        for it in range(n_iter):
            r = lo + it * BQ + np.arange(BQ)
            rin = r < hi
            rseg = np.where(rin, seg_q[np.minimum(r, Tq - 1)], _PAST_Q)
            roff = np.where(rin, off_q[np.minimum(r, Tq - 1)], _INT_MIN)
            tseg = rseg[0] if (rseg == rseg[0]).all() else _MIXED_Q
            for w in range(_BKEY // 16):
                c = k0 + 16 * w + np.arange(16)
                kin = c < Tk
                kseg = np.where(kin, seg_k[np.minimum(c, Tk - 1)], _PAST_K)
                koff = np.where(kin, off_k[np.minimum(c, Tk - 1)], _INT_MAX)
                wseg = kseg[0] if (kseg == kseg[0]).all() else _MIXED_K
                if wseg == tseg and koff.max() <= roff.min():
                    live = np.ones((16, BQ), bool)
                else:
                    live = (kseg[:, None] == rseg[None]) & \
                        (koff[:, None] <= roff[None])
                live &= rin[None]          # lse +inf: P = 0
                cc, rr = np.nonzero(live)
                ok = (r[rr] < Tq) & (c[cc] < Tk)
                outside += int((~ok).sum())
                np.add.at(seen, (r[rr[ok]], c[cc[ok]]), 1)
    return seen, outside, [walks[kb] for kb in order]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("lens", ["equal", "lk_lt_lq"])
@pytest.mark.parametrize("D", [64, 128])
def test_fused_backward_sees_every_live_pair_once(causal, lens, D):
    """The host model of the fused kernel's blocks lets every live
    (query, key) pair into P exactly once and no other pair, at
    sequence lengths 1, 127, 128, 129, 255 and 2048 (and ``len_k <
    len_q``); its blocks launch longest walk first, and the 2048-token
    sequence's first key tile walks all its rows."""
    lens_q = [1, 127, 128, 129, 255, 2048]
    lens_k = lens_q if lens == "equal" else [1, 100, 128, 64, 200, 1000]
    meta = _meta(lens_q, lens_k, causal)
    seen, outside, walks = _fused_backward_pairs(meta, _BQ[D])
    assert outside == 0
    assert seen.max() <= 1
    assert np.array_equal(seen.astype(bool), _live(meta))
    assert walks == sorted(walks, reverse=True)
    if lens == "equal":
        # the long sequence starts on a 128-key boundary (640 = 5 * 128):
        # its first key tile walks all its rows, the longest walk
        _, k_tiles = fv.tile_ranges(*(torch.as_tensor(a) for a in meta))
        lo, hi = _walk(k_tiles.numpy(), 640 // _BKEY, sum(lens_k))
        assert (lo, hi) == (640, 640 + 2048)
        assert walks[0] == 2048 // _BQ[D]


# ------------------------------------------- plain version against Pallas

def _jax_grads(q, k, v, do, meta, dtype):
    """q/k/v gradients (cotangent ``do``) of the Pallas varlen kernels in
    interpret mode, with T padded to 128 by segment ids -1 / -2."""
    seg_q, off_q, seg_k, off_k = meta
    Tq, Tk = q.shape[0], k.shape[0]

    def pad(a, n, fill):
        return np.concatenate([a, np.full(n, fill, a.dtype)])
    pq, pk = -Tq % 128, -Tk % 128
    sq, oq = pad(seg_q, pq, -1), pad(off_q, pq, 0)
    sk, ok = pad(seg_k, pk, -2), pad(off_k, pk, 0)

    def f(q, k, v):
        z = lambda a, n: jnp.concatenate(
            [a, jnp.zeros((n,) + a.shape[1:], a.dtype)])
        return jax_packed(z(q, pq), z(k, pk), z(v, pk), sq, oq, sk, ok,
                          interpret=True)[:Tq]
    args = [jnp.asarray(a, JDT[dtype]) for a in (q, k, v)]
    _, vjp = jax.vjp(f, *args)
    return [np.asarray(t.astype(jnp.float32))
            for t in vjp(jnp.asarray(do, JDT[dtype]))]


# sequence 0: 20 rows over 8 keys, causal, so its first 12 rows see no
# key; sequence 1: 5 keys and no row; 2: 6 rows over 10 keys; 3: 30 rows
# and no key
ZERO_LENS_Q, ZERO_LENS_K = [20, 0, 6, 30], [8, 5, 10, 0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [16, 64, 128])
def test_fused_plain_version_matches_the_pallas_pair(D, dtype):
    meta = _meta(ZERO_LENS_Q, ZERO_LENS_K, causal=True)
    Tq, Tk = sum(ZERO_LENS_Q), sum(ZERO_LENS_K)
    rs = np.random.RandomState(D)
    q, do = (rs.randn(Tq, 2, D).astype(np.float32) * 0.5 for _ in range(2))
    k, v = (rs.randn(Tk, 2, D).astype(np.float32) * 0.5 for _ in range(2))
    want = _jax_grads(q, k, v, do, meta, dtype)
    tq, tk, tv, tdo = (torch.tensor(a).to(TDT[dtype])
                       for a in (q, k, v, do))
    tmeta = [torch.as_tensor(a) for a in meta]
    scale = 1.0 / D ** 0.5
    o, lse = fv.flash_varlen_fwd_reference(tq, tk, tv, *tmeta, scale)
    delta = (tdo.float() * o.float()).sum(-1).t().contiguous()
    args = (tq, tk, tv, tdo, lse, delta, *tmeta, scale)
    dq, dk, dv = fv.flash_varlen_bwd_fused(
        *args[:-1], fv.tile_ranges(*tmeta)[1], scale)   # the CPU route
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert g.dtype == TDT[dtype]
        ref = max(1.0, float(np.abs(w).max()))
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= TOL[dtype] * ref, f"{name}: {err} > {TOL[dtype]} * {ref}"
    # rows that see no key (sequence 0's first 12, all of sequence 3) and
    # keys that no row sees (sequence 1) get exact zeros
    assert not dq[:12].any() and not dq[26:].any() and dq[12:26].any()
    assert not dk[8:13].any() and not dv[8:13].any() and dv[:8].any()
    # the split pair's plain versions on the same inputs, bitwise
    split = (fv.flash_varlen_bwd_dq_reference(*args),
             *fv.flash_varlen_bwd_dkv_reference(*args))
    for a, b in zip((dq, dk, dv), split):
        assert torch.equal(a, b)
    sums = fv.flash_varlen_bwd_fused_reference(*args,
                                               out_dtype=torch.float32)
    for a, b in zip(sums, (dq, dk, dv)):
        assert a.dtype == torch.float32 and torch.equal(a.to(b.dtype), b)


# ----------------------------------------------------- routes on the card

class _Recorder:
    """Stands in for the built libraries: records (library, entry, args),
    checks each call against the entry's C signature, and returns ``rc``
    from every entry."""

    def __init__(self, rc=0):
        self.calls, self.rc = [], rc

    def library(self, name, signatures):
        rec = self

        class _Lib:
            def __getattr__(self, entry):
                if entry == "error_string":
                    return lambda err: b"stand-in launch failure"
                assert entry in signatures, (name, entry)

                def call(*args):
                    assert len(args) == len(signatures[entry])
                    rec.calls.append((name, entry, args))
                    return rec.rc
                return call
        return _Lib()


@pytest.fixture
def card(monkeypatch):
    """The wrappers told their CPU tensors lie on the card, the built
    libraries replaced by a recorder, and every plain varlen version
    failing if it runs."""
    def install(rc=0):
        rec = _Recorder(rc)
        monkeypatch.setattr(_build, "on_card", lambda what, *t: True)
        monkeypatch.setattr(_build, "library", rec.library)
        monkeypatch.setattr(torch.cuda, "device",
                            lambda d: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda d: SimpleNamespace(cuda_stream=None))
        for name in ("flash_varlen_fwd_reference",
                     "flash_varlen_bwd_dkv_reference",
                     "flash_varlen_bwd_dq_reference",
                     "flash_varlen_bwd_fused_reference"):
            monkeypatch.setattr(fv, name,
                                lambda *a, **k: pytest.fail("plain ran"))
        return rec
    return install


def _bwd_inputs(dtype, lens_q=(3, 70), lens_k=(5, 300), H=2, D=64):
    meta = [torch.as_tensor(a) for a in _meta(lens_q, lens_k, True)]
    Tq, Tk = sum(lens_q), sum(lens_k)
    q, do = (torch.zeros(Tq, H, D, dtype=dtype) for _ in range(2))
    k, v = (torch.zeros(Tk, H, D, dtype=dtype) for _ in range(2))
    lse, delta = torch.zeros(H, Tq), torch.zeros(H, Tq)
    return q, k, v, do, lse, delta, meta, fv.tile_ranges(*meta)


def test_routes_by_dtype():
    assert fv.varlen_bwd_route(torch.bfloat16) == "fused"
    assert fv.varlen_bwd_route(torch.float32) == "split"


def test_bf16_backward_reaches_the_fused_entry_once(card):
    """The fused wrapper calls ``flash_varlen_bwd_fused_wgmma`` once with
    q, k, v, do, lse, delta, the metadata and ``k_tiles`` in that order,
    then the order scratch and dq32/dk/dv, and ``Tq, Tk, H, D``, the
    dtype code and the scale; it returns bf16 gradients of the inputs'
    shapes, and counts one launch."""
    rec = card()
    q, k, v, do, lse, delta, meta, (_, k_tiles) = _bwd_inputs(torch.bfloat16)
    before = [f.launches for f in (fv.flash_varlen_bwd_fused,
                                   fv.flash_varlen_bwd_dkv,
                                   fv.flash_varlen_bwd_dq)]
    dq, dk, dv = fv.flash_varlen_bwd_fused(q, k, v, do, lse, delta, *meta,
                                           k_tiles, 0.125)
    [(name, entry, args)] = rec.calls
    assert (name, entry) == ("flash_varlen_bwd_wgmma",
                             "flash_varlen_bwd_fused_wgmma")
    assert args[:11] == tuple(t.data_ptr() for t in (q, k, v, do, lse, delta,
                                                     *meta, k_tiles))
    assert args[15:] == (73, 305, 2, 64, 1, 0.125, None)
    assert [f.launches - b for f, b in zip(
        (fv.flash_varlen_bwd_fused, fv.flash_varlen_bwd_dkv,
         fv.flash_varlen_bwd_dq), before)] == [1, 0, 0]
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_the_op_backward_takes_the_route_of_its_dtype(card, dtype):
    """Through the differentiable op (its forward run on the CPU first):
    bf16 reaches the fused entry only, f32 the CUDA-core pair only."""
    q, k, v, _, _, _, meta, tiles = _bwd_inputs(dtype)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o, _ = fv.flash_attn_varlen(q, k, v, *meta, *tiles, 0.125)
    rec = card()
    o.float().sum().backward()
    want = (["flash_varlen_bwd_fused_wgmma"] if dtype == torch.bfloat16
            else ["flash_varlen_bwd_dkv", "flash_varlen_bwd_dq"])
    assert [c[1] for c in rec.calls] == want


@pytest.mark.parametrize("what", ["wrapper", "op_backward"])
def test_a_fused_launch_error_raises(card, what):
    """A C entry that reports a CUDA error raises RuntimeError, counting
    no launch: nothing turns to the split pair or the plain version."""
    q, k, v, do, lse, delta, meta, tiles = _bwd_inputs(torch.bfloat16)
    if what == "op_backward":
        q.requires_grad_()
        o, _ = fv.flash_attn_varlen(q, k, v, *meta, *tiles, 0.125)
    rec = card(rc=719)
    before = fv.flash_varlen_bwd_fused.launches
    with pytest.raises(RuntimeError, match="CUDA error 719"):
        if what == "wrapper":
            fv.flash_varlen_bwd_fused(q, k, v, do, lse, delta, *meta,
                                      tiles[1], 0.125)
        else:
            o.float().sum().backward()
    assert [c[1] for c in rec.calls] == ["flash_varlen_bwd_fused_wgmma"]
    assert fv.flash_varlen_bwd_fused.launches == before


def test_fused_wrapper_refuses_f32_and_misaligned_inputs(card):
    """On the card the fused kernel takes bf16 only, and reads q, k, v
    and do with TMA: an f32 call and a bf16 ``do`` off a 16-byte
    boundary raise before any launch."""
    rec = card()
    q, k, v, do, lse, delta, meta, (_, k_tiles) = _bwd_inputs(torch.float32)
    with pytest.raises(ValueError, match="bfloat16"):
        fv.flash_varlen_bwd_fused(q, k, v, do, lse, delta, *meta, k_tiles,
                                  0.125)
    q, k, v, do, lse, delta, meta, (_, k_tiles) = _bwd_inputs(torch.bfloat16)
    buf = torch.zeros(do.numel() + 1, dtype=torch.bfloat16)
    bad = buf[1:].view(do.shape)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        fv.flash_varlen_bwd_fused(q, k, v, bad, lse, delta, *meta, k_tiles,
                                  0.125)
    assert rec.calls == []


def test_flash_varlen_module_has_no_exception_handler():
    tree = ast.parse(Path(fv.__file__).read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_the_smoke_share_gate_separates_the_unrounded_backward():
    """``chip_smoke.varlen_bwd_stats``, the smoke's gate for the fused
    kernel on random inputs: the plain f32 sums correctly rounded read no
    element off; one element one bf16 step away reads one in the share;
    the plain backward without its P/dS rounding reads far past
    ``VARLEN_OFF_SHARE``."""
    import chip_smoke as cs
    meta = [torch.as_tensor(a) for a in _meta((3, 70, 40), (5, 90, 40),
                                              True)]
    g = torch.Generator().manual_seed(0)
    q, do = (torch.randn(113, 4, 64, generator=g).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(135, 4, 64, generator=g).to(torch.bfloat16)
            for _ in range(2))
    o, lse = fv.flash_varlen_fwd_reference(q, k, v, *meta, 0.125)
    delta = (do.float() * o.float()).sum(-1).t().contiguous()
    args = (lse, delta, *meta, 0.125)
    ref32 = fv.flash_varlen_bwd_fused_reference(q, k, v, do, *args,
                                                out_dtype=torch.float32)
    got = [t.to(torch.bfloat16) for t in ref32]
    n = sum(t.numel() for t in got)
    stats = cs.varlen_bwd_stats(got, ref32)
    assert stats == dict(max_err=0.0, off_share=0.0, past_limit=0,
                         elements=n)
    # one element of dv a bf16 step further from its f32 sum
    dv = got[2].flatten().float()
    i = int(ref32[2].abs().flatten().argmax())
    step = torch.exp2(torch.floor(torch.log2(dv[i].abs())) - 7)
    dv[i] += step if dv[i] >= ref32[2].flatten()[i] else -step
    one = cs.varlen_bwd_stats(
        [got[0], got[1], dv.to(torch.bfloat16).view_as(got[2])], ref32)
    assert one["off_share"] == 1 / n and one["max_err"] > 0
    up = [t.float() for t in (q, k, v, do)]
    unrounded = [t.to(torch.bfloat16) for t in
                 fv.flash_varlen_bwd_fused_reference(*up, *args)]
    assert cs.varlen_bwd_stats(unrounded, ref32)["off_share"] > \
        4 * cs.VARLEN_OFF_SHARE
