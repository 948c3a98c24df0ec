"""The port's packed varlen attention (``kernels/flash_varlen.py``,
``nn/functional/flash_attention.py``) held against the JAX package on
the same numpy inputs, on the CPU.

The plain versions of the three varlen kernels (which a CPU tensor runs)
are held against ``flash_attention_varlen_packed(..., interpret=True)``,
the Pallas kernels' own semantics, forward and q/k/v gradients. The
port's ``flash_attn_unpadded`` (packed route on either device) is held
against the JAX function on the CPU, which densifies, on inputs where
every row sees a key; the port's own densify route is held against the
JAX densify route. The wrappers' paths to their C entries run against a
stand-in library (bf16 forwards reach the tensor-core entry, f32 the
CUDA-core one), and a host model of the tensor-core forward's blocks is
held against the mask pair by pair.

Tolerances: f32 output 1e-5 and gradients 1e-4 (f32 sums of up to ~200
terms in another order; the Pallas kernel's online softmax against one
softmax over the row), each relative to max(1, the reference's largest
magnitude); bf16 2e-2 (outputs and probabilities rounded to bf16 at
different places).

Sizes stay small (T <= ~300, H <= 4): the interpret-mode kernel runs its
grid step by step. The JAX side pads T to a multiple of 128 with segment
ids -1 / -2 (its kernel needs 8-row tiles and is fastest with one tile);
the port takes any T.
"""

import contextlib
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle2_tpu as paddle
import paddle2_tpu.nn.functional as JF
from paddle2_tpu.kernels.pallas_flash import \
    flash_attention_varlen_packed as jax_packed
from paddle2_tpu_torch.kernels import _build, attention
from paddle2_tpu_torch.kernels import flash_varlen as fv
from paddle2_tpu_torch.kernels.attention import remat_policy
from paddle2_tpu_torch.nn import functional as F
from paddle2_tpu_torch.nn.functional import flash_attention as fa

TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# name -> (lens_q, lens_k): ragged with a length-1 sequence and T = 209
# (not a multiple of 8, a last sequence that ends mid-tile); len_q !=
# len_k with len_k >= len_q
CASES = {
    "ragged": ([1, 7, 64, 100, 37], None),
    "lq_ne_lk": ([5, 40, 1, 30], [9, 40, 3, 70]),
}


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)


def _meta(lens_q, lens_k, causal):
    """The port's per-row metadata (no padding), as ``_seg_off_device``
    builds it."""
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


def _inputs(lens_q, lens_k, H, D, seed):
    rs = np.random.RandomState(seed)
    Tq, Tk = sum(lens_q), sum(lens_k)
    q, do = (rs.randn(Tq, H, D).astype(np.float32) * 0.5 for _ in range(2))
    k, v = (rs.randn(Tk, H, D).astype(np.float32) * 0.5 for _ in range(2))
    return q, k, v, do


def _jax_packed(q, k, v, do, meta, dtype):
    """Output and q/k/v gradients (cotangent ``do``) of the Pallas varlen
    kernels in interpret mode, with T padded to a multiple of 128."""
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
    out, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(do, JDT[dtype]))
    return [np.asarray(t.astype(jnp.float32)) for t in (out, *grads)]


def _torch_packed(q, k, v, do, meta, dtype):
    ts = [torch.tensor(a).to(TDT[dtype]).requires_grad_() for a in (q, k, v)]
    out = fv.flash_attention_varlen_packed(*ts, *meta)
    out.backward(torch.tensor(do).to(TDT[dtype]))
    return [t.detach().float().numpy()
            for t in (out, ts[0].grad, ts[1].grad, ts[2].grad)]


def _close(got, want, tol, what):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_versions_match_the_pallas_kernels(case, causal, D, dtype):
    lens_q, lens_k = CASES[case]
    lens_k = lens_k or lens_q
    q, k, v, do = _inputs(lens_q, lens_k, 2, D, seed=D + int(causal))
    meta = _meta(lens_q, lens_k, causal)
    want = _jax_packed(q, k, v, do, meta, dtype)
    got = _torch_packed(q, k, v, do, meta, dtype)
    out_tol, grad_tol = TOL[dtype]
    for name, g, w, tol in zip(("out", "dq", "dk", "dv"), got, want,
                               (out_tol,) + (grad_tol,) * 3):
        _close(g, w, tol, name)


def test_rows_that_see_no_key_give_zero_as_the_pallas_kernel():
    """Causal with ``len_k < len_q``: the first ``len_q - len_k`` rows of
    the sequence see no key. The Pallas kernel and the port's packed
    route give them 0 output and 0 gradient; the JAX package's CPU route
    (densify, an XLA softmax over an all -inf row) gives NaN there, and
    so does the port's densify route, which ports it."""
    lens_q, lens_k = [20, 6], [8, 10]
    q, k, v, do = _inputs(lens_q, lens_k, 2, 16, seed=3)
    meta = _meta(lens_q, lens_k, causal=True)
    want = _jax_packed(q, k, v, do, meta, "float32")
    got = _torch_packed(q, k, v, do, meta, "float32")
    for g, w in zip(got, want):
        _close(g, w, 1e-4, "packed")
    assert not got[0][:12].any() and not got[1][:12].any()
    assert got[0][12:].any()
    cu_q, cu_k = _cu(lens_q), _cu(lens_k)
    jout, _ = JF.flash_attn_unpadded(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
        paddle.to_tensor(cu_q.astype(np.int32)),
        paddle.to_tensor(cu_k.astype(np.int32)), 20, 10, 0.25, causal=True)
    with F.sdp_kernel(enable_flash=False):
        tout, _ = F.flash_attn_unpadded(torch.tensor(q), torch.tensor(k),
                                        torch.tensor(v), cu_q, cu_k, 20, 10,
                                        0.25, causal=True)
    assert np.isnan(np.asarray(jout._data)[:12]).all()
    assert torch.isnan(tout[:12]).all()
    np.testing.assert_allclose(tout[12:].numpy(),
                               np.asarray(jout._data)[12:], atol=1e-5)


def _jax_unpadded(q, k, v, do, cu_q, cu_k, causal, dtype, packed_qkv=False):
    """The JAX package's ``flash_attn_unpadded`` on the CPU (its densify
    route): output and q/k/v gradients of ``sum(out * do)``."""
    ts = [paddle.to_tensor(a).astype(dtype) for a in (q, k, v)]
    for t in ts:
        t.stop_gradient = False
    args = (paddle.to_tensor(cu_q.astype(np.int32)),
            paddle.to_tensor(cu_k.astype(np.int32)),
            int(np.diff(cu_q).max()), int(np.diff(cu_k).max()),
            1.0 / np.sqrt(q.shape[-1]))
    if packed_qkv:
        qkv = paddle.stack(ts, axis=1)
        out, none = JF.flash_attn_varlen_qkvpacked(qkv, *args, causal=causal)
    else:
        out, none = JF.flash_attn_unpadded(*ts, *args, causal=causal)
    assert none is None
    (out.astype("float32") * paddle.to_tensor(do)).sum().backward()
    f = lambda t: np.asarray(t._data.astype(jnp.float32))
    return [f(out)] + [f(t.grad) for t in ts]


def _torch_unpadded(q, k, v, do, cu_q, cu_k, causal, dtype, packed_qkv):
    ts = [torch.tensor(a).to(TDT[dtype]).requires_grad_() for a in (q, k, v)]
    args = (torch.tensor(cu_q, dtype=torch.int32),
            torch.tensor(cu_k, dtype=torch.int32),
            int(np.diff(cu_q).max()), int(np.diff(cu_k).max()),
            1.0 / np.sqrt(q.shape[-1]))
    if packed_qkv:
        out, none = F.flash_attn_varlen_qkvpacked(torch.stack(ts, 1), *args,
                                                  causal=causal)
    else:
        out, none = F.flash_attn_unpadded(*ts, *args, causal=causal)
    assert none is None
    (out.float() * torch.tensor(do)).sum().backward()
    return [t.detach().float().numpy()
            for t in (out, ts[0].grad, ts[1].grad, ts[2].grad)]


UNPADDED = [(case, causal, dtype, False) for case in CASES
            for causal in (True, False) for dtype in TDT] + \
    [("ragged", True, dtype, True) for dtype in TDT]


@pytest.mark.parametrize(
    "case,causal,dtype,packed_qkv", UNPADDED,
    ids=["-".join([c, "causal" if k else "full", d]
                  + (["qkvpacked"] if p else [])) for c, k, d, p in UNPADDED])
def test_flash_attn_unpadded_matches_jax(case, causal, dtype, packed_qkv):
    lens_q, lens_k = CASES[case]
    lens_k = lens_k or lens_q
    q, k, v, do = _inputs(lens_q, lens_k, 3, 64, seed=7)
    calls = []
    orig = fv.flash_varlen_fwd_reference
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fv, "flash_varlen_fwd_reference",
                   lambda *a: calls.append(1) or orig(*a))
        got = _torch_unpadded(q, k, v, do, _cu(lens_q), _cu(lens_k), causal,
                              dtype, packed_qkv)
    assert calls == [1]              # the packed route, on the CPU too
    want = _jax_unpadded(q, k, v, do, _cu(lens_q), _cu(lens_k), causal,
                         dtype, packed_qkv)
    out_tol, grad_tol = TOL[dtype]
    for name, g, w, tol in zip(("out", "dq", "dk", "dv"), got, want,
                               (out_tol,) + (grad_tol,) * 3):
        _close(g, w, tol, name)


@pytest.mark.parametrize("why", ["flash_off", "head_dim_272"])
def test_densify_route_matches_jax(why):
    """Flash turned off, or a head dim over 256, takes the densify route
    in plain torch (no varlen kernel), equal to the JAX densify route."""
    D = 272 if why == "head_dim_272" else 16
    lens_q, lens_k = [3, 9, 4], [5, 9, 6]
    q, k, v, do = _inputs(lens_q, lens_k, 2, D, seed=11)
    off = F.sdp_kernel(enable_flash=False) if why == "flash_off" \
        else contextlib.nullcontext()
    with pytest.MonkeyPatch.context() as mp, off:
        for name in ("flash_varlen_fwd_reference",
                     "flash_varlen_bwd_dkv_reference",
                     "flash_varlen_bwd_dq_reference"):
            mp.setattr(fv, name, lambda *a: pytest.fail("a varlen kernel"))
        got = _torch_unpadded(q, k, v, do, _cu(lens_q), _cu(lens_k), True,
                              "float32", False)
    want = _jax_unpadded(q, k, v, do, _cu(lens_q), _cu(lens_k), True,
                         "float32")
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        _close(g, w, 1e-5, name)


def test_dropout_takes_the_densify_route_by_its_statistics():
    """Dropout in training densifies and drops probabilities at rate p,
    scaling the kept ones by 1/(1-p): with all-ones values every output
    is (kept probability mass)/(1-p), 1 on average. Out of training the
    dropout is off and the packed route runs."""
    lens = [200, 300]
    T, H, D = 500, 2, 16
    q = torch.zeros(T, H, D)
    v = torch.ones(T, H, D)
    cu = _cu(lens)
    gen = torch.Generator().manual_seed(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fv, "flash_varlen_fwd_reference",
                   lambda *a: pytest.fail("the packed route ran"))
        out, _ = F.flash_attn_unpadded(q, q, v, cu, cu, 300, 300, 0.25,
                                       dropout=0.5, generator=gen)
    again, _ = F.flash_attn_unpadded(
        q, q, v, cu, cu, 300, 300, 0.25, dropout=0.5,
        generator=torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    # uniform attention over n keys, each kept with p 0.5 and scaled by 2:
    # an output has mean 1 and standard deviation 1/sqrt(n) per row
    rows = out[:, :, 0]
    assert abs(rows.mean().item() - 1.0) < 4 * (1 / np.sqrt(250)) \
        / np.sqrt(T * H)
    assert rows.std().item() > 0.03
    off, _ = F.flash_attn_unpadded(q, q, v, cu, cu, 300, 300, 0.25,
                                   dropout=0.5, training=False)
    assert torch.allclose(off, torch.ones_like(off))


def test_return_softmax_raises_and_unsupported_inputs_raise():
    """``return_softmax`` raises, as in the JAX package. A head dim (32)
    or a dtype (float16) the varlen kernels do not take computes on the
    CPU as the JAX function does there (it densifies); on the card (a
    stand-in: the router told its tensors are there) it raises, naming
    its ROADMAP queue 2 item. Offsets that do not end at T raise."""
    q = torch.zeros(4, 1, 16)
    cu = [0, 4]
    with pytest.raises(NotImplementedError, match="return_softmax"):
        F.flash_attn_unpadded(q, q, q, cu, cu, 4, 4, 0.25,
                              return_softmax=True)
    rs = np.random.RandomState(2)
    cases = ((32, "float32", 1e-5, "A1"), (16, "float16", 1e-2, "A2"))
    for D, dtype, tol, _ in cases:
        a = [rs.randn(4, 1, D).astype(np.float32) for _ in range(3)]
        got, _ = F.flash_attn_unpadded(
            *(torch.tensor(x).to(getattr(torch, dtype)) for x in a), cu, cu,
            4, 4, 0.25, causal=True)
        want, _ = JF.flash_attn_unpadded(
            *(paddle.to_tensor(x).astype(dtype) for x in a),
            paddle.to_tensor(np.array(cu, np.int32)),
            paddle.to_tensor(np.array(cu, np.int32)), 4, 4, 0.25,
            causal=True)
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want._data.astype(jnp.float32)),
            atol=tol, rtol=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_build, "on_cuda", lambda t: True)
        for D, dtype, _, item in cases:
            z = torch.zeros(4, 1, D, dtype=getattr(torch, dtype))
            with pytest.raises(NotImplementedError,
                               match=f"ROADMAP.md queue 2 {item}"):
                F.flash_attn_unpadded(z, z, z, cu, cu, 4, 4, 0.25)
    with pytest.raises(ValueError, match="cu_seqlens_q"):
        F.flash_attn_unpadded(q, q, q, [0, 3], cu, 4, 4, 0.25)


@pytest.mark.parametrize("D", [32, 96])
def test_head_dims_outside_the_kernels_match_jax_on_the_cpu(D):
    """Head dims the varlen kernels do not take (but the JAX package's
    packed route does, up to 256) take the densify route on the CPU, the
    JAX package's route there: output and q/k/v gradients agree, and no
    varlen kernel's plain version runs."""
    q, k, v, do = _inputs([5, 7], [5, 7], 2, D, seed=D)
    cu = _cu([5, 7])
    with pytest.MonkeyPatch.context() as mp:
        for name in ("flash_varlen_fwd_reference",
                     "flash_varlen_bwd_dkv_reference",
                     "flash_varlen_bwd_dq_reference"):
            mp.setattr(fv, name, lambda *a: pytest.fail("a varlen kernel"))
        got = _torch_unpadded(q, k, v, do, cu, cu, True, "float32", False)
    want = _jax_unpadded(q, k, v, do, cu, cu, True, "float32")
    assert got[0].shape == (12, 2, D)
    for name, g, w, tol in zip(("out", "dq", "dk", "dv"), got, want,
                               TOL["float32"][:1] + TOL["float32"][1:] * 3):
        _close(g, w, tol, name)


def test_sdp_kernel_toggles_the_route_per_thread():
    assert attention.flash_enabled()
    with F.sdp_kernel(enable_flash=False):
        assert not attention.flash_enabled()
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            attention.flash_enabled()))
        t.start()
        t.join()
        assert seen == [True]
    assert attention.flash_enabled()
    with pytest.raises(ValueError, match="enable_math"):
        F.sdp_kernel(enable_math=False)
    # the dense attention follows it too, as the JAX package's use_pallas
    x = torch.randn(1, 8, 2, 16)
    with pytest.MonkeyPatch.context() as mp, \
            F.sdp_kernel(enable_flash=False):
        mp.setattr(attention, "flash_attention_bshd",
                   lambda *a, **k: pytest.fail("flash ran"))
        out = F.scaled_dot_product_attention(x, x, x, is_causal=True)
    torch.testing.assert_close(
        out, attention.flash_attention_bshd(x, x, x, causal=True),
        rtol=0, atol=1e-6)


def test_the_metadata_memo_builds_once_per_cu_seqlens():
    fa._SEG_CACHE.clear()
    q = torch.randn(10, 1, 16)
    calls = []
    orig = fv.tile_ranges
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fa, "tile_ranges", lambda *a: calls.append(1) or orig(*a))
        for cu in ([0, 4, 10], torch.tensor([0, 4, 10], dtype=torch.int32),
                   np.array([0, 4, 10])):
            F.flash_attn_unpadded(q, q, q, cu, cu, 6, 6, 0.25, causal=True)
        assert len(calls) == 1 and len(fa._SEG_CACHE) == 1
        F.flash_attn_unpadded(q, q, q, [0, 5, 10], [0, 5, 10], 5, 5, 0.25,
                              causal=True)
        F.flash_attn_unpadded(q, q, q, [0, 4, 10], [0, 4, 10], 6, 6, 0.25)
    assert len(calls) == 3 and len(fa._SEG_CACHE) == 3
    seg_q, off_q, seg_k, off_k, _ = next(iter(fa._SEG_CACHE.values()))
    assert seg_q.tolist() == [0] * 4 + [1] * 6
    assert off_q.tolist() == list(range(4)) + list(range(6))


def _live(meta):
    seg_q, off_q, seg_k, off_k = (torch.as_tensor(a) for a in meta)
    return (seg_q[:, None] == seg_k[None, :]) & \
        (off_k[None, :] <= off_q[:, None])


@pytest.mark.parametrize("case", ["long_and_short", "lk_lt_lq", "empty_seq",
                                  "full", "padded"])
def test_tile_ranges_cover_every_live_pair(case):
    """Every (query, key) pair the mask keeps lies inside its query
    tile's key range and its key tile's query range; a long causal
    sequence gets exactly its triangle."""
    causal = case != "full"
    lens_q, lens_k = {
        "long_and_short": ([300] + [20] * 8, None),
        "lk_lt_lq": ([70, 90, 5], [10, 130, 40]),
        "empty_seq": ([30, 0, 100], [30, 5, 0]),
        "full": ([1, 129, 64, 7], None),
        "padded": ([100, 28], None),
    }[case]
    meta = _meta(lens_q, lens_k or lens_q, causal)
    if case == "padded":      # the JAX package's padding rows, at the end
        meta = [np.concatenate([a, np.full(8, fill, np.int32)])
                for a, fill in zip(meta, (-1, 0, -2, 0))]
    live = _live(meta)
    q_tiles, k_tiles = fv.tile_ranges(*(torch.as_tensor(a) for a in meta))
    qi, ki = torch.nonzero(live, as_tuple=True)
    qt, kt = q_tiles[qi // fv.TILE], k_tiles[ki // fv.TILE]
    assert ((qt[:, 0] <= ki) & (ki < qt[:, 1])).all()
    assert ((kt[:, 0] <= qi) & (qi < kt[:, 1])).all()
    if case == "long_and_short":
        # query tile t of the 300-token sequence sees keys [0, 64(t+1))
        assert q_tiles[:4].tolist() == [[0, 64 * (t + 1)] for t in range(4)]
        assert k_tiles[:4].tolist() == [[64 * t, 300] for t in range(4)]
    if case == "padded":
        assert q_tiles[-1, 1] <= 128 and k_tiles[-1, 1] <= 128


@pytest.fixture
def stand_in(monkeypatch):
    """The wrappers told their tensors are on the card, the built
    libraries replaced by a recorder of (library, entry, arguments), and
    the plain versions failing if they run."""
    calls = []

    class StandIn:
        def __init__(self, name):
            self.name = name

        def __getattr__(self, entry):
            return lambda *args: calls.append((self.name, entry, args)) or 0
    monkeypatch.setattr(_build, "on_card", lambda what, *t: True)
    monkeypatch.setattr(_build, "library", lambda name, sigs: StandIn(name))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=None))
    for name in ("flash_varlen_fwd_reference",
                 "flash_varlen_bwd_dkv_reference",
                 "flash_varlen_bwd_dq_reference"):
        monkeypatch.setattr(fv, name, lambda *a: pytest.fail("plain ran"))
    return calls


def _packed_call(dtype):
    """A forward and a backward of the differentiable op on the stand-in
    library; returns (q, k, v, meta)."""
    lens_q, lens_k = [3, 70], [5, 80]
    meta = [torch.as_tensor(a) for a in _meta(lens_q, lens_k, True)]
    q = torch.zeros(73, 2, 64, dtype=dtype, requires_grad=True)
    k = torch.zeros(85, 2, 64, dtype=dtype, requires_grad=True)
    v = torch.zeros(85, 2, 64, dtype=dtype, requires_grad=True)
    out = fv.flash_attention_varlen_packed(q, k, v, *meta, scale=0.125)
    out.float().sum().backward()
    return q, k, v, meta


def test_wrappers_reach_their_c_entries(stand_in):
    """With the wrappers told their tensors are on the card, a bf16
    forward and backward call ``flash_varlen_fwd_wgmma`` (the tensor-core
    library), ``flash_varlen_bwd_dkv`` and ``flash_varlen_bwd_dq`` once
    each, with the tensors' pointers, ``Tq, Tk, H, D``, the dtype code
    and the scale, and count one launch each; no plain version runs."""
    before = [f.launches for f in (fv.flash_varlen_fwd,
                                   fv.flash_varlen_bwd_dkv,
                                   fv.flash_varlen_bwd_dq)]
    q, k, v, meta = _packed_call(torch.bfloat16)
    assert [f.launches - b for f, b in zip(
        (fv.flash_varlen_fwd, fv.flash_varlen_bwd_dkv,
         fv.flash_varlen_bwd_dq), before)] == [1, 1, 1]
    assert [c[:2] for c in stand_in] == [
        ("flash_varlen_wgmma", "flash_varlen_fwd_wgmma"),
        ("flash_varlen", "flash_varlen_bwd_dkv"),
        ("flash_varlen", "flash_varlen_bwd_dq")]
    tail = (73, 85, 2, 64, 1, 0.125, None)
    fwd, dkv, dq = (c[2] for c in stand_in)
    assert fwd[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert fwd[3:7] == tuple(m.data_ptr() for m in meta)
    assert len(fwd) == 10 + 7 and fwd[10:] == tail
    assert len(dkv) == 13 + 7 and dkv[13:] == tail
    assert len(dq) == 12 + 7 and dq[12:] == tail
    assert dkv[6:10] == dq[6:10] == fwd[3:7]


def test_f32_forward_keeps_the_cuda_core_kernel(stand_in):
    """An f32 forward reaches ``flash_varlen_fwd`` in the CUDA-core
    library with the same C signature as the bf16 entry."""
    _packed_call(torch.float32)
    assert [c[:2] for c in stand_in] == [
        ("flash_varlen", "flash_varlen_fwd"),
        ("flash_varlen", "flash_varlen_bwd_dkv"),
        ("flash_varlen", "flash_varlen_bwd_dq")]
    assert stand_in[0][2][10:] == (73, 85, 2, 64, 0, 0.125, None)
    assert fv._LIBRARIES["flash_varlen_wgmma"]["flash_varlen_fwd_wgmma"] \
        == fv._LIBRARIES["flash_varlen"]["flash_varlen_fwd"]


def test_a_misaligned_bf16_packed_view_raises(stand_in):
    """TMA reads 16-byte aligned bases: a contiguous bf16 view that
    starts elsewhere raises before any launch (the f32 kernel takes it);
    its aligned copy launches."""
    T, H, D = 10, 2, 16
    n = T * H * D
    meta = [torch.as_tensor(a) for a in _meta([4, 6], [4, 6], True)]
    tiles = fv.tile_ranges(*meta)
    for dtype, launches in ((torch.bfloat16, 0), (torch.float32, 1)):
        buf = torch.zeros(3 * n + 1, dtype=dtype)
        q, k, v = (buf[1 + i * n:1 + (i + 1) * n].view(T, H, D)
                   for i in range(3))
        assert q.is_contiguous() and q.data_ptr() % 16
        before = len(stand_in)
        if launches:
            fv.flash_varlen_fwd(q, k, v, *meta, tiles[0], 0.25)
        else:
            with pytest.raises(ValueError, match="16-byte"):
                fv.flash_varlen_fwd(q, k, v, *meta, tiles[0], 0.25)
        assert len(stand_in) - before == launches
    fv.flash_varlen_fwd(*(t.to(torch.bfloat16).clone() for t in (q, k, v)),
                        *meta, tiles[0], 0.25)
    assert stand_in[-1][1] == "flash_varlen_fwd_wgmma"


# the tensor-core forward's block rows and key tiles (BQ; BK by head dim)
# and its sentinel segment ids (csrc/flash_varlen_wgmma.cu)
_WG_BQ = 128
_WG_BK = {16: 128, 64: 128, 128: 64}
_INT_MIN, _INT_MAX = -2 ** 31, 2 ** 31 - 1
_PAST_K, _PAST_Q, _MIXED_K, _MIXED_Q = (_INT_MIN + i for i in range(4))


def _wgmma_forward_pairs(meta, BK):
    """A host model of the tensor-core forward's index arithmetic: for
    each 128-row block, the union of its two ``q_tiles`` entries, its
    key tiles of ``BK`` from the range's first row, and for each warp of
    16 rows and each key tile the mask-skip rule; returns the [Tq, Tk]
    pairs the kernel lets into its softmax."""
    seg_q, off_q, seg_k, off_k = (np.asarray(a, np.int64) for a in meta)
    Tq, Tk = len(seg_q), len(seg_k)
    q_tiles, _ = fv.tile_ranges(*(torch.as_tensor(a) for a in meta))
    q_tiles = q_tiles.numpy()
    n64 = len(q_tiles)
    seen = np.zeros((Tq, Tk), np.int64)
    for t in range(-(-Tq // _WG_BQ)):
        lo, hi = q_tiles[2 * t]
        if 2 * t + 1 < n64:
            lo, hi = min(lo, q_tiles[2 * t + 1, 0]), max(
                hi, q_tiles[2 * t + 1, 1])
        n_tiles = -(-(hi - lo) // BK) if hi > lo else 0
        for i in range(n_tiles):
            c = lo + i * BK + np.arange(BK)
            inr = c < hi
            kseg = np.where(inr, seg_k[np.minimum(c, Tk - 1)], _PAST_K)
            koff = np.where(inr, off_k[np.minimum(c, Tk - 1)], _INT_MAX)
            tseg = kseg[0] if (kseg == kseg[0]).all() else _MIXED_K
            for w in range(_WG_BQ // 16):
                r = t * _WG_BQ + 16 * w + np.arange(16)
                rin = r < Tq
                rseg = np.where(rin, seg_q[np.minimum(r, Tq - 1)], _PAST_Q)
                roff = np.where(rin, off_q[np.minimum(r, Tq - 1)], _INT_MIN)
                wseg = rseg[0] if (rseg == rseg[0]).all() else _MIXED_Q
                if tseg == wseg and koff.max() <= roff.min():
                    live = np.ones((16, BK), bool)
                else:
                    live = (kseg[None] == rseg[:, None]) & \
                        (koff[None] <= roff[:, None])
                live &= rin[:, None] & (c < Tk)[None]
                rr, cc = np.nonzero(live)
                np.add.at(seen, (r[rr], c[cc]), 1)
    return seen


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("lens", ["equal", "lk_lt_lq"])
@pytest.mark.parametrize("D", [64, 128])
def test_tensor_core_forward_sees_every_live_pair_once(causal, lens, D):
    """The host model of the tensor-core forward's blocks (the 128-row
    union of ``q_tiles``, key tiles from the range's first row, the
    mask-skip rule) lets every live (query, key) pair into the softmax
    exactly once and no other pair, at sequence lengths 1, 127, 128,
    129, 255 and 2048 (and ``len_k < len_q``)."""
    lens_q = [1, 127, 128, 129, 255, 2048]
    lens_k = lens_q if lens == "equal" else [1, 100, 128, 64, 200, 1000]
    meta = _meta(lens_q, lens_k, causal)
    seen = _wgmma_forward_pairs(meta, _WG_BK[D])
    live = _live(meta).numpy()
    assert seen.max() <= 1
    assert np.array_equal(seen.astype(bool), live)


def test_dots_remat_keeps_the_varlen_op_outputs():
    """Under the "dots" policy a checkpointed block's backward reuses
    the varlen op's saved (o, lse): one forward per step, as the JAX
    package's flash_out/flash_lse names; full recompute runs it twice."""
    meta = [torch.as_tensor(a) for a in _meta([30, 34], [30, 34], True)]
    x = torch.randn(64, 2, 16, requires_grad=True)
    w = torch.randn(16, 16)

    def block(x):
        h = (x @ w).contiguous()
        return fv.flash_attention_varlen_packed(h, h, h, *meta) @ w
    for base, want in (("dots", 1), ("full", 2)):
        calls = []
        orig = fv.flash_varlen_fwd_reference
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(fv, "flash_varlen_fwd_reference",
                       lambda *a: calls.append(1) or orig(*a))
            ctx = remat_policy(base)
            kw = {"context_fn": ctx} if ctx is not None else {}
            y = torch.utils.checkpoint.checkpoint(block, x,
                                                  use_reentrant=False, **kw)
            y.sum().backward()
        assert len(calls) == want, base


def test_flash_attention_and_qkvpacked_match_jax():
    """``flash_attention`` and ``flash_attn_qkvpacked`` (dense layout):
    output and the plain probabilities of ``return_softmax``."""
    rs = np.random.RandomState(5)
    qkv = rs.randn(2, 12, 3, 2, 16).astype(np.float32) * 0.5
    jq = paddle.to_tensor(qkv)
    jout, jsm = JF.flash_attn_qkvpacked(jq, causal=True, return_softmax=True)
    tout, tsm = F.flash_attn_qkvpacked(torch.tensor(qkv), causal=True,
                                       return_softmax=True)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout._data),
                               atol=1e-5)
    np.testing.assert_allclose(tsm.numpy(), np.asarray(jsm._data), atol=1e-6)
    out, sm = F.flash_attention.flash_attention(
        torch.tensor(qkv[:, :, 0]), torch.tensor(qkv[:, :, 1]),
        torch.tensor(qkv[:, :, 2]))
    assert sm is None
    np.testing.assert_allclose(out.numpy(), np.asarray(JF.flash_attention
                               .flash_attention(paddle.to_tensor(
                                   qkv[:, :, 0]), paddle.to_tensor(
                                   qkv[:, :, 1]), paddle.to_tensor(
                                   qkv[:, :, 2]))[0]._data), atol=1e-5)


FLASHMASK = {
    "causal_1": (True, 1, None), "causal_2": (True, 2, None),
    "bidir_2": (False, 2, None), "bidir_4": (False, 4, None),
    "causal_window": (True, None, 3), "bidir_window": (False, None, (2, 1)),
}


@pytest.mark.parametrize("variant", list(FLASHMASK))
def test_flashmask_attention_matches_jax(variant):
    causal, n, window = FLASHMASK[variant]
    rs = np.random.RandomState(9)
    B, S, H, D = 2, 10, 2, 16
    q, k, v = (rs.randn(B, S, H, D).astype(np.float32) for _ in range(3))
    idx = None
    if n is not None:
        idx = np.sort(rs.randint(0, S + 1, (B, 1, S, n)), axis=-1) \
            .astype(np.int32)
    kw = dict(causal=causal, window_size=window, return_softmax_lse=True,
              return_seed_offset=True)
    j = JF.flashmask_attention(
        *(paddle.to_tensor(a) for a in (q, k, v)),
        startend_row_indices=None if idx is None else paddle.to_tensor(idx),
        **kw)
    t = F.flashmask_attention(
        *(torch.tensor(a) for a in (q, k, v)),
        startend_row_indices=None if idx is None else torch.tensor(idx),
        **kw)
    assert len(t) == len(j) == 3
    for a, b in zip(t[:2], j[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b._data),
                                   atol=1e-5)
    assert t[2].tolist() == [0, 0]


@pytest.mark.parametrize("masks", [False, True], ids=["csr", "csr_masks"])
def test_sparse_attention_matches_jax(masks):
    rs = np.random.RandomState(2)
    B, H, S, D = 2, 2, 8, 16
    q, k, v = (rs.randn(B, H, S, D).astype(np.float32) for _ in range(3))
    counts = rs.randint(0, 4, (B, H, S))
    offset = np.concatenate([np.zeros((B, H, 1), np.int64),
                             np.cumsum(counts, -1)], -1).astype(np.int32)
    nnz = int(offset[..., -1].max()) + 2
    cols = rs.randint(0, S, (B, H, nnz)).astype(np.int32)
    extra = {}
    if masks:
        extra = dict(key_padding_mask=np.where(rs.rand(B, S) < 0.2, -2.0,
                                               0.0).astype(np.float32),
                     attn_mask=rs.randn(S, S).astype(np.float32))
    j = JF.sparse_attention(*(paddle.to_tensor(a) for a in
                              (q, k, v, offset, cols)),
                            **{n: paddle.to_tensor(a)
                               for n, a in extra.items()})
    t = F.sparse_attention(*(torch.tensor(a) for a in
                             (q, k, v, offset, cols)),
                           **{n: torch.tensor(a) for n, a in extra.items()})
    np.testing.assert_allclose(t.numpy(), np.asarray(j._data), atol=1e-5)
