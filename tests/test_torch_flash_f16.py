"""float16 on the flash kernels (ROADMAP queue 2 A2): the port's plain
f16 versions, dense and packed varlen, forward and backward, held
against the JAX package's Pallas kernels run in interpret mode in f16,
and the routes taking f16 on the CPU and (through a stand-in library)
reaching the tensor-core C entries with dtype code 2.

The plain versions round where the Pallas kernels round: P to f16 before
P·V and P^T·dO, dS to f16 before dS·K and dS^T·Q, every sum f32. Where
they differ, the tolerance says so: the one-tile Pallas kernels round
q·scale to f16 (exact at head dims 16 and 64, whose scales are powers of
two), and the plain versions sum in another order. Tolerances: f16 has
three more mantissa bits than bf16, so bf16's limits of these tests
(2e-2) become 2.5e-3 (the same number of f16 steps, 2**-11 each).
"""

import contextlib
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle2_tpu.kernels.pallas_flash import (_flash_bwd, _flash_fwd,
                                              flash_attention_bshd)
from paddle2_tpu.kernels.pallas_flash import \
    flash_attention_varlen_packed as jax_packed
from paddle2_tpu_torch.kernels import _build, attention
from paddle2_tpu_torch.kernels import flash_attn as fa
from paddle2_tpu_torch.kernels import flash_varlen as fv

TOL = 2.5e-3
F16 = torch.float16


def _dense(seed, B, H, Sq, Sk, D):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, S, D)).astype(np.float32)
            for S in (Sq, Sk, Sk, Sq)]


def _t(a, dtype=F16):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _close(got, want, tol=TOL, what=""):
    g = got.float().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(w).max()))
    err = float(np.abs(g - w).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


# (D, Sq, Sk, block): every head dim in one tile; the tiled kernel (a
# block of 16 rows and keys) at head dim 64
DENSE = [(D, Sq, Sk, 1024) for D in (16, 64, 128)
         for Sq, Sk in ((32, 32), (8, 40))] + \
    [(64, Sq, Sk, 16) for Sq, Sk in ((32, 32), (8, 40))]
DENSE_IDS = [f"D{D}-{Sq}x{Sk}-{'one_tile' if b == 1024 else 'tiled'}"
             for D, Sq, Sk, b in DENSE]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("D,Sq,Sk,block", DENSE, ids=DENSE_IDS)
def test_dense_forward_matches_pallas(D, Sq, Sk, block, causal):
    q, k, v, _ = _dense(D + Sq + block, 1, 2, Sq, Sk, D)
    scale = 1.0 / math.sqrt(D)
    o_ref, lse_ref = _flash_fwd(*(jnp.asarray(a, jnp.float16)
                                  for a in (q, k, v)), scale, causal, block,
                                block, True)
    o, lse = fa.flash_fwd(_t(q), _t(k), _t(v), causal=causal)
    assert o.dtype == F16 and lse.dtype == torch.float32
    _close(o, o_ref.astype(jnp.float32), what="o")
    _close(lse, lse_ref, what="lse")


# the backward's cases: every head dim on the fused one-tile kernel, the
# split pair (a block of 16) at head dim 64
DENSE_BWD = [(D, Sq, Sk, 1024) for D in (16, 64, 128)
             for Sq, Sk in ((32, 32), (24, 40))] + \
    [(64, Sq, Sk, 16) for Sq, Sk in ((32, 32), (24, 40))]
DENSE_BWD_IDS = [f"D{D}-{Sq}x{Sk}-{'fused1blk' if b == 1024 else 'split'}"
                 for D, Sq, Sk, b in DENSE_BWD]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("D,Sq,Sk,block", DENSE_BWD, ids=DENSE_BWD_IDS)
def test_dense_backward_matches_pallas(D, Sq, Sk, block, causal):
    q, k, v, do = _dense(D + Sq + block + 1, 1, 2, Sq, Sk, D)
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.float16) for a in (q, k, v, do))
    scale = 1.0 / math.sqrt(D)
    o, lse = _flash_fwd(jq, jk, jv, scale, causal, block, block, True)
    want = _flash_bwd(jq, jk, jv, o, lse, jdo, scale, causal, block, block,
                      True)
    got = fa.flash_bwd(_t(q), _t(k), _t(v), _t(o), _t(lse, torch.float32),
                       _t(do), scale, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == F16
        _close(g, w.astype(jnp.float32), what=name)


def test_public_flash_matches_pallas_end_to_end():
    """``flash_attention_bshd``'s output and q/k/v gradients through
    autograd against the JAX function's VJP, both f16."""
    q, k, v, do = (np.swapaxes(a, 1, 2) for a in _dense(4, 2, 2, 48, 48, 64))
    f = lambda a, b, c: flash_attention_bshd(a, b, c, causal=True,  # noqa
                                             interpret=True)
    out, vjp = jax.vjp(f, *(jnp.asarray(a, jnp.float16) for a in (q, k, v)))
    want = [out, *vjp(jnp.asarray(do, jnp.float16))]
    ts = [_t(a).requires_grad_() for a in (q, k, v)]
    o = fa.flash_attention_bshd(*ts, causal=True)
    o.backward(_t(do))
    for name, g, w in zip(("out", "dq", "dk", "dv"),
                          (o.detach(), *(t.grad for t in ts)), want):
        assert g.dtype == F16
        _close(g, w.astype(jnp.float32), what=name)


def test_f16_rounding_is_the_pallas_kernels():
    """The plain versions round P and dS to f16 where the kernels do:
    with the rounding taken out (f32 sums on f32 copies) they move off
    the Pallas results by far more than with it."""
    q, k, v, do = _dense(9, 1, 2, 64, 64, 64)
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.float16) for a in (q, k, v, do))
    o, lse = _flash_fwd(jq, jk, jv, 0.125, True, 1024, 1024, True)
    want = _flash_bwd(jq, jk, jv, o, lse, jdo, 0.125, True, 1024, 1024, True)
    args = [_t(a) for a in (q, k, v, o)] + [_t(lse, torch.float32), _t(do)]
    rounded = fa.flash_bwd_reference(*args, 0.125, True,
                                     out_dtype=torch.float32)
    unrounded = fa.flash_bwd_reference(*[a.float() for a in args], 0.125,
                                       True)
    e_r = max(float((g - torch.from_numpy(np.asarray(
        w.astype(jnp.float32)))).abs().max()) for g, w in zip(rounded, want))
    e_u = max(float((g - torch.from_numpy(np.asarray(
        w.astype(jnp.float32)))).abs().max())
        for g, w in zip(unrounded, want))
    assert e_r < e_u


# ------------------------------------------------------------ varlen

VARLEN_CASES = {"equal": ([37, 100, 5], None),
                "cross": ([20, 64], [50, 90]),
                "one": ([130], None)}


def _meta(lens_q, lens_k, causal):
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


def _jax_varlen(q, k, v, do, meta):
    seg_q, off_q, seg_k, off_k = meta
    Tq, Tk = q.shape[0], k.shape[0]
    pq, pk = -Tq % 128, -Tk % 128

    def pad(a, n, fill):
        return np.concatenate([a, np.full(n, fill, a.dtype)])
    sq, oq = pad(seg_q, pq, -1), pad(off_q, pq, 0)
    sk, ok = pad(seg_k, pk, -2), pad(off_k, pk, 0)

    def f(q, k, v):
        z = lambda a, n: jnp.concatenate(  # noqa: E731
            [a, jnp.zeros((n,) + a.shape[1:], a.dtype)])
        return jax_packed(z(q, pq), z(k, pk), z(v, pk), sq, oq, sk, ok,
                          interpret=True)[:Tq]
    out, vjp = jax.vjp(f, *(jnp.asarray(a, jnp.float16) for a in (q, k, v)))
    grads = vjp(jnp.asarray(do, jnp.float16))
    return [np.asarray(t.astype(jnp.float32)) for t in (out, *grads)]


# every head dim on the cross-length batch, head dim 64 on the others
VARLEN = [("cross", D) for D in (16, 64, 128)] + \
    [(c, 64) for c in VARLEN_CASES if c != "cross"]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("case,D", VARLEN,
                         ids=[f"{c}-D{D}" for c, D in VARLEN])
def test_varlen_matches_pallas(case, D, causal):
    lens_q, lens_k = VARLEN_CASES[case]
    lens_k = lens_k or lens_q
    rs = np.random.RandomState(D + int(causal))
    Tq, Tk = sum(lens_q), sum(lens_k)
    q, do = (rs.randn(Tq, 2, D).astype(np.float32) * 0.5 for _ in range(2))
    k, v = (rs.randn(Tk, 2, D).astype(np.float32) * 0.5 for _ in range(2))
    meta = _meta(lens_q, lens_k, causal)
    want = _jax_varlen(q, k, v, do, meta)
    ts = [_t(a).requires_grad_() for a in (q, k, v)]
    out = fv.flash_attention_varlen_packed(*ts, *meta)
    out.backward(_t(do))
    for name, g, w in zip(("out", "dq", "dk", "dv"),
                          (out.detach(), *(t.grad for t in ts)), want):
        assert g.dtype == F16
        _close(g, w, what=name)


# ------------------------------------------------------------ routes

class _Recorder:
    def __init__(self):
        self.calls = []

    def library(self, name, signatures):
        rec = self

        class _Lib:
            def __getattr__(self, entry):
                assert entry in signatures, (name, entry)

                def call(*args):
                    assert len(args) == len(signatures[entry])
                    rec.calls.append((name, entry, args))
                    return 0
                return call
        return _Lib()


@pytest.fixture
def card(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(_build, "on_card", lambda what, *t: True)
    monkeypatch.setattr(_build, "on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "library", rec.library)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=None))
    for mod, name in ((fa, "flash_fwd_reference"),
                      (fa, "flash_bwd_reference"),
                      (fv, "flash_varlen_fwd_reference"),
                      (fv, "flash_varlen_bwd_fused_reference")):
        monkeypatch.setattr(mod, name, lambda *a, **k: pytest.fail(
            "a plain version ran"))
    return rec


def test_routes_take_f16():
    assert fa.bwd_route(F16) == "fused" and fv.varlen_bwd_route(F16) == \
        "fused"
    assert fa.FWD_ROUTES[F16] == "wgmma"
    assert fa._DTYPE_CODE[F16] == fv._DTYPE_CODE[F16] == 2
    z = torch.zeros(4, 2, 64, dtype=F16)
    assert fv.kernel_gap(z, z, z) is None
    assert attention._kernel_gap(z[None], z[None], z[None]) is None


def test_dense_f16_reaches_the_tensor_core_entries(card):
    """An f16 attention forward and backward on the card: the wgmma
    forward and the fused wgmma backward, dtype code 2, f16 outputs."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 64, 3, 64, generator=g).to(F16)
               .requires_grad_() for _ in range(3))
    before = (fa.flash_fwd.launches, fa.flash_bwd_fused.launches)
    out = attention.scaled_dot_product_attention(q, k, v, is_causal=True)
    assert out.dtype == F16
    out.float().sum().backward()
    assert (fa.flash_fwd.launches, fa.flash_bwd_fused.launches) == \
        (before[0] + 1, before[1] + 1)
    assert [c[:2] for c in card.calls] == [
        ("flash_fwd_wgmma", "flash_fwd_wgmma"),
        ("flash_bwd_wgmma", "flash_bwd_fused_wgmma")]
    assert all(c[2][-9:-1][5] == 2 for c in card.calls)
    assert q.grad.dtype == k.grad.dtype == v.grad.dtype == F16


def test_dense_f16_split_route_reaches_the_cuda_core_pair(card):
    q, k, v, do = (torch.zeros(1, 2, 40, 64, dtype=F16) for _ in range(4))
    lse = torch.zeros(1, 2, 40)
    fa.flash_bwd(q, k, v, q, lse, do, 0.125, True, route="split")
    assert [c[:2] for c in card.calls] == [("flash_bwd", "flash_bwd_dkv"),
                                           ("flash_bwd", "flash_bwd_dq")]
    assert all(c[2][-9:-1][5] == 2 for c in card.calls)


def test_varlen_f16_reaches_the_tensor_core_entries(card):
    meta = [torch.as_tensor(a) for a in _meta([3, 70], [5, 80], True)]
    q = torch.zeros(73, 2, 64, dtype=F16, requires_grad=True)
    k = torch.zeros(85, 2, 64, dtype=F16, requires_grad=True)
    v = torch.zeros(85, 2, 64, dtype=F16, requires_grad=True)
    before = (fv.flash_varlen_fwd.launches, fv.flash_varlen_bwd_fused.launches)
    out = fv.flash_attention_varlen_packed(q, k, v, *meta, scale=0.125)
    out.float().sum().backward()
    assert (fv.flash_varlen_fwd.launches,
            fv.flash_varlen_bwd_fused.launches) == (before[0] + 1,
                                                    before[1] + 1)
    assert [c[:2] for c in card.calls] == [
        ("flash_varlen_wgmma", "flash_varlen_fwd_wgmma"),
        ("flash_varlen_bwd_wgmma", "flash_varlen_bwd_fused_wgmma")]
    assert all(c[2][-3] == 2 for c in card.calls)
