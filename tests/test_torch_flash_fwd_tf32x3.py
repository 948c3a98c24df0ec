"""The f32 flash forward on the tensor cores (3xTF32), held on the CPU.

``flash_fwd_tf32x3.cu`` runs the f32 forward with both products (S =
Q Kᵀ, O = P V) done as three TF32 products each (small·big, big·small,
big·big), the online softmax in registers. Here, without a card:

- routing, through the stand-in card of ``test_torch_flash_tc.py``: f32
  CUDA tensors reach ``flash_fwd_tf32x3`` with ``flash_fwd_wgmma``'s
  argument list, counted in ``route_launches["tf32x3"]``; an f32 view
  off a 16-byte boundary is copied first; a failing entry raises;
- the smoke's row of the kernel (its source, what it replaces, its
  launches, its 3xTF32 bound);
- numerics: the plain forward with 3xTF32-emulated products
  (``flash_attn.tf32_matmul``) stays within the f32 limit (1e-4) of the
  JAX package's Pallas forward (interpret mode) at D 16/64/128, causal
  and not, Sq < Sk, and a single TF32 pass does not;
- index arithmetic: a host mirror of one warp's walk (S through
  ``mma_abt``'s fragments, the online softmax on the C fragments with a
  quad of four threads owning a row, each keeping its own share of the
  running sum, P fed to ``mma_cx`` straight from the S accumulators)
  reproduces softmax(QKᵀ)·V and the row log-sum-exp; and the block
  walk (query tiles of 64·MT rows, 32-key tiles to the causal edge, the
  per-warp skip) meets every kept (query, key) pair once.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle2_tpu.kernels.pallas_flash import _flash_fwd
from paddle2_tpu_torch.kernels import flash_attn as fa
from tests.test_torch_flash_bwd_tf32x3 import (MT, _lanes, _mma_abt,
                                               _mma_cx, _tile)
from tests.test_torch_flash_tc import (  # noqa: F401 (on_card: a fixture)
    _padded, _qkv, _tail, on_card)

TOL = 1e-4          # chip_smoke.TOL[torch.float32]
BKT = 32            # keys a step of the kernel


# ------------------------------------------------------------- routing

def test_f32_forward_reaches_the_tf32x3_entry(on_card):
    rec = on_card()
    q, k, v, _ = _qkv(torch.float32)
    before = fa.flash_fwd.launches, dict(fa.flash_fwd.route_launches)
    o, lse = fa.flash_fwd(q, k, v, scale=0.125, causal=True)
    [(name, entry, args)] = rec.calls
    assert (name, entry) == ("flash_fwd_tf32x3", "flash_fwd_tf32x3")
    assert _tail(args) == (2, 3, 40, 72, 64, 0, 0.125, 1)
    assert args[3:5] == (o.data_ptr(), lse.data_ptr())
    assert fa.flash_fwd.launches == before[0] + 1
    assert fa.flash_fwd.route_launches == dict(
        before[1], tf32x3=before[1]["tf32x3"] + 1)
    assert fa._LIBRARIES["flash_fwd_tf32x3"]["flash_fwd_tf32x3"] == \
        fa._LIBRARIES["flash_fwd_wgmma"]["flash_fwd_wgmma"]


def test_bf16_forward_counts_its_own_route(on_card):
    on_card()
    q, k, v, _ = _qkv(torch.bfloat16)
    before = dict(fa.flash_fwd.route_launches)
    fa.flash_fwd(q, k, v, causal=False)
    assert fa.flash_fwd.route_launches == dict(
        before, wgmma=before["wgmma"] + 1)
    assert set(fa.FWD_ROUTES.values()) == set(fa.flash_fwd.route_launches)


def test_f32_inputs_reach_cp_async_on_16_byte_boundaries(on_card):
    rec = on_card()
    B, H, S, D = 1, 2, 8, 16
    n = B * H * S * D
    buf = torch.randn(3 * n + 1)
    q, k, v = (buf[1 + i * n:1 + (i + 1) * n].view(B, H, S, D)
               for i in range(3))
    assert q.data_ptr() % 16 != 0 and q.is_contiguous()
    fa.flash_fwd(q, k, v, causal=True)
    fa.flash_fwd(*(t.clone() for t in (q, k, v)), causal=True)
    (_, _, moved), (_, _, kept) = rec.calls
    assert all(p % 16 == 0 for p in moved[:5])
    assert all(p % 16 == 0 for p in kept[:5])


def test_a_failing_tf32x3_forward_raises(on_card):
    rec = on_card(rc=1)
    q, k, v, _ = _qkv(torch.float32)
    before = fa.flash_fwd.launches, dict(fa.flash_fwd.route_launches)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        fa.flash_fwd(q, k, v, causal=True)
    assert (fa.flash_fwd.launches, fa.flash_fwd.route_launches) == before
    assert [c[1] for c in rec.calls] == ["flash_fwd_tf32x3"]


def test_the_smoke_reports_the_tensor_core_forward_in_its_own_row():
    """``chip_smoke.py``'s kernels line: the f32 forward has a row of its
    own (its source, the f32 row at the serving prefill's shape, its
    route's launches, the 3xTF32 bound); the wrapper's first row is the
    bf16 wgmma kernel, counting every route."""
    import chip_smoke as cs
    tc = cs.F32_TC_ROW["flash_fwd"]
    assert cs.KERNELS["flash_fwd"]["source"].endswith(
        "csrc/flash_fwd_wgmma.cu")
    assert "f32_source" not in cs.KERNELS["flash_fwd"]
    assert cs.KERNELS[tc]["source"].endswith("csrc/flash_fwd_tf32x3.cu")
    for key in ("replaces", "also_replaces"):
        assert cs.KERNELS[tc][key] == cs.KERNELS["flash_fwd"][key]
    assert cs.FLASH_KERNEL_NAMES["flash_fwd", torch.float32] == \
        "flash_fwd_tf32x3_kernel"
    cs.reset_counts()
    fa.flash_fwd.launches, fa.flash_fwd.route_launches["tf32x3"] = 5, 2
    assert (cs.counts()["flash_fwd"], cs.counts()[tc]) == (5, 2)
    cs.reset_counts()
    assert (cs.counts()["flash_fwd"], cs.counts()[tc]) == (0, 0)
    assert cs.launches_by_route("flash_fwd", {"flash_fwd": 9, tc: 4}) == \
        dict(tf32x3=4, wgmma=5)
    shape = cs.LINE_SHAPES[tc]
    rows = [dict(name=n, dtype=d, shape=shape) for d in ("bfloat16",
                                                         "float32")
            for n in ("flash_fwd", tc)]
    assert cs.line_row(rows, "flash_fwd")["dtype"] == "bfloat16"
    assert cs.line_row(rows, tc)["dtype"] == "float32"
    assert "flash_fwd_tf32x3" in cs.SERVING_KERNELS
    assert ("flash_fwd_tf32x3_kernel", 64) in {
        (k, i) for k, insts in cs.TF32_KERNELS["flash_fwd_tf32x3"].items()
        for i in insts}
    # B1 H16 S1024 D128 causal: three TF32 products per f32 product at
    # 494.7 TFLOP/s
    ops = 4 * cs.causal_pairs(1024, 1024) * 128 * 16
    assert 3 * ops / cs.TF32_OPS * 1e3 == pytest.approx(0.026, abs=5e-4)


# ------------------------------------------------------------ numerics

def _inputs(Sq, Sk, D, seed, B=1, H=2):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, Sq, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, H, Sk, D)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _pallas(q, k, v, scale, causal):
    """The Pallas forward (interpret mode) on inputs padded to its
    128-row tiles in a way that leaves the real rows' outputs alone
    (``test_torch_flash_tc._padded``); returns the real rows."""
    Sq, Sk = q.shape[2], k.shape[2]
    a, b = _padded(Sq, Sk, causal)
    padq = ((0, 0), (0, 0), (a, b), (0, 0))
    padk = ((0, 0), (0, 0), (0, b), (0, 0))
    o, lse = _flash_fwd(jnp.asarray(np.pad(q, padq)),
                        jnp.asarray(np.pad(k, padk)),
                        jnp.asarray(np.pad(v, padk)), scale, causal, 128,
                        128, True)
    rows = slice(a, a + Sq)
    return np.asarray(o)[:, :, rows], np.asarray(lse)[:, :, rows]


def _plain(q, k, v, scale, causal, passes):
    t = [torch.from_numpy(x) for x in (q, k, v)]
    return fa.flash_fwd_reference(
        *t, scale, causal, matmul=lambda a, b: fa.tf32_matmul(a, b, passes))


# without a mask no padding is exact, so the non-causal lengths are
# multiples of the Pallas tiles (the card's smoke takes ragged ones)
CASES = [(64, 64, True), (200, 333, True), (127, 129, True),
         (128, 256, False), (256, 384, False)]


@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("Sq,Sk,causal", CASES,
                         ids=[f"{a}-{b}-{'causal' if c else 'full'}"
                              for a, b, c in CASES])
def test_3xtf32_plain_forward_matches_pallas(Sq, Sk, causal, D):
    q, k, v = _inputs(Sq, Sk, D, seed=Sq * 13 + Sk + D + causal)
    scale = 1.0 / math.sqrt(D)
    o, lse = _plain(q, k, v, scale, causal, passes=3)
    jo, jlse = _pallas(q, k, v, scale, causal)
    np.testing.assert_allclose(o.numpy(), jo, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=TOL, atol=TOL)


# B1 H2 S 256 D 64 and 128, causal: 3xTF32 reads ~1e-6, one pass ~1e-3
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("passes", [1, 3])
def test_only_the_compensated_product_meets_the_f32_limit(passes, D):
    q, k, v = _inputs(256, 256, D, seed=11 + D)
    scale = 1.0 / math.sqrt(D)
    o, lse = _plain(q, k, v, scale, True, passes)
    jo, jlse = _pallas(q, k, v, scale, True)
    err = max(np.abs(o.numpy() - jo).max(), np.abs(lse.numpy() - jlse).max())
    if passes == 3:
        assert err <= TOL / 10, err
    else:
        assert err > TOL, err


# ----------------------------------------------------- index arithmetic

def _warp_forward(Q, K, V, scale, causal, row0, offset):
    """One warp of ``flash_fwd_tf32x3_kernel`` with one m16 row tile
    (rows row0 .. row0 + 15 of Q): 32-key tiles to the causal edge, S
    through ``mma_abt``, the online softmax on the C fragments (lane (g,
    t) holds rows g and g + 8 at keys 2t, 2t + 1 of each n-tile; the row
    max is the quad's, each lane keeps its own share of l), O through
    ``mma_cx`` from the P accumulators. Returns (o, lse) of the 16 rows
    as the kernel's epilogue writes them."""
    g, t = _lanes()
    Sq, Sk, D = Q.shape[0], K.shape[0], Q.shape[1]
    sA = np.zeros((16, D), np.float32)
    n = min(16, Sq - row0)
    sA[:n] = Q[row0:row0 + n]
    mx = np.full((32, 2), -np.inf)
    ls = np.zeros((32, 2))
    acc = np.zeros((D // 8, 32, 4))
    k_end = min(Sk, row0 + 16 + offset) if causal else Sk
    for k0 in range(0, k_end, BKT):
        sB = np.zeros((BKT, D), np.float32)
        sX = np.zeros((BKT, D), np.float32)
        m = min(BKT, Sk - k0)
        sB[:m], sX[:m] = K[k0:k0 + m], V[k0:k0 + m]
        s = _mma_abt(sA, sB, D, BKT // 8)            # [nj, 32, 4]
        for h in range(2):
            row = row0 + g + 8 * h
            vals = []
            for j in range(BKT // 8):
                for c in range(2):
                    key = k0 + 8 * j + 2 * t + c
                    ok = (row < Sq) & (key < Sk) & (
                        (not causal) | (key <= row + offset))
                    x = np.where(ok, s[j, :, 2 * h + c] * scale, -np.inf)
                    s[j, :, 2 * h + c] = x
                    vals.append(x)
            tile_max = np.max(vals, axis=0)
            quad = tile_max.reshape(8, 4).max(axis=1).repeat(4)
            m_new = np.maximum(mx[:, h], quad)
            safe = np.where(m_new == -np.inf, 0.0, m_new)
            alpha = np.where(mx[:, h] == -np.inf, 0.0,
                             np.exp(mx[:, h] - safe))
            rs = np.zeros(32)
            for j in range(BKT // 8):
                for c in range(2):
                    x = s[j, :, 2 * h + c]
                    p = np.where(x == -np.inf, 0.0, np.exp(x - safe))
                    s[j, :, 2 * h + c] = p
                    rs += p
            ls[:, h] = alpha * ls[:, h] + rs
            mx[:, h] = m_new
            acc[:, :, 2 * h] *= alpha
            acc[:, :, 2 * h + 1] *= alpha
        acc += _mma_cx(s.astype(np.float32), sX, D)
    l_row = ls.reshape(8, 4, 2).sum(axis=1)          # the quad's sum
    o, lse = _tile(acc), np.zeros(16)
    for h in range(2):
        l = l_row[:, h]
        safe_l = np.where(l == 0, 1.0, l)
        o[8 * h:8 * h + 8] /= safe_l[:, None]
        lse[8 * h:8 * h + 8] = np.where(l == 0, -np.inf,
                                        mx[::4, h] + np.log(safe_l))
    return o[:n], lse[:n]


@pytest.mark.parametrize("D,Sq,Sk,causal", [(16, 40, 72, True),
                                             (64, 16, 16, True),
                                             (64, 33, 50, False),
                                             (128, 20, 100, True)])
def test_warp_walk_reproduces_softmax_attention(D, Sq, Sk, causal):
    rng = np.random.default_rng(D + Sq + Sk)
    Q = rng.normal(size=(Sq, D)).astype(np.float32)
    K = rng.normal(size=(Sk, D)).astype(np.float32)
    V = rng.normal(size=(Sk, D)).astype(np.float32)
    scale, offset = 1.0 / math.sqrt(D), Sk - Sq
    S = Q.astype(np.float64) @ K.astype(np.float64).T * scale
    if causal:
        S = np.where(np.arange(Sk)[None] <= np.arange(Sq)[:, None] + offset,
                     S, -np.inf)
    P = np.exp(S - S.max(axis=1, keepdims=True))
    want_o = P @ V.astype(np.float64) / P.sum(axis=1, keepdims=True)
    want_lse = S.max(axis=1) + np.log(P.sum(axis=1))
    for row0 in range(0, Sq, 16):
        o, lse = _warp_forward(Q, K, V, scale, causal, row0, offset)
        rows = slice(row0, row0 + len(o))
        np.testing.assert_allclose(o, want_o[rows], rtol=0, atol=1e-5)
        np.testing.assert_allclose(lse, want_lse[rows], rtol=0, atol=1e-5)


def _block_walk(Sq, Sk, D, causal):
    """The kernel's visits (query tile, key tile, warp, row tile) with
    every (query, key) pair each visit covers: query tiles of 64·MT
    rows, the last first; 32-key tiles to the last row's reach; a warp
    skips a tile its rows lie past or its last row does not reach."""
    offset, bq = Sk - Sq, 64 * MT[D]
    pairs = np.zeros((Sq, Sk), dtype=int)
    nq = -(-Sq // bq)
    for y in range(nq):
        q0 = (nq - 1 - y) * bq
        k_end = min(Sk, q0 + bq + offset) if causal else Sk
        for k0 in range(0, k_end, BKT):
            for w in range(4):
                row_w = q0 + w * 16 * MT[D]
                if row_w >= Sq or (causal and
                                   k0 > row_w + 16 * MT[D] - 1 + offset):
                    continue
                for r in range(row_w, min(Sq, row_w + 16 * MT[D])):
                    for c in range(k0, min(Sk, k0 + BKT)):
                        if not causal or c <= r + offset:
                            pairs[r, c] += 1
    return pairs


@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("Sq,Sk,causal", [(200, 333, True), (200, 333, False),
                                          (127, 127, True), (129, 129, True),
                                          (1, 300, True)])
def test_block_walk_meets_every_kept_pair_once(D, Sq, Sk, causal):
    pairs = _block_walk(Sq, Sk, D, causal)
    keep = np.ones((Sq, Sk), dtype=bool)
    if causal:
        keep = np.arange(Sk)[None] <= np.arange(Sq)[:, None] + (Sk - Sq)
    np.testing.assert_array_equal(pairs, keep.astype(int))
