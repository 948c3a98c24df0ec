"""The f32 split flash backward on the tensor cores (3xTF32), held on the
CPU.

``flash_bwd_tf32x3.cu`` runs the split pair (dK/dV, then dQ) for f32 with
every product done as three TF32 products (small·big, big·small,
big·big). Here, without a card:

- routing, through the stand-in card of ``test_torch_flash_tc.py``: f32
  CUDA tensors reach ``flash_bwd_dkv_tf32x3`` then
  ``flash_bwd_dq_tf32x3`` with the old argument list; bf16 keeps
  ``flash_bwd.cu``'s CUDA-core pair; a failing entry raises;
- numerics: the plain backward with 3xTF32-emulated products
  (``flash_attn.tf32_matmul``) stays within the f32 limit (1e-4) of the
  JAX package's split Pallas kernels (interpret mode), and a single
  TF32 pass does not;
- index arithmetic: host mirrors of the kernels' fragment mapping (a
  C fragment taken as an A fragment with k permuted, B's rows 2t and
  2t + 1) and of their causal tile walks.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle2_tpu.kernels.pallas_flash import _flash_bwd
from paddle2_tpu_torch.kernels import flash_attn as fa
from tests.test_torch_flash_tc import _qkv, _tail, on_card  # noqa: F401

BWD_TOL = 1e-4          # chip_smoke.BWD_TOL[torch.float32]
SPLIT_BLOCK = 32        # Pallas blocks: several a side, so the split route


# ------------------------------------------------------------- routing

def _bwd_args(dtype):
    q, k, v, do = _qkv(dtype)
    return q, k, v, q, torch.zeros(2, 3, 40), do


@pytest.mark.parametrize("route", [None, "split"])
def test_f32_split_pair_reaches_the_tf32x3_entries(on_card, route):
    rec = on_card()
    pair = (fa.flash_bwd_split_dkv, fa.flash_bwd_split_dq)
    before = [(f.launches, dict(f.route_launches)) for f in pair]
    dq, dk, dv = fa.flash_bwd(*_bwd_args(torch.float32), scale=0.125,
                              causal=True, route=route)
    for f, (n, routes) in zip(pair, before):
        assert f.launches == n + 1
        assert f.route_launches == dict(routes, tf32x3=routes["tf32x3"] + 1)
    assert [c[:2] for c in rec.calls] == [
        ("flash_bwd_tf32x3", "flash_bwd_dkv_tf32x3"),
        ("flash_bwd_tf32x3", "flash_bwd_dq_tf32x3")]
    for _, _, args in rec.calls:
        assert _tail(args) == (2, 3, 40, 72, 64, 0, 0.125, 1)
    # dk, dv then dq: the pointers of the outputs it returns
    (_, _, dkv_args), (_, _, dq_args) = rec.calls
    assert dkv_args[6:8] == (dk.data_ptr(), dv.data_ptr())
    assert dq_args[6] == dq.data_ptr()
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.float32,) * 3


def test_tf32x3_entries_keep_the_cuda_core_signatures():
    lib = fa._LIBRARIES
    assert lib["flash_bwd_tf32x3"]["flash_bwd_dkv_tf32x3"] == \
        lib["flash_bwd"]["flash_bwd_dkv"]
    assert lib["flash_bwd_tf32x3"]["flash_bwd_dq_tf32x3"] == \
        lib["flash_bwd"]["flash_bwd_dq"]


def test_bf16_split_route_keeps_the_cuda_core_pair(on_card):
    rec = on_card()
    pair = (fa.flash_bwd_split_dkv, fa.flash_bwd_split_dq)
    before = [dict(f.route_launches) for f in pair]
    fa.flash_bwd(*_bwd_args(torch.bfloat16), route="split")
    assert [c[:2] for c in rec.calls] == [("flash_bwd", "flash_bwd_dkv"),
                                          ("flash_bwd", "flash_bwd_dq")]
    for f, routes in zip(pair, before):
        assert f.route_launches == dict(
            routes, cuda_cores=routes["cuda_cores"] + 1)


@pytest.mark.parametrize("which", ["dkv", "dq"])
def test_a_failing_tf32x3_entry_raises(on_card, which):
    rec = on_card(rc=1)
    q, k, v, _, lse, do = _bwd_args(torch.float32)
    delta = torch.zeros_like(lse)
    fn = fa.flash_bwd_split_dkv if which == "dkv" else fa.flash_bwd_split_dq
    before = fn.launches, dict(fn.route_launches)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        fn(q, k, v, do, lse, delta, 0.125, True)
    assert (fn.launches, fn.route_launches) == before
    assert [c[1] for c in rec.calls] == [f"flash_bwd_{which}_tf32x3"]


@pytest.mark.parametrize("which", ["dkv", "dq"])
def test_the_smoke_reports_the_tensor_core_kernel_in_its_own_row(which):
    """``chip_smoke.py``'s kernels line: the f32 tensor-core kernel has
    a row of its own (its source, the f32 row at the training shape,
    its route's launches, the 3xTF32 bound); the wrapper's first row is
    the bf16 CUDA-core kernel of ``flash_bwd.cu``."""
    import chip_smoke as cs
    base = f"flash_bwd_split_{which}"
    tc = cs.SPLIT_TF32X3[base]
    assert cs.KERNELS[base]["source"].endswith("csrc/flash_bwd.cu")
    assert "f32_source" not in cs.KERNELS[base]
    assert cs.KERNELS[tc]["source"].endswith("csrc/flash_bwd_tf32x3.cu")
    assert cs.KERNELS[tc]["replaces"] == cs.KERNELS[base]["replaces"]
    fn = getattr(fa, base)
    cs.reset_counts()
    fn.launches, fn.route_launches["tf32x3"] = 3, 2
    assert (cs.counts()[base], cs.counts()[tc]) == (3, 2)
    cs.reset_counts()
    assert (cs.counts()[base], cs.counts()[tc]) == (0, 0)
    # a main path's sums: the row's launches split by route
    assert cs.launches_by_route(base, {base: 12, tc: 8}) == dict(
        tf32x3=8, cuda_cores=4)
    shape = cs.LINE_SHAPES[tc]
    rows = [dict(name=n, dtype=d, shape=shape) for d in ("bfloat16",
                                                         "float32")
            for n in (base, tc)]
    assert cs.line_row(rows, base)["dtype"] == "bfloat16"
    assert cs.line_row(rows, tc)["dtype"] == "float32"
    # B8 H16 S1024 D64 causal: three TF32 products per f32 product at
    # 494.7 TFLOP/s, below the CUDA cores' bound
    pairs = 1024 * 1025 // 2
    ops = {"dkv": 8, "dq": 6}[which] * pairs * 64 * 16 * 8
    ms, by = cs.bwd_bound_3xtf32(base, 8, 16, 1024, 1024, 64, 4)
    assert by == "operations"
    assert ms == pytest.approx(3 * ops / 494.7e12 * 1e3)
    assert ms < cs.bwd_bound(base, 8, 16, 1024, 1024, 64, torch.float32,
                             4)[0]


def test_f32_inputs_reach_cp_async_on_16_byte_boundaries(on_card):
    """The kernels read q, k, v and dO in 16-byte chunks: a contiguous f32
    view that starts elsewhere is copied before the launch, and only
    then."""
    rec = on_card()
    B, H, S, D = 1, 2, 8, 16
    n = B * H * S * D
    buf = torch.randn(4 * n + 1)
    q, k, v, do = (buf[1 + i * n:1 + (i + 1) * n].view(B, H, S, D)
                   for i in range(4))
    assert q.data_ptr() % 16 != 0 and q.is_contiguous()
    lse = torch.zeros(B, H, S)
    fa.flash_bwd(q, k, v, q, lse, do, causal=True)
    assert len(rec.calls) == 2
    for _, _, args in rec.calls:
        assert all(p % 16 == 0 for p in args[:4])


# ------------------------------------------------------------ numerics

def test_tf32_round_is_round_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                  # TF32's step in [1, 2)
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2e-7,
                      one + 3 * ulp / 2, 0.0, -0.0, float("inf"),
                      float("-inf")])
    got = fa.tf32_round(x)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 0.0,
                         -0.0, float("inf"), float("-inf")])
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    assert torch.isnan(fa.tf32_round(torch.tensor([float("nan")]))).all()
    assert (got.view(torch.int32)[:6] & 0x1FFF == 0).all()


def test_tf32_split_keeps_f32_accuracy():
    """big is x rounded to TF32 (the kernel's integer add and mask), small
    the exact rest truncated to TF32 (what the tensor cores read of it):
    together within 2⁻²¹ of x."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4096, generator=g) * 100
    big, small = fa.tf32_split(x)
    for t in (big, small):
        assert (t.view(torch.int32) & 0x1FFF == 0).all()
    assert torch.equal(big, fa.tf32_round(x))
    rest = x.double() - big.double()
    assert (small.double().abs() <= rest.abs()).all()
    assert ((rest - small.double()).abs() <= rest.abs() * 2.0 ** -10).all()
    err = ((big.double() + small.double()) - x.double()).abs()
    assert (err <= x.double().abs() * 2.0 ** -21).all()
    assert not torch.equal(big, x)


def _pad(Sq, Sk, causal, tile=SPLIT_BLOCK):
    """Padding that brings (Sq, Sk) to multiples of ``tile`` without
    changing the real rows' gradients: (front query rows, end query rows,
    end keys). Causal: both ends by the same b keep Sk - Sq, a front pad
    a shifts rows and offset alike (``test_torch_flash_tc._padded``).
    Not causal: zero keys at the end get P > 0 but meet dO·0 = 0 and a
    zero K row, so no real gradient moves."""
    if causal:
        b = (-Sk) % tile
        return (-(Sq + b)) % tile, b, b
    return 0, (-Sq) % tile, (-Sk) % tile


def _inputs(Sq, Sk, D, seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(1, 2, Sq, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(1, 2, Sk, D)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def _pallas_split(q, k, v, o, lse, do, scale, causal):
    """The JAX package's split backward (``_bwd_dkv_kernel``,
    ``_bwd_dq_kernel``, interpret mode) on padded copies, cut back."""
    Sq, Sk = q.shape[2], k.shape[2]
    a, bq, bk = _pad(Sq, Sk, causal)
    rows = ((0, 0), (0, 0), (a, bq), (0, 0))
    keys = ((0, 0), (0, 0), (0, bk), (0, 0))
    jq, jo, jdo = (jnp.asarray(np.pad(t, rows)) for t in (q, o, do))
    jk, jv = (jnp.asarray(np.pad(t, keys)) for t in (k, v))
    jlse = jnp.asarray(np.pad(lse, ((0, 0), (0, 0), (a, bq)),
                              constant_values=-np.inf))
    assert jq.shape[2] > SPLIT_BLOCK or jk.shape[2] > SPLIT_BLOCK
    dq, dk, dv = _flash_bwd(jq, jk, jv, jo, jlse, jdo, scale, causal,
                            SPLIT_BLOCK, SPLIT_BLOCK, True)
    return (np.asarray(dq)[:, :, a:a + Sq], np.asarray(dk)[:, :, :Sk],
            np.asarray(dv)[:, :, :Sk])


def _plain(q, k, v, do, scale, causal, passes):
    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, do))
    o, lse = fa.flash_fwd_reference(tq, tk, tv, scale, causal)
    got = fa.flash_bwd_reference(
        tq, tk, tv, o, lse, tdo, scale, causal,
        matmul=lambda x, y: fa.tf32_matmul(x, y, passes))
    return got, o.numpy(), lse.numpy()


CASES = [(S, S) for S in (63, 64, 65, 127, 129)] + [(40, 129), (65, 127)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("Sq,Sk", CASES, ids=[f"{a}-{b}" for a, b in CASES])
def test_3xtf32_plain_backward_matches_pallas_split(Sq, Sk, D, causal):
    q, k, v, do = _inputs(Sq, Sk, D, seed=Sq * 31 + Sk + D + causal)
    scale = 1.0 / math.sqrt(D)
    got, o, lse = _plain(q, k, v, do, scale, causal, passes=3)
    want = _pallas_split(q, k, v, o, lse, do, scale, causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=BWD_TOL, atol=BWD_TOL)


def _scaled_err(got, want):
    """chip_smoke.check_flash_bwd's error: absolute below 1, relative
    above."""
    return max(float((np.abs(g.numpy() - w) / np.maximum(np.abs(w), 1.0))
                     .max()) for g, w in zip(got, want))


# B1 H2 Sq 256 Sk 256 D64, causal: 3xTF32 reads ~1e-6, one TF32 pass ~1e-3
GUARD_SHAPE = (256, 256, 64)


@pytest.mark.parametrize("passes", [1, 3])
def test_only_the_compensated_product_meets_the_f32_limit(passes):
    Sq, Sk, D = GUARD_SHAPE
    q, k, v, do = _inputs(Sq, Sk, D, seed=7)
    scale = 1.0 / math.sqrt(D)
    got, o, lse = _plain(q, k, v, do, scale, True, passes)
    err = _scaled_err(got, _pallas_split(q, k, v, o, lse, do, scale, True))
    if passes == 3:
        assert err <= BWD_TOL / 10, err
    else:
        assert err > BWD_TOL, err


# ----------------------------------------------------- index arithmetic

def _lanes():
    lane = np.arange(32)
    return lane // 4, lane % 4


def _mma(c, a, b):
    """One mma.sync.m16n8k8 (tf32, f32 sums) on per-lane fragments, as
    the PTX ISA lays them out: a [32, 4] (a0 (g, t), a1 (g+8, t), a2 (g,
    t+4), a3 (g+8, t+4)), b [32, 2] (b0 (t, g), b1 (t+4, g)), c [32, 4]
    (c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1))."""
    g, t = _lanes()
    A, B, C = np.zeros((16, 8)), np.zeros((8, 8)), np.zeros((16, 8))
    for i, (r, col) in enumerate(((g, t), (g + 8, t), (g, t + 4),
                                  (g + 8, t + 4))):
        A[r, col] = a[:, i]
    B[t, g], B[t + 4, g] = b[:, 0], b[:, 1]
    for i, (r, col) in enumerate(((g, 2 * t), (g, 2 * t + 1),
                                  (g + 8, 2 * t), (g + 8, 2 * t + 1))):
        C[r, col] = c[:, i]
    D = C + A @ B
    return np.stack([D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t],
                     D[g + 8, 2 * t + 1]], axis=1)


def _split(x):
    big, small = fa.tf32_split(torch.as_tensor(x, dtype=torch.float32))
    return big.double().numpy(), small.double().numpy()


def _mma3(c, a, b):
    """``flash_bwd_tf32x3.cu`` ``mma3``: small·big, big·small, big·big."""
    (ab, as_), (bb, bs) = _split(a), _split(b)
    return _mma(_mma(_mma(c, as_, bb), ab, bs), ab, bb)


def _mma_abt(sA, sB, D, nj):
    """``mma_abt``: the warp's acc[j] = A B_jᵀ, A 16 rows, B_j rows
    8j..8j+7, both K-major with D columns."""
    g, t = _lanes()
    acc = np.zeros((nj, 32, 4))
    for kk in range(0, D, 8):
        a = np.stack([sA[g, kk + t], sA[g + 8, kk + t], sA[g, kk + t + 4],
                      sA[g + 8, kk + t + 4]], axis=1)
        for j in range(nj):
            b = np.stack([sB[8 * j + g, kk + t], sB[8 * j + g, kk + t + 4]],
                         axis=1)
            acc[j] = _mma3(acc[j], a, b)
    return acc


def _mma_cx(c, sX, D):
    """``mma_cx``: acc[n] += C X_n with C's k-step j the C fragment c[j]
    taken as (c0, c2, c1, c3), and b0 = X[8j + 2t][8n + g], b1 =
    X[8j + 2t + 1][8n + g]."""
    g, t = _lanes()
    acc = np.zeros((D // 8, 32, 4))
    for j in range(c.shape[0]):
        a = c[j][:, [0, 2, 1, 3]]
        for n in range(D // 8):
            b = np.stack([sX[8 * j + 2 * t, 8 * n + g],
                          sX[8 * j + 2 * t + 1, 8 * n + g]], axis=1)
            acc[n] = _mma3(acc[n], a, b)
    return acc


def _tile(acc):
    """The 16 x 8·len(acc) matrix a warp's C fragments hold."""
    g, t = _lanes()
    out = np.zeros((16, 8 * len(acc)))
    for j, c in enumerate(acc):
        out[g, 8 * j + 2 * t], out[g, 8 * j + 2 * t + 1] = c[:, 0], c[:, 1]
        out[g + 8, 8 * j + 2 * t], out[g + 8, 8 * j + 2 * t + 1] = \
            c[:, 2], c[:, 3]
    return out


@pytest.mark.parametrize("D,rows", [(16, 32), (64, 32), (128, 32),
                                    (64, 64)])
def test_fragment_mapping_reproduces_the_matmuls(D, rows):
    """S = A Bᵀ through ``mma_abt``, then (S ∘ W) X through ``mma_cx``
    reading S's accumulators as A fragments: both equal the plain
    products to 3xTF32's accuracy, so the k permutation of C → A and
    B's rows 2t, 2t + 1 agree."""
    rng = np.random.default_rng(D + rows)
    A = rng.normal(size=(16, D)).astype(np.float32)
    Bm = rng.normal(size=(rows, D)).astype(np.float32)
    X = rng.normal(size=(rows, D)).astype(np.float32)
    acc = _mma_abt(A, Bm, D, rows // 8)
    S = A.astype(np.float64) @ Bm.astype(np.float64).T
    np.testing.assert_allclose(_tile(acc), S, rtol=0, atol=1e-5 * np.sqrt(D))
    C = _tile(acc.astype(np.float32).astype(np.float64))
    np.testing.assert_allclose(_tile(_mma_cx(acc.astype(np.float32), X, D)),
                               C @ X.astype(np.float64), rtol=0,
                               atol=1e-5 * np.abs(C).max() * np.sqrt(rows))


def test_single_tf32_pass_in_the_mirror_would_miss_the_limit():
    """The same mirror with one TF32 product misses 3xTF32's accuracy by
    orders of magnitude: the three-term sum is what keeps f32."""
    rng = np.random.default_rng(5)
    A = rng.normal(size=(16, 64)).astype(np.float32)
    Bm = rng.normal(size=(64, 64)).astype(np.float32)
    g, t = _lanes()
    acc1 = np.zeros((8, 32, 4))
    for kk in range(0, 64, 8):
        a = _split(np.stack([A[g, kk + t], A[g + 8, kk + t],
                             A[g, kk + t + 4], A[g + 8, kk + t + 4]], 1))[0]
        for j in range(8):
            b = _split(np.stack([Bm[8 * j + g, kk + t],
                                 Bm[8 * j + g, kk + t + 4]], 1))[0]
            acc1[j] = _mma(acc1[j], a, b)
    S = A.astype(np.float64) @ Bm.astype(np.float64).T
    err1 = np.abs(_tile(acc1) - S).max()
    err3 = np.abs(_tile(_mma_abt(A, Bm, 64, 8)) - S).max()
    assert err1 > 100 * err3 and err1 > 1e-3


# the kernels' tiles: m16 row tiles a warp (MT), dK/dV blocks of 64·MT keys
# stepping 32 query rows, dQ blocks of 64·MT rows stepping 32 keys
MT = {16: 2, 64: 2, 128: 1}
DKV_BQ = BKD = 32


def _dkv_walk(Sq, Sk, D, causal):
    """The dK/dV kernel's visits, (query tile, key tile, warp): key tile
    ``y`` walks from ``qt0 = (k0 - offset) // 32`` when that is
    positive; a warp computes a tile only if its first key is below Sk
    and within the tile's last row's reach."""
    offset, nq, bk = Sk - Sq, -(-Sq // DKV_BQ), 64 * MT[D]
    out = set()
    for kt in range(-(-Sk // bk)):
        k0 = kt * bk
        qt0 = (k0 - offset) // DKV_BQ if causal and k0 - offset > 0 else 0
        assert qt0 < nq
        for qt in range(qt0, nq):
            for w in range(4):
                key_w = k0 + w * 16 * MT[D]
                reach = qt * DKV_BQ + DKV_BQ - 1 + offset
                if key_w < Sk and (not causal or key_w <= reach):
                    out.add((qt, kt, w))
    return out


def _dq_walk(Sq, Sk, D, causal):
    """The dQ kernel's visits: query tile ``gridDim.y - 1 - y`` walks key
    tiles up to ``min(Sk, q0 + 64·MT + offset)``; a warp computes a tile
    only if its first row is below Sq and its last row reaches the
    tile's first key."""
    offset, bq = Sk - Sq, 64 * MT[D]
    nq = -(-Sq // bq)
    out = []
    for y in range(nq):
        qt = nq - 1 - y
        q0 = qt * bq
        k_end = min(Sk, q0 + bq + offset) if causal else Sk
        for kt in range(-(-k_end // BKD)):
            for w in range(4):
                row_w = q0 + w * 16 * MT[D]
                reach = row_w + 16 * MT[D] - 1 + offset
                if row_w < Sq and (not causal or kt * BKD <= reach):
                    out.append((qt, kt, w))
    assert len(out) == len(set(out))
    return set(out)


def _live(Sq, Sk, causal, rows, cols, warp_rows, by_row):
    """(row tile, column tile, warp) triples whose pairs the mask keeps
    at least once, and those whose pairs are all kept and in range (the
    kernels skip the mask there). The warps split the row side of the
    dQ kernel (``by_row``) and the key side of the dK/dV kernel."""
    r = np.arange(Sq)[:, None]
    c = np.arange(Sk)[None, :]
    keep = (c <= r + Sk - Sq) if causal else np.ones((Sq, Sk), bool)
    live, full = set(), set()
    for qt in range(-(-Sq // rows)):
        for kt in range(-(-Sk // cols)):
            for w in range(4):
                if by_row:
                    r0, c0 = qt * rows + w * warp_rows, kt * cols
                    blk = keep[r0:r0 + warp_rows, c0:c0 + cols]
                    shape = (warp_rows, cols)
                else:
                    r0, c0 = qt * rows, kt * cols + w * warp_rows
                    blk = keep[r0:r0 + rows, c0:c0 + warp_rows]
                    shape = (rows, warp_rows)
                if blk.any():
                    live.add((qt, kt, w))
                if blk.shape == shape and blk.all():
                    full.add((qt, kt, w))
    return live, full


def _edge(r0, c0, rows, cols, Sq, Sk, causal):
    """The kernels' ``edge`` flag for a warp's (rows x cols) block at
    (r0, c0): the mask applies somewhere in it."""
    return (r0 + rows > Sq or c0 + cols > Sk
            or (causal and c0 + cols - 1 > r0 + Sk - Sq))


WALKS = [(1, 1), (63, 64), (64, 64), (65, 65), (127, 129), (200, 333),
         (1, 333), (129, 1024), (1024, 1024), (333, 333)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("Sq,Sk", WALKS, ids=[f"{a}-{b}" for a, b in WALKS])
@pytest.mark.parametrize("D", [16, 64, 128])
def test_tile_walks_visit_exactly_the_live_tiles(D, Sq, Sk, causal):
    """Every (tile, warp) a kernel computes holds a kept pair, every kept
    pair lies in one it computes, and the mask is skipped only where
    every pair is kept."""
    wr = 16 * MT[D]
    live, full = _live(Sq, Sk, causal, DKV_BQ, 64 * MT[D], wr, False)
    assert _dkv_walk(Sq, Sk, D, causal) == live
    for qt, kt, w in live:
        assert _edge(qt * DKV_BQ, kt * 64 * MT[D] + w * wr, DKV_BQ, wr, Sq,
                     Sk, causal) == ((qt, kt, w) not in full)
    live, full = _live(Sq, Sk, causal, 64 * MT[D], BKD, wr, True)
    assert _dq_walk(Sq, Sk, D, causal) == live
    for qt, kt, w in live:
        assert _edge(qt * 64 * MT[D] + w * wr, kt * BKD, wr, BKD, Sq, Sk,
                     causal) == ((qt, kt, w) not in full)
