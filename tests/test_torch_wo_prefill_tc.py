"""The int8 weight-only prefill on the tensor cores in TF32
(``wo_gemm_tf32_kernel`` in ``paddle2_tpu_torch/kernels/csrc/wo_matmul.cu``),
on the CPU, where no card runs it:

- exactness: every int8 value, every int4 value and every bf16 value is
  exact in TF32 (``flash_attn.tf32_round``), so w needs no split and a
  bf16 x one pass;
- numerics: the kernel's product on f32 x, ``x_small·w + x_big·w``
  emulated on the host, is within the f32 limit (1e-4, scaled as
  ``chip_smoke.check_wo`` scales it) of ``int8_weight_only_matmul_reference``
  at M 17, 144 and 1008; one TF32 pass is not;
- the plain version against the JAX package's ``_wo_pallas`` in
  interpret mode, in f32;
- index arithmetic: a host mirror of the kernel's fragment maps (the
  n map that makes B's values of four n-tiles one 32-bit word, the A
  fragments of its two m16 row tiles, the C fragments' eight
  neighbouring columns) walked over a block's 8 warps, at both of its
  tiles (f32 32 x 512, bf16 128 x 128), meets every (m, k, n)
  product of the tile once and stores every output once; the split
  partial tiles' sum across a cluster takes every output once;
- the tile and K-split plan (``quant_matmul.gemm_tile``,
  ``gemm_k_split``): whole 32-row k-steps covering K once, at most 8
  splits at any K, and the blocks filling the card at M 32, 144 and 1008
  for every GPT-3 1.3B projection; a host model of the kernel's k loop,
  whose accumulators go into a second sum every 64 k-steps, takes every
  row of a split once and no accumulator more than 2048 rows;
- the wrapper's path to the C entry through a stand-in library
  (``tests/test_torch_int8_matmul.py``'s ``wo_card`` fixture): the plan
  reaches the entry, no workspace, and a launch error raises.

Tolerances: the mirror's sums of small integers are exact in float64 and
compared exactly; its f32 sums against float64 to 2⁻²¹ per product.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle2_tpu.kernels import pallas_matmul as pm
from paddle2_tpu_torch.kernels import flash_attn as fa
from paddle2_tpu_torch.kernels import quant_matmul as qm
from tests.test_torch_flash_bwd_tf32x3 import _lanes, _mma, _split
from test_torch_int8_matmul import wo_card  # noqa: F401 (the fixture)

TOL = 1e-4            # chip_smoke.TOL[torch.float32]
BK = 32               # csrc/wo_matmul.cu: rows of K a k-step
DTYPES = (torch.float32, torch.bfloat16)   # tiles 32 x 512, 128 x 128
CHUNK = 64            # k-steps an mma accumulator takes (2048 rows)
SMS = 132             # an H100's SMs
RESIDENT = 2 * SMS    # wo_gemm_blocks_per_sm reads 2 on an H100
PROJECTIONS = {"qkv": (2048, 6144), "out_proj": (2048, 2048),
               "up": (2048, 8192), "down": (8192, 2048)}


# ------------------------------------------------------------ exactness
def _exact_in_tf32(x):
    return bool(torch.equal(fa.tf32_round(x), x))


def test_every_int8_and_int4_value_is_exact_in_tf32():
    assert _exact_in_tf32(torch.arange(-128, 128).float())
    assert _exact_in_tf32(torch.arange(-8, 8).float())
    assert _exact_in_tf32(qm.unpack_int4(qm.pack_int4(
        torch.arange(-8, 8, dtype=torch.int8).repeat(2)), 32).float())


def test_every_bf16_value_is_exact_in_tf32():
    """All 65,536 bf16 bit patterns widened to f32 (NaNs aside) are their
    own TF32 rounding: a bf16 x needs one TF32 pass."""
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16).float()
    keep = ~torch.isnan(x)
    assert int(keep.sum()) > 65000
    assert _exact_in_tf32(x[keep])


# ------------------------------------------------------------- numerics
def _scaled(got, ref):
    """chip_smoke.check_wo's error: absolute below 1, relative above."""
    return float(((got - ref).abs() / ref.abs().clamp_min(1.0)).max())


def _wo_inputs(M, K, N, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(M, K, generator=g)
    w8, s8 = qm.quantize_channelwise(torch.randn(K, N, generator=g) * 0.02)
    b = torch.randn(N, generator=g) * 0.02
    return x, w8, s8, b


def _two_pass(x, w8, s8, b):
    """The kernel's arithmetic on f32 x: x split once into big (rounded
    to TF32) and small (the rest, truncated to TF32 by the tensor cores),
    each product x_small·w + x_big·w summed in f32, then the epilogue."""
    big, small = fa.tf32_split(x)
    acc = small @ w8.float() + big @ w8.float()
    return acc * (s8 / 127.0) + b


@pytest.mark.parametrize("M", [17, 144, 1008])
def test_two_passes_meet_the_f32_limit_and_one_does_not(M):
    x, w8, s8, b = _wo_inputs(M, 512, 256, seed=M)
    ref = qm.int8_weight_only_matmul_reference(x, w8, s8, b)
    two = _scaled(_two_pass(x, w8, s8, b), ref)
    assert two <= TOL / 10, two
    # the same through the plain version's matmul= hook, as the smoke
    # computes its gate: w is exact, so three passes are the kernel's two
    three = qm.int8_weight_only_matmul_reference(
        x, w8, s8, b, matmul=lambda a, c: fa.tf32_matmul(a, c, 3))
    assert _scaled(three, ref) <= TOL / 10
    one = qm.int8_weight_only_matmul_reference(
        x, w8, s8, b, matmul=lambda a, c: fa.tf32_matmul(a, c, 1))
    assert _scaled(one, ref) > TOL


@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("M,K,N", [(32, 256, 256), (144, 512, 256),
                                   (256, 256, 384)])
def test_plain_matches_pallas_kernel_interpret_in_f32(M, K, N, with_bias):
    """The plain version (the card's oracle for the TF32 kernel) against
    ``_wo_pallas`` in interpret mode, f32 x, two blocks a side."""
    rs = np.random.RandomState(M + K + N)
    x = rs.randn(M, K).astype(np.float32)
    w_i8, scale = pm.quantize_channelwise(
        jnp.asarray(rs.randn(K, N).astype(np.float32)), 8, axis=1)
    b = rs.randn(N).astype(np.float32) if with_bias else None
    ref = pm.int8_weight_only_matmul(
        jnp.asarray(x), w_i8, scale, None if b is None else jnp.asarray(b),
        block_m=M // 2, block_n=N // 2, block_k=K // 2, interpret=True)
    assert pm.wo_supported(M, K, N, M // 2, N // 2, K // 2)
    got = qm.int8_weight_only_matmul_reference(
        torch.from_numpy(x), torch.from_numpy(np.asarray(w_i8)),
        torch.from_numpy(np.asarray(scale)),
        None if b is None else torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


# ----------------------------------------------------- index arithmetic
def _warp_tile(X, W, wm, wn, passes):
    """One warp of ``gemm_step`` over one k-step: X the block's x tile
    [rows, BK], W its w tile [BK, columns]. Returns the warp's C fragments
    acc[mt][4q + j] ([32 lanes, 4]). B's (k t + 4h, n g) of n-tile j of
    group q is byte j of the word at row t + 4h, columns 32q + 4g ..
    32q + 4g + 3 of the warp's 64; A's fragment of row tile mt is the PTX
    one at rows 32 wm + 16 mt (+ 8), columns kk + t (+ 4)."""
    g, t = _lanes()
    acc = np.zeros((2, 8, 32, 4))
    for kk in range(0, BK, 8):
        for mt in range(2):
            r0 = 32 * wm + 16 * mt
            a = np.stack([X[r0 + g, kk + t], X[r0 + g + 8, kk + t],
                          X[r0 + g, kk + t + 4], X[r0 + g + 8, kk + t + 4]],
                         axis=1)
            big, small = _split(a)
            for q in range(2):
                for j in range(4):
                    col = 64 * wn + 32 * q + 4 * g + j
                    b = np.stack([W[kk + t, col], W[kk + t + 4, col]], 1)
                    if passes == 2:
                        acc[mt, 4 * q + j] = _mma(acc[mt, 4 * q + j], small,
                                                  b)
                    acc[mt, 4 * q + j] = _mma(acc[mt, 4 * q + j],
                                              big if passes == 2 else a, b)
    return acc


def _store(acc, wm, wn, out, count):
    """The epilogue's map: row 32 wm + 16 mt + g + 8h, columns 64 wn +
    32q + 8t + j (c0/c2 of n-tile 4q + j) and + 4 + j (c1/c3)."""
    g, t = _lanes()
    for mt in range(2):
        for h in range(2):
            row = 32 * wm + 16 * mt + g + 8 * h
            for q in range(2):
                for j in range(4):
                    c = acc[mt, 4 * q + j]
                    for e, col in ((2 * h, 64 * wn + 32 * q + 8 * t + j),
                                   (2 * h + 1,
                                    64 * wn + 32 * q + 8 * t + 4 + j)):
                        out[row, col] += c[:, e]
                        count[row, col] += 1


def _block(X, W, passes, dtype):
    """A block's 8 warps at x's ``dtype``'s tile, warp w at (w % warps_m,
    w // warps_m), warps_m = rows / 32."""
    bm, bn = qm.gemm_tile(dtype)
    warps_m = bm // 32
    assert X.shape == (bm, BK) and W.shape == (BK, bn)
    out, count = np.zeros((bm, bn)), np.zeros((bm, bn), dtype=int)
    for warp in range(8):
        wm, wn = warp % warps_m, warp // warps_m
        _store(_warp_tile(X, W, wm, wn, passes), wm, wn, out, count)
    return out, count


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_fragment_maps_take_every_product_once(dtype):
    """Integer x and w: every sum is exact in float64, so the block's
    tile equals X @ W only if each (m, k, n) product is taken once; and
    each output is stored by exactly one thread."""
    bm, bn = qm.gemm_tile(dtype)
    assert bm * bn == 128 * 128
    rng = np.random.default_rng(bm)
    X = rng.integers(-8, 8, size=(bm, BK)).astype(np.float64)
    W = rng.integers(-128, 128, size=(BK, bn)).astype(np.float64)
    out, count = _block(X, W, 1, dtype)
    assert (count == 1).all()
    np.testing.assert_array_equal(out, X @ W)


def test_two_pass_fragments_keep_f32_accuracy_and_one_pass_does_not():
    BM, BN = qm.gemm_tile(torch.float32)
    rng = np.random.default_rng(1)
    X = rng.normal(size=(BM, BK)).astype(np.float32)
    W = rng.integers(-127, 128, size=(BK, BN)).astype(np.float64)
    exact = X.astype(np.float64) @ W
    bound = np.abs(X).astype(np.float64) @ np.abs(W) * 2.0 ** -20
    two, _ = _block(X, W, 2, torch.float32)
    assert (np.abs(two - exact) <= bound).all()
    one, _ = _block(_split(X)[0], W, 1, torch.float32)
    assert np.abs(one - exact).max() > 100 * np.abs(two - exact).max()


@pytest.mark.parametrize("splits", list(range(1, 9)))
def test_cluster_sum_takes_every_output_once(splits):
    """The split finish: rank r adds float4 o = 4 (tid + 256 (r + S i))
    of the tile (16,384 outputs at either tile) over all S ranks; every
    output once."""
    outputs = 128 * 128
    seen = np.zeros(outputs, dtype=int)
    for r in range(splits):
        for tid in range(256):
            o = 4 * (tid + 256 * r)
            while o < outputs:
                seen[o:o + 4] += 1
                o += 4 * 256 * splits
    assert (seen == 1).all()


# ------------------------------------------------------------- the plan
def _covers(K, per, splits):
    """Every row of K taken once by the splits' k loops, and no mma
    accumulator taking more than CHUNK k-steps: the kernel's loop over
    step i of a split adds its accumulators into the second sum after
    step i when (i + 1) % CHUNK == 0 and steps remain."""
    rows = np.zeros(K, dtype=int)
    for z in range(splits):
        kbeg, kend = z * per, min(K, (z + 1) * per)
        assert kbeg < kend
        steps = -(-(kend - kbeg) // BK)
        run = 0
        for i in range(steps):
            k0 = kbeg + i * BK
            rows[k0:min(kend, k0 + BK)] += 1
            run += 1
            assert run <= CHUNK
            if steps > CHUNK and (i + 1) % CHUNK == 0 and i + 1 < steps:
                run = 0
    return (rows == 1).all()


@pytest.mark.parametrize("label", list(PROJECTIONS))
@pytest.mark.parametrize("M", [32, 144, 1008])
def test_split_plan_covers_k_once_and_fills_the_card(M, label):
    K, N = PROJECTIONS[label]
    bm, bn = qm.gemm_tile(torch.float32)
    per, splits = qm.gemm_k_split(M, K, N, RESIDENT, torch.float32)
    tiles = (-(-M // bm)) * (-(-N // bn))
    assert per % BK == 0 and 1 <= splits <= 8
    assert _covers(K, per, splits)
    assert splits == 1 or per >= 256
    blocks = tiles * splits
    # the card is filled (one block an SM at least, within 10 %) as far as
    # the 8-way cap and the 256-row floor let it, and a split never pushes
    # the blocks past one wave
    assert blocks >= 0.9 * SMS or splits == 8 or per < 2 * 256
    assert splits == 1 or blocks <= RESIDENT


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("M,K,N", [
    (37, 16416, 333), (144, 20484, 333), (1008, 20480, 2048),
    (128, 65536, 2048), (32, 131072, 8192)])
def test_split_plan_takes_any_k_in_at_most_8_splits(M, K, N, dtype):
    """Past 8 x 2048 rows the plan still asks for at most 8 splits (the
    cluster's limit, which the C entry refuses past); the kernel's k loop
    keeps each accumulator within 2048 rows."""
    per, splits = qm.gemm_k_split(M, K, N, RESIDENT, dtype)
    assert per % BK == 0 and 1 <= splits <= 8
    assert _covers(K, per, splits)


def test_split_plan_at_the_named_shapes():
    """The docstring's cases: M 128 down 8 ways of 1024 rows; M 1008 up
    not at all, down 2 ways; a short K keeps 256-row splits."""
    f32, bf16 = DTYPES
    assert qm.gemm_k_split(128, 8192, 2048, RESIDENT) == (1024, 8)
    assert qm.gemm_k_split(128, 8192, 2048, RESIDENT, bf16) == (1024, 8)
    assert qm.gemm_k_split(1008, 2048, 8192, RESIDENT) == (2048, 1)
    assert qm.gemm_k_split(1008, 2048, 8192, RESIDENT, bf16) == (2048, 1)
    assert qm.gemm_k_split(1008, 8192, 2048, RESIDENT, f32) == (4096, 2)
    assert qm.gemm_k_split(32, 512, 2048, RESIDENT) == (256, 2)
    assert qm.gemm_k_split(37, 200, 333, RESIDENT, bf16) == (224, 1)


# ----------------------------------------------------------- the wrapper
def test_the_tile_follows_the_dtype():
    assert [qm.gemm_tile(d) for d in DTYPES] == [(32, 512), (128, 128)]


@pytest.mark.parametrize("M,K,N,dtype", [
    (1008, 2048, 8192, torch.float32), (128, 8192, 2048, torch.float32),
    (32, 2048, 6144, torch.float32), (37, 200, 333, torch.bfloat16)])
def test_prefill_calls_reach_the_entry_with_the_plan(wo_card, M, K, N,
                                                     dtype):
    x = torch.zeros(M, K, dtype=dtype)
    w = torch.zeros(K, N, dtype=torch.int8)
    s = torch.ones(N)
    before = qm.int8_weight_only_matmul.route_launches["gemm"]
    y = qm.int8_weight_only_matmul(x, w, s)
    (lib, entry, args), = wo_card
    assert (lib, entry) == ("wo_matmul", "wo_gemm_tf32")
    assert args[5:9] == (M, K, N, qm.gemm_k_split(M, K, N, 396, dtype)[0])
    assert args[9:11] == (127.0, qm._DTYPE_CODE[dtype])
    assert qm.int8_weight_only_matmul.route_launches["gemm"] == before + 1
    assert y.dtype == dtype and tuple(y.shape) == (M, N)


def test_a_failing_prefill_launch_raises(monkeypatch, wo_card):
    class Failing:
        def __getattr__(self, entry):
            if entry == "error_string":
                return lambda err: b"stand-in launch failure"
            return lambda *args: 719
    monkeypatch.setattr(qm._build, "library", lambda name, sigs: Failing())
    x = torch.zeros(144, 2048)
    before = qm.int8_weight_only_matmul.route_launches["gemm"]
    with pytest.raises(RuntimeError, match="CUDA error 719"):
        qm.int8_weight_only_matmul(x, torch.zeros(2048, 2048,
                                                  dtype=torch.int8),
                                   torch.ones(2048))
    assert qm.int8_weight_only_matmul.route_launches["gemm"] == before


def test_the_entries_are_declared():
    assert qm._SIGNATURES["wo_gemm_blocks_per_sm"] == [ctypes.c_int,
                                                       ctypes.c_void_p]
    sig = qm._SIGNATURES["wo_gemm_tf32"]
    assert len(sig) == 12 and sig[9] is ctypes.c_float
    assert qm._ENTRIES["gemm"] == "wo_gemm_tf32"


def test_the_smoke_names_every_instantiation():
    """``chip_smoke.tf32_instance`` reads x's type (which sets the tile)
    and the 16-byte copies from the kernel's mangled names: f32 x with
    16-byte or element-wise copies of x and w, bf16 x element-wise with
    either w. They are the instantiations its SASS check requires, the
    model's path among them."""
    import chip_smoke as cs
    tail = "EEEvPKT_PKaPKfS3_PS1_iiiif"
    names = {cs.tf32_instance(f"_ZN12_GLOBAL__N_119wo_gemm_tf32_kernelI{t}"
                              f"Lb{xv}ELb{wv}{tail}")
             for t, xvs in (("f", (0, 1)), ("13__nv_bfloat16", (0,)))
             for xv in xvs for wv in (0, 1)}
    want = cs.TF32_KERNELS["wo_matmul"]["wo_gemm_tf32_kernel"]
    assert len(want) == 6
    assert names == {("wo_gemm_tf32_kernel", i) for i in want}
    assert [p for p in cs.TF32_MAIN_PATH
            if p[0] == "wo_gemm_tf32_kernel"] == [(
                "wo_gemm_tf32_kernel", "f32 32x512 x16 w16")]
    assert cs.TF32_MAIN_PATH[0] in names
