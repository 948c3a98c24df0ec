"""The port's int8 x int8 matmul and the rest of the ``pallas_matmul``
surface (paddle2_tpu_torch.kernels.quant_matmul) held against the JAX
package on the same numpy inputs, on the CPU, where each wrapper runs its
plain version.

Tolerances: the int32 products are compared bitwise (``np.array_equal``):
every product of the plain version's f32 chunks is an integer of at most
2**24 in magnitude, so the sums are exact. The int4 weight-only product
is held to f32 rtol/atol 1e-5 (the two frameworks sum in different
orders); ``fp8_matmul`` to f32 rtol 1e-6 / atol 1e-4, NaN where JAX has
NaN (its operands are exact in f32, only the order of the sums differs).
The nibble packers are compared bitwise."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle2_tpu.kernels import pallas_matmul as pm
from paddle2_tpu_torch.kernels import _build
from paddle2_tpu_torch.kernels import quant_matmul as qm
from paddle2_tpu_torch.kernels.quant_matmul import (
    i8i8_split, int4_weight_only_matmul, int8_matmul, pack_int4,
    quantize_channelwise, unpack_int4, weight_quant_error_bound)


def _int8(rs, *shape, lo=-128, hi=127):
    return rs.randint(lo, hi + 1, size=shape).astype(np.int8)


def _port(x, w):
    out = int8_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert out.dtype == torch.int32
    return out.numpy()


# ------------------------------------------------------------------ int8
@pytest.mark.parametrize("M,K,N", [(32, 128, 128), (64, 256, 256),
                                   (32, 1152, 128)])
def test_plain_matches_pallas_kernel_interpret(M, K, N):
    """The plain version against ``_i8i8_kernel`` run in interpret mode
    (32 x 128 x 128 blocks), on random int8 operands with -128 in them;
    K 1152 spans two of the plain version's 1024-row chunks."""
    rs = np.random.RandomState(M + K + N)
    x, w = _int8(rs, M, K), _int8(rs, K, N)
    ref = pm.int8_matmul(jnp.asarray(x), jnp.asarray(w), block_m=32,
                         block_n=128, block_k=128, interpret=True)
    assert np.array_equal(_port(x, w), np.asarray(ref))


@pytest.mark.parametrize("M,K,N", [(3, 200, 333), (17, 1030, 5),
                                   (1, 2500, 7), (9, 31, 1)])
def test_plain_matches_xla_route_ragged(M, K, N):
    rs = np.random.RandomState(M * K + N)
    x, w = _int8(rs, M, K), _int8(rs, K, N)
    ref = pm.int8_matmul(jnp.asarray(x), jnp.asarray(w))
    assert np.array_equal(_port(x, w), np.asarray(ref))


@pytest.mark.parametrize("value", [127, -127, -128])
def test_largest_sums_are_exact(value):
    """All-+-127 (and -128) operands at K 4096 reach the largest sums
    of the path's shapes: 4096 * 127**2 and 4096 * 128**2, against the
    Pallas kernel in interpret mode; signs alternate over the columns."""
    K = 4096
    x = np.full((32, K), value, np.int8)
    w = np.full((K, 128), value, np.int8)
    w[:, 1::2] = -127
    ref = pm.int8_matmul(jnp.asarray(x), jnp.asarray(w), block_m=32,
                         block_n=128, block_k=128, interpret=True)
    got = _port(x, w)
    assert np.array_equal(got, np.asarray(ref))
    assert got[0, 0] == K * value * value


def test_sums_past_int32_wrap_as_xla():
    """Past K = 131,072 the int32 sum wraps; the plain version's int32
    adds of exact f32 chunks wrap to the integers XLA gives."""
    for K in (131072, 131073):
        x = np.full((1, K), -128, np.int8)
        w = np.full((K, 2), -128, np.int8)
        ref = pm.int8_matmul(jnp.asarray(x), jnp.asarray(w))
        assert np.array_equal(_port(x, w), np.asarray(ref))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(4, 8, dtype=torch.int8)
    w = torch.zeros(8, 3, dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        int8_matmul(x.float(), w)
    with pytest.raises(ValueError, match="2-D"):
        int8_matmul(x[None], w)
    with pytest.raises(ValueError, match="differ in K"):
        int8_matmul(x, w[:7])
    with pytest.raises(ValueError, match="device"):
        int8_matmul(x, w.to("meta"))


@pytest.mark.parametrize("M,K,N", [(1, 2048, 6144), (8, 2048, 2048),
                                   (8, 8192, 2048), (8, 2048, 50304),
                                   (1008, 2048, 2048), (3, 200, 333),
                                   (40, 64, 128), (5, 1, 1)])
@pytest.mark.parametrize("sms", [132, 16])
def test_split_covers_k_in_whole_stages(M, K, N, sms):
    """The kernel the shape takes splits K into whole stages that cover it
    once, none empty, at most 8 (a tile's splits are one cluster): the
    prefill kernel (``i8i8_split``) into 128-row stages, at least four a
    split, only as far as its blocks fit one wave (half the SMs for
    clusters of 4 and 8); the decode kernel
    (``i8i8_mma_split``) into 128-row runs, as far as the tiles times the
    splits stay within two blocks an SM."""
    if qm.i8i8_route(M, K, N) == "wgmma":
        per, splits = i8i8_split(M, K, N, sms)
        assert per % 128 == 0 and (splits == 1 or per >= 4 * 128)
        tiles = -(-M // 128) * -(-N // qm.i8i8_tile_n(M, K, N, sms))
        assert splits == 1 or tiles * splits <= (
            sms if splits <= 2 else sms // 2)
    else:
        per, splits = qm.i8i8_mma_split(M, K, N, sms)
        assert per % 128 == 0
        tiles = -(-N // 128) * -(-M // (8 if M <= 8 else 16))
        assert splits == 1 or tiles * splits <= 2 * sms
    assert 1 <= splits <= 8
    assert (splits - 1) * per < K <= splits * per


class _StandInLibrary:
    """Records the C entries' arguments in place of the built library."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        return lambda *args: self.calls.append((entry, args)) or 0


@pytest.mark.parametrize("M,K,N", [(8, 2048, 6144), (1008, 2048, 2048)])
def test_wrapper_reaches_its_c_entry(monkeypatch, M, K, N):
    """With the wrapper told its tensors are on the card, ``int8_matmul``
    calls one C entry once, with the operands' and the output's pointers,
    M, K, N, its plan (the decode kernel's split at M 8, the prefill
    kernel's tile width and split at M 1008) and the stream, on an output
    that is not zeroed (the K splits add through distributed shared
    memory); one launch is counted and the plain version does not run."""
    lib = _StandInLibrary()
    monkeypatch.setattr(_build, "on_card", lambda what, *t: True)
    monkeypatch.setattr(_build, "library", lambda name, sigs: lib)
    monkeypatch.setattr(qm, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(qm, "_I8_PLANS", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(qm, "_raw_stream", lambda index: None)
    monkeypatch.setattr(qm, "int8_matmul_reference",
                        lambda *a: pytest.fail("the plain version ran"))
    x = torch.ones(M, K, dtype=torch.int8)
    w = torch.ones(K, N, dtype=torch.int8)
    before = int8_matmul.launches
    y = int8_matmul(x, w)
    assert int8_matmul.launches == before + 1
    ptrs = (x.data_ptr(), w.data_ptr(), y.data_ptr(), M, K, N)
    if M == 8:
        per, splits = qm.i8i8_mma_split(M, K, N, 132)
        assert splits > 1
        assert lib.calls == [("i8i8_gemv_mma", ptrs + (per, None))]
    else:
        per, splits = i8i8_split(M, K, N, 132)
        assert lib.calls == [("i8i8_wgmma", ptrs + (
            qm.i8i8_tile_n(M, K, N, 132), per, None))]
    assert y.dtype == torch.int32 and tuple(y.shape) == (M, N)


# ------------------------------------------------- weight-only routes
@pytest.fixture
def wo_card(monkeypatch):
    """``int8_weight_only_matmul`` told its tensors are on the card, the
    built libraries replaced by a recorder of (library, entry,
    arguments), 396 decode blocks a wave, and the plain version failing
    if it runs."""
    calls = []

    class StandIn:
        def __init__(self, name):
            self.name = name

        def __getattr__(self, entry):
            return lambda *args: calls.append((self.name, entry, args)) or 0
    monkeypatch.setattr(_build, "on_card", lambda what, *t: True)
    monkeypatch.setattr(_build, "library", lambda name, sigs: StandIn(name))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(qm, "_raw_stream", lambda index: None)
    monkeypatch.setattr(qm, "_resident", lambda *a: 396)
    monkeypatch.setattr(qm, "_PLANS", {})
    monkeypatch.setattr(qm, "int8_weight_only_matmul_reference",
                        lambda *a: pytest.fail("the plain version ran"))
    return calls


def _wo_operands(M, K, N, dtype, bias=True):
    x = torch.zeros(M, K, dtype=dtype)
    w = torch.zeros(K, N, dtype=torch.int8)
    s = torch.ones(N)
    return x, w, s, torch.zeros(N, dtype=dtype) if bias else None


def _counts():
    f = qm.int8_weight_only_matmul
    return f.launches, dict(f.route_launches)


def test_bf16_prefill_reaches_the_tensor_core_entry(wo_card):
    """A bf16 call at M 1008 calls ``wo_matmul_wgmma`` once with the
    operands' and the output's pointers, M, K, N and qmax, and counts one
    launch in the total and in the "wgmma" route; an x that starts off a
    16-byte boundary reaches it as an aligned copy."""
    x, w, s, b = _wo_operands(1008, 2048, 2048, torch.bfloat16)
    total, routes = _counts()
    y = qm.int8_weight_only_matmul(x, w, s, b)
    assert wo_card == [("wo_matmul_wgmma", "wo_matmul_wgmma", (
        x.data_ptr(), w.data_ptr(), s.data_ptr(), b.data_ptr(),
        y.data_ptr(), 1008, 2048, 2048, 127.0, None))]
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (1008, 2048)
    routes["wgmma"] += 1
    assert _counts() == (total + 1, routes)
    buf = torch.zeros(1008 * 2048 + 1, dtype=torch.bfloat16)
    view = buf[1:].view(1008, 2048)
    assert view.data_ptr() % 16
    qm.int8_weight_only_matmul(view, w, s, quant_bits=4)
    ptr, qmax = wo_card[-1][2][0], wo_card[-1][2][8]
    assert ptr % 16 == 0 and ptr != view.data_ptr() and qmax == 7.0


@pytest.mark.parametrize("M,N,dtype,route", [
    (1008, 2048, torch.float32, "gemm"),    # f32 prefill: the TF32 GEMM
    (8, 2048, torch.float32, "gemv"),       # f32 decode
    (1008, 336 - 3, torch.bfloat16, "gemm"),  # rows past TMA's rule
])
def test_other_calls_keep_the_cuda_core_entry(wo_card, M, N, dtype, route):
    """The f32 calls and a bf16 N off TMA's 16-byte rule reach the
    tensor-core kernels' own entries in the ``wo_matmul`` library. f32
    decode: ``wo_gemv_tf32`` (the TF32 decode kernel) with pointers, M, K, N, the
    K split of ``tf32_k_split``, qmax and the stream. f32 prefill and the
    bf16 row: ``wo_gemm_tf32`` with pointers, M, K, N, the K split, qmax,
    the dtype code (which sets the tile). Neither takes a workspace: the
    K splits of a tile add through distributed shared memory. The route's
    count moves."""
    K = 2048
    x, w, s, b = _wo_operands(M, K, N, dtype)
    total, routes = _counts()
    y = qm.int8_weight_only_matmul(x, w, s, b)
    assert qm.wo_route(M, K, N, dtype) == route
    (lib, entry, args), = wo_card
    assert args[:5] == (x.data_ptr(), w.data_ptr(), s.data_ptr(),
                        b.data_ptr(), y.data_ptr())
    if route == "gemm":
        assert (lib, entry) == ("wo_matmul", "wo_gemm_tf32")
        assert args[5:] == (M, K, N, qm.gemm_k_split(M, K, N, 396, dtype)[0],
                            127.0, qm._DTYPE_CODE[dtype], None)
    else:
        assert (lib, entry) == ("wo_matmul", "wo_gemv_tf32")
        assert args[5:] == (M, K, N, qm.tf32_k_split(M, K, N, 396)[0],
                            127.0, None)
    routes[route] += 1
    assert _counts() == (total + 1, routes)


def test_the_route_comes_from_shape_and_dtype():
    assert [qm.wo_route(M, K, N, torch.bfloat16) for M, K, N in (
        (8, 2048, 8192), (9, 2048, 8192), (1008, 200, 336),
        (1008, 204, 336), (1008, 200, 344), (32, 2048, 50304))] == \
        ["gemv_mma", "wgmma", "wgmma", "gemm", "gemm", "wgmma"]
    assert qm.wo_route(1008, 2048, 8192, torch.float32) == "gemm"
    assert set(qm.WO_ROUTES) == set(qm.int8_weight_only_matmul.route_launches)


# csrc/wo_matmul_wgmma.cu's tiling, by its index arithmetic
_BM, _BN, _BK = 128, 128, 64


def _wgmma_cover(M, K, N):
    """How often the kernel's blocks, warpgroups, threads and k16 steps
    reach each row, column and K index, and whether each reaches only
    indices TMA fills with zeros past the edge: grid (ceil(M / 128),
    ceil(N / 128)); warpgroup wg's thread (warp w, lane l) holds rows
    m0 + 64 wg + 16 (w % 4) + l / 4 + 8 h and columns n0 + 64 cb + 8 j +
    2 (l % 4) + e; K-step i's k16 step kk covers i * 64 + 16 kk ..
    + 15. The epilogue stores rows < M and columns < N."""
    gx, gy, n_k = -(-M // _BM), -(-N // _BN), -(-K // _BK)
    rows = np.array([bx * _BM + wg * 64 + (w % 4) * 16 + lane // 4 + 8 * h
                     for bx in range(gx) for wg in range(2)
                     for w in range(4) for lane in range(0, 32, 4)
                     for h in range(2)])
    cols = np.array([by * _BN + 64 * cb + 8 * j + 2 * (lane % 4) + e
                     for by in range(gy) for cb in range(2)
                     for j in range(8) for lane in range(4)
                     for e in range(2)])
    ks = np.array([i * _BK + 16 * kk + t for i in range(n_k)
                   for kk in range(4) for t in range(16)])
    stored = lambda idx, n: np.bincount(idx[idx < n], minlength=n)
    return stored(rows, M), stored(cols, N), stored(ks, K), (
        rows.max() < gx * _BM and cols.max() < gy * _BN
        and ks.max() < n_k * _BK)


@pytest.mark.parametrize("N", [336, 2048, 8192])
@pytest.mark.parametrize("K", [200, 2048, 8192])
@pytest.mark.parametrize("M", [32, 37, 1008])
def test_tensor_core_tiling_covers_every_product_once(M, K, N):
    """Every (m, n, k) of the product is summed exactly once: each row
    and each column is stored by one thread once, and each k lies in one
    k16 step of one K-step; the indices past M, N or K that the tiles
    reach stay inside the boxes TMA fills with zeros. Since each block
    takes every K-step of its tile, the three covers multiply."""
    rows, cols, ks, inside = _wgmma_cover(M, K, N)
    assert (rows == 1).all() and (cols == 1).all() and (ks == 1).all()
    assert inside


def test_widened_tile_is_the_layout_wgmma_reads():
    """The widening's stores (thread tid's 16-byte chunks tid and tid +
    256, each two bf16 chunks at (2 c16 + e) % 8 ^ (r % 8) of column
    block c16 / 4) land every element (k, n) of a 64 x 128 int8 tile
    where the MN-major 128-byte-swizzled descriptor reads it: column
    block n / 64, row k, chunk (n % 64) / 8 ^ (k % 8), element n % 8."""
    tile = np.arange(64 * 128).reshape(64, 128)
    smem = np.full(2 * 64 * 64, -1)
    for tid in range(256):
        for j in range(2):
            g = tid + 256 * j
            r, c16 = g // 8, g % 8
            vals = tile.reshape(-1)[g * 16:g * 16 + 16]
            for e in range(2):
                chunk = (2 * c16 + e) % 8
                at = (c16 // 4) * 64 * 64 + r * 64 + (chunk ^ (r % 8)) * 8
                smem[at:at + 8] = vals[8 * e:8 * e + 8]
    k, n = np.meshgrid(np.arange(64), np.arange(128), indexing="ij")
    read = smem[(n // 64) * 64 * 64 + k * 64 + ((n % 64) // 8 ^ (k % 8)) * 8
                + n % 8]
    assert np.array_equal(read, tile)


def test_widening_maps_every_int8_value_to_its_exact_bf16():
    """The widening's bit arithmetic (``wo::i8x4_to_f32``: flip the sign
    bit, place the byte in the low mantissa of 2**23, subtract 2**23 +
    128; then round to bf16 pairs), mirrored in torch for all 256 int8
    values: each lands on its exact bf16 value, lower column in the low
    half of the packed word."""
    b = torch.arange(-128, 128, dtype=torch.int32)
    u = (b & 0xFF) ^ 0x80
    f = (u | 0x4B000000).view(torch.float32) - 8388736.0
    bf = f.to(torch.bfloat16)
    assert torch.equal(bf.float(), b.float())
    assert torch.equal(bf, b.to(torch.bfloat16))
    bits = bf.view(torch.int16).to(torch.int32) & 0xFFFF
    word = bits[0::2] | (bits[1::2] << 16)
    assert torch.equal(word & 0xFFFF, bits[0::2])
    assert torch.equal((word >> 16) & 0xFFFF, bits[1::2])


def test_cpu_call_launches_no_kernel():
    before = int8_matmul.launches
    int8_matmul(torch.ones(2, 3, dtype=torch.int8),
                torch.ones(3, 4, dtype=torch.int8))
    assert int8_matmul.launches == before


# ------------------------------------------------------------------ int4
@pytest.mark.parametrize("shape", [(6, 8), (3, 5, 10), (4, 2)])
def test_pack_unpack_bitwise_jax(shape):
    rs = np.random.RandomState(len(shape))
    w_q = _int8(rs, *shape, lo=-8, hi=7)
    packed = pack_int4(torch.from_numpy(w_q))
    j_packed = np.asarray(pm.pack_int4(jnp.asarray(w_q)))
    assert packed.dtype == torch.uint8
    assert np.array_equal(packed.numpy(), j_packed)
    n = shape[-1]
    for keep in (n, n - 1):
        got = unpack_int4(packed, keep)
        ref = np.asarray(pm.unpack_int4(jnp.asarray(j_packed), keep))
        assert got.dtype == torch.int8
        assert np.array_equal(got.numpy(), ref)
    assert np.array_equal(unpack_int4(packed, n).numpy(), w_q)


def test_pack_int4_refuses_an_odd_count_as_jax():
    w_q = np.zeros((3, 5), np.int8)
    with pytest.raises(ValueError, match="even"):
        pm.pack_int4(jnp.asarray(w_q))
    with pytest.raises(ValueError, match="even"):
        pack_int4(torch.from_numpy(w_q))


@pytest.mark.parametrize("with_bias", [False, True])
def test_int4_weight_only_matmul_matches_jax(with_bias):
    rs = np.random.RandomState(11)
    x = rs.randn(2, 5, 64).astype(np.float32)
    w = rs.randn(64, 96).astype(np.float32)
    b = rs.randn(96).astype(np.float32) if with_bias else None
    w_i4, s4 = pm.quantize_channelwise(jnp.asarray(w), 4, axis=1)
    packed = pm.pack_int4(w_i4)
    ref = pm.int4_weight_only_matmul(
        jnp.asarray(x), packed, s4, bias=None if b is None else
        jnp.asarray(b))
    got = int4_weight_only_matmul(
        torch.from_numpy(x), torch.from_numpy(np.array(packed)),
        torch.from_numpy(np.array(s4)),
        None if b is None else torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_int4_error_bound_holds_and_a_two_bit_payload_breaks_it():
    """The int4 gate of the JAX bench (serving-throughput): the 4-bit
    product stays within ``weight_quant_error_bound(x, s, 4)`` of the f64
    product, a 2-bit payload breaks that bound, and the bound is below
    ``max |x @ W|``."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(32, 64)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(64, 128)).astype(np.float32))
    w_i4, s4 = quantize_channelwise(w, 4, axis=1)
    y4 = int4_weight_only_matmul(x, pack_int4(w_i4), s4).double()
    y_ref = x.double() @ w.double()
    bound4 = weight_quant_error_bound(x, s4, 4).double()
    assert bool(((y4 - y_ref).abs() <= bound4 + 1e-6).all())
    w_i2, s2 = quantize_channelwise(w, 2, axis=1)
    y2 = qm.int8_weight_only_matmul(x, w_i2, s2, quant_bits=2).double()
    assert bool(((y2 - y_ref).abs() > bound4).any())
    assert bound4.max() < y_ref.abs().max()


def test_wo_supported_is_the_jax_arithmetic():
    for m, k, n in [(256, 512, 256), (8, 2048, 6144), (1000, 2048, 2048),
                    (3, 200, 333), (512, 1024, 100)]:
        assert qm.wo_supported(m, k, n) == pm.wo_supported(m, k, n)
        assert qm.wo_supported(m, k, n, 8, 128, 128) == \
            pm.wo_supported(m, k, n, 8, 128, 128)
    assert (qm.DEFAULT_BLOCK_M, qm.DEFAULT_BLOCK_N, qm.DEFAULT_BLOCK_K) == \
        (pm.DEFAULT_BLOCK_M, pm.DEFAULT_BLOCK_N, pm.DEFAULT_BLOCK_K)


# ------------------------------------------------------------------- fp8
@pytest.mark.parametrize("lead", [(), (2,)])
def test_fp8_matmul_matches_jax(lead):
    """Operands spread over e4m3's range and past it: 450 and 460 round
    to 448, 470 and 1e4 are NaN in XLA's cast, and so in the port's."""
    assert qm.fp8_supported() and pm.fp8_supported()
    rs = np.random.RandomState(5)
    x = (rs.randn(*lead, 6, 16) * 50).astype(np.float32)
    w = (rs.randn(16, 9) * 3).astype(np.float32)
    x.reshape(-1, 16)[0, :4] = [450.0, -460.0, 470.0, 1e4]
    w[5, 2] = 500.0
    ref = np.asarray(pm.fp8_matmul(jnp.asarray(x), jnp.asarray(w)))
    got = qm.fp8_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32
    assert np.isnan(ref).any()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-4)


def test_fp8_matmul_keeps_x_dtype():
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(0))
    out = qm.fp8_matmul(x.bfloat16(), torch.ones(8, 2))
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["allgather_matmul", "matmul_allgather",
                                  "collective_matmul_traffic"])
def test_collective_matmuls_wait_for_queue_items(name):
    with pytest.raises(NotImplementedError, match="item 6.*item 4"):
        getattr(qm, name)(None, None, "mp")


def test_public_names_are_the_jax_modules():
    assert set(pm.__all__) <= set(qm.__all__)
