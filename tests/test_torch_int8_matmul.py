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

import contextlib
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
    """Each split is whole 64-row stages (at least two where K has
    them), the splits cover K and none is empty; K is split only when
    the output tiles fill fewer than the SMs, into at most about two
    waves of blocks."""
    per, splits = i8i8_split(M, K, N, sms)
    steps = -(-K // 64)
    assert per % 64 == 0 and per >= 64 * min(2, steps)
    assert (splits - 1) * per < K <= splits * per
    tiles = -(-M // (16 if M <= 16 else 64)) * -(-N // 128)
    if tiles >= sms:
        assert splits == 1
    else:
        assert tiles * splits <= max(2 * sms + tiles, tiles)


class _StandInLibrary:
    """Records the C entries' arguments in place of the built library."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        return lambda *args: self.calls.append((entry, args)) or 0


@pytest.mark.parametrize("M,K,N", [(8, 2048, 6144), (1008, 2048, 2048)])
def test_wrapper_reaches_its_c_entry(monkeypatch, M, K, N):
    """With the wrapper told its tensors are on the card, ``int8_matmul``
    calls ``i8i8_matmul`` once with the operands' and the output's
    pointers, M, K, N and the K split of :func:`i8i8_split`, on an
    output of zeros when K is split; one launch is counted and the plain
    version does not run."""
    lib = _StandInLibrary()
    monkeypatch.setattr(_build, "on_card", lambda what, *t: True)
    monkeypatch.setattr(_build, "library", lambda name, sigs: lib)
    monkeypatch.setattr(qm, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(qm, "int8_matmul_reference",
                        lambda *a: pytest.fail("the plain version ran"))
    x = torch.ones(M, K, dtype=torch.int8)
    w = torch.ones(K, N, dtype=torch.int8)
    before = int8_matmul.launches
    y = int8_matmul(x, w)
    assert int8_matmul.launches == before + 1
    per, splits = i8i8_split(M, K, N, 132)
    assert (splits > 1) == (M == 8)
    assert lib.calls == [("i8i8_matmul", (x.data_ptr(), w.data_ptr(),
                                          y.data_ptr(), M, K, N, per, None))]
    assert y.dtype == torch.int32 and tuple(y.shape) == (M, N)
    if splits > 1:
        assert not y.any()


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
