"""``paddle2_tpu_torch``'s random ops (``ops/random.py``) and RNG state
(``framework/random.py``). JAX draws from threefry keys, so values are
never held against the JAX package's: each op's shape and dtype are, and
then determinism under ``seed``, the ``get_rng_state`` /
``set_rng_state`` round trip, and the moments of each distribution over
many draws (limits several standard errors wide)."""

import numpy as np
import pytest
import torch

import paddle2_tpu as jp
import paddle2_tpu_torch as tp
from torch_core_harness import port_on_cpu  # noqa: F401

from torch_core_table_random import DRAWS


def _conv(a, side):
    if isinstance(a, np.ndarray):
        return jp.to_tensor(a) if side == "jax" else tp.to_tensor(a)
    return a


def _dtype(t):
    return str(t.dtype).rpartition(".")[2] if isinstance(t, torch.Tensor) \
        else np.dtype(t.dtype).name


@pytest.mark.parametrize("op,a,kw", DRAWS,
                         ids=[f"{d[0]}-{i}" for i, d in enumerate(DRAWS)])
def test_draw_shape_dtype_and_seed(op, a, kw):
    j = getattr(jp, op)(*[_conv(x, "jax") for x in a], **kw)
    tp.seed(7)
    t1 = getattr(tp, op)(*[_conv(x, "torch") for x in a], **kw)
    assert tuple(t1.shape) == tuple(j.shape)
    assert _dtype(t1) == _dtype(j)
    assert t1.device.type == "cpu"
    tp.seed(7)
    t2 = getattr(tp, op)(*[_conv(x, "torch") for x in a], **kw)
    assert torch.equal(t1, t2)


@pytest.mark.parametrize("op,args,kwargs", [
    ("uniform_", (-1.0, 2.0), {}), ("normal_", (0.5, 2.0), {}),
    ("exponential_", (2.0,), {}), ("cauchy_", (0.0, 1.0), {}),
    ("geometric_", (0.3,), {}), ("bernoulli_", (0.3,), {}),
    ("log_normal_", (0.0, 0.5), {})])
def test_in_place_fills(op, args, kwargs):
    x = tp.zeros([3, 4])
    tp.seed(3)
    out = getattr(tp, op)(x, *args, **kwargs)
    assert out is x and x.dtype == torch.float32
    first = x.clone()
    tp.seed(3)
    getattr(tp, op)(x, *args, **kwargs)
    assert torch.equal(x, first)
    jx = jp.zeros([3, 4])
    jout = getattr(jp, op)(jx, *args, **kwargs)
    assert tuple(jout.shape) == tuple(x.shape)


def test_rng_state_round_trip_replays():
    tp.seed(11)
    tp.rand([4])
    state = tp.get_rng_state()
    a = tp.randn([5])
    b = tp.randint(0, 100, [5])
    tp.set_rng_state(state)
    assert torch.equal(tp.randn([5]), a)
    assert torch.equal(tp.randint(0, 100, [5]), b)


def test_seed_leaves_torch_default_generator_alone():
    torch.manual_seed(0)
    want = torch.rand(3)
    torch.manual_seed(0)
    tp.seed(123)
    tp.rand([10])
    assert torch.equal(torch.rand(3), want)


N = 200_000


def _moments(t):
    a = t.double()
    return float(a.mean()), float(a.var())


@pytest.mark.parametrize("name,draw,mean,var", [
    ("rand", lambda: tp.rand([N]), 0.5, 1 / 12),
    ("randn", lambda: tp.randn([N]), 0.0, 1.0),
    ("uniform", lambda: tp.uniform([N], min=-1.0, max=3.0), 1.0, 16 / 12),
    ("normal", lambda: tp.normal(2.0, 3.0, [N]), 2.0, 9.0),
    ("log_normal", lambda: tp.log_normal(0.0, 0.5, [N]),
     np.exp(0.125), (np.exp(0.25) - 1) * np.exp(0.25)),
    ("randint", lambda: tp.randint(0, 10, [N]), 4.5, 99 / 12),
    ("poisson", lambda: tp.poisson(tp.full([N], 3.0)), 3.0, 3.0),
    ("bernoulli", lambda: tp.bernoulli(tp.full([N], 0.3)), 0.3, 0.21),
    ("binomial", lambda: tp.binomial(tp.full([N], 10, dtype="int32"),
                                     tp.full([N], 0.3)), 3.0, 2.1),
    ("standard_gamma", lambda: tp.standard_gamma(tp.full([N], 2.0)),
     2.0, 2.0),
    ("exponential_", lambda: tp.exponential_(tp.zeros([N]), 2.0),
     0.5, 0.25),
    ("geometric_", lambda: tp.geometric_(tp.zeros([N]), 0.25), 4.0, 12.0),
    ("randperm", lambda: tp.randperm(1000), 499.5, (1000 ** 2 - 1) / 12),
])
def test_moments(name, draw, mean, var):
    tp.seed(2024)
    m, v = _moments(draw())
    n = 1000 if name == "randperm" else N
    assert abs(m - mean) < 6 * np.sqrt(var / n) + 1e-9, (m, mean)
    assert abs(v - var) < 0.05 * var, (v, var)


def test_multinomial_frequencies_and_top_p():
    tp.seed(5)
    probs = tp.to_tensor(np.array([0.1, 0.2, 0.7], np.float32))
    draws = tp.multinomial(probs, 20000, replacement=True)
    freq = np.bincount(draws.numpy(), minlength=3) / 20000
    np.testing.assert_allclose(freq, [0.1, 0.2, 0.7], atol=0.02)
    # nucleus: with ps 0.75 the two largest (0.7, 0.2) are kept
    x = tp.to_tensor(np.tile([[0.1, 0.2, 0.7]], (4000, 1)).astype(
        np.float32))
    ids, none = tp.top_p_sampling(x, tp.full([4000], 0.75))
    assert none is None and ids.shape == (4000, 1) and ids.dtype == \
        torch.int32
    jids, _ = jp.top_p_sampling(jp.to_tensor(x.numpy()[:2]),
                                jp.full([2], 0.75))
    assert tuple(jids.shape) == (2, 1) and np.dtype(jids.dtype).name == \
        "int32"
    freq = np.bincount(ids.reshape(-1).numpy(), minlength=3) / 4000
    assert freq[0] == 0 and abs(freq[2] - 0.7 / 0.9) < 0.03
    a, _ = tp.top_p_sampling(x[:8], tp.full([8], 0.75), seed=9)
    b, _ = tp.top_p_sampling(x[:8], tp.full([8], 0.75), seed=9)
    assert torch.equal(a, b)
