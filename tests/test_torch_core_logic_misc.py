"""``paddle2_tpu_torch``'s comparison, logic and search ops
(``ops/logic.py``) and the rest of the surface (``ops/misc.py``) against
the JAX package's on the CPU (see ``torch_core_harness``)."""

import numpy as np
import pytest
import torch

import paddle2_tpu as jp
import paddle2_tpu_torch as tp
from torch_core_harness import port_on_cpu  # noqa: F401
from torch_core_harness import cases_params, run_case
from torch_core_table_logic_misc import CASES


@pytest.mark.parametrize("case,dtype", cases_params(CASES))
def test_logic_misc_op(case, dtype):
    run_case(case, dtype)


def test_is_tensor():
    assert tp.is_tensor(torch.zeros(1)) and not tp.is_tensor(np.zeros(1))
    assert jp.is_tensor(jp.zeros([1])) and not jp.is_tensor(np.zeros(1))


def test_index_fill_in_place():
    a = np.arange(12, dtype=np.float32).reshape(4, 3)
    j = jp.index_fill_(jp.to_tensor(a), jp.to_tensor(np.array([1, 3])), 0,
                       -1.0)
    t0 = tp.to_tensor(a)
    t = tp.index_fill_(t0, tp.to_tensor(np.array([1, 3])), 0, -1.0)
    assert t is t0
    np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy()))


def test_dtype_names():
    assert isinstance(torch.float32, tp.dtype)
    assert not isinstance("float32", tp.dtype)
    assert tp.dtype("float32") is torch.float32
    assert tp.dtype("int64") is torch.int32
    assert tp.float8_e4m3fn is torch.float8_e4m3fn
    assert tp.float8_e5m2 is torch.float8_e5m2
    assert np.dtype(jp.float8_e4m3fn).name == "float8_e4m3fn"


def test_places_and_small_utilities():
    assert tp.to_tensor([1.0], place=tp.CUDAPinnedPlace()).device.type == \
        "cpu"
    assert repr(tp.CUDAPinnedPlace()) == repr(jp.CUDAPinnedPlace())
    with tp.LazyGuard() as g:
        assert isinstance(g, tp.LazyGuard)
    assert tp.disable_signal_handler() is None

    def reader():
        yield from range(5)
    assert list(tp.batch(reader, 2)()) == list(jp.batch(reader, 2)())
    assert list(tp.batch(reader, 2, drop_last=True)()) == \
        list(jp.batch(reader, 2, drop_last=True)())
    before = torch._tensor_str.PRINT_OPTS.precision
    try:
        tp.set_printoptions(precision=2)
        assert torch._tensor_str.PRINT_OPTS.precision == 2
    finally:
        tp.set_printoptions(precision=before)


def test_cuda_rng_state_lists_the_cuda_generators(monkeypatch):
    from paddle2_tpu_torch.framework import random as fr
    assert all(k == "cpu" for k in fr.get_rng_state()) or \
        tp.get_cuda_rng_state()
    states = tp.get_cuda_rng_state()
    tp.set_cuda_rng_state(states)
    assert jp.get_cuda_rng_state() == []


def test_flops_counts_conv_and_linear():
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3, padding=1),
                              torch.nn.Flatten(),
                              torch.nn.Linear(4 * 8 * 8, 10))
    # conv: 4*8*8 outputs x (2*27 - 1); linear: 2 * 10 outputs x 256 in
    assert tp.flops(net, [1, 3, 8, 8]) == 256 * 53 + 2 * 10 * 256
