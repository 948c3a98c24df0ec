"""``paddle2_tpu_torch``'s creation ops (``ops/creation.py``) against the
JAX package's on the CPU: values, result dtypes (the x32 and
default-dtype rules) and gradients where an op takes a tensor (see
``torch_core_harness``). Ops that make a tensor from nothing run once
for float32 and once with ``dtype="bfloat16"``."""

import numpy as np
import pytest
import torch

import paddle2_tpu as jp
import paddle2_tpu_torch as tp
from torch_core_harness import port_on_cpu  # noqa: F401
from torch_core_harness import cases_params, run_case
from torch_core_table_creation import CASES


@pytest.mark.parametrize("case,dtype", cases_params(CASES))
def test_creation_op(case, dtype):
    run_case(case, dtype)


@pytest.mark.parametrize("dtype", [None, "float32", "bfloat16"])
def test_empty_has_the_shape_and_dtype(dtype):
    for jt, tt in ((jp.empty([2, 3], dtype=dtype),
                    tp.empty([2, 3], dtype=dtype)),
                   (jp.empty_like(jp.zeros([2]), dtype=dtype),
                    tp.empty_like(tp.zeros([2]), dtype=dtype))):
        assert tuple(tt.shape) == tuple(jt.shape)
        assert str(tt.dtype).rpartition(".")[2] == np.dtype(jt.dtype).name


@pytest.mark.parametrize("data,dtype", [
    (1.5, None), (3, None), (True, None), ([1, 2], None),
    ([1.0, 2.0], None), (np.arange(3, dtype=np.int64), None),
    (np.arange(3, dtype=np.float64), None), ([[1, 2]], "float32"),
    (2.5, "bfloat16"), (np.ones(2, np.uint8), None),
    (np.ones(2, np.float16), None), (np.ones(2, np.complex128), None)])
def test_to_tensor_dtype_rules(data, dtype):
    """to_tensor's x32 and default-dtype rules equal the JAX package's:
    a Python int is int32, a float the default float, a float64 array
    float32, an int64 array int32."""
    j = jp.to_tensor(data, dtype=dtype)
    t = tp.to_tensor(data, dtype=dtype)
    assert t.device.type == "cpu"
    assert str(t.dtype).rpartition(".")[2] == np.dtype(j.dtype).name
    want = np.asarray(j.numpy())
    got = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    np.testing.assert_array_equal(got, want.astype(got.dtype))


def test_default_dtype_rules_follow_set_default_dtype():
    before = tp.get_default_dtype()
    try:
        for side in (jp, tp):
            side.set_default_dtype("float16")
        assert tp.to_tensor(1.5).dtype == torch.float16
        assert tp.zeros([2]).dtype == torch.float16
        assert tp.arange(0.0, 1.0, 0.5).dtype == torch.float16
        assert np.dtype(jp.zeros([2]).dtype).name == "float16"
        tp.set_default_dtype("float64")
        assert tp.get_default_dtype() == torch.float32
    finally:
        jp.set_default_dtype("float32")
        tp.set_default_dtype(before)


def test_to_tensor_stop_gradient_and_place():
    t = tp.to_tensor([1.0, 2.0], stop_gradient=False)
    assert t.requires_grad and t.is_leaf and not t.stop_gradient
    assert tp.to_tensor([1, 2], stop_gradient=False).requires_grad is False
    assert tp.to_tensor([1.0], place=tp.CPUPlace()).device.type == "cpu"
    src = torch.ones(2, requires_grad=True)
    copy = tp.to_tensor(src)
    assert copy.requires_grad is False and copy.data_ptr() != \
        src.data_ptr()
