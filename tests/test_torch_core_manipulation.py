"""``paddle2_tpu_torch``'s shape and layout ops (``ops/manipulation.py``)
against the JAX package's on the CPU: forward values, result dtypes and
gradients, in float32 and bfloat16 (see ``torch_core_harness``)."""

import numpy as np
import pytest
import torch

import paddle2_tpu as jp
import paddle2_tpu_torch as tp
from torch_core_harness import port_on_cpu  # noqa: F401
from torch_core_harness import cases_params, run_case
from torch_core_table_manipulation import CASES


@pytest.mark.parametrize("case,dtype", cases_params(CASES))
def test_manipulation_op(case, dtype):
    run_case(case, dtype)


def test_tolist():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    assert tp.tolist(tp.to_tensor(a, place="cpu")) == \
        jp.tolist(jp.to_tensor(a))


@pytest.mark.parametrize("op,args", [
    ("reshape_", ([3, 4],)), ("squeeze_", (1,)), ("unsqueeze_", (0,)),
    ("scatter_", (np.array([2, 0], np.int32), np.ones((2, 4), np.float32))),
    ("index_add_", (np.array([1, 1], np.int32), 0,
                    np.ones((2, 4), np.float32))),
    ("index_put_", ((np.array([0, 2], np.int32),),
                    np.ones(4, np.float32) * 3)),
])
def test_in_place_forms(op, args):
    """The in-place forms change the tensor itself, to the values of
    the JAX package's, and keep the gradient path of an interior
    tensor."""
    shape = (3, 1, 4) if op == "squeeze_" else (3, 4)
    base = np.random.default_rng(0).standard_normal(shape).astype(
        np.float32)

    def conv(a, side):
        if isinstance(a, np.ndarray):
            return jp.to_tensor(a) if side == "jax" else \
                tp.to_tensor(a, place="cpu")
        if isinstance(a, tuple):
            return tuple(conv(b, side) for b in a)
        return a
    j = jp.to_tensor(base)
    jout = getattr(jp, op)(j, *conv(args, "jax"))
    leaf = torch.from_numpy(base.copy()).requires_grad_()
    t = leaf * 1.0
    tout = getattr(tp, op)(t, *conv(args, "torch"))
    assert tout is t
    np.testing.assert_array_equal(t.detach().numpy(), np.asarray(jout.numpy()))
    t.sum().backward()
    assert leaf.grad is not None and leaf.grad.shape == leaf.shape
