"""``paddle2_tpu_torch``'s math ops (``ops/math.py``) against the JAX
package's on the CPU: the same numpy inputs, the forward values, the
result dtypes and the gradients, in float32 and bfloat16 (see
``torch_core_harness``)."""

import numpy as np
import pytest

from torch_core_harness import port_on_cpu  # noqa: F401
from torch_core_harness import cases_params, run_case
from torch_core_table_math import CASES


@pytest.mark.parametrize("case,dtype", cases_params(CASES))
def test_math_op(case, dtype):
    run_case(case, dtype)


def test_increment_adds_in_place():
    import paddle2_tpu as jp
    import paddle2_tpu_torch as tp
    for dt in ("float32", "int32"):
        a = np.arange(4).astype(dt)
        j = jp.increment(jp.to_tensor(a), 2)
        t0 = tp.to_tensor(a, place="cpu")
        t = tp.increment(t0, 2)
        assert t is t0
        np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy()))
        assert str(t.dtype).endswith(dt)
