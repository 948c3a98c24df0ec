"""``paddle2_tpu_torch``'s long-tail ops (``ops/extra.py``) against the
JAX package's on the CPU (see ``torch_core_harness``)."""

import numpy as np
import pytest

import paddle2_tpu as jp
import paddle2_tpu_torch as tp
from torch_core_harness import port_on_cpu  # noqa: F401
from torch_core_harness import cases_params, run_case
from torch_core_table_extra import CASES


@pytest.mark.parametrize("case,dtype", cases_params(CASES))
def test_extra_op(case, dtype):
    run_case(case, dtype)


def test_complex_real_imag_and_take_raises():
    a = np.random.default_rng(0).standard_normal((2, 3)).astype(np.float32)
    jz = jp.complex(jp.to_tensor(a), jp.to_tensor(a * 2))
    tz = tp.complex(tp.to_tensor(a), tp.to_tensor(a * 2))
    for op in ("real", "imag", "sgn"):
        np.testing.assert_allclose(getattr(tp, op)(tz).numpy(),
                                   np.asarray(getattr(jp, op)(jz).numpy()),
                                   rtol=1e-6)
    with pytest.raises(IndexError, match="out of range"):
        tp.take(tp.to_tensor(a), tp.to_tensor(np.array([6])))
