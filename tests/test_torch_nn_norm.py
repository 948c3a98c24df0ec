"""``paddle2_tpu_torch.nn.functional``'s norms against the JAX package's
on the CPU: the table's ``NORM`` cases (``torch_nn_table_functional``),
forward, dtypes and gradients in float32 and bfloat16
(``torch_core_harness``'s tolerances unless a case states its own)."""

import pytest

from torch_core_harness import port_on_cpu  # noqa: F401
from torch_core_harness import cases_params, run_case
from torch_nn_table_functional import NORM


@pytest.mark.parametrize("case,dtype", cases_params(NORM))
def test_norm_matches_jax(case, dtype):
    run_case(case, dtype)
