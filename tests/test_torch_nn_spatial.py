"""``paddle2_tpu_torch.nn.functional``'s spatial common functionals
(``unfold``, ``fold``, ``interpolate`` in every mode, ``upsample``, the
pixel and channel shuffles) against the JAX package's on the CPU: the
table's ``SPATIAL`` cases (``torch_nn_table_functional``), forward,
dtypes and gradients in float32 and bfloat16 (``torch_core_harness``:
f32 rtol 1e-5 / atol 1e-6, bf16 one bf16 step)."""

import pytest

from torch_core_harness import port_on_cpu  # noqa: F401
from torch_core_harness import cases_params, run_case
from torch_nn_table_functional import SPATIAL


@pytest.mark.parametrize("case,dtype", cases_params(SPATIAL))
def test_spatial_functional_matches_jax(case, dtype):
    run_case(case, dtype)
