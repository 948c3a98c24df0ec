"""``paddle2_tpu_torch.nn``'s norm layers against ``paddle2_tpu.nn``'s on
the CPU: for every entry of ``torch_nn_table_layers.NORM_LAYERS``, the
same state names, order and shapes, the JAX weights loaded into the
twin, and the forward, dtypes, buffers and the gradients of every float
input and parameter (``torch_nn_layer_harness``'s tolerances, or the
entry's own); the batch norms' buffers are their running statistics
after one training call."""

import pytest

from torch_core_harness import port_on_cpu  # noqa: F401
from torch_nn_layer_harness import layer_params, run_layer
from torch_nn_table_layers import NORM_LAYERS


@pytest.mark.parametrize("entry,dtype", layer_params(NORM_LAYERS))
def test_norm_layer_matches_jax(entry, dtype):
    run_layer(entry, dtype)
