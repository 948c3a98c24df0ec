"""``paddle2_tpu_torch.nn``'s activation, common, conv and pooling
layers against ``paddle2_tpu.nn``'s on the CPU: for every entry of
``torch_nn_table_layers`` (``ACTIVATION_LAYERS``, ``COMMON_LAYERS``),
the JAX layer and the port's twin from the same constructor arguments
have the same state names, order and shapes; the twin takes the JAX
weights; and the forward, dtypes, buffers and the gradients of every
float input and parameter agree (f32 rtol 1e-5 / atol 1e-6, bf16 one
bf16 step, or the entry's own tolerance; ``torch_nn_layer_harness``).
``RReLU`` draws its slopes: it is held by their range."""

import numpy as np
import pytest
import torch

import paddle2_tpu as jp
import paddle2_tpu_torch as tp
from torch_core_harness import port_on_cpu  # noqa: F401
from torch_nn_layer_harness import layer_params, run_layer
from torch_nn_table_layers import ACTIVATION_LAYERS, COMMON_LAYERS


@pytest.mark.parametrize("entry,dtype", layer_params(ACTIVATION_LAYERS))
def test_activation_layer_matches_jax(entry, dtype):
    run_layer(entry, dtype)


@pytest.mark.parametrize("entry,dtype", layer_params(COMMON_LAYERS))
def test_common_layer_matches_jax(entry, dtype):
    run_layer(entry, dtype)


def test_rrelu_layer_draws_slopes_in_range_in_either_mode():
    """As the JAX layer, ``RReLU`` calls ``F.rrelu`` with its default
    ``training=True``: slopes in ``[lower, upper]`` in eval mode too."""
    x = -torch.rand(50, 40) - 0.1
    layer = tp.nn.RReLU(0.2, 0.4)
    for train in (True, False):
        layer.train() if train else layer.eval()
        slope = layer(x) / x
        assert slope.min() >= 0.2 - 1e-6 and slope.max() <= 0.4 + 1e-6
        assert slope.std() > 0.03
    jslope = np.asarray(jp.nn.RReLU(0.2, 0.4).eval()(
        jp.to_tensor(x.numpy())).numpy()) / x.numpy()
    assert jslope.std() > 0.03


@pytest.mark.parametrize("name,kw", [
    ("Dropout", dict(p=0.3)), ("Dropout2D", dict(p=0.3)),
    ("Dropout3D", dict(p=0.3)), ("AlphaDropout", dict(p=0.3)),
    ("FeatureAlphaDropout", dict(p=0.3))])
def test_dropout_layers_draw_in_training_and_not_in_eval(name, kw):
    shape = (20, 10, 2, 2, 2) if name == "Dropout3D" else (20, 10, 4, 4)
    x = torch.rand(shape) + 1.0
    layer = getattr(tp.nn, name)(**kw)
    tp.seed(3)
    a = layer(x)
    tp.seed(3)
    assert torch.equal(layer(x), a)
    assert not torch.equal(a, x)
    layer.eval()
    assert torch.equal(layer(x), x)
