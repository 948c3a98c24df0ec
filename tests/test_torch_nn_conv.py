"""``paddle2_tpu_torch.nn``'s convolutions against ``paddle2_tpu.nn``'s
on the CPU: every ``CONV`` case and ``CONV_LAYERS`` entry of
``torch_nn_table_spatial_rnn`` (forward, dtypes and the gradients of
every float input and parameter, f32 and bf16; the tolerances of
``torch_core_cases.TOL`` or the case's own), and the transposes' string
padding: at stride 1 the sizes of a plain convolution, past stride 1 a
``ValueError`` in both packages."""

import numpy as np
import pytest
import torch

import paddle2_tpu as jp
import paddle2_tpu_torch as tp
from torch_core_harness import port_on_cpu  # noqa: F401
from torch_core_harness import cases_params, run_case
from torch_nn_layer_harness import layer_params, run_layer
from torch_nn_table_spatial_rnn import CONV, CONV_LAYERS


@pytest.mark.parametrize("case,dtype", cases_params(CONV))
def test_conv_matches_jax(case, dtype):
    run_case(case, dtype)


@pytest.mark.parametrize("entry,dtype", layer_params(CONV_LAYERS))
def test_conv_layer_matches_jax(entry, dtype):
    run_layer(entry, dtype)


@pytest.mark.parametrize("padding,size", [("SAME", 5), ("VALID", 3)])
def test_transpose_string_padding_sizes_at_stride_one(padding, size):
    """Input length 5, kernel 3: ``"SAME"`` keeps 5 and ``"VALID"`` gives
    3, a plain convolution's sizes (Paddle's transposed ``"VALID"`` would
    give 7)."""
    x = np.ones((1, 2, 5), np.float32)
    w = np.ones((2, 3, 3), np.float32)
    j = jp.nn.functional.conv1d_transpose(jp.to_tensor(x), jp.to_tensor(w),
                                          padding=padding)
    t = tp.nn.functional.conv1d_transpose(torch.from_numpy(x),
                                          torch.from_numpy(w),
                                          padding=padding)
    assert tuple(j.shape) == tuple(t.shape) == (1, 3, size)


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_transpose_string_padding_past_stride_one_raises(padding):
    x = np.ones((1, 2, 5), np.float32)
    w = np.ones((2, 3, 3), np.float32)
    with pytest.raises(ValueError, match="String padding"):
        jp.nn.functional.conv1d_transpose(jp.to_tensor(x), jp.to_tensor(w),
                                          stride=2, padding=padding)
    with pytest.raises(ValueError, match="String padding"):
        tp.nn.functional.conv1d_transpose(torch.from_numpy(x),
                                          torch.from_numpy(w), stride=2,
                                          padding=padding)


@pytest.mark.parametrize("name", ["Conv1D", "Conv2D", "Conv3D"])
def test_conv_layers_raise_on_padding_mode(name):
    """The JAX layers store ``padding_mode`` and pad with zeros; the port
    raises rather than give zeros where reflection was asked."""
    with pytest.raises(NotImplementedError, match="padding_mode"):
        getattr(tp.nn, name)(2, 3, 3, padding_mode="reflect")


def test_transpose_weight_layout_and_init_range():
    """``[in, out/groups, *k]`` and the forward's ``fan_in`` (in/groups
    times the kernel): weights and bias within ±1/√fan_in."""
    for name, k in (("Conv1DTranspose", (3,)), ("Conv2DTranspose", (3, 2)),
                    ("Conv3DTranspose", (2, 2, 2))):
        layer = getattr(tp.nn, name)(4, 6, k, groups=2)
        jl = getattr(jp.nn, name)(4, 6, k, groups=2)
        assert tuple(layer.weight.shape) == (4, 3) + k == \
            tuple(jl.weight.shape)
        bound = 1 / np.sqrt(2 * np.prod(k))
        assert layer.weight.abs().max() <= bound
        assert layer.bias.abs().max() <= bound
