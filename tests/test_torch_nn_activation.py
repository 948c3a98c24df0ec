"""``paddle2_tpu_torch.nn.functional``'s activations against the JAX
package's on the CPU: the table's activations
(``torch_nn_table_functional.ACTIVATIONS``), forward, dtypes and
gradients in float32 and bfloat16 (``torch_core_harness``: f32 rtol
1e-5 / atol 1e-6, bf16 one bf16 step); the in-place activations; and
the surface: the functional modules of this slice export the JAX
modules' ``__all__`` in order, and the namespace has every one of their
names in the JAX order."""

import numpy as np
import pytest
import torch

import paddle2_tpu as jp
import paddle2_tpu.nn.functional as JF
import paddle2_tpu_torch.nn.functional as TF
from torch_core_harness import port_on_cpu  # noqa: F401
from torch_core_harness import cases_params, run_case
from torch_nn_table_functional import ACTIVATIONS

F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case,dtype", cases_params(ACTIVATIONS))
def test_activation_matches_jax(case, dtype):
    run_case(case, dtype)


# ------------------------------------------------------------- surface
FUNCTIONAL_MODULES = ("activation", "common", "norm", "loss",
                      "extra_losses")


@pytest.mark.parametrize("mod", FUNCTIONAL_MODULES)
def test_functional_modules_export_the_jax_names_in_order(mod):
    import importlib
    jm = importlib.import_module(f"paddle2_tpu.nn.functional.{mod}")
    tm = importlib.import_module(f"paddle2_tpu_torch.nn.functional.{mod}")
    assert tm.__all__ == jm.__all__
    for name in jm.__all__:
        assert callable(getattr(TF, name)), name


def test_functional_namespace_has_every_jax_name_of_the_slice():
    """The JAX namespace's names from this slice's modules, the in-place
    activations and ``sequence_mask``/``diag_embed`` are in the port's,
    in the JAX order; ``flash_attention`` stays the module."""
    import importlib
    want = []
    for mod in FUNCTIONAL_MODULES:
        want += importlib.import_module(
            f"paddle2_tpu.nn.functional.{mod}").__all__
    want += ["elu_", "hardtanh_", "leaky_relu_", "tanh_",
             "thresholded_relu_", "relu6_", "sigmoid_", "sequence_mask",
             "diag_embed"]
    for name in want:
        assert hasattr(JF, name), name
        assert name in TF.__all__, name
    order = [TF.__all__.index(n) for n in want]
    assert order == sorted(order)
    import types
    assert isinstance(TF.flash_attention, types.ModuleType)


# ------------------------------------------------------------ in place
@pytest.mark.parametrize("name,kw", [
    ("relu_", {}), ("softmax_", {}), ("elu_", dict(alpha=0.5)),
    ("hardtanh_", {}), ("leaky_relu_", dict(negative_slope=0.3)),
    ("tanh_", {}), ("thresholded_relu_", dict(threshold=0.2)),
    ("relu6_", {}), ("sigmoid_", {})])
def test_inplace_activation_updates_x_and_keeps_the_gradient(name, kw):
    """``x`` itself holds the result (the out-of-place function's), and
    the gradient through it is the out-of-place one's."""
    rng = np.random.default_rng(1)
    a = (rng.standard_normal((3, 5)) * 3).astype(np.float32)
    base = getattr(TF, name[:-1])
    leaf = torch.from_numpy(a).requires_grad_(True)
    x = leaf * 1.0
    out = getattr(TF, name)(x, **kw)
    assert out is x
    want_leaf = torch.from_numpy(a).requires_grad_(True)
    want = base(want_leaf * 1.0, **kw)
    np.testing.assert_allclose(out.detach().numpy(),
                               want.detach().numpy(), **F32)
    jwant = getattr(JF, name)(jp.to_tensor(a), **kw)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jwant.numpy()), **F32)
    g = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
    (out * g).sum().backward()
    (want * g).sum().backward()
    np.testing.assert_allclose(leaf.grad.numpy(), want_leaf.grad.numpy(),
                               **F32)
