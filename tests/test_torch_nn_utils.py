"""``paddle2_tpu_torch.nn.utils`` against ``paddle2_tpu.nn.utils`` on
the CPU: ``weight_norm`` (``dim`` 0, 1 and None, which is the LAST
axis) on a ``Linear`` and a ``Conv2D`` with the JAX weights: the state
names and values, the forward and the gradients of ``<name>_v`` and
``<name>_g`` over three training steps; ``remove_weight_norm`` giving
back the state of a plain layer; ``spectral_norm`` after three forwards
(the carried ``u``/``v``, the forward, the gradient of
``<name>_orig``); the vector helpers; and the module paths of the two
clips."""

import numpy as np
import pytest
import torch

import paddle2_tpu as jp
import paddle2_tpu_torch as tp
from paddle2_tpu_torch.models import nn_state_from_reference
from torch_core_cases import TOL, assert_same
from torch_core_harness import port_on_cpu  # noqa: F401

# weight_norm's and spectral_norm's forward divide by a norm that each
# framework sums in its own order
NORM_TOL = {"float32": dict(rtol=2e-5, atol=2e-6)}


def _twins(make):
    jp.seed(7)
    jl = make(jp)
    tl = make(tp)
    tl.set_state_dict(nn_state_from_reference(jl))
    return jl, tl


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _layer(kind):
    if kind == "linear":
        return (lambda pkg: pkg.nn.Linear(5, 4)), (3, 5)
    return (lambda pkg: pkg.nn.Conv2D(3, 4, 3, padding=1)), (2, 3, 6, 6)


def _sgd_step(params, grads, lr=0.1):
    for p, g in zip(params, grads):
        with torch.no_grad():
            p -= lr * g


@pytest.mark.parametrize("kind", ["linear", "conv"])
@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm_matches_jax(kind, dim):
    make, shape = _layer(kind)
    jl, tl = _twins(make)
    jp.nn.utils.weight_norm(jl, dim=dim)
    tp.nn.utils.weight_norm(tl, dim=dim)
    js, ts = jl.state_dict(), tl.state_dict()
    assert list(ts) == list(js)
    assert "weight_v" in ts and "weight_g" in ts
    w = np.asarray(js["weight"].numpy())
    axis = w.ndim - 1 if dim is None else dim
    assert tuple(ts["weight_g"].shape) == tuple(
        1 if i != axis else n for i, n in enumerate(w.shape))
    assert_same(ts["weight_g"], js["weight_g"], NORM_TOL, "g")
    jtrain = [p for p in jl.parameters() if not p.stop_gradient]
    ttrain = [p for p in tl.parameters() if p.requires_grad]
    assert len(jtrain) == len(ttrain) == 3      # bias, v, g
    for step in range(3):
        x = _x(shape, step)
        jout, tout = jl(jp.to_tensor(x)), tl(torch.from_numpy(x))
        assert_same(tout, jout, NORM_TOL, f"forward {step}")
        jg = jp.grad([jout.sum()], jtrain)
        tg = torch.autograd.grad(tout.sum(), ttrain)
        for i, (a, b) in enumerate(zip(tg, jg)):
            assert_same(a, b, {"float32": dict(rtol=1e-4, atol=1e-5)},
                        f"grad {i} step {step}")
        _sgd_step(ttrain, tg)
        for p, g in zip(jtrain, jg):
            p.set_value(p - 0.1 * g)
    assert_same(tl.state_dict()["weight"], jl.state_dict()["weight"],
                NORM_TOL, "weight after the first forward")


@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_remove_weight_norm_round_trips_the_state(kind):
    make, shape = _layer(kind)
    jl, tl = _twins(make)
    before = list(tl.state_dict())
    for pkg, layer in ((jp, jl), (tp, tl)):
        pkg.nn.utils.weight_norm(layer)
        x = _x(shape)
        layer(jp.to_tensor(x) if pkg is jp else torch.from_numpy(x))
        pkg.nn.utils.remove_weight_norm(layer)
    assert list(tl.state_dict()) == list(jl.state_dict()) == before
    assert_same(tl.state_dict()["weight"], jl.state_dict()["weight"],
                NORM_TOL, "folded weight")
    assert tl.weight.requires_grad
    assert tl.weight is tl._parameters["weight"]
    x = _x(shape, 1)
    assert_same(tl(torch.from_numpy(x)), jl(jp.to_tensor(x)), NORM_TOL,
                "forward after removal")


@pytest.mark.parametrize("kind,dim", [("linear", None), ("conv", None),
                                      ("conv", 1)])
def test_spectral_norm_after_three_forwards(kind, dim):
    make, shape = _layer(kind)
    jl, tl = _twins(make)
    jp.nn.utils.spectral_norm(jl, dim=dim, n_power_iterations=2)
    tp.nn.utils.spectral_norm(tl, dim=dim, n_power_iterations=2)
    assert list(tl.state_dict()) == list(jl.state_dict())
    assert "weight_orig" in tl.state_dict()
    for step in range(3):
        x = _x(shape, step)
        jout, tout = jl(jp.to_tensor(x)), tl(torch.from_numpy(x))
        assert_same(tout, jout, NORM_TOL, f"forward {step}")
    jorig = dict(jl.named_parameters())["weight_orig"]
    jg = jp.grad([jout.sum()], [jorig])[0]
    tg = torch.autograd.grad(tout.sum(), [tl.weight_orig])[0]
    assert_same(tg, jg, {"float32": dict(rtol=1e-4, atol=1e-5)}, "grad")
    assert_same(tl.state_dict()["weight"], jl.state_dict()["weight"],
                NORM_TOL, "weight after the first forward")


def test_vector_helpers():
    jl, tl = _twins(lambda pkg: pkg.nn.Linear(5, 4))
    tv = tp.nn.utils.parameters_to_vector(tl.parameters())
    jv = jp.nn.utils.parameters_to_vector(jl.parameters())
    assert_same(tv, jv, TOL, "vector")
    assert not tv.requires_grad
    tp.nn.utils.vector_to_parameters(torch.arange(24.0), tl.parameters())
    assert tl.weight.flatten().tolist() == list(range(20))
    assert tl.bias.tolist() == [20.0, 21.0, 22.0, 23.0]


def test_clip_module_paths():
    from paddle2_tpu_torch.nn import clip, utils_mod
    assert tp.nn.utils.clip_grad_norm_ is clip.clip_grad_norm_ is \
        utils_mod.clip_grad_norm_ is tp.nn.clip_grad_norm_
    assert tp.nn.utils.clip_grad_value_ is clip.clip_grad_value_


@pytest.mark.parametrize("module", [
    "nn.functional.conv", "nn.functional.pooling", "nn.functional.vision_ops",
    "nn.layer.conv", "nn.layer.pooling", "nn.layer.rnn", "nn.decode",
    "nn.utils", "vision.models", "vision.models.resnet", "vision.models.vgg",
    "vision.models.small", "vision.models.mobilenet",
    "vision.models.densenet", "vision.models.inception_shuffle"])
def test_module_all_matches_jax(module):
    """Each module of the slice exports the JAX module's ``__all__`` in
    its order, and ``nn`` / ``nn.functional`` carry every one of its
    names."""
    import importlib
    jm = importlib.import_module("paddle2_tpu." + module)
    tm = importlib.import_module("paddle2_tpu_torch." + module)
    assert tm.__all__ == jm.__all__
    if module.startswith(("nn.layer", "nn.decode")):
        assert set(jm.__all__) <= set(tp.nn.__all__)
    if module.startswith("nn.functional"):
        assert set(jm.__all__) <= set(tp.nn.functional.__all__)
    for name in tm.__all__:
        assert hasattr(tm, name), name
