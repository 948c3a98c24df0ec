"""The port's model zoo (``paddle2_tpu_torch.vision.models``) against
the JAX package's on the CPU:

- every constructor of the zoo's ``__all__`` (and the families' defining
  arguments: VGG's ``batch_norm``, MobileNet's and ShuffleNet's
  ``scale``, DenseNet's ``bn_size``) builds with the JAX ``state_dict``
  names in the JAX order, the same shapes, parameter count and
  trainable flags. Each is built alone and freed; the JAX side draws
  its weights from zeros here (``jax.random`` patched inside the test),
  which gives the same names and shapes at a fraction of the
  compilation time of its random draws;
- eval-mode forwards of small members of the families with their own
  blocks (LeNet, SqueezeNet's fire modules, MobileNetV3's squeeze and
  excite, ShuffleNetV2's channel shuffle) on the same weights (logits
  to 1e-5 of their largest magnitude); DenseNet-121 is
  ``test_torch_vision_densenet.py``'s;
- a JAX ``resnet18`` saved with ``paddle2_tpu.save`` loads through the
  port's ``paddle.load`` and ``set_state_dict`` with no transpose and
  gives the same logits;
- ``pretrained=True`` raises for every family.
"""

import gc

import numpy as np
import pytest
import torch

import paddle2_tpu as jp
import paddle2_tpu_torch as tp
from paddle2_tpu.vision import models as JM
from paddle2_tpu_torch.vision import models as TM
from torch_core_harness import port_on_cpu  # noqa: F401
from torch_vision_twins import twins, zero_draws

CONSTRUCTORS = [n for n in JM.__all__ if n[0].islower()]
VARIANTS = [("vgg11", dict(batch_norm=True)),
            ("mobilenet_v1", dict(scale=0.5)),
            ("mobilenet_v2", dict(scale=0.75)),
            ("mobilenet_v3_small", dict(scale=0.5)),
            ("densenet121", dict(bn_size=2, num_classes=0)),
            ("resnet50", dict(num_classes=0, with_pool=False))]


def _near(got, want, tol):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_zoo_exports_the_jax_names():
    assert TM.__all__ == JM.__all__


@pytest.mark.parametrize("name,kwargs",
                         [(n, {}) for n in CONSTRUCTORS] + VARIANTS,
                         ids=[n for n in CONSTRUCTORS] +
                         [f"{n}-{'-'.join(k)}" for n, k in VARIANTS])
def test_constructor_state_matches_jax(name, kwargs):
    with zero_draws():
        jm = getattr(JM, name)(**kwargs)
    jstate = [(n, tuple(v.shape)) for n, v in jm.state_dict().items()]
    jcount = sum(int(np.prod(p.shape)) for p in jm.parameters())
    jtrain = [not p.stop_gradient for p in jm.parameters()]
    del jm
    gc.collect()
    tm = getattr(TM, name)(**kwargs)
    assert isinstance(tm, tp.nn.Layer)
    assert [(n, tuple(v.shape)) for n, v in tm.state_dict().items()] == \
        jstate
    assert sum(p.numel() for p in tm.parameters()) == jcount
    assert [p.requires_grad for p in tm.parameters()] == jtrain
    assert all(p.device.type == "cpu" for p in tm.parameters())
    del tm
    gc.collect()


@pytest.mark.parametrize("name", ["resnet18", "vgg11", "alexnet",
                                  "squeezenet1_0", "mobilenet_v2",
                                  "densenet121", "googlenet",
                                  "inception_v3", "shufflenet_v2_x1_0"])
def test_pretrained_raises(name):
    with pytest.raises(ValueError, match="pretrained"):
        getattr(TM, name)(pretrained=True)


def _images(batch, size, classes, seed=0, channels=3):
    rs = np.random.RandomState(seed)
    img = (rs.randn(batch, channels, size, size) * 0.5).astype(np.float32)
    return img, rs.randint(0, classes, (batch,)).astype(np.int32)


@pytest.mark.parametrize("name,kwargs,size,channels", [
    ("LeNet", dict(), 28, 1),
    ("squeezenet1_1", dict(num_classes=10), 64, 3),
    ("mobilenet_v3_small", dict(num_classes=10), 32, 3),
    ("shufflenet_v2_swish", dict(num_classes=10), 32, 3),
])
def test_eval_forward_matches_jax(name, kwargs, size, channels):
    jm, tm = twins(name, **kwargs)
    jm.eval()
    tm.eval()
    img, _ = _images(2, size, 10, seed=1, channels=channels)
    want = np.asarray(jm(jp.to_tensor(img)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(img)).numpy()
    _near(got, want, 1e-5)


def test_jax_resnet18_checkpoint_loads_with_no_transpose(tmp_path):
    """``paddle2_tpu.save`` of a JAX resnet18, the port's ``paddle.load``
    and ``set_state_dict``: every name matches, ``fc.weight`` is ``[512,
    10]`` on both sides, and the eval logits agree."""
    jp.seed(4)
    jm = JM.resnet18(num_classes=10)
    path = tmp_path / "resnet18.pdparams"
    jp.save(jm.state_dict(), str(path))
    tm = TM.resnet18(num_classes=10)
    missing, unexpected = tm.set_state_dict(tp.load(str(path)))
    assert not missing and not unexpected
    assert tuple(tm.fc.weight.shape) == (512, 10)
    jm.eval()
    tm.eval()
    img, _ = _images(2, 32, 10, seed=2)
    want = np.asarray(jm(jp.to_tensor(img)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(img)).numpy()
    _near(got, want, 1e-5)
