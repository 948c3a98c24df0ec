"""DenseNet-121, the slice's main path model, against the JAX package's
on the CPU, on the same weights (the port's draw, loaded into the JAX
model), at 32x32, batch 4, 10 classes, f32. The JAX side runs through
``paddle.jit.to_static`` and ``paddle.jit.train_step`` (its eager
backward compiles every op at each of the 120 convolutions' distinct
shapes, ~3 minutes).

At this size the last dense block is 1x1, so in training mode its
BatchNorms normalise 4 values a channel. That makes the training-mode
arithmetic chaotic in f32: the port's own f32 gradients land up to 18 %
of the largest magnitude from an f64 run of the same model, and three
``Momentum`` steps at lr 1e-4 move the f32 loss 9 % from the f64 one
(1e-6 and 6e-8 in eval mode). Two f32 implementations cannot agree
there, so what is held where:

- one training-mode forward: the loss to 1e-4 relative (the port's f32
  reads 3e-6 from f64, the JAX package's 4e-5) and every BatchNorm
  buffer it updates to 1e-4 (absolute below 1, relative above; the last
  block's statistics carry the same ~2e-5);
- in eval mode (BatchNorm on its running statistics) the loss to 1e-5
  relative and every one of the 364 gradients to 1e-4 of its largest
  magnitude;
- three ``jit.train_step`` calls in eval mode with ``Momentum(lr 1e-4,
  momentum 0.9, multi_precision=True)`` under
  ``FLAGS_fused_optimizer_step`` (on the CPU the multi-tensor step runs
  its plain version, once a tensor a step): the losses to 1e-5
  relative.
"""

import numpy as np
import pytest
import torch

import paddle2_tpu as jp
import paddle2_tpu.nn.functional as JF
import paddle2_tpu.optimizer as jopt
from paddle2_tpu import flags as jflags
from paddle2_tpu_torch import flags, jit
from paddle2_tpu_torch.kernels import fused_momentum as fm
from paddle2_tpu_torch.nn import functional as F
from paddle2_tpu_torch.optimizer import Momentum
from torch_core_harness import port_on_cpu  # noqa: F401
from torch_vision_twins import twins


def _images(seed):
    rs = np.random.RandomState(seed)
    img = (rs.randn(4, 3, 32, 32) * 0.5).astype(np.float32)
    return img, rs.randint(0, 10, (4,)).astype(np.int32)


def test_densenet121_forward_buffers_and_eval_grads_match_jax():
    jm, tm = twins("densenet121", num_classes=10)
    img, lbl = _images(0)
    with torch.no_grad():
        tloss = F.cross_entropy(tm(torch.from_numpy(img)),
                                torch.from_numpy(lbl))
    jloss = JF.cross_entropy(jp.jit.to_static(jm)(jp.to_tensor(img)),
                             jp.to_tensor(lbl))
    np.testing.assert_allclose(tloss.item(), float(jloss.numpy()), rtol=1e-4)
    jbufs = {n: np.asarray(b.numpy()) for n, b in jm.named_buffers()}
    for n, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), jbufs[n], rtol=1e-4,
                                   atol=1e-4, err_msg=n)
    jm.eval()
    tm.eval()
    jloss = JF.cross_entropy(jp.jit.to_static(jm)(jp.to_tensor(img)),
                             jp.to_tensor(lbl))
    jloss.backward()
    tloss = F.cross_entropy(tm(torch.from_numpy(img)),
                            torch.from_numpy(lbl))
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss.numpy()), rtol=1e-5)
    jgrads = {n: np.asarray(p.grad.numpy()) for n, p in
              jm.named_parameters()}
    names = [n for n, _ in tm.named_parameters()]
    assert names == list(jgrads) and len(names) == 364
    for n, p in tm.named_parameters():
        want = jgrads[n]
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=n)


@pytest.fixture
def fused_flag():
    before = (jflags.get_flags("FLAGS_fused_optimizer_step"),
              flags.get_flags("fused_optimizer_step"))
    jflags.set_flags({"FLAGS_fused_optimizer_step": True})
    flags.set_flags({"fused_optimizer_step": True})
    yield
    jflags.set_flags(before[0])
    flags.set_flags(before[1])


def test_densenet121_train_step_losses_track_jax(fused_flag, monkeypatch):
    calls = []
    plain = fm.momentum_step_reference
    monkeypatch.setattr(fm, "momentum_step_reference",
                        lambda *a: calls.append(1) or plain(*a))
    jm, tm = twins("densenet121", num_classes=10)
    jm.eval()
    tm.eval()
    jo = jopt.Momentum(learning_rate=1e-4, momentum=0.9,
                       parameters=jm.parameters(), multi_precision=True)
    to = Momentum(learning_rate=1e-4, momentum=0.9,
                  parameters=tm.parameters(), multi_precision=True)
    jstep = jp.jit.train_step(lambda i, l: JF.cross_entropy(jm(i), l), jo)
    tstep = jit.train_step(lambda i, l: F.cross_entropy(tm(i), l), to)
    jl, tl = [], []
    for s in range(3):
        img, lbl = _images(s)
        jl.append(float(jstep(jp.to_tensor(img),
                              jp.to_tensor(lbl)).numpy()))
        tl.append(float(tstep(torch.from_numpy(img),
                              torch.from_numpy(lbl))))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert len(calls) == 3 * 364
