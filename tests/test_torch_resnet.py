"""The port's vision path (paddle2_tpu_torch.nn conv / BatchNorm /
pooling / cross-entropy and paddle2_tpu_torch.vision.models.resnet)
against the JAX package on the same numpy inputs, on the CPU: each
functional forward and gradient in f32 and bf16, ``amp.decorate`` at O2
on the new layers, resnet18's loss, gradients and BatchNorm buffers
(the JAX weights carried across by ``resnet_state_from_reference``,
which passes them as they are: the port's ResNet is an ``nn.Layer``
with the JAX names and shapes), five
``jit.train_step`` losses under ``FLAGS_fused_optimizer_step`` with
``Momentum(multi_precision=True)``, and resnet50's names, shapes, size
and an f32 forward.

Tolerances, each beside its assertion, measured against these inputs:
- f32 functionals: 1e-5 of the result's largest magnitude (the two
  frameworks sum in different orders);
- bf16 functionals: a few bf16 rounding steps (2**-8 relative) of the
  result's largest magnitude: both round to bf16, at different places
  (XLA keeps a fused bf16 chain in f32 where torch rounds each op);
- resnet18 at 32x32, batch 4, f32: the loss to 1e-5 relative, buffers
  to 1e-5 of their largest magnitude, gradients to 1e-3 of each
  gradient's largest magnitude: the last stage's BatchNorm normalizes 4
  values a channel, and each framework's f32 gradients land 1e-4 to
  2.5e-4 of the largest magnitude from an f64 run of the same model;
- train_step at 64x64 (``bench.py``'s CPU profile for this model, 16
  values a channel in the last stage) with lr 1e-4: f32 losses to 1e-5
  relative; bf16 O2 losses to 2e-2 relative (each framework's bf16
  losses lie within ~2 % of the f32 ones). A larger step is chaotic at
  batch 4: a 1e-5 gradient difference grows to 10 % loss differences in
  f32 within five steps at lr 1e-2, so no tolerance would test anything.
"""

import numpy as np
import pytest
import torch

import paddle2_tpu as paddle
import paddle2_tpu_torch as tp
import paddle2_tpu.nn.functional as JF
import paddle2_tpu.optimizer as jopt
from paddle2_tpu import flags as jflags
from paddle2_tpu.framework.tensor import Tensor
from paddle2_tpu.vision.models import resnet18 as jax_resnet18
from paddle2_tpu.vision.models import resnet50 as jax_resnet50
from paddle2_tpu_torch import amp, flags, jit
from paddle2_tpu_torch import nn as tnn
from paddle2_tpu_torch.framework.core import place_scope
from paddle2_tpu_torch.kernels import fused_momentum as fm
from paddle2_tpu_torch.models import resnet_state_from_reference
from paddle2_tpu_torch.nn import functional as F
from paddle2_tpu_torch.optimizer import Momentum
from paddle2_tpu_torch.vision.models import (BottleneckBlock, ResNet,
                                             resnet18, resnet50)
from torch_core_harness import port_on_cpu  # noqa: F401

BF16_STEP = 2.0 ** -8


def _near(got, want, tol):
    """``|got - want| <= tol * max|want|``, elementwise; equal when
    ``tol`` is 0 (infinities included)."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    if tol == 0:
        np.testing.assert_array_equal(got, want)
        return
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{err} > {tol} * {scale}"


def _run_jax(fn, arrays, dtypes, dy):
    """``fn`` over JAX leaves cast to ``dtypes``; the output (as f32) and
    the leaves' gradients of ``sum(out * dy)``."""
    leaves = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    ins = [t if dt == "float32" else t.astype(dt)
           for t, dt in zip(leaves, dtypes)]
    out = fn(*ins).astype("float32")
    (out * paddle.to_tensor(dy)).sum().backward()
    return np.asarray(out.numpy()), [np.asarray(t.grad.numpy())
                                     for t in leaves]


def _run_torch(fn, arrays, dtypes, dy):
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    ins = [t.to(getattr(torch, dt)) for t, dt in zip(leaves, dtypes)]
    out = fn(*ins).float()
    (out * torch.from_numpy(dy)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def _check(jfn, tfn, arrays, dtypes, out_shape, tol, grad_tols=(),
           seed=9):
    """The output and every gradient to ``tol`` (``grad_tols`` overrides
    it per gradient); returns the port's gradients and ``dy``."""
    dy = np.random.default_rng(seed).normal(size=out_shape).astype(
        np.float32)
    jo, jg = _run_jax(jfn, arrays, dtypes, dy)
    to, tg = _run_torch(tfn, arrays, dtypes, dy)
    _near(to, jo, tol)
    for i, (a, b) in enumerate(zip(tg, jg)):
        _near(a, b, grad_tols[i] if i < len(grad_tols) else tol)
    return tg, dy


DTYPES = {"f32": ("float32", 1e-5), "bf16": ("bfloat16", 2 * BF16_STEP)}

# (stride, padding, groups, dilation, data_format, bias)
CONV_CASES = {
    "plain": (1, 0, 1, 1, "NCHW", True),
    "stem_s2_p3": (2, 3, 1, 1, "NCHW", False),
    "per_axis": (1, [1, 2], 1, 1, "NCHW", True),
    "per_side": (2, [0, 1, 2, 0], 1, 1, "NCHW", False),
    "same_s2": (2, "SAME", 1, 1, "NCHW", True),
    "valid": (1, "valid", 1, 1, "NCHW", False),
    "groups": (1, 1, 2, 1, "NCHW", True),
    "dilated_same": (1, "SAME", 1, 2, "NCHW", False),
    "nhwc": (2, 1, 1, 1, "NHWC", True),
}


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv2d_matches_jax(case, dt):
    stride, padding, groups, dilation, fmt, with_bias = CONV_CASES[case]
    rng = np.random.default_rng(0)
    k = 7 if case == "stem_s2_p3" else 3
    x = rng.normal(size=(2, 4, 11, 10)).astype(np.float32)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w = (rng.normal(size=(6, 4 // groups, k, k)) * 0.3).astype(np.float32)
    arrays = [x, w] + ([rng.normal(size=(6,)).astype(np.float32)]
                       if with_bias else [])
    dtype, tol = DTYPES[dt]
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups, data_format=fmt)
    out_shape = tuple(F.conv2d(*[torch.from_numpy(a) for a in arrays],
                               **kw).shape)
    # bf16: the bias gradient sums the bf16 output gradient over N*H*W
    # (144 to 198 terms here); JAX's CPU reduction accumulates in bf16
    # (3.4e-2 of the largest magnitude from the port's here), torch's in
    # f32 with one rounding, which is held to the f64 sum just below
    bias_tol = 5e-2 if dt == "bf16" else tol
    tg, dy = _check(lambda *a: JF.conv2d(*a, **kw),
                    lambda *a: F.conv2d(*a, **kw), arrays,
                    [dtype] * len(arrays), out_shape, tol,
                    grad_tols=(tol, tol, bias_tol))
    if with_bias and dt == "bf16":
        axes = (0, 2, 3) if fmt == "NCHW" else (0, 1, 2)
        exact = torch.from_numpy(dy).bfloat16().double().sum(axes).numpy()
        _near(tg[2], exact, BF16_STEP)          # one bf16 rounding


def _bn_inputs(seed, fmt="NCHW"):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(4, 5, 6, 7)) * 2 + 0.5).astype(np.float32)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w = rng.uniform(0.5, 1.5, size=(5,)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    rm = rng.normal(size=(5,)).astype(np.float32)
    rv = rng.uniform(0.5, 2.0, size=(5,)).astype(np.float32)
    return x, w, b, rm, rv


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_batch_norm_matches_jax(dt, training, fmt):
    """The output, the gradients of x, γ and β, and both running
    buffers after the call (updated in place in training mode, read in
    eval mode); bf16 is a bf16 x with f32 γ/β, as AMP O2 gives. The
    buffers are f32: 1e-6 of their largest magnitude in f32; in bf16
    they take one tenth of a bf16 statistic, and two roundings of it
    differ by a bf16 step: 2**-8 of the buffer's largest magnitude."""
    x, w, b, rm, rv = _bn_inputs(1, fmt)
    dtype, tol = DTYPES[dt]
    jrm, jrv = Tensor(rm.copy()), Tensor(rv.copy())
    trm, trv = torch.tensor(rm), torch.tensor(rv)
    kw = dict(training=training, momentum=0.9, epsilon=1e-5,
              data_format=fmt)
    _check(lambda a, g, c: JF.batch_norm(a, jrm, jrv, g, c, **kw),
           lambda a, g, c: F.batch_norm(a, trm, trv, g, c, **kw),
           [x, w, b], [dtype, "float32", "float32"], x.shape, tol)
    btol = 1e-6 if dt == "f32" else BF16_STEP
    for got, want in ((trm, jrm), (trv, jrv)):
        assert got.dtype == torch.float32
        _near(got.numpy(), want.numpy(), btol)
    if not training:
        assert np.array_equal(trm.numpy(), rm)
    else:
        # the population variance, with Paddle's momentum (0.9 kept)
        axes = (0, 2, 3) if fmt == "NCHW" else (0, 1, 2)
        _near(trv.numpy(), 0.9 * rv + 0.1 * x.var(axes),
              1e-6 if dt == "f32" else BF16_STEP)


# (kernel, stride, padding, ceil_mode, data_format)
POOL_CASES = {
    "stem": (3, 2, 1, False, "NCHW"),
    "k2s2": (2, 2, 0, False, "NCHW"),
    "ceil": (3, 2, 0, True, "NCHW"),
    "ceil_padded": (2, 2, 1, True, "NCHW"),
    "same": (3, 2, "SAME", False, "NCHW"),
    "per_side": ((3, 2), (2, 1), [0, 1, 1, 0], False, "NCHW"),
    "wide_padding": (3, 1, 2, False, "NCHW"),
    "nhwc": (3, 2, 1, False, "NHWC"),
}


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(POOL_CASES))
def test_max_pool2d_matches_jax(case, dt):
    """Distinct input values (a shuffled range, exact in bf16): which
    tap of a tied window takes the gradient is not part of the contract,
    and the two frameworks may differ there. A max is exact, so the
    output and the routed gradients agree exactly."""
    kernel, stride, padding, ceil_mode, fmt = POOL_CASES[case]
    shape = (2, 3, 9, 8) if fmt == "NCHW" else (2, 9, 8, 3)
    x = np.random.default_rng(2).permutation(np.prod(shape)).reshape(
        shape).astype(np.float32) / 4 - 20
    kw = dict(kernel_size=kernel, stride=stride, padding=padding,
              ceil_mode=ceil_mode, data_format=fmt)
    out_shape = tuple(F.max_pool2d(torch.from_numpy(x), **kw).shape)
    _check(lambda a: JF.max_pool2d(a, **kw), lambda a: F.max_pool2d(a, **kw),
           [x], [DTYPES[dt][0]], out_shape, 0.0)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("size", [1, (2, 3), 3, (7, 2)],
                         ids=["1", "2x3", "3", "7x2"])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_adaptive_avg_pool2d_matches_jax(fmt, size, dt):
    """Two means, H then W, each rounded in bf16 as the JAX package
    rounds them; uneven bins (7 into 3, 5 into 2) overlap."""
    shape = (2, 3, 7, 5) if fmt == "NCHW" else (2, 7, 5, 3)
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    dtype, tol = DTYPES[dt]
    out_shape = tuple(F.adaptive_avg_pool2d(torch.from_numpy(x), size,
                                            fmt).shape)
    _check(lambda a: JF.adaptive_avg_pool2d(a, size, fmt),
           lambda a: F.adaptive_avg_pool2d(a, size, fmt), [x], [dtype],
           out_shape, tol)


def test_adaptive_avg_pool2d_rounds_each_axis_in_bf16():
    """One ``mean((2, 3))`` rounds once; the port rounds after each
    axis, as the JAX package does."""
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 64, 7, 7)).astype(np.float32)).bfloat16()
    two = x.mean(2, keepdim=True).mean(3, keepdim=True)
    assert torch.equal(F.adaptive_avg_pool2d(x, 1), two)
    assert not torch.equal(two, x.mean((2, 3), keepdim=True))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("label_shape", ["n", "n1"])
def test_cross_entropy_matches_jax(label_shape, dt):
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(6, 10)) * 3).astype(np.float32)
    labels = rng.integers(0, 10, size=(6,)).astype(np.int32)
    labels[2] = -100                                  # ignored
    if label_shape == "n1":
        labels = labels[:, None]
    dtype, tol = DTYPES[dt]
    jl = Tensor(labels)
    tl = torch.from_numpy(labels)
    _check(lambda a: JF.cross_entropy(a, jl), lambda a: F.cross_entropy(
        a, tl), [logits], [dtype], (), tol)


@pytest.mark.parametrize("kwargs", [
    dict(soft_label=True), dict(reduction="sum"), dict(label_smoothing=0.1),
    dict(weight=np.linspace(0.5, 2.0, 10).astype(np.float32)),
    dict(use_softmax=False), dict(axis=0)],
    ids=["soft", "sum", "smoothing", "weight", "no_softmax", "axis0"])
def test_cross_entropy_unported_options_raise(kwargs):
    """The options once refused here are ported: each matches the JAX
    function, loss and input gradient, in f32 (the name is kept from
    when they raised)."""
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(4, 10)).astype(np.float32)
    if kwargs.get("soft_label"):
        labels = rng.dirichlet(np.ones(10), size=4).astype(np.float32)
    elif kwargs.get("axis") == 0:
        labels = rng.integers(0, 4, size=(10,)).astype(np.int32)
    else:
        labels = rng.integers(0, 10, size=(4,)).astype(np.int32)
    if kwargs.get("use_softmax") is False:
        logits = rng.dirichlet(np.ones(10), size=4).astype(np.float32)
    w = kwargs.get("weight")
    jkw = dict(kwargs, **({} if w is None else dict(weight=Tensor(w))))
    tkw = dict(kwargs, **({} if w is None else
                          dict(weight=torch.from_numpy(w))))
    jl, tl = Tensor(labels), torch.from_numpy(labels)
    _check(lambda a: JF.cross_entropy(a, jl, **jkw),
           lambda a: F.cross_entropy(a, tl, **tkw), [logits], ["float32"],
           (), 1e-5)


def test_layers_keep_the_jax_constructors():
    """The layers' Paddle constructors (built on the CPU, which the
    port's layers ask for as the current place)."""
    with place_scope("cpu"):
        conv = tnn.Conv2D(4, 6, 3, stride=2, padding=1, bias_attr=False)
        assert conv.bias is None
        assert tuple(conv.weight.shape) == (6, 4, 3, 3)
        assert conv.weight.abs().max() <= 1 / np.sqrt(4 * 9)
        assert tnn.Conv2D(4, 6, (3, 1), groups=2).weight.shape == \
            (6, 2, 3, 1)
        bn = tnn.BatchNorm2D(8)
        assert (bn._momentum, bn._epsilon) == (0.9, 1e-5)
        assert torch.equal(bn.weight, torch.ones(8))
        assert torch.equal(bn.bias, torch.zeros(8))
        assert dict(bn.named_buffers()).keys() == {"_mean", "_variance"}
        assert torch.equal(bn._mean, torch.zeros(8))
        assert torch.equal(bn._variance, torch.ones(8))
        x = torch.randn(1, 3, 8, 8)
        assert tnn.MaxPool2D(3, 2, 1)(x).shape == (1, 3, 4, 4)
        assert tnn.AdaptiveAvgPool2D((1, 1))(x).shape == (1, 3, 1, 1)
        with pytest.raises(NotImplementedError):
            tnn.Conv2D(4, 6, 3, padding_mode="reflect")
        with pytest.raises(NotImplementedError):
            F.max_pool2d(x.permute(0, 2, 3, 1), 2, return_mask=True,
                         data_format="NHWC")


def _pair(make_jax, make_torch, seed=0):
    """The JAX model and the port's with the JAX model's f32 weights."""
    paddle.seed(seed)
    jm = make_jax()
    state = {k: np.asarray(v.numpy(), np.float32)
             for k, v in jm.state_dict().items()}
    tm = make_torch()
    tm.load_state_dict(resnet_state_from_reference(state))
    return jm, tm


def _images(batch, size, classes, seed=0):
    rs = np.random.RandomState(seed)
    img = (rs.randn(batch, 3, size, size) * 0.5).astype(np.float32)
    return img, rs.randint(0, classes, (batch,)).astype(np.int32)


def test_amp_o2_keeps_batch_norm_f32():
    """O2 casts the convolutions and ``fc`` to bf16 and keeps every
    BatchNorm parameter, and the buffers, in f32: the dtypes of the JAX
    package's ``amp.decorate``, name by name."""
    jm, tm = _pair(lambda: jax_resnet18(num_classes=10),
                   lambda: resnet18(num_classes=10))
    jm = paddle.amp.decorate(jm, level="O2", dtype="bfloat16")
    tm = amp.decorate(tm, level="O2", dtype="bfloat16")
    jdt = {n: str(p._data.dtype) for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        want = "float32" if ".bn" in n or n.startswith("bn") or \
            "downsample.1" in n else "bfloat16"
        assert (str(p.dtype).replace("torch.", ""), jdt[n]) == (want, want), n
    assert all(b.dtype == torch.float32 for b in tm.buffers())


def test_resnet18_loss_grads_and_buffers_match_jax():
    jm, tm = _pair(lambda: jax_resnet18(num_classes=10),
                   lambda: resnet18(num_classes=10))
    img, lbl = _images(4, 32, 10)
    jloss = JF.cross_entropy(jm(Tensor(img)).astype("float32"), Tensor(lbl))
    jloss.backward()
    tloss = F.cross_entropy(tm(torch.from_numpy(img)).float(),
                            torch.from_numpy(lbl))
    tloss.backward()
    # the loss: 1e-5 relative
    np.testing.assert_allclose(tloss.item(), float(jloss.numpy()), rtol=1e-5)
    jgrads = {n: np.asarray(p.grad.numpy()) for n, p in
              jm.named_parameters()}
    names = [n for n, _ in tm.named_parameters()]
    assert names == list(jgrads)
    for n, p in tm.named_parameters():
        _near(p.grad.numpy(), jgrads[n], 1e-3)  # see the module docstring
    jbufs = {n: np.asarray(b.numpy()) for n, b in jm.named_buffers()}
    tbufs = dict(tm.named_buffers())
    assert tbufs.keys() == jbufs.keys()
    for n, b in tbufs.items():
        _near(b.numpy(), jbufs[n], 1e-5)      # one forward's update


@pytest.fixture
def fused_flag():
    """``FLAGS_fused_optimizer_step`` on in both packages, restored after
    the test (the flags are process-global)."""
    before = (jflags.get_flags("FLAGS_fused_optimizer_step"),
              flags.get_flags("fused_optimizer_step"))
    jflags.set_flags({"FLAGS_fused_optimizer_step": True})
    flags.set_flags({"fused_optimizer_step": True})
    yield
    jflags.set_flags(before[0])
    flags.set_flags(before[1])


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16_o2"])
def test_train_step_losses_track_jax(fused_flag, monkeypatch, bf16):
    """Five ``jit.train_step`` calls of ``bench_resnet50``'s CPU profile
    (resnet18, 10 classes, 64x64, batch 4) with ``Momentum(lr=1e-4,
    momentum=0.9, multi_precision=True)`` and ``fused=None`` under the
    flag, in f32 or AMP O2 bf16, on both packages from the same weights
    and images: the losses track (tolerances in the module docstring),
    and the port's fused route runs once a parameter tensor a step."""
    calls = []
    plain = fm.momentum_step_reference
    monkeypatch.setattr(fm, "momentum_step_reference",
                        lambda *a: calls.append(1) or plain(*a))
    jm, tm = _pair(lambda: jax_resnet18(num_classes=10),
                   lambda: resnet18(num_classes=10))
    if bf16:
        jm = paddle.amp.decorate(jm, level="O2", dtype="bfloat16")
        tm = amp.decorate(tm, level="O2", dtype="bfloat16")
    jo = jopt.Momentum(learning_rate=1e-4, momentum=0.9,
                       parameters=jm.parameters(), multi_precision=True)
    to = Momentum(learning_rate=1e-4, momentum=0.9,
                  parameters=tm.parameters(), multi_precision=True)
    jstep = paddle.jit.train_step(
        lambda i, l: JF.cross_entropy(jm(i).astype("float32"), l), jo)
    tstep = jit.train_step(
        lambda i, l: F.cross_entropy(tm(i).float(), l), to)
    rs = np.random.RandomState(0)
    jl, tl = [], []
    for _ in range(5):
        img = (rs.randn(4, 3, 64, 64) * 0.5).astype(np.float32)
        lbl = rs.randint(0, 10, (4,)).astype(np.int32)
        ji = paddle.to_tensor(img)
        ti = torch.from_numpy(img)
        if bf16:
            ji, ti = ji.astype("bfloat16"), ti.bfloat16()
        jl.append(float(jstep(ji, paddle.to_tensor(lbl)).numpy()))
        tl.append(float(tstep(ti, torch.from_numpy(lbl))))
    np.testing.assert_allclose(tl, jl, rtol=2e-2 if bf16 else 1e-5)
    assert len(calls) == 5 * len(list(tm.parameters()))
    if not bf16:
        # the running statistics after five steps: 1e-5 of each buffer's
        # largest magnitude, as after one forward
        jbufs = {n: np.asarray(b.numpy()) for n, b in jm.named_buffers()}
        for n, b in tm.named_buffers():
            _near(b.numpy(), jbufs[n], 1e-5)


def test_train_step_updates_batch_norm_buffers_once():
    """A ``train_step`` in training mode folds the batch's statistics
    into every ``_mean``/``_variance`` exactly once (bitwise what one
    training-mode forward of a copy does); in eval mode it leaves them
    as they are."""
    tp.seed(2)
    model = resnet18(num_classes=10)
    tp.seed(2)
    twin = resnet18(num_classes=10)
    step = jit.train_step(lambda i, l: F.cross_entropy(model(i), l),
                          Momentum(parameters=model.parameters()))
    img, lbl = (torch.from_numpy(a) for a in _images(2, 32, 10))
    step(img, lbl)
    with torch.no_grad():
        twin(img)
    for a, b in zip(model.buffers(), twin.buffers()):
        assert torch.equal(a, b)
    model.eval()
    before = [b.clone() for b in model.buffers()]
    step(img, lbl)
    assert all(torch.equal(a, b) for a, b in zip(model.buffers(), before))


def test_resnet50_names_shapes_and_size_match_jax():
    """Every parameter and buffer name and shape, in the JAX order,
    25,557,032 parameters in 161 tensors, 53 convolutions and 53
    BatchNorms."""
    paddle.seed(0)
    jm = jax_resnet50(num_classes=1000)
    jstate = {n: tuple(v.shape) for n, v in jm.state_dict().items()}
    tm = resnet50(num_classes=1000)
    tstate = {n: tuple(v.shape) for n, v in tm.state_dict().items()}
    assert list(tstate) == list(jstate)
    for n, shape in tstate.items():
        assert shape == jstate[n], n
    assert sum(p.numel() for p in tm.parameters()) == 25_557_032
    assert len(list(tm.parameters())) == 161
    assert sum(isinstance(m, tnn.Conv2D) for m in tm.modules()) == 53
    assert sum(isinstance(m, tnn.BatchNorm2D) for m in tm.modules()) == 53
    assert sum(p.size for p in jm.parameters()) == 25_557_032


def test_resnet50_forward_matches_jax():
    """An f32 forward at 32x32, batch 2, in eval mode (the running
    statistics as built): logits to 1e-5 of their largest magnitude. In
    training mode the last stage would normalize 2 values a channel,
    which leaves nothing to compare."""
    jm, tm = _pair(lambda: jax_resnet50(num_classes=1000),
                   lambda: resnet50(num_classes=1000))
    jm.eval()
    tm.eval()
    img, _ = _images(2, 32, 1000, seed=1)
    want = np.asarray(jm(Tensor(img)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(img)).numpy()
    _near(got, want, 1e-5)


def test_model_entry_points():
    with pytest.raises(ValueError, match="pretrained"):
        resnet18(pretrained=True)
    m = ResNet(BottleneckBlock, 50, num_classes=0, with_pool=False)
    assert not hasattr(m, "fc") and not hasattr(m, "avgpool")
    assert m(torch.zeros(1, 3, 32, 32)).shape == (1, 2048, 1, 1)
    tp.seed(3)
    a = resnet18(num_classes=10)
    tp.seed(3)
    b = resnet18(num_classes=10)
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
