"""Activation functionals: the counterpart of
``paddle2_tpu/nn/functional/activation.py``.

Each is the JAX function's formula in torch, under the JAX op's name
for the AMP cast (:func:`~paddle2_tpu_torch.amp.casting.amp_op`). The
JAX package writes them as XLA elementwise graphs, not Pallas kernels,
so plain torch here is the port of that path. ``rrelu`` (in training)
and ``gumbel_softmax`` draw from the port's generator of the input's
device; their draws are f32, as JAX's are, so a bfloat16 input gives a
float32 output there as it does in the JAX package.

The in-place forms (``relu_``, ``softmax_``) are torch's in-place ops:
``x`` itself is updated and returned, and, as in torch, a leaf that
requires grad cannot be updated in place.
"""

from __future__ import annotations

import torch
from torch.nn import functional as TF

from ...amp.casting import amp_op
from ...framework import core
from ...framework import random as fr

__all__ = ["relu", "relu_", "relu6", "elu", "selu", "celu", "gelu", "silu",
           "swish", "mish", "softplus", "softshrink", "hardshrink",
           "tanhshrink", "hardtanh", "hardsigmoid", "hardswish", "leaky_relu",
           "log_sigmoid", "log_softmax", "softmax", "softmax_", "softsign",
           "sigmoid", "tanh", "maxout", "prelu", "rrelu", "glu",
           "gumbel_softmax", "thresholded_relu"]


def _unary(name, fn):
    @amp_op(name)
    def op(x, *args, name=None, **kwargs):
        return fn(x, *args, **kwargs)
    op.__name__ = op.__qualname__ = name
    return op


relu = _unary("relu", torch.relu)
relu6 = _unary("relu6", lambda a: TF.hardtanh(a, 0.0, 6.0))
sigmoid = _unary("sigmoid", torch.sigmoid)
tanh = _unary("tanh", torch.tanh)
softsign = _unary("softsign", TF.softsign)
silu = _unary("silu", TF.silu)
log_sigmoid = _unary("log_sigmoid", TF.logsigmoid)
# jax.nn.softplus is logaddexp(x, 0), with no threshold
mish = _unary("mish", lambda a: a * torch.tanh(torch.logaddexp(
    a, torch.zeros((), dtype=a.dtype, device=a.device))))


def relu_(x, name=None):
    return torch.relu_(x)


@amp_op("elu")
def elu(x, alpha=1.0, name=None):
    return TF.elu(x, alpha)


@amp_op("selu")
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@amp_op("celu")
def celu(x, alpha=1.0, name=None):
    return TF.celu(x, alpha)


@amp_op("gelu")
def gelu(x, approximate=False, name=None):
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def swish(x, name=None):
    return silu(x)


@amp_op("softplus")
def softplus(x, beta=1.0, threshold=20.0, name=None):
    scaled = beta * x
    return torch.where(scaled > threshold, x,
                       torch.log1p(torch.exp(torch.clamp(
                           scaled, max=threshold))) / beta)


@amp_op("softshrink")
def softshrink(x, threshold=0.5, name=None):
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, 0.0))


@amp_op("hardshrink")
def hardshrink(x, threshold=0.5, name=None):
    return torch.where(x.abs() > threshold, x, 0.0)


@amp_op("tanhshrink")
def tanhshrink(x, name=None):
    return x - torch.tanh(x)


@amp_op("hardtanh")
def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(x, min, max)


@amp_op("hardsigmoid")
def hardsigmoid(x, slope=1.0 / 6, offset=0.5, name=None):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


@amp_op("hardswish")
def hardswish(x, name=None):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


@amp_op("leaky_relu")
def leaky_relu(x, negative_slope=0.01, name=None):
    return TF.leaky_relu(x, negative_slope)


@amp_op("thresholded_relu")
def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return torch.where(x > threshold, x, value)


@amp_op("softmax")
def softmax(x, axis=-1, dtype=None, name=None):
    dt = core.convert_dtype(dtype)
    return torch.softmax(x if dt is None else x.to(dt), dim=axis)


def softmax_(x, axis=-1, dtype=None, name=None):
    # softmax's backward reads its output, not x: copying the result
    # into x keeps the graph whole
    return x.copy_(softmax(x, axis, dtype))


@amp_op("log_softmax")
def log_softmax(x, axis=-1, dtype=None, name=None):
    dt = core.convert_dtype(dtype)
    return torch.log_softmax(x if dt is None else x.to(dt), dim=axis)


@amp_op("maxout")
def maxout(x, groups, axis=1, name=None):
    ax = axis % x.ndim
    c = x.shape[ax]
    shape = tuple(x.shape[:ax]) + (c // groups, groups) + \
        tuple(x.shape[ax + 1:])
    return x.reshape(shape).amax(dim=ax + 1)


@amp_op("prelu")
def prelu(x, weight, data_format="NCHW", name=None):
    w = weight
    if w.numel() > 1:
        shape = [1] * x.ndim
        shape[1 if data_format == "NCHW" else x.ndim - 1] = w.numel()
        w = w.reshape(shape)
    return torch.where(x > 0, x, w * x)


@amp_op("rrelu")
def rrelu(x, lower=0.125, upper=1.0 / 3, training=True, name=None):
    if training:
        slope = torch.empty(tuple(x.shape), dtype=torch.float32,
                            device=x.device).uniform_(
            lower, upper, generator=fr.generator(x.device))
        return torch.where(x >= 0, x, slope * x)
    return torch.where(x >= 0, x, (lower + upper) / 2.0 * x)


@amp_op("glu")
def glu(x, axis=-1, name=None):
    return TF.glu(x, dim=axis)


class _StraightThrough(torch.autograd.Function):
    """The one-hot forward, bit for bit, with the soft sample's
    gradient (JAX's custom_vjp ``st``)."""

    @staticmethod
    def forward(ctx, soft, onehot):
        return onehot

    @staticmethod
    def backward(ctx, grad):
        return grad, None


@amp_op("gumbel_softmax")
def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    u = torch.empty(tuple(x.shape), dtype=torch.float32,
                    device=x.device).uniform_(
        1e-20, 1.0, generator=fr.generator(x.device))
    g = -torch.log(-torch.log(u))
    y = torch.softmax((x + g) / temperature, dim=axis)
    if not hard:
        return y
    idx = y.argmax(dim=axis, keepdim=True)
    onehot = torch.zeros_like(y).scatter_(axis, idx, 1.0)
    return _StraightThrough.apply(y, onehot)
