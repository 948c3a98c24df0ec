"""Activation layers: the counterpart of
``paddle2_tpu/nn/layer/activation.py``, over the port's functionals.
As in the JAX package, a layer's positional arguments (or, with none
given, its defaults) and keywords go to its functional as they are;
``RReLU`` draws its slopes in training and in eval mode alike, as the
JAX layer calls ``F.rrelu`` with its default ``training=True``."""

from __future__ import annotations

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["ReLU", "ReLU6", "ELU", "SELU", "CELU", "GELU", "Sigmoid", "Silu",
           "Swish", "Mish", "Softplus", "Softshrink", "Hardshrink",
           "Tanhshrink", "Hardtanh", "Hardsigmoid", "Hardswish", "LeakyReLU",
           "LogSigmoid", "LogSoftmax", "Softmax", "Softsign", "Tanh", "Maxout",
           "PReLU", "RReLU", "GLU", "ThresholdedReLU"]


def _simple(name, fn, *defaults):
    class _Act(Layer):
        def __init__(self, *args, name=None, **kwargs):
            super().__init__()
            self.args = args if args else defaults
            self.kwargs = kwargs

        def forward(self, x):
            return fn(x, *self.args, **self.kwargs)
    _Act.__name__ = _Act.__qualname__ = name
    return _Act


ReLU = _simple("ReLU", F.relu)
ReLU6 = _simple("ReLU6", F.relu6)
ELU = _simple("ELU", F.elu)
SELU = _simple("SELU", F.selu)
CELU = _simple("CELU", F.celu)
GELU = _simple("GELU", F.gelu)
Sigmoid = _simple("Sigmoid", F.sigmoid)
Silu = _simple("Silu", F.silu)
Swish = _simple("Swish", F.swish)
Mish = _simple("Mish", F.mish)
Softplus = _simple("Softplus", F.softplus)
Softshrink = _simple("Softshrink", F.softshrink)
Hardshrink = _simple("Hardshrink", F.hardshrink)
Tanhshrink = _simple("Tanhshrink", F.tanhshrink)
Hardtanh = _simple("Hardtanh", F.hardtanh)
Hardsigmoid = _simple("Hardsigmoid", F.hardsigmoid)
Hardswish = _simple("Hardswish", F.hardswish)
LeakyReLU = _simple("LeakyReLU", F.leaky_relu)
LogSigmoid = _simple("LogSigmoid", F.log_sigmoid)
Softsign = _simple("Softsign", F.softsign)
Tanh = _simple("Tanh", F.tanh)
GLU = _simple("GLU", F.glu)
ThresholdedReLU = _simple("ThresholdedReLU", F.thresholded_relu)
RReLU = _simple("RReLU", F.rrelu)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, axis=self.axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.log_softmax(x, axis=self.axis)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups, self.axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self.groups, self.axis)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)
