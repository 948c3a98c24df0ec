"""``Conv2D``: the counterpart of ``paddle2_tpu/nn/layer/conv.py:73-85``
(the other conv layers are ROADMAP queue 1 item 2).

The weight is ``[O, I/groups, kh, kw]``, drawn as the JAX package draws
it (Kaiming-uniform with slope √5: uniform in ±1/√fan_in, the bias in
the same range); ``bias_attr=False`` drops the bias. The forward is the
port's :func:`~paddle2_tpu_torch.nn.functional.conv2d`, with its
padding rules. A ``padding_mode`` other than zeros is ROADMAP queue 1
item 2.
"""

import math

import numpy as np
import torch

from .. import functional as F
from .. import initializer as I
from ..functional.conv import tuplize
from .layers import Layer

__all__ = ["Conv2D"]


class Conv2D(Layer):

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(
                "Conv2D takes padding_mode='zeros' (ROADMAP queue 1 item 2)")
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = tuplize(kernel_size, 2)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._padding_mode = padding_mode
        self._data_format = data_format
        fan_in = (in_channels // groups) * int(np.prod(self._kernel_size))
        bound = 1.0 / np.sqrt(fan_in)
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, *self._kernel_size],
            attr=weight_attr,
            default_initializer=I.KaimingUniform(
                fan_in=fan_in, negative_slope=np.sqrt(5.0),
                nonlinearity="leaky_relu"))
        self.bias = self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=I.Uniform(-bound, bound))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Redraw the weight and bias uniform in ±1/√fan_in from
        ``generator`` (a model that seeds its own weights)."""
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        self.weight.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")
