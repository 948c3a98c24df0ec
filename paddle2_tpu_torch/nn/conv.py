"""``Conv2D``: the counterpart of ``paddle2_tpu/nn/layer/conv.py:73-85``.

The weight is ``[O, I/groups, kh, kw]``, drawn as the JAX package
draws it (Kaiming-uniform with slope √5: uniform in ±1/√fan_in, the bias
in the same range); ``bias_attr=False`` drops the bias. The forward is
the port's :func:`~paddle2_tpu_torch.nn.functional.conv2d`, with its
padding rules. Parameter attributes other than False, and a
``padding_mode`` other than zeros, are ROADMAP queue 1 item 2.
"""

import math

import torch
from torch import nn

from .functional import conv2d
from .functional.conv import tuplize

__all__ = ["Conv2D"]


class Conv2D(nn.Module):

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None, dtype=None):
        super().__init__()
        if padding_mode != "zeros" or weight_attr not in (None, True) or \
                bias_attr not in (None, True, False):
            raise NotImplementedError(
                "Conv2D takes padding_mode='zeros' and no parameter "
                "attributes but bias_attr=False (ROADMAP queue 1 item 2)")
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = tuplize(kernel_size, 2)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        factory = {"device": device, "dtype": dtype}
        self.weight = nn.Parameter(torch.empty(
            (out_channels, in_channels // groups) + self._kernel_size,
            **factory))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.empty(out_channels, **factory))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        self.weight.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self._stride, self._padding,
                      self._dilation, self._groups, self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")
