"""The conv layers: the counterpart of ``paddle2_tpu/nn/layer/conv.py``.

``_ConvNd`` makes the weight as the JAX one does (``conv.py:39-51``):
``[O, I/groups, *k]``, or ``[I, O/groups, *k]`` for the transposes,
drawn Kaiming-uniform with slope √5 (uniform in ±1/√fan_in with
``fan_in = I/groups * prod(k)``, the transposes' too) and the bias in
the same range; ``bias_attr=False`` drops the bias. The forwards are
the port's functionals, with their layout and padding rules. A
``padding_mode`` other than ``"zeros"`` raises (the JAX layers store it
and pad with zeros all the same); the transposes take none.
"""

import numpy as np

from .. import functional as F
from .. import initializer as I
from ..functional.conv import tuplize
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose"]


class _ConvNd(Layer):
    n = 2
    transpose = False

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format=None,
                 output_padding=0):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(
                f"{type(self).__name__} takes padding_mode='zeros' (the JAX "
                f"package's layers pad with zeros whatever the mode)")
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = tuplize(kernel_size, self.n)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._padding_mode = padding_mode
        self._data_format = data_format
        self._output_padding = output_padding
        if self.transpose:
            shape = (in_channels, out_channels // groups) + self._kernel_size
        else:
            shape = (out_channels, in_channels // groups) + self._kernel_size
        fan_in = (in_channels // groups) * int(np.prod(self._kernel_size))
        bound = 1.0 / np.sqrt(fan_in)
        self.weight = self.create_parameter(
            list(shape), attr=weight_attr,
            default_initializer=I.KaimingUniform(
                fan_in=fan_in, negative_slope=np.sqrt(5.0),
                nonlinearity="leaky_relu"))
        self.bias = self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=I.Uniform(-bound, bound))

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class _Conv(_ConvNd):
    fn = None

    def forward(self, x):
        return type(self).fn(x, self.weight, self.bias, self._stride,
                             self._padding, self._dilation, self._groups,
                             self._data_format)


class Conv1D(_Conv):
    n = 1
    fn = staticmethod(F.conv1d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)


class Conv2D(_Conv):
    n = 2
    fn = staticmethod(F.conv2d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)


class Conv3D(_Conv):
    n = 3
    fn = staticmethod(F.conv3d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)


class _ConvTranspose(_ConvNd):
    transpose = True
    fn = None

    def forward(self, x, output_size=None):
        return type(self).fn(x, self.weight, self.bias, self._stride,
                             self._padding, self._output_padding,
                             self._groups, self._dilation, output_size,
                             self._data_format)


class Conv1DTranspose(_ConvTranspose):
    n = 1
    fn = staticmethod(F.conv1d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, output_padding)


class Conv2DTranspose(_ConvTranspose):
    n = 2
    fn = staticmethod(F.conv2d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, output_padding)


class Conv3DTranspose(_ConvTranspose):
    n = 3
    fn = staticmethod(F.conv3d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, output_padding)
