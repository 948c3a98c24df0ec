"""The pooling layers: the counterpart of
``paddle2_tpu/nn/layer/pooling.py``, over the port's functionals. As in
the JAX package, ``_Pool`` and ``_AdaptivePool`` pass their keyword
arguments to the functional as they are."""

from .. import functional as F
from .layers import Layer

__all__ = ["AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D", "LPPool1D", "LPPool2D", "MaxUnPool1D",
           "MaxUnPool2D", "MaxUnPool3D", "FractionalMaxPool2D",
           "FractionalMaxPool3D"]


class _Pool(Layer):
    fn = None

    def __init__(self, kernel_size, stride=None, padding=0, **kwargs):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.kwargs = kwargs

    def forward(self, x):
        return type(self).fn(x, self.kernel_size, self.stride, self.padding,
                             **self.kwargs)


class AvgPool1D(_Pool):
    fn = staticmethod(F.avg_pool1d)


class AvgPool2D(_Pool):
    fn = staticmethod(F.avg_pool2d)


class AvgPool3D(_Pool):
    fn = staticmethod(F.avg_pool3d)


class MaxPool1D(_Pool):
    fn = staticmethod(F.max_pool1d)


class MaxPool2D(_Pool):
    fn = staticmethod(F.max_pool2d)


class MaxPool3D(_Pool):
    fn = staticmethod(F.max_pool3d)


class _AdaptivePool(Layer):
    fn = None

    def __init__(self, output_size, **kwargs):
        super().__init__()
        self.output_size = output_size
        self.kwargs = kwargs

    def forward(self, x):
        return type(self).fn(x, self.output_size, **self.kwargs)


class AdaptiveAvgPool1D(_AdaptivePool):
    fn = staticmethod(F.adaptive_avg_pool1d)


class AdaptiveAvgPool2D(_AdaptivePool):
    fn = staticmethod(F.adaptive_avg_pool2d)


class AdaptiveAvgPool3D(_AdaptivePool):
    fn = staticmethod(F.adaptive_avg_pool3d)


class AdaptiveMaxPool1D(_AdaptivePool):
    fn = staticmethod(F.adaptive_max_pool1d)


class AdaptiveMaxPool2D(_AdaptivePool):
    fn = staticmethod(F.adaptive_max_pool2d)


class AdaptiveMaxPool3D(_AdaptivePool):
    fn = staticmethod(F.adaptive_max_pool3d)


class _LPPool(Layer):
    fn = None
    data_format = None

    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format=None, name=None):
        super().__init__()
        self._args = (norm_type, kernel_size, stride, padding, ceil_mode,
                      data_format or type(self).data_format)

    def forward(self, x):
        return type(self).fn(x, *self._args)


class LPPool1D(_LPPool):
    fn = staticmethod(F.lp_pool1d)
    data_format = "NCL"


class LPPool2D(_LPPool):
    fn = staticmethod(F.lp_pool2d)
    data_format = "NCHW"


class _MaxUnPool(Layer):
    fn = None

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format=None, output_size=None, name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.output_size = output_size

    def forward(self, x, indices):
        return type(self).fn(x, indices, self.kernel_size, self.stride,
                             self.padding, output_size=self.output_size)


class MaxUnPool1D(_MaxUnPool):
    fn = staticmethod(F.max_unpool1d)


class MaxUnPool2D(_MaxUnPool):
    fn = staticmethod(F.max_unpool2d)


class MaxUnPool3D(_MaxUnPool):
    fn = staticmethod(F.max_unpool3d)


class _FractionalMaxPool(Layer):
    fn = None

    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self._args = (output_size, kernel_size, random_u, return_mask)

    def forward(self, x):
        return type(self).fn(x, *self._args)


class FractionalMaxPool2D(_FractionalMaxPool):
    fn = staticmethod(F.fractional_max_pool2d)


class FractionalMaxPool3D(_FractionalMaxPool):
    fn = staticmethod(F.fractional_max_pool3d)
