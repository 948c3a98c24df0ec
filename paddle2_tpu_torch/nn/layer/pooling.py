"""``MaxPool2D`` and ``AdaptiveAvgPool2D``: the counterparts of the
layers of ``paddle2_tpu/nn/layer/pooling.py`` (the other pools are
ROADMAP queue 1 item 2), over the port's
:func:`~paddle2_tpu_torch.nn.functional.max_pool2d` and
:func:`~paddle2_tpu_torch.nn.functional.adaptive_avg_pool2d`."""

from .. import functional as F
from .layers import Layer

__all__ = ["MaxPool2D", "AdaptiveAvgPool2D"]


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


class MaxPool2D(_Pool):
    fn = staticmethod(F.max_pool2d)


class _AdaptivePool(Layer):
    fn = None

    def __init__(self, output_size, **kwargs):
        super().__init__()
        self.output_size = output_size
        self.kwargs = kwargs

    def forward(self, x):
        return type(self).fn(x, self.output_size, **self.kwargs)


class AdaptiveAvgPool2D(_AdaptivePool):
    fn = staticmethod(F.adaptive_avg_pool2d)
