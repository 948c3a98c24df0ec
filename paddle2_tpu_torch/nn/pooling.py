"""``MaxPool2D`` and ``AdaptiveAvgPool2D``: the counterparts of the
layers of ``paddle2_tpu/nn/layer/pooling.py``, over the port's
:func:`~paddle2_tpu_torch.nn.functional.max_pool2d` and
:func:`~paddle2_tpu_torch.nn.functional.adaptive_avg_pool2d`."""

from torch import nn

from .functional import adaptive_avg_pool2d, max_pool2d

__all__ = ["MaxPool2D", "AdaptiveAvgPool2D"]


class MaxPool2D(nn.Module):

    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW"):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.kwargs = dict(return_mask=return_mask, ceil_mode=ceil_mode,
                           data_format=data_format)

    def forward(self, x):
        return max_pool2d(x, self.kernel_size, self.stride, self.padding,
                          **self.kwargs)


class AdaptiveAvgPool2D(nn.Module):

    def __init__(self, output_size, data_format="NCHW"):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return adaptive_avg_pool2d(x, self.output_size, self.data_format)
