"""LayerNorm and BatchNorm2D with the JAX package's routes and
mixed-precision numerics.

``BatchNorm2D`` is the counterpart of
``paddle2_tpu/nn/layer/norm.py:18-62``: Paddle's ``momentum=0.9`` and
``epsilon=1e-5``, weight ones and bias zeros (``weight_attr=False`` /
``bias_attr=False`` drop them), and the f32 buffers ``_mean`` (zeros)
and ``_variance`` (ones) under those names. Its forward is
:func:`paddle2_tpu_torch.nn.functional.batch_norm`, with the batch's
statistics in training mode and the running ones in eval mode.

The layer is ``torch.nn.LayerNorm`` (same parameters, names and init);
its forward is :func:`paddle2_tpu_torch.nn.functional.layer_norm`, the
counterpart of the JAX package's ``F.layer_norm``: the fused LayerNorm
op under ``FLAGS_pallas_layer_norm``, else the JAX package's rounding
order outside pure f32 (see that module).
"""

import torch
from torch import nn

from .functional import batch_norm, layer_norm

__all__ = ["LayerNorm", "BatchNorm2D"]


class LayerNorm(nn.LayerNorm):
    """``torch.nn.LayerNorm`` whose forward is the port's
    ``layer_norm``."""

    def forward(self, x):
        return layer_norm(x, self.normalized_shape, self.weight, self.bias,
                          self.eps)


class BatchNorm2D(nn.Module):

    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, device=None, dtype=None):
        super().__init__()
        if weight_attr not in (None, True, False) or \
                bias_attr not in (None, True, False):
            raise NotImplementedError(
                "BatchNorm2D takes no parameter attributes but False "
                "(ROADMAP queue 1 item 2)")
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        factory = {"device": device, "dtype": dtype}
        self.weight = None if weight_attr is False else nn.Parameter(
            torch.ones(num_features, **factory))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(num_features, **factory))
        self.register_buffer("_mean", torch.zeros(num_features,
                                                  device=device))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     device=device))

    def forward(self, x):
        return batch_norm(x, self._mean, self._variance, self.weight,
                          self.bias, training=self.training,
                          momentum=self._momentum, epsilon=self._epsilon,
                          data_format=self._data_format,
                          use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}")
