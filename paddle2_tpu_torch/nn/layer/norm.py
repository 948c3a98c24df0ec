"""Norm layers: the counterpart of ``paddle2_tpu/nn/layer/norm.py``.

The batch norms hold Paddle's ``momentum=0.9`` and ``epsilon=1e-5``,
weight ones and bias zeros (``weight_attr=False``/``bias_attr=False``
drop them), and the f32 buffers ``_mean`` (zeros) and ``_variance``
(ones); their forward is :func:`~paddle2_tpu_torch.nn.functional.
batch_norm`, with the batch's statistics in training mode and the
running ones in eval mode. ``SyncBatchNorm`` is ``BatchNorm`` on one
process, as in the JAX package. ``LayerNorm``'s forward is
:func:`~paddle2_tpu_torch.nn.functional.layer_norm`: the fused LayerNorm
kernels under ``FLAGS_pallas_layer_norm``.
"""

from __future__ import annotations

import torch

from ...amp.casting import amp_op
from ...framework import core
from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "LayerNorm", "RMSNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "GroupNorm",
           "LocalResponseNorm", "SpectralNorm"]


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            [num_features], attr=bias_attr, is_bias=True,
            default_initializer=I.Constant(0.0))
        dev = core.current_device()
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance",
                             torch.ones(num_features, device=dev))

    def forward(self, input):
        return F.batch_norm(
            input, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, "NCW" if data_format == "NCL" else "NWC",
                         use_global_stats, name)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name)


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica batch norm; on one process it is BatchNorm."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        out = layer
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            out = cls(layer._num_features, layer._momentum, layer._epsilon,
                      data_format=layer._data_format)
            out.weight.set_value(layer.weight)
            out.bias.set_value(layer.bias)
            out._mean.set_value(layer._mean)
            out._variance.set_value(layer._variance)
        for name, sub in list(layer._sub_layers.items()):
            out._sub_layers[name] = cls.convert_sync_batchnorm(sub)
        return out


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            self._normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            self._normalized_shape, attr=bias_attr, is_bias=True,
            default_initializer=I.Constant(0.0))

    def forward(self, input):
        return F.layer_norm(input, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class RMSNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-6, weight_attr=None,
                 name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            list(normalized_shape), attr=weight_attr,
            default_initializer=I.Constant(1.0))

    def forward(self, input):
        return F.rms_norm(input, self.weight, self._epsilon)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self._data_format = data_format
        if weight_attr is not False:
            self.weight = self.create_parameter(
                [num_features], attr=weight_attr,
                default_initializer=I.Constant(1.0))
            self.bias = self.create_parameter(
                [num_features], attr=bias_attr, is_bias=True,
                default_initializer=I.Constant(0.0))
        else:
            self.weight = None
            self.bias = None

    def forward(self, input):
        return F.instance_norm(input, weight=self.weight, bias=self.bias,
                               eps=self._epsilon,
                               data_format=self._data_format)


class InstanceNorm1D(_InstanceNormBase):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, "NCW")


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 name=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_channels], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            [num_channels], attr=bias_attr, is_bias=True,
            default_initializer=I.Constant(0.0))

    def forward(self, input):
        return F.group_norm(input, self._num_groups, self._epsilon,
                            self.weight, self.bias, self._data_format)


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=0.0001, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, input):
        return F.local_response_norm(input, *self.args)


class SpectralNorm(Layer):
    """A weight divided by its largest singular value, estimated by
    ``power_iters`` power iterations from the stored ``weight_u`` and
    ``weight_v`` (which take no gradient and, as in the JAX layer, are
    not updated); the gradient flows through the iterations."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 dtype="float32"):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._epsilon = epsilon
        h = weight_shape[dim]
        w = 1
        for i, s in enumerate(weight_shape):
            if i != dim:
                w *= s
        self.weight_u = self.create_parameter(
            [h], default_initializer=I.Normal(0.0, 1.0))
        self.weight_u.stop_gradient = True
        self.weight_v = self.create_parameter(
            [w], default_initializer=I.Normal(0.0, 1.0))
        self.weight_v.stop_gradient = True

    def forward(self, weight):
        return _spectral_norm(weight, self.weight_u.detach(),
                              self.weight_v.detach(), self._dim,
                              self._epsilon, self._power_iters)


@amp_op("spectral_norm")
def _spectral_norm(w, u, v, dim, eps, iters):
    wm = w.movedim(dim, 0).reshape(w.shape[dim], -1)
    for _ in range(iters):
        v = wm.T @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = wm @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    return w / (u @ wm @ v)
