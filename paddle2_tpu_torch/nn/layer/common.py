"""Common layers: the counterpart of ``paddle2_tpu/nn/layer/common.py``.

``Linear`` stores its weight ``[in_features, out_features]`` (Xavier
normal; the bias zeros), as the JAX layer does, so a JAX checkpoint
loads with no transpose. ``Embedding`` draws its table from N(0, 1) and
zeroes the ``padding_idx`` row (a negative one counts from the end).
"""

from __future__ import annotations

import torch

from ...ops.extra import unflatten
from ...ops.manipulation import flatten
from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["FeatureAlphaDropout", "Softmax2D", "Unflatten", "ZeroPad1D",
           "ZeroPad3D", "PairwiseDistance", "Linear", "Embedding", "Dropout",
           "Dropout2D", "Dropout3D", "AlphaDropout", "Flatten", "Pad1D",
           "Pad2D", "Pad3D", "ZeroPad2D", "Upsample", "UpsamplingBilinear2D",
           "UpsamplingNearest2D", "PixelShuffle", "PixelUnshuffle",
           "ChannelShuffle", "CosineSimilarity", "Bilinear", "Identity",
           "Unfold", "Fold", "LinearLowPrecision"]


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, input):
        return input


class Linear(Layer):
    """``y = x W + b`` with ``W`` ``[in_features, out_features]``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal())
        self.bias = self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True,
            default_initializer=I.Constant(0.0))

    def forward(self, input):
        return F.linear(input, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


LinearLowPrecision = Linear  # precision comes from AMP or bf16 parameters


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = (padding_idx if padding_idx is None
                             or padding_idx >= 0
                             else num_embeddings + padding_idx)
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0))
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight[self._padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, input):
        return F.dropout(input, p=self.p, axis=self.axis,
                         training=self.training, mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, input):
        return F.dropout2d(input, p=self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, input):
        return F.dropout3d(input, p=self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, input):
        return F.alpha_dropout(input, p=self.p, training=self.training)


class FeatureAlphaDropout(Layer):
    """Alpha dropout over whole channels."""

    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.feature_alpha_dropout(x, self.p, self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, input):
        return flatten(input, self.start_axis, self.stop_axis)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis = axis
        self.shape = shape

    def forward(self, x):
        return unflatten(x, self.axis, self.shape)


class _PadNd(Layer):
    n = 2

    def __init__(self, padding, mode="constant", value=0.0, data_format=None,
                 name=None):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format or {1: "NCL", 2: "NCHW",
                                           3: "NCDHW"}[self.n]

    def forward(self, input):
        df = {"NCL": "NCW", "NLC": "NWC"}.get(self.data_format,
                                              self.data_format)
        return F.pad(input, self.padding, mode=self.mode, value=self.value,
                     data_format=df)


class Pad1D(_PadNd):
    n = 1


class Pad2D(_PadNd):
    n = 2


class Pad3D(_PadNd):
    n = 3


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, mode="constant", value=0.0,
                         data_format=data_format)


class _ZeroPadNd(Layer):
    """As in the JAX layer, the padding pairs go to ``F.pad`` with its
    default ``NCHW`` rule (an int becomes one pair per spatial dim)."""
    n_spatial = 1

    def __init__(self, padding, data_format=None, name=None):
        super().__init__()
        if isinstance(padding, int):
            padding = [padding, padding] * self.n_spatial
        self.padding = list(padding)

    def forward(self, x):
        return F.pad(x, self.padding, mode="constant", value=0.0)


class ZeroPad1D(_ZeroPadNd):
    n_spatial = 1


class ZeroPad3D(_ZeroPadNd):
    n_spatial = 3


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.align_mode, self.data_format = align_mode, data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0,
                         data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor, self.data_format = upscale_factor, data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor, self.data_format = downscale_factor, \
            data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr)
        self.bias = self.create_parameter([out_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, self.output_sizes, *self.args)


class Softmax2D(Layer):
    """Softmax over the channel axis of ``[N, C, H, W]``."""

    def forward(self, x):
        return F.softmax(x, axis=-3)
