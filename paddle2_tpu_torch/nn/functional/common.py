"""Common functionals: the counterpart of
``paddle2_tpu/nn/functional/common.py``.

Each is the JAX function in torch, under the JAX op's name for the AMP
cast. The JAX package computes them in XLA, outside any Pallas kernel,
so plain torch is the port of that path (``linear``'s product is
``torch.matmul``, with the weight ``[in, out]`` as in Paddle). The
dropouts draw their keep masks, and ``class_center_sample`` its extra
classes, from the port's generator of the input's device: the same
``paddle.seed`` gives the same draw (JAX's keys give other bits, so
tests hold them by their statistics).

``interpolate``'s ``nearest`` mode picks ``floor(i * in / out)`` in
float32, as the JAX function does; its other modes are
``jax.image.resize`` ported: separable weight matrices (a triangle
kernel for the linear modes, Keys' cubic with ``a = -0.5`` for
``bicubic``), half-pixel sample positions and, when a dimension
shrinks, the kernel widened to filter (antialiasing). As in the JAX
function, ``align_corners`` and ``align_mode`` change nothing, and
``area`` is the linear kernel.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as TF

from ...amp.casting import amp_op
from ...framework import core
from ...framework import random as fr
from ...ops.dispatch import promote

__all__ = ["feature_alpha_dropout", "linear", "dropout", "dropout2d",
           "dropout3d", "alpha_dropout", "embedding", "one_hot", "pad",
           "zeropad2d", "unfold", "fold", "interpolate", "upsample",
           "pixel_shuffle", "pixel_unshuffle", "channel_shuffle",
           "cosine_similarity", "bilinear", "label_smooth",
           "class_center_sample", "normalize"]


@amp_op("linear")
def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with ``weight`` ``[in_features,
    out_features]``."""
    x, weight = promote(x, weight)
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def _keep_mask(shape, p, device):
    """A Bernoulli(1 - p) keep mask from the port's generator."""
    return torch.rand(tuple(shape), generator=fr.generator(device),
                      device=device) < 1.0 - p


@amp_op("dropout")
def _dropout(x, p, axis, mode):
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = _keep_mask(shape, p, x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)


@amp_op("dropout_infer")
def _scale_infer(x, keep):
    return x * keep


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return _scale_infer(x, 1.0 - p)
        return x.clone()
    return _dropout(x, p, axis, mode)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training)


_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


def alpha_dropout(x, p=0.5, training=True, name=None):
    if not training or p == 0.0:
        return x.clone()
    return _alpha_dropout(x, p)


@amp_op("alpha_dropout")
def _alpha_dropout(x, p):
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    keep = _keep_mask(x.shape, p, x.device)
    a_coef = (1.0 - p + p * alpha_p ** 2) ** -0.5
    b_coef = -a_coef * p * alpha_p
    return (a_coef * torch.where(keep, x, alpha_p) + b_coef).to(x.dtype)


def feature_alpha_dropout(x, p=0.5, training=True, name=None):
    """Alpha dropout over whole feature maps: drops entire channels to
    the SELU saturation value, keeping mean and variance."""
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout probability must be in [0, 1], got {p}")
    if not training or p == 0.0:
        return x
    return _feature_alpha_dropout(x, p)


@amp_op("feature_alpha_dropout")
def _feature_alpha_dropout(x, p):
    alpha_p = -1.7580993408473766  # -scale * alpha of SELU
    if p == 1.0:  # everything dropped: the affine of the constant
        return torch.zeros_like(x)
    keep = _keep_mask(tuple(x.shape[:2]) + (1,) * (x.ndim - 2), p, x.device)
    a = 1.0 / ((1 - p) * (1 + p * alpha_p ** 2)) ** 0.5
    b = -a * alpha_p * p
    return torch.where(keep, x, alpha_p) * a + b


@amp_op("embedding")
def _embedding(x, weight, pad_idx):
    out = TF.embedding(x, weight)
    if pad_idx is not None:
        out = torch.where((x == pad_idx)[..., None], 0.0, out)
    return out


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` for the ids ``x``; ids equal to
    ``padding_idx`` (negative counts from the end) give zeros and no
    gradient."""
    pad_idx = padding_idx
    if pad_idx is not None and pad_idx < 0:
        pad_idx = weight.shape[0] + pad_idx
    return _embedding(x, weight, pad_idx)


def one_hot(x, num_classes, name=None):
    """One-hot rows in the default dtype; an id outside ``[0,
    num_classes)`` gives a row of zeros, as ``jax.nn.one_hot``."""
    classes = torch.arange(num_classes, device=x.device)
    return (x[..., None] == classes).to(core.get_default_dtype())


def _pad_index(n, lo, hi, mode, device):
    """Source indices of a dimension of size ``n`` padded by ``(lo,
    hi)`` in numpy's ``reflect``, ``edge`` or ``wrap`` mode."""
    i = np.arange(-lo, n + hi)
    if mode == "edge":
        i = np.clip(i, 0, n - 1)
    elif mode == "wrap":
        i = np.mod(i, n)
    else:  # reflect, no edge repeat
        period = 2 * (n - 1) if n > 1 else 1
        i = np.abs(np.mod(i, period))
        i = np.where(i >= n, period - i, i)
    return torch.as_tensor(i, dtype=torch.long, device=device)


@amp_op("pad")
def _pad(x, cfg, mode, value):
    if mode == "constant":
        flat = []
        for lo, hi in reversed(cfg):
            flat += [lo, hi]
        return TF.pad(x, flat, mode="constant", value=value)
    out = x
    for ax, (lo, hi) in enumerate(cfg):
        if lo or hi:
            out = out.index_select(
                ax, _pad_index(out.shape[ax], lo, hi, mode, x.device))
    return out


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    if isinstance(pad, torch.Tensor):
        pad = [int(p) for p in pad.reshape(-1).tolist()]
    pad = [int(p) for p in pad]
    nd = x.ndim
    if len(pad) == 2 * nd:
        cfg = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        # Paddle's rule: pad applies to the spatial dims of data_format,
        # listed innermost first (W, H, D)
        n_spatial = len(pad) // 2
        cfg = [(0, 0)] * nd
        first = 2 if data_format.startswith("NC") else 1
        spatial_axes = list(range(first, first + n_spatial))
        for i, ax in enumerate(reversed(spatial_axes)):
            cfg[ax] = (pad[2 * i], pad[2 * i + 1])
    mode = {"constant": "constant", "reflect": "reflect",
            "replicate": "edge", "circular": "wrap"}[mode]
    return _pad(x, cfg, mode, value)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _paddings4(paddings):
    """(top, left, bottom, right) from an int, a pair or a 4-tuple."""
    if isinstance(paddings, int):
        return paddings, paddings, paddings, paddings
    if len(paddings) == 2:
        return paddings[0], paddings[1], paddings[0], paddings[1]
    return tuple(paddings)


@amp_op("unfold")
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``[N, C, H, W]`` -> ``[N, C*kh*kw, L]``."""
    pt, pl, pb, pr = _paddings4(paddings)
    x = TF.pad(x, [pl, pr, pt, pb])
    return TF.unfold(x, _pair(kernel_sizes), dilation=_pair(dilations),
                     stride=_pair(strides))


@amp_op("fold")
def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the adjoint of :func:`unfold`."""
    oh, ow = _pair(output_sizes)
    pt, pl, pb, pr = _paddings4(paddings)
    out = TF.fold(x, (oh + pt + pb, ow + pl + pr), _pair(kernel_sizes),
                  dilation=_pair(dilations), stride=_pair(strides))
    return out[..., pt:pt + oh, pl:pl + ow]


def _triangle(d):
    return torch.clamp(1 - d.abs(), min=0)


def _keys_cubic(d):
    out = ((1.5 * d - 2.5) * d) * d + 1.0
    out = torch.where(d >= 1.0, ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0, out)
    return torch.where(d >= 2.0, 0.0, out)


def _resize_weights(n_in, n_out, kernel, device):
    """``jax.image.scale.compute_weight_mat`` for a resize (scale
    ``n_out / n_in``, no translation, antialiased): ``[n_in, n_out]``
    in float32."""
    scale = np.float32(n_out / n_in)
    inv = np.float32(1.0) / scale
    kscale = max(float(inv), 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * float(inv) - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    w = kernel((sample[None, :] - src[:, None]).abs() / kscale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


@amp_op("interpolate")
def _interpolate(x, spatial_axes, in_sizes, out_sizes, mode):
    if mode == "nearest":
        out = x
        for ax, n_in, n_out in zip(spatial_axes, in_sizes, out_sizes):
            idx = np.floor(np.arange(n_out, dtype=np.float32)
                           * np.float32(n_in / n_out)).astype(np.int64)
            out = out.index_select(ax, torch.as_tensor(idx, device=x.device))
        return out
    kernel = _keys_cubic if mode == "cubic" else _triangle
    out = x if x.is_floating_point() else x.to(torch.float32)
    for ax, n_in, n_out in zip(spatial_axes, in_sizes, out_sizes):
        if n_in == n_out:
            continue
        w = _resize_weights(n_in, n_out, kernel, x.device).to(out.dtype)
        out = torch.tensordot(out, w, dims=([ax], [0])).movedim(-1, ax)
    return out


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    if data_format not in ("NCHW", "NHWC", "NCW", "NWC", "NCDHW", "NDHWC"):
        raise ValueError(f"bad data_format {data_format}")
    n_spatial = x.ndim - 2
    first = 2 if data_format.startswith("NC") else 1
    spatial_axes = list(range(first, first + n_spatial))
    in_sizes = [x.shape[a] for a in spatial_axes]
    if size is not None:
        if isinstance(size, torch.Tensor):
            size = [int(s) for s in size.reshape(-1).tolist()]
        out_sizes = [int(s) for s in
                     (size if isinstance(size, (list, tuple)) else [size])]
    else:
        sf = (scale_factor if isinstance(scale_factor, (list, tuple))
              else [scale_factor] * n_spatial)
        out_sizes = [int(i * float(s)) for i, s in zip(in_sizes, sf)]
    kind = {"nearest": "nearest", "bilinear": "linear", "linear": "linear",
            "trilinear": "linear", "bicubic": "cubic",
            "area": "linear"}[mode]
    return _interpolate(x, spatial_axes, in_sizes, out_sizes, kind)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


@amp_op("pixel_shuffle")
def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, c // (r * r))


@amp_op("pixel_unshuffle")
def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return x.reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = x.shape
    x = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // r, w // r, c * r * r)


@amp_op("channel_shuffle")
def channel_shuffle(x, groups, data_format="NCHW", name=None):
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, groups, c // groups, h, w).transpose(1, 2)
        return x.reshape(n, c, h, w)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, groups, c // groups).transpose(3, 4)
    return x.reshape(n, h, w, c)


@amp_op("cosine_similarity")
def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot = (x1 * x2).sum(dim=axis)
    na = (x1 * x1).sum(dim=axis).sqrt()
    nb = (x2 * x2).sum(dim=axis).sqrt()
    return dot / torch.clamp(na * nb, min=eps)


@amp_op("normalize")
def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    norm = (x.abs() ** p).sum(dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp(norm, min=epsilon)


@amp_op("bilinear")
def bilinear(x1, x2, weight, bias=None, name=None):
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


@amp_op("label_smooth")
def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def class_center_sample(label, num_classes, num_samples, group=None):
    """The classes in ``label`` and, up to ``num_samples`` in all, others
    drawn without replacement from the port's generator; returns the
    labels remapped into the sorted sample, and the sample."""
    dev = label.device
    pos = torch.unique(label.reshape(-1).long())
    n_extra = max(0, num_samples - pos.numel())
    is_pos = torch.zeros(num_classes, dtype=torch.bool, device=dev)
    is_pos[pos] = True
    rest = torch.nonzero(~is_pos).reshape(-1)
    if n_extra and rest.numel():
        order = torch.randperm(rest.numel(), generator=fr.generator(dev),
                               device=dev)
        extra = rest[order[:min(n_extra, rest.numel())]]
    else:
        extra = rest[:0]
    sampled = torch.sort(torch.cat([pos, extra])).values
    remap = torch.full((num_classes,), -1, dtype=torch.long, device=dev)
    remap[sampled] = torch.arange(sampled.numel(), device=dev)
    return (remap[label.long()].to(torch.int32), sampled.to(torch.int32))
