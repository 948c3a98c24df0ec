"""``max_pool2d`` and ``adaptive_avg_pool2d``: the counterparts of
``paddle2_tpu/nn/functional/pooling.py:36-76,89-97`` and ``:147-182``.

Max pooling keeps the JAX package's window rules: padding as
``_pad_cfg`` reads it (an int, one per axis, flat ``(lo, hi)`` pairs,
``"SAME"``/``"VALID"``), padded elements that never win (XLA's
``reduce_window`` starts from ``-inf``), and ``ceil_mode`` as extra
padding at the high end so that a partial trailing window is kept.
torch's ``max_pool2d`` ignores its own padding the same way; it takes
symmetric padding up to half the window, so any other padding is applied
to the input first, with ``-inf``.

Adaptive average pooling is one mean per axis, H first, as
``pooling.py:154-172`` takes it: in bf16 the mean over H is rounded to
bf16 before the mean over W, where one ``mean((2, 3))`` rounds once.
The bins follow Paddle: ``[floor(i*I/O), ceil((i+1)*I/O))``.

``return_mask`` and the other pools are ROADMAP queue 1 item 2.
"""

import math
from typing import Optional, Sequence, Union

import torch
from torch.nn import functional as TF

from .conv import channel_last, resolve_padding, tuplize

__all__ = ["max_pool2d", "adaptive_avg_pool2d"]


def max_pool2d(x, kernel_size, stride=None, padding=0,
               return_mask: bool = False, ceil_mode: bool = False,
               data_format: str = "NCHW") -> torch.Tensor:
    """Max over ``kernel_size`` windows of the spatial axes of ``x``."""
    if return_mask:
        raise NotImplementedError(
            "max_pool2d(return_mask=True) is not ported yet (ROADMAP queue "
            "1 item 2)")
    nhwc = channel_last(data_format)
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    kernel = tuplize(kernel_size, 2)
    stride = tuplize(stride if stride is not None else kernel, 2)
    pads = resolve_padding(padding, x.shape[2:], kernel, stride)
    if ceil_mode and not isinstance(padding, str):
        for i, n in enumerate(x.shape[2:]):
            lo, hi = pads[i]
            rem = (n + lo + hi - kernel[i]) % stride[i]
            if rem:
                pads[i] = (lo, hi + stride[i] - rem)
    if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, kernel)):
        out = TF.max_pool2d(x, kernel, stride, tuple(lo for lo, _ in pads))
    else:
        (top, bottom), (left, right) = pads
        x = TF.pad(x, (left, right, top, bottom), value=-math.inf)
        out = TF.max_pool2d(x, kernel, stride)
    return out.permute(0, 2, 3, 1) if nhwc else out


def adaptive_avg_pool2d(x, output_size: Union[int, Sequence[Optional[int]]],
                        data_format: str = "NCHW") -> torch.Tensor:
    """Average over Paddle's adaptive bins, one spatial axis at a time
    (an ``output_size`` entry of None keeps that axis)."""
    sizes = (output_size,) * 2 if isinstance(output_size, int) or \
        output_size is None else tuple(output_size)
    axes = (1, 2) if channel_last(data_format) else (2, 3)
    out = x
    for osz, ax in zip(sizes, axes):
        if osz is None:
            continue
        isz = out.shape[ax]
        pieces = []
        for j in range(osz):
            s = math.floor(j * isz / osz)
            e = math.ceil((j + 1) * isz / osz)
            pieces.append(out.narrow(ax, s, e - s).mean(ax, keepdim=True))
        out = pieces[0] if osz == 1 else torch.cat(pieces, ax)
    return out
