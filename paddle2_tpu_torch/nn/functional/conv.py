"""``conv2d``: the counterpart of
``paddle2_tpu/nn/functional/conv.py:42-108``.

The JAX package lowers the convolution to XLA's
``conv_general_dilated``, not to a Pallas kernel, so the port's
counterpart is ``torch.nn.functional.conv2d`` (cuDNN on the card), as
``torch.matmul`` is for a plain product. What is carried over is the
call's contract: the weight ``[O, I/groups, kh, kw]``, ``NCHW`` or
``NHWC`` data, and the padding rules of ``_padding`` (``conv.py:27-39``):
an int, one int per axis, one ``(lo, hi)`` pair per axis given flat
(``[top, bottom, left, right]``), or ``"SAME"``/``"VALID"`` as XLA reads
them. torch pads symmetrically only, so an uneven padding is applied to
the input first, with zeros. float32 runs in full float32: the package
turns TF32 off for cuDNN, as the JAX package runs f32 at "highest".

With ``FLAGS_conv_prefer_channels_last`` on, an ``NCHW`` convolution
with ``groups == 1`` runs in NHWC inside (input and weight in
``torch.channels_last``) and returns a contiguous ``NCHW`` tensor, as
the JAX package's flag does (``conv.py:60-66``).
"""

import math
from typing import List, Sequence, Tuple, Union

import torch
from torch.nn import functional as TF

from ...flags import flag_value
from ...amp.casting import amp_op

__all__ = ["conv2d"]

Padding = Union[str, int, Sequence[int]]


def tuplize(v, n) -> Tuple[int, ...]:
    return (v,) * n if isinstance(v, int) else tuple(int(x) for x in v)


def channel_last(data_format: str) -> bool:
    """True for ``NHWC``, False for ``NCHW``; any other layout raises."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"unknown data_format {data_format!r}")
    return data_format == "NHWC"


def _same_pads(sizes, windows, strides) -> List[Tuple[int, int]]:
    """XLA's ``"SAME"``: ``ceil(size / stride)`` outputs, the padding
    split with the odd element at the end."""
    out = []
    for n, w, s in zip(sizes, windows, strides):
        total = max((math.ceil(n / s) - 1) * s + w - n, 0)
        out.append((total // 2, total - total // 2))
    return out


def resolve_padding(padding: Padding, sizes, windows, strides
                    ) -> List[Tuple[int, int]]:
    """One ``(lo, hi)`` pair per spatial axis, as ``_padding`` and XLA
    resolve ``padding`` (``windows`` are the dilated kernel sizes)."""
    n = len(sizes)
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "SAME":
            return _same_pads(sizes, windows, strides)
        if mode == "VALID":
            return [(0, 0)] * n
        raise ValueError(f"bad padding {padding!r}")
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = [int(p) for p in padding]
    if len(padding) == n:
        return [(p, p) for p in padding]
    if len(padding) == 2 * n:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    raise ValueError(f"bad padding {padding}")


@amp_op("conv2d")
def conv2d(x, weight, bias=None, stride=1, padding: Padding = 0,
           dilation=1, groups: int = 1, data_format: str = "NCHW"
           ) -> torch.Tensor:
    """2-D convolution of ``x`` (``NCHW`` or ``NHWC``) with ``weight``
    ``[O, I/groups, kh, kw]``, plus ``bias`` ``[O]`` when given."""
    nhwc = channel_last(data_format)
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    stride = tuplize(stride, 2)
    dilation = tuplize(dilation, 2)
    windows = [(k - 1) * d + 1 for k, d in zip(weight.shape[2:], dilation)]
    pads = resolve_padding(padding, x.shape[2:], windows, stride)
    if all(lo == hi for lo, hi in pads):
        sym = tuple(lo for lo, _ in pads)
    else:
        (top, bottom), (left, right) = pads
        x = TF.pad(x, (left, right, top, bottom))
        sym = (0, 0)
    if (not nhwc and groups == 1
            and flag_value("conv_prefer_channels_last")):
        cl = torch.channels_last
        out = TF.conv2d(x.contiguous(memory_format=cl),
                        weight.contiguous(memory_format=cl), bias, stride,
                        sym, dilation, groups)
        return out.contiguous()
    out = TF.conv2d(x, weight, bias, stride, sym, dilation, groups)
    return out.permute(0, 2, 3, 1) if nhwc else out
