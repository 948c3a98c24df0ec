"""The convolutions: the counterpart of
``paddle2_tpu/nn/functional/conv.py``.

The JAX package lowers every convolution to XLA's
``conv_general_dilated``, not to a Pallas kernel, so the port's
counterparts are torch's ``conv{1,2,3}d`` and ``conv_transpose{1,2,3}d``
(cuDNN on the card), as ``torch.matmul`` is for a plain product. What is
carried over is each call's contract:

- the weight: ``[O, I/groups, *k]``, and ``[I, O/groups, *k]`` for the
  transposes (which is torch's layout too);
- the layouts: ``conv1d`` maps ``"NCL"`` to channels first and any other
  string to channels last (``conv.py:102-104``); ``conv3d`` and the
  transposes take any layout that starts with ``"NC"`` as channels first
  and any other as channels last; ``conv2d`` keeps its own rule
  (``NCHW`` or ``NHWC``, any other raises);
- the padding rules of ``_padding`` (``conv.py:27-39``): an int, one int
  per axis, one ``(lo, hi)`` pair per axis given flat, or
  ``"SAME"``/``"VALID"`` as XLA reads them. torch pads symmetrically
  only, so an uneven padding is applied to the input first, with zeros;
- a transpose is the convolution of the input dilated by ``stride`` and
  padded ``(k_eff - lo, k_eff - hi + output_padding)`` per axis with the
  flipped kernel (``conv.py:135-143``; ``k_eff = dilation * (k - 1)``).
  torch's ``conv_transpose`` takes that padding when ``lo == hi`` and
  ``output_padding`` is below the stride or the dilation; any other
  padding runs the full transpose (padding 0) and crops ``lo`` at the
  low end and ``hi - output_padding`` at the high end, a negative crop
  appending zeros, before the bias is added;
- a string padding on a transpose goes to XLA as it is: at stride 1 it
  is a plain convolution with the flipped kernel (``"SAME"`` keeps the
  input's size, ``"VALID"`` shrinks it), past stride 1 XLA raises
  ``ValueError``; ``output_padding`` is then unused, and ``output_size``
  is always taken and ignored, as in the JAX package.

float32 runs in full float32: the package turns TF32 off for cuDNN, as
the JAX package runs f32 at "highest".

With ``FLAGS_conv_prefer_channels_last`` on, an ``NCHW`` ``conv2d`` with
``groups == 1`` runs in NHWC inside (input and weight in
``torch.channels_last``) and returns a contiguous ``NCHW`` tensor, as the
JAX package's flag does (``conv.py:60-66``).
"""

import math
from typing import List, Sequence, Tuple, Union

import torch
from torch.nn import functional as TF

from ...flags import flag_value
from ...amp.casting import amp_op

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

Padding = Union[str, int, Sequence[int]]

_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


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


def torch_pad(pads: Sequence[Tuple[int, int]]) -> List[int]:
    """``(lo, hi)`` pairs, first spatial axis first, as ``F.pad`` takes
    them (last axis first)."""
    return [p for lo_hi in reversed(pads) for p in lo_hi]


def to_channels_first(x, cl: bool):
    return x.movedim(-1, 1) if cl else x


def from_channels_first(x, cl: bool):
    return x.movedim(1, -1) if cl else x


def _conv(x, weight, bias, stride, padding, dilation, groups, n,
          nhwc_inside=False):
    """The ``n``-d convolution of channels-first ``x`` with XLA's
    padding rules; ``nhwc_inside`` runs it on ``channels_last`` copies
    of ``x`` and ``weight`` and returns a contiguous result."""
    stride = tuplize(stride, n)
    dilation = tuplize(dilation, n)
    windows = [(k - 1) * d + 1 for k, d in zip(weight.shape[2:], dilation)]
    pads = resolve_padding(padding, x.shape[2:], windows, stride)
    if all(lo == hi for lo, hi in pads):
        sym = tuple(lo for lo, _ in pads)
    else:
        x = TF.pad(x, torch_pad(pads))
        sym = (0,) * n
    if nhwc_inside:
        cl = torch.channels_last
        return TF.conv2d(x.contiguous(memory_format=cl),
                         weight.contiguous(memory_format=cl), bias, stride,
                         sym, dilation, groups).contiguous()
    return _CONV[n](x, weight, bias, stride, sym, dilation, groups)


@amp_op("conv1d")
def conv1d(x, weight, bias=None, stride=1, padding: Padding = 0,
           dilation=1, groups: int = 1, data_format: str = "NCL",
           name=None) -> torch.Tensor:
    """1-D convolution of ``x`` (``"NCL"``; any other layout is taken as
    channels last) with ``weight`` ``[O, I/groups, k]``."""
    cl = data_format != "NCL"
    out = _conv(to_channels_first(x, cl), weight, bias, stride, padding,
                dilation, groups, 1)
    return from_channels_first(out, cl)


@amp_op("conv2d")
def conv2d(x, weight, bias=None, stride=1, padding: Padding = 0,
           dilation=1, groups: int = 1, data_format: str = "NCHW",
           name=None) -> torch.Tensor:
    """2-D convolution of ``x`` (``NCHW`` or ``NHWC``) with ``weight``
    ``[O, I/groups, kh, kw]``, plus ``bias`` ``[O]`` when given."""
    nhwc = channel_last(data_format)
    inside = (not nhwc and groups == 1
              and flag_value("conv_prefer_channels_last"))
    out = _conv(to_channels_first(x, nhwc), weight, bias, stride, padding,
                dilation, groups, 2, nhwc_inside=inside)
    return from_channels_first(out, nhwc)


@amp_op("conv3d")
def conv3d(x, weight, bias=None, stride=1, padding: Padding = 0,
           dilation=1, groups: int = 1, data_format: str = "NCDHW",
           name=None) -> torch.Tensor:
    """3-D convolution of ``x`` (a layout starting ``"NC"``, else channels
    last) with ``weight`` ``[O, I/groups, kd, kh, kw]``."""
    cl = not data_format.startswith("NC")
    out = _conv(to_channels_first(x, cl), weight, bias, stride, padding,
                dilation, groups, 3)
    return from_channels_first(out, cl)


def _flipped_forward_weight(weight, groups: int, n: int) -> torch.Tensor:
    """A transpose's weight ``[I, O/groups, *k]`` as the forward
    convolution's ``[O, I/groups, *k]``, its taps flipped."""
    cin, cog = weight.shape[:2]
    k = tuple(weight.shape[2:])
    w = (weight.reshape((groups, cin // groups, cog) + k)
         .transpose(1, 2).reshape((groups * cog, cin // groups) + k))
    return w.flip(tuple(range(2, 2 + n)))


def _crop(y, axis: int, lo: int, hi: int) -> torch.Tensor:
    """``lo`` elements off the low end and ``hi`` off the high end of
    ``axis``; a negative count appends that many zeros instead."""
    size = y.shape[axis]
    y = y.narrow(axis, max(lo, 0), size - max(lo, 0) - max(hi, 0))
    if lo < 0 or hi < 0:
        pad = [0, 0] * (y.ndim - 1 - axis) + [max(-lo, 0), max(-hi, 0)]
        y = TF.pad(y, pad)
    return y


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, n, cl):
    x = to_channels_first(x, cl)
    stride = tuplize(stride, n)
    dilation = tuplize(dilation, n)
    out_pad = tuplize(output_padding, n)
    if isinstance(padding, str):
        if any(s != 1 for s in stride):
            raise ValueError("String padding is not implemented for "
                             "transposed convolution")
        out = _conv(x, _flipped_forward_weight(weight, groups, n), bias, 1,
                    padding, dilation, groups, n)
        return from_channels_first(out, cl)
    pads = resolve_padding(padding, [0] * n, [0] * n, stride)
    k_eff = [d * (k - 1) for d, k in zip(dilation, weight.shape[2:])]
    if all(lo == hi and 0 <= lo <= ke and 0 <= op < max(s, d)
           for (lo, hi), ke, op, s, d in zip(pads, k_eff, out_pad, stride,
                                             dilation)):
        out = _CONV_T[n](x, weight, bias, stride,
                         tuple(lo for lo, _ in pads), out_pad, groups,
                         dilation)
        return from_channels_first(out, cl)
    out = _CONV_T[n](x, weight, None, stride, 0, 0, groups, dilation)
    for i, ((lo, hi), op) in enumerate(zip(pads, out_pad)):
        out = _crop(out, 2 + i, lo, hi - op)
    if bias is not None:
        out = out + bias.reshape((-1,) + (1,) * n)
    return from_channels_first(out, cl)


@amp_op("conv1d_transpose")
def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None
                     ) -> torch.Tensor:
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 1, data_format != "NCL")


@amp_op("conv2d_transpose")
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None
                     ) -> torch.Tensor:
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 2,
                           not data_format.startswith("NC"))


@amp_op("conv3d_transpose")
def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None
                     ) -> torch.Tensor:
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 3,
                           not data_format.startswith("NC"))
