"""The pools: the counterpart of ``paddle2_tpu/nn/functional/pooling.py``.

The JAX package pools with XLA's ``reduce_window`` and slices, not with
Pallas, so the port pools with torch's ops; what is carried over is
each function's contract:

- windows: padding as ``_pad_cfg`` reads it (an int, one per axis, flat
  ``(lo, hi)`` pairs, ``"SAME"``/``"VALID"``), and ``ceil_mode`` as extra
  padding at the high end so that a partial trailing window is kept (not
  with a string padding). Layouts starting ``"NC"`` are channels first,
  any other channels last;
- max pooling: padded elements never win (XLA starts from ``-inf``), and
  a tie's gradient goes to the first tap, as ``reduce_window``'s and
  torch's ``max_pool`` give it. torch takes symmetric padding up to half
  the window; any other padding is applied first, with ``-inf``, out
  of sight of ``FLAGS_check_nan_inf``, which checks the pool's output;
- ``return_mask=True`` (``_max_pool_with_mask``, ``:205-269``) stacks the
  windows' taps, in float32 padded with ``finfo(float32).min``, takes
  their max and the first tap that holds it, and gives the tap's flat
  index into the input's spatial plane. Its gradient is that of a max
  over the stacked axis, which splits a tie equally among the tied taps
  (``torch.amax`` as ``jnp.max``). A string padding raises
  ``ValueError``, a channels-last layout ``NotImplementedError``;
- average pooling sums the zero-padded window and divides by the whole
  window, or with ``exclusive=True`` (the default) by the count of
  unpadded elements, the ``ceil_mode`` extension counting as padding; a
  string padding always divides by the whole window.
  ``divisor_override`` is taken and ignored;
- adaptive pools: one axis at a time, H first, over Paddle's bins
  ``[floor(i*I/O), ceil((i+1)*I/O))``, a mean or a max each (the max's
  tie gradient split equally, as ``jnp.max``'s); ``adaptive_max_pool*d``
  with ``return_mask=True`` gives ``(out, None)``;
- ``max_unpool*d`` scatters values to the mask's flat indices;
- ``lp_pool*d`` is ``(avg_pool(|x|**p) * prod(k)) ** (1/p)``, in three
  ops as the JAX package composes it (``lp_pow``, the pool, ``lp_root``);
- ``fractional_max_pool*d`` takes Graham's window bounds from
  ``random_u``, drawn from the port's generator (``paddle.seed``) when
  None: the two packages draw different numbers from one seed.
"""

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch.nn import functional as TF

from .conv import (channel_last, from_channels_first, resolve_padding,
                   to_channels_first, torch_pad, tuplize)
from ...amp.casting import amp_op, cast_call
from ...framework import random as _random
from ...ops.dispatch import checks_outputs

__all__ = ["avg_pool1d", "avg_pool2d", "avg_pool3d", "max_pool1d",
           "max_pool2d", "max_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d", "adaptive_max_pool1d",
           "adaptive_max_pool2d", "adaptive_max_pool3d", "lp_pool1d",
           "lp_pool2d", "max_unpool1d", "max_unpool2d", "max_unpool3d",
           "fractional_max_pool2d", "fractional_max_pool3d"]

_MAX_POOL = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}


def _windows(x, kernel_size, stride, padding, n, ceil_mode):
    """The kernel, the stride and one ``(lo, hi)`` pair per spatial axis
    of channels-first ``x``, as ``_pool`` makes them."""
    kernel = tuplize(kernel_size, n)
    stride = tuplize(stride if stride is not None else kernel, n)
    pads = resolve_padding(padding, x.shape[2:], kernel, stride)
    if ceil_mode and not isinstance(padding, str):
        for i, size in enumerate(x.shape[2:]):
            lo, hi = pads[i]
            rem = (size + lo + hi - kernel[i]) % stride[i]
            if rem:
                pads[i] = (lo, hi + stride[i] - rem)
    return kernel, stride, pads


def _window_sum(x, kernel, stride, n):
    """The sum over every window of channels-first ``x`` (no padding)."""
    for i in range(n):
        x = x.unfold(2 + i, kernel[i], stride[i])
    return x.sum(tuple(range(-n, 0)))


def _max_pool(x, kernel_size, stride, padding, n, ceil_mode, data_format):
    cl = not data_format.startswith("NC")
    x = to_channels_first(x, cl)
    kernel, stride, pads = _windows(x, kernel_size, stride, padding, n,
                                    ceil_mode)
    if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, kernel)):
        out = _MAX_POOL[n](x, kernel, stride, tuple(lo for lo, _ in pads))
    else:
        out = _max_pool_inf_padded(x, kernel, stride, pads, n)
    return from_channels_first(out, cl)


@checks_outputs("max_pool")
def _max_pool_inf_padded(x, kernel, stride, pads, n):
    """The pool over ``x`` padded first with ``-inf``. Under
    ``FLAGS_check_nan_inf`` it runs with the check suspended and only
    its output is checked, so the pad is not taken for a fault; a
    finite pad would change the max of a window that sees no input."""
    return _MAX_POOL[n](TF.pad(x, torch_pad(pads), value=-math.inf),
                        kernel, stride)


def _max_pool_with_mask(x, kernel_size, stride, padding, n, ceil_mode,
                        data_format):
    kernel = tuplize(kernel_size, n)
    stride = tuplize(stride if stride is not None else kernel, n)
    if isinstance(padding, str):
        raise ValueError("mask mode needs explicit padding")
    if not data_format.startswith("NC"):
        raise NotImplementedError("return_mask expects NC-first layouts")
    _, _, pads = _windows(x, kernel, stride, padding, n, ceil_mode)
    spatial = x.shape[2:]
    neg = torch.finfo(torch.float32).min
    ap = TF.pad(x.float(), torch_pad(pads), value=neg)
    outs = [(ap.shape[2 + i] - kernel[i]) // stride[i] + 1
            for i in range(n)]
    taps, coords = [], []
    for tap in np.ndindex(*kernel):
        coords.append(tap)
        sl = [slice(None), slice(None)] + [
            slice(tap[i], tap[i] + (outs[i] - 1) * stride[i] + 1, stride[i])
            for i in range(n)]
        taps.append(ap[tuple(sl)])
    stack = torch.stack(taps, 2)                  # [N, C, K, *outs]
    out = torch.amax(stack, 2).to(x.dtype)
    arg = torch.argmax(stack.detach(), 2)         # the first tap at the max
    coords = torch.tensor(coords, dtype=torch.int32, device=x.device)
    flat = torch.zeros(arg.shape, dtype=torch.int32, device=x.device)
    for i in range(n):
        grid = torch.arange(outs[i], dtype=torch.int32, device=x.device)
        grid = grid.reshape((outs[i],) + (1,) * (n - 1 - i))
        pos = grid * stride[i] + coords[:, i][arg] - pads[i][0]
        flat = flat * spatial[i] + pos
    return out, flat


def _max_pool_op(name, n, default_format):
    @amp_op(name)
    def pool(x, kernel_size, stride=None, padding=0, return_mask=False,
             ceil_mode=False, data_format=default_format, name=None):
        """Max over ``kernel_size`` windows of the spatial axes of ``x``
        (with ``return_mask``, also each max's flat index)."""
        if return_mask:
            return _max_pool_with_mask(x, kernel_size, stride, padding, n,
                                       ceil_mode, data_format)
        return _max_pool(x, kernel_size, stride, padding, n, ceil_mode,
                         data_format)
    pool.__name__ = pool.__qualname__ = name
    return pool


max_pool1d = _max_pool_op("max_pool1d", 1, "NCL")
max_pool2d = _max_pool_op("max_pool2d", 2, "NCHW")
max_pool3d = _max_pool_op("max_pool3d", 3, "NCDHW")


def _avg_pool(x, kernel_size, stride, padding, n, ceil_mode, exclusive,
              data_format):
    cl = not data_format.startswith("NC")
    x = to_channels_first(x, cl)
    kernel, stride, pads = _windows(x, kernel_size, stride, padding, n,
                                    ceil_mode)
    total = _window_sum(TF.pad(x, torch_pad(pads)), kernel, stride, n)
    if exclusive and not isinstance(padding, str):
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        counts = _window_sum(TF.pad(ones, torch_pad(pads)), kernel, stride,
                             n)
        out = total / counts
    else:
        out = total / float(np.prod(kernel))
    return from_channels_first(out, cl)


@amp_op("avg_pool1d")
def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _avg_pool(x, kernel_size, stride, padding, 1, ceil_mode,
                     exclusive, data_format)


@amp_op("avg_pool2d")
def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _avg_pool(x, kernel_size, stride, padding, 2, ceil_mode,
                     exclusive, data_format)


@amp_op("avg_pool3d")
def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _avg_pool(x, kernel_size, stride, padding, 3, ceil_mode,
                     exclusive, data_format)


@amp_op("lp_pow")
def _lp_pow(x, p):
    return x.abs() ** p


@amp_op("lp_root")
def _lp_root(x, scale, p):
    return (x * scale) ** (1.0 / p)


def _lp_pool(x, norm_type, kernel_size, stride, padding, ceil_mode,
             data_format, n, name):
    p = float(norm_type)
    pooled = cast_call(name, _avg_pool, _lp_pow(x, p), kernel_size, stride,
                       padding, n, ceil_mode, False, data_format)
    scale = float(np.prod(tuplize(kernel_size, n)))
    return _lp_root(pooled, scale, p)


def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCL", name=None):
    return _lp_pool(x, norm_type, kernel_size, stride, padding, ceil_mode,
                    data_format, 1, "lp_pool1d")


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW", name=None):
    return _lp_pool(x, norm_type, kernel_size, stride, padding, ceil_mode,
                    data_format, 2, "lp_pool2d")


def _bins(size: int, out: int):
    return [(math.floor(j * size / out), math.ceil((j + 1) * size / out))
            for j in range(out)]


def _adaptive(x, output_size, n, reduce, cl):
    """One spatial axis at a time over Paddle's adaptive bins (an
    ``output_size`` entry of None keeps that axis)."""
    sizes = (output_size,) * n if isinstance(output_size, int) or \
        output_size is None else tuple(output_size)
    axes = range(1, 1 + n) if cl else range(x.ndim - n, x.ndim)
    out = x
    for osz, ax in zip(sizes, axes):
        if osz is None:
            continue
        pieces = [reduce(out.narrow(ax, s, e - s), ax)
                  for s, e in _bins(out.shape[ax], osz)]
        out = pieces[0] if osz == 1 else torch.cat(pieces, ax)
    return out


def _mean(t, ax):
    return t.mean(ax, keepdim=True)


def _amax(t, ax):
    return torch.amax(t, ax, keepdim=True)


@amp_op("adaptive_avg_pool1d")
def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, _mean, False)


@amp_op("adaptive_avg_pool2d")
def adaptive_avg_pool2d(x, output_size: Union[int, Sequence[Optional[int]]],
                        data_format: str = "NCHW", name=None) -> torch.Tensor:
    """Average over Paddle's adaptive bins, one spatial axis at a time
    (an ``output_size`` entry of None keeps that axis)."""
    return _adaptive(x, output_size, 2, _mean, channel_last(data_format))


@amp_op("adaptive_avg_pool3d")
def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, output_size, 3, _mean,
                     not data_format.startswith("NC"))


def _adaptive_max_op(name, n):
    fn = amp_op(name)(lambda x, output_size: _adaptive(x, output_size, n,
                                                       _amax, False))

    def pool(x, output_size, return_mask=False, name=None):
        out = fn(x, output_size)
        return (out, None) if return_mask else out
    pool.__name__ = pool.__qualname__ = name
    return pool


adaptive_max_pool1d = _adaptive_max_op("adaptive_max_pool1d", 1)
adaptive_max_pool2d = _adaptive_max_op("adaptive_max_pool2d", 2)
adaptive_max_pool3d = _adaptive_max_op("adaptive_max_pool3d", 3)


def _max_unpool(x, indices, n, kernel_size, stride, padding, output_size):
    """Scatter ``x`` to its flat ``indices`` in zero planes; the plane is
    ``(in - 1) * stride - 2 * pad + kernel`` per axis unless
    ``output_size`` gives it."""
    kernel = tuplize(kernel_size, n)
    stride = tuplize(stride if stride is not None else kernel_size, n)
    pads = resolve_padding(padding, [0] * n, [0] * n, [1] * n)
    if output_size is None:
        out_sp = tuple((x.shape[2 + i] - 1) * stride[i] - 2 * pads[i][0]
                       + kernel[i] for i in range(n))
    else:
        out_sp = tuple(int(s) for s in output_size[-n:])
    N, C = x.shape[:2]
    flat = torch.zeros((N, C, int(np.prod(out_sp))), dtype=x.dtype,
                       device=x.device)
    flat = flat.scatter(2, indices.reshape(N, C, -1).long(),
                        x.reshape(N, C, -1))
    return flat.reshape((N, C) + out_sp)


def _max_unpool_op(name, n, default_format):
    @amp_op(name)
    def unpool(x, indices, kernel_size, stride=None, padding=0,
               data_format=default_format, output_size=None, name=None):
        return _max_unpool(x, indices, n, kernel_size, stride, padding,
                           output_size)
    unpool.__name__ = unpool.__qualname__ = name
    return unpool


max_unpool1d = _max_unpool_op("max_unpool1d", 1, "NCL")
max_unpool2d = _max_unpool_op("max_unpool2d", 2, "NCHW")
max_unpool3d = _max_unpool_op("max_unpool3d", 3, "NCDHW")


def _fractional_bounds(in_size, out_size, u):
    """Graham's fractional pooling bounds (``pooling.py:317-329``):
    ``start_i = ceil(alpha*(i+u) - 1)``, ``end_i = ceil(alpha*(i+1+u) -
    1)``, the first window from 0 and the last to ``in_size``."""
    alpha = in_size / out_size
    starts = [max(0, int(np.ceil(alpha * (i + u) - 1)))
              for i in range(out_size)]
    ends = [min(in_size, int(np.ceil(alpha * (i + 1 + u) - 1)))
            for i in range(out_size)]
    ends[-1] = in_size
    starts[0] = 0
    return starts, ends


def _fractional_max_pool(x, output_size, n, kernel_size, random_u,
                         return_mask, name):
    if random_u is None:
        gen = _random.generator(x.device)
        random_u = float(torch.rand((), generator=gen, device=gen.device))
    u = float(random_u)
    if not 0.0 < u < 1.0:
        raise ValueError(f"random_u must be in (0, 1), got {u}")
    spatial = list(x.shape[x.ndim - n:])
    out_sizes = tuplize(output_size, n) if not isinstance(
        output_size, (list, tuple)) else tuple(output_size)
    out_sizes = tuple(out_sizes[i] if out_sizes[i] is not None
                      else spatial[i] for i in range(n))
    kern = tuplize(kernel_size, n) if kernel_size is not None else None
    bounds = []
    for i in range(n):
        s, e = _fractional_bounds(spatial[i], out_sizes[i], u)
        if kern is not None:
            e = [min(spatial[i], st + kern[i]) for st in s]
        bounds.append(list(zip(s, e)))

    def pool(a):
        out = a
        for i in range(n):
            ax = a.ndim - n + i
            out = torch.cat([torch.amax(out.narrow(ax, s, e - s), ax,
                                        keepdim=True) for s, e in bounds[i]],
                            ax)
        return out

    res = cast_call(name, pool, x)
    if not return_mask:
        return res
    # the first maximum of each window, flat in the window's C order, as
    # the input's flat index
    N, C = x.shape[:2]
    a = x.detach()
    mask = torch.zeros((N, C) + out_sizes, dtype=torch.int32,
                       device=x.device)
    for pos in np.ndindex(*out_sizes):
        cell = [bounds[i][pos[i]] for i in range(n)]
        seg = a[(slice(None), slice(None)) + tuple(slice(s, e)
                                                   for s, e in cell)]
        rem = seg.reshape(N, C, -1).argmax(-1)
        local = []
        for s, e in reversed(cell):
            local.append(rem % (e - s))
            rem = rem // (e - s)
        flat = torch.zeros((N, C), dtype=torch.int64, device=x.device)
        for i, off in enumerate(reversed(local)):
            flat = flat * spatial[i] + off + cell[i][0]
        mask[(slice(None), slice(None)) + pos] = flat.to(torch.int32)
    return res, mask


def fractional_max_pool2d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    return _fractional_max_pool(x, output_size, 2, kernel_size, random_u,
                                return_mask, "fractional_max_pool2d")


def fractional_max_pool3d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    return _fractional_max_pool(x, output_size, 3, kernel_size, random_u,
                                return_mask, "fractional_max_pool3d")
