"""The rest of the top-level surface: the counterpart of
``paddle2_tpu/ops/misc.py``."""

from __future__ import annotations

import numpy as np
import torch

from ..framework import core
from ..framework import random as fr
from .dispatch import ensure_tensor, promote

__all__ = ["dtype", "float8_e4m3fn", "float8_e5m2", "rank", "shape",
           "add_n", "reverse", "histogram_bin_edges", "is_complex",
           "is_integer", "is_floating_point", "get_cuda_rng_state",
           "set_cuda_rng_state", "set_printoptions",
           "disable_signal_handler", "CUDAPinnedPlace", "create_parameter",
           "check_shape",
           "reduce_as", "as_strided", "diagonal_scatter", "LazyGuard",
           "batch", "flops"]


class _DtypeMeta(type):
    def __instancecheck__(cls, obj):
        return isinstance(obj, torch.dtype)

    def __call__(cls, spec):
        return core.convert_dtype(spec)


class dtype(metaclass=_DtypeMeta):
    """``paddle.dtype``: ``isinstance(t.dtype, paddle.dtype)`` holds for a
    torch dtype, and ``paddle.dtype("float32")`` gives one (x32 policy)."""


float8_e4m3fn = torch.float8_e4m3fn
float8_e5m2 = torch.float8_e5m2


def rank(input, name=None):
    x = ensure_tensor(input)
    return torch.tensor(x.ndim, dtype=torch.int32, device=x.device)


def shape(input, name=None):
    x = ensure_tensor(input)
    return torch.tensor(tuple(x.shape), dtype=torch.int32, device=x.device)


def add_n(inputs, name=None):
    ts = promote(*[ensure_tensor(t) for t in (
        inputs if isinstance(inputs, (list, tuple)) else [inputs])])
    out = ts[0]
    for t in ts[1:]:
        out = out + t
    return out


def reverse(x, axis, name=None):
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
    return torch.flip(ensure_tensor(x), ax)


def histogram_bin_edges(input, bins=100, min=0, max=0, name=None):
    """``np.histogram_bin_edges``: ``bins + 1`` edges over ``[min, max]``
    (the data's range when both are 0, widened by 0.5 on each side when
    it is one value), in the input's float dtype (float32 for an integer
    input), as numpy gives them."""
    x = ensure_tensor(input)
    if min == 0 and max == 0:
        lo, hi = float(x.min()), float(x.max())
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
    else:
        lo, hi = float(min), float(max)
    dt = x.dtype if x.is_floating_point() else torch.float32
    return torch.linspace(lo, hi, bins + 1, dtype=torch.float64,
                          device=x.device).to(dt)


def is_complex(x) -> bool:
    return ensure_tensor(x).is_complex()


def is_integer(x) -> bool:
    x = ensure_tensor(x)
    return not (x.is_floating_point() or x.is_complex()
                or x.dtype == torch.bool)


def is_floating_point(x) -> bool:
    return ensure_tensor(x).is_floating_point()


def get_cuda_rng_state():
    """The states of the port's CUDA generators, by device."""
    return [st for key, st in sorted(fr.get_rng_state().items())
            if key.startswith("cuda")]


def set_cuda_rng_state(state):
    cuda = sorted(k for k in fr.get_rng_state() if k.startswith("cuda"))
    fr.set_rng_state(dict(zip(cuda, state)))


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    torch.set_printoptions(precision=precision, threshold=threshold,
                           edgeitems=edgeitems, linewidth=linewidth,
                           sci_mode=sci_mode)


def disable_signal_handler():
    """Nothing to disable: the port installs no signal handler."""


class CUDAPinnedPlace(core.Place):
    """Page-locked host memory: a tensor placed here lives on the CPU."""

    device_type = "gpu_pinned"

    def __repr__(self):
        return "CUDAPinnedPlace"

    def torch_device(self) -> torch.device:
        return torch.device("cpu")


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """A parameter of its own, made as ``Layer.create_parameter`` makes
    one (on the current place; ``attr=False`` gives None)."""
    from ..nn.layer.layers import Layer
    return Layer().create_parameter(list(shape), attr=attr, dtype=dtype,
                                    is_bias=is_bias,
                                    default_initializer=default_initializer)


def check_shape(x):
    return tuple(ensure_tensor(x).shape)


def reduce_as(x, target, name=None):
    """Sum ``x`` down to ``target``'s broadcast-compatible shape."""
    x = ensure_tensor(x)
    tgt = tuple(ensure_tensor(target).shape)
    extra = x.ndim - len(tgt)
    if extra > 0:
        x = torch.sum(x, dim=tuple(range(extra)))
    axes = tuple(i for i, (d, t) in enumerate(zip(x.shape, tgt))
                 if d != t and t == 1)
    return torch.sum(x, dim=axes, keepdim=True) if axes else x


def as_strided(x, shape, stride, offset=0, name=None):
    """The strided window as a gather over ``x``'s elements in order (a
    read; writes to it do not reach ``x``)."""
    x = ensure_tensor(x)
    shape = tuple(int(s) for s in shape)
    idx = np.full(shape, int(offset), np.int64)
    for d, (s, st) in enumerate(zip(shape, stride)):
        idx += (np.arange(s) * int(st)).reshape(
            (1,) * d + (s,) + (1,) * (len(shape) - d - 1))
    return x.reshape(-1)[torch.from_numpy(idx).to(x.device)]


def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    x = ensure_tensor(x)
    return torch.diagonal_scatter(x, ensure_tensor(y).to(x.dtype), offset,
                                  axis1, axis2)


class LazyGuard:
    """``paddle.LazyGuard``: the port builds parameters eagerly, so the
    guard changes nothing (as in the JAX package)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def batch(reader, batch_size, drop_last=False):
    """The legacy reader combinator (``paddle.batch``)."""

    def gen():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf
    return gen


def flops(net, input_size, custom_ops=None, print_detail=False) -> int:
    """``paddle.flops``: a rough multiply-add count of ``net``'s
    ``Conv2d`` and ``Linear`` layers over one forward of zeros of
    ``input_size``, by forward hooks."""
    total = {"flops": 0}

    def conv_hook(layer, inputs, output):
        out_el = int(np.prod(output.shape[1:]))
        kernel = int(np.prod(layer.kernel_size)) * (layer.in_channels
                                                    // layer.groups)
        total["flops"] += out_el * (2 * kernel - 1)

    def linear_hook(layer, inputs, output):
        total["flops"] += 2 * int(np.prod(output.shape[1:])) \
            * int(layer.in_features)

    hooks = []
    for layer in net.modules():
        if isinstance(layer, torch.nn.Conv2d):
            hooks.append(layer.register_forward_hook(conv_hook))
        elif isinstance(layer, torch.nn.Linear):
            hooks.append(layer.register_forward_hook(linear_hook))
    param = next(net.parameters(), None)
    dev = param.device if param is not None else core.current_device()
    try:
        with torch.no_grad():
            net(torch.zeros(list(input_size), device=dev))
    finally:
        for h in hooks:
            h.remove()
    return total["flops"]
