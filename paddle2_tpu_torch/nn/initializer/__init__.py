"""Weight initializers: the counterpart of
``paddle2_tpu/nn/initializer/__init__.py``.

An initializer is a callable ``init(shape, dtype)`` that returns a new
tensor on the current place (``framework.core.current_device()``: the
card unless the caller ran ``paddle.set_device("cpu")``). Fans and
gains are computed as the JAX package computes them (a 2-D weight is
``[in, out]``, a conv weight ``[out, in/groups, *kernel]``). The random
ones draw from the port's generator of that device
(``framework/random.py``), so ``paddle.seed`` fixes their draws; JAX's
threefry keys give other values, so tests hold them by their
statistics. :func:`set_global_initializer` is read by
``Layer.create_parameter``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ...framework import core
from ...framework import random as fr

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
           "Assign", "Orthogonal", "Dirac", "calculate_gain",
           "set_global_initializer", "Bilinear"]


def _fan_in_out(shape: Sequence[int]):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        # Paddle's Linear weights are [in_features, out_features]
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    # a conv weight [out_channels, in_channels/groups, *kernel]
    return shape[1] * receptive, shape[0] * receptive


def calculate_gain(nonlinearity: str, param=None) -> float:
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "conv1d_transpose": 1.0, "conv2d_transpose": 1.0,
        "conv3d_transpose": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(
            2.0 / (1 + (param if param is not None else 0.01) ** 2)),
        "selu": 3.0 / 4.0,
    }
    if nonlinearity not in gains:
        raise ValueError(f"unsupported nonlinearity {nonlinearity!r}")
    return gains[nonlinearity]


def _dtype(dtype) -> torch.dtype:
    return core.convert_dtype(dtype) or core.get_default_dtype()


def _draw(shape, fill) -> torch.Tensor:
    """An f32 tensor of ``shape`` on the current place, filled in place
    by ``fill(tensor, generator)`` from the port's generator."""
    dev = core.current_device()
    t = torch.empty(tuple(shape), dtype=torch.float32, device=dev)
    with torch.no_grad():
        fill(t, fr.generator(dev))
    return t


class Initializer:
    def __call__(self, shape, dtype=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, shape, dtype=None):
        return torch.full(tuple(shape), self.value, dtype=_dtype(dtype),
                          device=core.current_device())


class Normal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=None):
        z = _draw(shape, lambda t, g: t.normal_(generator=g))
        return (self.mean + self.std * z).to(_dtype(dtype))


class TruncatedNormal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0, a: float = -2.0,
                 b: float = 2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype=None):
        # a standard normal cut to [a, b], then scaled, as JAX's
        # truncated_normal(a, b) is
        z = _draw(shape, lambda t, g: torch.nn.init.trunc_normal_(
            t, 0.0, 1.0, self.a, self.b, generator=g))
        return (self.mean + self.std * z).to(_dtype(dtype))


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=None):
        return _draw(shape, lambda t, g: t.uniform_(
            self.low, self.high, generator=g)).to(_dtype(dtype))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=None):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)(shape, dtype)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=None):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)(shape, dtype)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope: float = 0.0,
                 nonlinearity: str = "relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype=None):
        fi, _ = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        return Normal(0.0, gain / math.sqrt(fi))(shape, dtype)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope: float = 0.0,
                 nonlinearity: str = "relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype=None):
        fi, _ = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(shape, dtype)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype=None):
        v = self.value
        arr = v.detach().cpu() if isinstance(v, torch.Tensor) \
            else torch.as_tensor(np.asarray(v))
        return arr.reshape(tuple(shape)).to(
            device=core.current_device(), dtype=_dtype(dtype))


class Orthogonal(Initializer):
    """``gain`` times JAX's orthogonal initializer: the last axis is the
    column axis, a matrix ``[prod(other axes), shape[-1]]`` with
    orthonormal columns (rows, when it is wide) from the QR
    factorization of a normal draw, its signs fixed by ``R``'s
    diagonal."""

    def __init__(self, gain: float = 1.0):
        self.gain = gain

    def __call__(self, shape, dtype=None):
        shape = tuple(shape)
        if len(shape) < 2:
            raise ValueError("Orthogonal initializer needs at least 2 dims")
        n_cols = shape[-1]
        n_rows = int(np.prod(shape)) // n_cols
        wide = n_rows < n_cols
        a = _draw((n_cols, n_rows) if wide else (n_rows, n_cols),
                  lambda t, g: t.normal_(generator=g))
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))[None, :]
        if wide:
            q = q.T
        return (self.gain * q.reshape(shape)).to(_dtype(dtype))


class Dirac(Initializer):
    """Identity-preserving conv init (paddle.nn.initializer.Dirac)."""

    def __init__(self, groups: int = 1):
        self.groups = groups

    def __call__(self, shape, dtype=None):
        shape = tuple(shape)
        out = np.zeros(shape, np.float32)
        oc, ic = shape[0], shape[1]
        mins = min(oc // self.groups, ic)
        centers = [s // 2 for s in shape[2:]]
        for g in range(self.groups):
            for i in range(mins):
                out[(g * (oc // self.groups) + i, i) + tuple(centers)] = 1.0
        return torch.from_numpy(out).to(device=core.current_device(),
                                        dtype=_dtype(dtype))


_global_weight_init: Optional[Initializer] = None
_global_bias_init: Optional[Initializer] = None


def set_global_initializer(weight_init, bias_init=None):
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init


def get_global_initializer():
    return _global_weight_init, _global_bias_init


class Bilinear(Initializer):
    """Transposed-conv upsampling kernels: called on a 4-D parameter, it
    writes the bilinear interpolation stencil into each ``[kh, kw]``
    slice in place (as the JAX package's ``Bilinear``, which takes the
    parameter, not a shape)."""

    def __call__(self, param, block=None):
        shape = tuple(param.shape)
        if len(shape) != 4:
            raise ValueError("Bilinear initializer expects a 4-D weight")
        kh, kw = shape[2], shape[3]
        f_h = (kh + 1) // 2
        f_w = (kw + 1) // 2
        og = np.ogrid[:kh, :kw]
        center_h = (2 * f_h - 1 - f_h % 2) / (2.0 * f_h)
        center_w = (2 * f_w - 1 - f_w % 2) / (2.0 * f_w)
        filt = ((1 - np.abs(og[0] / f_h - center_h))
                * (1 - np.abs(og[1] / f_w - center_w)))
        w = np.zeros(shape, np.float32)
        w[:, :] = filt
        with torch.no_grad():
            param.copy_(torch.from_numpy(w))
        return param
