"""Tensor creation ops: the counterpart of ``paddle2_tpu/ops/creation.py``.

A creation op without a tensor argument makes its tensor on the current
place (``framework.core.set_device``; the card by default).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..framework import core
from ..framework.tensor import to_tensor
from .dispatch import ensure_tensor, promote

__all__ = ["to_tensor", "zeros", "ones", "full", "empty", "zeros_like",
           "ones_like", "full_like", "empty_like", "arange", "linspace",
           "logspace", "eye", "meshgrid", "diag", "diagflat", "diag_embed",
           "tril", "triu", "tril_indices", "triu_indices", "assign", "clone",
           "complex", "polar", "as_tensor"]


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item()) if isinstance(s, torch.Tensor) else int(s)
                 for s in shape)


def _dt(dtype, default=None):
    d = core.convert_dtype(dtype)
    return d if d is not None else (default or core.get_default_dtype())


def _v(x):
    return x.item() if isinstance(x, torch.Tensor) else x


def zeros(shape, dtype=None, name=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype),
                       device=core.current_device())


def ones(shape, dtype=None, name=None):
    return torch.ones(_shape(shape), dtype=_dt(dtype),
                      device=core.current_device())


def full(shape, fill_value, dtype=None, name=None):
    fill_value = _v(fill_value)
    if dtype is None:
        dtype = (core.bool_ if isinstance(fill_value, bool)
                 else core.int64 if isinstance(fill_value, int)
                 else core.get_default_dtype())
    return torch.full(_shape(shape), fill_value, dtype=_dt(dtype),
                      device=core.current_device())


def empty(shape, dtype=None, name=None):
    return torch.empty(_shape(shape), dtype=_dt(dtype),
                       device=core.current_device())


def zeros_like(x, dtype=None, name=None):
    return torch.zeros_like(ensure_tensor(x), dtype=core.convert_dtype(dtype))


def ones_like(x, dtype=None, name=None):
    return torch.ones_like(ensure_tensor(x), dtype=core.convert_dtype(dtype))


def full_like(x, fill_value, dtype=None, name=None):
    return torch.full_like(ensure_tensor(x), _v(fill_value),
                           dtype=core.convert_dtype(dtype))


def empty_like(x, dtype=None, name=None):
    return torch.empty_like(ensure_tensor(x), dtype=core.convert_dtype(dtype))


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _v(start), _v(end), _v(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = (core.int64 if all(isinstance(v, int)
                                   for v in (start, end, step))
                 else core.get_default_dtype())
    return torch.arange(start, end, step, dtype=_dt(dtype),
                        device=core.current_device())


def _float_then(make, dtype):
    """``make(float dtype)``: computed in float32 and rounded for a
    half-precision dtype (the CUDA and CPU sequences of torch differ in
    bfloat16), floored and cast for an integer dtype (as
    ``jnp.linspace`` does)."""
    dt = _dt(dtype)
    if dt in (torch.bfloat16, torch.float16):
        return make(core.float32).to(dt)
    if dt.is_floating_point or dt.is_complex:
        return make(dt)
    return torch.floor(make(core.float32)).to(dt)


def linspace(start, stop, num, dtype=None, name=None):
    return _float_then(lambda dt: torch.linspace(
        _v(start), _v(stop), int(_v(num)), dtype=dt,
        device=core.current_device()), dtype)


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return _float_then(lambda dt: torch.logspace(
        _v(start), _v(stop), int(_v(num)), base=_v(base), dtype=dt,
        device=core.current_device()), dtype)


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    m = n if num_columns is None else int(num_columns)
    return torch.eye(n, m, dtype=_dt(dtype), device=core.current_device())


def meshgrid(*args, **kwargs) -> List[torch.Tensor]:
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    ts = [ensure_tensor(a) for a in args]
    return list(torch.meshgrid(*ts, indexing="ij"))


def diag(x, offset=0, padding_value=0, name=None):
    x = ensure_tensor(x)
    out = torch.diag(x, offset)
    if x.ndim == 1 and padding_value != 0:
        keep = torch.diag(torch.ones_like(x), offset)
        out = out + (1 - keep) * padding_value
        out = out.to(x.dtype)
    return out


def diagflat(x, offset=0, name=None):
    return torch.diagflat(ensure_tensor(x), offset)


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    return torch.diag_embed(ensure_tensor(input), offset, dim1, dim2)


def tril(x, diagonal=0, name=None):
    return torch.tril(ensure_tensor(x), diagonal)


def triu(x, diagonal=0, name=None):
    return torch.triu(ensure_tensor(x), diagonal)


def tril_indices(row, col=None, offset=0, dtype="int64", name=None):
    col = row if col is None else col
    return torch.tril_indices(row, col, offset,
                              device=core.current_device()).to(
        core.convert_dtype(dtype))


def triu_indices(row, col=None, offset=0, dtype="int64", name=None):
    col = row if col is None else col
    return torch.triu_indices(row, col, offset,
                              device=core.current_device()).to(
        core.convert_dtype(dtype))


def assign(x, output: Optional[torch.Tensor] = None):
    out = ensure_tensor(x).clone()
    if output is not None:
        with torch.no_grad():
            output.copy_(out)
        return output
    return out


def clone(x, name=None):
    return ensure_tensor(x).clone()


def complex(real, imag, name=None):
    real = ensure_tensor(real)
    return torch.complex(*promote(real, ensure_tensor(imag, real)))


def polar(abs, angle, name=None):
    abs = ensure_tensor(abs)
    return torch.polar(*promote(abs, ensure_tensor(angle, abs)))


def as_tensor(data, dtype=None, place=None):
    if isinstance(data, torch.Tensor) and dtype is None:
        return data
    return to_tensor(data, dtype=dtype, place=place)
