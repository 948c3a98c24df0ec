"""Shape and layout ops: the counterpart of
``paddle2_tpu/ops/manipulation.py``. Index tensors are cast to int64
inside the ops that torch asks it of; results keep the JAX package's
dtypes (indices int32)."""

from __future__ import annotations

import builtins
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from ..framework import core
from .dispatch import ensure_tensor, promote

__all__ = ["reshape", "reshape_", "transpose", "t", "flatten", "squeeze",
           "squeeze_", "unsqueeze", "unsqueeze_", "concat", "stack", "split",
           "chunk", "tile", "expand", "expand_as", "broadcast_to",
           "broadcast_tensors", "flip", "rot90", "roll", "gather", "gather_nd",
           "scatter", "scatter_", "scatter_nd", "scatter_nd_add",
           "index_select", "index_sample", "index_add", "index_add_",
           "index_put_", "index_put", "masked_select", "masked_fill", "where",
           "nonzero", "take_along_axis", "put_along_axis", "unbind",
           "repeat_interleave", "unique", "unique_consecutive", "sort",
           "argsort", "slice", "strided_slice", "moveaxis", "swapaxes",
           "as_complex", "as_real", "cast", "numel", "shard_index",
           "unstack", "unfold", "tensordot", "atleast_1d", "atleast_2d",
           "atleast_3d", "view", "view_as", "tolist", "crop", "pad_basic"]


def _ints(v):
    if isinstance(v, torch.Tensor):
        return [int(a) for a in v.reshape(-1).tolist()]
    if isinstance(v, (list, tuple)):
        return [int(a.item()) if isinstance(a, torch.Tensor) else int(a)
                for a in v]
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def _axes(axis):
    a = _ints(axis)
    return tuple(a) if isinstance(a, list) else a


def _long(i: torch.Tensor) -> torch.Tensor:
    return i if i.dtype in (torch.int64, torch.bool) else i.to(torch.int64)


def reshape(x, shape, name=None):
    return torch.reshape(ensure_tensor(x), tuple(_ints(shape)))


def _contiguous_strides(shape):
    strides, acc = [], 1
    for s in reversed(shape):
        strides.append(acc)
        acc *= builtins.max(s, 1)
    return tuple(reversed(strides))


def reshape_(x, shape, name=None):
    """In place: ``x`` becomes a ``shape`` view of its own storage (x
    must be contiguous)."""
    shape = list(_ints(shape))
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape[shape.index(-1)] = x.numel() // builtins.max(known, 1)
    if not x.is_contiguous() or int(np.prod(shape)) != x.numel():
        raise ValueError(f"reshape_: cannot view {tuple(x.shape)} as "
                         f"{tuple(shape)} in place")
    return x.as_strided_(shape, _contiguous_strides(shape),
                         x.storage_offset())


def transpose(x, perm, name=None):
    return ensure_tensor(x).permute(*_ints(perm))


def t(input, name=None):
    input = ensure_tensor(input)
    if input.ndim < 2:
        return input.clone()
    if input.ndim == 2:
        return input.t()
    raise ValueError("paddle.t only supports ndim<=2; use transpose")


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    x = ensure_tensor(x)
    if x.ndim == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


def squeeze(x, axis=None, name=None):
    x = ensure_tensor(x)
    if axis is None:
        return torch.squeeze(x)
    ax = _axes(axis)
    ax = (ax,) if isinstance(ax, int) else ax
    dims = tuple(a % x.ndim for a in ax if x.shape[a % x.ndim] == 1) \
        if x.ndim else ()
    return torch.squeeze(x, dims) if dims else x


def squeeze_(x, axis=None, name=None):
    if axis is None:
        return x.squeeze_()
    ax = _axes(axis)
    ax = (ax,) if isinstance(ax, int) else ax
    for d in sorted((a % x.ndim for a in ax), reverse=True):
        if x.shape[d] == 1:
            x.squeeze_(d)
    return x


def _unsqueeze_dims(x, axis):
    ax = _axes(axis)
    ax = (ax,) if isinstance(ax, int) else ax
    out_nd = x.ndim + len(ax)
    return sorted(a % out_nd for a in ax)


def unsqueeze(x, axis, name=None):
    x = ensure_tensor(x)
    for d in _unsqueeze_dims(x, axis):
        x = x.unsqueeze(d)
    return x


def unsqueeze_(x, axis, name=None):
    for d in _unsqueeze_dims(x, axis):
        x.unsqueeze_(d)
    return x


def concat(x, axis=0, name=None):
    ts = promote(*[ensure_tensor(t_) for t_ in x])
    return torch.cat(ts, dim=_ints(axis))


def stack(x, axis=0, name=None):
    return torch.stack(promote(*[ensure_tensor(t_) for t_ in x]), dim=axis)


def split(x, num_or_sections, axis=0, name=None) -> List[torch.Tensor]:
    x = ensure_tensor(x)
    axis = _ints(axis)
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections != 0:
            raise ValueError(f"split: axis dim {dim} is not divisible by "
                             f"num_or_sections={num_or_sections}")
        sections = [dim // num_or_sections] * num_or_sections
    else:
        sections = _ints(num_or_sections)
        neg = [i for i, s in enumerate(sections) if s < 0]
        if neg:
            sections[neg[0]] = dim - builtins.sum(s for s in sections
                                                  if s >= 0)
    return list(torch.split(x, sections, dim=axis))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unstack(x, axis=0, num=None):
    return list(torch.unbind(ensure_tensor(x), dim=axis))


def unbind(input, axis=0):
    return unstack(input, axis)


def tile(x, repeat_times, name=None):
    return torch.tile(ensure_tensor(x), tuple(_ints(repeat_times)))


def _expand_shape(x, shape):
    shape = _ints(shape)
    xs = [1] * (len(shape) - x.ndim) + list(x.shape)
    return tuple(xs[i] if s == -1 else s for i, s in enumerate(shape))


def expand(x, shape, name=None):
    x = ensure_tensor(x)
    return torch.broadcast_to(x, _expand_shape(x, shape))


def expand_as(x, y, name=None):
    return expand(x, list(ensure_tensor(y).shape))


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def broadcast_tensors(input, name=None):
    return list(torch.broadcast_tensors(*[ensure_tensor(t_)
                                          for t_ in input]))


def flip(x, axis, name=None):
    ax = _axes(axis)
    return torch.flip(ensure_tensor(x), (ax,) if isinstance(ax, int) else ax)


def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(ensure_tensor(x), k, tuple(axes))


def roll(x, shifts, axis=None, name=None):
    x = ensure_tensor(x)
    sh = _axes(shifts)
    if axis is None:
        return torch.roll(x, sh)
    return torch.roll(x, sh, _axes(axis))


def gather(x, index, axis=0, name=None):
    x, index = ensure_tensor(x), ensure_tensor(index)
    return torch.index_select(x, _ints(axis), _long(index.reshape(-1)))


def _nd_index(index):
    index = _long(index)
    return tuple(index[..., k] for k in range(index.shape[-1]))


def gather_nd(x, index, name=None):
    x, index = ensure_tensor(x), ensure_tensor(index)
    return x[_nd_index(index)]


def scatter(x, index, updates, overwrite=True, name=None):
    x, index, updates = (ensure_tensor(x), ensure_tensor(index),
                         ensure_tensor(updates))
    i = (_long(index.reshape(-1)),)
    u = updates.to(x.dtype)
    if overwrite:
        return x.index_put(i, u)
    return x.index_put(i, torch.zeros_like(u)).index_put(i, u,
                                                         accumulate=True)


def scatter_(x, index, updates, overwrite=True, name=None):
    i = (_long(ensure_tensor(index).reshape(-1)),)
    u = ensure_tensor(updates).to(x.dtype)
    if overwrite:
        return x.index_put_(i, u)
    return x.index_put_(i, torch.zeros_like(u)).index_put_(
        i, u, accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    index, updates = ensure_tensor(index), ensure_tensor(updates)
    zero = torch.zeros(tuple(_ints(shape)), dtype=updates.dtype,
                       device=updates.device)
    return zero.index_put(_nd_index(index), updates, accumulate=True)


def scatter_nd_add(x, index, updates, name=None):
    x, index, updates = (ensure_tensor(x), ensure_tensor(index),
                         ensure_tensor(updates))
    return x.index_put(_nd_index(index), updates.to(x.dtype),
                       accumulate=True)


def index_select(x, index, axis=0, name=None):
    return gather(x, index, axis)


def index_sample(x, index):
    x, index = ensure_tensor(x), ensure_tensor(index)
    return torch.gather(x, 1, _long(index))


def index_add(x, index, axis, value, name=None):
    x, index, value = (ensure_tensor(x), ensure_tensor(index),
                       ensure_tensor(value))
    return x.index_add(axis, _long(index.reshape(-1)), value.to(x.dtype))


def index_add_(x, index, axis, value, name=None):
    return x.index_add_(axis, _long(ensure_tensor(index).reshape(-1)),
                        ensure_tensor(value).to(x.dtype))


def index_put(x, indices, value, accumulate=False, name=None):
    x, value = ensure_tensor(x), ensure_tensor(value)
    idx = tuple(_long(ensure_tensor(i)) for i in indices)
    return x.index_put(idx, value.to(x.dtype), accumulate=accumulate)


def index_put_(x, indices, value, accumulate=False, name=None):
    idx = tuple(_long(ensure_tensor(i)) for i in indices)
    return x.index_put_(idx, ensure_tensor(value).to(x.dtype),
                        accumulate=accumulate)


def masked_select(x, mask, name=None):
    x, mask = ensure_tensor(x), ensure_tensor(mask)
    return torch.masked_select(x, mask.to(torch.bool))


def masked_fill(x, mask, value, name=None):
    x, mask = ensure_tensor(x), ensure_tensor(mask).to(torch.bool)
    if isinstance(value, torch.Tensor):
        return torch.where(mask, value.to(x.dtype), x)
    if isinstance(value, float) and not (x.is_floating_point()
                                         or x.is_complex()):
        x = x.to(core.get_default_dtype())
    return x.masked_fill(mask, value)


def where(condition, x=None, y=None, name=None):
    condition = ensure_tensor(condition)
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    x = ensure_tensor(x, y if isinstance(y, torch.Tensor) else None)
    y = ensure_tensor(y, x)
    return torch.where(condition.to(torch.bool), *promote(x, y))


def nonzero(x, as_tuple=False):
    nz = torch.nonzero(ensure_tensor(x))
    if as_tuple:
        return tuple(nz[:, k].to(torch.int32) for k in range(nz.shape[1]))
    return nz.to(torch.int32)


def take_along_axis(arr, indices, axis, broadcast=True):
    arr, indices = ensure_tensor(arr), ensure_tensor(indices)
    return torch.take_along_dim(arr, _long(indices), dim=axis)


def put_along_axis(arr, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True):
    arr, indices = ensure_tensor(arr), _long(ensure_tensor(indices))
    values = ensure_tensor(values, arr).to(arr.dtype)
    values = values.expand(indices.shape) if values.ndim else \
        torch.full(indices.shape, values.item(), dtype=arr.dtype,
                   device=arr.device)
    if reduce == "add":
        return arr.scatter_add(axis, indices, values)
    if reduce in ("multiply", "mul"):
        return arr.scatter_reduce(axis, indices, values, "prod")
    return arr.scatter(axis, indices, values)


def repeat_interleave(x, repeats, axis=None, name=None):
    x = ensure_tensor(x)
    if isinstance(repeats, torch.Tensor):
        repeats = _long(repeats)
    return torch.repeat_interleave(x, repeats, dim=axis)


def _first_index(inverse: torch.Tensor, n_unique: int) -> torch.Tensor:
    pos = torch.arange(inverse.numel(), device=inverse.device)
    first = torch.full((n_unique,), inverse.numel(), dtype=torch.int64,
                       device=inverse.device)
    return first.scatter_reduce(0, inverse.reshape(-1), pos, "amin")


def unique(x, return_index=False, return_inverse=False,
           return_counts=False, axis=None, dtype="int64", name=None):
    x = ensure_tensor(x)
    src = x.reshape(-1) if axis is None else x
    vals, inv, counts = torch.unique(src, sorted=True, return_inverse=True,
                                     return_counts=True, dim=axis)
    outs = [vals]
    if return_index:
        outs.append(_first_index(inv, vals.shape[0 if axis is None
                                                  else axis]).to(torch.int32))
    if return_inverse:
        outs.append((inv.reshape(x.shape) if axis is None and x.ndim > 1
                     else inv).to(torch.int32))
    if return_counts:
        outs.append(counts.to(torch.int32))
    return outs[0] if len(outs) == 1 else tuple(outs)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    x = ensure_tensor(x)
    src = x.reshape(-1) if axis is None else x
    vals, inv, counts = torch.unique_consecutive(
        src, return_inverse=True, return_counts=True, dim=axis)
    outs = [vals]
    if return_inverse:
        outs.append(inv.to(torch.int32))
    if return_counts:
        outs.append(counts.to(torch.int32))
    return outs[0] if len(outs) == 1 else tuple(outs)


def sort(x, axis=-1, descending=False, stable=False, name=None):
    out = torch.sort(ensure_tensor(x), dim=axis, stable=True).values
    return torch.flip(out, (axis,)) if descending else out


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    idx = torch.argsort(ensure_tensor(x), dim=axis, stable=True)
    idx = torch.flip(idx, (axis,)) if descending else idx
    return idx.to(torch.int32)


def _sliced(a, specs):
    """``a`` sliced by ``(axis, start, end, step)`` specs with Python's
    rules (negative steps too)."""
    idx = [builtins.slice(None)] * a.ndim
    for ax, s, e, st in specs:
        if st < 0:
            rng = range(*builtins.slice(s, e, st).indices(a.shape[ax]))
            a = torch.index_select(a, ax, torch.tensor(
                list(rng), dtype=torch.int64, device=a.device))
        else:
            idx[ax] = builtins.slice(s, e, st)
    return a[tuple(idx)]


def slice(input, axes, starts, ends):
    input = ensure_tensor(input)
    return _sliced(input, [(ax, s, e, 1) for ax, s, e in
                           zip(axes, _ints(starts), _ints(ends))])


def strided_slice(x, axes, starts, ends, strides, name=None):
    x = ensure_tensor(x)
    return _sliced(x, list(zip(axes, _ints(starts), _ints(ends),
                               _ints(strides))))


def crop(x, shape=None, offsets=None, name=None):
    x = ensure_tensor(x)
    shape = _ints(shape) if shape is not None else list(x.shape)
    offsets = _ints(offsets) if offsets is not None else [0] * x.ndim
    return x[tuple(builtins.slice(o, o + s) for o, s in zip(offsets, shape))]


def moveaxis(x, source, destination, name=None):
    return torch.movedim(ensure_tensor(x), source, destination)


def swapaxes(x, axis0, axis1, name=None):
    return torch.swapaxes(ensure_tensor(x), axis0, axis1)


def as_complex(x, name=None):
    x = ensure_tensor(x)
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x, name=None):
    x = ensure_tensor(x)
    if not x.is_complex():
        return torch.stack([x, torch.zeros_like(x)], dim=-1)
    return torch.stack([torch.real(x), torch.imag(x)], dim=-1)


def cast(x, dtype):
    return ensure_tensor(x).to(core.convert_dtype(dtype))


def numel(x, name=None):
    x = ensure_tensor(x)
    return torch.tensor(x.numel(), dtype=torch.int32, device=x.device)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    input = ensure_tensor(input)
    size = (index_num + nshards - 1) // nshards
    lo, hi = shard_id * size, (shard_id + 1) * size
    inside = (input >= lo) & (input < hi)
    return torch.where(inside, input - lo,
                       torch.full_like(input, ignore_value))


def unfold(x, axis, size, step, name=None):
    return ensure_tensor(x).unfold(axis, size, step)


def tensordot(x, y, axes=2, name=None):
    x, y = promote(ensure_tensor(x), ensure_tensor(y))
    if isinstance(axes, torch.Tensor):
        axes = axes.tolist()
    if isinstance(axes, (list, tuple)):
        axes = [list(a) if isinstance(a, (list, tuple)) else [a]
                for a in axes]
    return torch.tensordot(x, y, dims=axes)


def _atleast(fn, inputs):
    outs = [fn(ensure_tensor(i)) for i in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_1d(*inputs, name=None):
    return _atleast(torch.atleast_1d, inputs)


def atleast_2d(*inputs, name=None):
    return _atleast(torch.atleast_2d, inputs)


def atleast_3d(*inputs, name=None):
    return _atleast(torch.atleast_3d, inputs)


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return ensure_tensor(x).view(core.convert_dtype(shape_or_dtype))


def view_as(x, other, name=None):
    return reshape(x, list(ensure_tensor(other).shape))


def tolist(x):
    return ensure_tensor(x).tolist()


def pad_basic(x, pad, value=0.0):
    x = ensure_tensor(x)
    pairs = [(int(pad[2 * i]), int(pad[2 * i + 1]))
             for i in range(len(pad) // 2)]
    flat = [p for pair in reversed(pairs) for p in pair]
    return F.pad(x, flat, value=value)
