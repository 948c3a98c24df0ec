"""Comparison, logic and search ops: the counterpart of
``paddle2_tpu/ops/logic.py``. Indices come back int32, as under the JAX
package's x32 policy."""

from __future__ import annotations

import torch

from ..framework import core
from .dispatch import ensure_tensor, promote

__all__ = ["equal", "not_equal", "greater_than", "greater_equal",
           "less_than", "less_equal", "equal_all", "allclose", "isclose",
           "is_empty", "is_tensor", "argmax", "argmin", "topk", "kthvalue",
           "mode", "searchsorted", "bucketize", "index_fill", "index_fill_",
           "masked_scatter"]


def _cmp(opname, tfn):
    def op(x, y, name=None):
        x = ensure_tensor(x, y if isinstance(y, torch.Tensor) else None)
        y = ensure_tensor(y, x)
        return tfn(*promote(x, y))
    op.__name__ = op.__qualname__ = opname
    return op


equal = _cmp("equal", torch.eq)
not_equal = _cmp("not_equal", torch.ne)
greater_than = _cmp("greater_than", torch.gt)
greater_equal = _cmp("greater_equal", torch.ge)
less_than = _cmp("less_than", torch.lt)
less_equal = _cmp("less_equal", torch.le)


def _scalar(value: bool, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.bool, device=like.device)


def equal_all(x, y, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    if tuple(x.shape) != tuple(y.shape):
        return _scalar(False, x)
    return torch.all(torch.eq(*promote(x, y)))


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = promote(ensure_tensor(x), ensure_tensor(y))
    return torch.all(torch.isclose(x, y, rtol=rtol, atol=atol,
                                   equal_nan=equal_nan))


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = promote(ensure_tensor(x), ensure_tensor(y))
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


def is_empty(x, name=None):
    x = ensure_tensor(x)
    return _scalar(x.numel() == 0, x)


def is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def _arg(tfn, x, axis, keepdim, dtype):
    x = ensure_tensor(x)
    if axis is None:
        out = tfn(x.reshape(-1))
    else:
        out = tfn(x, dim=axis, keepdim=keepdim)
    return out.to(core.convert_dtype(dtype))


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    x = ensure_tensor(x)
    if isinstance(k, torch.Tensor):
        k = int(k.item())
    vals, idx = torch.topk(x, k, dim=-1 if axis is None else axis,
                           largest=largest, sorted=True)
    return vals, idx.to(torch.int32)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    vals, idx = torch.kthvalue(ensure_tensor(x), k, dim=axis,
                               keepdim=keepdim)
    return vals, idx.to(torch.int32)


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest of equally
    frequent ones) and the index of its last occurrence, as the JAX
    package computes them."""
    x = ensure_tensor(x)
    moved = torch.movedim(x, axis, -1)
    rows = moved.reshape(-1, moved.shape[-1])
    vals, idxs = [], []
    for row in rows:
        uniq, counts = torch.unique(row, return_counts=True)
        v = uniq[torch.argmax(counts)]
        vals.append(v)
        idxs.append(torch.nonzero(row == v)[-1, 0])
    shape = moved.shape[:-1]
    vals = torch.stack(vals).reshape(shape) if vals else \
        moved.new_empty(shape)
    idxs = torch.stack(idxs).reshape(shape).to(torch.int32) if idxs else \
        torch.empty(shape, dtype=torch.int32, device=x.device)
    if keepdim:
        vals, idxs = vals.unsqueeze(axis), idxs.unsqueeze(axis)
    return vals, idxs


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    ss, v = ensure_tensor(sorted_sequence), ensure_tensor(values)
    ss, v = promote(ss, v)
    return torch.searchsorted(ss.contiguous(), v.contiguous(),
                              right=right, out_int32=True)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def index_fill(x, index, axis, value, name=None):
    x, index = ensure_tensor(x), ensure_tensor(index)
    return x.index_fill(axis, index.reshape(-1).to(torch.int64), value)


def index_fill_(x, index, axis, value, name=None):
    return x.index_fill_(axis, ensure_tensor(index).reshape(-1).to(
        torch.int64), value)


def masked_scatter(x, mask, value, name=None):
    x, mask, value = ensure_tensor(x), ensure_tensor(mask), \
        ensure_tensor(value)
    return torch.masked_scatter(x, mask.to(torch.bool).expand(x.shape),
                                value.to(x.dtype))
