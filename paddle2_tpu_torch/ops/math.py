"""Elementwise, reduction and scan ops: the counterpart of
``paddle2_tpu/ops/math.py``. Each op is a plain function on torch
tensors with the JAX op's signature and result dtype (an integer sum is
int32, as ``jnp.sum`` gives under the x32 policy); gradients are
torch.autograd's."""

from __future__ import annotations

import builtins

import numpy as np
import torch

from ..framework import core
from .dispatch import ensure_tensor, promote

__all__ = []


def _export(name, fn):
    fn.__name__ = fn.__qualname__ = name
    globals()[name] = fn
    __all__.append(name)
    return fn


def _unary(name, tfn):
    def op(x, name=None):  # noqa: A002 — paddle ops take `name`
        return tfn(ensure_tensor(x))
    return _export(name, op)


def _binary(name, tfn):
    def op(x, y, name=None):  # noqa: A002
        x = ensure_tensor(x, y if isinstance(y, torch.Tensor) else None)
        y = ensure_tensor(y, x)
        return tfn(*promote(x, y))
    return _export(name, op)


def _floating(x: torch.Tensor) -> torch.Tensor:
    """``x``, cast to the default float dtype where it is not inexact
    (``jnp``'s rule for functions that need a float)."""
    if x.is_floating_point() or x.is_complex():
        return x
    return x.to(core.get_default_dtype())


def _float_unary(name, tfn):
    return _unary(name, lambda a: tfn(_floating(a)))


def _wide(tfn):
    """``tfn`` over float32 copies of half-precision inputs, cast back to
    the first one's dtype: for torch functions without half-precision
    kernels (on the CPU, the card or both)."""
    def run(a, *rest):
        if a.dtype in (torch.bfloat16, torch.float16):
            rest = [r.float() if isinstance(r, torch.Tensor)
                    and r.dtype in (torch.bfloat16, torch.float16) else r
                    for r in rest]
            return tfn(a.float(), *rest).to(a.dtype)
        return tfn(a, *rest)
    return run


def _int_result(dtype: torch.dtype) -> torch.dtype:
    """The dtype of an integer sum, product or scan (``jnp``'s default
    int under x32)."""
    if dtype in (torch.uint8, torch.uint16, torch.uint32, torch.uint64):
        return torch.uint32
    return torch.int32


# ---------------------------------------------------------------- unary
for _n, _f in (("abs", torch.abs), ("ceil", torch.ceil),
               ("floor", torch.floor), ("neg", torch.neg),
               ("round", torch.round), ("sign", torch.sign),
               ("square", torch.square), ("trunc", torch.trunc),
               ("conj", torch.conj_physical),
               ("isnan", torch.isnan), ("isinf", torch.isinf),
               ("isfinite", torch.isfinite),
               ("bitwise_not", torch.bitwise_not)):
    _unary(_n, _f)
for _n, _f in (("acos", torch.acos), ("acosh", torch.acosh),
               ("asin", torch.asin), ("asinh", torch.asinh),
               ("atan", torch.atan), ("atanh", torch.atanh),
               ("cos", torch.cos), ("cosh", torch.cosh),
               ("digamma", torch.digamma), ("erf", torch.erf),
               ("erfinv", torch.erfinv), ("exp", torch.exp),
               ("expm1", torch.expm1), ("lgamma", torch.lgamma),
               ("log", torch.log), ("log2", torch.log2),
               ("log10", torch.log10), ("log1p", torch.log1p),
               ("reciprocal", torch.reciprocal), ("rsqrt", torch.rsqrt),
               ("sigmoid", torch.sigmoid), ("sin", torch.sin),
               ("sinh", torch.sinh), ("sqrt", torch.sqrt),
               ("tan", torch.tan), ("tanh", torch.tanh),
               ("angle", _wide(torch.angle)),
               ("i0", _wide(torch.special.i0)),
               ("i0e", _wide(torch.special.i0e)),
               ("i1", _wide(torch.special.i1)),
               ("i1e", _wide(torch.special.i1e)), ("logit", torch.logit),
               ("deg2rad", torch.deg2rad), ("rad2deg", torch.rad2deg)):
    _float_unary(_n, _f)
_unary("frac", lambda a: a - torch.trunc(a))
_unary("exponential_", lambda a: a)  # the random fill is ops/random.py's


def logical_not(x, out=None, name=None):
    return torch.logical_not(ensure_tensor(x))
_export("logical_not", logical_not)


# --------------------------------------------------------------- binary
for _n, _f in (("add", torch.add), ("subtract", torch.sub),
               ("multiply", torch.mul), ("divide", torch.true_divide),
               ("floor_divide", torch.floor_divide),
               ("remainder", torch.remainder), ("mod", torch.remainder),
               ("floor_mod", torch.remainder), ("pow_op", torch.pow),
               ("maximum", torch.maximum), ("minimum", torch.minimum),
               ("fmax", torch.fmax), ("fmin", torch.fmin),
               ("heaviside", torch.heaviside),
               ("nextafter", torch.nextafter), ("gcd", torch.gcd),
               ("lcm", torch.lcm), ("logical_and", torch.logical_and),
               ("logical_or", torch.logical_or),
               ("logical_xor", torch.logical_xor),
               ("bitwise_and", torch.bitwise_and),
               ("bitwise_or", torch.bitwise_or),
               ("bitwise_xor", torch.bitwise_xor)):
    _binary(_n, _f)
for _n, _f in (("atan2", torch.atan2), ("logaddexp", torch.logaddexp),
               ("hypot", torch.hypot), ("copysign", torch.copysign)):
    _binary(_n, lambda a, b, _f=_f: _f(_floating(a), _floating(b)))


def ldexp(x, y, name=None):
    """``x * 2.0 ** y``; an integer ``y`` makes a float32 power, as in the
    JAX package."""
    x = ensure_tensor(x)
    y = _floating(ensure_tensor(y, x))
    return x * torch.pow(2.0, y)
_export("ldexp", ldexp)


def polygamma_n(x, n, name=None):
    """``polygamma(n, x)`` with an integer tensor ``n`` (elementwise
    orders)."""
    x = _floating(ensure_tensor(x))
    n = ensure_tensor(n, x)
    orders = torch.unique(n)
    poly = _wide(lambda a, k: torch.polygamma(k, a))
    if orders.numel() == 1:
        return poly(x, int(orders.item()))
    out = torch.zeros_like(x)
    for k in orders.tolist():
        out = torch.where(n == k, poly(x, int(k)), out)
    return out
_export("polygamma_n", polygamma_n)


def pow(x, y, name=None):
    if isinstance(y, int) and not isinstance(y, bool):
        return torch.pow(ensure_tensor(x), y)
    return pow_op(x, y)  # noqa: F821
_export("pow", pow)


def divide_no_nan(x, y, name=None):
    x, y = promote(ensure_tensor(x), ensure_tensor(y))
    zero = y == 0
    return torch.where(zero, torch.zeros_like(x),
                       x / torch.where(zero, torch.ones_like(y), y))
_export("divide_no_nan", divide_no_nan)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    x = ensure_tensor(x)
    out = x * scale + bias if bias_after_scale else (x + bias) * scale
    if act is not None:
        out = getattr(torch.nn.functional, act)(out)
    return out
_export("scale", scale)


def clip(x, min=None, max=None, name=None):
    x = ensure_tensor(x)
    lo = float(min) if isinstance(min, (int, float)) else min
    hi = float(max) if isinstance(max, (int, float)) else max
    if not (x.is_floating_point() or x.is_complex()) and (
            isinstance(lo, float) or isinstance(hi, float)):
        x = _floating(x)
    return torch.clamp(x, lo, hi)
_export("clip", clip)


def lerp(x, y, weight, name=None):
    x, y = promote(ensure_tensor(x), ensure_tensor(y))
    return x + weight * (y - x)
_export("lerp", lerp)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(ensure_tensor(x), nan=nan, posinf=posinf,
                            neginf=neginf)
_export("nan_to_num", nan_to_num)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * ensure_tensor(x))
_export("stanh", stanh)


def multiplex(inputs, index, name=None):
    xs = torch.stack([ensure_tensor(t) for t in inputs], 0)
    idx = ensure_tensor(index).reshape(1, -1, *([1] * (xs.ndim - 2)))
    idx = idx.to(torch.int64).expand(1, *xs.shape[1:])
    return torch.gather(xs, 0, idx)[0]
_export("multiplex", multiplex)


# ----------------------------------------------------------- reductions

def _norm_axis(axis):
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        return tuple(int(a) for a in axis.reshape(-1).tolist())
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(axis, ndim):
    """``axis`` (None, an int or a sequence) as a tuple of dims."""
    ax = _norm_axis(axis)
    if ax is None:
        return tuple(range(ndim))
    return (ax,) if isinstance(ax, int) else ax


def _reduce(x, axis, keepdim, fn):
    """``fn(x, dims, keepdim)`` over ``axis``; a 0-d ``x`` reduces to
    itself."""
    if x.ndim == 0:
        return fn(x.reshape(1), (0,), False)
    return fn(x, _dims(axis, x.ndim), keepdim)


def _sum_like(name, tfn, floating=False):
    opname = name

    def op(x, axis=None, keepdim=False, dtype=None, name=None):  # noqa
        x = ensure_tensor(x)
        if dtype is not None:
            x = x.to(core.convert_dtype(dtype))
        elif floating:
            x = _floating(x)
        out = _reduce(x, axis, keepdim,
                      lambda a, d, k: tfn(a, dim=d, keepdim=k))
        if not (x.is_floating_point() or x.is_complex()):
            out = out.to(_int_result(x.dtype))
        return out
    return _export(opname, op)


def _prod(a, dim, keepdim):
    for d in sorted((d % a.ndim for d in dim), reverse=True):
        a = torch.prod(a, d, keepdim=keepdim)
    return a


_sum_like("sum", torch.sum)
_sum_like("mean", torch.mean, floating=True)
_sum_like("prod", _prod)
_sum_like("nansum", torch.nansum)


def _chooser(name, tfn):
    opname = name

    def op(x, axis=None, keepdim=False, name=None):  # noqa: A002
        return _reduce(ensure_tensor(x), axis, keepdim,
                       lambda a, d, k: tfn(a, dim=d, keepdim=k))
    return _export(opname, op)


_chooser("max", torch.amax)
_chooser("min", torch.amin)
_chooser("amax", torch.amax)
_chooser("amin", torch.amin)
_chooser("nanmean", lambda a, dim, keepdim: torch.nanmean(
    _floating(a), dim=dim, keepdim=keepdim))
_chooser("all", torch.all)
_chooser("any", torch.any)
_chooser("logsumexp", lambda a, dim, keepdim: torch.logsumexp(
    _floating(a), dim=dim, keepdim=keepdim))


def count_nonzero(x, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    return _reduce(x != 0, axis, keepdim, lambda a, d, k: torch.sum(
        a, dim=d, keepdim=k)).to(torch.int32)
_export("count_nonzero", count_nonzero)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _reduce(_floating(ensure_tensor(x)), axis, keepdim,
                   lambda a, d, k: torch.var(a, dim=d, keepdim=k,
                                             correction=int(unbiased)))
_export("var", var)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _reduce(_floating(ensure_tensor(x)), axis, keepdim,
                   lambda a, d, k: torch.std(a, dim=d, keepdim=k,
                                             correction=int(unbiased)))
_export("std", std)


def quantile_along(x, q, axis, keepdim, method, ignore_nan=False):
    """``jnp.quantile`` / ``jnp.nanquantile``: the reduced axes are
    sorted as one, and the positions ``q * (n - 1)`` read by ``method``
    (linear, lower, higher, nearest, midpoint). A vector ``q`` puts its
    axis first."""
    x = _floating(ensure_tensor(x))
    dims = _dims(axis, x.ndim) if x.ndim else ()
    dims = tuple(sorted(d % builtins.max(x.ndim, 1) for d in dims))
    keep = [d for d in range(x.ndim) if d not in dims]
    a = x.permute(*keep, *dims) if x.ndim else x.reshape(1)
    batch = [x.shape[d] for d in keep]
    a = a.reshape(*batch, -1)
    s = torch.sort(a, dim=-1).values
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    qs = qt.reshape(-1)
    if ignore_nan:
        n = (~torch.isnan(a)).sum(-1, keepdim=True).to(x.dtype)
    else:
        n = torch.full((*batch, 1), a.shape[-1], dtype=x.dtype,
                       device=x.device)
    pos = qs * (n - 1)                                  # [*batch, k]
    lo = torch.floor(pos).clamp(min=0)
    hi = torch.ceil(pos).clamp(min=0)
    last = (n - 1).clamp(min=0).to(torch.int64)
    lo_i = torch.minimum(lo.to(torch.int64), last)
    hi_i = torch.minimum(hi.to(torch.int64), last)
    v_lo = torch.gather(s, -1, lo_i)
    v_hi = torch.gather(s, -1, hi_i)
    if method == "linear":
        out = v_lo + (v_hi - v_lo) * (pos - lo)
    elif method == "lower":
        out = v_lo
    elif method == "higher":
        out = v_hi
    elif method == "nearest":
        out = torch.gather(s, -1, torch.minimum(
            torch.round(pos).to(torch.int64), last))
    elif method == "midpoint":
        out = (v_lo + v_hi) / 2
    else:
        raise ValueError(f"unknown interpolation {method!r}")
    if ignore_nan:
        out = torch.where(n == 0, torch.full_like(out, float("nan")), out)
    if keepdim:
        shape = [1 if d in dims else x.shape[d] for d in range(x.ndim)]
        out = out.reshape(*shape, -1) if x.ndim else out
    out = out.movedim(-1, 0)
    return out.reshape(out.shape[1:]) if qt.ndim == 0 else out


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    return quantile_along(x, 0.5, axis, keepdim, "midpoint")
_export("median", median)


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    return quantile_along(x, q, axis, keepdim, interpolation)
_export("quantile", quantile)


# ------------------------------------------------------- scans and misc

def _scan_input(x, axis):
    x = ensure_tensor(x)
    return (x.reshape(-1), 0) if axis is None else (x, int(axis))


def cumsum(x, axis=None, dtype=None, name=None):
    a, ax = _scan_input(x, _norm_axis(axis))
    if dtype is not None:
        a = a.to(core.convert_dtype(dtype))
    out = torch.cumsum(a, ax)
    if not (a.is_floating_point() or a.is_complex()):
        out = out.to(_int_result(a.dtype))
    return out
_export("cumsum", cumsum)


def cumprod(x, dim=None, dtype=None, name=None):
    a, ax = _scan_input(x, dim)
    if dtype is not None:
        a = a.to(core.convert_dtype(dtype))
    out = torch.cumprod(a, ax)
    if not (a.is_floating_point() or a.is_complex()):
        out = out.to(_int_result(a.dtype))
    return out
_export("cumprod", cumprod)


def cummax(x, axis=None, dtype="int64", name=None):
    a, ax = _scan_input(x, axis)
    vals, idx = torch.cummax(a, ax)
    return vals, idx.to(core.convert_dtype(dtype))
_export("cummax", cummax)


def cummin(x, axis=None, dtype="int64", name=None):
    a, ax = _scan_input(x, axis)
    vals, idx = torch.cummin(a, ax)
    return vals, idx.to(core.convert_dtype(dtype))
_export("cummin", cummin)


def logcumsumexp(x, axis=None, dtype=None, name=None):
    a, ax = _scan_input(x, axis)
    return torch.logcumsumexp(_floating(a), ax)
_export("logcumsumexp", logcumsumexp)


def _edge(v, x, axis):
    v = ensure_tensor(v, x)
    if v.ndim == 0:
        shape = list(x.shape)
        shape[axis] = 1
        v = v.expand(shape)
    return v.to(x.dtype)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    x = ensure_tensor(x)
    pre = None if prepend is None else _edge(prepend, x, axis)
    app = None if append is None else _edge(append, x, axis)
    return torch.diff(x, n=n, dim=axis, prepend=pre, append=app)
_export("diff", diff)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    x = ensure_tensor(x)
    out = torch.diagonal(x, offset, axis1, axis2).sum(-1)
    if not (x.is_floating_point() or x.is_complex()):
        out = out.to(_int_result(x.dtype))
    return out
_export("trace", trace)


def kron(x, y, name=None):
    return torch.kron(*promote(ensure_tensor(x), ensure_tensor(y)))
_export("kron", kron)


def cross(x, y, axis=9, name=None):
    x, y = promote(ensure_tensor(x), ensure_tensor(y))
    if axis == 9:
        axis = next((i for i, d in enumerate(x.shape) if d == 3), None)
        if axis is None:
            raise ValueError("cross: no axis with dimension 3")
    return torch.linalg.cross(x, y, dim=axis)
_export("cross", cross)


def inner(x, y, name=None):
    return torch.inner(*promote(ensure_tensor(x), ensure_tensor(y)))
_export("inner", inner)


def outer(x, y, name=None):
    x, y = promote(ensure_tensor(x), ensure_tensor(y))
    return torch.outer(x.reshape(-1), y.reshape(-1))
_export("outer", outer)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    input, x, y = promote(ensure_tensor(input), ensure_tensor(x),
                          ensure_tensor(y))
    return beta * input + alpha * (x @ y)
_export("addmm", addmm)


def renorm(x, p, axis, max_norm, name=None):
    x = ensure_tensor(x)
    dims = tuple(i for i in range(x.ndim) if i != axis % x.ndim)
    norms = torch.sum(torch.abs(x) ** p, dim=dims, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
    return x * factor
_export("renorm", renorm)


def histogram(input, bins=100, min=0, max=0, name=None):
    """Counts in the input's float dtype (the default float for an
    integer input), as ``jnp.histogram`` gives them."""
    a = _floating(ensure_tensor(input)).reshape(-1)
    return torch.histc(a.float(), bins=bins, min=float(min),
                       max=float(max)).to(a.dtype)
_export("histogram", histogram)


def bincount(x, weights=None, minlength=0, name=None):
    x = ensure_tensor(x).reshape(-1)
    n = int(x.max().item()) + 1 if x.numel() else 0
    length = builtins.max(n, minlength)
    if weights is not None:
        w = ensure_tensor(weights).reshape(-1)
        return torch.bincount(x.to(torch.int64), w, length).to(w.dtype)
    return torch.bincount(x.to(torch.int64), minlength=length).to(
        torch.int32)
_export("bincount", bincount)


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))
_export("broadcast_shape", broadcast_shape)


def increment(x, value=1.0, name=None):
    x = ensure_tensor(x)
    with torch.no_grad():
        x.add_(value)
    return x
_export("increment", increment)
