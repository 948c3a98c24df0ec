"""Long-tail tensor functions: the counterpart of
``paddle2_tpu/ops/extra.py``."""

from __future__ import annotations

import builtins
import itertools

import numpy as np
import torch

from ..framework import random as fr
from .dispatch import ensure_tensor, promote
from .math import _floating, _wide, quantile_along
from .manipulation import _sliced

__all__ = [
    "histogramdd", "trapezoid", "cumulative_trapezoid", "nanmedian",
    "nanquantile", "take", "diagonal", "real", "imag",
    "bitwise_left_shift", "bitwise_right_shift", "frexp", "polygamma",
    "multigammaln", "gammaln", "gammainc", "gammaincc", "vander",
    "cartesian_prod", "combinations", "column_stack", "row_stack",
    "hstack", "vstack", "dstack", "tensor_split", "hsplit", "vsplit",
    "dsplit", "block_diag", "unflatten", "positive", "negative",
    "signbit", "isneginf", "isposinf", "isreal", "aminmax",
    "float_power", "addcdiv", "addcmul", "baddbmm", "cdist", "pdist",
    "flipud", "fliplr", "logaddexp2", "sinc", "xlogy", "exp2",
    "clip_by_norm", "sgn", "fix", "fmod", "isin", "vecdot", "vdot",
    "slice_scatter", "select_scatter", "top_p_sampling",
]


def _ts(*xs):
    return promote(*[ensure_tensor(x) for x in xs])


# ------------------------------------------------------------- elementwise

def positive(x, name=None):
    return torch.positive(ensure_tensor(x))


def negative(x, name=None):
    return torch.neg(ensure_tensor(x))


def signbit(x, name=None):
    return torch.signbit(ensure_tensor(x))


def isneginf(x, name=None):
    return torch.isneginf(ensure_tensor(x))


def isposinf(x, name=None):
    return torch.isposinf(ensure_tensor(x))


def isreal(x, name=None):
    return torch.isreal(ensure_tensor(x))


def float_power(x, y, name=None):
    """``x ** y`` computed in float32 (``jnp.float_power``'s float64 under
    the x32 policy); the result keeps a float input's dtype, and an
    integer one gives float32."""
    x, y = _ts(x, y)
    if x.is_complex():
        return torch.pow(x.to(torch.complex64), y.to(torch.complex64))
    out = torch.pow(x.to(torch.float32), y.to(torch.float32))
    return out.to(x.dtype) if x.is_floating_point() else out


def logaddexp2(x, y, name=None):
    return torch.logaddexp2(*[_floating(t) for t in _ts(x, y)])


def sinc(x, name=None):
    return torch.sinc(_floating(ensure_tensor(x)))


def xlogy(x, y, name=None):
    return torch.xlogy(*[_floating(t) for t in _ts(x, y)])


def exp2(x, name=None):
    return torch.exp2(_floating(ensure_tensor(x)))


def sgn(x, name=None):
    return torch.sgn(ensure_tensor(x))


def fix(x, name=None):
    return torch.trunc(ensure_tensor(x))


def fmod(x, y, name=None):
    return torch.fmod(*_ts(x, y))


def frexp(x, name=None):
    m, e = torch.frexp(_floating(ensure_tensor(x)))
    return m, e.to(torch.int32)


def polygamma(x, n, name=None):
    return torch.polygamma(int(n), _floating(ensure_tensor(x)))


def gammaln(x, name=None):
    return torch.lgamma(_floating(ensure_tensor(x)))


def multigammaln(x, p, name=None):
    return torch.special.multigammaln(_floating(ensure_tensor(x)), int(p))


def gammainc(x, y, name=None):
    return _wide(torch.special.gammainc)(*[_floating(t)
                                           for t in _ts(x, y)])


def gammaincc(x, y, name=None):
    return _wide(torch.special.gammaincc)(*[_floating(t)
                                            for t in _ts(x, y)])


def bitwise_left_shift(x, y, is_arithmetic=True, name=None):
    return torch.bitwise_left_shift(*_ts(x, y))


_UNSIGNED_BITS = {torch.int8: 8, torch.int16: 16, torch.int32: 32,
                  torch.int64: 64}


def bitwise_right_shift(x, y, is_arithmetic=True, name=None):
    x, y = _ts(x, y)
    if is_arithmetic or x.dtype not in _UNSIGNED_BITS:
        return torch.bitwise_right_shift(x, y)
    # logical shift: the bits as unsigned, shifted, read back signed
    bits = _UNSIGNED_BITS[x.dtype]
    if bits == 64:
        raise TypeError("a logical right shift of int64 is not supported")
    wide = x.to(torch.int64) & ((1 << bits) - 1)
    out = torch.bitwise_right_shift(wide, y.to(torch.int64))
    out = torch.where(out >= (1 << (bits - 1)), out - (1 << bits), out)
    return out.to(x.dtype)


def addcdiv(input, tensor1, tensor2, value=1.0, name=None):
    a, b, c = _ts(input, tensor1, tensor2)
    return a + value * b / c


def addcmul(input, tensor1, tensor2, value=1.0, name=None):
    a, b, c = _ts(input, tensor1, tensor2)
    return a + value * b * c


# -------------------------------------------------------------- reductions

def nanmedian(x, axis=None, keepdim=False, name=None):
    return quantile_along(x, 0.5, axis, keepdim, "midpoint",
                          ignore_nan=True)


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    return quantile_along(x, q, axis, keepdim, "linear", ignore_nan=True)


def aminmax(x, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    dims = tuple(range(x.ndim)) if axis is None else axis
    return (torch.amin(x, dim=dims, keepdim=keepdim),
            torch.amax(x, dim=dims, keepdim=keepdim))


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    y = _floating(ensure_tensor(y))
    if x is not None:
        return torch.trapezoid(*promote(y, ensure_tensor(x)), dim=axis)
    return torch.trapezoid(y, dx=dx or 1.0, dim=axis)


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    y = _floating(ensure_tensor(y))
    n = y.shape[axis]
    avg = (y.narrow(axis, 1, n - 1) + y.narrow(axis, 0, n - 1)) / 2.0
    if x is not None:
        x = ensure_tensor(x).to(y.dtype)
        d = x.narrow(axis, 1, n - 1) - x.narrow(axis, 0, n - 1)
    else:
        d = dx or 1.0
    return torch.cumsum(avg * d, dim=axis)


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """On the host, as the JAX package computes it (``np.histogramdd``):
    the counts and the edges of each dimension, float32, on ``x``'s
    device."""
    x = ensure_tensor(x)
    w = None if weights is None else \
        ensure_tensor(weights).detach().cpu().numpy()
    hist, edges = np.histogramdd(x.detach().cpu().numpy(), bins=bins,
                                 range=ranges, density=density, weights=w)

    def dev(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(x.device)
    return dev(hist), [dev(e) for e in edges]


# ---------------------------------------------------------- index / select

def take(x, index, mode="raise", name=None):
    x, index = ensure_tensor(x), ensure_tensor(index)
    flat = x.reshape(-1)
    n = flat.shape[0]
    i = index.to(torch.int64)
    if mode == "raise":
        if i.numel() and (int(i.min()) < -n or int(i.max()) >= n):
            raise IndexError(
                f"take(mode='raise'): index out of range for tensor with "
                f"{n} elements (got [{int(i.min())}, {int(i.max())}])")
    elif mode == "wrap":
        i = torch.remainder(i, n)
    elif mode == "clip":
        i = i.clamp(0, n - 1)
    return flat[i]


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(ensure_tensor(x), offset, axis1, axis2)


def isin(x, test_x, assume_unique=False, invert=False, name=None):
    return torch.isin(*_ts(x, test_x), invert=invert)


def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    x, value = ensure_tensor(x), ensure_tensor(value)
    specs = list(zip(axes, starts, ends, strides))
    if any(st < 0 for *_, st in specs):
        # scatter through the positions a negative stride reads
        pos = torch.arange(x.numel(), device=x.device).reshape(x.shape)
        sel = _sliced(pos, specs).reshape(-1)
        return x.reshape(-1).index_put((sel,), value.to(x.dtype).reshape(
            -1)).reshape(x.shape)
    out = x.clone()
    idx = [builtins.slice(None)] * x.ndim
    for ax, s, e, st in specs:
        idx[ax] = builtins.slice(s, e, st)
    out[tuple(idx)] = value.to(x.dtype)
    return out


def select_scatter(x, values, axis, index, name=None):
    x = ensure_tensor(x)
    return torch.select_scatter(x, ensure_tensor(values).to(x.dtype), axis,
                                index)


# ------------------------------------------------------------- composition

def vander(x, n=None, increasing=False, name=None):
    """The powers ``x ** k`` for ``k < n`` as columns, by repeated
    products (differentiable at 0)."""
    x = ensure_tensor(x)
    n = x.shape[0] if n is None else int(n)
    cols = [torch.ones_like(x)]
    for _ in range(1, n):
        cols.append(cols[-1] * x)
    out = torch.stack(cols[:n], dim=-1)
    return out if increasing else torch.flip(out, (-1,))


def cartesian_prod(x, name=None):
    ts = promote(*[ensure_tensor(t) for t in (
        x if isinstance(x, (list, tuple)) else [x])])
    grids = torch.meshgrid(*ts, indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], dim=-1)


def combinations(x, r=2, with_replacement=False, name=None):
    x = ensure_tensor(x)
    gen = (itertools.combinations_with_replacement if with_replacement
           else itertools.combinations)
    idx = np.asarray(list(gen(range(int(x.shape[0])), r)),
                     np.int64).reshape(-1, r)
    return x[torch.from_numpy(idx).to(x.device)]


def column_stack(x, name=None):
    return torch.column_stack(_ts(*x))


def row_stack(x, name=None):
    return torch.vstack(_ts(*x))


def hstack(x, name=None):
    return torch.hstack(_ts(*x))


def vstack(x, name=None):
    return torch.vstack(_ts(*x))


def dstack(x, name=None):
    return torch.dstack(_ts(*x))


def _sections(arg):
    return arg if isinstance(arg, int) else list(arg)


def tensor_split(x, num_or_indices, axis=0, name=None):
    return list(torch.tensor_split(ensure_tensor(x),
                                   _sections(num_or_indices), dim=axis))


def hsplit(x, num_or_indices, name=None):
    return list(torch.hsplit(ensure_tensor(x), _sections(num_or_indices)))


def vsplit(x, num_or_indices, name=None):
    return list(torch.vsplit(ensure_tensor(x), _sections(num_or_indices)))


def dsplit(x, num_or_indices, name=None):
    return list(torch.dsplit(ensure_tensor(x), _sections(num_or_indices)))


def block_diag(inputs, name=None):
    return torch.block_diag(*_ts(*inputs))


def unflatten(x, axis, shape, name=None):
    return torch.unflatten(ensure_tensor(x), axis, tuple(shape))


def flipud(x, name=None):
    return torch.flipud(ensure_tensor(x))


def fliplr(x, name=None):
    return torch.fliplr(ensure_tensor(x))


# ------------------------------------------------------------------ linalg

def baddbmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    i, a, b = _ts(input, x, y)
    return beta * i + alpha * torch.matmul(a, b)


def vecdot(x, y, axis=-1, name=None):
    a, b = _ts(x, y)
    return torch.sum(torch.conj(a) * b, dim=axis)


def vdot(x, y, name=None):
    a, b = _ts(x, y)
    return torch.vdot(a.reshape(-1), b.reshape(-1))


def _pnorm(d, p):
    if p == 2.0:
        return torch.sqrt(torch.clamp(torch.sum(d * d, -1), min=1e-30))
    return torch.sum(torch.abs(d) ** p, -1) ** (1.0 / p)


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    a, b = _ts(x, y)
    return _pnorm(a[..., :, None, :] - b[..., None, :, :], p)


def pdist(x, p=2.0, name=None):
    x = ensure_tensor(x)
    n = int(x.shape[0])
    iu = torch.triu_indices(n, n, 1, device=x.device)
    return _pnorm(x[:, None, :] - x[None, :, :], p)[iu[0], iu[1]]


def clip_by_norm(x, max_norm, name=None):
    x = ensure_tensor(x)
    norm = torch.sqrt(torch.clamp(torch.sum(x * x), min=1e-30))
    return torch.where(norm > max_norm, x * (max_norm / norm), x)


# ----------------------------------------------------------------- complex

def real(x, name=None):
    x = ensure_tensor(x)
    return torch.real(x) if x.is_complex() else x


def imag(x, name=None):
    """The imaginary part; zeros for a real ``x``, with a (zero)
    gradient to ``x`` as in the JAX package."""
    x = ensure_tensor(x)
    if x.is_complex():
        return torch.imag(x)
    if not x.is_floating_point():
        return torch.zeros_like(x)
    z = torch.complex(x.float(), torch.zeros_like(x, dtype=torch.float32))
    return torch.imag(z).to(x.dtype)


# ------------------------------------------------------------------ search

def _nucleus_keep_mask(sorted_probs, p):
    """Keep-mask over descending sorted probabilities: the smallest
    prefix that reaches mass ``p``."""
    cum = torch.cumsum(sorted_probs, -1)
    return cum - sorted_probs < p[..., None]


def top_p_sampling(x, ps, threshold=None, seed=None, name=None):
    """Nucleus sampling over the last axis: keep the smallest prefix of
    the sorted probabilities whose mass reaches ``ps``, renormalize and
    draw one index a row (int32), from the port's generator (or one
    seeded by ``seed``). Returns ``(ids, None)``."""
    x = ensure_tensor(x)
    p = ensure_tensor(ps, x).to(x.dtype).reshape(x.shape[:-1])
    if seed not in (None, -1):
        g = torch.Generator(device=x.device)
        g.manual_seed(int(seed))
    else:
        g = fr.generator(x.device)
    probs, order = torch.sort(x, dim=-1, descending=True, stable=True)
    keep = _nucleus_keep_mask(probs, p)
    filt = torch.where(keep, probs, torch.zeros_like(probs)).float()
    filt = filt / filt.sum(-1, keepdim=True).clamp(min=1e-30)
    rows = filt.reshape(-1, filt.shape[-1])
    pick = torch.multinomial(rows, 1, generator=g).reshape(
        *filt.shape[:-1], 1)
    return torch.gather(order, -1, pick).to(torch.int32), None
