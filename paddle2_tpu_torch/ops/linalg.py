"""Linear algebra ops: the counterpart of ``paddle2_tpu/ops/linalg.py``.

torch's decompositions take float32 and float64; a bfloat16 or float16
operand is decomposed in float32 and the result cast back, so the result
dtype is the operand's, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..amp.casting import cast_call
from .dispatch import ensure_tensor, promote

__all__ = ["matmul", "bmm", "mm", "mv", "dot", "norm", "dist", "cond",
           "cholesky", "cholesky_solve", "qr", "svd", "pca_lowrank", "inv",
           "pinv", "det", "slogdet", "solve", "triangular_solve", "lstsq",
           "eig", "eigh", "eigvals", "eigvalsh", "matrix_power",
           "matrix_rank", "multi_dot", "corrcoef", "cov",
           "householder_product", "lu", "lu_unpack", "einsum",
           "vector_norm", "matrix_norm", "cholesky_inverse", "matrix_exp",
           "svd_lowrank", "ormqr"]

_NARROW = (torch.bfloat16, torch.float16)


def _wide(fn):
    """``fn`` over float32 copies of narrow float operands, each tensor
    result cast back to the first operand's dtype."""
    def run(*ts):
        dt = ts[0].dtype
        if dt not in _NARROW:
            return fn(*ts)
        out = fn(*[t.float() if t.dtype in _NARROW else t for t in ts])
        if isinstance(out, tuple):
            return tuple(o.to(dt) if o.is_floating_point() else o
                         for o in out)
        return out.to(dt) if out.is_floating_point() else out
    return run


def _t(x):
    return x.transpose(-1, -2)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    x, y = promote(ensure_tensor(x), ensure_tensor(y))
    if transpose_x and x.ndim >= 2:
        x = _t(x)
    if transpose_y and y.ndim >= 2:
        y = _t(y)
    return torch.matmul(x, y)


def mm(input, mat2, name=None):
    return matmul(input, mat2)


def bmm(x, y, name=None):
    return matmul(x, y)


def mv(x, vec, name=None):
    return matmul(x, vec)


def dot(x, y, name=None):
    x, y = promote(ensure_tensor(x), ensure_tensor(y))
    return torch.sum(x * y, dim=-1)


def norm(x, p=None, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    if isinstance(axis, (list, tuple)):
        axis = tuple(int(a) for a in axis)
    p = "fro" if p is None else p
    if axis is None and (p == "fro" or p == 2):
        return torch.sqrt(torch.sum(torch.square(x)))
    if p == "fro":
        return torch.sqrt(torch.sum(torch.square(x), dim=axis,
                                    keepdim=keepdim))
    dims = tuple(range(x.ndim)) if axis is None else axis
    if p == float("inf"):
        return torch.amax(torch.abs(x), dim=dims, keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(torch.abs(x), dim=dims, keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dim=dims, keepdim=keepdim)
    return torch.sum(torch.abs(x) ** p, dim=dims,
                     keepdim=keepdim) ** (1.0 / p)


def dist(x, y, p=2, name=None):
    x, y = promote(ensure_tensor(x), ensure_tensor(y))
    d = x - y
    if p == 0:
        return torch.sum((d != 0).to(d.dtype))
    if p == float("inf"):
        return torch.amax(torch.abs(d))
    if p == float("-inf"):
        return torch.amin(torch.abs(d))
    return torch.sum(torch.abs(d) ** p) ** (1.0 / p)


def cond(x, p=None, name=None):
    return _wide(lambda a: torch.linalg.cond(a, 2 if p is None else p))(
        ensure_tensor(x))


def cholesky(x, upper=False, name=None):
    return _wide(lambda a: torch.linalg.cholesky(a, upper=upper))(
        ensure_tensor(x))


def cholesky_solve(x, y, upper=False, name=None):
    x, y = promote(ensure_tensor(x), ensure_tensor(y))

    def fn(b, l):
        # two triangular solves that read the factor's lower triangle,
        # as the JAX package's (its gradient stays in that triangle)
        lo = _t(l) if upper else l
        z = torch.linalg.solve_triangular(lo, b, upper=False)
        return torch.linalg.solve_triangular(_t(lo), z, upper=True)
    return _wide(fn)(x, y)


def qr(x, mode="reduced", name=None):
    x = ensure_tensor(x)
    if mode == "r":
        return _wide(lambda a: torch.linalg.qr(a, mode="r")[1])(x)
    return _wide(lambda a: tuple(torch.linalg.qr(a, mode=mode)))(x)


def svd(x, full_matrices=False, name=None):
    return _wide(lambda a: tuple(torch.linalg.svd(
        a, full_matrices=full_matrices)))(ensure_tensor(x))


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    x = ensure_tensor(x)
    m, n = x.shape[-2], x.shape[-1]
    qv = q if q is not None else min(6, m, n)

    def fn(a):
        if center:
            a = a - torch.mean(a, dim=-2, keepdim=True)
        u, s, vh = torch.linalg.svd(a, full_matrices=False)
        return u[..., :qv], s[..., :qv], _t(vh)[..., :qv]
    return _wide(fn)(x)


def inv(x, name=None):
    return _wide(torch.linalg.inv)(ensure_tensor(x))


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return _wide(lambda a: torch.linalg.pinv(a, rtol=rcond,
                                             hermitian=hermitian))(
        ensure_tensor(x))


def det(x, name=None):
    return _wide(torch.linalg.det)(ensure_tensor(x))


def slogdet(x, name=None):
    """``[sign, logdet]`` stacked. Under AMP it casts as the JAX op's two
    dispatches do: the determinant as ``"slogdet"``, the stack as
    ``"stack"``."""
    sign, logdet = cast_call("slogdet", _wide(
        lambda a: tuple(torch.linalg.slogdet(a))), ensure_tensor(x))
    return cast_call("stack", torch.stack, [sign, logdet], dim=0)


slogdet.amp_name = "slogdet"      # cast inside: not wrapped again


def solve(x, y, name=None):
    x, y = promote(ensure_tensor(x), ensure_tensor(y))

    def fn(a, b):
        vec = b.ndim == a.ndim - 1
        out = torch.linalg.solve(a, b.unsqueeze(-1) if vec else b)
        return out.squeeze(-1) if vec else out
    return _wide(fn)(x, y)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    x, y = promote(ensure_tensor(x), ensure_tensor(y))

    def fn(a, b):
        if transpose:
            return torch.linalg.solve_triangular(
                _t(a), b, upper=not upper, unitriangular=unitriangular)
        return torch.linalg.solve_triangular(a, b, upper=upper,
                                             unitriangular=unitriangular)
    return _wide(fn)(x, y)


def lstsq(x, y, rcond=None, driver=None, name=None):
    """``jnp.linalg.lstsq``: the solution, the residuals (the squared
    norms of the columns of ``b - a x``, always, as the JAX package
    returns them), the rank (int32) and the singular values, from one
    SVD."""
    x, y = promote(ensure_tensor(x), ensure_tensor(y))

    def fn(a, b):
        vec = b.ndim == 1
        b2 = b[:, None] if vec else b
        m, n = a.shape[-2], a.shape[-1]
        u, s, vh = torch.linalg.svd(a, full_matrices=False)
        rc = (torch.finfo(a.dtype).eps * max(m, n) if rcond is None
              else rcond)
        mask = (s > 0) & (s >= rc * s[0]) if s.numel() else s > 0
        s_inv = torch.where(mask, 1 / torch.where(mask, s,
                                                  torch.ones_like(s)),
                            torch.zeros_like(s))
        sol = _t(vh) @ (s_inv[:, None] * (_t(u) @ b2))
        rank = mask.sum().to(torch.int32)
        resid = torch.sum(torch.square(b2 - a @ sol), dim=0)
        if vec:
            return sol[:, 0], resid[0], rank, s
        return sol, resid, rank, s
    return _wide(fn)(x, y)


def eig(x, name=None):
    w, v = torch.linalg.eig(ensure_tensor(x).float())
    return w, v


def eigvals(x, name=None):
    return torch.linalg.eigvals(ensure_tensor(x).float())


def eigh(x, UPLO="L", name=None):
    return _wide(lambda a: tuple(torch.linalg.eigh(a, UPLO=UPLO)))(
        ensure_tensor(x))


def eigvalsh(x, UPLO="L", name=None):
    return _wide(lambda a: torch.linalg.eigvalsh(a, UPLO=UPLO))(
        ensure_tensor(x))


def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(ensure_tensor(x), n)


def matrix_rank(x, tol=None, hermitian=False, atol=None, rtol=None,
                name=None):
    """``jnp.linalg.matrix_rank``: singular values above ``tol`` (default
    the largest times max(m, n) times the dtype's eps), as int32."""
    x = ensure_tensor(x)

    def fn(a):
        s = torch.linalg.svdvals(a)
        if tol is None:
            t = s.amax(-1, keepdim=True) * max(a.shape[-2:]) * \
                torch.finfo(a.dtype).eps
        else:
            t = torch.as_tensor(tol, dtype=s.dtype, device=s.device)
            t = t.unsqueeze(-1) if t.ndim else t
        return (s > t).sum(-1).to(torch.int32)
    return _wide(fn)(x)


def multi_dot(x, name=None):
    return torch.linalg.multi_dot(promote(*[ensure_tensor(t) for t in x]))


def corrcoef(x, rowvar=True, name=None):
    x = ensure_tensor(x)
    return _wide(torch.corrcoef)(x if rowvar or x.ndim < 2 else _t(x))


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    x = ensure_tensor(x)
    fw = None if fweights is None else ensure_tensor(fweights).to(
        torch.int64)
    aw = None if aweights is None else ensure_tensor(aweights)
    return _wide(lambda a: torch.cov(a, correction=1 if ddof else 0,
                                     fweights=fw, aweights=aw))(
        x if rowvar or x.ndim < 2 else _t(x))


def householder_product(x, tau, name=None):
    x, tau = promote(ensure_tensor(x), ensure_tensor(tau))
    return _wide(torch.linalg.householder_product)(x, tau)


def lu(x, pivot=True, get_infos=False, name=None):
    x = ensure_tensor(x)
    lu_mat, piv = _wide(lambda a: tuple(torch.linalg.lu_factor(a)))(x)
    outs = (lu_mat, piv.to(torch.int32))
    if get_infos:
        return outs + (torch.zeros((), dtype=torch.int32,
                                   device=x.device),)
    return outs


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    p, l, u = _wide(lambda a: tuple(torch.lu_unpack(a, y.to(torch.int32))))(
        x)
    return p, l, u


def einsum(equation, *operands):
    return torch.einsum(equation, *promote(*[ensure_tensor(o)
                                             for o in operands]))


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    if isinstance(axis, list):
        axis = tuple(axis)
    return torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=keepdim)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    return _wide(lambda a: torch.linalg.matrix_norm(
        a, ord=p, dim=tuple(axis), keepdim=keepdim))(ensure_tensor(x))


def cholesky_inverse(x, upper=False, name=None):
    x = ensure_tensor(x)
    a = _t(x) @ x if upper else x @ _t(x)
    return _wide(torch.linalg.inv)(a)


def matrix_exp(x, name=None):
    return _wide(torch.linalg.matrix_exp)(ensure_tensor(x))


def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    """The JAX package's randomized range finder: the same Gaussian test
    matrix (``RandomState(0)``), ``niter`` power steps, a QR and a small
    SVD."""
    x = ensure_tensor(x)
    if M is not None:
        x = x - ensure_tensor(M, x)
    m, n = int(x.shape[-2]), int(x.shape[-1])
    k = min(q, m, n)
    omega = torch.from_numpy(np.random.RandomState(0).randn(n, k)).to(
        dtype=x.dtype, device=x.device)

    def fn(a, om):
        y = a @ om
        for _ in range(niter):
            y = a @ (_t(a) @ y)
        Q, _ = torch.linalg.qr(y)
        u, s, vh = torch.linalg.svd(_t(Q) @ a, full_matrices=False)
        return Q @ u, s, _t(vh)
    return _wide(fn)(x, omega)


def ormqr(x, tau, y, left=True, transpose=False, name=None):
    q = householder_product(x, tau)
    q, y = promote(q, ensure_tensor(y))
    qq = _t(q) if transpose else q
    return qq @ y if left else y @ qq
