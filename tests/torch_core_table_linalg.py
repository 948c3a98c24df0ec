"""The case table of ``test_torch_core_linalg.py`` (see
``torch_core_cases``): JAX-free, so that ``chip_smoke.py`` runs it on
the card."""

import numpy as np

from torch_core_cases import (Bo, Case, I, N, Raw, U, args, lst)  # noqa: F401

F32 = ("float32",)
# decompositions and solves: the JAX package's float32 path (XLA) and
# LAPACK's order their sums differently, so results of conditioned
# problems agree to a few float32 steps of their magnitude
DECOMP = {"float32": dict(rtol=1e-4, atol=1e-4)}
# ormqr materializes Q as a product of Householder reflections: in
# bfloat16 each factor rounds, in another order in each package
ORMQR = {**DECOMP, "bfloat16": dict(rtol=2e-2, atol=5e-2)}


def spd(n):
    def make(r):
        m = r.standard_normal((n, n)).astype(np.float32)
        return (m @ m.T + n * np.eye(n)).astype(np.float32)
    return make


def well(n, batch=()):
    def make(r):
        m = r.standard_normal((*batch, n, n)).astype(np.float32)
        return (m + n * np.eye(n)).astype(np.float32)
    return make


def lower(n):
    def make(r):
        return np.tril(well(n)(r)).astype(np.float32)
    return make


def recon_qr(out, xp):
    q, r = out
    return xp.matmul(q, r), xp.abs(r)


def recon_svd(out, xp):
    u, s, vh = out
    return s, xp.matmul(u * s.unsqueeze(-2) if hasattr(s, "unsqueeze")
                        else u * s, vh)


def recon_svd_j(out, xp):
    u, s, vh = out
    return s, xp.matmul(xp.multiply(u, xp.unsqueeze(s, -2)), vh)


def recon_eigh(out, xp):
    w, v = out
    return w, xp.abs(v)


def recon_lowrank(out, xp):
    u, s, v = out
    return s, xp.abs(u), xp.abs(v)


CASES = [
    Case("matmul", args(N(3, 4), N(4, 5))),
    Case("matmul", args(N(2, 3, 4), N(2, 4, 5)), label="batched"),
    Case("matmul", args(N(4, 3), N(5, 4)), kwargs=dict(
        transpose_x=True, transpose_y=True), label="transposed"),
    Case("matmul", args(N(3, 4), N(4)), label="vector"),
    Case("mm", args(N(3, 4), N(4, 5))),
    Case("bmm", args(N(2, 3, 4), N(2, 4, 5))),
    Case("mv", args(N(3, 4), N(4))),
    Case("dot", args(N(4), N(4))),
    Case("dot", args(N(3, 4), N(3, 4)), label="rows"),
    Case("norm", args(N(3, 4))),
    Case("norm", args(N(3, 4)), kwargs=dict(p=1, axis=1), label="p1"),
    Case("norm", args(N(3, 4)), kwargs=dict(p=float("inf"), axis=0,
                                            keepdim=True), label="inf"),
    Case("norm", args(N(3, 4)), kwargs=dict(p="fro", axis=[0, 1]),
         label="fro axes"),
    Case("norm", args(N(3, 4)), kwargs=dict(p=3, axis=1), label="p3"),
    Case("dist", args(N(3, 4), N(3, 4))),
    Case("dist", args(N(3, 4), N(3, 4)), kwargs=dict(p=1), label="p1"),
    Case("dist", args(N(3, 4), N(3, 4)), kwargs=dict(p=float("inf")),
         label="inf"),
    Case("cond", args(well(4)), dtypes=F32, tol=DECOMP),
    Case("cholesky", args(spd(4)), dtypes=F32, tol=DECOMP),
    Case("cholesky", args(spd(4)), kwargs=dict(upper=True), dtypes=F32,
         tol=DECOMP, label="upper"),
    Case("cholesky_solve", args(N(4, 2), lower(4)), tol=DECOMP),
    Case("qr", args(N(5, 3)), post=recon_qr, dtypes=F32, tol=DECOMP),
    # the JAX package does not differentiate a complete QR of a tall matrix
    Case("qr", args(N(5, 3)), kwargs=dict(mode="complete"), post=recon_qr,
         dtypes=F32, tol=DECOMP, grad=False, label="complete"),
    Case("svd", args(N(4, 3)), post=recon_svd_j, dtypes=F32, tol=DECOMP),
    Case("pca_lowrank", args(N(6, 4)), kwargs=dict(q=2),
         post=recon_lowrank, dtypes=F32, tol=DECOMP, grad=False),
    Case("inv", args(well(4)), dtypes=F32, tol=DECOMP),
    Case("pinv", args(N(4, 3)), dtypes=F32, tol=DECOMP),
    Case("det", args(well(3)), tol=DECOMP),
    Case("slogdet", args(well(3)), dtypes=F32, tol=DECOMP),
    Case("solve", args(well(4), N(4, 2)), dtypes=F32, tol=DECOMP),
    Case("solve", args(well(4), N(4)), dtypes=F32, tol=DECOMP,
         label="vector"),
    Case("triangular_solve", args(lambda r: np.triu(well(4)(r)), N(4, 2)),
         tol=DECOMP),
    Case("triangular_solve", args(lower(4), N(4, 2)), kwargs=dict(
        upper=False, transpose=True), tol=DECOMP,
        label="lower T"),
    Case("triangular_solve", args(lambda r: np.triu(well(4)(r)), N(4, 2)),
         kwargs=dict(unitriangular=True), tol=DECOMP,
         label="unit"),
    Case("lstsq", args(N(6, 3), N(6, 2)), dtypes=F32, tol=DECOMP,
         grad=False),
    Case("lstsq", args(N(3, 5), N(3, 2)), dtypes=F32, tol=DECOMP,
         grad=False, label="underdetermined"),
    Case("eigh", args(spd(4)), post=recon_eigh, dtypes=F32, tol=DECOMP),
    Case("eigvalsh", args(spd(4)), dtypes=F32, tol=DECOMP),
    Case("eig", args(spd(3)), post=lambda o, xp: (xp.real(o[0]),
                                                  xp.abs(o[1])),
         grad=False, tol=DECOMP),
    Case("eigvals", args(spd(3)), post=lambda o, xp: xp.real(o),
         grad=False, tol=DECOMP),
    Case("matrix_power", args(N(3, 3), 3)),
    Case("matrix_power", args(well(3), -2), dtypes=F32, tol=DECOMP,
         label="inverse"),
    Case("matrix_rank", args(lambda r: (r.standard_normal((5, 2)) @
                                        r.standard_normal((2, 4))).astype(
        np.float32)), dtypes=F32, grad=False),
    Case("multi_dot", args(lst(N(3, 4), N(4, 5), N(5, 2)))),
    Case("corrcoef", args(N(3, 6)), tol=DECOMP),
    Case("corrcoef", args(N(6, 3)), kwargs=dict(rowvar=False),
         tol=DECOMP, label="columns"),
    Case("cov", args(N(3, 6))),
    Case("cov", args(N(6, 3)), kwargs=dict(rowvar=False, ddof=False),
         label="columns biased"),
    Case("cov", args(N(3, 6)), kwargs=dict(
        fweights=np.array([1, 2, 1, 3, 1, 1], np.int32),
        aweights=np.array([0.5, 1, 1, 2, 1, 0.5], np.float32)),
        label="weights"),
    Case("householder_product", args(N(4, 3), U(0.5, 1.5, 3)),
         tol=DECOMP),
    Case("lu", args(well(4)), dtypes=F32, tol=DECOMP, grad=False),
    Case("lu", args(well(4)), kwargs=dict(get_infos=True), dtypes=F32,
         tol=DECOMP, grad=False, label="infos"),
    Case("einsum", args("ij,jk->ik", N(3, 4), N(4, 5))),
    Case("einsum", args("bij,bjk->bik", N(2, 3, 4), N(2, 4, 5)),
         label="batched"),
    Case("einsum", args("ii->", N(4, 4)), label="trace"),
    Case("vector_norm", args(N(3, 4))),
    Case("vector_norm", args(N(3, 4)), kwargs=dict(p=1.0, axis=1,
                                                   keepdim=True),
         label="p1"),
    Case("vector_norm", args(N(3, 4)), kwargs=dict(keepdim=True),
         label="keep"),
    Case("matrix_norm", args(N(3, 4))),
    Case("matrix_norm", args(N(2, 3, 4)), kwargs=dict(p=1),
         label="p1"),
    Case("cholesky_inverse", args(lower(3)), dtypes=F32, tol=DECOMP),
    Case("cholesky_inverse", args(lambda r: np.triu(well(3)(r))),
         kwargs=dict(upper=True), dtypes=F32, tol=DECOMP, label="upper"),
    Case("matrix_exp", args(lambda r: 0.3 * r.standard_normal(
        (3, 3)).astype(np.float32)), dtypes=F32, tol=DECOMP),
    Case("svd_lowrank", args(N(6, 5)), kwargs=dict(q=3),
         post=recon_lowrank, dtypes=F32, tol=DECOMP, grad=False),
    Case("ormqr", args(N(4, 4), U(0.5, 1.5, 4), N(4, 2)),
         tol=ORMQR),
    Case("ormqr", args(N(4, 4), U(0.5, 1.5, 4), N(2, 4)), kwargs=dict(
        left=False, transpose=True), tol=ORMQR,
        label="right T"),
]


