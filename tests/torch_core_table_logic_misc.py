"""The case table of ``test_torch_core_logic_misc.py`` (see
``torch_core_cases``): JAX-free, so that ``chip_smoke.py`` runs it on
the card."""

import numpy as np

from torch_core_cases import (Bo, Case, I, N, Raw, U, args, lst)  # noqa: F401

F32 = ("float32",)
S = (3, 4)


def with_ties(r):
    return r.integers(0, 3, S).astype(np.float32)


CASES = [Case(op, args(with_ties, with_ties), grad=False)
         for op in ("equal", "not_equal", "greater_than", "greater_equal",
                    "less_than", "less_equal")]
CASES += [
    Case("equal", args(with_ties, 1.0), grad=False, label="scalar"),
    Case("less_than", args(I(0, 3, *S), 1), grad=False, dtypes=F32,
         label="int"),
    Case("equal_all", args(with_ties, with_ties), grad=False),
    Case("equal_all", args(N(3), N(4)), grad=False, label="shapes"),
    Case("allclose", args(N(*S), lambda r: np.zeros(S, np.float32)),
         grad=False),
    Case("allclose", args(lambda r: np.ones(S, np.float32),
                          lambda r: np.ones(S, np.float32) + 1e-6),
         grad=False, dtypes=F32, label="close"),
    Case("isclose", args(N(*S), N(*S)), kwargs=dict(atol=0.5), grad=False),
    Case("is_empty", args(N(0, 3)), grad=False, dtypes=F32),
    Case("is_empty", args(N(2)), grad=False, dtypes=F32, label="full"),
    Case("argmax", args(N(*S)), grad=False),
    Case("argmax", args(N(*S)), kwargs=dict(axis=1, keepdim=True),
         grad=False, label="axis"),
    Case("argmin", args(N(*S)), kwargs=dict(axis=0), grad=False),
    Case("argmin", args(N(*S)), kwargs=dict(dtype="int32"), grad=False,
         label="dtype"),
    Case("topk", args(N(3, 6), 2)),
    Case("topk", args(N(3, 6), 2), kwargs=dict(axis=0, largest=False),
         label="smallest"),
    Case("kthvalue", args(N(3, 6), 2)),
    Case("kthvalue", args(N(4, 3), 3), kwargs=dict(axis=0, keepdim=True),
         label="axis"),
    Case("mode", args(I(0, 3, 4, 6)), grad=False, dtypes=F32),
    Case("mode", args(lambda r: r.integers(0, 3, (4, 6)).astype(
        np.float32)), kwargs=dict(axis=0, keepdim=True), grad=False,
        label="axis"),
    Case("searchsorted", args(lambda r: np.sort(r.standard_normal(6))
                              .astype(np.float32), N(3, 2)), grad=False),
    Case("searchsorted", args(lambda r: np.sort(r.standard_normal(
        (2, 6)), -1).astype(np.float32), N(2, 3)), kwargs=dict(right=True),
        grad=False, label="batched right"),
    Case("bucketize", args(N(5), lambda r: np.sort(r.standard_normal(4))
                           .astype(np.float32)), grad=False),
    Case("index_fill", args(N(4, 3), lambda r: np.array([0, 2], np.int32),
                            0, 1.5)),
    Case("index_fill", args(N(4, 3), lambda r: np.array([1], np.int32), 1,
                            -1.0), label="axis1"),
    Case("masked_scatter", args(N(*S), Bo(*S), N(12)), grad=False),
    Case("masked_scatter", args(N(*S), Bo(1, 4), N(12)), grad=False,
         label="broadcast"),
    # misc
    Case("rank", args(N(2, 3, 4)), grad=False, dtypes=F32),
    Case("shape", args(N(2, 3, 4)), grad=False, dtypes=F32),
    Case("add_n", args(lst(N(*S), N(*S), N(*S)))),
    Case("reverse", args(N(*S), 1)),
    Case("reverse", args(N(2, 3, 4), Raw([0, 2])), label="axes"),
    Case("histogram_bin_edges", args(N(20)), kwargs=dict(bins=5),
         grad=False),
    Case("histogram_bin_edges", args(N(20)), kwargs=dict(bins=4, min=-1,
                                                         max=1),
         grad=False, label="range"),
    Case("is_complex", args(N(2)), grad=False),
    Case("is_integer", args(I(0, 2, 2)), grad=False, dtypes=F32),
    Case("is_integer", args(N(2)), grad=False, label="float"),
    Case("is_floating_point", args(N(2)), grad=False),
    Case("is_floating_point", args(Bo(2)), grad=False, dtypes=F32,
         label="bool"),
    Case("check_shape", args(N(2, 3)), grad=False),
    Case("reduce_as", args(N(2, 3, 4), N(3, 1))),
    Case("reduce_as", args(N(3, 4), N(1, 4)), label="keep"),
    Case("as_strided", args(N(12), Raw([3, 3]), Raw([2, 1]))),
    Case("as_strided", args(N(3, 4), Raw([2, 2]), Raw([1, 4])),
         kwargs=dict(offset=1), label="offset"),
    Case("diagonal_scatter", args(N(4, 4), N(4))),
    Case("diagonal_scatter", args(N(3, 4), N(3)), kwargs=dict(offset=1),
         label="offset"),
]


