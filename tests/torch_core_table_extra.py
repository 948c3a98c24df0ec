"""The case table of ``test_torch_core_extra.py`` (see
``torch_core_cases``): JAX-free, so that ``chip_smoke.py`` runs it on
the card."""

import numpy as np

from torch_core_cases import (Bo, Case, I, N, Raw, U, args, lst)  # noqa: F401

F32 = ("float32",)
S = (3, 4)
# a scan over bfloat16 values: the JAX package rounds each partial sum
SCAN_BF16 = {"bfloat16": dict(rtol=1e-2, atol=3e-2)}
# functions the JAX package composes from several bfloat16 ops (each
# rounding) where torch's backward is one float32 kernel: a few bfloat16
# steps apart
COMPOSED_BF16 = {"bfloat16": dict(rtol=3e-2, atol=2e-2)}
# log-gamma at its zeros (x near 1 and 2): the two packages' series agree
# to a few float32 steps of 1, not of the value
LGAMMA = {"float32": dict(rtol=1e-5, atol=5e-6)}


def special(r):
    return np.array([[-np.inf, -1.0, 0.0, np.inf],
                     [np.nan, -0.0, 2.0, -3.0],
                     [1.0, -2.0, np.inf, 0.5]], np.float32)


CASES = [
    Case("positive", args(N(*S))),
    Case("negative", args(N(*S))),
    Case("signbit", args(lambda r: np.nan_to_num(special(r), nan=-5.0)),
         grad=False),
    Case("isneginf", args(special), grad=False),
    Case("isposinf", args(special), grad=False),
    Case("isreal", args(N(*S)), grad=False),
    Case("float_power", args(U(0.5, 2, *S), U(-1, 2, *S))),
    Case("float_power", args(I(1, 4, *S), 2), dtypes=F32, grad=False,
         label="int"),
    Case("logaddexp2", args(N(*S), N(*S))),
    Case("sinc", args(N(*S)), tol=COMPOSED_BF16),
    Case("xlogy", args(N(*S), U(0.5, 2, *S))),
    Case("exp2", args(N(*S))),
    Case("sgn", args(N(*S))),
    Case("fix", args(U(-3, 3, *S))),
    Case("fmod", args(U(-3, 3, *S), U(0.5, 2, *S))),
    Case("frexp", args(U(-9, 9, *S)), grad=False),
    Case("polygamma", args(U(0.5, 3, *S), 2)),
    Case("gammaln", args(U(0.5, 3, *S)), tol=LGAMMA),
    Case("multigammaln", args(U(2, 4, *S), 3)),
    Case("gammainc", args(U(0.5, 3, *S), U(0.5, 3, *S)), grad_args=(1,)),
    Case("gammaincc", args(U(0.5, 3, *S), U(0.5, 3, *S)), grad_args=(1,)),
    Case("bitwise_left_shift", args(I(-50, 50, *S), I(0, 5, *S)),
         grad=False, dtypes=F32),
    Case("bitwise_right_shift", args(I(-50, 50, *S), I(0, 5, *S)),
         grad=False, dtypes=F32),
    Case("bitwise_right_shift", args(I(-50, 50, *S), I(0, 5, *S)),
         kwargs=dict(is_arithmetic=False), grad=False, dtypes=F32,
         label="logical"),
    Case("addcdiv", args(N(*S), N(*S), U(0.5, 2, *S)),
         kwargs=dict(value=0.5)),
    Case("addcmul", args(N(*S), N(*S), N(*S)), kwargs=dict(value=2.0)),
    Case("nanmedian", args(lambda r: np.where(
        r.random((3, 5)) < 0.3, np.nan, r.standard_normal((3, 5))).astype(
        np.float32)), kwargs=dict(axis=1)),
    Case("nanmedian", args(N(3, 4)), label="flat"),
    Case("nanquantile", args(lambda r: np.where(
        r.random((3, 5)) < 0.3, np.nan, r.standard_normal((3, 5))).astype(
        np.float32), 0.3), kwargs=dict(axis=1)),
    Case("aminmax", args(N(3, 5))),
    Case("aminmax", args(N(3, 5)), kwargs=dict(axis=1, keepdim=True),
         label="axis"),
    Case("trapezoid", args(N(3, 5))),
    Case("trapezoid", args(N(3, 5)), kwargs=dict(dx=0.5, axis=0),
         label="dx"),
    Case("trapezoid", args(N(3, 5)), kwargs=dict(
        x=np.cumsum(np.ones(5, np.float32))), label="x"),
    Case("cumulative_trapezoid", args(N(3, 5)), tol=SCAN_BF16),
    Case("cumulative_trapezoid", args(N(3, 5)), kwargs=dict(
        dx=0.5, axis=0), label="dx", tol=SCAN_BF16),
    Case("histogramdd", args(N(10, 2)), kwargs=dict(bins=3), grad=False,
         dtypes=F32),
    Case("take", args(N(3, 4), I(-12, 12, 5))),
    Case("take", args(N(3, 4), I(-20, 20, 5)), kwargs=dict(mode="wrap"),
         label="wrap"),
    Case("take", args(N(3, 4), I(-20, 20, 5)), kwargs=dict(mode="clip"),
         label="clip"),
    Case("diagonal", args(N(4, 5))),
    Case("diagonal", args(N(2, 4, 5)), kwargs=dict(offset=-1, axis1=1,
                                                   axis2=2), label="batch"),
    Case("isin", args(I(0, 9, *S), I(0, 9, 5)), grad=False, dtypes=F32),
    Case("isin", args(I(0, 9, *S), I(0, 9, 5)), kwargs=dict(invert=True),
         grad=False, dtypes=F32, label="invert"),
    Case("slice_scatter", args(N(4, 6), N(2, 3), Raw([0, 1]), Raw([0, 0]),
                               Raw([4, 6]), Raw([2, 2]))),
    Case("select_scatter", args(N(3, 4), N(4), 0, 1)),
    Case("vander", args(N(4))),
    Case("vander", args(N(3)), kwargs=dict(n=4, increasing=True),
         label="increasing"),
    Case("cartesian_prod", args(lst(N(2), N(3)))),
    Case("cartesian_prod", args(lst(N(3))), label="one"),
    Case("combinations", args(N(4))),
    # the gradient sums each element's copies (up to 6) in bfloat16, in
    # another order on the card than on the CPU
    Case("combinations", args(N(4)), kwargs=dict(r=3,
                                                 with_replacement=True),
         label="replacement",
         tol={"bfloat16": dict(rtol=2e-2, atol=5e-2)}),
    Case("column_stack", args(lst(N(3), N(3, 2)))),
    Case("row_stack", args(lst(N(2, 3), N(3)))),
    Case("hstack", args(lst(N(2, 3), N(2, 2)))),
    Case("vstack", args(lst(N(2, 3), N(1, 3)))),
    Case("dstack", args(lst(N(2, 3), N(2, 3)))),
    Case("tensor_split", args(N(7, 2), 3)),
    Case("tensor_split", args(N(7, 2), Raw([2, 5])), label="indices"),
    Case("hsplit", args(N(2, 6), 3)),
    Case("vsplit", args(N(4, 3), 2)),
    Case("dsplit", args(N(2, 2, 4), Raw([1, 3]))),
    Case("block_diag", args(lst(N(2, 2), N(1, 3)))),
    Case("unflatten", args(N(2, 12), 1, Raw([3, -1]))),
    Case("unflatten", args(N(12, 2), -2, Raw([2, 6])), label="neg axis"),
    Case("flipud", args(N(*S))),
    Case("fliplr", args(N(*S))),
    Case("baddbmm", args(N(2, 3, 5), N(2, 3, 4), N(2, 4, 5)),
         kwargs=dict(beta=0.5, alpha=2.0)),
    Case("vecdot", args(N(*S), N(*S))),
    Case("vecdot", args(N(*S), N(*S)), kwargs=dict(axis=0), label="axis"),
    Case("vdot", args(N(*S), N(*S))),
    Case("cdist", args(N(3, 4), N(5, 4)), tol=COMPOSED_BF16),
    Case("cdist", args(N(3, 4), N(5, 4)), kwargs=dict(p=1.0), label="p1"),
    Case("pdist", args(N(4, 3))),
    Case("clip_by_norm", args(N(*S), 1.0)),
    Case("clip_by_norm", args(N(*S), 100.0), label="inside"),
    Case("real", args(N(*S))),
    Case("imag", args(N(*S))),
]


