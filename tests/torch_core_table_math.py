"""The case table of ``test_torch_core_math.py`` (see
``torch_core_cases``): JAX-free, so that ``chip_smoke.py`` runs it on
the card."""

import numpy as np

from torch_core_cases import (Bo, Case, I, N, Raw, U, args, lst)  # noqa: F401

S = (3, 4)
F32 = ("float32",)
# the JAX package rounds each partial sum of a bfloat16 scan to bfloat16;
# torch sums in float32, so a long run of partial sums drifts apart by a
# few bfloat16 steps of the running sum's magnitude
SCAN_BF16 = {"bfloat16": dict(rtol=1e-2, atol=3e-2)}

UNARY = {
    "abs": U(-2, 2, *S), "acos": U(-0.9, 0.9, *S), "acosh": U(1.2, 3, *S),
    "asin": U(-0.9, 0.9, *S), "asinh": N(*S), "atan": N(*S),
    "atanh": U(-0.9, 0.9, *S), "ceil": U(-3, 3, *S), "cos": N(*S),
    "cosh": N(*S), "digamma": U(0.5, 3, *S), "erf": N(*S),
    "erfinv": U(-0.9, 0.9, *S), "exp": N(*S), "expm1": N(*S),
    "floor": U(-3, 3, *S), "lgamma": U(0.5, 3, *S), "log": U(0.5, 3, *S),
    "log2": U(0.5, 3, *S), "log10": U(0.5, 3, *S), "log1p": U(0, 3, *S),
    "neg": N(*S), "reciprocal": U(0.5, 2, *S), "round": U(-3, 3, *S),
    "rsqrt": U(0.5, 3, *S), "sigmoid": N(*S), "sign": N(*S),
    "sin": N(*S), "sinh": N(*S), "sqrt": U(0.5, 3, *S), "square": N(*S),
    "tan": U(-1, 1, *S), "tanh": N(*S), "trunc": U(-3, 3, *S),
    "frac": U(-3, 3, *S), "angle": N(*S), "conj": N(*S),
    "i0": N(*S), "i0e": N(*S), "i1": N(*S), "i1e": N(*S),
    "logit": U(0.1, 0.9, *S), "deg2rad": N(*S), "rad2deg": N(*S),
}
NONDIFF_UNARY = {"isnan": N(*S), "isinf": N(*S), "isfinite": N(*S),
                 "logical_not": N(*S)}
BINARY = {
    "add": (N(*S), N(*S)), "subtract": (N(*S), N(*S)),
    "multiply": (N(*S), N(*S)), "divide": (N(*S), U(0.5, 2, *S)),
    "remainder": (U(-3, 3, *S), U(0.5, 2, *S)),
    "mod": (U(-3, 3, *S), U(0.5, 2, *S)),
    "floor_mod": (U(-3, 3, *S), U(0.5, 2, *S)),
    "pow_op": (U(0.5, 2, *S), U(-1, 2, *S)),
    "maximum": (N(*S), N(*S)), "minimum": (N(*S), N(*S)),
    "fmax": (N(*S), N(*S)), "fmin": (N(*S), N(*S)),
    "atan2": (N(*S), N(*S)), "logaddexp": (N(*S), N(*S)),
    "hypot": (N(*S), N(*S)), "copysign": (N(*S), N(*S)),
    "ldexp": (N(*S), I(-2, 3, *S)),
}
NONDIFF_BINARY = {
    "floor_divide": (U(-3, 3, *S), U(0.5, 2, *S)),
    "heaviside": (N(*S), N(*S)), "nextafter": (N(*S), N(*S)),
    "logical_and": (N(*S), N(*S)), "logical_or": (N(*S), N(*S)),
    "logical_xor": (N(*S), N(*S)),
}
INT_BINARY = {
    "gcd": (I(1, 30, *S), I(1, 30, *S)), "lcm": (I(1, 12, *S), I(1, 12, *S)),
    "bitwise_and": (I(0, 64, *S), I(0, 64, *S)),
    "bitwise_or": (I(0, 64, *S), I(0, 64, *S)),
    "bitwise_xor": (I(0, 64, *S), I(0, 64, *S)),
    "floor_divide": (I(-20, 20, *S), I(1, 6, *S)),
    "remainder": (I(-20, 20, *S), I(1, 6, *S)),
    "add": (I(-20, 20, *S), I(-20, 20, *S)),
    "divide": (I(-20, 20, *S), I(1, 6, *S)),
}

CASES = []
CASES += [Case(op, args(m)) for op, m in UNARY.items()]
CASES += [Case(op, args(m), grad=False) for op, m in NONDIFF_UNARY.items()]
CASES += [Case(op, args(*m)) for op, m in BINARY.items()]
CASES += [Case(op, args(*m), grad=False) for op, m in NONDIFF_BINARY.items()]
CASES += [Case(op, args(*m), dtypes=F32, grad=False, label="int")
          for op, m in INT_BINARY.items()]
CASES += [
    # integer inputs to float functions give the default float dtype
    Case("sqrt", args(I(1, 9, *S)), dtypes=F32, grad=False, label="int"),
    Case("exp", args(I(-3, 3, *S)), dtypes=F32, grad=False, label="int"),
    Case("abs", args(I(-9, 9, *S)), dtypes=F32, grad=False, label="int"),
    Case("bitwise_not", args(I(-9, 9, *S)), dtypes=F32, grad=False),
    Case("bitwise_not", args(Bo(*S)), dtypes=F32, grad=False,
         label="bool"),
    # a Python scalar takes the tensor's dtype
    Case("add", args(N(*S), 2.5), label="scalar"),
    Case("multiply", args(3, N(*S)), label="scalar first"),
    Case("add", args(I(-9, 9, *S), 2.5), dtypes=F32, grad=False,
         label="int + float scalar"),
    Case("subtract", args(N(2, 3, 4), N(3, 1)), label="broadcast"),
    Case("polygamma_n", args(U(0.5, 3, *S), lambda r: np.ones(
        S, np.int32)), grad_args=(0,)),
    Case("pow", args(N(*S), 3), label="int exponent"),
    Case("pow", args(U(0.5, 2, *S), 0.5), label="float exponent"),
    Case("pow", args(U(0.5, 2, *S), U(0.5, 2, *S)), label="tensor"),
    Case("divide_no_nan", args(N(*S), lambda r: np.where(
        r.random(S) < 0.3, 0, r.uniform(0.5, 2, S)).astype(np.float32))),
    Case("scale", args(N(*S)), kwargs=dict(scale=2.0, bias=0.5)),
    Case("scale", args(N(*S)), kwargs=dict(scale=2.0, bias=0.5,
                                           bias_after_scale=False),
         label="bias first"),
    Case("clip", args(N(*S)), kwargs=dict(min=-0.5, max=0.5)),
    Case("clip", args(N(*S)), kwargs=dict(min=-0.5), label="min only"),
    Case("lerp", args(N(*S), N(*S), 0.3)),
    Case("lerp", args(N(*S), N(*S), U(0, 1, *S)), label="tensor weight"),
    Case("nan_to_num", args(lambda r: np.array(
        [np.nan, np.inf, -np.inf, 1.5], np.float32)),
        kwargs=dict(nan=1.0, posinf=9.0, neginf=-9.0), grad=False),
    Case("stanh", args(N(*S))),
    Case("multiplex", args(lst(N(*S), N(*S), N(*S)),
                           lambda r: r.integers(0, 3, (3, 1)).astype(
                               np.int32))),
]

REDUCE_IN = N(2, 3, 4)
for op in ("sum", "mean", "prod", "max", "min", "amax", "amin", "nansum",
           "nanmean", "logsumexp"):
    for label, kw in (("all", {}), ("axis1", dict(axis=1)),
                      ("axes keep", dict(axis=[0, 2], keepdim=True)),
                      ("neg axis", dict(axis=-1))):
        CASES.append(Case(op, args(REDUCE_IN), kwargs=kw, label=label))
for op in ("all", "any"):
    CASES.append(Case(op, args(Bo(2, 3, 4)), grad=False, dtypes=F32))
    CASES.append(Case(op, args(Bo(2, 3, 4)), kwargs=dict(axis=1),
                      grad=False, dtypes=F32, label="axis"))
CASES += [
    Case("sum", args(I(-9, 9, 2, 3)), dtypes=F32, grad=False, label="int"),
    Case("sum", args(Bo(2, 3)), dtypes=F32, grad=False, label="bool"),
    Case("prod", args(I(1, 4, 2, 3)), kwargs=dict(axis=1), dtypes=F32,
         grad=False, label="int"),
    Case("mean", args(I(-9, 9, 2, 3)), dtypes=F32, grad=False,
         label="int"),
    Case("sum", args(N(2, 3)), kwargs=dict(dtype="float32"),
         label="dtype"),
    Case("count_nonzero", args(lambda r: (r.random((3, 4)) < 0.5).astype(
        np.float32)), grad=False),
    Case("count_nonzero", args(I(-1, 2, 3, 4)), kwargs=dict(
        axis=1, keepdim=True), grad=False, dtypes=F32, label="axis"),
    Case("var", args(N(3, 5))),
    Case("var", args(N(3, 5)), kwargs=dict(axis=1, unbiased=False),
         label="axis biased"),
    Case("std", args(N(3, 5))),
    Case("std", args(N(3, 5)), kwargs=dict(axis=0, keepdim=True),
         label="axis"),
    Case("median", args(N(3, 5))),
    Case("median", args(N(3, 4)), kwargs=dict(axis=1), label="even"),
    Case("median", args(N(3, 5)), kwargs=dict(axis=0, keepdim=True),
         label="keep"),
    Case("quantile", args(N(3, 5), 0.3)),
    Case("quantile", args(N(3, 5), [0.2, 0.7]), kwargs=dict(axis=1),
         label="vector q"),
    Case("quantile", args(N(4, 5), 0.4), kwargs=dict(
        axis=[0, 1], keepdim=True), label="axes keep"),
    Case("quantile", args(N(3, 5), 0.3), kwargs=dict(
        axis=1, interpolation="lower"), label="lower"),
    Case("quantile", args(N(3, 5), 0.3), kwargs=dict(
        axis=1, interpolation="higher"), label="higher"),
    Case("quantile", args(N(3, 5), 0.3), kwargs=dict(
        axis=1, interpolation="nearest"), label="nearest"),
    Case("quantile", args(N(3, 5), 0.3), kwargs=dict(
        axis=1, interpolation="midpoint"), label="midpoint"),
    Case("cumsum", args(N(3, 4)), tol=SCAN_BF16),
    Case("cumsum", args(N(3, 4)), kwargs=dict(axis=1), label="axis",
         tol=SCAN_BF16),
    Case("cumsum", args(I(-5, 5, 3, 4)), kwargs=dict(axis=0), dtypes=F32,
         grad=False, label="int"),
    Case("cumprod", args(U(0.5, 1.5, 3, 4)), kwargs=dict(dim=1),
         tol=SCAN_BF16),
    Case("cumprod", args(U(0.5, 1.5, 3, 4)), label="flat", tol=SCAN_BF16),
    Case("cummax", args(N(3, 5)), kwargs=dict(axis=1)),
    Case("cummax", args(N(3, 5)), label="flat"),
    Case("cummin", args(N(3, 5)), kwargs=dict(axis=0)),
    Case("logcumsumexp", args(N(3, 4)), kwargs=dict(axis=1), tol=SCAN_BF16),
    Case("logcumsumexp", args(N(3, 4)), label="flat", tol=SCAN_BF16),
    Case("diff", args(N(3, 5))),
    Case("diff", args(N(3, 5)), kwargs=dict(n=2, axis=0), label="n2"),
    Case("diff", args(N(3, 5)), kwargs=dict(prepend=np.zeros(
        (3, 1), np.float32), append=np.ones((3, 2), np.float32)),
        label="pre/append"),
    Case("trace", args(N(4, 4))),
    Case("trace", args(N(2, 4, 5)), kwargs=dict(offset=1, axis1=1,
                                                axis2=2), label="batch"),
    Case("trace", args(I(-5, 5, 3, 3)), dtypes=F32, grad=False,
         label="int"),
    Case("kron", args(N(2, 3), N(3, 2))),
    Case("cross", args(N(4, 3), N(4, 3))),
    Case("cross", args(N(3, 5), N(3, 5)), kwargs=dict(axis=0),
         label="axis"),
    Case("inner", args(N(3, 4), N(2, 4))),
    Case("outer", args(N(3), N(4))),
    Case("addmm", args(N(3, 5), N(3, 4), N(4, 5)), kwargs=dict(
        beta=0.5, alpha=2.0)),
    Case("addmm", args(N(5), N(3, 4), N(4, 5)), label="broadcast"),
    Case("renorm", args(N(3, 4), 2.0, 0, 1.0)),
    Case("histogram", args(N(20)), kwargs=dict(bins=5), grad=False),
    Case("histogram", args(N(20)), kwargs=dict(bins=4, min=-1, max=1),
         grad=False, label="range"),
    Case("bincount", args(I(0, 6, 12)), grad=False, dtypes=F32),
    Case("bincount", args(I(0, 6, 12)), kwargs=dict(minlength=9),
         grad=False, dtypes=F32, label="minlength"),
    Case("bincount", args(I(0, 6, 12), N(12)), grad=False, dtypes=F32,
         label="weights"),
    Case("broadcast_shape", args(Raw([2, 1, 4]), Raw([3, 1])),
         grad=False, dtypes=F32),
]


