"""The case table of ``test_torch_core_creation.py`` (see
``torch_core_cases``): JAX-free, so that ``chip_smoke.py`` runs it on
the card."""

import numpy as np

from torch_core_cases import (Bo, Case, I, N, Raw, U, args, lst)  # noqa: F401

F32 = ("float32",)


def made(op, *a, label="", **kw):
    """A case of an op with no tensor input, once per dtype request."""
    return [Case(op, args(*[Raw(x) for x in a]), kwargs=kw, dtypes=F32,
                 grad=False, label=label or "default"),
            Case(op, args(*[Raw(x) for x in a]),
                 kwargs={**kw, "dtype": "bfloat16"}, dtypes=F32,
                 grad=False, label=(label + " " if label else "") + "bf16")]


CASES = []
CASES += made("zeros", [2, 3])
CASES += made("ones", (4,))
CASES += made("full", [2, 2], 1.5)
CASES += made("eye", 3, 4)
CASES += made("linspace", 0.0, 1.0, 5)
CASES += made("logspace", 0.0, 2.0, 4)
CASES += made("arange", 0.0, 2.0, 0.25)
CASES += [
    Case("full", args(Raw([2]), Raw(3)), grad=False, dtypes=F32,
         label="int fill"),
    Case("full", args(Raw([2]), Raw(True)), grad=False, dtypes=F32,
         label="bool fill"),
    Case("full", args(Raw([2]), Raw(7)), kwargs=dict(dtype="int64"),
         grad=False, dtypes=F32, label="int64 is int32"),
    Case("arange", args(Raw(5)), grad=False, dtypes=F32, label="int"),
    Case("arange", args(Raw(2), Raw(11), Raw(3)), grad=False, dtypes=F32,
         label="int step"),
    Case("zeros", args(Raw([2])), kwargs=dict(dtype="float64"),
         grad=False, dtypes=F32, label="float64 is float32"),
    Case("eye", args(Raw(3)), kwargs=dict(dtype="int32"), grad=False,
         dtypes=F32, label="int"),
    Case("zeros_like", args(N(2, 3))),
    Case("zeros_like", args(N(2, 3)), kwargs=dict(dtype="int32"),
         grad=False, label="dtype"),
    Case("ones_like", args(N(2, 3))),
    Case("full_like", args(N(2, 3), 2.5)),
    Case("full_like", args(I(0, 5, 2, 3), 4), grad=False, dtypes=F32,
         label="int"),
    Case("meshgrid", args(N(3), N(4))),
    Case("meshgrid", args(lst(N(2), N(3), N(2))), label="list"),
    Case("diag", args(N(3))),
    Case("diag", args(N(3)), kwargs=dict(offset=1, padding_value=2.0),
         label="padding"),
    Case("diag", args(N(3, 4)), kwargs=dict(offset=-1), label="2-D"),
    Case("diagflat", args(N(2, 2))),
    Case("diagflat", args(N(3)), kwargs=dict(offset=-1), label="offset"),
    Case("diag_embed", args(N(2, 3))),
    Case("diag_embed", args(N(2, 3)), kwargs=dict(offset=1, dim1=0,
                                                  dim2=2), label="dims"),
    Case("tril", args(N(4, 5))),
    Case("tril", args(N(4, 5)), kwargs=dict(diagonal=-1), label="-1"),
    Case("triu", args(N(2, 4, 5)), kwargs=dict(diagonal=1)),
    Case("tril_indices", args(Raw(4), Raw(5), Raw(1)), grad=False,
         dtypes=F32),
    Case("triu_indices", args(Raw(4)), grad=False, dtypes=F32),
    Case("assign", args(N(2, 3))),
    Case("clone", args(N(2, 3))),
    Case("complex", args(N(3), N(3)), dtypes=F32),
    Case("polar", args(U(0.5, 2, 3), N(3)), dtypes=F32),
    Case("to_tensor", args(N(2, 3)), grad=False),
    Case("as_tensor", args(N(2, 3)), grad=False),
    Case("as_tensor", args(Raw([[1.0, 2.0]])), kwargs=dict(
        dtype="float16"), grad=False, dtypes=F32, label="dtype"),
]


