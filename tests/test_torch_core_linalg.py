"""``paddle2_tpu_torch``'s linear algebra ops (``ops/linalg.py``) against
the JAX package's on the CPU: forward values, result dtypes and
gradients (see ``torch_core_harness``). Decompositions whose factors are
fixed only up to signs (QR, SVD, eigenvectors) are compared through
sign-free forms: the products they reconstruct, ``|v|``, singular values.

bfloat16 runs where the JAX package runs it: its LAPACK decompositions
(Cholesky, QR, SVD, LU, eigh, inverses, solves) refuse bfloat16, and
those cases run in float32 only. torch decomposes a bfloat16 operand in
float32 and rounds the result."""

import numpy as np
import pytest

import paddle2_tpu as jp
import paddle2_tpu_torch as tp
from torch_core_harness import port_on_cpu  # noqa: F401
from torch_core_harness import cases_params, run_case
from torch_core_table_linalg import CASES


@pytest.mark.parametrize("case,dtype", cases_params(CASES))
def test_linalg_op(case, dtype):
    run_case(case, dtype)


def test_lu_unpack_reconstructs_like_jax():
    a = np.random.default_rng(3).standard_normal((4, 4)).astype(np.float32)
    a += 4 * np.eye(4, dtype=np.float32)
    jl, jpiv = jp.lu(jp.to_tensor(a))
    tl, tpiv = tp.lu(tp.to_tensor(a, place="cpu"))
    jout = [np.asarray(t.numpy()) for t in jp.lu_unpack(jl, jpiv)]
    tout = [t.numpy() for t in tp.lu_unpack(tl, tpiv)]
    for got, want in zip(tout, jout):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    p, l, u = tout
    np.testing.assert_allclose(p @ l @ u, a, rtol=1e-4, atol=1e-4)
