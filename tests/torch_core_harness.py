"""Shared harness of the ``test_torch_core_*.py`` files: one op case
(``torch_core_cases``) runs the same numpy inputs, drawn from a seed,
through ``paddle2_tpu.<op>`` and ``paddle2_tpu_torch.<op>`` on the CPU
and holds the forward values, the result dtypes and, for a
differentiable op, the gradients of ``sum(out * cotangent)`` with
respect to every float input, at the tolerances of
``torch_core_cases.TOL`` (or the case's own)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle2_tpu as jp
import paddle2_tpu_torch as tp
from torch_core_cases import (TOL, Case, Raw, _is_float_np, as_np,
                              assert_same, dtype_name, flat, is_tensor,
                              resolve, seed_of)


@pytest.fixture(autouse=True)
def port_on_cpu():
    """The port's creation ops land on the current place (the card by
    default): the tests ask for the CPU. Each test file imports this
    fixture."""
    before = tp.framework.core._current_place
    tp.set_device("cpu")
    yield
    tp.framework.core._current_place = before


def cases_params(cases):
    return [pytest.param(c, dt, id=f"{c.id}-{dt}")
            for c in cases for dt in c.dtypes]


# --------------------------------------------------------- conversions

def _jax_tensor(a, dtype, requires_grad):
    if _is_float_np(a):
        arr = a.astype(jnp.bfloat16) if dtype == "bfloat16" \
            else a.astype(np.float32)
        return jp.to_tensor(arr, stop_gradient=not requires_grad)
    return jp.to_tensor(a)


def _torch_tensor(a, dtype, requires_grad):
    if _is_float_np(a):
        t = torch.from_numpy(a.astype(np.float32))
        if dtype == "bfloat16":
            t = t.to(torch.bfloat16)
        return t.requires_grad_(requires_grad)
    return tp.to_tensor(a, place="cpu")


def build(args, dtype, side, grad_ids):
    """``args`` as one package's tensors; returns them and the leaves
    that take gradients (by position in ``grad_ids``)."""
    make = _jax_tensor if side == "jax" else _torch_tensor
    leaves = []
    out = []
    for i, a in enumerate(args):
        if isinstance(a, Raw):
            out.append(a.value)
        elif isinstance(a, list):
            items = []
            for a2 in a:
                rg = i in grad_ids and _is_float_np(a2)
                t = make(a2, dtype, rg)
                if rg:
                    leaves.append(t)
                items.append(t)
            out.append(items)
        elif isinstance(a, np.ndarray):
            rg = i in grad_ids and _is_float_np(a)
            t = make(a, dtype, rg)
            if rg:
                leaves.append(t)
            out.append(t)
        else:
            out.append(a)
    return out, leaves


def build_kwargs(kwargs, dtype, side):
    make = _jax_tensor if side == "jax" else _torch_tensor
    return {k: make(v, dtype, False) if isinstance(v, np.ndarray) else v
            for k, v in kwargs.items()}


def run_case(case: Case, dtype: str):
    rng = np.random.default_rng(seed_of(case))
    args = list(case.make(rng))
    n = len(args)
    grad_ids = set(case.grad_args if case.grad_args is not None
                   else range(n)) if case.grad else set()
    tol = {**TOL, **case.tol}
    ja, jl = build(args, dtype, "jax", grad_ids)
    ta, tl = build(args, dtype, "torch", grad_ids)
    jk = build_kwargs(case.kwargs, dtype, "jax")
    tk = build_kwargs(case.kwargs, dtype, "torch")
    jout = resolve(jp, case.op)(*ja, **jk)
    tout = resolve(tp, case.op)(*ta, **tk)
    if case.post is not None:
        jout, tout = case.post(jout, jp), case.post(tout, tp)
    if case.shape_only:
        for a, b in zip(flat(tout), flat(jout)):
            assert dtype_name(a) == dtype_name(b)
            assert tuple(a.shape) == tuple(b.shape)
        return
    assert_same(tout, jout, tol, case.id)
    if not (case.grad and jl):
        return
    jo = [o for o in flat(jout) if is_tensor(o) and not o.stop_gradient
          and dtype_name(o) in ("float32", "bfloat16", "float16")]
    to = [o for o in flat(tout) if is_tensor(o) and o.requires_grad
          and dtype_name(o) in ("float32", "bfloat16", "float16")]
    assert len(jo) == len(to), \
        f"{case.id}: {len(to)} outputs take gradients, want {len(jo)}"
    if not jo:
        return
    crng = np.random.default_rng(seed_of(case) + 1)
    cots = [crng.standard_normal(tuple(o.shape)).astype(np.float32)
            for o in jo]
    jc = [jp.to_tensor(c).astype(dtype_name(o)) for c, o in zip(cots, jo)]
    tc = [torch.from_numpy(c).to(o.dtype) for c, o in zip(cots, to)]
    jg = jp.grad(jo, jl, grad_outputs=jc, allow_unused=True)
    tg = tp.grad(to, tl, grad_outputs=tc, allow_unused=True)
    for i, (a, b) in enumerate(zip(tg, jg)):
        if b is None:
            assert a is None or not as_np(a).any(), \
                f"{case.id} grad {i}: the JAX package gives none"
            continue
        assert a is not None, f"{case.id} grad {i}: the port gives none"
        assert_same(a, b, tol, f"{case.id} grad {i}")


