"""Shared runner of the ``test_torch_nn_layers*.py`` files: one layer of
``torch_nn_table_layers`` built in both packages from the same
arguments, the JAX weights loaded into the port's twin, and the state
names, the forward, the dtypes and the gradients held (tolerances of
``torch_core_cases.TOL``, or the entry's own)."""

from __future__ import annotations

import zlib

import numpy as np
import pytest
import torch

import paddle2_tpu as jp
import paddle2_tpu_torch as tp
from paddle2_tpu_torch.models import nn_state_from_reference
from torch_core_cases import (TOL, as_np, assert_same, dtype_name, flat,
                              is_tensor)


def layer_params(entries):
    return [pytest.param(e, dt, id=f"{e.id}-{dt}")
            for e in entries for dt in e.dtypes]


def _side(v, side):
    if isinstance(v, np.ndarray):
        return jp.to_tensor(v) if side == "jax" else torch.from_numpy(v)
    return v


def build_pair(entry, seed=0):
    """The JAX layer and the port's twin with the JAX weights."""
    jp.seed(seed)
    jl = getattr(jp.nn, entry.name)(
        *entry.args, **{k: _side(v, "jax") for k, v in entry.kwargs.items()})
    tl = getattr(tp.nn, entry.name)(
        *entry.args,
        **{k: _side(v, "torch") for k, v in entry.kwargs.items()})
    return jl, tl


def check_state(jl, tl, what):
    """The same state names in the same order and shapes; the twin takes
    the JAX state as it is."""
    js, ts = jl.state_dict(), tl.state_dict()
    assert list(ts) == list(js), what
    for k in js:
        assert tuple(ts[k].shape) == tuple(js[k].shape), (what, k)
    missing, unexpected = tl.set_state_dict(nn_state_from_reference(jl))
    assert not missing and not unexpected, (what, missing, unexpected)
    for k in js:
        np.testing.assert_array_equal(as_np(ts[k]),
                                      np.asarray(js[k].numpy(), np.float32)
                                      if as_np(ts[k]).dtype.kind == "f"
                                      else np.asarray(js[k].numpy()))


def run_layer(entry, dtype):
    jl, tl = build_pair(entry)
    check_state(jl, tl, entry.id)
    if dtype != "float32":
        jl.to(dtype=dtype)
        tl.to(dtype=dtype)
    if not entry.train:
        jl.eval()
        tl.eval()
    rng = np.random.default_rng(zlib.crc32(entry.id.encode()))
    arrays = [m(rng) for m in entry.inputs]
    grad_ids = set(range(len(arrays)) if entry.grad_inputs is None
                   else entry.grad_inputs)
    jin, tin, jleaves, tleaves = [], [], [], []

    def make(a, rg):
        if a.dtype.kind != "f":
            return jp.to_tensor(a), torch.from_numpy(a)
        j = jp.to_tensor(a).astype(dtype)
        j.stop_gradient = not rg
        t = torch.from_numpy(a).to(getattr(torch, dtype))
        t.requires_grad_(rg)
        if rg:
            jleaves.append(j)
            tleaves.append(t)
        return j, t
    for i, a in enumerate(arrays):
        # a list of arrays is a tuple argument (an LSTM's (h, c))
        pairs = [make(x, i in grad_ids) for x in a] \
            if isinstance(a, list) else [make(a, i in grad_ids)]
        j, t = zip(*pairs)
        jin.append(tuple(j) if isinstance(a, list) else j[0])
        tin.append(tuple(t) if isinstance(a, list) else t[0])
    jparams = [p for p in jl.parameters() if not p.stop_gradient]
    tparams = [p for p in tl.parameters() if p.requires_grad]
    assert len(jparams) == len(tparams), entry.id
    jout = jl(*jin)
    tout = tl(*tin)
    tol = {**TOL, **entry.tol}
    assert_same(tout, jout, tol, entry.id)
    for name, b in jl.named_buffers():
        assert_same(dict(tl.named_buffers())[name], b, tol,
                    f"{entry.id} buffer {name}")
    floats = ("float32", "bfloat16", "float16")
    jo = [o for o in flat(jout) if is_tensor(o) and not o.stop_gradient
          and dtype_name(o) in floats]
    to = [o for o in flat(tout) if is_tensor(o) and o.requires_grad]
    assert len(jo) == len(to), entry.id
    if not jo:
        return
    crng = np.random.default_rng(1)
    cots = [crng.standard_normal(tuple(o.shape)).astype(np.float32)
            for o in jo]
    jc = [jp.to_tensor(c).astype(dtype_name(o)) for c, o in zip(cots, jo)]
    tc = [torch.from_numpy(c).to(o.dtype) for c, o in zip(cots, to)]
    jg = jp.grad(jo, jleaves + jparams, grad_outputs=jc, allow_unused=True)
    tg = torch.autograd.grad(to, tleaves + tparams, tc, allow_unused=True)
    for i, (a, b) in enumerate(zip(tg, jg)):
        if b is None:
            assert a is None or not as_np(a).any(), f"{entry.id} grad {i}"
            continue
        assert a is not None, f"{entry.id} grad {i}: the port gives none"
        assert_same(a, b, tol, f"{entry.id} grad {i}")
