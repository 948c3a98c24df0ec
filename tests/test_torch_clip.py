"""Gradient clipping (paddle2_tpu_torch.nn.clip) held against the JAX
package's ``nn.ClipGradBy*``, ``clip_grad_norm_`` and
``clip_grad_value_`` on the same numpy gradients: the ``(param, grad)``
form with ``need_clip=False`` on one parameter, the optimizer's
``apply_arrays`` form, f32 and bf16.

Tolerances: f32 to 1e-6 relative of each tensor's largest magnitude (the
norms sum in another order); bf16 to one bf16 step (2**-8) relative, the
clipped value being one rounding of an f32 product in both packages.
"""

import numpy as np
import pytest
import torch

import paddle2_tpu as paddle
import paddle2_tpu.nn as jnn
import paddle2_tpu_torch.nn as tnn

SHAPES = [(5, 7), (13,), (3, 4, 2)]
TOL = {"float32": 1e-6, "bfloat16": 2 ** -8}


def _grads(seed, scale=3.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in SHAPES]


def _jax(arrs, dtype):
    return [paddle.to_tensor(a).astype(dtype) for a in arrs]


def _torch(arrs, dtype):
    # copies: the port clips in place, and the JAX arrays may share the
    # numpy buffers
    return [torch.from_numpy(a.copy()).to(getattr(torch, dtype))
            for a in arrs]


def _close(got, want, dtype):
    w = np.asarray(want._data.astype("float32") if hasattr(want, "_data")
                   else want, np.float32)
    g = got.float().numpy()
    assert str(got.dtype).endswith(dtype)
    np.testing.assert_allclose(g, w, rtol=0,
                               atol=TOL[dtype] * max(np.abs(w).max(), 1e-12))


CLIPS = [("ClipGradByValue", (0.7,), {}),
         ("ClipGradByValue", (0.9,), dict(min=-0.2)),
         ("ClipGradByNorm", (1.5,), {}),
         ("ClipGradByGlobalNorm", (2.0,), {}),
         ("ClipGradByGlobalNorm", (1e3,), {})]
CLIP_IDS = ["value", "value_min", "norm", "global", "global_no_clip"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,args,kwargs", CLIPS, ids=CLIP_IDS)
def test_apply_arrays_matches_jax(name, args, kwargs, dtype):
    arrs = _grads(1)
    got = getattr(tnn, name)(*args, **kwargs).apply_arrays(
        _torch(arrs, dtype))
    want = getattr(jnn, name)(*args, **kwargs).apply_arrays(
        [t._data for t in _jax(arrs, dtype)])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, np.asarray(w.astype("float32")), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,args,kwargs", CLIPS, ids=CLIP_IDS)
def test_pairs_honour_need_clip(name, args, kwargs, dtype):
    """``__call__`` on ``(param, grad)`` pairs: the parameter marked
    ``need_clip = False`` keeps its gradient, a ``None`` gradient stays
    ``None``, and the rest match the JAX package's (whose global norm
    leaves the unclipped gradient out too)."""
    arrs = _grads(2)
    tps = [torch.nn.Parameter(torch.zeros(s)) for s in SHAPES]
    jps = [paddle.create_parameter(list(s), "float32") for s in SHAPES]
    tps[1].need_clip = False
    jps[1].need_clip = False
    tg, jg = _torch(arrs, dtype), _jax(arrs, dtype)
    extra_t = torch.nn.Parameter(torch.zeros(2))
    extra_j = paddle.create_parameter([2], "float32")
    got = getattr(tnn, name)(*args, **kwargs)(
        list(zip(tps, tg)) + [(extra_t, None)])
    want = getattr(jnn, name)(*args, **kwargs)(
        list(zip(jps, jg)) + [(extra_j, None)])
    assert got[1][1] is tg[1] and got[-1][1] is None
    for (p, g), (_, w) in zip(got[:-1], want[:-1]):
        _close(g, w, dtype)


def test_global_norm_clips_at_the_limit():
    arrs = _grads(3, scale=10.0)
    out = tnn.ClipGradByGlobalNorm(1.0).apply_arrays(_torch(arrs, "float32"))
    total = torch.sqrt(sum((g.double() ** 2).sum() for g in out))
    assert abs(total.item() - 1.0) < 1e-5
    c = tnn.ClipGradByGlobalNorm(1.0, group_name="g", auto_skip_clip=True)
    assert (c.group_name, c.auto_skip_clip) == ("g", True)


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")],
                         ids=["l2", "l1", "inf"])
def test_clip_grad_norm_matches_jax(norm_type):
    arrs = _grads(4)
    tps = [torch.nn.Parameter(torch.zeros(s)) for s in SHAPES]
    jps = [paddle.create_parameter(list(s), "float32") for s in SHAPES]
    for p, g in zip(tps, _torch(arrs, "float32")):
        p.grad = g
    for p, g in zip(jps, _jax(arrs, "float32")):
        p.grad = g
    tn = tnn.clip_grad_norm_(iter(tps), 2.5, norm_type=norm_type)
    jn = jnn.clip_grad_norm_(jps, 2.5, norm_type=norm_type)
    np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
    for p, q in zip(tps, jps):
        _close(p.grad, q.grad, "float32")


def test_clip_grad_value_matches_jax():
    arrs = _grads(5)
    tps = [torch.nn.Parameter(torch.zeros(s)) for s in SHAPES]
    jps = [paddle.create_parameter(list(s), "float32") for s in SHAPES]
    for p, g in zip(tps, _torch(arrs, "float32")):
        p.grad = g
    for p, g in zip(jps, _jax(arrs, "float32")):
        p.grad = g
    tnn.clip_grad_value_(tps, 0.4)
    jnn.clip_grad_value_(jps, 0.4)
    for p, q in zip(tps, jps):
        _close(p.grad, q.grad, "float32")
        assert p.grad.abs().max() <= 0.4
