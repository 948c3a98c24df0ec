"""``paddle2_tpu_torch.autograd`` against ``paddle2_tpu.autograd`` on the
CPU: ``paddle.grad`` (interior inputs, ``create_graph`` to second order,
``allow_unused``, ``no_grad_vars``), ``backward``, ``PyLayer`` (saved
tensors, non-tensor arguments, double backward, non-differentiable
outputs, ``set_materialize_grads``), ``saved_tensors_hooks`` and
``jacobian`` / ``hessian`` / ``vjp`` / ``jvp``."""

import numpy as np
import pytest
import torch

import paddle2_tpu as jp
import paddle2_tpu_torch as tp
from torch_core_harness import port_on_cpu  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


def arr(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def both(a, grad=True):
    return (jp.to_tensor(a, stop_gradient=not grad),
            tp.to_tensor(a, stop_gradient=not grad))


def close(t, j):
    got = t.detach().numpy() if isinstance(t, torch.Tensor) else t
    np.testing.assert_allclose(got, np.asarray(j.numpy()), rtol=RTOL,
                               atol=ATOL)


def test_grad_of_interior_and_leaf_inputs():
    jx, tx = both(arr(3, 4))
    outs = []
    for xp, x in ((jp, jx), (tp, tx)):
        h = xp.tanh(x)
        y = xp.sum(xp.multiply(h, h))
        outs.append(xp.grad(y, [x, h]))
    for t, j in zip(outs[1], outs[0]):
        close(t, j)
    assert all(not g.requires_grad for g in outs[1])
    assert tx.grad is None


def test_grad_second_order():
    jx, tx = both(arr(5))
    res = []
    for xp, x in ((jp, jx), (tp, tx)):
        y = xp.sum(xp.multiply(xp.sin(x), x))
        (g,) = xp.grad(y, x, create_graph=True)
        (gg,) = xp.grad(xp.sum(g), x)
        res.append((g, gg))
    close(res[1][0], res[0][0])
    close(res[1][1], res[0][1])


def test_grad_outputs_allow_unused_and_no_grad_vars():
    ja, ta = both(arr(3, seed=1))
    jb, tb = both(arr(3, seed=2))
    cot = arr(3, seed=3)
    res = []
    for xp, a, b in ((jp, ja, jb), (tp, ta, tb)):
        y = xp.multiply(a, a)
        res.append(xp.grad(y, [a, b], grad_outputs=[xp.to_tensor(cot)],
                           allow_unused=True))
    close(res[1][0], res[0][0])
    assert res[0][1] is None and res[1][1] is None
    with pytest.raises(RuntimeError):
        tp.grad(ta * ta, [ta, tb], grad_outputs=[tp.to_tensor(cot)])
    # no_grad_vars: the path through h is cut
    res = []
    for xp, a in ((jp, ja), (tp, ta)):
        h = xp.exp(a)
        y = xp.sum(xp.add(xp.multiply(h, a), a))
        res.append(xp.grad(y, a, no_grad_vars=[h]))
    close(res[1][0], res[0][0])


def test_backward_accumulates():
    jx, tx = both(arr(4))
    for xp, x in ((jp, jx), (tp, tx)):
        y1 = xp.sum(xp.multiply(x, x))
        y2 = xp.sum(xp.exp(x))
        xp.autograd.backward([y1, y2])
    close(tx.grad, jx.grad)


def _layers(xp, base):
    class Cube(base):
        @staticmethod
        def forward(ctx, x, scale, shift=0.0):
            ctx.save_for_backward(x)
            ctx.scale = scale
            return x * x * x * scale + shift

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            return dy * 3 * x * x * ctx.scale
    return Cube


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pylayer_forward_backward_like_jax(dtype):
    a = arr(3, 4)
    jx = jp.to_tensor(a).astype(dtype)
    jx.stop_gradient = False
    tx = torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_()
    jc, tc = _layers(jp, jp.autograd.PyLayer), \
        _layers(tp, tp.autograd.PyLayer)
    jy = jc.apply(jx, 2.0, shift=1.0)
    ty = tc.apply(tx, 2.0, shift=1.0)
    assert ty.grad_fn.name() == "CubeBackward"
    tol = dict(rtol=1e-2, atol=1e-2) if dtype == "bfloat16" else \
        dict(rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ty.detach().float().numpy(),
                               np.asarray(jy.numpy()).astype(np.float32),
                               **tol)
    jp.sum(jy).backward()
    ty.sum().backward()
    np.testing.assert_allclose(tx.grad.float().numpy(),
                               np.asarray(jx.grad.numpy()).astype(
                                   np.float32), **tol)


def test_pylayer_double_backward_and_context():
    jx, tx = both(arr(4))
    res = []
    for xp, x in ((jp, jx), (tp, tx)):
        cube = _layers(xp, xp.autograd.PyLayer)
        y = xp.sum(cube.apply(x, 1.0))
        (g,) = xp.grad(y, x, create_graph=True)
        (gg,) = xp.grad(xp.sum(g), x)
        res.append((g, gg))
    close(res[1][0], res[0][0])
    close(res[1][1], res[0][1])

    class Split(tp.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.set_materialize_grads(False)
            idx = torch.argmax(x)
            ctx.mark_non_differentiable(idx)
            ctx.mark_not_inplace(x)
            return x * 2, idx

        @staticmethod
        def backward(ctx, dy, didx):
            assert didx is None
            return dy * 2
    y, idx = Split.apply(tx)
    assert not idx.requires_grad and ctx_free(y)
    y.sum().backward()
    assert torch.equal(tx.grad, torch.full((4,), 2.0))


def ctx_free(t):
    return t.requires_grad


def test_saved_tensors_hooks_wrap_pylayer_saves():
    packed, unpacked = [], []

    def pack(t):
        packed.append(t.shape)
        return t.detach().clone()

    def unpack(t):
        unpacked.append(t.shape)
        return t
    res = []
    for xp in (jp, tp):
        packed.clear()
        unpacked.clear()
        x = xp.to_tensor(arr(2, 3), stop_gradient=False)
        cube = _layers(xp, xp.autograd.PyLayer)
        with xp.autograd.saved_tensors_hooks(pack, unpack):
            y = cube.apply(x, 1.0)
        xp.sum(y).backward()
        res.append((list(packed), list(unpacked), x.grad))
    assert [tuple(s) for s in res[1][0]] == [tuple(s) for s in res[0][0]]
    assert len(res[1][1]) == len(res[0][1]) == 1
    close(res[1][2], res[0][2])
    assert tp.autograd.saved_tensors_hooks is \
        torch.autograd.graph.saved_tensors_hooks


def _f(xp):
    def f(x):
        return xp.multiply(xp.sin(x), xp.sum(xp.multiply(x, x)))
    return f


def _g(xp):
    def g(x, y):
        return xp.sum(xp.multiply(xp.exp(x), y)) + xp.sum(
            xp.multiply(y, y))
    return g


def test_jacobian_functional_and_tensor_forms():
    jx, tx = both(arr(3))
    close(tp.autograd.jacobian(_f(tp), tx), jp.autograd.jacobian(_f(jp),
                                                                jx))
    jy, ty = both(arr(3, seed=5))
    jl = jp.autograd.jacobian(lambda a, b: jp.multiply(a, b), [jx, jy])
    tl = tp.autograd.jacobian(lambda a, b: tp.multiply(a, b), [tx, ty])
    for t, j in zip(tl, jl):
        close(t, j)
    # tensor form: ys already computed from xs
    jys, tys = _f(jp)(jx), _f(tp)(tx)
    close(tp.autograd.jacobian(tys, tx), jp.autograd.jacobian(jys, jx))


def test_hessian_vjp_jvp():
    jx, tx = both(arr(3))
    jy, ty = both(arr(3, seed=4))
    h = jp.autograd.hessian(lambda a: jp.sum(_f(jp)(a)), jx)
    close(tp.autograd.hessian(lambda a: tp.sum(_f(tp)(a)), tx), h)
    jh = jp.autograd.hessian(_g(jp), [jx, jy])
    th = tp.autograd.hessian(_g(tp), [tx, ty])
    for ti, ji in zip(th, jh):
        for t, j in zip(ti, ji):
            close(t, j)
    v = arr(3, seed=9)
    jys, jg = jp.autograd.vjp(_f(jp), jx, jp.to_tensor(v))
    tys, tg = tp.autograd.vjp(_f(tp), tx, tp.to_tensor(v))
    close(tys, jys)
    close(tg, jg)
    jys, jg = jp.autograd.vjp(_g(jp), [jx, jy])
    tys, tg = tp.autograd.vjp(_g(tp), [tx, ty])
    close(tys, jys)
    for t, j in zip(tg, jg):
        close(t, j)
    jys, jt = jp.autograd.jvp(_f(jp), jx, jp.to_tensor(v))
    tys, tt = tp.autograd.jvp(_f(tp), tx, tp.to_tensor(v))
    close(tys, jys)
    close(tt, jt)
    jys, jt = jp.autograd.jvp(_f(jp), jx)
    tys, tt = tp.autograd.jvp(_f(tp), tx)
    close(tt, jt)
    assert not tt.requires_grad
