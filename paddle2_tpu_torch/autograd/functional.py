"""``jacobian``, ``hessian``, ``vjp`` and ``jvp`` (the counterpart of
``paddle2_tpu/autograd/functional.py``), on
``torch.autograd.functional``. ``batch_axis`` is taken and, as in the JAX
package, not used. Results hold no graph."""

from __future__ import annotations

from typing import Callable

import torch
from torch.autograd import functional as AF


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _detached(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach()
    if isinstance(obj, (tuple, list)):
        return type(obj)(_detached(o) for o in obj)
    return obj


def jacobian(ys, xs, batch_axis=None):
    """``jacobian(func, xs)``: the Jacobian of a callable, ``y.shape +
    x.shape`` for each (output, input); one array when ``xs`` is one
    tensor. ``jacobian(ys, xs)`` with ``ys`` already computed: rows of
    vector-Jacobian products through the graph that made them."""
    if callable(ys) and not isinstance(ys, torch.Tensor):
        xs_l = _as_list(xs)
        jac = AF.jacobian(ys, tuple(xs_l))
        if isinstance(xs, (list, tuple)):
            return _detached(jac)
        if isinstance(jac, tuple) and jac and isinstance(jac[0], tuple):
            return _detached(jac[0])
        return _detached(jac[0] if isinstance(jac, tuple) else jac)
    ys_l, xs_l = _as_list(ys), _as_list(xs)
    rows = []
    for y in ys_l:
        flat = y.reshape(-1)
        per_row = []
        for i in range(flat.numel()):
            gs = torch.autograd.grad(flat[i], xs_l, retain_graph=True,
                                     allow_unused=True)
            per_row.append([torch.zeros_like(x) if g is None else g
                            for g, x in zip(gs, xs_l)])
        per_x = [torch.stack([r[k] for r in per_row]).reshape(
            *y.shape, *x.shape).detach() for k, x in enumerate(xs_l)]
        rows.append(per_x if isinstance(xs, (list, tuple)) else per_x[0])
    return rows if isinstance(ys, (list, tuple)) else rows[0]


def hessian(func: Callable, xs, batch_axis=None):
    """The Hessian of a callable with a scalar output: ``x.shape +
    x.shape``, or a nested tuple over a list of inputs."""
    if not callable(func) or isinstance(func, torch.Tensor):
        raise TypeError("hessian expects a callable producing a scalar")
    xs_l = _as_list(xs)
    h = AF.hessian(func, tuple(xs_l))
    if isinstance(xs, (list, tuple)):
        return _detached(h)
    return _detached(h[0][0] if isinstance(h, tuple) else h)


def vjp(func: Callable, xs, v=None):
    """``(ys, vjp)``: ``func(*xs)`` and ``v``'s vector-Jacobian product
    (``v`` defaults to ones), a list over a list of inputs."""
    xs_l = _as_list(xs)
    ys = func(*xs_l)
    if v is None:
        v = (tuple(torch.ones_like(y) for y in ys)
             if isinstance(ys, tuple) else torch.ones_like(ys))
    else:
        v_l = _as_list(v)
        v = tuple(v_l) if isinstance(ys, tuple) else v_l[0]
    ys, gs = AF.vjp(func, tuple(xs_l), v)
    gs = list(_detached(gs))
    return _detached(ys), (gs if isinstance(xs, (list, tuple)) else gs[0])


def jvp(func: Callable, xs, v=None):
    """``(ys, tangents)``: ``func(*xs)`` and its Jacobian-vector product
    with ``v`` (default ones), in ``ys``'s structure."""
    xs_l = _as_list(xs)
    v = (tuple(torch.ones_like(x) for x in xs_l) if v is None
         else tuple(_as_list(v)))
    ys, out = AF.jvp(func, tuple(xs_l), v)
    return _detached(ys), _detached(out)
