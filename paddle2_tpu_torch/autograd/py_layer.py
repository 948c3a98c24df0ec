"""``PyLayer``: a user's forward and backward, on
``torch.autograd.Function`` (the counterpart of
``paddle2_tpu/autograd/py_layer.py``).

A subclass writes paddle's protocol: ``forward(ctx, *args, **kwargs)``
and ``backward(ctx, *grads)`` returning one gradient for each tensor
argument of ``forward`` (not for the other arguments), and calls
``Sub.apply(*args, **kwargs)``. Each subclass gets a
``torch.autograd.Function`` of its own name that carries the call; its
``ctx`` is a :class:`PyLayerContext`.
"""

from __future__ import annotations

from typing import Any, List

import torch

__all__ = ["PyLayer", "PyLayerContext"]


class PyLayerContext:
    """What ``forward`` and ``backward`` receive as ``ctx``: paddle's
    names over torch's context. Other attributes may be stashed on it."""

    def __init__(self, ctx):
        self._ctx = ctx
        self.materialize_grads = True

    def save_for_backward(self, *tensors):
        self._ctx.save_for_backward(*tensors)

    def saved_tensor(self):
        return self._ctx.saved_tensors

    def mark_not_inplace(self, *args):
        pass

    def mark_non_differentiable(self, *args):
        self._ctx.mark_non_differentiable(*args)

    def set_materialize_grads(self, value: bool):
        self.materialize_grads = bool(value)
        self._ctx.set_materialize_grads(bool(value))


class _Bridge(torch.autograd.Function):
    """Runs a PyLayer's forward and backward; the layer class and the
    keyword arguments ride in front of the positional ones."""

    @staticmethod
    def forward(ctx, layer, kwargs, *args):
        pctx = PyLayerContext(ctx)
        ctx.pctx, ctx.layer = pctx, layer
        ctx.tensor_args = [isinstance(a, torch.Tensor) for a in args]
        return layer.forward(pctx, *args, **kwargs)

    @staticmethod
    def backward(ctx, *grads):
        got = ctx.layer.backward(ctx.pctx, *grads)
        if not isinstance(got, (tuple, list)):
            got = (got,)
        out: List[Any] = []
        gi = 0
        for is_tensor in ctx.tensor_args:
            if is_tensor:
                out.append(got[gi] if gi < len(got) else None)
                gi += 1
            else:
                out.append(None)
        return (None, None, *out)


class PyLayer:
    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        fn = cls.__dict__.get("_function")
        if fn is None:
            fn = type(cls.__name__, (_Bridge,), {})
            cls._function = fn
        return fn.apply(cls, kwargs, *args)
