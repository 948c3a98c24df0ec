"""``paddle.autograd`` on ``torch.autograd``: the counterpart of
``paddle2_tpu/autograd/``. The JAX package keeps a tape of its own
(``autograd/tape.py``); the port's tape is torch's, so there is no
counterpart of that file: :func:`grad` and :func:`backward` are
``torch.autograd.grad`` / ``backward`` under paddle's argument names."""

from __future__ import annotations

from typing import List, Optional

import torch

__all__ = ["grad", "backward", "PyLayer", "PyLayerContext",
           "saved_tensors_hooks", "jacobian", "hessian", "vjp", "jvp"]


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None) -> List[Optional[torch.Tensor]]:
    """``paddle.grad``: the gradients of ``outputs`` with respect to
    ``inputs`` (leaf or interior tensors), a list, with no effect on any
    tensor's ``.grad``. ``create_graph=True`` records the backward for
    higher orders; ``retain_graph`` defaults to ``create_graph``.
    ``no_grad_vars`` are constants: no gradient flows through them (an
    input reached only through one gets zeros). An input that gets no
    gradient raises unless ``allow_unused``, which gives None."""
    outputs, inputs = _as_list(outputs), _as_list(inputs)
    if grad_outputs is not None:
        grad_outputs = _as_list(grad_outputs)
    hooks = [v.register_hook(torch.zeros_like)
             for v in (no_grad_vars or ()) if v.requires_grad]
    try:
        out = torch.autograd.grad(outputs, inputs, grad_outputs,
                                  retain_graph=retain_graph,
                                  create_graph=create_graph,
                                  allow_unused=allow_unused)
    finally:
        for h in hooks:
            h.remove()
    return list(out)


def backward(tensors, grad_tensors=None, retain_graph=False):
    """``paddle.autograd.backward``: accumulate into the leaves' ``.grad``."""
    tensors = _as_list(tensors)
    if grad_tensors is not None:
        grad_tensors = _as_list(grad_tensors)
    torch.autograd.backward(tensors, grad_tensors, retain_graph=retain_graph)


from .py_layer import PyLayer, PyLayerContext  # noqa: E402
from .saved_tensors_hooks import saved_tensors_hooks  # noqa: E402
from .functional import hessian, jacobian, jvp, vjp  # noqa: E402
