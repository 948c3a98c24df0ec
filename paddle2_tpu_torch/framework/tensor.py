"""``to_tensor``, ``Parameter`` and the paddle-only tensor names: the
counterpart of ``paddle2_tpu/framework/tensor.py``.

There is no tensor class of the port's own: a port tensor is a
``torch.Tensor``, ``Parameter`` is ``torch.nn.Parameter``, and the tape
is ``torch.autograd``. :func:`install_methods` adds paddle's names to
``torch.Tensor`` only where torch lacks the name (``stop_gradient``,
``place``, ``astype``, ``clear_grad`` ...); an attribute torch already
has keeps torch's meaning (``shape``, ``size``, ``dim``, ``numpy``,
``pow``, ``name``, ...), since the rest of the port and torch itself rely
on it. The README lists those differences.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from . import core

__all__ = ["Tensor", "Parameter", "to_tensor", "install_methods"]

Tensor = torch.Tensor
Parameter = torch.nn.Parameter


def _can_require_grad(t: torch.Tensor) -> bool:
    return t.is_floating_point() or t.is_complex()


def to_tensor(data: Any, dtype: Any = None, place: Any = None,
              stop_gradient: bool = True) -> torch.Tensor:
    """``data`` as a new leaf tensor on ``place`` (default: the current
    place) under the x32 and default-dtype rules of
    :func:`~.core.to_torch_tensor`. ``stop_gradient=False`` makes a float
    or complex tensor require grad; an integer tensor never does."""
    t = core.to_torch_tensor(data, dtype, place)
    if not stop_gradient and _can_require_grad(t):
        t.requires_grad_(True)
    return t


# ------------------------------------------------ paddle-only tensor names

def _get_stop_gradient(self) -> bool:
    return not self.requires_grad


def _set_stop_gradient(self, value: bool) -> None:
    if value != (not self.requires_grad):
        self.requires_grad_(not value)


def _get_trainable(self) -> bool:
    return self.requires_grad


def _set_trainable(self, value: bool) -> None:
    if bool(value) != self.requires_grad:
        self.requires_grad_(bool(value))


def _astype(self, dtype) -> torch.Tensor:
    return self.to(core.convert_dtype(dtype))


def _clear_grad(self) -> None:
    self.grad = None


def _clear_gradient(self, set_to_zero: bool = False) -> None:
    if set_to_zero and self.grad is not None:
        self.grad = torch.zeros_like(self.grad)
    else:
        self.grad = None


def _set_value(self, value) -> None:
    new = (value if isinstance(value, torch.Tensor)
           else torch.from_numpy(np.asarray(value)))
    if tuple(new.shape) != tuple(self.shape):
        raise ValueError(f"set_value shape mismatch: {tuple(new.shape)} vs "
                         f"{tuple(self.shape)}")
    with torch.no_grad():
        self.copy_(new)


_TENSOR_NAMES: Dict[str, Any] = {
    "stop_gradient": property(_get_stop_gradient, _set_stop_gradient),
    "trainable": property(_get_trainable, _set_trainable),
    "place": property(core.place_of_tensor),
    "astype": _astype,
    "cast": _astype,
    "clear_grad": _clear_grad,
    "clear_gradient": _clear_gradient,
    "set_value": _set_value,
}

# every name the port added to torch.Tensor
INSTALLED: Dict[str, Any] = {}


def install_methods(names: Dict[str, Callable]) -> None:
    """Add ``names`` to ``torch.Tensor``, skipping every name the class
    already has."""
    for name, fn in names.items():
        if name in INSTALLED or hasattr(torch.Tensor, name):
            continue
        setattr(torch.Tensor, name, fn)
        INSTALLED[name] = fn


install_methods(_TENSOR_NAMES)
