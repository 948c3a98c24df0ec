"""``auto_cast`` and the cast it drives: the counterpart of
``paddle2_tpu/amp/__init__.py:24-81`` and of the cast in
``paddle2_tpu/ops/dispatch.py:35-60, :170-175``.

The JAX package casts by op name where it dispatches an op: under O1 a
white-list op's floating inputs go to the AMP dtype and a black-list
op's to f32, the rest untouched; under O2 every op that is not black
goes to the AMP dtype; the custom lists override both
(:func:`cast_inputs_for_op`). Its models run every op through that
dispatcher, so the cast reaches every op of a forward, the ones inside
the stacked blocks included, and nothing inside an op (a kernel's own
f32 arithmetic is never cast).

The port's models call torch directly, so the same rule reaches them by
two means, both keyed by the JAX package's op names:

- :func:`amp_op` decorates each port function that stands for one JAX
  op (the op library's ops, ``scaled_dot_product_attention`` as
  ``"flash_attention"`` or ``"sdpa"``, ``layer_norm``, the losses):
  it casts the function's floating tensor arguments by its name and
  runs the body with the cast switched off, as a JAX op's body is pure;
- while ``auto_cast`` is on, :class:`CastMode`, a ``TorchFunctionMode``,
  casts the arguments of the torch functions the models call directly
  (``F.linear``, ``torch.matmul``, ``F.embedding``, ``+``, ``F.gelu``,
  ...) under the JAX name :data:`TORCH_NAMES` gives each. A torch
  function the table does not name runs as called, at O1 and at O2.

It is not ``torch.autocast``: torch's own lists differ from the JAX
package's (it keeps ``layer_norm`` inputs as they come, runs ``add``
in whatever dtype it meets, and has no O2), and the port is held
against the JAX package. A backward pass is never cast (autograd
replays what the forward recorded), except the forward that activation
recomputation re-runs in the backward, which :func:`bind_amp_state`
puts back under the state of the forward it repeats.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from . import amp_lists
from ..framework import core

__all__ = ["auto_cast", "amp_guard", "amp_state", "cast_inputs_for_op",
           "amp_op", "cast_call", "CastMode", "TORCH_NAMES", "record_casts",
           "bind_amp_state"]

_tls = threading.local()


class _AmpState:
    __slots__ = ("enable", "dtype", "level", "custom_white", "custom_black",
                 "use_promote")

    def __init__(self, enable, dtype, level, custom_white, custom_black,
                 use_promote=True):
        self.enable = enable
        self.dtype = dtype
        self.level = level
        self.custom_white = set(custom_white or ())
        self.custom_black = set(custom_black or ())
        self.use_promote = use_promote


def amp_state() -> Optional[_AmpState]:
    """The calling thread's AMP state (None outside ``auto_cast``)."""
    return getattr(_tls, "state", None)


def _target(name: str, st: _AmpState) -> Optional[torch.dtype]:
    """The dtype op ``name``'s floating inputs take under ``st``, or None
    where they stay as they are."""
    white = (name in amp_lists.WHITE_LIST or name in st.custom_white) \
        and name not in st.custom_black
    black = (name in amp_lists.BLACK_LIST or name in st.custom_black) \
        and name not in st.custom_white
    if st.level == "O2":
        return torch.float32 if black else st.dtype
    if white:
        return st.dtype
    if black:
        return torch.float32
    return None


def _cast(x: Any, target: torch.dtype) -> Any:
    if isinstance(x, torch.Tensor):
        return x.to(target) if x.is_floating_point() and \
            x.dtype != target else x
    if type(x) in (list, tuple) and any(isinstance(t, torch.Tensor)
                                        for t in x):
        return type(x)(_cast(t, target) for t in x)
    return x


def cast_inputs_for_op(name: str, arrays):
    """The AMP cast of op ``name`` applied to ``arrays`` (a sequence of
    tensors), as the JAX package's dispatcher applies it: returns a
    tuple, floating tensors cast to the op's target dtype, or
    ``arrays`` itself outside ``auto_cast``."""
    st = amp_state()
    if st is None or not st.enable:
        return arrays
    target = _target(name, st)
    if target is None:
        return arrays
    return tuple(_cast(a, target) for a in arrays)


def _record(name: str, out: Any) -> None:
    rec = getattr(_tls, "record", None)
    if rec is None:
        return
    outs = out if isinstance(out, (tuple, list)) else (out,)
    rec.append((name, tuple(o.dtype for o in outs
                            if isinstance(o, torch.Tensor)
                            and o.is_floating_point())))


@contextlib.contextmanager
def record_casts():
    """Collect ``(op name, floating output dtypes)`` of every op the cast
    reached in this thread while the block runs (the smoke's and the
    tests' view of which ops ran in which dtype)."""
    prev = getattr(_tls, "record", None)
    rec: List[Tuple[str, tuple]] = []
    _tls.record = rec
    try:
        yield rec
    finally:
        _tls.record = prev


def _active() -> Optional[_AmpState]:
    """The state to cast under, or None: outside ``auto_cast``, inside
    an op's body, or inside the backward (but for a recomputed
    forward)."""
    st = getattr(_tls, "state", None)
    if st is None or not st.enable or getattr(_tls, "suspended", 0):
        return None
    if torch._C._current_autograd_node() is not None and \
            not getattr(_tls, "replay", 0):
        return None
    return st


@contextlib.contextmanager
def _suspended():
    _tls.suspended = getattr(_tls, "suspended", 0) + 1
    try:
        yield
    finally:
        _tls.suspended -= 1


def cast_call(name: str, fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)`` as the JAX op ``name``: under ``auto_cast``
    the floating tensor arguments (and the tensors of a list or tuple
    argument) take the op's target dtype, and ``fn`` runs with the cast
    off."""
    st = _active()
    if st is None:
        return fn(*args, **kwargs)
    target = _target(name, st)
    with _suspended():
        if target is not None:
            args = tuple(_cast(a, target) for a in args)
            kwargs = {k: _cast(v, target) for k, v in kwargs.items()}
        out = fn(*args, **kwargs)
    if target is not None:
        _record(name, out)
    return out


def amp_op(name: str) -> Callable:
    """Decorator for a port function that is the JAX op ``name``: every
    call goes through :func:`cast_call`."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if getattr(_tls, "state", None) is None:
                return fn(*args, **kwargs)
            return cast_call(name, fn, *args, **kwargs)
        wrapper.amp_name = name
        return wrapper
    return deco


_T = torch.Tensor
# the torch functions the port's models (GPT, ERNIE, a packed stack of
# flash_attn_unpadded layers; the vision models' residual ``+``) call
# directly in their forwards, by the JAX op each one is (``x + y`` comes
# as ``Tensor.add``); every other op of those forwards is an
# :func:`amp_op` (the ``nn`` layers' functionals among them). A model's
# forward reaches each entry (tests/test_torch_amp.py)
TORCH_NAMES = {
    # white
    F.linear: "linear",
    torch.matmul: "matmul",     # GPT's fake-quantized head
    # neither: cast at O2 only
    F.embedding: "embedding", _T.add: "add", F.dropout: "dropout",
    F.gelu: "gelu", torch.tanh: "tanh",
}


class CastMode(TorchFunctionMode):
    """Casts the arguments of the torch functions :data:`TORCH_NAMES`
    names, by the JAX op each one is. Pushed by ``auto_cast`` in the
    thread that enters it; a function the table does not name runs as
    called."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        try:
            name = TORCH_NAMES.get(func)
        except TypeError:               # an unhashable callable
            name = None
        st = _active() if name is not None else None
        target = _target(name, st) if st is not None else None
        if target is None:
            return func(*args, **kwargs)
        args = tuple(_cast(a, target) for a in args)
        kwargs = {k: _cast(v, target) for k, v in kwargs.items()}
        out = func(*args, **kwargs)
        _record(name, out)
        return out


@contextlib.contextmanager
def _entered(st: Optional[_AmpState], replay: bool = False):
    """Run the block under ``st`` in this thread, with the mode pushed
    once per thread however deep ``auto_cast`` nests."""
    prev = getattr(_tls, "state", None)
    _tls.state = st
    push = st is not None and not getattr(_tls, "mode_on", False)
    mode = None
    if push:
        mode = CastMode()
        mode.__enter__()
        _tls.mode_on = True
    if replay:
        _tls.replay = getattr(_tls, "replay", 0) + 1
    try:
        yield
    finally:
        if replay:
            _tls.replay -= 1
        if mode is not None:
            _tls.mode_on = False
            mode.__exit__(None, None, None)
        _tls.state = prev


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """``paddle.amp.auto_cast``: cast by the JAX package's lists while
    the block runs, in the calling thread. ``enable=False`` turns the
    cast off inside an enclosing block. ``use_promote`` is taken and
    kept (the JAX package's cast does not read it either)."""
    st = (_AmpState(enable, core.convert_dtype(dtype), level,
                    custom_white_list, custom_black_list, use_promote)
          if enable else None)
    with _entered(st):
        yield


amp_guard = auto_cast  # the legacy name


def bind_amp_state(fn: Callable) -> Callable:
    """``fn`` bound to the calling thread's AMP state: it runs under that
    state wherever and whenever it is called, the backward included.
    Activation recomputation wraps the forward it will repeat in it, as
    the JAX package's remat repeats a forward whose casts its trace
    fixed."""
    st = amp_state()
    if st is None:
        return fn

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with _entered(st, replay=True):
            return fn(*args, **kwargs)
    return run
