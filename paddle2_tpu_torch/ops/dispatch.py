"""The finite check (``FLAGS_check_nan_inf``) and operand coercion: the
part of ``paddle2_tpu/ops/dispatch.py`` the port needs now.

**The finite check.** The JAX package checks the forward output of every
op it dispatches and every gradient its tape computes. The port's models
call torch directly, not the port's op functions, so the check sits
under torch: while the flag is on, a ``TorchDispatchMode`` is pushed
(:class:`FiniteCheckMode`) that checks the floating outputs of every
aten op the process runs, forward and backward alike (autograd carries
the mode into its device threads), and raises ``FloatingPointError``
naming the first op whose output holds a NaN or an infinity. A CUDA
kernel launched through the C interface (``kernels/_build.py``) is
invisible to the mode; its wrapper is decorated with
:func:`checks_outputs`, which, while the flag is on, runs the wrapper
with the mode suspended and checks the wrapper's outputs, naming the
kernel. The plain version behind a wrapper (the CPU path) is checked the
same way, so an internal ``-inf`` mask is not taken for a fault, and so
is every plain route that builds its own ``-inf`` pad or mask (max
pooling's uneven pads, ``flash_attention``'s probabilities, the
densified varlen route, ``flashmask_attention`` and
``sparse_attention``, the plain split-K paged decode): as in the JAX
package, which checks the ops it dispatches and not their insides. The
check reads every output back to the host, one synchronization an op; it
is off by default, as in the JAX package.

**The AMP cast** (``dispatch.py:35-60, :170-175``). Under
``paddle.amp.auto_cast`` each op of the library casts its floating
tensor arguments by the name the JAX package dispatches it under, with
the JAX package's rule (:mod:`paddle2_tpu_torch.amp.casting`), and
runs its body uncast: :func:`cast_op_library` wraps every op of the
library in :func:`~paddle2_tpu_torch.amp.casting.amp_op`. The name is
the op's own, but for the ops the JAX package dispatches under another
(:data:`DISPATCHED_AS`: ``mm`` and ``bmm`` as ``matmul``, ``unbind``
as ``unstack`` ...; ``pow`` by its exponent, :data:`DISPATCHED_BY`) and
the ones it runs without its dispatcher
(:data:`NOT_DISPATCHED`: creation from shapes, random draws, queries,
in-place fills), which take no cast. The static recorder comes with
``static/`` (ROADMAP queue 1 item 9).
"""

from __future__ import annotations

import functools
import inspect
import threading
from typing import Any, Callable, Optional

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from ..amp.casting import amp_op, cast_call
from ..framework import core

__all__ = ["FiniteCheckMode", "check_finite", "checks_outputs",
           "set_check_nan_inf", "ensure_tensor", "promote",
           "cast_op_library", "DISPATCHED_AS", "DISPATCHED_BY",
           "NOT_DISPATCHED"]

# ops whose outputs are uninitialized memory (nothing to check yet)
_UNCHECKED = frozenset({"empty", "empty_like", "empty_strided",
                        "new_empty", "new_empty_strided",
                        "empty_permuted", "resize_", "set_"})


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return []


def check_finite(name: str, out: Any) -> None:
    """Raise ``FloatingPointError`` naming ``name`` when a floating or
    complex tensor in ``out`` (a tensor, or nested tuples and lists of
    them) holds a NaN or an infinity."""
    for i, t in enumerate(_flat(out)):
        if not ((t.is_floating_point() or t.is_complex()) and t.numel()
                and t.device.type != "meta"):
            continue
        with _disable_current_modes():      # the check is not checked
            finite = bool(torch.isfinite(t).all())
        if not finite:
            node = getattr(torch._C, "_current_autograd_node", None)
            node = node() if node is not None else None
            where = f" in the backward of {node.name()}" if node else ""
            raise FloatingPointError(
                f"nan/inf in output {i} of op '{name}'{where} "
                f"(FLAGS_check_nan_inf is enabled)")


class FiniteCheckMode(TorchDispatchMode):
    """Checks the outputs of every aten op run under it."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        packet = func.overloadpacket
        if packet.__name__ not in _UNCHECKED:
            check_finite(str(packet), out)
        return out


_lock = threading.Lock()
_mode: Optional[FiniteCheckMode] = None
_checking = False


def set_check_nan_inf(on: bool) -> None:
    """Push (on) or pop (off) the check's dispatch mode in the calling
    thread; the flag's ``on_change`` hook."""
    global _mode, _checking
    with _lock:
        _checking = bool(on)
        if on and _mode is None:
            _mode = FiniteCheckMode()
            _mode.__enter__()
        elif not on and _mode is not None:
            mode, _mode = _mode, None
            mode.__exit__(None, None, None)


def checks_outputs(name: str, pick: Optional[Callable] = None):
    """Decorator for a kernel wrapper: while ``FLAGS_check_nan_inf`` is
    on, run it with the dispatch mode suspended and check what it
    returns (``pick(result, *args, **kwargs)`` where the outputs are not
    the result, e.g. an in-place step), naming ``name``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _checking:
                return fn(*args, **kwargs)
            with _disable_current_modes():
                out = fn(*args, **kwargs)
            check_finite(name, out if pick is None
                         else pick(out, *args, **kwargs))
            return out
        return wrapper
    return deco


# ------------------------------------------------------ operand coercion

def ensure_tensor(x: Any, ref: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """A tensor for ``x``: a Python scalar or array takes ``ref``'s device
    (else the current place) and, as in the JAX package, ``ref``'s dtype
    where it is an int, or a float beside a floating ``ref``; otherwise
    the x32 and default-dtype rules."""
    if isinstance(x, torch.Tensor):
        return x
    dtype = None
    if (ref is not None and isinstance(x, (int, float))
            and not isinstance(x, bool)):
        ref_float = ref.is_floating_point() or ref.is_complex()
        if isinstance(x, int) or ref_float:
            dtype = ref.dtype
    place = ref.device if ref is not None else None
    return core.to_torch_tensor(x, dtype, place)


def promote(*ts: torch.Tensor):
    """The tensors cast to their common dtype (the JAX package's binary
    promotion: a 0-d tensor promotes like any other, unlike torch's
    scalar-like rule)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        if t.dtype != dt:
            dt = torch.promote_types(dt, t.dtype)
    return tuple(t if t.dtype == dt else t.to(dt) for t in ts)


# ------------------------------------------------------------ AMP cast

# ops the JAX package dispatches under another op's name
DISPATCHED_AS = {
    "bmm": "matmul", "mm": "matmul", "mv": "matmul",
    "broadcast_tensors": "expand", "broadcast_to": "expand",
    "expand_as": "expand", "bucketize": "searchsorted", "chunk": "split",
    "index_select": "gather", "unbind": "unstack", "view_as": "reshape",
    "pad_basic": "pad", "ormqr": "householder_product",
}

# ops the JAX package runs without its dispatcher: no AMP cast
NOT_DISPATCHED = frozenset({
    "CUDAPinnedPlace", "LazyGuard", "arange", "as_tensor", "batch",
    "create_parameter",
    "bernoulli", "bernoulli_", "binomial", "broadcast_shape", "cauchy_",
    "check_shape", "disable_signal_handler", "dtype", "eig", "eigvals",
    "empty", "empty_like", "exponential_", "eye", "float8_e4m3fn",
    "float8_e5m2", "flops", "full", "full_like", "geometric_",
    "get_cuda_rng_state", "histogram_bin_edges", "histogramdd",
    "increment", "index_add_", "index_fill_", "index_put_", "is_complex",
    "is_empty", "is_floating_point", "is_integer", "is_tensor",
    "linspace", "log_normal", "log_normal_", "logspace", "lu",
    "lu_unpack", "masked_scatter", "mode", "multinomial", "nonzero",
    "normal", "normal_", "numel", "ones", "ones_like", "poisson", "rand",
    "randint", "randint_like", "randn", "randperm", "rank", "reshape_",
    "scatter_", "set_cuda_rng_state", "set_printoptions", "shape",
    "squeeze_", "standard_gamma", "standard_normal", "to_tensor",
    "tolist", "top_p_sampling", "tril_indices", "triu_indices", "uniform",
    "uniform_", "unique", "unique_consecutive", "unsqueeze_", "where_",
    "zeros", "zeros_like",
})


def _pow_name(x, y, *args, **kwargs) -> str:
    """``pow`` dispatches as ``"pow"`` for a Python int exponent and as
    ``"pow_op"`` otherwise, as in the JAX package (both black-listed)."""
    return "pow" if isinstance(y, int) and not isinstance(y, bool) \
        else "pow_op"


def _arg(args, kwargs, i, name, default=None):
    return args[i] if len(args) > i else kwargs.get(name, default)


# ops whose JAX name depends on their arguments: op -> name(*args, **kw),
# None where the JAX op dispatches nothing for those arguments
DISPATCHED_BY = {
    "pow": _pow_name,
    # a tensor of fewer than 2 dims is cloned
    "t": lambda x, *a, **k: "clone" if getattr(x, "ndim", 2) < 2 else "t",
    # where(condition) is nonzero's, outside the dispatcher
    "where": lambda c, *a, **k: None if _arg(a, k, 0, "x") is None and
    _arg(a, k, 1, "y") is None else "where",
    # a list or tuple reshapes; a dtype reinterprets
    "view": lambda x, sd, *a, **k: "reshape" if isinstance(sd, (list, tuple))
    else "view_dtype",
    # tensors of two shapes compare unequal without a dispatch
    "equal_all": lambda x, y, *a, **k: "equal_all" if tuple(
        getattr(x, "shape", ())) == tuple(getattr(y, "shape", ()))
    else None,
    "bitwise_right_shift": lambda x, y, *a, **k: "bitwise_right_shift"
    if _arg(a, k, 0, "is_arithmetic", True) else
    "bitwise_right_shift_logical",
}


def _by_args(namer, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        name = namer(*args, **kwargs)
        if name is None:
            return fn(*args, **kwargs)
        return cast_call(name, fn, *args, **kwargs)
    wrapper.amp_name = namer
    return wrapper


def cast_op_library(modules) -> None:
    """Wrap every function each module of ``modules`` exports (its
    ``__all__``) in :func:`~paddle2_tpu_torch.amp.casting.amp_op`
    under the name the JAX package dispatches it by, in place, so the
    package's re-exports, the tensor methods and the calls between ops
    all cast; an op inside another runs uncast, as it does in the JAX
    package."""
    for mod in modules:
        for name in mod.__all__:
            fn = getattr(mod, name)
            if name in NOT_DISPATCHED or not inspect.isfunction(fn) or \
                    hasattr(fn, "amp_name"):
                continue
            if name in DISPATCHED_BY:
                setattr(mod, name, _by_args(DISPATCHED_BY[name], fn))
            else:
                setattr(mod, name, amp_op(DISPATCHED_AS.get(name, name))(fn))
