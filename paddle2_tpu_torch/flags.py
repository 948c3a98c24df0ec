"""Global flag registry: the counterpart of ``paddle2_tpu/flags.py``.

The registry (``define_flag``, ``set_flags``, ``get_flags``,
``flag_value``) keeps the JAX package's contract: each flag is typed by
its default, an environment variable ``FLAGS_<name>`` overrides the
default when the flag is defined, a string sets a bool flag true when it
reads ``1``, ``true``, ``yes`` or ``on``, and a flag's ``on_change`` hook
runs after ``set_flags`` sets it.

All twelve of the JAX package's core flags are registered under its
names, defaults and types. Four act on the port: ``check_nan_inf``
(``ops/dispatch.py``), ``conv_prefer_channels_last``
(``nn/functional/conv.py``), ``log_level`` (the ``paddle2_tpu_torch``
logger) and the two kernel routes ``pallas_layer_norm`` and
``fused_optimizer_step``. The XLA-only ones are registered so that a
script setting them runs, and are read nowhere; each one's help says
what it does on the port. The flags that subsystems define beside their
modules (the distributed watchdog's, fault tolerance's) come with those
modules.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

__all__ = ["define_flag", "set_flags", "get_flags", "flag_value"]


class _Flag:
    __slots__ = ("value", "default", "type", "help", "on_change")

    def __init__(self, default: Any, help_str: str,
                 on_change: Optional[Callable[[Any], None]]):
        self.value = default
        self.default = default
        self.type = type(default)
        self.help = help_str
        self.on_change = on_change


_REGISTRY: Dict[str, _Flag] = {}
_LOCK = threading.RLock()


def _coerce(flag: _Flag, value: Any) -> Any:
    if flag.type is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "on")
    return flag.type(value)


def _key(name: str) -> str:
    key = name[6:] if name.startswith("FLAGS_") else name
    if key not in _REGISTRY:
        raise ValueError(f"unknown flag {name!r}")
    return key


def define_flag(name: str, default: Any, help_str: str = "",
                on_change: Optional[Callable[[Any], None]] = None) -> None:
    """Register a flag; ``FLAGS_<name>`` in the environment overrides
    the default (and runs ``on_change`` with it). Defining a name twice
    keeps the first."""
    with _LOCK:
        if name in _REGISTRY:
            return
        flag = _Flag(default, help_str, on_change)
        env = os.environ.get("FLAGS_" + name)
        if env is not None:
            flag.value = _coerce(flag, env)
        _REGISTRY[name] = flag
        if env is not None and on_change is not None:
            on_change(flag.value)


def set_flags(flags: Dict[str, Any]) -> None:
    """Set registered flags, by name with or without ``FLAGS_``."""
    with _LOCK:
        for name, value in flags.items():
            flag = _REGISTRY[_key(name)]
            flag.value = _coerce(flag, value)
            if flag.on_change is not None:
                flag.on_change(flag.value)


def get_flags(flags: Union[str, Iterable[str], None] = None
              ) -> Dict[str, Any]:
    """``{"FLAGS_<name>": value}`` for the named flags (all when None)."""
    with _LOCK:
        if flags is None:
            names: List[str] = list(_REGISTRY)
        elif isinstance(flags, str):
            names = [flags]
        else:
            names = list(flags)
        keys = [_key(n) for n in names]
        return {"FLAGS_" + k: _REGISTRY[k].value for k in keys}


def flag_value(name: str) -> Any:
    """The value of one flag, for the port's own reads."""
    return _REGISTRY[name].value


def _check_nan_inf(on: bool) -> None:
    from .ops.dispatch import set_check_nan_inf
    set_check_nan_inf(on)


LOGGER = logging.getLogger("paddle2_tpu_torch")


def _log_level(level: int) -> None:
    LOGGER.setLevel(logging.WARNING if level <= 0 else
                    logging.INFO if level == 1 else logging.DEBUG)


define_flag("check_nan_inf", False,
            "Check the floating outputs of every op for NaN and infinity "
            "and raise FloatingPointError naming the first op that holds "
            "one, forward and backward: a TorchDispatchMode over every "
            "aten op, and each CUDA kernel's wrapper over its own outputs "
            "(ops/dispatch.py). One host synchronization an op; off by "
            "default.", on_change=_check_nan_inf)
define_flag("enable_api_kernel_fallback", True,
            "Registered for scripts that set it; read nowhere. The port "
            "never moves work to the CPU: an op the card cannot run "
            "raises.")
define_flag("eager_vjp_cache", True,
            "Registered for scripts that set it; read nowhere. The port's "
            "tape is torch.autograd, which keeps no linearized programs "
            "to cache.")
define_flag("log_level", 0,
            "Verbosity of the 'paddle2_tpu_torch' logger: 0 warnings, 1 "
            "info, 2 and above debug.", on_change=_log_level)
define_flag("compilation_cache_dir", os.environ.get(
    "PADDLE2_TPU_CACHE_DIR", ""),
    "Registered for scripts that set it; read nowhere. There is no XLA "
    "compilation to cache: the port's CUDA kernels are built once by "
    "nvcc into build/paddle2_tpu_torch/, keyed by their sources "
    "(kernels/_build.py).")
define_flag("conv_prefer_channels_last", False,
            "Run NCHW conv2d in NHWC inside (torch.channels_last on input "
            "and weight) and return NCHW; the same result within the "
            "convolution's tolerance. Off by default.")
define_flag("pallas_layer_norm", False,
            "Route last-axis affine LayerNorm (one normalized axis, weight "
            "and bias given, H <= 8192) through the fused LayerNorm op "
            "(kernels/fused_layer_norm.py): the CUDA kernels for a CUDA "
            "tensor, their plain versions for a CPU tensor. Off by "
            "default, as in the JAX package.")
define_flag("max_program_cache_size", 32,
            "Registered for scripts that set it; read nowhere until "
            "jit.to_static is ported (ROADMAP queue 1 item 3).")
define_flag("donate_optimizer_buffers", True,
            "Registered for scripts that set it; read nowhere. The port's "
            "optimizers update their parameters in place already.")
define_flag("fused_optimizer_step", False,
            "Route AdamW and Momentum updates through their one-pass step "
            "kernels (kernels/fused_adamw.py, kernels/fused_momentum.py) "
            "when the optimizer's fused= is None; an explicit fused= wins "
            "either way.")
define_flag("xla_latency_hiding_scheduler", True,
            "Registered for scripts that set it; read nowhere. An XLA "
            "scheduler option; the port has no XLA.")
define_flag("xla_async_collectives", True,
            "Registered for scripts that set it; read nowhere. An XLA "
            "collective lowering option; the port has no XLA.")
