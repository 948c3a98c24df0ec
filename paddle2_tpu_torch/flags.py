"""Global flag registry: the counterpart of ``paddle2_tpu/flags.py``.

The registry (``define_flag``, ``set_flags``, ``get_flags``,
``flag_value``) keeps the JAX package's contract: each flag is typed by
its default, an environment variable ``FLAGS_<name>`` overrides the
default when the flag is defined, and a string sets a bool flag true
when it reads ``1``, ``true``, ``yes`` or ``on``.

Only the flags the port reads are defined. The JAX package's compiler
flags (the XLA compilation cache, the multichip XLA environment) have no
counterpart here, and neither has their ``on_change`` hook: a flag's
help text is taken, for the signature, and not kept.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Iterable, List, Union

__all__ = ["define_flag", "set_flags", "get_flags", "flag_value"]


class _Flag:
    __slots__ = ("value", "type")

    def __init__(self, default: Any):
        self.value = default
        self.type = type(default)


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


def define_flag(name: str, default: Any, help_str: str = "") -> None:
    """Register a flag; ``FLAGS_<name>`` in the environment overrides
    the default. Defining a name twice keeps the first."""
    with _LOCK:
        if name in _REGISTRY:
            return
        flag = _Flag(default)
        env = os.environ.get("FLAGS_" + name)
        if env is not None:
            flag.value = _coerce(flag, env)
        _REGISTRY[name] = flag


def set_flags(flags: Dict[str, Any]) -> None:
    """Set registered flags, by name with or without ``FLAGS_``."""
    with _LOCK:
        for name, value in flags.items():
            flag = _REGISTRY[_key(name)]
            flag.value = _coerce(flag, value)


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


define_flag("pallas_layer_norm", False,
            "Route last-axis affine LayerNorm (one normalized axis, weight "
            "and bias given, H <= 8192) through the fused LayerNorm op "
            "(kernels/fused_layer_norm.py): the CUDA kernels for a CUDA "
            "tensor, their plain versions for a CPU tensor. Off by "
            "default, as in the JAX package.")
define_flag("fused_optimizer_step", False,
            "Route AdamW and Momentum updates through their one-pass step "
            "kernels (kernels/fused_adamw.py, kernels/fused_momentum.py) "
            "when the optimizer's fused= is None; an explicit fused= wins "
            "either way.")
