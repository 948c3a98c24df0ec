"""The fused (Nesterov) momentum step: the CUDA kernel, its wrapper and
its plain version.

Counterpart of ``fused_momentum_step`` in
``paddle2_tpu/kernels/pallas_fused.py``. The kernel is
``csrc/momentum_step.cu``: one pass over flat f32 ``(p, g, v)`` that
writes ``(p, v)`` in place, in the exact op order of the port's eager
Momentum (:mod:`paddle2_tpu_torch.optimizer.optimizers`: L2 decay folded
into the gradient, then the velocity, then the parameter), so the two
agree bitwise on f32 state. ``lr``, ``momentum`` and ``weight_decay``
are rounded to f32 on the host, as the Pallas wrapper stages them and as
torch rounds a Python scalar against an f32 tensor.

A CPU tensor runs :func:`momentum_step_reference`; a CUDA tensor
launches the kernel or raises.
"""

import ctypes

import numpy as np
import torch

from . import _build
from .fused_adamw import adamw_step_supported

__all__ = ["momentum_step_supported", "momentum_step",
           "momentum_step_reference"]

_F = ctypes.c_float
_SIGNATURES = {"momentum_step": [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
               + [_F] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}

# the same gate as AdamW's (pallas_fused.py:156): an f32 working param
# (a plain f32 param or the multi-precision master) and an f32 grad
momentum_step_supported = adamw_step_supported


def _f32(x) -> float:
    return float(np.float32(x))


def momentum_step_reference(p, g, v, lr, momentum, nesterov,
                            weight_decay) -> None:
    """The plain version, in place, one torch op per kernel operation."""
    lr, momentum, weight_decay = (_f32(x) for x in
                                  (lr, momentum, weight_decay))
    if weight_decay:
        g = g + weight_decay * p
    v_new = momentum * v + g
    if nesterov:
        p_new = p - lr * (g + momentum * v_new)
    else:
        p_new = p - lr * v_new
    p.copy_(p_new)
    v.copy_(v_new)


def momentum_step(p, g, v, lr, momentum, nesterov=False,
                  weight_decay=0.0) -> None:
    """One momentum step on f32 ``(p, g, v)`` of one shape, updating
    ``p`` and ``v`` in place. ``weight_decay=0.0`` skips the L2 fold
    (the eager ``if wd and decay`` branch).
    ``momentum_step.launches`` counts the kernel's launches."""
    if not (p.shape == g.shape == v.shape):
        raise ValueError("p, g and v must have one shape")
    if not all(t.dtype == torch.float32 for t in (p, g, v)):
        raise ValueError("momentum_step takes float32 p, g and v")
    if not (p.device == g.device == v.device):
        raise ValueError("p, g and v must lie on one device")
    if not _build.on_card("momentum_step", p, g, v):
        momentum_step_reference(p, g, v, lr, momentum, nesterov,
                                weight_decay)
        return
    wd = _f32(weight_decay)
    lib = _build.library("momentum_step", _SIGNATURES)
    with torch.cuda.device(p.device):
        err = lib.momentum_step(
            p.data_ptr(), g.data_ptr(), v.data_ptr(), p.numel(), _f32(lr),
            _f32(momentum), wd, int(bool(nesterov)), int(bool(wd)),
            torch.cuda.current_stream(p.device).cuda_stream)
    _build.check(lib, err, "momentum_step")
    momentum_step.launches += 1


momentum_step.launches = 0
