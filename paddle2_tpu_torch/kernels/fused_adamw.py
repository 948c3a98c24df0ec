"""The fused AdamW step: the CUDA kernel, its wrapper and its plain
version.

Counterpart of ``fused_adamw_step`` and ``adamw_step_supported`` in
``paddle2_tpu/kernels/pallas_fused.py``. The kernel is
``csrc/adamw_step.cu``: one pass over flat f32 ``(p, g, m, v)`` that
writes ``(p, m, v)`` in place, in the exact op order of the port's eager
AdamW (:mod:`paddle2_tpu_torch.optimizer.optimizers`), so the two agree
bitwise on f32 state. The scalars are staged on the host in f32 by
:func:`stage_scalars`, as the Pallas wrapper stages them.

A CPU tensor runs :func:`adamw_step_reference`; a CUDA tensor launches
the kernel or raises.
"""

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _build

__all__ = ["AdamWScalars", "stage_scalars", "adamw_step_supported",
           "adamw_step", "adamw_step_reference"]

_F = ctypes.c_float
_SIGNATURES = {"adamw_step": [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
               + [_F] * 9 + [ctypes.c_int, ctypes.c_void_p]}


class AdamWScalars(NamedTuple):
    """The step's scalars, each a Python float that is exactly an f32
    value: what the kernel receives and what the plain version uses."""
    lr: float
    b1: float
    om1: float      # 1 - b1, from the Python double
    b2: float
    om2: float
    eps: float
    wd: float
    bc1: float      # 1 - b1**t in f32
    bc2: float


def stage_scalars(lr, beta1, beta2, eps, weight_decay, step
                  ) -> AdamWScalars:
    """Stage the scalars as ``pallas_fused.py:176-186`` does: ``1 - b``
    rounded from the Python double (the eager expression's constant),
    the bias corrections ``1 - b**t`` computed in f32 from the integer
    step."""
    f = np.float32
    t = f(step)
    return AdamWScalars(*(float(x) for x in (
        f(lr), f(beta1), f(1 - beta1), f(beta2), f(1 - beta2), f(eps),
        f(weight_decay), f(1) - f(beta1) ** t, f(1) - f(beta2) ** t)))


def adamw_step_supported(work, grad) -> bool:
    """The kernel serves f32 math on contiguous tensors: an f32 working
    param (a plain f32 param or the multi-precision master) and an f32
    grad (the master path casts explicitly, as the eager path does)."""
    return (work.dtype == torch.float32 and grad.dtype == torch.float32
            and work.is_contiguous() and grad.is_contiguous())


def adamw_step_reference(p, g, m, v, sc: AdamWScalars,
                         apply_wd: bool) -> None:
    """The plain version, in place, one torch op per kernel operation.
    The bias corrections divide by a tensor on ``m``'s device: torch on
    CUDA turns division by a host scalar into a multiplication by its
    reciprocal, which rounds differently."""
    bc1 = torch.tensor(sc.bc1, dtype=torch.float32, device=m.device)
    bc2 = torch.tensor(sc.bc2, dtype=torch.float32, device=m.device)
    m_new = sc.b1 * m + sc.om1 * g
    v_new = sc.b2 * v + sc.om2 * (g * g)
    mhat = m_new / bc1
    vhat = v_new / bc2
    p_new = p - (sc.lr * mhat) / (torch.sqrt(vhat) + sc.eps)
    if apply_wd:
        p_new = p_new - float(np.float32(sc.lr) * np.float32(sc.wd)) * p
    p.copy_(p_new)
    m.copy_(m_new)
    v.copy_(v_new)


def adamw_step(p, g, m, v, sc: AdamWScalars, apply_wd: bool) -> None:
    """One AdamW step on f32 ``(p, g, m, v)`` of one shape, updating
    ``p``, ``m`` and ``v`` in place. ``apply_wd=False`` skips the decay
    subtract (the eager ``if wd and decay`` branch).
    ``adamw_step.launches`` counts the kernel's launches."""
    if not (p.shape == g.shape == m.shape == v.shape):
        raise ValueError("p, g, m and v must have one shape")
    if not all(t.dtype == torch.float32 for t in (p, g, m, v)):
        raise ValueError("adamw_step takes float32 p, g, m and v")
    if not (p.device == g.device == m.device == v.device):
        raise ValueError("p, g, m and v must lie on one device")
    if p.device.type == "cpu":
        adamw_step_reference(p, g, m, v, sc, apply_wd)
        return
    if p.device.type != "cuda":
        raise ValueError(f"unsupported device {p.device}")
    if not all(t.is_contiguous() for t in (p, g, m, v)):
        raise ValueError("adamw_step needs contiguous tensors")
    lib = _build.library("adamw_step", _SIGNATURES)
    with torch.cuda.device(p.device):
        err = lib.adamw_step(
            p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            p.numel(), *sc, int(bool(apply_wd)),
            torch.cuda.current_stream(p.device).cuda_stream)
    _build.check(lib, err, "adamw_step")
    adamw_step.launches += 1


adamw_step.launches = 0
