"""The two fused AdamW kernels: their wrappers and their plain versions.

``adamw_step`` is the counterpart of ``fused_adamw_step`` and
``adamw_step_supported`` in ``paddle2_tpu/kernels/pallas_fused.py``.
Its kernel is ``csrc/adamw_step.cu``: one pass over flat f32
``(p, g, m, v)`` that writes ``(p, m, v)`` in place, in the exact op
order of the port's eager AdamW
(:mod:`paddle2_tpu_torch.optimizer.optimizers`), so the two agree
bitwise on f32 state. The scalars are staged on the host in f32 by
:func:`stage_scalars`, as the Pallas wrapper stages them.

``adamw_flat`` is the counterpart of ``fused_adamw`` (``_adamw_kernel``)
there, the flat AdamW with an f32 master copy that
``incubate.nn.functional.fused_adamw_kernel`` calls. Its kernel is
``csrc/adamw_flat.cu``: one pass reads ``(g, m, v, master)`` and writes
four new tensors ``(p, m, v, master)``, with the decay folded into the
update (another rounding order than the eager AdamW's). The param is
not read: it fixes only p's dtype and shape. Its scalars come from
:func:`stage_flat_scalars`.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel
or raises.
"""

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _build

__all__ = ["AdamWScalars", "stage_scalars", "adamw_step_supported",
           "adamw_step", "adamw_step_reference", "stage_flat_scalars",
           "adamw_flat", "adamw_flat_reference", "fused_adamw"]

_F = ctypes.c_float
_SIGNATURES = {"adamw_step": [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
               + [_F] * 9 + [ctypes.c_int, ctypes.c_void_p]}
# g, m, v, master, p', m', v', master', n, p dtype, g dtype, 9 scalars,
# stream
_FLAT_SIGNATURES = {"adamw_flat": [ctypes.c_void_p] * 8 + [ctypes.c_longlong]
                    + [ctypes.c_int] * 2 + [_F] * 9 + [ctypes.c_void_p]}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


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


# ------------------------------------------------------------ flat AdamW

def stage_flat_scalars(lr, beta1, beta2, eps, weight_decay, step
                       ) -> AdamWScalars:
    """Stage the scalars as ``fused_adamw`` (``pallas_fused.py:74-78``)
    and ``_adamw_kernel`` have them: every one in f32, ``1 - b`` as the
    kernel's f32 subtraction ``f32(1) - f32(b)`` (not the rounding of
    the Python double that :func:`stage_scalars` takes), the bias
    corrections ``1 - b**t`` in f32 from the step."""
    f = np.float32
    t = f(step)
    return AdamWScalars(*(float(x) for x in (
        f(lr), f(beta1), f(1) - f(beta1), f(beta2), f(1) - f(beta2),
        f(eps), f(weight_decay), f(1) - f(beta1) ** t,
        f(1) - f(beta2) ** t)))


def _check_flat(param, grad, m, v, master) -> None:
    n = param.numel()
    if any(t.numel() != n for t in (grad, m, v, master)):
        raise ValueError(
            f"param, grad, m, v and master must have one size; got "
            f"{[tuple(t.shape) for t in (param, grad, m, v, master)]}")
    if any(t.dtype not in _DTYPE_CODE
           for t in (param, grad, m, v, master)):
        raise ValueError(
            f"the flat AdamW takes float32/bfloat16/float16 tensors; got "
            f"{[t.dtype for t in (param, grad, m, v, master)]}")
    if len({t.device for t in (param, grad, m, v, master)}) != 1:
        raise ValueError("param, grad, m, v and master must lie on one "
                         "device")
    if not all(t.is_contiguous() for t in (param, grad, m, v, master)):
        raise ValueError("the flat AdamW needs contiguous tensors")


def adamw_flat_reference(param, grad, m, v, master, sc: AdamWScalars):
    """The plain version, one torch op per kernel operation; returns new
    ``(p, m, v, master)``: p in param's dtype and shape, the rest f32.
    The bias corrections divide by a tensor on the state's device, as in
    :func:`adamw_step_reference`."""
    bc1 = torch.tensor(sc.bc1, dtype=torch.float32, device=m.device)
    bc2 = torch.tensor(sc.bc2, dtype=torch.float32, device=m.device)
    g = grad.reshape(param.shape).float()
    mw = master.reshape(param.shape).float()
    m_new = sc.b1 * m.reshape(param.shape).float() + sc.om1 * g
    v_new = sc.b2 * v.reshape(param.shape).float() + sc.om2 * g * g
    upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + sc.eps) + sc.wd * mw
    mw_new = mw - sc.lr * upd
    return mw_new.to(param.dtype), m_new, v_new, mw_new


def adamw_flat(param, grad, m, v, master, sc: AdamWScalars):
    """One flat AdamW step; returns new ``(p, m, v, master)`` (p in
    param's dtype, the rest f32, all of param's shape) and updates
    nothing in place. m, v and master of a half dtype are widened to f32
    first (exactly). ``adamw_flat.launches`` counts the kernel's
    launches."""
    _check_flat(param, grad, m, v, master)
    if not _build.on_card("adamw_flat", param, grad, m, v, master):
        return adamw_flat_reference(param, grad, m, v, master, sc)
    m, v, master = (t.float() for t in (m, v, master))
    outs = (torch.empty_like(param),) + tuple(
        torch.empty(param.shape, dtype=torch.float32, device=param.device)
        for _ in range(3))
    lib = _build.library("adamw_flat", _FLAT_SIGNATURES)
    with torch.cuda.device(param.device):
        err = lib.adamw_flat(
            grad.data_ptr(), m.data_ptr(), v.data_ptr(), master.data_ptr(),
            *(t.data_ptr() for t in outs), param.numel(),
            _DTYPE_CODE[param.dtype], _DTYPE_CODE[grad.dtype], *sc,
            torch.cuda.current_stream(param.device).cuda_stream)
    _build.check(lib, err, "adamw_flat")
    adamw_flat.launches += 1
    return outs


adamw_flat.launches = 0


def fused_adamw(param, grad, m, v, master, lr, beta1=0.9, beta2=0.999,
                eps=1e-8, weight_decay=0.01, step=1):
    """``pallas_fused.fused_adamw``'s counterpart: decoupled-decay Adam
    with an f32 master in one pass; returns ``(p, m, v, master)``."""
    return adamw_flat(param, grad, m, v, master, stage_flat_scalars(
        lr, beta1, beta2, eps, weight_decay, step))
