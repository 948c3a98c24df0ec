"""The two fused AdamW kernels: their wrappers and their plain versions.

``adamw_step_multi`` is the counterpart of ``fused_adamw_step`` in
``paddle2_tpu/kernels/pallas_fused.py``, which the JAX optimizer calls
once per leaf (``adamw_multi_supported`` is ``adamw_step_supported``'s,
for a list). Its kernel is
``csrc/adamw_step.cu``: one launch over a table of tensors, each a flat
f32 working parameter (a plain f32 parameter or the multi-precision
master), m and v updated in place, a gradient read in its stored dtype
(f32, or the bf16/f16 gradient of a parameter with an f32 master,
widened exactly), its own decay flag, and optionally that bf16/f16
parameter written from the new master; in the exact op order of the
port's eager AdamW (:mod:`paddle2_tpu_torch.optimizer.optimizers`), so
the two agree bitwise. :func:`adamw_step` is the same over a list of
one. The scalars are staged on the host in f32 by
:func:`stage_scalars`, as the Pallas wrapper stages them.

``adamw_flat`` is the counterpart of ``fused_adamw`` (``_adamw_kernel``)
there, the flat AdamW with an f32 master copy that
``incubate.nn.functional.fused_adamw_kernel`` calls. Its kernel is
``csrc/adamw_flat.cu``: one pass reads ``(g, m, v, master)`` and writes
four new tensors ``(p, m, v, master)``, with the decay folded into the
update (another rounding order than the eager AdamW's). The param is
not read: it fixes only p's dtype and shape. Its scalars come from
:func:`stage_flat_scalars`. Two routes, one C entry each: "vec"
(``adamw_flat_vec``, 8 elements a thread a step in 16-byte loads and
stores) when all eight tensors start on a 16-byte boundary, else
"general" (``adamw_flat``, one element a thread an iteration); both run
the same arithmetic.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel
or raises.
"""

import ctypes
from typing import Dict, NamedTuple

import numpy as np
import torch

from . import _build

__all__ = ["AdamWScalars", "stage_scalars", "adamw_multi_supported", "adamw_step_multi",
           "adamw_step_multi_reference", "adamw_step",
           "adamw_step_reference", "stage_flat_scalars", "adamw_flat",
           "adamw_flat_reference", "flat_route", "fused_adamw",
           "MAX_TENSORS", "FLAT_ROUTES"]

_F = ctypes.c_float
# descs, count, the 9 scalars, stream
_SIGNATURES = {"adamw_step_multi": [ctypes.c_void_p, ctypes.c_int]
               + [_F] * 9 + [ctypes.c_void_p]}
# g, m, v, master, p', m', v', master', n, p dtype, g dtype, 9 scalars,
# stream; the vector route's entry takes the same
_FLAT_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 2
              + [_F] * 9 + [ctypes.c_void_p])
_FLAT_SIGNATURES = {"adamw_flat": _FLAT_ARGS, "adamw_flat_vec": _FLAT_ARGS}
# the flat AdamW's routes, by their C entries
FLAT_ROUTES = {"vec": "adamw_flat_vec", "general": "adamw_flat"}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_F32 = torch.float32
# one launch takes at most this many tensors (csrc/adamw_step.cu
# MAX_TENSORS: the table is one kernel parameter); longer lists take one
# launch per MAX_TENSORS
MAX_TENSORS = 256
# the kernel's tensor record (csrc/adamw_step.cu `Desc`)
_DESC = np.dtype([("work", "<u8"), ("m", "<u8"), ("v", "<u8"),
                  ("grad", "<u8"), ("low", "<u8"), ("n", "<i8"),
                  ("codes", "<i4"), ("pad", "<i4")])
# the descriptor tables, keyed by their records (pointers, sizes, codes):
# an optimizer's tensors keep their storage from step to step, so a step
# refills nothing; a changed pointer makes a new table
_TABLES: Dict[tuple, np.ndarray] = {}
_MAX_TABLES = 64


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


def adamw_multi_supported(work, grad, m, v, low=None) -> bool:
    """Whether the multi-tensor kernel takes this tensor: an f32 working
    parameter (a plain f32 parameter or the multi-precision master), f32
    m and v, a gradient in f32 (in bf16/f16 only beside a parameter
    ``low`` of that dtype, whose master ``work`` is), all contiguous, of
    one size and on one device. The optimizer asks this once a tensor a
    step, so it reads only what it must."""
    n, dev = work.numel(), work.get_device()
    if low is None:
        if grad.dtype is not _F32:
            return False
    elif not ((low.dtype is torch.bfloat16 or low.dtype is torch.float16)
              and (grad.dtype is _F32 or grad.dtype is low.dtype)
              and low.numel() == n and low.get_device() == dev
              and low.is_contiguous()):
        return False
    return (work.dtype is _F32 and m.dtype is _F32 and v.dtype is _F32
            and grad.numel() == n and m.numel() == n and v.numel() == n
            and grad.get_device() == dev and m.get_device() == dev
            and v.get_device() == dev and work.is_contiguous()
            and m.is_contiguous() and v.is_contiguous()
            and grad.is_contiguous())


def adamw_step_reference(p, g, m, v, sc: AdamWScalars,
                         apply_wd: bool) -> None:
    """The plain version on one tensor, in place, one torch op per
    kernel operation. The bias corrections divide by a tensor on ``m``'s
    device: torch on CUDA turns division by a host scalar into a
    multiplication by its reciprocal, which rounds differently."""
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


def adamw_step_multi_reference(works, grads, ms, vs, lows, decays,
                               sc: AdamWScalars) -> None:
    """The plain version of one multi-tensor step, tensor by tensor: the
    gradient widened (``g.float()``, exact), :func:`adamw_step_reference`
    on the flat f32 state, then the low-precision parameter written from
    the new master (``copy_`` rounds to nearest even, as ``.to``)."""
    for w, g, m, v, lo, decay in zip(works, grads, ms, vs, lows, decays):
        adamw_step_reference(w.view(-1), g.reshape(-1).float(), m.view(-1),
                             v.view(-1), sc, decay)
        if lo is not None:
            lo.view(-1).copy_(w.view(-1))


def _refuse(works, grads, ms, vs, lows) -> None:
    """Raise for lists the kernel does not take."""
    for w, g, m, v, lo in zip(works, grads, ms, vs, lows):
        if not adamw_multi_supported(w, g, m, v, lo):
            raise ValueError(
                f"adamw_step_multi takes contiguous f32 work, m and v and an "
                f"f32 gradient (bf16/f16 beside a parameter of that dtype) "
                f"of one size on one device; got work {w.dtype} "
                f"{tuple(w.shape)} on {w.device}, grad {g.dtype} "
                f"{tuple(g.shape)} on {g.device}, m {m.dtype} "
                f"{tuple(m.shape)}, v {v.dtype} {tuple(v.shape)}, low "
                f"{None if lo is None else (lo.dtype, tuple(lo.shape))}")
    dev = works[0].get_device()
    if any(w.get_device() != dev for w in works):
        raise ValueError("adamw_step_multi's tensors must lie on one device")


def _table(works, grads, ms, vs, lows, decays) -> np.ndarray:
    """The kernel's descriptor table for these tensors: made once for
    each tuple of records and reused."""
    key = tuple(
        (w.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
         0 if lo is None else lo.data_ptr(), w.numel(),
         _DTYPE_CODE[g.dtype] | (0 if lo is None else _DTYPE_CODE[lo.dtype])
         << 8 | int(bool(decay)) << 16, 0)
        for w, g, m, v, lo, decay in zip(works, grads, ms, vs, lows, decays))
    descs = _TABLES.get(key)
    if descs is None:
        if len(_TABLES) >= _MAX_TABLES:
            _TABLES.clear()
        descs = _TABLES[key] = np.array(list(key), dtype=_DESC)
    return descs


def adamw_step_multi(works, grads, ms, vs, lows, decays,
                     sc: AdamWScalars) -> None:
    """One AdamW step over lists of tensors, in place: for each ``i``,
    the f32 ``works[i]``, ``ms[i]`` and ``vs[i]`` from ``grads[i]``, with
    the decoupled decay where ``decays[i]`` (``sc.wd`` for all), and
    ``lows[i]`` (a bf16/f16 parameter whose master is ``works[i]``, or
    None) written from the new master. On the card: one launch per
    :data:`MAX_TENSORS` tensors, each counted in ``adamw_step.launches``;
    the descriptor table is reused while the tensors keep their
    storage."""
    if not (len(grads) == len(ms) == len(vs) == len(lows) == len(decays)
            == len(works)):
        raise ValueError("works, grads, ms, vs, lows and decays must have "
                         "one length")
    if not works:
        return
    _refuse(works, grads, ms, vs, lows)
    if not _build.on_card("adamw_step_multi", works[0]):
        adamw_step_multi_reference(works, grads, ms, vs, lows, decays, sc)
        return
    descs = _table(works, grads, ms, vs, lows, decays)
    dev = works[0].device
    lib = _build.library("adamw_step", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for i in range(0, len(descs), MAX_TENSORS):
            part = descs[i:i + MAX_TENSORS]
            err = lib.adamw_step_multi(part.ctypes.data, len(part), *sc,
                                       stream)
            _build.check(lib, err, "adamw_step_multi")
            adamw_step.launches += 1


def adamw_step(p, g, m, v, sc: AdamWScalars, apply_wd: bool) -> None:
    """One AdamW step on f32 ``(p, g, m, v)`` of one shape, updating
    ``p``, ``m`` and ``v`` in place: :func:`adamw_step_multi` over a list
    of one. ``apply_wd=False`` skips the decay subtract (the eager ``if
    wd and decay`` branch). ``adamw_step.launches`` counts the kernel's
    launches."""
    if not (p.shape == g.shape == m.shape == v.shape):
        raise ValueError("p, g, m and v must have one shape")
    if not all(t.dtype == torch.float32 for t in (p, g, m, v)):
        raise ValueError("adamw_step takes float32 p, g, m and v")
    adamw_step_multi([p], [g], [m], [v], [None], [apply_wd], sc)


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


def flat_route(*tensors) -> str:
    """The flat AdamW's route for its eight tensors (grad, m, v, master
    and the four outputs): "vec" when every one starts on a 16-byte
    boundary, else "general"."""
    return ("vec" if all(t.data_ptr() % 16 == 0 for t in tensors)
            else "general")


def adamw_flat(param, grad, m, v, master, sc: AdamWScalars):
    """One flat AdamW step; returns new ``(p, m, v, master)`` (p in
    param's dtype, the rest f32, all of param's shape) and updates
    nothing in place. m, v and master of a half dtype are widened to f32
    first (exactly). ``adamw_flat.launches`` counts the kernel's
    launches, ``adamw_flat.route_launches`` those of each route."""
    _check_flat(param, grad, m, v, master)
    if not _build.on_card("adamw_flat", param, grad, m, v, master):
        return adamw_flat_reference(param, grad, m, v, master, sc)
    m, v, master = (t.float() for t in (m, v, master))
    outs = (torch.empty_like(param),) + tuple(
        torch.empty(param.shape, dtype=torch.float32, device=param.device)
        for _ in range(3))
    route = flat_route(grad, m, v, master, *outs)
    lib = _build.library("adamw_flat", _FLAT_SIGNATURES)
    entry = FLAT_ROUTES[route]
    with torch.cuda.device(param.device):
        err = getattr(lib, entry)(
            grad.data_ptr(), m.data_ptr(), v.data_ptr(), master.data_ptr(),
            *(t.data_ptr() for t in outs), param.numel(),
            _DTYPE_CODE[param.dtype], _DTYPE_CODE[grad.dtype], *sc,
            torch.cuda.current_stream(param.device).cuda_stream)
    _build.check(lib, err, entry)
    adamw_flat.launches += 1
    adamw_flat.route_launches[route] += 1
    return outs


adamw_flat.launches = 0
adamw_flat.route_launches = dict.fromkeys(FLAT_ROUTES, 0)


def fused_adamw(param, grad, m, v, master, lr, beta1=0.9, beta2=0.999,
                eps=1e-8, weight_decay=0.01, step=1):
    """``pallas_fused.fused_adamw``'s counterpart: decoupled-decay Adam
    with an f32 master in one pass; returns ``(p, m, v, master)``."""
    return adamw_flat(param, grad, m, v, master, stage_flat_scalars(
        lr, beta1, beta2, eps, weight_decay, step))
