"""The fused (Nesterov) momentum step: the CUDA kernel, its wrappers and
its plain version.

Counterpart of ``fused_momentum_step`` in
``paddle2_tpu/kernels/pallas_fused.py``, which the JAX optimizer calls
once per leaf. The kernel is ``csrc/momentum_step.cu``: one launch over a
table of tensors (:func:`momentum_step_multi`), each a flat f32 working
parameter and velocity updated in place, a gradient read in its stored
dtype (f32, or the bf16/f16 gradient of a parameter with an f32 master,
widened exactly), and optionally that bf16/f16 parameter written from
the new master. The op order is the port's eager Momentum
(:mod:`paddle2_tpu_torch.optimizer.optimizers`: L2 decay folded into the
gradient, then the velocity, then the parameter, then the cast), so the
two agree bitwise. ``lr``, ``momentum`` and each ``weight_decay`` are
rounded to f32 on the host, as the Pallas wrapper stages them and as
torch rounds a Python scalar against an f32 tensor.

CPU tensors run :func:`momentum_step_reference` per tensor; CUDA tensors
launch the kernel or raise.
"""

import ctypes

import numpy as np
import torch

from . import _build

__all__ = ["momentum_multi_supported", "momentum_step_multi",
           "momentum_step", "momentum_step_reference", "MAX_TENSORS"]

_F = ctypes.c_float
# descs, count, lr, momentum, nesterov, stream
_SIGNATURES = {"momentum_step_multi": [ctypes.c_void_p, ctypes.c_int, _F, _F,
                                       ctypes.c_int, ctypes.c_void_p]}
# one launch takes at most this many tensors (csrc/momentum_step.cu
# MAX_TENSORS: the table is one kernel parameter); longer lists take one
# launch per MAX_TENSORS
MAX_TENSORS = 256
_F32 = torch.float32
_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the kernel's tensor record (csrc/momentum_step.cu `Desc`)
_DESC = np.dtype([("work", "<u8"), ("vel", "<u8"), ("grad", "<u8"),
                  ("low", "<u8"), ("n", "<i8"), ("wd", "<f4"),
                  ("codes", "<i4")])


def _f32(x) -> float:
    return float(np.float32(x))


def momentum_multi_supported(work, grad, vel, low=None) -> bool:
    """Whether the kernel takes this tensor: an f32 working parameter (a
    plain f32 parameter or the multi-precision master) and f32 velocity,
    a gradient in f32 (in bf16/f16 only beside a parameter ``low`` of
    that dtype, whose master ``work`` is), all contiguous, of one size
    and on one device. The optimizer asks this once a tensor a step, so
    it reads only what it must."""
    n, dev = work.numel(), work.get_device()
    if low is None:
        if grad.dtype is not _F32:
            return False
    elif not ((low.dtype is torch.bfloat16 or low.dtype is torch.float16)
              and (grad.dtype is _F32 or grad.dtype is low.dtype)
              and low.numel() == n and low.get_device() == dev
              and low.is_contiguous()):
        return False
    return (work.dtype is _F32 and vel.dtype is _F32
            and grad.numel() == n and vel.numel() == n
            and grad.get_device() == dev and vel.get_device() == dev
            and work.is_contiguous() and vel.is_contiguous()
            and grad.is_contiguous())


def momentum_step_reference(p, g, v, lr, momentum, nesterov,
                            weight_decay) -> None:
    """The plain version, in place on the flat tensors, one torch op per
    kernel operation."""
    lr, momentum, weight_decay = (_f32(x) for x in
                                  (lr, momentum, weight_decay))
    p, v = p.view(-1), v.view(-1)
    g = g.reshape(-1).float()
    if weight_decay:
        g = g + weight_decay * p
    v_new = momentum * v + g
    if nesterov:
        p_new = p - lr * (g + momentum * v_new)
    else:
        p_new = p - lr * v_new
    p.copy_(p_new)
    v.copy_(v_new)


def _refuse(works, grads, vels, lows) -> None:
    """Raise for lists the kernel does not take."""
    for w, g, v, lo in zip(works, grads, vels, lows):
        if not momentum_multi_supported(w, g, v, lo):
            raise ValueError(
                f"momentum_step_multi takes contiguous f32 work and "
                f"velocity and an f32 gradient (bf16/f16 beside a parameter "
                f"of that dtype) of one size on one device; got work "
                f"{w.dtype} {tuple(w.shape)} on {w.device}, grad {g.dtype} "
                f"{tuple(g.shape)} on {g.device}, velocity {v.dtype} "
                f"{tuple(v.shape)} on {v.device}, low "
                f"{None if lo is None else (lo.dtype, tuple(lo.shape))}")
    dev = works[0].get_device()
    if any(w.get_device() != dev for w in works):
        raise ValueError("momentum_step_multi's tensors must lie on one "
                         "device")


def momentum_step_multi(works, grads, vels, lows, wds, lr, momentum,
                        nesterov=False) -> None:
    """One momentum step over lists of tensors, in place: for each
    ``i``, the f32 ``works[i]`` and ``vels[i]`` from ``grads[i]`` with
    L2 decay ``wds[i]`` (0 skips the fold), and ``lows[i]`` (a bf16/f16
    parameter whose master is ``works[i]``, or None) written from the
    new master. On the card: one launch per :data:`MAX_TENSORS` tensors,
    each counted in ``momentum_step.launches``."""
    if not (len(grads) == len(vels) == len(lows) == len(wds) == len(works)):
        raise ValueError("works, grads, vels, lows and wds must have one "
                         "length")
    if not works:
        return
    _refuse(works, grads, vels, lows)
    if not _build.on_card("momentum_step_multi", works[0]):
        for w, g, v, lo, wd in zip(works, grads, vels, lows, wds):
            momentum_step_reference(w, g, v, lr, momentum, nesterov, wd)
            if lo is not None:
                lo.view(-1).copy_(w.view(-1))
        return
    dev = works[0].device
    descs = np.array(
        [(w.data_ptr(), v.data_ptr(), g.data_ptr(),
          0 if lo is None else lo.data_ptr(), w.numel(), wd,
          _CODE[g.dtype] | (0 if lo is None else _CODE[lo.dtype]) << 8)
         for w, g, v, lo, wd in zip(works, grads, vels, lows, wds)],
        dtype=_DESC)
    lib = _build.library("momentum_step", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for i in range(0, len(descs), MAX_TENSORS):
            part = descs[i:i + MAX_TENSORS]
            err = lib.momentum_step_multi(
                part.ctypes.data, len(part), _f32(lr), _f32(momentum),
                int(bool(nesterov)), stream)
            _build.check(lib, err, "momentum_step_multi")
            momentum_step.launches += 1


def momentum_step(p, g, v, lr, momentum, nesterov=False,
                  weight_decay=0.0) -> None:
    """One momentum step on f32 ``(p, g, v)`` of one size, updating
    ``p`` and ``v`` in place: :func:`momentum_step_multi` over a list of
    one. ``weight_decay=0.0`` skips the L2 fold (the eager ``if wd and
    decay`` branch). ``momentum_step.launches`` counts the kernel's
    launches."""
    momentum_step_multi([p], [g], [v], [None], [weight_decay], lr,
                        momentum, nesterov)


momentum_step.launches = 0
