"""Adam and AdamW: the counterpart of
``paddle2_tpu/optimizer/optimizers.py:74-158``.

The update keeps the JAX package's eager op order exactly (one torch op
per JAX op): ``1-b1`` is a Python constant, ``1-b1**t`` is computed in
f32 from the integer step, and AdamW's decoupled decay is a separate
subtract against the pre-update parameter. No ``add_(..., alpha=)``,
``addcmul_`` or ``lerp_``: on CUDA those fuse a multiply and an add into
one rounding, and the fused kernel (``kernels/csrc/adamw_step.cu``) is
held to this chain bitwise. Division by the bias corrections goes
through a tensor on the parameter's device, because torch on CUDA turns
division by a host scalar into a multiplication by its reciprocal.

The other optimizers of the JAX module are ROADMAP queue 1 item 2.
"""

import numpy as np
import torch

from ..kernels.fused_adamw import (adamw_step, adamw_step_supported,
                                   stage_scalars)
from .optimizer import Optimizer

__all__ = ["Adam", "AdamW"]


class Adam(Optimizer):

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _init_state(self, p):
        dt = torch.float32 if p.dtype in (torch.bfloat16, torch.float16) \
            else p.dtype
        return {"m": torch.zeros(p.shape, dtype=dt, device=p.device),
                "v": torch.zeros(p.shape, dtype=dt, device=p.device)}

    def _update_one(self, param, grad, state, lr, step):
        b1, b2, eps = self._beta1, self._beta2, self._eps
        t = np.float32(step)
        bc1 = torch.tensor(np.float32(1) - np.float32(b1) ** t,
                           device=param.device)
        bc2 = torch.tensor(np.float32(1) - np.float32(b2) ** t,
                           device=param.device)
        m = b1 * state["m"] + (1 - b1) * grad
        v = b2 * state["v"] + (1 - b2) * (grad * grad)
        mhat = m / bc1
        vhat = v / bc2
        new_p = param - lr * mhat / (torch.sqrt(vhat) + eps)
        return new_p, {"m": m, "v": v}


class AdamW(Adam):
    """Adam with decoupled weight decay. ``fused=True`` routes each f32
    update (a plain f32 parameter, or the master of a bf16 one) through
    the one-pass kernel (:mod:`paddle2_tpu_torch.kernels.fused_adamw`),
    bitwise equal to the eager chain. Other tensors (a bf16 parameter
    without a master, l1 decay) fall back to the chain on the CPU and
    raise on the card. ``fused=None`` follows the JAX package's default
    for ``FLAGS_fused_optimizer_step``: off."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None, multi_precision=False, fused=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, multi_precision)
        self._fused_step = fused

    def _decoupled_wd(self):
        return True

    def _fused_update_builder(self, decay_flags):
        b1, b2, eps = self._beta1, self._beta2, self._eps

        def kernel(work, g, inner, lr, step, wd_eff):
            if not (set(inner) == {"m", "v"}
                    and inner["m"].dtype == torch.float32
                    and inner["m"].is_contiguous()
                    and inner["v"].is_contiguous()
                    and adamw_step_supported(work, g)):
                return None
            adamw_step(work, g, inner["m"], inner["v"],
                       stage_scalars(lr, b1, b2, eps, wd_eff, step),
                       apply_wd=bool(wd_eff))
            return work, inner
        return self._fused_paramwise_builder(decay_flags, kernel)
