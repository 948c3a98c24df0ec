"""Momentum, Adam and AdamW: the counterpart of
``paddle2_tpu/optimizer/optimizers.py:29-158``.

The update keeps the JAX package's eager op order exactly (one torch op
per JAX op): ``1-b1`` is a Python constant, ``1-b1**t`` is computed in
f32 from the integer step, and AdamW's decoupled decay is a separate
subtract against the pre-update parameter. No ``add_(..., alpha=)``,
``addcmul_`` or ``lerp_``: on CUDA those fuse a multiply and an add into
one rounding, and the fused multi-tensor kernel
(``kernels/csrc/adamw_step.cu``) is held to this chain bitwise, the cast
of a master to its bf16/f16 parameter included. Division by the bias corrections goes
through a tensor on the parameter's device, because torch on CUDA turns
division by a host scalar into a multiplication by its reciprocal.

Momentum keeps its eager order too: ``v = mom*v + g``, then
``p - lr*v`` (Nesterov: ``p - lr*(g + mom*v)`` with the new ``v``), the
L2 decay folded into ``g`` first by the base ``_apply_one``; the fused
multi-tensor kernel (``kernels/csrc/momentum_step.cu``) is held to this
chain bitwise, the cast of a master to its bf16/f16 parameter included.

The other optimizers of the JAX module are ROADMAP queue 1 item 2.
"""

import numpy as np
import torch

from ..kernels.fused_adamw import (adamw_multi_supported, adamw_step_multi,
                                   stage_scalars)
from ..kernels.fused_momentum import (momentum_multi_supported,
                                       momentum_step_multi)
from .optimizer import Optimizer, refuse_off_cpu, refuse_unported

__all__ = ["Momentum", "Adam", "AdamW"]


class Momentum(Optimizer):
    """Heavy-ball (or Nesterov) momentum. The velocity is f32 under
    ``multi_precision`` (for f32 parameters too, as in the JAX package),
    else in the parameter's dtype. ``fused=True`` routes each f32 update
    (a plain f32 parameter, or the master of a bf16/f16 one, whose
    parameter the same pass writes) through one multi-tensor kernel
    launch a step (:mod:`paddle2_tpu_torch.kernels.fused_momentum`),
    bitwise equal to the eager chain; other tensors fall back to the
    chain on the CPU and raise on the card. ``fused=None`` follows
    ``FLAGS_fused_optimizer_step`` (off by default)."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None, fused=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov
        self._fused_step = fused

    def _init_state(self, p):
        return {"velocity": torch.zeros_like(
            p, dtype=torch.float32 if self._multi_precision else None,
            memory_format=torch.contiguous_format)}

    def _update_one(self, param, grad, state, lr, step):
        v = self._momentum * state["velocity"] + grad
        if self._nesterov:
            new_p = param - lr * (grad + self._momentum * v)
        else:
            new_p = param - lr * v
        return new_p, {"velocity": v}

    def _fused_update_builder(self, decay_flags):
        """One kernel launch a step for every tensor the kernel takes
        (:func:`~paddle2_tpu_torch.kernels.fused_momentum.momentum_step_multi`):
        the f32 update of each, and each bf16/f16 parameter written from
        its master in the same pass, so the parameter is returned as
        itself and ``step`` copies nothing. l1 decay and tensors the
        kernel does not take follow :func:`refuse_off_cpu`: the eager
        chain per tensor on the CPU, ``NotImplementedError`` on the card.
        The states are updated in place and keep their layout."""
        mom, nesterov = self._momentum, self._nesterov
        wd_kind, wd = self._weight_decay
        l1 = bool(wd) and wd_kind != "l2"
        multi_prec = self._multi_precision
        apply_one = self._apply_one

        def update(params, grads, states, lr, step):
            new_params, new_states = list(params), list(states)
            works, gs, vels, lows, wds = [], [], [], [], []
            for i, (p, g, s, decay) in enumerate(zip(params, grads, states,
                                                     decay_flags)):
                master, inner = None, s
                if multi_prec and "master" in s:
                    master, inner = s["master"], s["inner"]
                work = master if master is not None else p
                low = p if master is not None else None
                v = inner.get("velocity")
                if l1 or set(inner) != {"velocity"} or \
                        not momentum_multi_supported(work, g, v, low):
                    refuse_off_cpu(p, l1)
                    new_params[i], new_states[i] = apply_one(
                        p, g, s, lr, step, decay)
                    continue
                works.append(work)
                gs.append(g)
                vels.append(v)
                lows.append(low)
                wds.append(wd if (wd and decay) else 0.0)
            momentum_step_multi(works, gs, vels, lows, wds, lr, mom,
                                nesterov)
            return new_params, new_states
        return update


class Adam(Optimizer):

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, amsgrad=False):
        refuse_unported(lazy_mode=lazy_mode, amsgrad=amsgrad)
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
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
    update (a plain f32 parameter, or the master of a bf16/f16 one, whose
    parameter the same pass writes) through one multi-tensor kernel
    launch a step (:mod:`paddle2_tpu_torch.kernels.fused_adamw`), bitwise
    equal to the eager chain. Other tensors (a bf16 parameter without a
    master, l1 decay, non-contiguous state) fall back to the chain on
    the CPU and raise on the card. ``fused=None`` follows
    ``FLAGS_fused_optimizer_step`` (off by default)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 amsgrad=False, fused=None):
        refuse_unported(lr_ratio=lr_ratio,
                        apply_decay_param_fun=apply_decay_param_fun)
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode,
                         multi_precision, name, amsgrad)
        self._fused_step = fused

    def _decoupled_wd(self):
        return True

    def _fused_update_builder(self, decay_flags):
        """One kernel launch a step for every tensor the kernel takes
        (:func:`~paddle2_tpu_torch.kernels.fused_adamw.adamw_step_multi`):
        the f32 update of each, and each bf16/f16 parameter written from
        its master in the same pass, so the parameter is returned as
        itself and ``step`` copies nothing. l1 decay and tensors the
        kernel does not take follow :func:`refuse_off_cpu`: the eager
        chain per tensor on the CPU, ``NotImplementedError`` on the card.
        The states are updated in place and keep their layout."""
        b1, b2, eps = self._beta1, self._beta2, self._eps
        wd_kind, wd = self._weight_decay
        l1 = bool(wd) and wd_kind != "l2"
        multi_prec = self._multi_precision
        apply_one = self._apply_one

        def update(params, grads, states, lr, step):
            new_params, new_states = list(params), list(states)
            works, gs, ms, vs, lows, decays = [], [], [], [], [], []
            for i, (p, g, s, decay) in enumerate(zip(params, grads, states,
                                                     decay_flags)):
                master, inner = None, s
                if multi_prec and "master" in s:
                    master, inner = s["master"], s["inner"]
                work = master if master is not None else p
                low = p if master is not None else None
                if l1 or set(inner) != {"m", "v"} or \
                        not adamw_multi_supported(work, g, inner["m"],
                                                  inner["v"], low):
                    refuse_off_cpu(p, l1)
                    new_params[i], new_states[i] = apply_one(
                        p, g, s, lr, step, decay)
                    continue
                works.append(work)
                gs.append(g)
                ms.append(inner["m"])
                vs.append(inner["v"])
                lows.append(low)
                decays.append(bool(wd and decay))
            adamw_step_multi(works, gs, ms, vs, lows, decays,
                             stage_scalars(lr, b1, b2, eps, wd, step))
            return new_params, new_states
        return update
