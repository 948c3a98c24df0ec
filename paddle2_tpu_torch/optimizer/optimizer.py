"""Optimizer base: the counterpart of
``paddle2_tpu/optimizer/optimizer.py``.

The JAX package traces one pure update over all parameters and runs it
jitted; the port runs the same per-parameter update eagerly, in torch
ops, and writes the results into the parameters and states. Subclasses
supply ``_update_one(param, grad, state, lr, step)``. What is carried
over: parameter groups, the ``(kind, coeff)`` weight decay (a float or
``paddle.regularizer.L1Decay``/``L2Decay``), gradient clipping
(``grad_clip``, applied to the gradients of the parameters whose
``need_clip`` is not False before either route's update), a float or an
:class:`~.lr.LRScheduler` learning rate (``get_lr``, ``set_lr``,
``set_lr_scheduler``), the multi-precision ``{"master", "inner"}`` state
with the explicit f32 cast of the gradient, decoupled decay, the
fused-step routing with its per-tensor fallback (for CPU tensors; on the
card a tensor the fused kernel does not take raises),
``step``/``minimize``/``clear_grad`` and ``state_dict`` with the
scheduler's state under ``"LR_Scheduler"``.

The constructors take the JAX package's parameters in its positional
order.
"""

from typing import Any, Dict, List

import numpy as np
import torch

from ..flags import flag_value
from .lr import LRScheduler

__all__ = ["Optimizer"]


def _clone(state, device=None):
    """A copy of a state tree, its tensors moved to ``device`` when
    given."""
    if isinstance(state, dict):
        return {k: _clone(v, device) for k, v in state.items()}
    if not isinstance(state, torch.Tensor):
        return state
    t = state.detach()
    if device is not None and t.device != device:
        return t.to(device)
    return t.clone()


def _clip_arrays(grad_clip, grads, need_clip_flags):
    """Gradient clipping over the clippable subset (the JAX package's
    ``_clip_arrays``)."""
    if grad_clip is None:
        return grads
    clipped = iter(grad_clip.apply_arrays(
        [g for g, c in zip(grads, need_clip_flags) if c]))
    return [next(clipped) if c else g
            for g, c in zip(grads, need_clip_flags)]


class Optimizer:

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError("parameters is required "
                             "(pass model.parameters())")
        self._param_groups: List[Dict[str, Any]] = []
        params_list = list(parameters)
        if params_list and isinstance(params_list[0], dict):
            for g in params_list:
                g = dict(g)
                g["params"] = list(g["params"])
                self._param_groups.append(g)
        else:
            self._param_groups.append({"params": params_list})
        self._lr = learning_rate
        self._name = name
        self._weight_decay = self._wd_value(weight_decay)
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._states: Dict[int, Any] = {}
        self._step_count = 0

    @staticmethod
    def _wd_value(weight_decay):
        """Returns (kind, coeff): kind is 'l2' or 'l1'."""
        if weight_decay is None:
            return ("l2", 0.0)
        if isinstance(weight_decay, (int, float)):
            return ("l2", float(weight_decay))
        coeff = float(getattr(weight_decay, "_coeff",
                              getattr(weight_decay, "coeff", 0.0)))
        kind = "l1" if type(weight_decay).__name__ == "L1Decay" else "l2"
        return (kind, coeff)

    # -- lr --------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return self._lr()
        return float(self._lr)

    def set_lr(self, value: float) -> None:
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    def set_lr_scheduler(self, scheduler: LRScheduler) -> None:
        self._lr = scheduler

    @property
    def _learning_rate(self):
        return self._lr

    # -- state -----------------------------------------------------------
    def _init_state(self, p):
        """The initial state of one parameter (subclass)."""
        return {}

    def _ensure_state(self, p):
        key = id(p)
        if key not in self._states:
            state = self._init_state(p)
            if self._multi_precision and p.dtype in (torch.bfloat16,
                                                     torch.float16):
                state = {"master": p.detach().float(), "inner": state}
            self._states[key] = state
        return self._states[key]

    # -- the update ------------------------------------------------------
    def _update_one(self, param, grad, state, lr, step):
        raise NotImplementedError

    def _decoupled_wd(self) -> bool:
        return False  # AdamW overrides

    def _use_fused_step(self) -> bool:
        """The explicit ``fused=`` ctor kwarg wins; None follows
        ``FLAGS_fused_optimizer_step``, as in the JAX package."""
        explicit = getattr(self, "_fused_step", None)
        if explicit is not None:
            return bool(explicit)
        return bool(flag_value("fused_optimizer_step"))

    def _fused_update_builder(self, decay_flags):
        """Subclasses with a multi-tensor kernel return a drop-in
        ``update`` here; None falls back to the generic per-op chain. A
        fused update must equal the generic one bitwise."""
        return None

    def _apply_one(self, p, g, s, lr, step, decay):
        """The per-parameter update (weight decay + ``_update_one`` +
        master handling) shared by the generic update and, as the
        per-tensor fallback, the fused ones. ``lr * wd`` is taken in f32,
        as the JAX package's f32 ``lr`` times the Python ``wd``."""
        wd_kind, wd = self._weight_decay
        decoupled = self._decoupled_wd()
        master, inner = None, s
        if self._multi_precision and "master" in s:
            master, inner = s["master"], s["inner"]
            work = master
            g = g.float()
        else:
            work = p
        if wd and decay and not decoupled:
            g = g + wd * (torch.sign(work) if wd_kind == "l1" else work)
        np_, ns_ = self._update_one(work, g, inner, lr, step)
        if wd and decay and decoupled:
            reg = torch.sign(work) if wd_kind == "l1" else work
            np_ = np_ - _f32_mul(lr, wd) * reg
        if master is not None:
            return np_.to(p.dtype), {"master": np_, "inner": ns_}
        return np_, ns_

    def _build_update(self, decay_flags):
        """``update(params, grads, states, lr, step) -> (new_params,
        new_states)`` over flat lists: the fused one when asked for and
        the subclass has one, else the generic chain."""
        if self._use_fused_step():
            fused = self._fused_update_builder(decay_flags)
            if fused is not None:
                return fused
        apply_one = self._apply_one

        def update(params, grads, states, lr, step):
            outs = [apply_one(p, g, s, lr, step, decay)
                    for p, g, s, decay in zip(params, grads, states,
                                              decay_flags)]
            return [o[0] for o in outs], [o[1] for o in outs]
        return update

    # -- step ------------------------------------------------------------
    @torch.no_grad()
    def step(self):
        """Update every parameter that has a gradient, in place."""
        self._step_count += 1
        params = [p for p in self._parameter_list()
                  if p is not None and p.requires_grad
                  and p.grad is not None]
        if not params:
            return
        decay_flags = tuple(not getattr(p, "no_weight_decay", False)
                            for p in params)
        need_clip = tuple(bool(getattr(p, "need_clip", True))
                          for p in params)
        grads = _clip_arrays(self._grad_clip, [p.grad for p in params],
                             need_clip)
        update = self._build_update(decay_flags)
        new_params, new_states = update(
            params, grads, [self._ensure_state(p) for p in params],
            self.get_lr(), self._step_count)
        for p, np_, ns_ in zip(params, new_params, new_states):
            if np_ is not p:
                p.copy_(np_)
            self._states[id(p)] = ns_

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()`` and :meth:`step`; returns ``(None,
        None)`` as the JAX package does."""
        loss.backward()
        self.step()
        return None, None

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._parameter_list():
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    # -- checkpointing ---------------------------------------------------
    @staticmethod
    def _state_key(p, idx: int) -> str:
        """A parameter's key in the state dict: its Paddle name where it
        carries one (``paddle_name``, which ``paddle.load`` sets), else
        ``param_<index>`` in parameter order, as the JAX package keys an
        unnamed parameter."""
        return getattr(p, "paddle_name", None) or f"param_{idx}"

    def state_dict(self) -> Dict[str, Any]:
        """``_step_count``, the scheduler's state (``"LR_Scheduler"``)
        and a copy of each parameter's state under
        :meth:`_state_key`."""
        out: Dict[str, Any] = {"_step_count": self._step_count}
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        for idx, p in enumerate(self._parameter_list()):
            if id(p) in self._states:
                out[self._state_key(p, idx)] = _clone(self._states[id(p)])
        return out

    def set_state_dict(self, state_dict: Dict[str, Any]):
        """Restore copies of the states on each parameter's device (a
        loaded file's tensors lie on the CPU); a parameter without an
        entry goes back to uninitialised, as in the JAX package."""
        self._step_count = int(state_dict.get("_step_count", 0))
        if isinstance(self._lr, LRScheduler) and \
                "LR_Scheduler" in state_dict:
            self._lr.set_state_dict(state_dict["LR_Scheduler"])
        for idx, p in enumerate(self._parameter_list()):
            key = self._state_key(p, idx)
            if key in state_dict:
                self._states[id(p)] = _clone(state_dict[key], p.device)
            else:
                self._states.pop(id(p), None)

    def _parameter_list(self):
        out = []
        for g in self._param_groups:
            out.extend(g["params"])
        return out


def refuse_off_cpu(p, l1: bool) -> None:
    """The fused route's rule for a tensor its kernel does not take: the
    eager chain serves it on the CPU; on the card it raises, so
    ``fused=True`` never runs the eager chain there."""
    if p.device.type != "cpu":
        raise NotImplementedError(
            f"fused=True: the fused step does not take this {p.dtype} "
            f"parameter of shape {tuple(p.shape)} on {p.device} ("
            + ("l1 decay" if l1 else "it needs an f32 update on contiguous "
               "tensors: an f32 parameter or multi_precision=True")
            + "); pass fused=False")


def _f32_mul(a: float, b: float) -> float:
    """``a * b`` rounded in f32 (both taken to f32 first)."""
    return float(np.float32(a) * np.float32(b))
