"""Optimizer base: the counterpart of
``paddle2_tpu/optimizer/optimizer.py``.

The JAX package traces one pure update over all parameters and runs it
jitted; the port runs the same per-parameter update eagerly, in torch
ops, and writes the results into the parameters and states. Subclasses
supply ``_update_one(param, grad, state, lr, step)``. What is carried
over: parameter groups, the ``(kind, coeff)`` weight decay, the
multi-precision ``{"master", "inner"}`` state with the explicit f32
cast of the gradient, decoupled decay, the fused-step routing with its
per-tensor fallback (for CPU tensors; on the card a tensor the fused
kernel does not take raises), ``step``/``clear_grad``/``state_dict``.

Not ported yet (ROADMAP queue 1 item 2): gradient clipping and LR
schedulers (only a float learning rate is taken).
"""

from typing import Any, Dict, List

import numpy as np
import torch

__all__ = ["Optimizer"]


def _clone(state):
    if isinstance(state, dict):
        return {k: _clone(v) for k, v in state.items()}
    return state.detach().clone() if isinstance(state, torch.Tensor) \
        else state


class Optimizer:

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False):
        if parameters is None:
            raise ValueError("parameters is required "
                             "(pass model.parameters())")
        if grad_clip is not None:
            raise NotImplementedError(
                "gradient clipping is not ported yet (ROADMAP queue 1 "
                "item 2)")
        if isinstance(learning_rate, bool) or \
                not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "only a float learning rate is taken: LR schedulers are "
                "not ported yet (ROADMAP queue 1 item 2)")
        self._param_groups: List[Dict[str, Any]] = []
        params_list = list(parameters)
        if params_list and isinstance(params_list[0], dict):
            for g in params_list:
                g = dict(g)
                g["params"] = list(g["params"])
                self._param_groups.append(g)
        else:
            self._param_groups.append({"params": params_list})
        self._lr = float(learning_rate)
        self._weight_decay = self._wd_value(weight_decay)
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
        """The explicit ``fused=`` ctor kwarg; None follows the default
        of the JAX package's ``FLAGS_fused_optimizer_step`` (False),
        whose flag is not ported yet."""
        return bool(getattr(self, "_fused_step", None))

    def _fused_update_builder(self, decay_flags):
        """Subclasses with a one-pass kernel return a drop-in ``update``
        here; None falls back to the generic per-op chain. A fused
        update must equal the generic one bitwise."""
        return None

    def _fused_paramwise_builder(self, decay_flags, kernel):
        """The fused-update scaffolding every subclass shares: the
        multi-precision master unwrap and re-wrap, the explicit f32 grad
        cast, and the per-tensor fallback to :meth:`_apply_one`.
        ``kernel(work, g, inner, lr, step, wd_eff)`` updates ``work``
        and ``inner`` in place and returns them, or None when this
        tensor is unsupported. l1 decay takes the fallback for every
        tensor: the kernels implement the l2 form only.

        The fallback serves CPU tensors only. A tensor on the card that
        the kernel does not take raises ``NotImplementedError``, so
        ``fused=True`` never runs the eager chain there."""
        wd_kind, wd = self._weight_decay
        l1 = bool(wd) and wd_kind != "l2"
        multi_prec = self._multi_precision
        apply_one = self._apply_one

        def update(params, grads, states, lr, step):
            new_params, new_states = [], []
            for p, g, s, decay in zip(params, grads, states, decay_flags):
                master, inner = None, s
                if multi_prec and "master" in s:
                    master, inner = s["master"], s["inner"]
                work = master if master is not None else p
                g_eff = g.float() if master is not None else g
                res = None if l1 else kernel(work, g_eff, inner, lr, step,
                                             wd if (wd and decay) else 0.0)
                if res is None:
                    if p.device.type != "cpu":
                        raise NotImplementedError(
                            f"fused=True: the fused step does not take "
                            f"this {p.dtype} parameter of shape "
                            f"{tuple(p.shape)} on {p.device} ("
                            + ("l1 decay" if l1 else "it needs an f32 "
                               "update on contiguous tensors: an f32 "
                               "parameter or multi_precision=True")
                            + "); pass fused=False (ROADMAP queue 1 "
                            "item 2)")
                    np_, ns_ = apply_one(p, g, s, lr, step, decay)
                elif master is not None:
                    np_, ns_ = res[0].to(p.dtype), {"master": res[0],
                                                    "inner": res[1]}
                else:
                    np_, ns_ = res
                new_params.append(np_)
                new_states.append(ns_)
            return new_params, new_states
        return update

    def _apply_one(self, p, g, s, lr, step, decay):
        """The per-parameter update (weight decay + ``_update_one`` +
        master handling) shared by the generic update and, as the
        per-tensor fallback, the fused one. ``lr * wd`` is taken in f32,
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
        update = self._build_update(decay_flags)
        new_params, new_states = update(
            params, [p.grad for p in params],
            [self._ensure_state(p) for p in params], self.get_lr(),
            self._step_count)
        for p, np_, ns_ in zip(params, new_params, new_states):
            if np_ is not p:
                p.copy_(np_)
            self._states[id(p)] = ns_

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._parameter_list():
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    # -- checkpointing ---------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """``_step_count`` and a copy of each parameter's state, keyed
        ``param_<index>`` in parameter order (torch parameters carry no
        names)."""
        out: Dict[str, Any] = {"_step_count": self._step_count}
        for idx, p in enumerate(self._parameter_list()):
            if id(p) in self._states:
                out[f"param_{idx}"] = _clone(self._states[id(p)])
        return out

    def set_state_dict(self, state_dict: Dict[str, Any]):
        """Restore copies of the states; a parameter without an entry
        goes back to uninitialised, as in the JAX package."""
        self._step_count = int(state_dict.get("_step_count", 0))
        for idx, p in enumerate(self._parameter_list()):
            key = f"param_{idx}"
            if key in state_dict:
                self._states[id(p)] = _clone(state_dict[key])
            else:
                self._states.pop(id(p), None)

    def _parameter_list(self):
        out = []
        for g in self._param_groups:
            out.extend(g["params"])
        return out


def _f32_mul(a: float, b: float) -> float:
    """``a * b`` rounded in f32 (both taken to f32 first)."""
    return float(np.float32(a) * np.float32(b))
