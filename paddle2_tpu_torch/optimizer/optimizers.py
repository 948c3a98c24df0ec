"""The fifteen optimizers: the counterpart of
``paddle2_tpu/optimizer/optimizers.py``, each with the JAX package's
constructor (positional order, defaults, and which options reach the
base: Adamax, Adagrad, Adadelta, RMSProp, Lion, ASGD and Rprop take no
``multi_precision`` there either) and its update rule, one torch op per
JAX op.

Adam's and AdamW's update keeps the JAX package's eager op order
exactly (one torch op per JAX op): ``1-b1`` is a Python constant,
``1-b1**t`` is computed in f32 from the integer step, and AdamW's
decoupled decay is a separate subtract against the pre-update
parameter. No ``add_(..., alpha=)``, ``addcmul_`` or ``lerp_``: on CUDA
those fuse a multiply and an add into one rounding, and the fused
multi-tensor kernel (``kernels/csrc/adamw_step.cu``) is held to this
chain bitwise, the cast of a master to its bf16/f16 parameter included.
Division by the bias corrections goes through a tensor on the
parameter's device, because torch on CUDA turns division by a host
scalar into a multiplication by its reciprocal.

Momentum keeps its eager order too: ``v = mom*v + g``, then
``p - lr*v`` (Nesterov: ``p - lr*(g + mom*v)`` with the new ``v``), the
L2 decay folded into ``g`` first by the base ``_apply_one``; the fused
multi-tensor kernel (``kernels/csrc/momentum_step.cu``) is held to this
chain bitwise, the cast of a master to its bf16/f16 parameter included.

Scalars the JAX package computes from the f32 step (bias corrections,
RAdam's rectification) are computed in numpy f32 on the host, and every
division by one goes through a tensor, as above. Where the JAX package
takes an option and does nothing with it, the port does the same:
``lazy_mode`` (it selects sparse row updates, and every gradient here
is dense) and AdamW's ``lr_ratio``. ``apply_decay_param_fun(name)`` is
called with each parameter's Paddle name (``paddle_name``, which
``paddle.load`` sets; None for a plain ``torch.nn.Parameter`` that
carries none) and marks the parameters it refuses ``no_weight_decay``,
as the JAX package does.
"""

import numpy as np
import torch

from ..kernels.fused_adamw import (adamw_multi_supported, adamw_step_multi,
                                   stage_scalars)
from ..kernels.fused_momentum import (momentum_multi_supported,
                                       momentum_step_multi)
from .optimizer import Optimizer, refuse_off_cpu

__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Adamax", "Adagrad",
           "Adadelta", "RMSProp", "Lamb", "Lion", "NAdam", "RAdam", "LBFGS",
           "ASGD", "Rprop"]


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-d f32 tensor on ``like``'s device."""
    return torch.tensor(np.float32(x), device=like.device)


def _bias(beta: float, step) -> np.float32:
    """``1 - beta ** t`` in f32, ``t`` the f32 step."""
    return np.float32(1) - np.float32(beta) ** np.float32(step)


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, memory_format=torch.contiguous_format)


class SGD(Optimizer):

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _update_one(self, param, grad, state, lr, step):
        return param - lr * grad, state


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
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._lazy_mode = lazy_mode
        self._amsgrad = amsgrad

    def _init_state(self, p):
        dt = torch.float32 if p.dtype in (torch.bfloat16, torch.float16) \
            else p.dtype
        s = {"m": torch.zeros(p.shape, dtype=dt, device=p.device),
             "v": torch.zeros(p.shape, dtype=dt, device=p.device)}
        if self._amsgrad:
            s["vmax"] = torch.zeros(p.shape, dtype=dt, device=p.device)
        return s

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
        if self._amsgrad:
            vmax = torch.maximum(state["vmax"], v)
            vhat = vmax / bc2
            new_state = {"m": m, "v": v, "vmax": vmax}
        else:
            vhat = v / bc2
            new_state = {"m": m, "v": v}
        new_p = param - lr * mhat / (torch.sqrt(vhat) + eps)
        return new_p, new_state


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
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode,
                         multi_precision, name, amsgrad)
        self._lr_ratio = lr_ratio
        self._apply_decay_fn = apply_decay_param_fun
        self._fused_step = fused
        if apply_decay_param_fun is not None:
            for p in self._parameter_list():
                if not apply_decay_param_fun(getattr(p, "paddle_name",
                                                     None)):
                    p.no_weight_decay = True

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
        The states are updated in place and keep their layout. amsgrad
        takes the eager chain, as in the JAX package (the kernel has no
        running maximum)."""
        if self._amsgrad:
            return None
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


class Adamax(Optimizer):

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _init_state(self, p):
        return {"m": _zeros(p), "u": _zeros(p)}

    def _update_one(self, param, grad, state, lr, step):
        b1, b2, eps = self._beta1, self._beta2, self._eps
        m = b1 * state["m"] + (1 - b1) * grad
        u = torch.maximum(b2 * state["u"], torch.abs(grad))
        rate = _scalar(lr, param) / _scalar(_bias(b1, step), param)
        new_p = param - rate * m / (u + eps)
        return new_p, {"m": m, "u": u}


class Adagrad(Optimizer):

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def _init_state(self, p):
        return {"moment": torch.full_like(
            p, self._init_acc, memory_format=torch.contiguous_format)}

    def _update_one(self, param, grad, state, lr, step):
        moment = state["moment"] + torch.square(grad)
        new_p = param - lr * grad / (torch.sqrt(moment) + self._eps)
        return new_p, {"moment": moment}


class Adadelta(Optimizer):

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps, self._rho = epsilon, rho

    def _init_state(self, p):
        return {"avg_sq_grad": _zeros(p), "avg_sq_update": _zeros(p)}

    def _update_one(self, param, grad, state, lr, step):
        rho, eps = self._rho, self._eps
        asg = rho * state["avg_sq_grad"] + (1 - rho) * torch.square(grad)
        update = (torch.sqrt(state["avg_sq_update"] + eps)
                  / torch.sqrt(asg + eps)) * grad
        asu = rho * state["avg_sq_update"] + (1 - rho) * torch.square(update)
        return param - lr * update, {"avg_sq_grad": asg,
                                     "avg_sq_update": asu}


class RMSProp(Optimizer):

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_state(self, p):
        s = {"mean_square": _zeros(p), "moment": _zeros(p)}
        if self._centered:
            s["mean_grad"] = _zeros(p)
        return s

    def _update_one(self, param, grad, state, lr, step):
        rho, eps = self._rho, self._eps
        ms = rho * state["mean_square"] + (1 - rho) * torch.square(grad)
        if self._centered:
            mg = rho * state["mean_grad"] + (1 - rho) * grad
            denom = torch.sqrt(ms - torch.square(mg) + eps)
            new_state = {"mean_square": ms, "mean_grad": mg}
        else:
            denom = torch.sqrt(ms + eps)
            new_state = {"mean_square": ms}
        mom = self._momentum * state["moment"] + lr * grad / denom
        new_state["moment"] = mom
        return param - mom, new_state


class Lamb(Optimizer):
    """LAMB: Adam's direction scaled per tensor by the trust ratio
    ``|w| / |r|``. ``exclude_from_weight_decay_fn(param)`` gives a
    parameter no decay."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_state(self, p):
        wd = 0.0 if (self._exclude_fn is not None
                     and self._exclude_fn(p)) else self._lamb_wd
        return {"m": torch.zeros(p.shape, device=p.device),
                "v": torch.zeros(p.shape, device=p.device),
                "wd": torch.tensor(np.float32(wd), device=p.device)}

    def _update_one(self, param, grad, state, lr, step):
        b1, b2, eps = self._beta1, self._beta2, self._eps
        m = b1 * state["m"] + (1 - b1) * grad
        v = b2 * state["v"] + (1 - b2) * torch.square(grad)
        mhat = m / _scalar(_bias(b1, step), m)
        vhat = v / _scalar(_bias(b2, step), v)
        r = mhat / (torch.sqrt(vhat) + eps) + state["wd"] * param
        w_norm = torch.linalg.vector_norm(param.float())
        r_norm = torch.linalg.vector_norm(r.float())
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        return (param - _scalar(lr, param) * trust * r,
                {"m": m, "v": v, "wd": state["wd"]})


class Lion(Optimizer):
    """Lion (sign momentum), with decoupled weight decay."""

    def __init__(self, learning_rate=1e-4, beta1=0.9, beta2=0.99,
                 parameters=None, weight_decay=0.0, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2 = beta1, beta2

    def _decoupled_wd(self):
        return True

    def _init_state(self, p):
        return {"m": _zeros(p)}

    def _update_one(self, param, grad, state, lr, step):
        b1, b2 = self._beta1, self._beta2
        update = torch.sign(b1 * state["m"] + (1 - b1) * grad)
        m = b2 * state["m"] + (1 - b2) * grad
        return param - lr * update, {"m": m}


class NAdam(Adam):

    def _update_one(self, param, grad, state, lr, step):
        b1, b2, eps = self._beta1, self._beta2, self._eps
        m = b1 * state["m"] + (1 - b1) * grad
        v = b2 * state["v"] + (1 - b2) * torch.square(grad)
        mhat = (b1 * m / _scalar(_bias(b1, step + 1), m)
                + (1 - b1) * grad / _scalar(_bias(b1, step), m))
        vhat = v / _scalar(_bias(b2, step), v)
        return (param - lr * mhat / (torch.sqrt(vhat) + eps),
                {"m": m, "v": v})


class RAdam(Adam):

    def _update_one(self, param, grad, state, lr, step):
        b1, b2, eps = self._beta1, self._beta2, self._eps
        f = np.float32
        t = f(step)
        m = b1 * state["m"] + (1 - b1) * grad
        v = b2 * state["v"] + (1 - b2) * torch.square(grad)
        mhat = m / _scalar(_bias(b1, step), m)
        rho_inf = 2.0 / (1 - b2) - 1
        b2t = f(b2) ** t
        rho_t = f(rho_inf) - f(2) * t * b2t / (f(1) - b2t)
        if rho_t > f(5.0):
            r = np.sqrt(((rho_t - f(4)) * (rho_t - f(2)) * f(rho_inf))
                        / (f((rho_inf - 4) * (rho_inf - 2)) * rho_t))
            vhat = torch.sqrt(v / _scalar(_bias(b2, step), v))
            new_p = param - _scalar(f(lr) * r, param) * mhat / (vhat + eps)
        else:
            new_p = param - lr * mhat
        return new_p, {"m": m, "v": v}


class LBFGS(Optimizer):
    """L-BFGS without a line search (the JAX package's variant): the
    two-loop recursion over the last ``history_size`` ``(s, y)`` pairs of
    the flattened f32 parameters and gradients, a step of
    ``learning_rate`` along it. ``step(closure)`` calls ``closure``
    first (it computes the loss and the gradients)."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._max_iter = max_iter
        self._max_eval = max_eval
        self._tol_grad = tolerance_grad
        self._tol_change = tolerance_change
        self._history_size = history_size
        self._line_search_fn = line_search_fn
        self._hist_s: list = []
        self._hist_y: list = []
        self._prev_flat = None
        self._prev_grad = None

    @staticmethod
    def _flat(ts):
        return torch.cat([t.detach().reshape(-1).float() for t in ts])

    def step(self, closure=None):
        if closure is not None:
            with torch.enable_grad():
                closure()
        with torch.no_grad():
            self._lbfgs_step()

    def _lbfgs_step(self):
        params = [p for p in self._parameter_list()
                  if p.requires_grad and p.grad is not None]
        if not params:
            return
        flat = self._flat(params)
        grad = self._flat([p.grad for p in params])
        if self._prev_flat is not None:
            s = flat - self._prev_flat
            y = grad - self._prev_grad
            if float(torch.dot(s, y)) > 1e-10:
                self._hist_s.append(s)
                self._hist_y.append(y)
                if len(self._hist_s) > self._history_size:
                    self._hist_s.pop(0)
                    self._hist_y.pop(0)
        q = grad
        alphas = []
        for s, y in zip(reversed(self._hist_s), reversed(self._hist_y)):
            rho = 1.0 / torch.dot(y, s)
            a = rho * torch.dot(s, q)
            q = q - a * y
            alphas.append((a, rho, s, y))
        if self._hist_s:
            s, y = self._hist_s[-1], self._hist_y[-1]
            q = q * (torch.dot(s, y) / torch.dot(y, y))
        for a, rho, s, y in reversed(alphas):
            b = rho * torch.dot(y, q)
            q = q + (a - b) * s
        new_flat = flat + self.get_lr() * -q
        self._prev_flat = flat
        self._prev_grad = grad
        offset = 0
        for p in params:
            n = p.numel()
            p.copy_(new_flat[offset:offset + n].reshape(p.shape))
            offset += n
        self._step_count += 1


class ASGD(Optimizer):
    """Stochastic average gradient over a ring of the last ``batch_num``
    gradients: ``i = m % n; d += grad - y_i; y_i = grad; param -= lr * d
    / min(m + 1, n)``."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        if batch_num < 1:
            raise ValueError("batch_num must be >= 1")
        self._n = int(batch_num)

    def _init_state(self, p):
        return {"d": _zeros(p),
                "y": torch.zeros((self._n,) + tuple(p.shape), dtype=p.dtype,
                                 device=p.device)}

    def _update_one(self, param, grad, state, lr, step):
        m = step - 1
        i = m % self._n
        d = state["d"] - state["y"][i] + grad
        y = state["y"].clone()
        y[i] = grad
        denom = _scalar(min(m + 1, self._n), param)
        return param - lr * d / denom, {"d": d, "y": y}


class Rprop(Optimizer):
    """Resilient backprop: per-element step sizes grow by ``etas[1]``
    while the gradient keeps its sign and shrink by ``etas[0]`` on a
    flip (where the step is skipped), clamped to
    ``learning_rate_range``; the update is ``sign(grad) * step``."""

    def __init__(self, learning_rate=0.001,
                 learning_rate_range=(1e-5, 50.0), parameters=None,
                 etas=(0.5, 1.2), grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._lr0 = float(learning_rate)
        self._lr_min, self._lr_max = (float(learning_rate_range[0]),
                                      float(learning_rate_range[1]))
        self._eta_neg, self._eta_pos = float(etas[0]), float(etas[1])

    def _init_state(self, p):
        return {"prev": _zeros(p),
                "lr": torch.full_like(p, self._lr0,
                                      memory_format=torch.contiguous_format)}

    def _update_one(self, param, grad, state, lr, step):
        rate = state["lr"]
        product = grad * state["prev"]
        eta = torch.where(product > 0, torch.full_like(rate, self._eta_pos),
                          torch.where(product < 0,
                                      torch.full_like(rate, self._eta_neg),
                                      torch.ones_like(rate)))
        grad = torch.where(product < 0, torch.zeros_like(grad), grad)
        lr_elt = torch.clamp(rate * eta, self._lr_min, self._lr_max)
        new_p = param - torch.sign(grad) * lr_elt
        return new_p, {"prev": grad, "lr": lr_elt}
