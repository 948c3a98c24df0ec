"""``paddle.nn.utils``: the counterpart of
``paddle2_tpu/nn/utils/__init__.py``: the weight reparametrizations,
the parameter/vector helpers and the gradient clips.

- ``weight_norm`` adds ``<name>_v`` and ``<name>_g`` (``g`` the norm of
  the weight over every axis but ``dim``; ``dim=None`` means the LAST
  axis, as in the JAX package), stops the original weight's gradient
  and recomputes the weight as ``g * v / max(||v||, 1e-12)`` in a
  forward pre-hook. The layer's attribute is the recomputed tensor; the
  original parameter stays in the state and takes the first forward's
  value, as the JAX hook leaves it;
- ``remove_weight_norm`` folds the weight back into the original
  parameter and drops the two, so that the state is as before;
- ``spectral_norm`` trains ``<name>_orig``: every forward runs
  ``n_power_iterations`` of the power iteration on it (without
  gradient) from the carried ``u`` and ``v``, which start from
  ``numpy.random.RandomState(0)`` and ``(1)`` normal draws as the JAX
  package's do, and divides it by ``u @ (W v)``;
- ``parameters_to_vector`` / ``vector_to_parameters`` flatten and
  refill, without gradient.

torch's own ``weight_norm``/``spectral_norm`` are not used: their
parameter names and rules differ.
"""

import numpy as np
import torch

from ..utils_mod import clip_grad_norm_, clip_grad_value_  # noqa: F401
from ...amp.casting import cast_call
from ...framework import core

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm",
           "parameters_to_vector", "vector_to_parameters",
           "clip_grad_norm_", "clip_grad_value_"]


def _norm_except(w, dim):
    axes = tuple(i for i in range(w.ndim) if i != dim)
    return torch.sqrt(torch.sum(torch.square(w), dim=axes, keepdim=True))


def _param_like(layer, value):
    """A new parameter of ``layer`` holding ``value``."""
    with core.place_scope(value.device):
        p = layer.create_parameter(list(value.shape), dtype=value.dtype)
    with torch.no_grad():
        p.copy_(value)
    return p


def _install(layer, name, out):
    """Make ``out`` the layer's ``name``; the first time, the original
    parameter takes its value."""
    if name not in layer.__dict__:
        with torch.no_grad():
            layer._parameters[name].copy_(out)
    object.__setattr__(layer, name, out)


def weight_norm(layer, name="weight", dim=0):
    w = getattr(layer, name)
    dim = (w.ndim - 1) if dim is None else int(dim)
    v = _param_like(layer, w.detach())
    g = _param_like(layer, _norm_except(w.detach(), dim))
    layer.add_parameter(f"{name}_v", v)
    layer.add_parameter(f"{name}_g", g)
    w.requires_grad_(False)

    def recompute(layer_, inputs):
        out = cast_call("weight_norm", lambda vv, gg: gg * vv / torch.clamp(
            _norm_except(vv, dim), min=1e-12), v, g)
        _install(layer_, name, out)
        return None

    handle = layer.register_forward_pre_hook(recompute)
    layer._weight_norm_state = (name, v, g, handle, w, dim)
    return layer


def remove_weight_norm(layer, name="weight"):
    state = getattr(layer, "_weight_norm_state", None)
    if state is None:
        return layer
    name_, v, g, handle, orig, dim = state
    handle.remove()
    with torch.no_grad():
        orig.copy_(g * v / torch.clamp(_norm_except(v, dim), min=1e-12))
    orig.requires_grad_(True)
    layer.__dict__.pop(name_, None)
    layer._parameters.pop(f"{name_}_v", None)
    layer._parameters.pop(f"{name_}_g", None)
    del layer._weight_norm_state
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    w = getattr(layer, name)
    dim = 0 if dim is None else int(dim)
    rows = w.shape[dim]
    cols = w.numel() // rows
    dev = w.device
    u0 = torch.tensor(np.random.RandomState(0).randn(rows),
                      dtype=torch.float32, device=dev)
    v0 = torch.tensor(np.random.RandomState(1).randn(cols),
                      dtype=torch.float32, device=dev)
    state = {"u": u0 / torch.linalg.norm(u0), "v": v0 / torch.linalg.norm(v0)}
    orig = _param_like(layer, w.detach())
    layer.add_parameter(f"{name}_orig", orig)
    w.requires_grad_(False)

    def as_matrix(t):
        return t.movedim(dim, 0).reshape(t.shape[dim], -1)

    def apply(layer_, inputs):
        with torch.no_grad():
            m = as_matrix(orig)
            u, vv = state["u"], state["v"]
            for _ in range(n_power_iterations):
                vv = m.T @ u
                vv = vv / torch.clamp(torch.linalg.norm(vv), min=eps)
                u = m @ vv
                u = u / torch.clamp(torch.linalg.norm(u), min=eps)
            state["u"], state["v"] = u, vv

        def normalized(wo):
            return wo / (u @ (as_matrix(wo) @ vv))
        _install(layer_, name, cast_call("spectral_norm", normalized, orig))
        return None

    handle = layer.register_forward_pre_hook(apply)
    layer._spectral_norm_state = (name, handle, orig)
    return layer


def parameters_to_vector(parameters, name=None):
    """The parameters flattened into one vector (no gradient)."""
    return torch.cat([p.detach().reshape(-1) for p in parameters])


def vector_to_parameters(vec, parameters, name=None):
    """Refill ``parameters`` in turn from ``vec``."""
    off = 0
    with torch.no_grad():
        for p in parameters:
            n = p.numel()
            p.copy_(vec[off:off + n].reshape(p.shape))
            off += n
