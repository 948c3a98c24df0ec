"""Gradient clipping: the counterpart of ``paddle2_tpu/nn/clip.py`` and
of ``clip_grad_norm_``/``clip_grad_value_`` in
``paddle2_tpu/nn/utils_mod.py``.

A clip object is attached to an optimizer (``grad_clip=``), which
applies :meth:`apply_arrays` to the gradients of the parameters whose
``need_clip`` attribute is not False, before the update, on the eager
and the fused routes alike; ``__call__`` is the same clip on ``(param,
grad)`` pairs, honouring ``need_clip`` itself. Each is the JAX
package's arithmetic in torch ops: a norm by value clips in the
gradient's dtype, the global norm in f32, each clipped gradient cast
back to its own dtype.
"""

from typing import Iterable, List, Tuple

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_", "clip_grad_value_"]


def _over(c: float, x: torch.Tensor) -> torch.Tensor:
    """``c / x`` rounded once in ``x``'s dtype (``float / tensor`` in
    torch multiplies by the reciprocal, which rounds twice)."""
    return torch.full_like(x, c) / x


def _clippable(p, g) -> bool:
    return g is not None and getattr(p, "need_clip", True)


class ClipGradBase:
    def __call__(self, params_grads: List[Tuple[torch.Tensor, torch.Tensor]]):
        out = []
        for p, g in params_grads:
            out.append((p, self._clip_one(g) if _clippable(p, g) else g))
        return out

    def _clip_one(self, g):
        raise NotImplementedError

    def apply_arrays(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The clip over a flat list of gradients (the optimizer's
        form)."""
        return [self._clip_one(g) for g in grads]


class ClipGradByValue(ClipGradBase):
    """Each element into ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):  # noqa: A002 — paddle's names
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip_one(self, g):
        return torch.clamp(g, self.min, self.max)


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to an L2 norm of at most ``clip_norm``, the
    norm taken in the gradient's dtype."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip_one(self, g):
        norm = torch.sqrt(torch.sum(torch.square(g)))
        scale = torch.clamp(_over(self.clip_norm,
                                  torch.clamp(norm, min=1e-12)), max=1.0)
        return g * scale


class ClipGradByGlobalNorm(ClipGradBase):
    """Every gradient scaled by ``min(clip_norm / global norm, 1)``, the
    global norm the f32 L2 norm over all of them. ``group_name`` and
    ``auto_skip_clip`` are taken and kept, as the JAX package does."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name
        self.auto_skip_clip = auto_skip_clip

    def _scale(self, grads):
        total = 0
        for g in grads:
            total = total + torch.sum(torch.square(g.float()))
        gnorm = torch.sqrt(total)
        return torch.clamp(_over(self.clip_norm,
                                 torch.clamp(gnorm, min=1e-12)), max=1.0)

    def __call__(self, params_grads):
        live = [g for p, g in params_grads if _clippable(p, g)]
        if not live:
            return params_grads
        scale = self._scale(live)
        return [(p, (g.float() * scale).to(g.dtype) if _clippable(p, g)
                 else g) for p, g in params_grads]

    def apply_arrays(self, grads):
        if not grads:
            return grads
        scale = self._scale(grads)
        return [(g.float() * scale).to(g.dtype) for g in grads]


def _param_list(parameters) -> list:
    if isinstance(parameters, torch.Tensor):
        return [parameters]
    return list(parameters)


@torch.no_grad()
def clip_grad_norm_(parameters: Iterable[torch.Tensor], max_norm,
                    norm_type=2.0, error_if_nonfinite=False):
    """Scale the gradients in place to a total ``norm_type`` norm of at
    most ``max_norm`` (``max_norm / (norm + 1e-6)``, capped at 1); returns
    the total norm (f32)."""
    params = [p for p in _param_list(parameters) if p.grad is not None]
    if not params:
        return torch.zeros(())
    dev = params[0].grad.device
    if norm_type == float("inf"):
        total = max(float(torch.max(torch.abs(p.grad))) for p in params)
        total_norm = torch.tensor(total, dtype=torch.float32, device=dev)
    else:
        total_norm = torch.sum(torch.stack(
            [torch.sum(torch.abs(p.grad.float()) ** norm_type)
             for p in params])) ** (1.0 / norm_type)
    scale = torch.clamp(_over(max_norm, total_norm + 1e-6), max=1.0)
    for p in params:
        p.grad.copy_((p.grad.float() * scale).to(p.grad.dtype))
    return total_norm


@torch.no_grad()
def clip_grad_value_(parameters: Iterable[torch.Tensor], clip_value) -> None:
    """Clamp every gradient in place into ``[-clip_value, clip_value]``."""
    for p in _param_list(parameters):
        if p.grad is not None:
            p.grad.copy_(torch.clamp(p.grad, -clip_value, clip_value))
