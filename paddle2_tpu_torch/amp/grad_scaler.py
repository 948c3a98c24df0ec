"""Dynamic loss scaling: the counterpart of
``paddle2_tpu/amp/grad_scaler.py``.

Every parameter, method and rule of the JAX package's ``GradScaler`` is
kept: the per-optimizer unscaled/found-inf state (two optimizers may
share one scaler), the growth and backoff rules, the clamp to
``[min_loss_scaling, max_loss_scaling]``, and
:class:`ScaleSaturationError` after ``max_consecutive_skips`` skipped
steps in a row.

``unscale_`` is one check over all of an optimizer's gradients with the
unscale multiply folded in and one host readback
(:func:`grads_nonfinite_flag`, :func:`flag_to_host`, the port's copies
of the JAX package's ``fault_tolerance.numerics`` helpers, in torch's
multi-tensor ops). Across processes the flag is reduced by
:func:`all_reduce_found_inf`, the identity on one process: its
collective comes with data parallelism (ROADMAP queue 1 item 6). The
metrics hooks of the JAX scaler are kept (``paddle2_tpu/amp/
grad_scaler.py:160-163, :200``): :meth:`GradScaler.update` adds one to
the ``amp_skipped_steps_total`` counter for a skipped step and sets the
``amp_loss_scale`` gauge, on the metrics plane when it is on
(:mod:`paddle2_tpu_torch.observability.metrics`). Its flight-recorder
and chaos hooks come with fault tolerance, and ``note_fused_step`` with
``train_step(reliability=)`` (both ROADMAP queue 1 item 7).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..observability import metrics as _metrics

__all__ = ["GradScaler", "ScaleSaturationError", "grads_nonfinite_flag",
           "flag_to_host", "all_reduce_found_inf"]


class ScaleSaturationError(RuntimeError):
    """Dynamic loss scaling skipped too many consecutive steps: the
    gradients are persistently non-finite, which no scale can fix — a
    numerics bug, not an overflow."""


def grads_nonfinite_flag(optimizer, inv_scale: Optional[float] = None
                         ) -> Tuple[Optional[torch.Tensor], List]:
    """One device-side flag over ``optimizer``'s gradients: a 0-d bool
    tensor, True where any of them (times ``inv_scale`` in f32, when
    given) holds a NaN or an infinity, or None when no parameter has a
    gradient. Returns ``(flag, [(param, f32 gradient), ...])``; nothing
    is read back."""
    params = [p for p in optimizer._parameter_list() if p.grad is not None]
    if not params:
        return None, []
    grads = [p.grad.float() for p in params]
    if inv_scale is not None:
        grads = torch._foreach_mul(grads, inv_scale)
    bad = [torch.logical_not(torch.isfinite(g)).any() for g in grads]
    return torch.stack(bad).any(), list(zip(params, grads))


def all_reduce_found_inf(flag, group=None):
    """The flag, made the same on every data-parallel rank: the identity
    on one process (data parallelism is ROADMAP queue 1 item 6)."""
    return flag


def flag_to_host(flag) -> bool:
    """The one host readback of a flag (False for None)."""
    if flag is None:
        return False
    if isinstance(flag, bool):
        return flag
    return bool(flag.item())


class GradScaler:
    """``paddle.amp.GradScaler``: ``scale(loss).backward()``, then
    ``step(optimizer)`` (unscale, skip on a non-finite gradient) and
    ``update()`` (move the scale). ``enable=False`` makes every method a
    passthrough."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True,
                 min_loss_scaling=1.0, max_loss_scaling=2.0 ** 32,
                 max_consecutive_skips=100):
        if min_loss_scaling > max_loss_scaling:
            raise ValueError(
                f"min_loss_scaling ({min_loss_scaling}) must be <= "
                f"max_loss_scaling ({max_loss_scaling})")
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._min_scale = float(min_loss_scaling)
        self._max_scale = float(max_loss_scaling)
        self._max_consecutive_skips = int(max_consecutive_skips)
        self._good_steps = 0
        self._bad_steps = 0
        self._consecutive_skips = 0
        # per-optimizer flags: one optimizer's scale()/unscale_ cycle
        # must not erase another's inf detection
        self._opt_state: Dict[int, Dict[str, bool]] = {}
        self._cycle_found_inf = False       # the union since update()

    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._dynamic

    def get_loss_scaling(self) -> float:
        return self._scale

    def set_init_loss_scaling(self, v) -> None:
        self._scale = float(v)

    def scale(self, loss: torch.Tensor) -> torch.Tensor:
        if not self._enable:
            return loss
        # a new backward cycle: clear the unscaled flags, keep the inf
        # detections for update()
        for st in self._opt_state.values():
            st["unscaled"] = False
        return loss * self._scale

    def _state_for(self, optimizer) -> Dict[str, bool]:
        st = self._opt_state.get(id(optimizer))
        if st is None:
            st = {"unscaled": False, "found_inf": False}
            self._opt_state[id(optimizer)] = st
        return st

    @torch.no_grad()
    def unscale_(self, optimizer) -> None:
        """Divide ``optimizer``'s gradients by the scale, in place (each
        keeps its dtype), and note whether any is non-finite."""
        st = self._state_for(optimizer)
        if not self._enable or st["unscaled"]:
            return
        flag, unscaled = grads_nonfinite_flag(optimizer, 1.0 / self._scale)
        for p, g in unscaled:
            if g is not p.grad:
                p.grad.copy_(g)
        found_inf = flag_to_host(all_reduce_found_inf(flag))
        st["found_inf"] = found_inf
        st["unscaled"] = True
        self._cycle_found_inf = self._cycle_found_inf or found_inf

    def step(self, optimizer) -> None:
        """Unscale and step unless a gradient is non-finite. Does not move
        the scale: call :meth:`update` after."""
        if not self._enable:
            optimizer.step()
            return
        st = self._state_for(optimizer)
        if not st["unscaled"]:
            self.unscale_(optimizer)
        if not st["found_inf"]:
            optimizer.step()

    def note_fused_step(self, found_inf: bool) -> None:
        """The host half of a fused ``train_step(reliability=)`` cycle,
        which is ROADMAP queue 1 item 7."""
        raise NotImplementedError(
            "note_fused_step consumes train_step(reliability=)'s flag, "
            "which is not ported yet (ROADMAP queue 1 item 7)")

    def minimize(self, optimizer, loss) -> None:
        """``step`` and ``update`` in one call."""
        self.step(optimizer)
        if self._enable:
            self.update()

    def update(self) -> None:
        """Move the scale: back off after ``decr_every_n_nan_or_inf`` bad
        cycles, grow after ``incr_every_n_steps`` good ones."""
        if not self._enable:
            return
        if not self._dynamic:
            self._opt_state.clear()
            self._cycle_found_inf = False
            return
        if self._cycle_found_inf:
            _metrics.inc("amp_skipped_steps_total")
            self._consecutive_skips += 1
            if self._consecutive_skips >= self._max_consecutive_skips:
                raise ScaleSaturationError(
                    f"{self._consecutive_skips} consecutive steps "
                    f"produced non-finite gradients (scale now "
                    f"{self._scale:g}, floor {self._min_scale:g}) — no "
                    f"loss scale can fix persistently bad numerics; "
                    f"bisect with FLAGS_check_nan_inf=1")
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio,
                                  self._min_scale)
                self._bad_steps = 0
        else:
            self._consecutive_skips = 0
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale = min(self._scale * self._incr_ratio,
                                  self._max_scale)
                self._good_steps = 0
        self._opt_state.clear()
        self._cycle_found_inf = False
        _metrics.set_gauge("amp_loss_scale", self._scale)

    def state_dict(self) -> Dict:
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every,
                "decr_every_n_nan_or_inf": self._decr_every,
                "good_steps": self._good_steps, "bad_steps": self._bad_steps,
                "min_scale": self._min_scale, "max_scale": self._max_scale,
                "consecutive_skips": self._consecutive_skips}

    def load_state_dict(self, state: Dict) -> None:
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)
        self._min_scale = state.get("min_scale", self._min_scale)
        self._max_scale = state.get("max_scale", self._max_scale)
        self._consecutive_skips = state.get("consecutive_skips", 0)
