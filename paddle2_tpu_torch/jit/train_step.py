"""The training step: the counterpart of
``paddle2_tpu/jit/train_step.py``.

Usage::

    step = paddle2_tpu_torch.jit.train_step(train_fn, optimizer)
    for ids, labels in batches:
        loss = step(ids, labels)      # forward, backward, update

One call runs the forward, the backward and the optimizer's update, and
updates the parameters and the optimizer's states in place. The JAX
package traces all three into one donated XLA program; the port runs
them eagerly (torch's autograd is its tape), so a step costs what its
kernels and launches cost. As in the JAX package, a parameter the loss
does not reach gets an all-zeros gradient and is still updated (decay
and moments apply to it); the eager ``optimizer.step()`` skips it.

Module buffers follow the forward. ``fn`` runs once a call, so a
``BatchNorm2D`` in training mode folds the batch's statistics into its
``_mean`` and ``_variance`` once a step, in place, as the JAX step
writes its captured buffers back once
(``paddle2_tpu/jit/train_step.py:148,308-309``); in eval mode they are
read, not written. The step leaves the modules' mode to the caller.

**Metrics.** While the metrics plane is on
(:mod:`paddle2_tpu_torch.observability.metrics`), a call runs inside
its ``phase("compute")`` and then closes the step window with
``step_end(tokens=, samples=)``, by the JAX step's rule
(``paddle2_tpu/jit/train_step.py:285-298, :315-341``): the first tensor
argument gives ``samples`` (its leading dimension) and, when it is
2-D of int16/int32/int64 (token ids; int8 never is), ``tokens`` = B·S.
The hooks read nothing off the device and add no synchronization, so
``compute_s`` is the host's time to enqueue the step on a CUDA card, as
it is the JAX step's dispatch time. The JAX step's compile counter
(``train_step_compiles_total``) and program-cache gauge
(``train_step_program_cache_size``) have no counterpart in an eager
step and are not written. With the plane off a hook costs one
attribute load. ``collect_cost = True`` runs each call under
:func:`~paddle2_tpu_torch.observability.cost_model.program_cost` and
keeps its result as ``last_cost`` (``cost_model.step_cost_of_program``
reads it).

Not ported yet, and refused: optimizer wrappers (ZeRO sharding,
gradient accumulation; ROADMAP queue 1 item 6), and the reliability
plane with ``instrument=``, the JAX step's in-program sentinel and
chaos seam (queue 1 item 7). There is no CUDA-graph capture of the
step yet (PERF.md, open questions).
"""

from typing import Any, Callable, Optional, Sequence

import torch

from ..observability import metrics as _metrics
from ..optimizer import Optimizer

# token ids: 2-D tensors of these types (int8 is a quantized payload)
_TOKEN_DTYPES = (torch.int16, torch.int32, torch.int64)

__all__ = ["train_step", "TrainStepProgram"]


class TrainStepProgram:
    """``fn`` (returning a scalar loss, or a tuple whose first element
    is the loss) plus ``optimizer``'s update, run as one call."""

    def __init__(self, fn: Callable, optimizer, instrument: bool = False):
        if not isinstance(optimizer, Optimizer):
            raise NotImplementedError(
                f"train_step takes a paddle2_tpu_torch optimizer; "
                f"wrappers such as {type(optimizer).__name__} are not "
                f"ported yet (ROADMAP queue 1 item 6)")
        if instrument:
            raise NotImplementedError(
                "instrument= (the reliability plane's in-program sentinel) "
                "is not ported yet (ROADMAP queue 1 item 7)")
        self.fn = fn
        self.optimizer = optimizer
        self.collect_cost = False
        self.last_cost: Optional[dict] = None

    def __call__(self, *args, **kwargs) -> torch.Tensor:
        pl = _metrics._ACTIVE
        if pl is not None:
            pl.phase_enter("compute")
        try:
            if self.collect_cost:
                from ..observability.cost_model import program_cost
                out = []
                self.last_cost = program_cost(
                    lambda: out.append(self._step(*args, **kwargs)), ())
                loss = out[0]
            else:
                loss = self._step(*args, **kwargs)
        finally:
            if pl is not None:
                pl.phase_exit()
        if pl is not None:
            _note_step_metrics(pl, args)
        return loss

    def _step(self, *args, **kwargs) -> torch.Tensor:
        params = [p for p in self.optimizer._parameter_list()
                  if p.requires_grad]
        for p in params:
            p.grad = None
        out = self.fn(*args, **kwargs)
        loss = out[0] if isinstance(out, tuple) else out
        loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        return loss.detach()


def _note_step_metrics(pl, args) -> None:
    """Close the step window with what the host knows of the batch (the
    JAX step's rule): ``samples`` from the first tensor argument's
    leading dimension, ``tokens`` = B·S when it is 2-D token ids."""
    tokens = samples = None
    first = next((a for a in args if isinstance(a, torch.Tensor)), None)
    if first is not None and first.dim():
        samples = int(first.shape[0])
        if first.dim() == 2 and first.dtype in _TOKEN_DTYPES:
            tokens = int(first.shape[0]) * int(first.shape[1])
    pl.step_end(tokens=tokens, samples=samples)


def train_step(fn: Callable, optimizer, layers: Optional[Sequence] = None,
               reliability: Any = None) -> TrainStepProgram:
    """One call of the returned program runs ``fn``, its backward and
    ``optimizer``'s update. ``layers`` (a module or a sequence of
    modules), as the JAX package takes it, names the modules ``fn``
    trains. The JAX package collects their state for its traced
    program; here the optimizer holds the parameters and the modules
    hold their buffers, so ``layers`` changes nothing, but every
    parameter of theirs that requires a gradient must be in the
    optimizer's parameter list, or the call raises ``ValueError``
    naming it: the step would leave it untrained."""
    if reliability not in (None, False):
        raise NotImplementedError(
            "train_step(reliability=...) is not ported yet (ROADMAP "
            "queue 1 item 7)")
    program = TrainStepProgram(fn, optimizer)
    if layers is not None:
        _check_layers(layers, optimizer)
    return program


def _check_layers(layers, optimizer) -> None:
    if isinstance(layers, torch.nn.Module):
        layers = [layers]
    owned = {id(p) for p in optimizer._parameter_list()}
    for i, layer in enumerate(layers):
        if not isinstance(layer, torch.nn.Module):
            raise TypeError(f"train_step(layers=...): item {i} is a "
                            f"{type(layer).__name__}, not a module")
        for name, p in layer.named_parameters():
            if p.requires_grad and id(p) not in owned:
                raise ValueError(
                    f"train_step(layers=...): parameter {name!r} of layer "
                    f"{i} ({type(layer).__name__}) requires a gradient "
                    f"but is not in the optimizer's parameter list")
