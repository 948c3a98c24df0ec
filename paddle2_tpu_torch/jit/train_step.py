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

Not ported yet, and refused: optimizer wrappers (ZeRO sharding,
gradient accumulation; ROADMAP queue 1 item 6), the reliability plane
and ``instrument=`` (queue 1 items 4 and 7). There is no CUDA-graph
capture of the step yet (PERF.md, open questions).
"""

from typing import Any, Callable, Optional, Sequence

import torch

from ..optimizer import Optimizer

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
                "instrument= is not ported yet (ROADMAP queue 1 item 4)")
        self.fn = fn
        self.optimizer = optimizer

    def __call__(self, *args, **kwargs) -> torch.Tensor:
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
