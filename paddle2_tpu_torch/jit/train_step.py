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
    ``optimizer``'s update. ``layers`` must be None: the JAX package
    collects the layers' state from it for its traced program, while
    here the optimizer holds the parameters and the modules hold their
    buffers."""
    if layers is not None:
        raise ValueError(
            "train_step(layers=...) has no use in the port: the optimizer "
            "holds the parameters; pass none")
    if reliability not in (None, False):
        raise NotImplementedError(
            "train_step(reliability=...) is not ported yet (ROADMAP "
            "queue 1 item 7)")
    return TrainStepProgram(fn, optimizer)
