"""Stacked block storage: the counterpart of ``StackedLayerStack`` in
``paddle2_tpu/models/_scan.py``.

The JAX package stores a homogeneous block stack as one ``[L, ...]``
parameter per leaf of a template block (named ``stacked_<name with . ->
__>``) and runs it as one ``lax.scan``. Torch has no scan: the port runs
a Python loop over the layers, binding the template's leaves to layer
``i``'s slices for the call, as the JAX package's ``_rebind`` /
``_restore`` do on its eager path. The slices come from one
``torch.unbind`` of each leaf per forward, so the backward stacks the
layers' gradients into each leaf once.

Unlike the JAX package, eager training works: torch's autograd reaches
the stacked leaves through the slices, so the JAX package's guard
against a backward through its eager slice path (``_scan.py:25-58``)
has nothing to guard.
"""

import contextlib
import functools
from typing import Iterator, List, Optional, Sequence

import torch
from torch import nn

from ..distributed.recompute import recompute

__all__ = ["StackedLayerStack"]


def _leaf_name(name: str) -> str:
    return "stacked_" + name.replace(".", "__")


class StackedLayerStack(nn.Module):
    """Blocks stored as one ``[L, ...]`` parameter per template leaf.

    Built from ``blocks`` (initialised, homogeneous); the first block
    becomes the template and gives up its own parameters, so only the
    stacked leaves are trained, saved and cast."""

    def __init__(self, blocks: Sequence[nn.Module]):
        super().__init__()
        tmpl = blocks[0]
        self._names: List[str] = sorted(n for n, _ in tmpl.named_parameters())
        self.n_layers = len(blocks)
        per = [dict(b.named_parameters()) for b in blocks]
        for n in self._names:
            self.register_parameter(_leaf_name(n), nn.Parameter(
                torch.stack([p[n].detach() for p in per])))
        self._slots = []
        for n in self._names:
            path, _, attr = n.rpartition(".")
            mod = tmpl.get_submodule(path)
            del mod._parameters[attr]
            setattr(mod, attr, None)      # bound per call
            self._slots.append((mod, attr))
        self._template = tmpl

    def stacked_leaf(self, name: str) -> nn.Parameter:
        return getattr(self, _leaf_name(name))

    def _slices(self) -> List[Sequence[torch.Tensor]]:
        return [torch.unbind(self.stacked_leaf(n)) for n in self._names]

    @contextlib.contextmanager
    def _bound(self, tensors) -> Iterator[nn.Module]:
        for (mod, attr), t in zip(self._slots, tensors):
            setattr(mod, attr, t)
        try:
            yield self._template
        finally:
            for mod, attr in self._slots:
                setattr(mod, attr, None)

    def _run(self, x, *tensors, **kwargs):
        with self._bound(tensors) as block:
            return block(x, **kwargs)

    def forward(self, x, remat: Optional[str] = None, **kwargs):
        """All layers in order, each called as ``block(x, **kwargs)``
        (ERNIE passes its ``attn_bias`` so). ``remat`` None runs them
        plainly; a granularity name checkpoints each layer with that
        policy."""
        slices = self._slices()
        run = functools.partial(self._run, **kwargs)
        for i in range(self.n_layers):
            layer = [s[i] for s in slices]
            if remat is None:
                x = run(x, *layer)
            else:
                x = recompute(run, x, *layer, policy=remat)
        return x

    def layer(self, i: int):
        """Context manager: the template bound to layer ``i``'s weights.
        The one way to address a single block (the JAX package's
        ``layer_slice_call``, whose keyword arguments the caller passes
        to the block it gets), through ``GPTModel.blocks()``: the
        decode path and the paged serving runner."""
        return self._bound([self.stacked_leaf(n)[i] for n in self._names])
