"""``paddle.autograd.saved_tensors_hooks`` is
``torch.autograd.graph.saved_tensors_hooks``: a (pack, unpack) pair over
the tensors saved for backward in its region. Unlike the JAX package's,
whose per-op residuals live inside XLA closures, it reaches every saved
tensor, not only those a ``PyLayer`` saves."""

from torch.autograd.graph import saved_tensors_hooks  # noqa: F401

__all__ = ["saved_tensors_hooks"]
