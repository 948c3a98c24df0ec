"""Activation recomputation: the counterpart of
``paddle2_tpu/distributed/recompute.py``.

The JAX package wraps the block's pure function in ``jax.checkpoint``
with a policy; the port wraps the call in
``torch.utils.checkpoint.checkpoint`` (non-reentrant) with the matching
selective-checkpoint context from
:func:`paddle2_tpu_torch.kernels.attention.remat_policy`.
"""

import torch.utils.checkpoint

from ..kernels.attention import remat_policy

__all__ = ["recompute"]


def recompute(function, *args, policy=None):
    """Run ``function(*args)`` with activation checkpointing. ``policy``
    is a granularity name: None or "full" keeps only the inputs and
    recomputes the rest in the backward; "dots" also keeps matrix
    products and the flash op's outputs."""
    context_fn = remat_policy(policy or "full")
    kwargs = {} if context_fn is None else {"context_fn": context_fn}
    return torch.utils.checkpoint.checkpoint(function, *args,
                                             use_reentrant=False, **kwargs)
