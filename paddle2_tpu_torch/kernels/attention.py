"""Scaled dot-product attention for the port's models, and the remat
policy that goes with it.

Counterpart of ``paddle2_tpu/kernels/attention.py``. The JAX package
sent long sequences on an accelerator to its Pallas flash kernel
(S >= 1024, a TPU VMEM threshold) and everything else to an XLA
softmax. The port has one route: every call goes through
:func:`~.flash_attn.flash_attention_bshd`, differentiable, which
launches the CUDA kernels for a CUDA tensor at every length and runs
their plain versions for a CPU tensor. Attention masks and attention
dropout belong to later slices and raise.
"""

import functools
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from .flash_attn import flash_attention_bshd

__all__ = ["scaled_dot_product_attention", "remat_policy"]

_aten = torch.ops.aten


def _dots_policy(ctx, op, *args, **kwargs):
    """"dots": keep the outputs of matrix products without batch
    dimensions (``mm``/``addmm``, as JAX's
    ``dots_with_no_batch_dims_saveable``) and of the flash op (its
    ``(o, lse)``, as the JAX package's ``flash_out``/``flash_lse``
    names); recompute everything else."""
    if op in (_aten.mm.default, _aten.addmm.default,
              torch.ops.paddle2_tpu_torch.flash_attn.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_policy(base: str = "dots") -> Optional[Callable]:
    """The ``context_fn`` that ``torch.utils.checkpoint.checkpoint``
    takes for a granularity: "dots" is the selective policy above;
    "full" and "nothing" mean full recompute (None: checkpoint saves
    the block's inputs only). The JAX package's other policies
    ("dots_plus", "dots_plus_ln", "offload", "search") are not ported
    yet (ROADMAP queue 1 item 2)."""
    if base in ("full", "nothing"):
        return None
    if base == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _dots_policy)
    raise NotImplementedError(
        f"remat granularity {base!r} is not ported yet (ROADMAP queue 1 "
        f"item 2); use 'dots' or 'full'")


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 scale: Optional[float] = None):
    """Attention on ``(batch, seq, num_heads, head_dim)`` tensors. The
    causal mask is aligned to the bottom right, as in the JAX package:
    with ``Sq < Sk`` row ``r`` sees keys ``c <= r + Sk - Sq``."""
    if attn_mask is not None:
        raise NotImplementedError(
            "attention masks are not ported yet (ROADMAP queue 1)")
    if dropout_p > 0.0:
        raise NotImplementedError(
            "attention dropout is not ported yet (ROADMAP queue 1 item 2)")
    return flash_attention_bshd(query, key, value, causal=is_causal,
                                scale=scale)
