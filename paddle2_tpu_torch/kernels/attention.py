"""Scaled dot-product attention for the port's models.

Counterpart of ``paddle2_tpu/kernels/attention.py``. The JAX package
sent long sequences on an accelerator to its Pallas flash kernel
(S >= 1024, a TPU VMEM threshold) and everything else to an XLA
softmax. The port has one route: every call goes through
:func:`~.flash_attn.flash_attention_bshd`, which launches the CUDA
kernel for a CUDA tensor at every length and runs the kernel's plain
version for a CPU tensor. Attention masks and attention dropout belong
to later slices and raise.
"""

from __future__ import annotations

from typing import Optional

from .flash_attn import flash_attention_bshd

__all__ = ["scaled_dot_product_attention"]


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
            "attention dropout belongs to the training slice "
            "(ROADMAP slice 2)")
    return flash_attention_bshd(query, key, value, causal=is_causal,
                                scale=scale)
