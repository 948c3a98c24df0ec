"""The port's kernels. Importing this package builds nothing: see
:mod:`._build` for when and how the CUDA sources are compiled."""

from .attention import scaled_dot_product_attention
from .flash_attn import (flash_attention_bshd, flash_fwd,
                         flash_fwd_reference)

__all__ = ["scaled_dot_product_attention", "flash_attention_bshd",
           "flash_fwd", "flash_fwd_reference"]
