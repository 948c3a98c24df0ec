"""The port's kernels. Importing this package builds nothing: see
:mod:`._build` for when and how the CUDA sources are compiled."""

from .attention import remat_policy, scaled_dot_product_attention
from .flash_attn import (flash_attention_bshd, flash_bwd,
                         flash_bwd_reference, flash_fwd,
                         flash_fwd_reference)
from .fused_adamw import adamw_step, adamw_step_reference
from .fused_ce import fused_linear_cross_entropy

__all__ = ["scaled_dot_product_attention", "remat_policy",
           "flash_attention_bshd", "flash_fwd", "flash_fwd_reference",
           "flash_bwd", "flash_bwd_reference", "adamw_step",
           "adamw_step_reference", "fused_linear_cross_entropy"]
