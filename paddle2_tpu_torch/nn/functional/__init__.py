"""Functional layers of the port: only what its models and the packed
varlen attention need so far (the rest is ROADMAP queue 1 item 2)."""

from ...kernels.attention import scaled_dot_product_attention
from .conv import conv2d
from .flash_attention import (flash_attn_qkvpacked, flash_attn_unpadded,
                              flash_attn_varlen_qkvpacked,
                              flashmask_attention, sdp_kernel,
                              sparse_attention)
from .loss import cross_entropy
from .norm import batch_norm, layer_norm
from .pooling import adaptive_avg_pool2d, max_pool2d
# as in the JAX package, ``nn.functional.flash_attention`` is the module
# (callers write ``F.flash_attention.flash_attention(...)``)
from . import flash_attention  # noqa: E402,F401

__all__ = ["layer_norm", "batch_norm", "conv2d", "max_pool2d",
           "adaptive_avg_pool2d", "cross_entropy",
           "scaled_dot_product_attention", "flash_attn_unpadded",
           "flash_attn_varlen_qkvpacked", "flash_attn_qkvpacked",
           "flashmask_attention", "sparse_attention", "sdp_kernel"]
