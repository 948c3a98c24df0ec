"""Functional layers of the port: only what its models need so far (the
rest is ROADMAP queue 1 item 2)."""

from .conv import conv2d
from .loss import cross_entropy
from .norm import batch_norm, layer_norm
from .pooling import adaptive_avg_pool2d, max_pool2d

__all__ = ["layer_norm", "batch_norm", "conv2d", "max_pool2d",
           "adaptive_avg_pool2d", "cross_entropy"]
