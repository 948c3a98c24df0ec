"""Neural-network layers of the port: what its models need beyond
``torch.nn``, and gradient clipping (``ClipGradBy*``,
``clip_grad_norm_``, ``clip_grad_value_``); the rest of the JAX
package's ``nn`` is ROADMAP queue 1 item 2."""

from . import functional
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .conv import Conv2D
from .norm import BatchNorm2D, LayerNorm
from .pooling import AdaptiveAvgPool2D, MaxPool2D

__all__ = ["LayerNorm", "BatchNorm2D", "Conv2D", "MaxPool2D",
           "AdaptiveAvgPool2D", "functional", "ClipGradByValue",
           "ClipGradByNorm", "ClipGradByGlobalNorm", "clip_grad_norm_",
           "clip_grad_value_"]
