"""Neural-network layers of the port: only what its models need beyond
``torch.nn`` so far (the rest is ROADMAP queue 1 item 2)."""

from . import functional
from .conv import Conv2D
from .norm import BatchNorm2D, LayerNorm
from .pooling import AdaptiveAvgPool2D, MaxPool2D

__all__ = ["LayerNorm", "BatchNorm2D", "Conv2D", "MaxPool2D",
           "AdaptiveAvgPool2D", "functional"]
