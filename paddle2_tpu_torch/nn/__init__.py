"""Neural-network layers of the port: only what its models need beyond
``torch.nn`` so far (the rest is ROADMAP queue 1 item 2)."""

from . import functional
from .norm import LayerNorm

__all__ = ["LayerNorm", "functional"]
