"""Distributed training: only activation recomputation is ported so far
(the rest is ROADMAP queue 1 item 6)."""

from .recompute import recompute

__all__ = ["recompute"]
