"""Functional layers of the port: only what its models need so far (the
rest is ROADMAP queue 1 item 2)."""

from .norm import layer_norm

__all__ = ["layer_norm"]
