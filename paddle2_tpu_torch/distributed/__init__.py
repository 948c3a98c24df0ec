"""Distributed training: activation recomputation, and the parts of
``fault_tolerance`` the serving plane calls (the flight recorder, the
chaos injector's grammar and serving hooks, ``HealthReport``). The rest
is ROADMAP queue 1 items 6 and 7."""

from .recompute import recompute

__all__ = ["recompute"]
