"""Incubating nn APIs of the port."""

from . import functional

__all__ = ["functional"]
