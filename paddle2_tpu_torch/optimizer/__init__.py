"""Optimizers of the port (counterpart of ``paddle2_tpu.optimizer``):
the base class, Adam and AdamW so far."""

from .optimizer import Optimizer
from .optimizers import Adam, AdamW

__all__ = ["Optimizer", "Adam", "AdamW"]
