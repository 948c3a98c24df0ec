"""Optimizers of the port (counterpart of ``paddle2_tpu.optimizer``):
the base class, Momentum, Adam and AdamW so far."""

from .optimizer import Optimizer
from .optimizers import Adam, AdamW, Momentum

__all__ = ["Optimizer", "Momentum", "Adam", "AdamW"]
