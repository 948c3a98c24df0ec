"""Optimizers of the port (counterpart of ``paddle2_tpu.optimizer``):
the base class, the fifteen optimizers of the JAX package and its
learning-rate schedulers (``paddle.optimizer.lr``)."""

from . import lr
from .optimizer import Optimizer
from .optimizers import (ASGD, LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax,
                         AdamW, Lamb, Lion, Momentum, NAdam, RAdam, RMSProp,
                         Rprop)

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "Lion", "NAdam", "RAdam",
           "LBFGS", "ASGD", "Rprop", "lr"]
