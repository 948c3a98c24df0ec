"""The fused training step of the port (counterpart of
``paddle2_tpu.jit``); ``to_static``, ``save`` and ``load`` are ROADMAP
queue 1 items 1 and 8."""

from .train_step import TrainStepProgram, train_step

__all__ = ["train_step", "TrainStepProgram"]
