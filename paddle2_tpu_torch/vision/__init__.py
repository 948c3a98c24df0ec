"""Vision models of the port (counterpart of ``paddle2_tpu.vision``):
the ResNet family so far; the other models, datasets and transforms are
ROADMAP queue 1 item 2."""

from . import models

__all__ = ["models"]
