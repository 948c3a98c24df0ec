"""Vision of the port (counterpart of ``paddle2_tpu.vision``): the model
zoo; ``ops``, the transforms and the datasets are ROADMAP queue 1 item
9."""

from . import models

__all__ = ["models"]
