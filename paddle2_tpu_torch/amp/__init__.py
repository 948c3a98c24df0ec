"""Automatic mixed precision: the counterpart of
``paddle2_tpu/amp/__init__.py``. Only ``decorate`` is ported;
``auto_cast`` and ``GradScaler`` are ROADMAP queue 1 item 2."""

import torch
from torch import nn

__all__ = ["decorate"]

_NORMS = (nn.LayerNorm, nn.GroupNorm, nn.modules.batchnorm._BatchNorm,
          nn.RMSNorm)
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def decorate(models, optimizers=None, level: str = "O2",
             dtype: str = "bfloat16"):
    """At O2, cast every floating parameter to ``dtype`` in place,
    except the parameters a norm layer owns itself, which stay f32 (as
    ``paddle2_tpu/amp/__init__.py:84-106``). Stacked block leaves
    (``models/_scan.py``) belong to the stack, not to a norm layer, so
    they are cast, stacked LayerNorm leaves included, as in the JAX
    package. O1 leaves the parameters as they are. Returns the models
    (and the optimizers, when given) as passed."""
    if level not in ("O1", "O2"):
        raise ValueError(f"unknown AMP level {level!r}")
    dt = _DTYPES[dtype] if isinstance(dtype, str) else dtype
    model_list = models if isinstance(models, (list, tuple)) else [models]
    if level == "O2":
        for model in model_list:
            keep = {id(p) for m in model.modules() if isinstance(m, _NORMS)
                    for p in m.parameters(recurse=False)}
            for p in model.parameters():
                if id(p) not in keep and p.is_floating_point():
                    p.data = p.data.to(dt)
    if optimizers is None:
        return models
    return models, optimizers
