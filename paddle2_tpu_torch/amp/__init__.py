"""Automatic mixed precision: the counterpart of
``paddle2_tpu/amp/``.

``auto_cast`` (and its old name ``amp_guard``) casts by the JAX
package's white and black lists (:mod:`.amp_lists`, the port's own
copy), by op name, as :mod:`.casting` explains; ``decorate`` casts a
model's parameters for O2; :class:`GradScaler` is dynamic loss scaling.
``cast_inputs_for_op`` and ``amp_state`` are the JAX package's hooks of
the same names.
"""

from . import amp_lists
from .casting import (amp_guard, amp_state, auto_cast, cast_inputs_for_op,
                        record_casts)
from ..framework import core
from .grad_scaler import GradScaler, ScaleSaturationError

__all__ = ["auto_cast", "amp_guard", "amp_state", "cast_inputs_for_op",
           "decorate", "GradScaler", "ScaleSaturationError",
           "is_bfloat16_supported", "is_float16_supported", "amp_lists",
           "record_casts"]


def _norm_types():
    """The layers whose own parameters stay f32 at O2: the JAX package's
    set (``paddle2_tpu/amp/__init__.py:88-96``) over the port's classes.
    The instance norms are not in it, so they are cast, as in JAX."""
    from ..nn.layer.norm import (_BatchNormBase, GroupNorm, LayerNorm,
                                 RMSNorm)
    return (_BatchNormBase, LayerNorm, GroupNorm, RMSNorm)


def decorate(models, optimizers=None, level: str = "O2",
             dtype: str = "bfloat16", master_weight=None, save_dtype=None,
             master_grad=False):
    """At O2, cast every floating parameter to ``dtype`` in place,
    except the parameters a norm layer owns itself, which stay f32 (as
    ``paddle2_tpu/amp/__init__.py:84-106``). Stacked block leaves
    (``models/_scan.py``) belong to the stack, not to a norm layer, so
    they are cast, stacked LayerNorm leaves included, as in the JAX
    package. O1 leaves the parameters as they are. ``master_weight``,
    ``save_dtype`` and ``master_grad`` are taken and, as in the JAX
    package, change nothing: the optimizer's ``multi_precision`` keeps
    the f32 masters, a checkpoint saves each tensor in its own dtype,
    and gradients come in the parameter's dtype. Returns the models (and
    the optimizers, when given) as passed."""
    if level not in ("O1", "O2"):
        raise ValueError(f"unknown AMP level {level!r}")
    dt = core.convert_dtype(dtype)
    model_list = models if isinstance(models, (list, tuple)) else [models]
    if level == "O2":
        norms = _norm_types()
        for model in model_list:
            keep = {id(p) for m in model.modules() if isinstance(m, norms)
                    for p in m.parameters(recurse=False)}
            for p in model.parameters():
                if id(p) not in keep and p.is_floating_point():
                    p.data = p.data.to(dt)
    if optimizers is None:
        return models
    return models, optimizers


def is_bfloat16_supported(device=None) -> bool:
    """True: the port's kernels take bfloat16 on the H100 and their
    plain versions on the CPU."""
    return True


def is_float16_supported(device=None) -> bool:
    """True: the port's kernels take float16 on the H100 and their
    plain versions on the CPU."""
    return True
