"""``clip_grad_norm_`` and ``clip_grad_value_`` under the module path of
``paddle2_tpu/nn/utils_mod.py``; the port's are in :mod:`.clip`."""

from .clip import clip_grad_norm_, clip_grad_value_  # noqa: F401

__all__ = ["clip_grad_norm_", "clip_grad_value_"]
