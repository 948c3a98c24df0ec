"""``paddle.nn.functional`` of the port: the counterpart of
``paddle2_tpu/nn/functional/__init__.py``, in its order: the
activation, common, conv, pooling, norm and loss functionals,
``scaled_dot_product_attention``, the flash helpers (and, as in the JAX
package, ``flash_attention`` the module), the extra losses, the
in-place activations, ``affine_grid``/``grid_sample`` and
``sequence_mask``/``diag_embed``."""

import torch
from torch.nn import functional as _TF

from ...framework import core as _core
from . import activation as _activation
from . import common as _common
from . import conv as _conv
from . import extra_losses as _extra_losses
from . import loss as _loss
from . import norm as _norm
from . import pooling as _pooling
from . import vision_ops as _vision_ops
from .activation import *      # noqa: F401,F403
from .common import *          # noqa: F401,F403
from .conv import *            # noqa: F401,F403
from .pooling import *         # noqa: F401,F403
from .norm import *            # noqa: F401,F403
from .loss import *            # noqa: F401,F403
from ...kernels.attention import scaled_dot_product_attention  # noqa: F401
from .flash_attention import (flashmask_attention,  # noqa: F401
                              sparse_attention, flash_attn_qkvpacked,
                              flash_attn_unpadded,
                              flash_attn_varlen_qkvpacked, sdp_kernel)
# as in the JAX package, ``nn.functional.flash_attention`` is the module
# (callers write ``F.flash_attention.flash_attention(...)``)
from . import flash_attention  # noqa: E402,F401
from .extra_losses import *    # noqa: F401,F403
from .vision_ops import *      # noqa: F401,F403


# the in-place activations the JAX package adds beside relu_ and
# softmax_: torch's in-place ops, so x itself is updated (a leaf that
# requires grad cannot be, as in torch)
def elu_(x, alpha=1.0, name=None):
    return _TF.elu_(x, alpha)


def hardtanh_(x, min=-1.0, max=1.0, name=None):
    return _TF.hardtanh_(x, min, max)


def leaky_relu_(x, negative_slope=0.01, name=None):
    return _TF.leaky_relu_(x, negative_slope)


def tanh_(x, name=None):
    return torch.tanh_(x)


def thresholded_relu_(x, threshold=1.0, value=0.0, name=None):
    # x if x > threshold else value: torch's threshold
    return _TF.threshold_(x, threshold, value)


def relu6_(x, name=None):
    return _TF.hardtanh_(x, 0.0, 6.0)


def sigmoid_(x, name=None):
    return torch.sigmoid_(x)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """``[..., maxlen]``: 1 where the position is below the length ``x``
    (``maxlen`` defaults to the largest length)."""
    m = int(maxlen) if maxlen is not None else int(x.max())
    return (torch.arange(m, device=x.device) < x[..., None]).to(
        _core.convert_dtype(dtype))


def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    from ...ops.creation import diag_embed as _de
    return _de(x, offset, dim1, dim2)


_INPLACE = ["elu_", "hardtanh_", "leaky_relu_", "tanh_", "thresholded_relu_",
            "relu6_", "sigmoid_"]

__all__ = (_activation.__all__ + _common.__all__
           + _conv.__all__ + _pooling.__all__ + _norm.__all__ + _loss.__all__
           + ["scaled_dot_product_attention", "flashmask_attention",
              "sparse_attention", "flash_attn_qkvpacked",
              "flash_attn_unpadded", "flash_attn_varlen_qkvpacked",
              "sdp_kernel", "flash_attention"]
           + _extra_losses.__all__ + _vision_ops.__all__ + _INPLACE
           + ["sequence_mask", "diag_embed"])
