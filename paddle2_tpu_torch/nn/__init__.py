"""``paddle.nn`` of the port: the counterpart of
``paddle2_tpu/nn/__init__.py``.

``Layer`` (a ``torch.nn.Module`` with Paddle's surface), ``ParamAttr``,
the initializers, the common, conv, norm, pooling, activation,
container, Transformer, loss and recurrent layers, the decoding loop
(``BeamSearchDecoder``, ``dynamic_decode``), gradient clipping and
``nn.utils``, in the JAX package's order.
"""

from . import initializer  # noqa: F401  (before the layers, as in JAX)
from .layer.layers import Layer, ParamAttr  # noqa: F401
from . import functional  # noqa: F401
from .layer import activation as _activation
from .layer import common as _common
from .layer import container as _container
from .layer import conv as _conv
from .layer import loss as _loss
from .layer import norm as _norm
from .layer import pooling as _pooling
from .layer import rnn as _rnn
from .layer import transformer as _transformer
from .layer.common import *        # noqa: F401,F403
from .layer.conv import *          # noqa: F401,F403
from .layer.norm import *          # noqa: F401,F403
from .layer.pooling import *       # noqa: F401,F403
from .layer.activation import *    # noqa: F401,F403
from .layer.container import *     # noqa: F401,F403
from .layer.transformer import *   # noqa: F401,F403
from .layer.loss import *          # noqa: F401,F403
from .layer.rnn import *           # noqa: F401,F403
from .decode import BeamSearchDecoder, Decoder, dynamic_decode  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .utils_mod import clip_grad_norm_, clip_grad_value_  # noqa: F401
from . import utils  # noqa: F401

__all__ = (["initializer", "Layer", "ParamAttr", "functional"]
           + _common.__all__ + _conv.__all__ + _norm.__all__
           + _pooling.__all__ + _activation.__all__ + _container.__all__
           + _transformer.__all__ + _loss.__all__ + _rnn.__all__
           + ["BeamSearchDecoder", "Decoder", "dynamic_decode",
              "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
              "clip_grad_norm_", "clip_grad_value_", "utils"])
