"""paddle2_tpu_torch — the PyTorch/CUDA port of ``paddle2_tpu``.

Import it as the JAX package is imported::

    import paddle2_tpu_torch as paddle

Module paths and public names mirror the JAX package
(``paddle2_tpu_torch.serving.ServingEngine`` is the counterpart of
``paddle2_tpu.serving.ServingEngine``). Port tensors are ``torch.Tensor``s
and the tape is ``torch.autograd``; plain tensor code is PyTorch, and
every Pallas kernel on a ported path is a CUDA C++ kernel for Hopper
(``sm_90a``) under a ``csrc/`` directory, built at its first launch.
Importing the package builds and loads nothing. Names of subsystems not
yet ported are absent (``ROADMAP.md`` lists them).

float32 matmuls run in full float32 (TF32 off for matmuls and cuDNN):
the JAX package's float32 path runs at "highest" precision, and the
port is held against it.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

# framework core
from .framework import (  # noqa: E402,F401
    CPUPlace, CUDAPlace, CustomPlace, Place, TPUPlace,
    Tensor, Parameter, to_tensor,
    bool_ as bool,  # noqa: A001 — paddle exposes paddle.bool
    uint8, int8, int16, int32, int64, float16, bfloat16, float32, float64,
    complex64, complex128,
    get_default_dtype, set_default_dtype, seed,
    no_grad, enable_grad, set_grad_enabled, is_grad_enabled,
    get_rng_state, set_rng_state,
    is_compiled_with_cuda, is_compiled_with_tpu, synchronize,
)
from .framework.core import set_device, get_device, device_count  # noqa
from .flags import set_flags, get_flags, define_flag  # noqa: E402,F401
from .device import resolve_device  # noqa: E402,F401

# ops -> the top-level namespace (paddle.matmul, paddle.reshape, ...)
from .ops import *  # noqa: E402,F401,F403
from .ops.logic import is_tensor  # noqa: E402,F401

from . import autograd  # noqa: E402,F401
from .autograd import grad  # noqa: E402,F401

from . import nn  # noqa: E402,F401
from .nn.layer.layers import ParamAttr  # noqa: E402,F401
from . import optimizer  # noqa: E402,F401
from . import regularizer  # noqa: E402,F401
from . import amp  # noqa: E402,F401
from . import jit  # noqa: E402,F401
from . import vision  # noqa: E402,F401
from .framework import io_state as _io_state  # noqa: E402,F401
from .framework.io_state import save, load  # noqa: E402,F401
from . import distributed  # noqa: E402,F401
from . import incubate  # noqa: E402,F401
from . import quantization  # noqa: E402,F401
from . import models  # noqa: E402,F401
from . import serving  # noqa: E402,F401
from .framework.dtype_info import iinfo, finfo  # noqa: E402,F401


def disable_static(place=None):
    """Eager is the port's only mode: nothing to switch."""


def enable_static():
    """Static graphs come with ``jit.to_static`` (ROADMAP queue 1 item
    3); eager stays on."""


def in_dynamic_mode() -> bool:
    return True
