"""paddle2_tpu_torch — the PyTorch/CUDA port of ``paddle2_tpu``.

Module paths and public names mirror the JAX package
(``paddle2_tpu_torch.serving.ServingEngine`` is the counterpart of
``paddle2_tpu.serving.ServingEngine``). Plain tensor code is PyTorch;
every Pallas kernel on a ported path is a CUDA C++ kernel for Hopper
(``sm_90a``) under a ``csrc/`` directory, built at its first launch.
Importing the package builds and loads nothing.

float32 matmuls run in full float32 (TF32 off for matmuls and cuDNN):
the JAX package's float32 path runs at "highest" precision, and the
port is held against it.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from . import quantization  # noqa: E402
from .device import resolve_device  # noqa: E402

__all__ = ["resolve_device", "quantization"]
