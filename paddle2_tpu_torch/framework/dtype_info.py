"""``paddle.iinfo`` / ``paddle.finfo``: the counterpart of
``paddle2_tpu/framework/dtype_info.py``, from ``torch.iinfo`` /
``torch.finfo``. A dtype may be a name, a numpy dtype or a torch dtype.
A name is taken as it reads, as the JAX package takes it
(``iinfo("int64")`` describes int64), while ``iinfo(paddle.int64)``
describes int32, which ``paddle.int64`` is under the x32 policy."""

import numpy as np
import torch

from .core import dtype_name


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    dt = getattr(torch, name.replace("paddle.", ""), None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"unsupported dtype {dtype!r}")
    return dt


class iinfo:
    def __init__(self, dtype):
        dt = _torch_dtype(dtype)
        info = torch.iinfo(dt)
        self.min = int(info.min)
        self.max = int(info.max)
        self.bits = int(info.bits)
        self.dtype = dtype_name(dt)


class finfo:
    def __init__(self, dtype):
        dt = _torch_dtype(dtype)
        info = torch.finfo(dt)
        self.min = float(info.min)
        self.max = float(info.max)
        self.eps = float(info.eps)
        self.tiny = float(info.tiny)
        self.smallest_normal = float(info.tiny)
        # as the dtype holds it (the JAX package's value)
        self.resolution = float(torch.tensor(info.resolution, dtype=dt))
        self.bits = int(info.bits)
        self.dtype = dtype_name(dt)
