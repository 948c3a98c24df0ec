"""Framework core: dtypes, places, the current device, grad mode.

The counterpart of ``paddle2_tpu/framework/core.py``. Port tensors are
``torch.Tensor``s and the tape is ``torch.autograd``, so grad mode is
torch's own (``no_grad``, ``enable_grad``, ``set_grad_enabled``,
``is_grad_enabled``).

**The x32 policy.** The JAX package runs without 64-bit types:
``paddle.int64`` *is* int32 and ``paddle.float64`` *is* float32. The port
keeps the same policy, since it is held against that package:
``paddle2_tpu_torch.int64 is torch.int32`` and
``convert_dtype("float64")`` is ``torch.float32``. An op that must hand
torch int64 indices (``torch.gather``, ``index_select``, ...) casts them
inside and returns the JAX package's result dtype.

**Places.** The default place is ``cuda:0`` (:func:`resolve_device`): a
missing GPU is an error, never a silent fall back to the CPU.
``set_device("cpu")`` (or ``CPUPlace()``) is how a caller asks for the
CPU; ``"gpu"``, ``"gpu:N"`` and ``"cuda:N"`` name a CUDA device; a TPU or
XPU place raises, since the port runs on NVIDIA GPUs.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional, Union

import numpy as np
import torch

from ..device import resolve_device

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int32
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float32
complex64 = torch.complex64
complex128 = torch.complex64

_DTYPE_ALIASES = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "uint32": torch.uint32,
    "uint64": torch.uint32, "float16": float16, "bfloat16": bfloat16,
    "float32": float32, "float64": float64, "complex64": complex64,
    "complex128": complex128,
}
# torch dtypes past the x32 policy's reach
_X32 = {torch.int64: int32, torch.float64: float32,
        torch.complex128: complex64, torch.uint64: torch.uint32}


def convert_dtype(dtype: Any) -> Optional[torch.dtype]:
    """A user's dtype (a name, a numpy dtype or type, a Python type or a
    torch dtype) as a torch dtype, under the x32 policy."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return _X32.get(dtype, dtype)
    if isinstance(dtype, str):
        name = dtype[7:] if dtype.startswith("paddle.") else dtype
        if name in _DTYPE_ALIASES:
            return _DTYPE_ALIASES[name]
        dtype = np.dtype(name)
    name = np.dtype(dtype).name
    if name not in _DTYPE_ALIASES:
        raise TypeError(f"unsupported dtype {dtype!r}")
    return _DTYPE_ALIASES[name]


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"``."""
    return str(dtype).rpartition(".")[2]


_state = threading.local()


def set_default_dtype(dtype: Any) -> None:
    """The dtype of Python floats and of creation ops without a dtype.
    The port's own setting: torch's default dtype is left as it is."""
    _state.default_dtype = convert_dtype(dtype)


def get_default_dtype() -> torch.dtype:
    return getattr(_state, "default_dtype", float32)


is_grad_enabled = torch.is_grad_enabled
set_grad_enabled = torch.set_grad_enabled
enable_grad = torch.enable_grad


def no_grad(func=None):
    """``torch.no_grad`` as a context manager, or as a decorator with or
    without the call (``@no_grad`` and ``@no_grad()``)."""
    if func is not None:
        return torch.no_grad()(func)
    return torch.no_grad()


# ---------------------------------------------------------------- places

class Place:
    """A device. ``torch_device()`` gives its ``torch.device``."""

    device_type = "unknown"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def torch_device(self) -> torch.device:
        raise ValueError(f"no torch device for {self!r}")


class CPUPlace(Place):
    device_type = "cpu"

    def torch_device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPlace(Place):
    device_type = "gpu"

    def torch_device(self) -> torch.device:
        return resolve_device(f"cuda:{self.device_id}")


def _no_accelerator(name: str) -> ValueError:
    return ValueError(
        f"{name!r}: this port runs on NVIDIA GPUs through CUDA; ask for "
        f"'gpu' (or 'gpu:N', 'cuda:N') or for 'cpu'")


class TPUPlace(Place):
    """Kept for scripts that import it; placing a tensor here raises."""

    device_type = "tpu"

    def torch_device(self) -> torch.device:
        raise _no_accelerator(f"tpu:{self.device_id}")


class CustomPlace(Place):
    def __init__(self, device_type: str, device_id: int = 0):
        super().__init__(device_id)
        self.device_type = device_type

    def torch_device(self) -> torch.device:
        raise _no_accelerator(f"{self.device_type}:{self.device_id}")


_device_lock = threading.Lock()
_current_place: Optional[Place] = None


def _place_of(device: Union[str, Place, torch.device]) -> Place:
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        device = str(device)
    name, _, idx = str(device).partition(":")
    device_id = int(idx) if idx else 0
    if name == "cpu":
        return CPUPlace(device_id)
    if name in ("gpu", "cuda"):
        return CUDAPlace(device_id)
    if name in ("tpu", "xpu"):
        raise _no_accelerator(device)
    raise ValueError(f"unknown device {device!r}")


def set_device(device: Union[str, Place, torch.device]) -> Place:
    """``"cpu"``, ``"gpu"``, ``"gpu:N"`` or ``"cuda:N"`` (or a place):
    the place of tensors that creation ops make. A GPU place raises
    when no GPU is present; ``"tpu"`` and ``"xpu"`` raise."""
    global _current_place
    place = _place_of(device)
    place.torch_device()
    with _device_lock:
        _current_place = place
    return place


def current_place() -> Place:
    """The place of :func:`set_device`; ``CUDAPlace(0)`` until then."""
    global _current_place
    with _device_lock:
        if _current_place is None:
            _current_place = CUDAPlace(0)
        return _current_place


def current_device() -> torch.device:
    return current_place().torch_device()


@contextlib.contextmanager
def place_scope(device: Union[str, Place, torch.device]):
    """The current place is ``device`` inside the block (for a model
    that builds its layers on a device it was given), the one before
    after it."""
    global _current_place
    place = _place_of(device)
    place.torch_device()
    with _device_lock:
        before, _current_place = _current_place, place
    try:
        yield place
    finally:
        with _device_lock:
            _current_place = before


def get_device() -> str:
    p = current_place()
    return f"{p.device_type}:{p.device_id}"


def place_of_tensor(t: torch.Tensor) -> Place:
    if t.device.type == "cuda":
        return CUDAPlace(t.device.index or 0)
    return CPUPlace(0)


def to_device(place: Any) -> torch.device:
    """A place, a device name or a ``torch.device`` (None: the current
    place) as a ``torch.device``."""
    if place is None:
        return current_device()
    if isinstance(place, torch.device) and place.type == "cpu":
        return place
    return _place_of(place).torch_device()


def device_count(device_type: str = "gpu") -> int:
    """The number of CUDA devices (1 for ``"cpu"``)."""
    if device_type == "cpu":
        return 1
    return torch.cuda.device_count()


def is_compiled_with_cuda() -> bool:
    return True


def is_compiled_with_tpu() -> bool:
    return False


def synchronize(device=None) -> None:
    """Wait for the work queued on a CUDA device (``torch.cuda.
    synchronize``); nothing to wait for on the CPU."""
    dev = to_device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# --------------------------------------------------------- host -> tensor

def to_torch_tensor(data: Any, dtype: Any = None, place: Any = None
                    ) -> torch.Tensor:
    """Host data (or a tensor) as a tensor on ``place`` (default: the
    current place), with the JAX package's dtype rules: a Python bool is
    bool, an int int32, a float the default dtype; a float64 array takes
    the default dtype; every other 64-bit type its 32-bit one."""
    dtype = convert_dtype(dtype)
    dev = to_device(place)
    if isinstance(data, torch.Tensor):
        out = data.detach()
        if dtype is None:
            dtype = _X32.get(out.dtype, out.dtype)
        return out.to(device=dev, dtype=dtype, copy=True)
    if isinstance(data, (bool, int, float, complex)):
        if dtype is None:
            dtype = (bool_ if isinstance(data, bool)
                     else int64 if isinstance(data, int)
                     else get_default_dtype() if isinstance(data, float)
                     else complex64)
        return torch.tensor(data, dtype=dtype, device=dev)
    if isinstance(data, (list, tuple)) and any(
            isinstance(d, torch.Tensor) for d in data):
        data = [d.detach().cpu().numpy() if isinstance(d, torch.Tensor)
                else d for d in data]
    arr = np.asarray(data)
    if arr.dtype == object:
        raise TypeError(f"cannot make a tensor of {type(data)!r}")
    if dtype is None and arr.dtype == np.float64:
        dtype = get_default_dtype()
    out = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype is None:
        dtype = _X32.get(out.dtype, out.dtype)
    return out.to(device=dev, dtype=dtype)
