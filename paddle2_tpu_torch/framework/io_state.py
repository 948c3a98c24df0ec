"""``paddle.save`` / ``paddle.load``: the counterpart of
``paddle2_tpu/framework/io_state.py``, with the same file format.

A file is the 8-byte magic ``P2TCKPT\\x01``, a ``<IQ`` (crc32, size)
header backfilled after the payload pickle has streamed through a
CRC-counting writer, and the pickle; ``load`` checks the CRC while it
unpickles, in one pass. A stream that cannot seek gets the envelope dict
instead, and a bare pickle (a file from before the envelope) still
loads. A path is written to ``<path>.tmp`` and moved over ``path`` with
``os.replace``, so a crashed save never leaves half a file.

**Files the JAX package wrote** load without the JAX package and
without ``ml_dtypes``: the unpickler maps the JAX package's
``_TensorPayload`` to this module's, and a bfloat16 leaf, which pickles
its dtype as ``numpy.dtype(ml_dtypes.bfloat16)``, to its raw 16-bit
words, read back as a ``torch.bfloat16`` tensor. numpy has no bfloat16,
so ``return_numpy=True`` raises ``TypeError`` on a bfloat16 leaf rather
than widen it. Loaded leaves are CPU tensors unless ``place=`` is given;
``stop_gradient`` is kept (``requires_grad``), a parameter comes back an
``nn.Parameter``, and its saved name as the attribute ``paddle_name``
(``name`` is torch's own, read-only attribute).

A learning-rate scheduler saves as ``{"__lr_scheduler__": state}`` and
loads back as its state dict, in both packages' files.

Out of scope: the JAX package reading the port's files, which would need
it to import this module's payload class.
"""

from __future__ import annotations

import io as _io
import os
import pickle
import struct
import zlib
from typing import Any, Optional, Set

import numpy as np
import torch

from . import core

__all__ = ["save", "load", "save_to_bytes", "load_from_bytes",
           "CheckpointCorruptionError"]

_PROTOCOL_DEFAULT = 4
_MAGIC = b"P2TCKPT\x01"
_HEADER = struct.Struct("<IQ")
_INTEGRITY_MARKER = "__p2t_integrity__"
_INTEGRITY_VERSION = 1


class CheckpointCorruptionError(ValueError):
    """A checkpoint failed its integrity check: a CRC32 or size
    mismatch, a truncation, or a pickle that does not read."""


class Crc32Writer:
    """A file wrapper that keeps a running CRC32 and byte count of what
    streams through it."""

    __slots__ = ("_f", "crc", "size")

    def __init__(self, f):
        self._f = f
        self.crc = 0
        self.size = 0

    def write(self, b):
        self._f.write(b)
        self.crc = zlib.crc32(b, self.crc)
        self.size += len(b)


class Crc32Reader:
    """The read side of :class:`Crc32Writer`."""

    __slots__ = ("_f", "crc", "size")

    def __init__(self, f):
        self._f = f
        self.crc = 0
        self.size = 0

    def read(self, n=-1):
        b = self._f.read(n)
        self.crc = zlib.crc32(b, self.crc)
        self.size += len(b)
        return b

    def readline(self):
        b = self._f.readline()
        self.crc = zlib.crc32(b, self.crc)
        self.size += len(b)
        return b


class _PrependReader:
    """Serve the sniffed magic bytes ahead of a stream that cannot
    seek back."""

    __slots__ = ("_head", "_f")

    def __init__(self, head: bytes, f):
        self._head = head
        self._f = f

    def read(self, n=-1):
        if not self._head:
            return self._f.read(n)
        if n is None or n < 0:
            b, self._head = self._head, b""
            return b + self._f.read(n)
        b, self._head = self._head[:n], self._head[n:]
        if len(b) < n:
            b += self._f.read(n - len(b))
        return b

    def readline(self):
        if not self._head:
            return self._f.readline()
        i = self._head.find(b"\n")
        if i >= 0:
            b, self._head = self._head[:i + 1], self._head[i + 1:]
            return b
        b, self._head = self._head, b""
        return b + self._f.readline()


class _TensorPayload:
    """A tensor leaf in the pickle. ``dtype`` names a type numpy lacks
    (``"bfloat16"``: ``array`` holds its 16-bit words); the JAX package's
    payload has no such field and carries bfloat16 as an ``ml_dtypes``
    array."""

    __slots__ = ("array", "name", "stop_gradient", "is_param", "dtype")

    def __init__(self, array: np.ndarray, name: str, stop_gradient: bool,
                 is_param: bool, dtype: Optional[str] = None):
        self.array = array
        self.name = name
        self.stop_gradient = stop_gradient
        self.is_param = is_param
        self.dtype = dtype

    def __reduce__(self):
        return (_TensorPayload, (self.array, self.name, self.stop_gradient,
                                 self.is_param, self.dtype))


_BF16 = object()     # what ``ml_dtypes.bfloat16`` unpickles to


class _Unpickler(pickle.Unpickler):
    """Reads the JAX package's pickles: its payload class becomes this
    module's, and each ``numpy.dtype(ml_dtypes.bfloat16)`` a uint16 dtype
    whose identity is recorded in ``bf16`` so its arrays can be told
    apart from real uint16 ones."""

    def __init__(self, f):
        super().__init__(f)
        self.bf16: list = []

    def _dtype(self, spec, align=False, copy=False):
        if spec is _BF16:
            d = np.dtype("<u2", align, True)
            self.bf16.append(d)
            return d
        return np.dtype(spec, align, copy)

    def find_class(self, module, name):
        if name == "_TensorPayload" and module.endswith(
                "framework.io_state"):
            return _TensorPayload
        if module == "ml_dtypes" and name == "bfloat16":
            return _BF16
        if module == "numpy" and name == "dtype":
            return self._dtype
        if module.startswith("numpy._core"):
            try:
                __import__("numpy._core")
            except ImportError:
                module = "numpy.core" + module[len("numpy._core"):]
        return super().find_class(module, name)


def _unpickle(f) -> tuple:
    u = _Unpickler(f)
    obj = u.load()
    return obj, {id(d) for d in u.bf16}, u.bf16


# ---------------------------------------------------------------- writing

def _dump_with_integrity(payload: Any, f, protocol: int) -> None:
    try:
        seekable = f.seekable()
    except (AttributeError, OSError):
        seekable = False
    if not seekable:
        blob = pickle.dumps(payload, protocol)
        pickle.dump({_INTEGRITY_MARKER: _INTEGRITY_VERSION,
                     "crc32": zlib.crc32(blob) & 0xFFFFFFFF,
                     "size": len(blob), "payload": blob}, f,
                    protocol=protocol)
        return
    start = f.tell()
    f.write(_MAGIC)
    f.write(_HEADER.pack(0, 0))          # backfilled after the stream
    w = Crc32Writer(f)
    pickle.dump(payload, w, protocol=protocol)
    end = f.tell()
    f.seek(start + len(_MAGIC))
    f.write(_HEADER.pack(w.crc & 0xFFFFFFFF, w.size))
    f.seek(end)


def _to_saveable(obj: Any) -> Any:
    from ..optimizer.lr import LRScheduler

    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        dtype = None
        if t.dtype == torch.bfloat16:
            t, dtype = t.view(torch.int16), "bfloat16"
        arr = t.numpy()
        if dtype is not None:
            arr = arr.view(np.uint16)
        return _TensorPayload(arr, getattr(obj, "paddle_name", "") or "",
                              not obj.requires_grad,
                              isinstance(obj, torch.nn.Parameter), dtype)
    if isinstance(obj, LRScheduler):
        return {"__lr_scheduler__": _to_saveable(obj.state_dict())}
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = type(obj) if type(obj) in (list, tuple) else list
        return t(_to_saveable(v) for v in obj)
    if isinstance(obj, (np.ndarray, np.generic, int, float, bool, str,
                        bytes, complex, type(None))):
        return obj
    if hasattr(obj, "state_dict") and callable(obj.state_dict):
        return _to_saveable(obj.state_dict())
    raise TypeError(
        f"paddle.save: unsupported object type {type(obj)!r}; save a "
        "state_dict / nested container of tensors instead")


def save(obj: Any, path, protocol: int = _PROTOCOL_DEFAULT,
         **configs) -> None:
    """Write ``obj`` (a state dict, a tensor, nested containers, a module
    or anything with ``state_dict()``) to ``path`` or a writable file."""
    if protocol < 2 or protocol > 5:
        raise ValueError(f"pickle protocol must be in [2, 5], got {protocol}")
    payload = _to_saveable(obj)
    if hasattr(path, "write"):
        _dump_with_integrity(payload, path, protocol)
        return
    path = os.fspath(path)
    if path.endswith(os.sep) or os.path.isdir(path):
        raise ValueError(f"paddle.save path is a directory: {path!r}")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _dump_with_integrity(payload, f, protocol)
    os.replace(tmp, path)


# ---------------------------------------------------------------- reading

def verified_unpickle(f, crc32: int, size: int, label: str):
    """Unpickle through a :class:`Crc32Reader`; the size and CRC verdict
    comes at the end, and a bad stream raises
    :class:`CheckpointCorruptionError` rather than the unpickler's own
    confusion."""
    r = Crc32Reader(f)
    err = None
    out = None
    try:
        out = _unpickle(r)
    except Exception as e:
        err = e
        r.read()
    if r.size != size:
        raise CheckpointCorruptionError(
            f"{label} truncated: {r.size} bytes read, recorded {size}")
    if r.crc & 0xFFFFFFFF != crc32:
        raise CheckpointCorruptionError(
            f"{label} corrupt: crc32 {r.crc & 0xFFFFFFFF:#010x} != "
            f"recorded {crc32:#010x}")
    if err is not None:
        raise CheckpointCorruptionError(f"{label} unreadable: {err}") \
            from err
    return out


def _unwrap(loaded, origin: str):
    obj = loaded[0]
    if not (isinstance(obj, dict) and _INTEGRITY_MARKER in obj):
        return loaded
    version = obj[_INTEGRITY_MARKER]
    if version != _INTEGRITY_VERSION or \
            not isinstance(obj.get("payload"), bytes):
        raise CheckpointCorruptionError(
            f"paddle.load: {origin} has integrity-envelope version "
            f"{version!r}; this build supports {_INTEGRITY_VERSION}")
    blob = obj["payload"]
    if len(blob) != obj.get("size"):
        raise CheckpointCorruptionError(
            f"paddle.load: {origin} truncated: payload {len(blob)} bytes, "
            f"expected {obj.get('size')}")
    crc = zlib.crc32(blob) & 0xFFFFFFFF
    if crc != obj.get("crc32"):
        raise CheckpointCorruptionError(
            f"paddle.load: {origin} corrupt: crc32 {crc:#010x} != recorded "
            f"{obj.get('crc32'):#010x}")
    return _unpickle(_io.BytesIO(blob))


def _load_with_integrity(f, origin: str):
    head = f.read(len(_MAGIC))
    if head == _MAGIC:
        raw = f.read(_HEADER.size)
        if len(raw) != _HEADER.size:
            raise CheckpointCorruptionError(
                f"paddle.load: {origin} truncated inside the integrity "
                "header")
        crc, size = _HEADER.unpack(raw)
        return verified_unpickle(f, crc, size, f"paddle.load: {origin}")
    return _unwrap(_unpickle(_PrependReader(head, f)), origin)


def _bf16_error(what: str) -> TypeError:
    return TypeError(
        f"paddle.load: {what} is bfloat16, which numpy has no type for; "
        "load with return_numpy=False to get a torch.bfloat16 tensor")


def _leaf(arr: np.ndarray, bf16: bool, place) -> torch.Tensor:
    if bf16:
        raw = np.ascontiguousarray(arr).view(np.int16).copy()
        return torch.from_numpy(raw).view(torch.bfloat16).to(
            core.to_device(place) if place is not None else "cpu")
    return core.to_torch_tensor(arr, None, "cpu" if place is None
                                else place)


def _from_saved(obj: Any, return_numpy: bool, bf16_ids: Set[int],
                place) -> Any:
    if isinstance(obj, _TensorPayload):
        bf16 = obj.dtype == "bfloat16" or id(obj.array.dtype) in bf16_ids
        if return_numpy:
            if bf16:
                raise _bf16_error(f"leaf {obj.name or '<unnamed>'!r}")
            return obj.array
        t = _leaf(obj.array, bf16, place)
        if obj.is_param:
            t = torch.nn.Parameter(t, requires_grad=not obj.stop_gradient
                                   and (t.is_floating_point()
                                        or t.is_complex()))
        elif not obj.stop_gradient and (t.is_floating_point()
                                        or t.is_complex()):
            t.requires_grad_(True)
        if obj.name:
            t.paddle_name = obj.name
        return t
    if isinstance(obj, np.ndarray) and id(obj.dtype) in bf16_ids:
        if return_numpy:
            raise _bf16_error("an array leaf")
        return _leaf(obj, True, place)
    if isinstance(obj, dict):
        if set(obj) == {"__lr_scheduler__"}:
            return _from_saved(obj["__lr_scheduler__"], return_numpy,
                               bf16_ids, place)
        return {k: _from_saved(v, return_numpy, bf16_ids, place)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_saved(v, return_numpy, bf16_ids, place)
                         for v in obj)
    return obj


def load(path, return_numpy: bool = False, **configs) -> Any:
    """Read a ``paddle.save`` file (the port's or the JAX package's).
    ``return_numpy=True`` gives ndarrays (and raises on bfloat16);
    ``place=`` puts the tensors there (default: the CPU)."""
    place = configs.get("place")
    if hasattr(path, "read"):
        payload, ids, keep = _load_with_integrity(path, "<stream>")
    else:
        path = os.fspath(path)
        if not os.path.exists(path):
            raise ValueError(f"paddle.load: no such file {path!r}")
        try:
            with open(path, "rb") as f:
                payload, ids, keep = _load_with_integrity(f, path)
        except (pickle.UnpicklingError, EOFError) as e:
            raise CheckpointCorruptionError(
                f"paddle.load: {path!r} unreadable (truncated or "
                f"corrupt): {e}") from e
    return _from_saved(payload, return_numpy, ids, place)


def save_to_bytes(obj: Any, protocol: int = _PROTOCOL_DEFAULT) -> bytes:
    buf = _io.BytesIO()
    save(obj, buf, protocol=protocol)
    return buf.getvalue()


def load_from_bytes(data: bytes, return_numpy: bool = False,
                    **configs) -> Any:
    return load(_io.BytesIO(data), return_numpy=return_numpy, **configs)
