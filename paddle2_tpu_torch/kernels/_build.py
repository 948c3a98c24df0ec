"""Builds and loads the port's CUDA kernels.

Every ``paddle2_tpu_torch/**/csrc/*.cu`` file is one shared library
with a plain C interface, compiled by ``nvcc`` for Hopper (``sm_90a``)
and loaded with :mod:`ctypes`; ``*.cuh`` headers beside them are shared
building blocks. Nothing includes PyTorch's headers, so a build takes
seconds, not minutes. The libraries land in ``build/paddle2_tpu_torch/``
at the repository root, named by the hash of their source, the headers
beside it and the flags: an edited source builds anew, an unchanged one
is reused.

The build is lazy. ``import paddle2_tpu_torch`` builds and loads
nothing; the first launch of any kernel builds every library at once,
one ``nvcc`` process per source, all started together.

C convention: each entry takes its pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launch, which
:func:`check` turns into a :class:`RuntimeError`. Each library also
exports ``const char* error_string(int)``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence

import torch

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "sources", "build_all", "library",
           "check", "on_cuda", "on_card", "tma_aligned"]

_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG.parent / "build" / "paddle2_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def sources() -> Dict[str, Path]:
    """Kernel library name (the source's stem) -> ``.cu`` path."""
    out: Dict[str, Path] = {}
    for src in sorted(_PKG.glob("**/csrc/*.cu")):
        if src.stem in out:
            raise RuntimeError(f"two kernel sources named {src.stem}")
        out[src.stem] = src
    return out


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built on this host")
    return found


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Build every library that is missing, in parallel; returns the
    seconds spent. Raises with the compiler's output when a build
    fails. The compiler's register/shared-memory report is kept beside
    each library as ``<lib>.log``."""
    t0 = time.perf_counter()
    todo = [(name, src, _lib_path(src)) for name, src in sources().items()
            if not _lib_path(src).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, src, out in todo:
        tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed: List[str] = []
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        out.with_suffix(".log").write_text(log)
        if p.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {p.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library ``name`` (building everything first if it is
    missing), with ``argtypes`` set from ``signatures`` (entry name ->
    ctypes argument types) and ``restype`` ``c_int`` on each entry."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            src = sources()[name]
            path = _lib_path(src)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def on_cuda(t: torch.Tensor) -> bool:
    """Where a router sends ``t``: False on the CPU, True on the card;
    any other device raises. Unlike :func:`on_card` it takes any
    layout, since a router may copy before it launches."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def on_card(what: str, *tensors: torch.Tensor) -> bool:
    """Where a wrapper runs: False for CPU tensors (the plain version);
    True for CUDA tensors, which must be contiguous (the kernel); any
    other device raises."""
    if not on_cuda(tensors[0]):
        return False
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} needs contiguous tensors")
    return True


def tma_aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it whose data starts on a 16-byte boundary, as
    TMA needs (a contiguous view can start anywhere)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()
