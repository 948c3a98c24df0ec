"""Device selection for the port's entry points.

Every entry point (``GPTForCausalLM(...)``, ``ServingEngine(...)``)
runs on the GPU unless the caller asks for the CPU. A missing GPU is an
error, never a silent fall back: the CPU path runs the kernels' plain
versions, which is what the tests want and what a server must not get
by accident.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a GPU present
    raises :class:`RuntimeError`; pass ``device="cpu"`` to run the
    plain versions on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; pass device='cpu' to run the "
            "plain (non-kernel) path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
