"""Flash attention forward: the CUDA kernel, its wrapper and its plain
version.

Counterpart of the forward half of ``paddle2_tpu/kernels/pallas_flash.py``
(``_flash_fwd`` and ``flash_attention_bshd``). The kernel is
``csrc/flash_fwd.cu``; its source note says what bounds it and how it
is laid out. The backward kernels belong to the training slice.

A CPU tensor runs :func:`flash_fwd_reference`; a CUDA tensor launches
the kernel or raises. There is no third path: shapes and dtypes the
kernel does not take raise on both devices, so the CPU tests hold the
same contract the card runs.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["flash_fwd", "flash_fwd_reference", "flash_attention_bshd",
           "SUPPORTED_HEAD_DIMS"]

SUPPORTED_HEAD_DIMS = (16, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             ctypes.c_float, _I, _P]}


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_fwd takes (B, H, S, D) tensors")
    B, H, Sq, D = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    Sk = k.shape[2]
    if not 1 <= Sq <= Sk:
        raise ValueError(f"need 1 <= Sq <= Sk, got Sq={Sq} Sk={Sk}")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {SUPPORTED_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need "
                         f"float32 or bfloat16 for all three")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")


def flash_fwd_reference(q, k, v, scale: float, causal: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: one softmax over the whole row in f32, the
    probabilities rounded to the input dtype before ``p @ v``, the
    causal mask aligned to the bottom right. Returns ``(o, lse)``."""
    Sq, Sk = q.shape[2], k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        keep = torch.ones(Sq, Sk, dtype=torch.bool,
                          device=q.device).tril(diagonal=Sk - Sq)
        s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    safe_m = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(s - safe_m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    lse = torch.where(l == 0, torch.full_like(l, float("-inf")),
                      m + torch.log(safe_l))
    return (o / safe_l).to(q.dtype), lse.squeeze(-1)


def flash_fwd(q, k, v, scale: Optional[float] = None, causal: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash forward on ``(B, H, S, D)``: returns ``o`` (input dtype)
    and ``lse`` (f32, ``(B, H, Sq)``). ``flash_fwd.launches`` counts the
    kernel's launches."""
    _check(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, float(scale), bool(causal))
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd needs contiguous q, k and v")
    B, H, Sq, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = _build.library("flash_fwd", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, H, Sq, k.shape[2], D, _DTYPE_CODE[q.dtype],
            float(scale), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_fwd")
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


def flash_attention_bshd(q, k, v, causal: bool = False,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention on ``(batch, seq, heads, dim)`` tensors, the
    layout of the JAX package's public flash API. Returns
    ``(B, Sq, H, D)``."""
    o, _ = flash_fwd(q.transpose(1, 2).contiguous(),
                     k.transpose(1, 2).contiguous(),
                     v.transpose(1, 2).contiguous(), scale=scale,
                     causal=causal)
    return o.transpose(1, 2)
