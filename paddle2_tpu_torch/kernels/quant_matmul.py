"""Int8 weight-only matmul: the CUDA kernel, its wrapper, its plain
version and the quantization primitives around it.

Counterpart of the weight-only half of
``paddle2_tpu/kernels/pallas_matmul.py``: :func:`channel_absmax`,
:func:`quantize_channelwise` and :func:`weight_quant_error_bound` are
plain torch; :func:`int8_weight_only_matmul` is the port of the Pallas
kernel ``_wo_kernel``, as ``csrc/wo_matmul.cu``. Layouts are the JAX
package's: ``x [..., K]``, ``w_int8 [K, N]`` int8, ``w_scale [N]`` f32
(per output channel).

A CPU tensor runs :func:`int8_weight_only_matmul_reference`; a CUDA
tensor launches the kernel or raises. The plain version repeats the
Pallas kernel's arithmetic, not the XLA fallback's: the product is
summed in f32 from the unscaled int8 values, each column is scaled by
``s_j / qmax`` once after the sum, and a bias is added in f32 before the
one cast to ``x.dtype``.

Unlike the Pallas path there is no ``wo_supported`` gate: the kernel
masks M, N and K at the ragged edge, so every shape takes it.
"""

import ctypes
from typing import Dict, Tuple

import torch

from . import _build

__all__ = ["channel_absmax", "quantize_channelwise",
           "weight_quant_error_bound", "int8_weight_only_matmul",
           "int8_weight_only_matmul_reference"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"wo_matmul": [_P] * 7 + [_I] * 4 + [ctypes.c_float, _I, _P],
               "wo_gemv_blocks_per_sm": [_I, _I, _I, _P]}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's decode regime (csrc/wo_matmul.cu): M <= 8 rows, computed
# as 1, 2, 4 or 8; 128-column tiles; a block takes at most 8192 / MT rows
# of K (x's rows for them fill its 32 KB of shared memory)
_GEMV_MAX_M = 8
_GEMV_COLS = 128
_GEMV_SMEM_FLOATS = 8192
# per device: zeroed u32 counters, one per column tile, that the split-K
# reduction leaves zeroed (calls on one device are ordered on one stream)
_COUNTERS: Dict[torch.device, torch.Tensor] = {}
# (device, MT, N % 16 == 0, dtype) -> decode blocks the whole card holds
_RESIDENT: Dict[tuple, int] = {}


# ------------------------------------------------------------ primitives
def channel_absmax(arr: torch.Tensor, axis: int) -> torch.Tensor:
    """Per-channel absmax of ``arr`` along ``axis`` (reduced over every
    other axis), in f32: the one reduction the observer and the packers
    share."""
    axis = axis % arr.dim()
    red = tuple(i for i in range(arr.dim()) if i != axis)
    return arr.abs().amax(dim=red).float()


def quantize_channelwise(w: torch.Tensor, quant_bits: int = 8,
                         axis: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(w_int8, scale)``: symmetric per-channel absmax quantization of
    ``w`` along ``axis`` (the output channel of a ``[K, N]`` weight)."""
    qmax = float(2 ** (quant_bits - 1) - 1)
    scale = channel_absmax(w, axis).clamp_min(1e-8)
    shape = [1] * w.dim()
    shape[axis % w.dim()] = -1
    w_q = torch.round(w.float() / scale.reshape(shape) * qmax)
    return w_q.clamp(-qmax, qmax).to(torch.int8).contiguous(), scale


def weight_quant_error_bound(x: torch.Tensor, w_scale: torch.Tensor,
                             quant_bits: int = 8) -> torch.Tensor:
    """Bound on the weight-only quantization error of ``x @ W``, per
    (row, output channel): each dequantized weight lies within
    ``s_j / (2 qmax)`` of the original, so the product's error is at
    most the row's l1 norm times that half step. ``[..., N]`` f32."""
    qmax = float(2 ** (quant_bits - 1) - 1)
    l1 = x.float().abs().sum(dim=-1, keepdim=True)
    return l1 * (w_scale.float() / (2.0 * qmax))


# ------------------------------------------------------- the weight-only op
def _qmax(quant_bits: int) -> float:
    if not 2 <= int(quant_bits) <= 8:
        raise ValueError(f"quant_bits must lie in [2, 8], got {quant_bits}")
    return float(2 ** (int(quant_bits) - 1) - 1)


def int8_weight_only_matmul_reference(x, w_int8, w_scale, bias=None,
                                      quant_bits: int = 8) -> torch.Tensor:
    """The plain version: the Pallas kernel's arithmetic in torch ops."""
    qmax = _qmax(quant_bits)
    acc = x.float() @ w_int8.float()
    out = acc * (w_scale.float() / qmax)
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def _check(x, w_int8, w_scale, bias) -> Tuple[int, int]:
    if w_int8.dtype != torch.int8 or w_int8.dim() != 2:
        raise ValueError(f"w_int8 must be a 2-D int8 [K, N] tensor, got "
                         f"{w_int8.dtype} {tuple(w_int8.shape)}")
    K, N = w_int8.shape
    if x.dim() < 1 or x.shape[-1] != K:
        raise ValueError(f"x {tuple(x.shape)} does not end in K = {K}")
    if not x.is_floating_point():
        raise ValueError(f"x must be floating point, got {x.dtype}")
    # a float buffer cast by module.to(dtype) would mis-scale silently
    if w_scale.dtype != torch.float32:
        raise ValueError(f"w_scale must be float32, got {w_scale.dtype} "
                         f"(quantize after casting the model, not before)")
    if tuple(w_scale.shape) != (N,):
        raise ValueError(f"w_scale {tuple(w_scale.shape)} is not [{N}]")
    if bias is not None and tuple(bias.shape) != (N,):
        raise ValueError(f"bias {tuple(bias.shape)} is not [{N}]")
    tensors = [x, w_int8, w_scale] + ([] if bias is None else [bias])
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, w_int8, w_scale and bias must lie on one "
                         "device")
    return K, N


def _gemv_rows(M: int) -> int:
    return 1 if M == 1 else 2 if M == 2 else 4 if M <= 4 else 8


def k_split(M: int, K: int, N: int, resident: int) -> Tuple[int, int]:
    """``(k_per_split, splits)`` of the decode kernel: as many K splits as
    one wave of ``resident`` blocks allows next to the column tiles, but
    no block under 256 rows (8 for each row lane, the copies it keeps in
    flight), and at least enough that a block's rows of x fit its shared
    memory; whole 32-row steps (one row for each row lane)."""
    if M > _GEMV_MAX_M:
        return K, 1
    tiles = -(-N // _GEMV_COLS)
    max_k = _GEMV_SMEM_FLOATS // _gemv_rows(M)
    splits = max(min(resident // tiles, -(-K // 256)), -(-K // max_k), 1)
    per = -(-K // splits)
    per = -(-per // 32) * 32
    return per, -(-K // per)


def _resident(lib, device: torch.device, M: int, N: int,
              dtype: torch.dtype) -> int:
    key = (device, _gemv_rows(M), N % 16 == 0, dtype)
    if key not in _RESIDENT:
        per_sm = ctypes.c_int(0)
        _build.check(lib, lib.wo_gemv_blocks_per_sm(
            M, int(key[2]), _DTYPE_CODE[dtype], ctypes.byref(per_sm)),
            "wo_gemv_blocks_per_sm")
        _RESIDENT[key] = per_sm.value * torch.cuda.get_device_properties(
            device).multi_processor_count
    return _RESIDENT[key]


def _counters(device: torch.device, n: int) -> torch.Tensor:
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 512), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def int8_weight_only_matmul(x, w_int8, w_scale, bias=None,
                            quant_bits: int = 8) -> torch.Tensor:
    """``x @ dequant(w_int8)`` with per-output-channel scales ``w_scale``
    (``qmax = 2**(quant_bits-1) - 1``; a 4-bit payload is stored as
    int8), plus ``bias``, in ``x.dtype``. ``x [..., K]`` float,
    ``w_int8 [K, N]`` int8, ``w_scale [N]`` f32, ``bias [N]``.
    ``int8_weight_only_matmul.launches`` counts the kernel's launches."""
    K, N = _check(x, w_int8, w_scale, bias)
    qmax = _qmax(quant_bits)
    if x.device.type == "cpu":
        return int8_weight_only_matmul_reference(x, w_int8, w_scale, bias,
                                                 quant_bits)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"the kernel takes float32 or bfloat16 x, got "
                         f"{x.dtype}")
    if bias is not None and bias.dtype != x.dtype:
        raise ValueError(f"bias dtype {bias.dtype} differs from x's "
                         f"{x.dtype}")
    if not all(t.is_contiguous() for t in (x, w_int8, w_scale)) or (
            bias is not None and not bias.is_contiguous()):
        raise ValueError("int8_weight_only_matmul needs contiguous tensors")
    if K == 0:
        raise ValueError("K must be positive")
    M = x.numel() // K
    y = torch.empty(x.shape[:-1] + (N,), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    dev = x.device
    lib = _build.library("wo_matmul", _SIGNATURES)
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(lib, x, w_int8, w_scale, bias, y, M, K, N, qmax)
    return _launch(lib, x, w_int8, w_scale, bias, y, M, K, N, qmax)


def _launch(lib, x, w_int8, w_scale, bias, y, M, K, N, qmax):
    """One launch on ``x``'s device, which is the current one."""
    dev = x.device
    per, splits = k_split(M, K, N, _resident(lib, dev, M, N, x.dtype)
                          if M <= _GEMV_MAX_M else 0)
    ws = counters = None
    if splits > 1:
        ws = torch.empty(splits * M * N, dtype=torch.float32, device=dev)
        counters = _counters(dev, -(-N // _GEMV_COLS))
    err = lib.wo_matmul(
        x.data_ptr(), w_int8.data_ptr(), w_scale.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(),
        M, K, N, per, qmax, _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "wo_matmul")
    int8_weight_only_matmul.launches += 1
    return y


int8_weight_only_matmul.launches = 0
