"""Low-precision matmuls: the int8 weight-only and the int8 x int8 CUDA
kernels, their wrappers, their plain versions and the quantization
primitives around them.

Counterpart of ``paddle2_tpu/kernels/pallas_matmul.py``, whose public
names it exposes. :func:`channel_absmax`, :func:`quantize_channelwise`,
:func:`weight_quant_error_bound`, the int4 packers and
:func:`fp8_matmul` are plain torch, as they are plain jnp there. Two
functions are ports of Pallas kernels:

* :func:`int8_weight_only_matmul`, of ``_wo_kernel``, on the tensor
  cores: bf16 prefill (more than 8 rows) in ``csrc/wo_matmul_wgmma.cu``;
  in ``csrc/wo_matmul.cu`` the decode (at most 8 rows) in bf16
  (``wo_gemv_mma_kernel``) and in f32 in two TF32 passes
  (``wo_gemv_tf32_kernel``), and f32 prefill in two TF32 passes
  (``wo_gemm_tf32_kernel``, which also takes bf16 rows off TMA's 16-byte
  rule) (:func:`wo_route` says which);
  :func:`int4_weight_only_matmul` unpacks a nibble payload and reaches
  it at ``quant_bits=4``.
* :func:`int8_matmul`, of ``_i8i8_kernel``, as ``csrc/i8i8_matmul.cu``:
  the product of ``QuantedInferenceLinear`` (PTQ's full-int8 layer), on
  the tensor cores, prefill (more than 16 rows) on wgmma and decode as a
  swapped ``mma.sync`` GEMV (:func:`i8i8_route` says which).

Layouts are the JAX package's: ``x [..., K]``, ``w_int8 [K, N]`` int8,
``w_scale [N]`` f32 (per output channel).

A CPU tensor runs each kernel's plain version; a CUDA tensor launches
the kernel or raises. The weight-only plain version repeats the Pallas
kernel's arithmetic, not the XLA fallback's: the product is summed in
f32 from the unscaled int8 values, each column is scaled by ``s_j /
qmax`` once after the sum, and a bias is added in f32 before the one
cast to ``x.dtype``. The int8 x int8 product is exact, so its plain
version and the kernel give the same integers.

Unlike the Pallas paths there is no :func:`wo_supported` gate on the
card: the ``wo_matmul.cu`` kernels mask M, N and K at the ragged edge,
and the wgmma kernel reads its tiles with TMA, which fills what lies
past an edge with zeros, so every shape takes a kernel. The gate stays public
for callers that read it.

The collective matmuls (``allgather_matmul``, ``matmul_allgather``,
``collective_matmul_traffic``) wait for the distributed core and the
cost model (ROADMAP queue 1 items 6 and 4) and raise.
"""

import ctypes
from typing import Dict, Tuple

import torch

from . import _build
from ..ops.dispatch import checks_outputs

__all__ = ["channel_absmax", "quantize_channelwise",
           "weight_quant_error_bound", "int8_weight_only_matmul",
           "int8_weight_only_matmul_reference", "int4_weight_only_matmul",
           "pack_int4", "unpack_int4", "int8_matmul",
           "int8_matmul_reference", "fp8_matmul", "fp8_supported",
           "wo_supported", "wo_route", "WO_ROUTES", "allgather_matmul",
           "matmul_allgather", "collective_matmul_traffic", "DEFAULT_BLOCK_M",
           "DEFAULT_BLOCK_N", "DEFAULT_BLOCK_K"]

# the Pallas tiling's defaults, which wo_supported reads; the CUDA
# kernels choose their own tiles
DEFAULT_BLOCK_M = 256
DEFAULT_BLOCK_N = 256
DEFAULT_BLOCK_K = 512

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"wo_gemm_tf32": [_P] * 5 + [_I] * 4 + [ctypes.c_float, _I,
                                                       _P],
               "wo_gemm_blocks_per_sm": [_I, _P],
               "wo_gemv_mma": [_P] * 5 + [_I] * 4 + [ctypes.c_float, _P],
               "wo_gemv_mma_blocks_per_sm": [_I, _P],
               "wo_gemv_tf32": [_P] * 5 + [_I] * 4 + [ctypes.c_float, _P],
               "wo_gemv_tf32_blocks_per_sm": [_I, _P]}
_WGMMA_SIGNATURES = {"wo_matmul_wgmma": [_P] * 5 + [_I] * 3
                     + [ctypes.c_float, _P]}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the decode kernels (csrc/wo_matmul.cu `wo_gemv_mma_kernel`, bf16, and
# `wo_gemv_tf32_kernel`, f32): M <= 8 rows (the mma's n8 side), 128-column
# tiles, K splits of whole 128-row runs (16 rows for each of a block's 4
# warps, twice over), at most 8 in bf16 (the splits of a column tile are
# one thread-block cluster, of the portable size) and 16 in f32 (the
# H100's non-portable size), where a split keeps at least 512 rows
_GEMV_MAX_M = 8
_GEMV_COLS = 128
_MMA_SPLIT_ROWS = 128
_TF_MAX_SPLITS = 16
_TF_WIDE_SPLIT_ROWS = 512
_MMA_MAX_SPLITS = 8
# the TF32 prefill kernel (csrc/wo_matmul.cu `wo_gemm_tf32_kernel`): a
# block's output tile by x's type, 32-row k-steps; K splits of whole
# k-steps, at least 8 of them (256 rows), at most 8 splits (a tile's
# splits are one cluster). The kernel adds its tensor-core sums into a
# second sum every 2048 rows, so a split may take any number of rows.
_GEMM_TILES = {torch.float32: (32, 512), torch.bfloat16: (128, 128)}
_GEMM_KSTEP = 32
_GEMM_MIN_ROWS = 256
_GEMM_MAX_SPLITS = 8
# the weight-only kernels a CUDA call may take (wo_route)
WO_ROUTES = ("gemv", "gemv_mma", "gemm", "wgmma")
# (device, route, N % 16 == 0, dtype) -> the decode kernel's blocks the
# whole card holds; (device, "gemm", dtype) -> the prefill kernel's
_RESIDENT: Dict[tuple, int] = {}
# (device, M, K, N, dtype) -> (route, k_per_split, splits, library, C
# entry): a launch's plan, made once per shape (a serving run repeats a
# few dozen), with its entry bound once
_PLANS: Dict[tuple, tuple] = {}
_MAX_PLANS = 4096


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
                                      quant_bits: int = 8,
                                      matmul=torch.matmul) -> torch.Tensor:
    """The plain version: the Pallas kernel's arithmetic in torch ops.
    ``matmul`` computes the f32 product of x and the int8 values (e.g.
    ``flash_attn.tf32_matmul``, whose passes the TF32 prefill kernel
    emulates: its w is exact in TF32, so 3 passes are that kernel's 2)."""
    qmax = _qmax(quant_bits)
    acc = matmul(x.float(), w_int8.float())
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


def mma_k_split(M: int, K: int, N: int, resident: int) -> Tuple[int, int]:
    """``(k_per_split, splits)`` of the bf16 decode kernel: K is split
    across blocks until the column tiles times the splits fill half of
    the ``resident`` blocks the card holds (two blocks of 128 threads an
    SM, 32 KB of weight loads in flight on each), in whole 128-row runs,
    at most 8 ways (a tile's splits are one cluster). More splits add
    partial sums without reading faster; fewer leave SMs idle
    (``wo_gemv_mma_variants.py`` times every split on the card)."""
    tiles = -(-N // _GEMV_COLS)
    want = min(_MMA_MAX_SPLITS, max(1, -(-(resident // 2) // tiles)))
    rows = -(-K // want)
    per = -(-rows // _MMA_SPLIT_ROWS) * _MMA_SPLIT_ROWS
    return per, -(-K // per)


def tf32_k_split(M: int, K: int, N: int, resident: int) -> Tuple[int, int]:
    """``(k_per_split, splits)`` of the f32 decode kernel: the most K
    splits, a power of two (a tile's splits are one cluster), whose
    blocks (the column tiles times the splits) stay within three quarters
    of the ``resident`` blocks the card holds, up to 8, and up to 16 (the
    H100's non-portable cluster size) where each split keeps at least 512
    rows; in whole 128-row runs. Timed on the card with every split, read
    cold (``wo_gemv_mma_variants.py --dtype float32``, M 8): qkv (48
    tiles) 0.0133 ms on 8 splits against 0.0142 on the bf16 rule's 6, up
    (64) 0.0146 on 4 against 0.0186 on 8, down (16, K 8192) 0.0152 on 16
    against 0.0187 on 8, out_proj (16, K 2048) 0.0102 on 8 and on 16 (128
    rows a split), the head's 393 tiles none."""
    tiles = -(-N // _GEMV_COLS)
    want = 1
    while (want < _TF_MAX_SPLITS and 2 * want * tiles <= 3 * resident // 4
           and (2 * want <= _MMA_MAX_SPLITS
                or K >= 2 * want * _TF_WIDE_SPLIT_ROWS)):
        want *= 2
    rows = -(-K // want)
    per = -(-rows // _MMA_SPLIT_ROWS) * _MMA_SPLIT_ROWS
    return per, -(-K // per)


def gemm_tile(dtype: torch.dtype) -> Tuple[int, int]:
    """The TF32 prefill kernel's output tile ``(rows, columns)`` for x of
    ``dtype``: 32 x 512 for f32 (8 warps side by side, so that every warp
    has rows at the padded prompt lengths), 128 x 128 for bf16 x, rows
    off TMA's 16-byte rule."""
    return _GEMM_TILES[dtype]


def gemm_k_split(M: int, K: int, N: int, resident: int,
                 dtype: torch.dtype = torch.float32) -> Tuple[int, int]:
    """``(k_per_split, splits)`` of the TF32 prefill kernel for x of
    ``dtype`` (:func:`gemm_tile`): its output tiles alone when they fill
    at least half of the ``resident`` blocks the card holds; else K is
    split across blocks until the tiles times the splits fill at most one
    wave of them, up to 8 ways (a tile's splits are one thread-block
    cluster), each split whole 32-row k-steps and at least 256 rows. At M
    128 the down projection (K 8192, N 2048) is 16 f32 tiles, 8 splits; at
    M 1008 it is 128 tiles, 2 splits, and the up projection (N 8192) 512
    tiles, none. More splits than one wave would run the partial tiles in
    a second wave; fewer leave SMs idle. Any K takes at most 8 splits: the
    kernel keeps its error in hand by itself, every 2048 rows."""
    bm, bn = gemm_tile(dtype)
    tiles = (-(-M // bm)) * (-(-N // bn))
    want = max(1, min(_GEMM_MAX_SPLITS, resident // tiles,
                      K // _GEMM_MIN_ROWS))
    per = -(-K // want)
    per = -(-per // _GEMM_KSTEP) * _GEMM_KSTEP
    return per, -(-K // per)


def _resident(lib, device: torch.device, N: int, dtype: torch.dtype,
              route: str) -> int:
    key = ((device, "gemm", dtype) if route == "gemm" else
           (device, route, N % 16 == 0, dtype))
    if key not in _RESIDENT:
        per_sm = ctypes.c_int(0)
        if route == "gemm":
            entry = "wo_gemm_blocks_per_sm"
            err = lib.wo_gemm_blocks_per_sm(_DTYPE_CODE[dtype],
                                            ctypes.byref(per_sm))
        else:
            entry = f"{_ENTRIES[route]}_blocks_per_sm"
            err = getattr(lib, entry)(int(key[2]), ctypes.byref(per_sm))
        _build.check(lib, err, entry)
        _RESIDENT[key] = per_sm.value * torch.cuda.get_device_properties(
            device).multi_processor_count
    return _RESIDENT[key]


def wo_route(M: int, K: int, N: int, dtype: torch.dtype) -> str:
    """The kernel a CUDA call of ``M x K x N`` in ``dtype`` takes, chosen
    from its shape and dtype before the launch. Decode, M <= 8, on the
    tensor cores at any K, N and alignment: "gemv_mma" for bf16
    (``wo_gemv_mma_kernel``), "gemv" for f32 (``wo_gemv_tf32_kernel``, two
    TF32 passes, each product within about 2**-21 of f32). Prefill:
    "wgmma" for bf16 within TMA's 16-byte rule, K % 8 == 0 and N % 16 ==
    0 (``wo_gemm_wgmma_kernel``); else "gemm" (``wo_gemm_tf32_kernel``,
    the tensor cores in TF32: f32 x in two passes, each product within
    about 2**-21 of f32, and bf16 rows of another length in one, exact).
    A base off a 16-byte boundary does not change the route: the wgmma
    route copies that operand first, the other kernels read it element
    by element."""
    if M <= _GEMV_MAX_M:
        return "gemv_mma" if dtype == torch.bfloat16 else "gemv"
    if dtype == torch.bfloat16 and K % 8 == 0 and N % 16 == 0:
        return "wgmma"
    return "gemm"


_ENTRIES = {"gemv": "wo_gemv_tf32", "gemm": "wo_gemm_tf32",
            "gemv_mma": "wo_gemv_mma", "wgmma": "wo_matmul_wgmma"}


def _plan(dev: torch.device, M: int, K: int, N: int,
          dtype: torch.dtype) -> tuple:
    key = (dev, M, K, N, dtype)
    plan = _PLANS.get(key)
    if plan is None:
        route = wo_route(M, K, N, dtype)
        lib = (_build.library("wo_matmul_wgmma", _WGMMA_SIGNATURES)
               if route == "wgmma" else
               _build.library("wo_matmul", _SIGNATURES))
        per, splits = K, 1
        if route in ("gemv", "gemv_mma"):
            split = mma_k_split if route == "gemv_mma" else tf32_k_split
            per, splits = split(M, K, N, _resident(lib, dev, N, dtype,
                                                   route))
        elif route == "gemm":
            per, splits = gemm_k_split(
                M, K, N, _resident(lib, dev, N, dtype, route), dtype)
        if len(_PLANS) >= _MAX_PLANS:
            _PLANS.clear()
        plan = _PLANS[key] = (route, per, splits, lib,
                              getattr(lib, _ENTRIES[route]))
    return plan


@checks_outputs("int8_weight_only_matmul")
def int8_weight_only_matmul(x, w_int8, w_scale, bias=None,
                            quant_bits: int = 8) -> torch.Tensor:
    """``x @ dequant(w_int8)`` with per-output-channel scales ``w_scale``
    (``qmax = 2**(quant_bits-1) - 1``; a 4-bit payload is stored as
    int8), plus ``bias``, in ``x.dtype``. ``x [..., K]`` float,
    ``w_int8 [K, N]`` int8, ``w_scale [N]`` f32, ``bias [N]``.
    ``int8_weight_only_matmul.launches`` counts the kernels' launches,
    and ``int8_weight_only_matmul.route_launches`` those of each route
    (:func:`wo_route`)."""
    K, N = _check(x, w_int8, w_scale, bias)
    qmax = _qmax(quant_bits)
    if not _build.on_card("int8_weight_only_matmul", x, w_int8, w_scale,
                          *(() if bias is None else (bias,))):
        return int8_weight_only_matmul_reference(x, w_int8, w_scale, bias,
                                                 quant_bits)
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"the kernel takes float32 or bfloat16 x, got "
                         f"{x.dtype}")
    if bias is not None and bias.dtype != x.dtype:
        raise ValueError(f"bias dtype {bias.dtype} differs from x's "
                         f"{x.dtype}")
    if K == 0:
        raise ValueError("K must be positive")
    M = x.numel() // K
    y = torch.empty(x.shape[:-1] + (N,), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    dev = x.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(x, w_int8, w_scale, bias, y, M, K, N, qmax)
    return _launch(x, w_int8, w_scale, bias, y, M, K, N, qmax)


def _raw_stream(index: int) -> int:
    """The current CUDA stream of device ``index`` as the integer handle
    ``torch.cuda.current_stream(index).cuda_stream`` gives, without
    building a Stream object (a fifth of a decode call's host time)."""
    return torch._C._cuda_getCurrentRawStream(index)


def _launch(x, w_int8, w_scale, bias, y, M, K, N, qmax):
    """One launch on ``x``'s device, which is the current one."""
    dev = x.device
    route, per, splits, lib, entry = _plan(dev, M, K, N, x.dtype)
    stream = _raw_stream(dev.index)
    b_ptr = None if bias is None else bias.data_ptr()
    if route == "wgmma":
        err = entry(
            _build.tma_aligned(x).data_ptr(),
            _build.tma_aligned(w_int8).data_ptr(),
            w_scale.data_ptr(), b_ptr, y.data_ptr(), M, K, N, qmax, stream)
    elif route == "gemm":
        # the K splits of a tile add through distributed shared memory,
        # not a workspace (one cluster)
        err = entry(x.data_ptr(), w_int8.data_ptr(), w_scale.data_ptr(),
                    b_ptr, y.data_ptr(), M, K, N, per, qmax,
                    _DTYPE_CODE[x.dtype], stream)
    else:
        # so do the decode kernels' (a column tile's splits one cluster)
        err = entry(x.data_ptr(), w_int8.data_ptr(), w_scale.data_ptr(),
                    b_ptr, y.data_ptr(), M, K, N, per, qmax, stream)
    if err:
        _build.check(lib, err, _ENTRIES[route])
    int8_weight_only_matmul.launches += 1
    int8_weight_only_matmul.route_launches[route] += 1
    return y


int8_weight_only_matmul.launches = 0
int8_weight_only_matmul.route_launches = dict.fromkeys(WO_ROUTES, 0)


def wo_supported(m: int, k: int, n: int, bm: int = DEFAULT_BLOCK_M,
                 bn: int = DEFAULT_BLOCK_N, bk: int = DEFAULT_BLOCK_K) -> bool:
    """Whether the JAX package's Pallas tiling takes ``m x k x n``: each
    dimension a multiple of its block (a block clipped to the
    dimension). The port's kernels take every shape; this is the same
    arithmetic, public for callers that read it."""
    bm, bn, bk = min(bm, m), min(bn, n), min(bk, k)
    return m % bm == 0 and k % bk == 0 and n % bn == 0


# ------------------------------------------------------------ int4 storage
def pack_int4(w_q) -> torch.Tensor:
    """Pack a ``[..., N]`` int4-valued int8 tensor (values in [-8, 7])
    into ``[..., N/2]`` uint8 nibbles, the even column in the low nibble.
    N must be even."""
    w_q = torch.as_tensor(w_q).to(torch.int8)
    if w_q.shape[-1] % 2:
        raise ValueError("pack_int4 needs an even out-channel count")
    lo = (w_q[..., 0::2] & 0xF).to(torch.uint8)
    hi = (w_q[..., 1::2] & 0xF).to(torch.uint8)
    return lo | (hi << 4)


def unpack_int4(packed, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: ``[..., N/2]`` uint8 -> ``[..., n]``
    int8, each nibble sign-extended to [-8, 7]."""
    packed = torch.as_tensor(packed).to(torch.uint8)
    lo = (packed & 0xF).to(torch.int8)
    hi = ((packed >> 4) & 0xF).to(torch.int8)
    out = torch.stack([torch.where(v >= 8, v - 16, v) for v in (lo, hi)],
                      dim=-1)
    return out.reshape(packed.shape[:-1] + (2 * packed.shape[-1],))[..., :n]


def int4_weight_only_matmul(x, w_packed, w_scale, bias=None) -> torch.Tensor:
    """int4 weight-only ``x @ dequant(W)``: the nibble payload
    ``w_packed [K, N/2]`` (from :func:`pack_int4`) unpacked to int8 and
    run through :func:`int8_weight_only_matmul` at ``quant_bits=4``
    (the ``wo_matmul`` kernel on the card). ``w_scale [N]`` f32."""
    n = 2 * w_packed.shape[-1]
    w_q = unpack_int4(w_packed, n).contiguous()
    return int8_weight_only_matmul(x, w_q, w_scale, bias=bias, quant_bits=4)


# ------------------------------------------------------ int8 x int8 matmul
# csrc/i8i8_matmul.cu. The prefill kernel (route "wgmma"): 128-row output
# tiles of 128 or 256 columns, 128 rows of K a stage, a tile's K splits one
# cluster of at most 8; it reads x and w with TMA, which wants K and N
# multiples of 16. The decode kernel (route "mma"), which also takes every
# shape off that rule: 128-column tiles, 8 or 16 rows of x a block, K splits
# of whole 128-row runs (32 rows for each of a block's 4 warps), at most 8
# (one cluster).
I8I8_ROUTES = ("wgmma", "mma")
# up to here (and off TMA's rule) the decode kernel; above, the prefill one
I8I8_DECODE_MAX_M = 16
_I8_BM = 128
_I8_BK = 128
_I8_MIN_STAGES = 4
_I8_LONG_K = 4096
_I8_MAX_SPLITS = 8
_I8_GEMV_COLS = 128
_I8_GEMV_RUN = 128
_I8_SIGNATURES = {"i8i8_wgmma": [_P] * 3 + [_I] * 5 + [_P],
                  "i8i8_gemv_mma": [_P] * 3 + [_I] * 4 + [_P]}
_I8_ENTRIES = {"wgmma": "i8i8_wgmma", "mma": "i8i8_gemv_mma"}
# the plain version's K chunk: each chunk's sum of int8 products is at
# most 1024 * 128**2 = 2**24 in magnitude, exact in f32
_I8_CHUNK = 1024
# device -> SM count
_SMS: Dict[torch.device, int] = {}
# (device, M, K, N) -> (route, tile columns, k_per_split, splits, library,
# C entry): a launch's plan, made once per shape
_I8_PLANS: Dict[tuple, tuple] = {}


def int8_matmul_reference(x_int8: torch.Tensor,
                          w_int8: torch.Tensor) -> torch.Tensor:
    """The plain version, the same integers on any device: K is cut in
    chunks of 1024; each chunk is an f32 matmul of the int8 values,
    exact because every partial sum is an integer of magnitude at most
    ``1024 * 128**2 = 2**24`` (TF32 would be exact too: an int8 value
    needs 8 significant bits). The chunks are converted to int32 and
    added in int32, which wraps past 2**31 as the kernel's adds do."""
    M, K = x_int8.shape
    acc = torch.zeros(M, w_int8.shape[1], dtype=torch.int32,
                      device=x_int8.device)
    for k0 in range(0, K, _I8_CHUNK):
        part = (x_int8[:, k0:k0 + _I8_CHUNK].float()
                @ w_int8[k0:k0 + _I8_CHUNK].float())
        acc += part.to(torch.int32)
    return acc


def i8i8_route(M: int, K: int, N: int) -> str:
    """The kernel a CUDA call of ``M x K x N`` takes: "wgmma" (the
    prefill kernel) above :data:`I8I8_DECODE_MAX_M` rows when K and N are
    multiples of 16 (TMA's rule; the wrapper copies an operand off a
    16-byte boundary first), else "mma" (the decode kernel, any shape)."""
    if M <= I8I8_DECODE_MAX_M or K % 16 or N % 16:
        return "mma"
    return "wgmma"


def i8i8_tile_n(M: int, K: int, N: int, sms: int) -> int:
    """The prefill kernel's output tile width: 256 columns when those
    tiles fill a wave of ``sms`` blocks (one an SM) by themselves, or when
    K is long (at least 4096 rows: its splits keep long walks), else 128.
    A 128 x 256 tile moves 48 KB a stage for 32K outputs against 32 KB
    for 16K, and the kernel is bound by those moves."""
    if -(-M // _I8_BM) * -(-N // 256) >= sms or K >= _I8_LONG_K:
        return 256
    return 128


def i8i8_split(M: int, K: int, N: int, sms: int) -> Tuple[int, int]:
    """``(k_per_split, splits)`` of the prefill kernel: K is split (1, 2,
    4 or 8 ways; a tile's splits are one thread-block cluster, adding
    through distributed shared memory) as far as every block still runs
    in one wave (at most ``sms`` blocks in clusters of 2, ``sms / 2`` in
    clusters of 4 and 8, which the card does not fit 128 at a time) and
    each split keeps at least 4 stages of 128 rows. Measured on the card
    (``i8i8_variants.py``): at M 32 the out_proj (16 tiles of 128 x 128)
    0.0072 ms on 4 splits, 0.0112 on 8 (128 blocks); down at M 1008 (64
    tiles of 128 x 256) 0.0402 on 2 splits, 0.0646 on 1."""
    bn = i8i8_tile_n(M, K, N, sms)
    tiles = -(-M // _I8_BM) * -(-N // bn)
    stages = -(-K // _I8_BK)
    splits = 1
    for s in (2, 4, 8):
        if stages < _I8_MIN_STAGES * s or \
                tiles * s > (sms if s <= 2 else sms // 2):
            break
        splits = s
    per = -(-stages // splits) * _I8_BK
    return per, -(-K // per)


def i8i8_mma_split(M: int, K: int, N: int, sms: int) -> Tuple[int, int]:
    """``(k_per_split, splits)`` of the decode kernel: K is split across
    blocks as far as the column tiles (times the 8- or 16-row tiles of M)
    times the splits stay within two blocks an SM of the ``sms``, in
    whole 128-row runs, at most 8 ways (a tile's splits are one cluster).
    A serving step reads each weight cold from device memory, where more
    blocks keep more loads in flight (``i8i8_variants.py``, cold: at M 8
    the up projection took 0.0122 ms on 4 splits, 0.0130 on 2, 0.0157 on
    8; warm in L2, 2 splits were faster)."""
    tiles = -(-N // _I8_GEMV_COLS) * -(-M // (8 if M <= 8 else 16))
    want = min(_I8_MAX_SPLITS, max(1, 2 * sms // tiles))
    rows = -(-K // want)
    per = -(-rows // _I8_GEMV_RUN) * _I8_GEMV_RUN
    return per, -(-K // per)


def _sm_count(device: torch.device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def _i8_plan(dev: torch.device, M: int, K: int, N: int) -> tuple:
    key = (dev, M, K, N)
    plan = _I8_PLANS.get(key)
    if plan is None:
        lib = _build.library("i8i8_matmul", _I8_SIGNATURES)
        route, sms = i8i8_route(M, K, N), _sm_count(dev)
        if route == "wgmma":
            bn = i8i8_tile_n(M, K, N, sms)
            per, splits = i8i8_split(M, K, N, sms)
        else:
            bn = _I8_GEMV_COLS
            per, splits = i8i8_mma_split(M, K, N, sms)
        if len(_I8_PLANS) >= _MAX_PLANS:
            _I8_PLANS.clear()
        plan = _I8_PLANS[key] = (route, bn, per, splits, lib,
                                 getattr(lib, _I8_ENTRIES[route]))
    return plan


def int8_matmul(x_int8: torch.Tensor, w_int8: torch.Tensor) -> torch.Tensor:
    """Full-int8 ``x_int8 [M, K] @ w_int8 [K, N] -> int32 [M, N]``, the
    product of ``QuantedInferenceLinear``. Exact while ``K * 128**2 <
    2**31`` (K < 131,072); past that the int32 sums wrap, as the JAX
    kernel's do. ``int8_matmul.launches`` counts the kernels' launches,
    and ``int8_matmul.route_launches`` those of each kernel
    (:func:`i8i8_route`)."""
    for name, t in (("x_int8", x_int8), ("w_int8", w_int8)):
        if t.dtype != torch.int8 or t.dim() != 2:
            raise ValueError(f"{name} must be a 2-D int8 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    M, K = x_int8.shape
    if w_int8.shape[0] != K:
        raise ValueError(f"x_int8 {tuple(x_int8.shape)} and w_int8 "
                         f"{tuple(w_int8.shape)} differ in K")
    if w_int8.device != x_int8.device:
        raise ValueError("x_int8 and w_int8 must lie on one device")
    if not _build.on_card("int8_matmul", x_int8, w_int8):
        return int8_matmul_reference(x_int8, w_int8)
    N = w_int8.shape[1]
    if M == 0 or N == 0 or K == 0:
        return torch.zeros(M, N, dtype=torch.int32, device=x_int8.device)
    dev = x_int8.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _i8_launch(x_int8, w_int8, M, K, N)
    return _i8_launch(x_int8, w_int8, M, K, N)


def _i8_launch(x, w, M, K, N):
    """One launch on ``x``'s device, which is the current one; y is
    written once (the K splits of a tile add through distributed shared
    memory), so it starts empty."""
    dev = x.device
    route, bn, per, splits, lib, entry = _i8_plan(dev, M, K, N)
    y = torch.empty(M, N, dtype=torch.int32, device=dev)
    stream = _raw_stream(dev.index)
    if route == "wgmma":
        err = entry(_build.tma_aligned(x).data_ptr(),
                    _build.tma_aligned(w).data_ptr(), y.data_ptr(), M, K, N,
                    bn, per, stream)
    else:
        err = entry(x.data_ptr(), w.data_ptr(), y.data_ptr(), M, K, N, per,
                    stream)
    if err:
        _build.check(lib, err, _I8_ENTRIES[route])
    int8_matmul.launches += 1
    int8_matmul.route_launches[route] += 1
    return y


int8_matmul.launches = 0
int8_matmul.route_launches = dict.fromkeys(I8I8_ROUTES, 0)


# ------------------------------------------------------------- fp8-shaped
def fp8_supported() -> bool:
    """True when this torch has the ``float8_e4m3fn`` dtype."""
    return hasattr(torch, "float8_e4m3fn")


# e4m3fn's largest finite value is 448; XLA's conversion rounds to
# nearest even, so |v| <= 464 lands on 448 and anything past it is NaN
# (the format has no infinity). torch's own cast saturates at +-448, so
# the port marks the overflow itself.
_FP8_OVERFLOW = 464.0


def _to_fp8_and_back(a: torch.Tensor) -> torch.Tensor:
    a32 = a.float()
    back = a32.to(torch.float8_e4m3fn).float()
    return torch.where(a32.abs() > _FP8_OVERFLOW,
                       torch.full_like(back, float("nan")), back)


def fp8_matmul(x, w) -> torch.Tensor:
    """fp8-shaped matmul: both operands cast to ``float8_e4m3fn`` (as
    XLA casts them: values past 464 in magnitude become NaN), widened to
    f32, multiplied over ``x``'s last axis and ``w``'s first, and cast
    to ``x.dtype``. The JAX package computes it with ``dot_general``
    outside any Pallas kernel, so plain torch is its port."""
    if not fp8_supported():
        raise NotImplementedError(
            "fp8_matmul: this torch has no float8_e4m3fn dtype")
    out = torch.tensordot(_to_fp8_and_back(x), _to_fp8_and_back(w),
                          dims=([x.dim() - 1], [0]))
    return out.to(x.dtype)


# ------------------------------------------------------- collective matmul
def _collective(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported yet: it waits for the distributed core "
            f"(ROADMAP queue 1 item 6); the cost model's collective "
            f"traffic it prices with is ported (queue 1 item 4, "
            f"observability.cost_model.CollectiveTraffic)")
    fn.__name__ = name
    fn.__doc__ = (f"``{name}`` of the JAX package; raises until ROADMAP "
                  f"queue 1 item 6 lands.")
    return fn


allgather_matmul = _collective("allgather_matmul")
matmul_allgather = _collective("matmul_allgather")
collective_matmul_traffic = _collective("collective_matmul_traffic")
