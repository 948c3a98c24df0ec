"""Packed varlen flash attention, forward and backward: the CUDA kernels,
their wrappers, their plain versions and the differentiable op over them.

Counterpart of the varlen half of ``paddle2_tpu/kernels/pallas_flash.py``
(``_fwd_kernel_varlen``, ``_bwd_dkv_kernel_varlen``,
``_bwd_dq_kernel_varlen``, the ``_flash_varlen`` custom_vjp and
``flash_attention_varlen_packed``). The forward is
``csrc/flash_varlen_wgmma.cu`` for bf16 (tensor cores: wgmma fed by TMA,
reading the packed rows in place) and ``csrc/flash_varlen.cu`` for f32
(CUDA cores). The backward takes the route :func:`varlen_bwd_route`
names: for bf16 one fused kernel, ``csrc/flash_varlen_bwd_wgmma.cu``
(tensor cores, dQ, dK and dV from one score tile, dQ added through an
f32 buffer), for f32 the split pair of ``csrc/flash_varlen.cu`` (CUDA
cores, no atomics, bitwise reproducible); the bf16 split pair stays
callable through :func:`flash_varlen_bwd_dkv` / :func:`flash_varlen_bwd_dq`.
Each source's note says what bounds its kernels and how they are laid
out.

The ragged batch stays one packed sequence: ``q`` ``[Tq, H, D]``,
``k``/``v`` ``[Tk, H, D]``, and per row an int32 segment id and offset.
Query row ``r`` sees key ``c`` when ``seg_q[r] == seg_k[c]`` and
``off_k[c] <= off_q[r]``. The metadata contract is the JAX package's:
segment ids ascend over the real rows; padding rows, if any, come last
with negative ids that never match (the JAX package uses -1 for queries,
-2 for keys); ``off_k`` ascends within a segment and ``off_q`` does not
fall. Unlike the JAX package, the kernels take any ``T``: nothing pads
it to a multiple of 8.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel
or raises. There is no third path: head dims and dtypes the kernels do
not take (:func:`kernel_gap`) raise on both devices, and the public
route (``nn.functional.flash_attn_unpadded``) sends them elsewhere on
the CPU before they reach this module.

The differentiable op is ``torch.ops.paddle2_tpu_torch.flash_attn_varlen``,
a ``torch.library`` custom op returning ``(o, lse)`` with its backward
registered on it, so the "dots" remat policy
(:func:`.attention.remat_policy`) keeps its outputs and a rematerialised
block never re-runs the forward kernel.
"""

import ctypes
import math
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build
from ..ops.dispatch import checks_outputs
from .flash_attn import attention_flops

__all__ = ["flash_varlen_fwd", "flash_varlen_fwd_reference",
           "flash_varlen_bwd_dkv", "flash_varlen_bwd_dkv_reference",
           "flash_varlen_bwd_dq", "flash_varlen_bwd_dq_reference",
           "flash_varlen_bwd_fused", "flash_varlen_bwd_fused_reference",
           "varlen_bwd_route", "tile_ranges", "flash_attn_varlen",
           "flash_attn_varlen_bwd",
           "flash_attention_varlen_packed", "kernel_gap",
           "SUPPORTED_HEAD_DIMS", "TILE"]

SUPPORTED_HEAD_DIMS = (16, 64, 128)
# the rows of a tile_ranges entry: the CUDA-core kernels' query and key
# tile (BQ = BK in csrc/flash_varlen.cu); a block of the tensor-core
# forward (csrc/flash_varlen_wgmma.cu) takes 128 query rows, two entries
TILE = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HALF = (torch.bfloat16, torch.float16)

_P = ctypes.c_void_p
_I = ctypes.c_int
# <tensors...>, Tq, Tk, H, D, dtype, scale, stream
_TAIL = [_I] * 5 + [ctypes.c_float, _P]
# q, k, v, seg_q, off_q, seg_k, off_k, q_tiles, o, lse
_FWD_ARGS = [_P] * 10 + _TAIL
_SIGNATURES = {
    "flash_varlen_fwd": _FWD_ARGS,
    # q, k, v, do, lse, delta, seg_q, off_q, seg_k, off_k, k_tiles, dk, dv
    "flash_varlen_bwd_dkv": [_P] * 13 + _TAIL,
    # q, k, v, do, lse, delta, seg_q, off_q, seg_k, off_k, q_tiles, dq
    "flash_varlen_bwd_dq": [_P] * 12 + _TAIL,
}
# library (the source's stem) -> {C entry: argument types}
_LIBRARIES = {"flash_varlen": _SIGNATURES,
              "flash_varlen_wgmma": {"flash_varlen_fwd_wgmma": _FWD_ARGS},
              # q, k, v, do, lse, delta, seg_q, off_q, seg_k, off_k,
              # k_tiles, order (scratch), dq32, dk, dv
              "flash_varlen_bwd_wgmma": {
                  "flash_varlen_bwd_fused_wgmma": [_P] * 15 + _TAIL}}
# the fused kernel's keys a block (csrc/flash_varlen_bwd_wgmma.cu BKEY)
_FUSED_KEYS = 128
# (library, C entry) of the forward by dtype: the tensor-core kernel
# takes bf16 and f16, the CUDA-core kernel f32
_FWD_ENTRY = {torch.bfloat16: ("flash_varlen_wgmma", "flash_varlen_fwd_wgmma"),
              torch.float16: ("flash_varlen_wgmma", "flash_varlen_fwd_wgmma"),
              torch.float32: ("flash_varlen", "flash_varlen_fwd")}
_NEG = float("-inf")


def kernel_gap(q, k, v) -> Optional[str]:
    """Why the varlen kernels do not take these ``[T, H, D]`` inputs,
    naming the ROADMAP item that ports them; None when they do."""
    D = q.shape[-1]
    if D not in SUPPORTED_HEAD_DIMS:
        return (f"head_dim {D}: the varlen kernels take "
                f"{SUPPORTED_HEAD_DIMS} (the other head dims up to 256 are "
                f"ROADMAP.md queue 2 A1)")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        return (f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the varlen kernels "
                f"take float32, bfloat16 or float16 for all three")
    return None


def _check(q, k, v, seg_q, off_q, seg_k, off_k) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("varlen flash attention takes packed [T, H, D] "
                         "tensors")
    Tq, H, D = q.shape
    Tk = k.shape[0]
    if k.shape != v.shape or k.shape[1:] != (H, D):
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if Tq == 0 or Tk == 0:
        raise ValueError(f"need at least one row, got Tq={Tq} Tk={Tk}")
    gap = kernel_gap(q, k, v)
    if gap is not None:
        raise NotImplementedError(gap)
    for name, t, T in (("seg_q", seg_q, Tq), ("off_q", off_q, Tq),
                       ("seg_k", seg_k, Tk), ("off_k", off_k, Tk)):
        if t.dtype != torch.int32 or t.shape != (T,):
            raise ValueError(f"{name} must be int32 [{T}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if not all(t.device == q.device
               for t in (k, v, seg_q, off_q, seg_k, off_k)):
        raise ValueError("all varlen inputs must lie on one device")


def _check_tma(*tensors) -> None:
    """TMA reads a tensor whose base and strides lie on 16-byte
    boundaries; the bf16 kernels raise for a packed view that does not
    (:func:`flash_attention_varlen_packed` and the op's backward copy one
    whose base does not)."""
    for t in tensors:
        if t.data_ptr() % 16 or any(st * t.element_size() % 16
                                    for st in t.stride()[:-1]):
            raise ValueError(
                f"the bf16 varlen kernels read their inputs with TMA, which "
                f"needs 16-byte aligned bases and strides; got a "
                f"{tuple(t.shape)} tensor at {t.data_ptr():#x} with strides "
                f"{t.stride()}")


def _check_tiles(tiles, T, name) -> None:
    want = (-(-T // TILE), 2)
    if tiles.dtype != torch.int32 or tuple(tiles.shape) != want:
        raise ValueError(f"{name} must be int32 {want}, got {tiles.dtype} "
                         f"{tuple(tiles.shape)}")


def _check_bwd(q, do, lse, delta) -> None:
    Tq, H, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do {do.dtype} {tuple(do.shape)} must have q's "
                         f"dtype and shape {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (H, Tq) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {(H, Tq)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if not (do.device == lse.device == delta.device == q.device):
        raise ValueError("all varlen backward inputs must lie on one device")


# ----------------------------------------------------------- tile ranges

_KEY_BIAS = 2 ** 31
_PAD_KEY = torch.iinfo(torch.int64).max


def _row_keys(seg, off):
    """(seg, off) as one int64 that sorts as the pair; padding rows
    (negative ids) sort last."""
    key = seg.long() * 2 ** 32 + (off.long() + _KEY_BIAS)
    return torch.where(seg >= 0, key, torch.full_like(key, _PAD_KEY))


def _per_tile(lo, hi, T, empty_lo):
    """Per 64-row tile, the smallest ``lo`` and the largest ``hi`` of its
    rows; rows with an empty range (``hi <= lo``) do not count."""
    n = -(-T // TILE)
    keep = hi > lo
    lo = torch.where(keep, lo, torch.full_like(lo, empty_lo))
    hi = torch.where(keep, hi, torch.zeros_like(hi))
    pad = n * TILE - T
    lo = torch.nn.functional.pad(lo, (0, pad), value=empty_lo)
    hi = torch.nn.functional.pad(hi, (0, pad), value=0)
    return torch.stack([lo.view(n, TILE).amin(1), hi.view(n, TILE).amax(1)],
                       dim=1).to(torch.int32).contiguous()


def tile_ranges(seg_q, off_q, seg_k, off_k
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The live range of each 64-row tile, computed on the metadata's
    device without a host sync: ``q_tiles[t] = [k_lo, k_hi)``, the keys
    the query rows of tile ``t`` can see, and ``k_tiles[t] = [q_lo,
    q_hi)``, the query rows that can see the keys of key tile ``t``.
    Under the module's metadata contract each is one contiguous range,
    and every (query, key) pair the mask keeps lies inside both. A tile
    whose rows see nothing gets an empty range."""
    kk = _row_keys(seg_k, off_k)
    qk = _row_keys(seg_q, off_q)
    real_q, real_k = seg_q >= 0, seg_k >= 0
    seg_q64, seg_k64 = seg_q.long(), seg_k.long()
    # row r sees keys [start of its segment, last key with off <= off_q]
    k_lo = torch.searchsorted(kk, seg_q64 * 2 ** 32)
    k_hi = torch.searchsorted(kk, qk, right=True)
    k_hi = torch.where(real_q, k_hi, torch.zeros_like(k_hi))
    # key c is seen by rows [first with off_q >= off_k, end of its segment]
    q_lo = torch.searchsorted(qk, kk)
    q_hi = torch.searchsorted(qk, (seg_k64 + 1) * 2 ** 32)
    q_hi = torch.where(real_k, q_hi, torch.zeros_like(q_hi))
    Tq, Tk = seg_q.shape[0], seg_k.shape[0]
    return (_per_tile(k_lo, k_hi, Tq, Tk), _per_tile(q_lo, q_hi, Tk, Tq))


# ------------------------------------------------------- plain versions

def _heads(t):
    """[T, H, D] -> f32 [H, T, D]."""
    return t.float().transpose(0, 1)


def _masked_scores(q, k, seg_q, off_q, seg_k, off_k, scale):
    """f32 ``q·kᵀ·scale`` [H, Tq, Tk], -inf where the segment mask drops
    the pair."""
    keep = (seg_q[:, None] == seg_k[None, :]) & \
        (off_k[None, :] <= off_q[:, None])
    s = torch.matmul(_heads(q), _heads(k).transpose(-1, -2)) * scale
    return s.masked_fill(~keep, _NEG)


def flash_varlen_fwd_reference(q, k, v, seg_q, off_q, seg_k, off_k,
                               scale: float
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward: one softmax over the whole masked row in f32,
    the probabilities rounded to the input dtype before ``p @ v``, a row
    that sees no key giving ``o = 0`` and ``lse = -inf``. Returns ``o``
    ``[Tq, H, D]`` and ``lse`` f32 ``[H, Tq]``."""
    s = _masked_scores(q, k, seg_q, off_q, seg_k, off_k, scale)
    m = s.amax(dim=-1, keepdim=True)
    safe_m = torch.where(m == _NEG, torch.zeros_like(m), m)
    p = torch.exp(s - safe_m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), _heads(v))
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    lse = torch.where(l == 0, torch.full_like(l, _NEG),
                      m + torch.log(safe_l))
    return ((o / safe_l).to(q.dtype).transpose(0, 1).contiguous(),
            lse.squeeze(-1))


def _p_ds(q, k, v, do, lse, delta, seg_q, off_q, seg_k, off_k, scale):
    """P and dS [H, Tq, Tk] of the split backward (``_bwd_p_ds``, guarded
    form), each rounded to the input dtype as it enters a product."""
    dt = q.dtype
    s = _masked_scores(q, k, seg_q, off_q, seg_k, off_k, scale)
    lse = lse[..., None]
    p = torch.exp(s - torch.where(lse == _NEG, torch.zeros_like(lse), lse))
    p = torch.where((s == _NEG) | (lse == _NEG), torch.zeros_like(p), p)
    dp = torch.matmul(_heads(do), _heads(v).transpose(-1, -2))
    ds = (p * (dp - delta[..., None])).to(dt).float()
    return p.to(dt).float(), ds


def flash_varlen_bwd_dkv_reference(q, k, v, do, lse, delta, seg_q, off_q,
                                   seg_k, off_k, scale: float,
                                   out_dtype: Optional[torch.dtype] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain dK/dV (``_bwd_dkv_kernel_varlen``): ``dV = Pᵀ·dO``,
    ``dK = dSᵀ·Q·scale``, f32 sums, cast to ``out_dtype`` (default the
    input dtype), ``[Tk, H, D]``. ``torch.float32`` keeps the sums the
    kernel rounds once at its end: a bf16 kernel and this version sum in
    different orders, so their bf16 outputs may differ by one step where
    a sum lies next to a rounding boundary."""
    p, ds = _p_ds(q, k, v, do, lse, delta, seg_q, off_q, seg_k, off_k,
                  scale)
    dv = torch.matmul(p.transpose(-1, -2), _heads(do))
    dk = torch.matmul(ds.transpose(-1, -2), _heads(q)) * scale
    return (dk.to(out_dtype or k.dtype).transpose(0, 1).contiguous(),
            dv.to(out_dtype or v.dtype).transpose(0, 1).contiguous())


def flash_varlen_bwd_dq_reference(q, k, v, do, lse, delta, seg_q, off_q,
                                  seg_k, off_k, scale: float,
                                  out_dtype: Optional[torch.dtype] = None
                                  ) -> torch.Tensor:
    """The plain dQ (``_bwd_dq_kernel_varlen``): ``dQ = dS·K·scale``, f32
    sums, cast to ``out_dtype`` (default the input dtype), ``[Tq, H,
    D]``."""
    _, ds = _p_ds(q, k, v, do, lse, delta, seg_q, off_q, seg_k, off_k,
                  scale)
    dq = torch.matmul(ds, _heads(k)) * scale
    return dq.to(out_dtype or q.dtype).transpose(0, 1).contiguous()


def flash_varlen_bwd_fused_reference(q, k, v, do, lse, delta, seg_q, off_q,
                                     seg_k, off_k, scale: float,
                                     out_dtype: Optional[torch.dtype] = None
                                     ) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """The plain fused backward: the two plain versions above on one P
    and dS (``_bwd_dkv_kernel_varlen`` and ``_bwd_dq_kernel_varlen``
    together). Returns ``(dq, dk, dv)``, f32 sums cast to ``out_dtype``
    (default the input dtype)."""
    p, ds = _p_ds(q, k, v, do, lse, delta, seg_q, off_q, seg_k, off_k,
                  scale)
    dq = torch.matmul(ds, _heads(k)) * scale
    dk = torch.matmul(ds.transpose(-1, -2), _heads(q)) * scale
    dv = torch.matmul(p.transpose(-1, -2), _heads(do))
    return tuple(t.to(out_dtype or q.dtype).transpose(0, 1).contiguous()
                 for t in (dq, dk, dv))


# -------------------------------------------------------------- wrappers

def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


@checks_outputs("flash_varlen_fwd",
                lambda out, *a, **k: out[0])
def flash_varlen_fwd(q, k, v, seg_q, off_q, seg_k, off_k, q_tiles,
                     scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The varlen forward kernel: ``o`` ``[Tq, H, D]`` in the input dtype
    and ``lse`` f32 ``[H, Tq]``; bf16 on the tensor cores (``q``, ``k``
    and ``v`` 16-byte aligned, or it raises), f32 on the CUDA cores.
    ``q_tiles`` is :func:`tile_ranges`'s first table.
    ``flash_varlen_fwd.launches`` counts its launches."""
    _check(q, k, v, seg_q, off_q, seg_k, off_k)
    _check_tiles(q_tiles, q.shape[0], "q_tiles")
    if not _build.on_card("flash_varlen_fwd", q, k, v, seg_q, off_q, seg_k,
                          off_k, q_tiles):
        return flash_varlen_fwd_reference(q, k, v, seg_q, off_q, seg_k,
                                          off_k, float(scale))
    Tq, H, D = q.shape
    if q.dtype in _HALF:
        _check_tma(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((H, Tq), dtype=torch.float32, device=q.device)
    name, entry = _FWD_ENTRY[q.dtype]
    lib = _build.library(name, _LIBRARIES[name])
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            *[t.data_ptr() for t in (q, k, v, seg_q, off_q, seg_k, off_k,
                                     q_tiles, o, lse)],
            Tq, k.shape[0], H, D, _DTYPE_CODE[q.dtype], float(scale),
            _stream(q))
    _build.check(lib, err, entry)
    flash_varlen_fwd.launches += 1
    flash_varlen_fwd.dtype_launches[q.dtype] += 1
    return o, lse


def _bwd_launch(entry, q, k, v, do, lse, delta, meta, tiles, outs, scale):
    Tq, H, D = q.shape
    lib = _build.library("flash_varlen", _LIBRARIES["flash_varlen"])
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            *[t.data_ptr() for t in (q, k, v, do, lse, delta, *meta, tiles,
                                     *outs)],
            Tq, k.shape[0], H, D, _DTYPE_CODE[q.dtype], float(scale),
            _stream(q))
    _build.check(lib, err, entry)


@checks_outputs("flash_varlen_bwd_dkv")
def flash_varlen_bwd_dkv(q, k, v, do, lse, delta, seg_q, off_q, seg_k,
                         off_k, k_tiles, scale: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward kernel 1 (``_bwd_dkv_kernel_varlen``): ``(dk, dv)``
    ``[Tk, H, D]``, one block per 64-key tile looping over the live query
    range ``k_tiles`` (:func:`tile_ranges`'s second table)."""
    meta = (seg_q, off_q, seg_k, off_k)
    _check(q, k, v, *meta)
    _check_bwd(q, do, lse, delta)
    _check_tiles(k_tiles, k.shape[0], "k_tiles")
    if not _build.on_card("flash_varlen_bwd_dkv", q, k, v, do, lse, delta,
                          *meta, k_tiles):
        return flash_varlen_bwd_dkv_reference(q, k, v, do, lse, delta,
                                              *meta, float(scale))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("flash_varlen_bwd_dkv", q, k, v, do, lse, delta, meta,
                k_tiles, (dk, dv), scale)
    flash_varlen_bwd_dkv.launches += 1
    flash_varlen_bwd_dkv.dtype_launches[q.dtype] += 1
    return dk, dv


@checks_outputs("flash_varlen_bwd_dq")
def flash_varlen_bwd_dq(q, k, v, do, lse, delta, seg_q, off_q, seg_k,
                        off_k, q_tiles, scale: float) -> torch.Tensor:
    """Backward kernel 2 (``_bwd_dq_kernel_varlen``): ``dq``
    ``[Tq, H, D]``, one block per 64-row query tile looping over its live
    key range ``q_tiles``."""
    meta = (seg_q, off_q, seg_k, off_k)
    _check(q, k, v, *meta)
    _check_bwd(q, do, lse, delta)
    _check_tiles(q_tiles, q.shape[0], "q_tiles")
    if not _build.on_card("flash_varlen_bwd_dq", q, k, v, do, lse, delta,
                          *meta, q_tiles):
        return flash_varlen_bwd_dq_reference(q, k, v, do, lse, delta,
                                             *meta, float(scale))
    dq = torch.empty_like(q)
    _bwd_launch("flash_varlen_bwd_dq", q, k, v, do, lse, delta, meta,
                q_tiles, (dq,), scale)
    flash_varlen_bwd_dq.launches += 1
    flash_varlen_bwd_dq.dtype_launches[q.dtype] += 1
    return dq


@checks_outputs("flash_varlen_bwd_fused")
def flash_varlen_bwd_fused(q, k, v, do, lse, delta, seg_q, off_q, seg_k,
                           off_k, k_tiles, scale: float
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """The fused backward (``_bwd_dkv_kernel_varlen`` and
    ``_bwd_dq_kernel_varlen`` in one kernel, on the tensor cores; bf16
    only): ``(dq, dk, dv)`` in bf16, one block per 128-key tile walking
    the live query range ``k_tiles`` (:func:`tile_ranges`'s second
    table). q, k, v and do must be 16-byte aligned (TMA), or it raises.
    Each block adds its dQ share into an f32 buffer with TMA reductions,
    cast to bf16 after the kernel; their order changes from run to run,
    so dq is not bitwise deterministic (dk and dv are)."""
    meta = (seg_q, off_q, seg_k, off_k)
    _check(q, k, v, *meta)
    _check_bwd(q, do, lse, delta)
    _check_tiles(k_tiles, k.shape[0], "k_tiles")
    if not _build.on_card("flash_varlen_bwd_fused", q, k, v, do, lse, delta,
                          *meta, k_tiles):
        return flash_varlen_bwd_fused_reference(q, k, v, do, lse, delta,
                                                *meta, float(scale))
    if q.dtype not in _HALF:
        raise ValueError(f"the fused varlen backward takes bfloat16 or "
                         f"float16, got {q.dtype} (f32 takes the split "
                         f"route)")
    _check_tma(q, k, v, do)
    Tq, H, D = q.shape
    Tk = k.shape[0]
    dq32 = torch.zeros((Tq, H, D), dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    order = torch.empty(-(-Tk // _FUSED_KEYS), dtype=torch.int32,
                        device=q.device)
    entry = "flash_varlen_bwd_fused_wgmma"
    lib = _build.library("flash_varlen_bwd_wgmma",
                         _LIBRARIES["flash_varlen_bwd_wgmma"])
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            *[t.data_ptr() for t in (q, k, v, do, lse, delta, *meta, k_tiles,
                                     order, dq32, dk, dv)],
            Tq, Tk, H, D, _DTYPE_CODE[q.dtype], float(scale), _stream(q))
    _build.check(lib, err, entry)
    flash_varlen_bwd_fused.launches += 1
    flash_varlen_bwd_fused.dtype_launches[q.dtype] += 1
    return dq32.to(q.dtype), dk, dv


for _fn in (flash_varlen_fwd, flash_varlen_bwd_dkv, flash_varlen_bwd_dq,
            flash_varlen_bwd_fused):
    _fn.launches = 0
    _fn.dtype_launches = dict.fromkeys(_DTYPE_CODE, 0)   # by dtype


def varlen_bwd_route(dtype: torch.dtype) -> str:
    """The packed backward's route: "fused" for bf16 (one tensor-core
    kernel, ``csrc/flash_varlen_bwd_wgmma.cu``), "split" for f32 (the
    CUDA-core pair, which has no atomics and so stays bitwise
    reproducible, the precision a run is checked in). PERF.md gives the
    H100 times that ground the rule. The choice is made before the
    launch; a launch that fails raises."""
    return "fused" if dtype in _HALF else "split"


# ----------------------------------------------------- differentiable op

@torch.library.custom_op(
    "paddle2_tpu_torch::flash_attn_varlen", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor seg_q, Tensor off_q, "
           "Tensor seg_k, Tensor off_k, Tensor q_tiles, Tensor k_tiles, "
           "float scale) -> (Tensor, Tensor)")
def flash_attn_varlen(q, k, v, seg_q, off_q, seg_k, off_k, q_tiles,
                      k_tiles, scale):
    """Differentiable packed varlen attention on contiguous ``[T, H, D]``
    tensors: ``(o, lse)`` from :func:`flash_varlen_fwd`. Its backward
    takes ``delta = rowsum(dO∘O)`` in f32 (plain torch, as the JAX
    package's ``_varlen_bwd``), then the route :func:`varlen_bwd_route`
    names: the fused kernel, or the dK/dV kernel and then dQ."""
    return flash_varlen_fwd(q, k, v, seg_q, off_q, seg_k, off_k, q_tiles,
                            scale)


@flash_attn_varlen.register_fake
def _(q, k, v, seg_q, off_q, seg_k, off_k, q_tiles, k_tiles, scale):
    Tq, H, _ = q.shape
    return torch.empty_like(q), q.new_empty((H, Tq), dtype=torch.float32)


def _varlen_setup(ctx, inputs, output):
    q, k, v, seg_q, off_q, seg_k, off_k, q_tiles, k_tiles, scale = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse, seg_q, off_q, seg_k, off_k,
                          q_tiles, k_tiles)
    ctx.scale = scale


@torch.library.custom_op(
    "paddle2_tpu_torch::flash_attn_varlen_bwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, "
           "Tensor do, Tensor seg_q, Tensor off_q, Tensor seg_k, "
           "Tensor off_k, Tensor q_tiles, Tensor k_tiles, float scale) "
           "-> (Tensor, Tensor, Tensor)")
def flash_attn_varlen_bwd(q, k, v, o, lse, do, seg_q, off_q, seg_k, off_k,
                          q_tiles, k_tiles, scale):
    """The backward of :func:`flash_attn_varlen` as one op, so that a
    ``FlopCounterMode`` counts it by its formula: ``delta =
    rowsum(dO∘O)`` in f32, then the route :func:`varlen_bwd_route`
    names. Returns ``(dq, dk, dv)``."""
    delta = (do.float() * o.float()).sum(-1).t().contiguous()
    meta = (seg_q, off_q, seg_k, off_k)
    if varlen_bwd_route(q.dtype) == "fused":
        return flash_varlen_bwd_fused(
            q, k, v, _build.tma_aligned(do), lse, delta, *meta, k_tiles,
            scale)
    dk, dv = flash_varlen_bwd_dkv(q, k, v, do, lse, delta, *meta,
                                  k_tiles, scale)
    dq = flash_varlen_bwd_dq(q, k, v, do, lse, delta, *meta, q_tiles,
                             scale)
    return dq, dk, dv


@flash_attn_varlen_bwd.register_fake
def _(q, k, v, o, lse, do, *args):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _varlen_backward(ctx, do, _dlse):
    q, k, v, o, lse, *meta = ctx.saved_tensors
    dq, dk, dv = flash_attn_varlen_bwd(q, k, v, o, lse, do.contiguous(),
                                       *meta, ctx.scale)
    return (dq, dk, dv) + (None,) * 7


flash_attn_varlen.register_autograd(_varlen_backward,
                                    setup_context=_varlen_setup)


def _sequence_pairs(seg_q, seg_k) -> int:
    """Σ over the packed sequences of ``len_q · len_k``: the full square
    of each (one read of the segment counts from the device)."""
    n = int(max(int(seg_q.max()), int(seg_k.max()))) + 1 \
        if seg_q.numel() and seg_k.numel() else 0
    if n == 0:
        return 0
    nq = torch.bincount(seg_q.long(), minlength=n)
    nk = torch.bincount(seg_k.long(), minlength=n)
    return int((nq * nk).sum())


def _varlen_flops(q, k, v, seg_q, seg_k, backward: bool) -> int:
    """:func:`~.flash_attn.attention_flops` over each packed sequence's
    full square (B = H = 1 there, times the heads and the pairs)."""
    pairs = _sequence_pairs(seg_q, seg_k)
    H, D, Dv = q.shape[1], q.shape[2], v.shape[2]
    return H * attention_flops(1, 1, pairs, 1, D, Dv, backward=backward)


@register_flop_formula(torch.ops.paddle2_tpu_torch.flash_attn_varlen,
                       get_raw=True)
def _flash_attn_varlen_flops(q, k, v, seg_q, off_q, seg_k, off_k, *args,
                             **kwargs) -> int:
    return _varlen_flops(q, k, v, seg_q, seg_k, backward=False)


@register_flop_formula(torch.ops.paddle2_tpu_torch.flash_attn_varlen_bwd,
                       get_raw=True)
def _flash_attn_varlen_bwd_flops(q, k, v, o, lse, do, seg_q, off_q, seg_k,
                                 off_k, *args, **kwargs) -> int:
    return _varlen_flops(q, k, v, seg_q, seg_k, backward=True)


def flash_attention_varlen_packed(q, k, v, seg_q, off_q, seg_k, off_k,
                                  scale: Optional[float] = None,
                                  tiles: Optional[Tuple] = None
                                  ) -> torch.Tensor:
    """Packed varlen flash attention, differentiable: ``q`` ``[Tq, H,
    D]``, ``k``/``v`` ``[Tk, H, D]``, per-row int32 ``seg_*``/``off_*``
    (any array-like; see the module's contract). Returns ``o`` ``[Tq, H,
    D]``. The JAX function's ``block_q``/``block_k``/``interpret`` are
    TPU tuning and are not carried over. ``tiles``, the pair
    :func:`tile_ranges` gives for this metadata, skips recomputing it
    (the functional layer memoizes it per ``cu_seqlens``). A bf16 input
    that TMA cannot read in place (a contiguous view off a 16-byte
    boundary) is copied first, as the dense wrapper does."""
    meta = [torch.as_tensor(t, dtype=torch.int32, device=q.device)
            for t in (seg_q, off_q, seg_k, off_k)]
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if tiles is None:
        tiles = tile_ranges(*meta)
    q, k, v = (t.contiguous() for t in (q, k, v))
    if q.dtype in _HALF:
        q, k, v = (_build.tma_aligned(t) for t in (q, k, v))
    o, _ = flash_attn_varlen(q, k, v, *meta, *tiles, float(scale))
    return o
