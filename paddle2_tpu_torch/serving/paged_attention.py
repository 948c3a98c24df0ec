"""Paged-attention decode: the CUDA kernels, their wrappers and their
plain versions.

Counterpart of ``paddle2_tpu/serving/paged_attention.py``. At decode
each sequence brings one query token and attends over its whole cached
context, whose K/V lie scattered across fixed-size blocks of the shared
pools (:mod:`.block_cache`). Two kernels, both in
``csrc/paged_decode.cu``, behind one dispatcher
(:func:`paged_attention_decode`):

* :func:`paged_decode` — one global softmax over the whole context
  (the JAX package's ``_decode_kernel``). One thread block per
  (sequence, head) keeps the context's f32 scores in shared memory.
* :func:`paged_decode_split_partials` — split-K partials
  ``(m, l, o)`` per (sequence, head, split) (``_decode_kernel_split``),
  merged by :func:`_merge_splits` in plain torch, as the JAX package
  merges them in plain XLA.

**The single/split switch, re-derived for the H100.** The TPU rule
budgeted VMEM for an ``[8, S]`` score buffer plus the gathered V. The
CUDA kernel gathers nothing: it reads K and V straight from the pools
and keeps only the f32 scores in shared memory, plus the query row, 8
warp partials and the p·V group partials (256 threads x 8 floats)::

    smem(S, D) = 4 * (S + D + 8 + 2048) bytes

A block may use at most 227 KB = 232,448 bytes of shared memory on the
H100, so the single kernel takes ``S <= 232448/4 - D - 2056`` keys:
55,928 at D = 128, far past the 2,048 positions of GPT-3 1.3B. Past
that the dispatcher halves the pages per split until one split fits.
``pages_per_split`` forces the split kernel whenever more than one
split results.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor
it launches its kernel or raises. Arithmetic of the plain versions
follows the kernels (and the Pallas bodies): the global body rounds
the score to the input dtype after the dot and after the scale, masks
with the dtype's most negative finite value, normalises in f32 and
rounds the probabilities to the input dtype; the split body masks with
``-inf`` and keeps ``m`` and ``l`` in f32. In f32 the two agree to
rounding; in bf16 they differ by bf16 rounding (the JAX tests hold
bf16 at 2e-2).

Precondition: ``ctx_lens >= 1`` for every row that is read (the
engine's padded rows have context 1 on the garbage block). The kernels
write zeros for a zero context.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..kernels import _build

__all__ = ["paged_attention_decode", "paged_decode",
           "paged_decode_split_partials", "paged_attention_reference",
           "paged_attention_split_reference", "gathered_dense_kv",
           "decode_scratch_smem_bytes", "fits_single_softmax",
           "auto_pages_per_split", "SMEM_BYTES"]

# shared memory one H100 block may use (dynamic, after opting in)
SMEM_BYTES = 232448
# floats of fixed scratch in csrc/paged_decode.cu besides the query row:
# 8 warp partials and 256 threads x 8 floats of p.V group partials
_FIXED_FLOATS = 8 + 256 * 8

SUPPORTED_HEAD_DIMS = (16, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "paged_decode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    "paged_decode_split": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _I, _I, _F, _P],
}


def decode_scratch_smem_bytes(n_keys: int, head_dim: int) -> int:
    """Shared memory one decode block needs for ``n_keys`` scores."""
    return 4 * (int(n_keys) + int(head_dim) + _FIXED_FLOATS)


def fits_single_softmax(n_pages: int, block_size: int,
                        head_dim: int) -> bool:
    """Can one block hold the scores of ``n_pages`` pages?"""
    return decode_scratch_smem_bytes(n_pages * block_size,
                                     head_dim) <= SMEM_BYTES


def auto_pages_per_split(n_pages: int, block_size: int,
                         head_dim: int) -> int:
    """Largest halving of ``n_pages`` whose split fits one block."""
    pps = max(int(n_pages), 1)
    while pps > 1 and not fits_single_softmax(pps, block_size, head_dim):
        pps = -(-pps // 2)
    return pps


def _check(q, k_pool, v_pool, block_tables, ctx_lens) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [B, 1, H, D], got {tuple(q.shape)}")
    B, _, H, D = q.shape
    if k_pool.dim() != 4 or k_pool.shape[2:] != (H, D) \
            or v_pool.shape != k_pool.shape:
        raise ValueError(f"pools must be [N, bs, {H}, {D}], got "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or tuple(ctx_lens.shape) != (B,):
        raise ValueError("block_tables must be [B, P] and ctx_lens [B]")
    if block_tables.dtype != torch.int32 or ctx_lens.dtype != torch.int32:
        raise ValueError("block_tables and ctx_lens must be int32")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {SUPPORTED_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k_pool.dtype}/{v_pool.dtype}: "
                         f"need float32 or bfloat16 for all three")
    devs = {t.device for t in (q, k_pool, v_pool, block_tables, ctx_lens)}
    if len(devs) != 1:
        raise ValueError(f"all inputs must lie on one device, got {devs}")


def _kernel_args(q, k_pool, v_pool, block_tables, ctx_lens):
    for t in (q, k_pool, v_pool, block_tables, ctx_lens):
        if not t.is_contiguous():
            raise ValueError("paged decode needs contiguous inputs")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("the kernels read the pools in 16-byte loads: "
                         "pools must be 16-byte aligned")
    return (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), ctx_lens.data_ptr())


# ------------------------------------------------------- plain versions
def gathered_dense_kv(pool, block_tables):
    """Dense ``[B, n_pages*block_size, H, D]`` view of every sequence's
    K or V through its block table."""
    g = pool[block_tables.long()]                  # [B, P, bs, H, D]
    return g.reshape(g.shape[0], -1, *g.shape[3:])


def _dense_scores(q, kd, scale):
    """[B, H, S] f32 scores, rounded to q's dtype after the dot and after
    the scale, as both kernels round them."""
    s = torch.einsum("bhd,bshd->bhs", q[:, 0].float(), kd.float())
    s = (s.to(q.dtype).float() * scale).to(q.dtype)
    return s.float()


def paged_attention_reference(q, k_pool, v_pool, block_tables, ctx_lens,
                              scale: Optional[float] = None):
    """Plain version of the global-softmax kernel: gather K/V through
    the table, mask keys past the context with the dtype's most negative
    finite value, one f32 softmax, probabilities in the input dtype."""
    _check(q, k_pool, v_pool, block_tables, ctx_lens)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    kd = gathered_dense_kv(k_pool, block_tables)
    vd = gathered_dense_kv(v_pool, block_tables)
    s = _dense_scores(q, kd, scale)
    valid = torch.arange(s.shape[-1], device=q.device)[None, :] \
        < ctx_lens.long()[:, None]
    s = s.masked_fill(~valid[:, None, :], torch.finfo(q.dtype).min)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bhs,bshd->bhd", p.float(), vd.float())
    return o.to(q.dtype)[:, None]


def _split_partials_reference(q, k_pool, v_pool, block_tables, ctx_lens,
                              scale, pps):
    """Plain version of the split kernel: ``(o [B,H,n,D], m [B,H,n],
    l [B,H,n])`` in f32."""
    B, _, H, D = q.shape
    bs = k_pool.shape[1]
    n_pages = block_tables.shape[1]
    n_splits = -(-n_pages // pps)
    width = pps * bs
    pad = n_splits * width - n_pages * bs
    kd = gathered_dense_kv(k_pool, block_tables)
    vd = gathered_dense_kv(v_pool, block_tables)
    s = _dense_scores(q, kd, scale)                       # [B, H, S]
    valid = torch.arange(s.shape[-1], device=q.device)[None, :] \
        < ctx_lens.long()[:, None]
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    s = torch.nn.functional.pad(s, (0, pad), value=float("-inf"))
    vd = torch.nn.functional.pad(vd, (0, 0, 0, 0, 0, pad))
    s = s.reshape(B, H, n_splits, width)
    m = s.amax(dim=-1)
    safe = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(s - safe[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhnw,bnwhd->bhnd", p.to(q.dtype).float(),
                     vd.reshape(B, n_splits, width, H, D).float())
    return o, m, l


def _merge_splits(o_parts, m, l, out_dtype):
    """Cross-split reduction in f32: rescale each split's partial by
    ``exp(m_i - max m)``, sum, normalise once. ``o_parts``
    ``[B, H, n, D]``; ``m``/``l`` ``[B, H, n]``. Dead splits
    (``m = -inf``) drop out."""
    m_max = m.amax(dim=2, keepdim=True)
    safe = torch.where(m_max == float("-inf"), torch.zeros_like(m_max),
                       m_max)
    w = torch.where(m == float("-inf"), torch.zeros_like(m),
                    torch.exp(m - safe))
    l_tot = (w * l).sum(dim=2)
    o = (w[..., None] * o_parts).sum(dim=2)
    l_safe = torch.where(l_tot == 0, torch.ones_like(l_tot), l_tot)
    return (o / l_safe[..., None]).to(out_dtype)


def paged_attention_split_reference(q, k_pool, v_pool, block_tables,
                                    ctx_lens, scale: Optional[float] = None,
                                    pages_per_split: int = 1):
    """Plain split-K path: plain partials, then :func:`_merge_splits`.
    Returns ``[B, 1, H, D]``."""
    _check(q, k_pool, v_pool, block_tables, ctx_lens)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    o, m, l = _split_partials_reference(q, k_pool, v_pool, block_tables,
                                        ctx_lens, float(scale),
                                        int(pages_per_split))
    return _merge_splits(o, m, l, q.dtype)[:, None]


# -------------------------------------------------------------- wrappers
def paged_decode(q, k_pool, v_pool, block_tables, ctx_lens, scale: float):
    """Global-softmax decode: ``[B, 1, H, D]``. ``paged_decode.launches``
    counts the kernel's launches."""
    _check(q, k_pool, v_pool, block_tables, ctx_lens)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, block_tables,
                                         ctx_lens, scale)
    B, _, H, D = q.shape
    bs = k_pool.shape[1]
    n_pages = block_tables.shape[1]
    if not fits_single_softmax(n_pages, bs, D):
        raise ValueError(f"{n_pages} pages of {bs} exceed one block's "
                         f"shared memory; use the split kernel")
    args = _kernel_args(q, k_pool, v_pool, block_tables, ctx_lens)
    out = torch.empty_like(q)
    lib = _build.library("paged_decode", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.paged_decode(
            *args, out.data_ptr(), B, H, D, bs, n_pages,
            _DTYPE_CODE[q.dtype], float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "paged_decode")
    paged_decode.launches += 1
    return out


paged_decode.launches = 0


def paged_decode_split_partials(q, k_pool, v_pool, block_tables, ctx_lens,
                                scale: float, pages_per_split: int
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Split-K partials ``(o [B,H,n,D], m [B,H,n], l [B,H,n])`` in f32.
    ``paged_decode_split_partials.launches`` counts the kernel's
    launches."""
    _check(q, k_pool, v_pool, block_tables, ctx_lens)
    pps = int(pages_per_split)
    if q.device.type == "cpu":
        return _split_partials_reference(q, k_pool, v_pool, block_tables,
                                         ctx_lens, float(scale), pps)
    B, _, H, D = q.shape
    bs = k_pool.shape[1]
    n_pages = block_tables.shape[1]
    if not fits_single_softmax(pps, bs, D):
        raise ValueError(f"a split of {pps} pages of {bs} exceeds one "
                         f"block's shared memory")
    n_splits = -(-n_pages // pps)
    args = _kernel_args(q, k_pool, v_pool, block_tables, ctx_lens)
    o = torch.empty((B, H, n_splits, D), dtype=torch.float32,
                    device=q.device)
    m = torch.empty((B, H, n_splits), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    lib = _build.library("paged_decode", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.paged_decode_split(
            *args, o.data_ptr(), m.data_ptr(), l.data_ptr(), B, H, D, bs,
            n_pages, pps, n_splits, _DTYPE_CODE[q.dtype], float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "paged_decode_split")
    paged_decode_split_partials.launches += 1
    return o, m, l


paged_decode_split_partials.launches = 0


def paged_attention_decode(q, k_pool, v_pool, block_tables, ctx_lens,
                           scale: Optional[float] = None,
                           pages_per_split: Optional[int] = None):
    """Paged decode attention.

    q: ``[B, 1, H, D]``; k_pool/v_pool: ``[num_blocks, block_size, H, D]``;
    block_tables: int32 ``[B, n_pages]`` physical block ids (padded with
    the garbage block); ctx_lens: int32 ``[B]`` valid keys per sequence,
    the token just appended included. Returns ``[B, 1, H, D]``.

    ``pages_per_split=None`` takes the global-softmax kernel whenever one
    block holds the context's scores (:func:`fits_single_softmax`), else
    :func:`auto_pages_per_split`. An explicit value forces split-K
    whenever more than one split results.
    """
    D = q.shape[-1]
    bs = k_pool.shape[1]
    n_pages = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if pages_per_split is None:
        pps = (n_pages if fits_single_softmax(n_pages, bs, D)
               else auto_pages_per_split(n_pages, bs, D))
    else:
        pps = max(1, min(int(pages_per_split), n_pages))
    if pps < n_pages:
        o, m, l = paged_decode_split_partials(q, k_pool, v_pool,
                                              block_tables, ctx_lens,
                                              float(scale), pps)
        return _merge_splits(o, m, l, q.dtype)[:, None]
    return paged_decode(q, k_pool, v_pool, block_tables, ctx_lens,
                        float(scale))
