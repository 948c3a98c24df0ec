"""Paged-attention decode: the CUDA kernel, its wrappers and their
plain versions.

Counterpart of ``paddle2_tpu/serving/paged_attention.py``. At decode
each sequence brings one query token and attends over its whole cached
context, whose K/V lie scattered across fixed-size blocks of the shared
pools (:mod:`.block_cache`). One kernel template in
``csrc/paged_decode.cu`` serves both routes, behind one dispatcher
(:func:`paged_attention_decode`):

* :func:`paged_decode` — one global softmax over the whole context
  (the JAX package's ``_decode_kernel``).
* :func:`paged_decode_split_partials` — split-K partials
  ``(m, l, o)`` per (sequence, head, split) (``_decode_kernel_split``),
  merged by :func:`_merge_splits` in plain torch, as the JAX package
  merges them in plain XLA.

**The plan.** One thread-block cluster of ``C`` blocks takes each
(sequence, head, range): the range is the whole table on the global
route and one split of ``pages_per_split`` pages on the split route.
:func:`cluster_plan` picks ``C`` (a power of two, at most
``MAX_CLUSTER`` = 16, while each block keeps at least ``TARGET_KEYS`` =
128 keys) and each block's chunk of pages from the range's width alone,
a host int: the wrapper never reads ``ctx_lens`` back from the card.
The blocks agree on the softmax through distributed shared memory; a
block whose chunk lies past the context exits at once.

**The single/split switch, re-derived for the cluster kernel.** A block
keeps a ring of 2 tiles of 8 KB, the f32 scores and the page ids of its
chunk, and fixed scratch (128 p.V partials, the ranks' maxima and sums,
the o columns the other blocks push to it, 4 warp partials)::

    smem = 16384 + 4 * (keys + pages + D + 180) bytes

(:func:`decode_scratch_smem_bytes`). A block may use at most 227 KB =
232,448 bytes on the H100, so a chunk holds up to 3,159 pages of 16 keys
at D = 128, and the global route takes tables of up to 16 such chunks
(808,704 keys). Past that the dispatcher halves the pages per split
until one split's chunk fits (:func:`auto_pages_per_split`).
``pages_per_split`` forces the split route whenever more than one split
results.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor
it launches its kernel or raises. Arithmetic of the plain versions
follows the kernel (and the Pallas bodies): the global body rounds
the score to the input dtype after the dot and after the scale, masks
with the dtype's most negative finite value, normalises in f32 and
rounds the probabilities to the input dtype; the split body masks with
``-inf`` and keeps ``m`` and ``l`` in f32. In f32 the two agree to
rounding; in bf16 they differ by bf16 rounding (the JAX tests hold
bf16 at 2e-2).

Precondition: ``ctx_lens >= 1`` for every row that is read (the
engine's padded rows have context 1 on the garbage block). The kernel
writes zeros for a zero context.

**The counted op.** :func:`paged_attention_op` is
:func:`paged_attention_decode` registered as the custom op
``paddle2_tpu_torch::paged_attention`` with a flop formula
(:func:`paged_attention_flops`), so that
``torch.utils.flop_counter.FlopCounterMode`` (the cost model's
``program_cost``) counts a decode the same on the card, where the
kernel is a C call it cannot see into, and on the CPU, where it would
otherwise count the plain version's products. The serving runner calls
:func:`paged_attention_decode` itself (an op's dispatch costs host time
on every call) and prices its steps by the same formula. The formula
is those products: ``QKᵀ`` over every key slot of the table, padded pages
included, and ``PV`` over as many, rounded up to whole splits on the
split route (as the plain split version pads its last split):
``2·B·H·block_size·D·(pages + pv_pages)``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from torch.utils.flop_counter import register_flop_formula

from ..kernels import _build
from ..ops.dispatch import checks_outputs

__all__ = ["paged_attention_op", "paged_attention_flops",
           "paged_attention_decode", "paged_decode",
           "paged_decode_split_partials", "paged_attention_reference",
           "paged_attention_split_reference", "gathered_dense_kv",
           "decode_scratch_smem_bytes", "fits_single_softmax",
           "route_pages_per_split",
           "auto_pages_per_split", "cluster_plan", "SMEM_BYTES",
           "TARGET_KEYS", "MAX_CLUSTER"]

# shared memory one H100 block may use (dynamic, after opting in)
SMEM_BYTES = 232448
# csrc/paged_decode.cu: a cluster grows (in powers of two, to MAX_CLUSTER
# blocks) while each block keeps at least TARGET_KEYS keys of its range
TARGET_KEYS = 128
MAX_CLUSTER = 16
# csrc/paged_decode.cu: the ring (2 tiles of 8 KB) and the fixed floats
# besides the scores, page ids and D: 128 p.V partials, the ranks' maxima
# and sums and MAX_CLUSTER more pushed columns, and 4 warp partials
_RING_BYTES = 2 * 8192
_FIXED_FLOATS = 128 + 3 * MAX_CLUSTER + 4

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


def cluster_plan(range_pages: int, block_size: int) -> Tuple[int, int]:
    """``(C, chunk_pages)`` for a range of ``range_pages`` pages (the
    table's width on the global route, one split's on the split route):
    C is the largest power of two up to ``MAX_CLUSTER`` whose blocks keep
    at least ``TARGET_KEYS`` keys each (1 for a short range), and block r
    of the cluster takes pages ``[r * chunk, (r + 1) * chunk)``. The rule
    of ``csrc/paged_decode.cu`` ``plan``."""
    keys = int(range_pages) * int(block_size)
    c = 1
    while c < MAX_CLUSTER and 2 * c * TARGET_KEYS <= keys:
        c *= 2
    return c, -(-int(range_pages) // c)


def decode_scratch_smem_bytes(n_keys: int, head_dim: int,
                              block_size: int) -> int:
    """Shared memory of one decode block whose chunk holds ``n_keys``
    keys in pages of ``block_size``."""
    pages = -(-int(n_keys) // int(block_size))
    return _RING_BYTES + 4 * (int(n_keys) + pages + int(head_dim)
                              + _FIXED_FLOATS)


def fits_single_softmax(n_pages: int, block_size: int,
                        head_dim: int) -> bool:
    """Does a cluster's block hold its chunk of a range of ``n_pages``
    pages?"""
    _, chunk = cluster_plan(n_pages, block_size)
    return decode_scratch_smem_bytes(chunk * block_size, head_dim,
                                     block_size) <= SMEM_BYTES


def auto_pages_per_split(n_pages: int, block_size: int,
                         head_dim: int) -> int:
    """Largest halving of ``n_pages`` whose split fits one cluster."""
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
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("the kernel copies the pools in 16-byte pieces: "
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
    the scale, as the kernel rounds them on both routes."""
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


@checks_outputs("paged_attention_split_reference")
def paged_attention_split_reference(q, k_pool, v_pool, block_tables,
                                    ctx_lens, scale: Optional[float] = None,
                                    pages_per_split: int = 1):
    """Plain split-K path: plain partials, then :func:`_merge_splits`.
    Returns ``[B, 1, H, D]``. Its ``-inf`` masks run out of sight of
    ``FLAGS_check_nan_inf``, which checks the result."""
    _check(q, k_pool, v_pool, block_tables, ctx_lens)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    o, m, l = _split_partials_reference(q, k_pool, v_pool, block_tables,
                                        ctx_lens, float(scale),
                                        int(pages_per_split))
    return _merge_splits(o, m, l, q.dtype)[:, None]


# -------------------------------------------------------------- wrappers
@checks_outputs("paged_decode")
def paged_decode(q, k_pool, v_pool, block_tables, ctx_lens, scale: float):
    """Global-softmax decode: ``[B, 1, H, D]``. ``paged_decode.launches``
    counts the kernel's launches."""
    _check(q, k_pool, v_pool, block_tables, ctx_lens)
    if not _build.on_card("paged_decode", q, k_pool, v_pool, block_tables,
                          ctx_lens):
        return paged_attention_reference(q, k_pool, v_pool, block_tables,
                                         ctx_lens, scale)
    B, _, H, D = q.shape
    bs = k_pool.shape[1]
    n_pages = block_tables.shape[1]
    if not fits_single_softmax(n_pages, bs, D):
        raise ValueError(f"{n_pages} pages of {bs} exceed a cluster's "
                         f"shared memory; use the split route")
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


@checks_outputs("paged_decode_split_partials",
                lambda out, *a, **k: out[0])
def paged_decode_split_partials(q, k_pool, v_pool, block_tables, ctx_lens,
                                scale: float, pages_per_split: int
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Split-K partials ``(o [B,H,n,D], m [B,H,n], l [B,H,n])`` in f32.
    ``paged_decode_split_partials.launches`` counts the kernel's
    launches."""
    _check(q, k_pool, v_pool, block_tables, ctx_lens)
    pps = int(pages_per_split)
    if not _build.on_card("paged_decode_split", q, k_pool, v_pool,
                          block_tables, ctx_lens):
        return _split_partials_reference(q, k_pool, v_pool, block_tables,
                                         ctx_lens, float(scale), pps)
    B, _, H, D = q.shape
    bs = k_pool.shape[1]
    n_pages = block_tables.shape[1]
    if not fits_single_softmax(pps, bs, D):
        raise ValueError(f"a split of {pps} pages of {bs} exceeds a "
                         f"cluster's shared memory")
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


def route_pages_per_split(n_pages: int, block_size: int, head_dim: int,
                          pages_per_split: Optional[int] = None) -> int:
    """The pages of one split that :func:`paged_attention_decode` runs
    (``n_pages`` or more: the global route)."""
    if pages_per_split is None:
        return (n_pages if fits_single_softmax(n_pages, block_size, head_dim)
                else auto_pages_per_split(n_pages, block_size, head_dim))
    return max(1, min(int(pages_per_split), n_pages))


@checks_outputs("paged_attention_decode")
def paged_attention_decode(q, k_pool, v_pool, block_tables, ctx_lens,
                           scale: Optional[float] = None,
                           pages_per_split: Optional[int] = None):
    """Paged decode attention.

    q: ``[B, 1, H, D]``; k_pool/v_pool: ``[num_blocks, block_size, H, D]``;
    block_tables: int32 ``[B, n_pages]`` physical block ids (padded with
    the garbage block); ctx_lens: int32 ``[B]`` valid keys per sequence,
    the token just appended included. Returns ``[B, 1, H, D]``.

    ``pages_per_split=None`` takes the global route whenever one cluster
    holds the whole table (:func:`fits_single_softmax`), else
    :func:`auto_pages_per_split`. An explicit value forces split-K
    whenever more than one split results.
    """
    D = q.shape[-1]
    bs = k_pool.shape[1]
    n_pages = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    pps = route_pages_per_split(n_pages, bs, D, pages_per_split)
    if pps < n_pages:
        o, m, l = paged_decode_split_partials(q, k_pool, v_pool,
                                              block_tables, ctx_lens,
                                              float(scale), pps)
        return _merge_splits(o, m, l, q.dtype)[:, None]
    return paged_decode(q, k_pool, v_pool, block_tables, ctx_lens,
                        float(scale))


# -------------------------------------------------- the counted op
@torch.library.custom_op(
    "paddle2_tpu_torch::paged_attention", mutates_args=(),
    schema="(Tensor q, Tensor k_pool, Tensor v_pool, Tensor block_tables, "
           "Tensor ctx_lens, float scale, int? pages_per_split) -> Tensor")
def paged_attention_op(q, k_pool, v_pool, block_tables, ctx_lens, scale,
                    pages_per_split):
    """:func:`paged_attention_decode` as one op, so that a
    ``FlopCounterMode`` counts it by :func:`paged_attention_flops`
    wherever it runs. ``scale`` is explicit."""
    return paged_attention_decode(q, k_pool, v_pool, block_tables,
                                  ctx_lens, scale=scale,
                                  pages_per_split=pages_per_split)


@paged_attention_op.register_fake
def _(q, k_pool, v_pool, block_tables, ctx_lens, scale, pages_per_split):
    return torch.empty_like(q)


def paged_attention_flops(B: int, H: int, n_pages: int, block_size: int,
                          D: int, pages_per_split: Optional[int] = None
                          ) -> int:
    """Operations of one paged decode over the whole table, as the plain
    versions' two einsums count them: ``QKᵀ`` at every key slot of
    ``n_pages`` pages, and ``PV`` at as many, rounded up to whole splits
    on the split route."""
    pps = route_pages_per_split(n_pages, block_size, D, pages_per_split)
    pv_pages = n_pages if pps >= n_pages else -(-n_pages // pps) * pps
    return 2 * B * H * block_size * D * (n_pages + pv_pages)


@register_flop_formula(torch.ops.paddle2_tpu_torch.paged_attention)
def _paged_attention_flops(q_shape, k_shape, v_shape, t_shape, c_shape,
                           scale, pages_per_split, *args, **kwargs) -> int:
    B, _, H, D = q_shape
    return paged_attention_flops(B, H, t_shape[1], k_shape[1], D,
                                 pages_per_split)

