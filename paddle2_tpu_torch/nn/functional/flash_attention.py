"""paddle.nn.functional.flash_attention: the counterpart of
``paddle2_tpu/nn/functional/flash_attention.py``, with the same names.
Layout is the reference's ``(batch, seq, heads, head_dim)``; the varlen
functions take packed ``[total_tokens, heads, head_dim]`` rows and
``cu_seqlens`` offsets.

``flash_attn_unpadded`` routes as the JAX package does on an
accelerator: with the flash kernels on (:func:`sdp_kernel`), no dropout
in training and head dim <= 256, the ragged batch stays one packed
sequence and runs the varlen flash kernels
(:mod:`paddle2_tpu_torch.kernels.flash_varlen`), on a tensor of either
device: a CUDA tensor launches the kernels, a CPU tensor runs their
plain versions. A head dim or dtype those kernels do not take
(``flash_varlen.kernel_gap``) densifies on the CPU, the JAX package's
CPU route, and raises on the card, naming the ROADMAP item that ports
it. Everything else densifies into a padded batch with a length mask
and runs the plain attention (:func:`_sdpa_plain`, the counterpart of
``_sdpa_xla``): the port of an XLA path, not a stand-in for a kernel.
The two routes differ on a query row that sees no key (a causal
sequence with ``len_k < len_q``): the packed route gives 0, as the JAX
package's kernel does; the densify route gives what the JAX package's
XLA softmax gives, NaN.

``flashmask_attention`` and ``sparse_attention`` reach no Pallas kernel
in the JAX package; they are its jnp bodies in plain torch.
"""

import math
from typing import Optional

import numpy as np
import torch

from ...kernels import _build
from ...kernels.attention import (_sdpa_plain, flash_enabled,
                                  scaled_dot_product_attention,
                                  set_flash_enabled)
from ...kernels.flash_varlen import (flash_attention_varlen_packed,
                                     kernel_gap, tile_ranges)

__all__ = ["flash_attention", "flash_attn_unpadded", "flash_attn_qkvpacked",
           "flash_attn_varlen_qkvpacked", "scaled_dot_product_attention",
           "sdp_kernel", "flashmask_attention", "sparse_attention"]

# the largest head dim the JAX package sends to its packed kernel
PACKED_MAX_HEAD_DIM = 256
_NEG = float("-inf")


def flash_attention(query, key, value, dropout: float = 0.0,
                    causal: bool = False, return_softmax: bool = False, *,
                    fixed_seed_offset=None, rng_name: str = "",
                    training: bool = True, name=None,
                    generator: Optional[torch.Generator] = None):
    """Returns ``(out, softmax)``: ``out`` from
    :func:`scaled_dot_product_attention`; ``softmax`` is None unless
    ``return_softmax``, then the plain f32 probabilities (not
    differentiable), which the flash kernel never forms. Dropout draws
    from ``generator``; ``fixed_seed_offset`` and ``rng_name`` are
    taken and unused, as in the JAX package."""
    out = scaled_dot_product_attention(query, key, value, dropout_p=dropout,
                                       is_causal=causal, training=training,
                                       generator=generator)
    softmax = None
    if return_softmax:
        with torch.no_grad():
            qh = query.transpose(1, 2).float()
            kh = key.transpose(1, 2).float()
            s = torch.matmul(qh, kh.transpose(-1, -2)) \
                / math.sqrt(query.shape[-1])
            if causal:
                t_q, t_k = s.shape[-2], s.shape[-1]
                keep = torch.ones(t_q, t_k, dtype=torch.bool,
                                  device=s.device).tril(diagonal=t_k - t_q)
                s = s.masked_fill(~keep, _NEG)
            softmax = torch.softmax(s, dim=-1)
    return out, softmax


def flash_attn_qkvpacked(qkv, dropout: float = 0.0, causal: bool = False,
                         return_softmax: bool = False, **kwargs):
    """Packed ``[b, s, 3, h, d]`` variant of :func:`flash_attention`."""
    return flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                           dropout=dropout, causal=causal,
                           return_softmax=return_softmax, **kwargs)


def _host_offsets(cu, T: int, what: str) -> np.ndarray:
    """``cu_seqlens`` on the host as int64 (one copy from the card for a
    CUDA tensor), checked: starts at 0, never falls, ends at ``T``."""
    if isinstance(cu, torch.Tensor):
        cu = cu.detach().cpu().numpy()
    cu = np.asarray(cu).astype(np.int64).reshape(-1)
    if cu.size < 2 or cu[0] != 0 or (np.diff(cu) < 0).any() \
            or cu[-1] != T:
        raise ValueError(f"{what} must rise from 0 to the {T} packed rows, "
                         f"got {cu.tolist()}")
    return cu


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q: int, max_seqlen_k: int, scale: float,
                        dropout: float = 0.0, causal: bool = False,
                        return_softmax: bool = False, *,
                        fixed_seed_offset=None, rng_name: str = "",
                        training: bool = True, name=None,
                        generator: Optional[torch.Generator] = None):
    """Varlen attention over packed sequences: query ``[Tq, H, D]``,
    key/value ``[Tk, H, D]``, ``cu_seqlens_*`` ``[batch + 1]`` cumulative
    offsets (a tensor of either device, an array or a list). The causal
    mask is aligned to the bottom right of each sequence. Returns
    ``(out [Tq, H, D], None)``; routes as the module says. Dropout (in
    training) draws its keep mask from ``generator``."""
    if return_softmax:
        raise NotImplementedError(
            "flash_attn_unpadded(return_softmax=True): the varlen path "
            "never materializes probabilities; use flash_attention")
    cu_q = _host_offsets(cu_seqlens_q, query.shape[0], "cu_seqlens_q")
    cu_k = _host_offsets(cu_seqlens_k, key.shape[0], "cu_seqlens_k")
    if cu_q.size != cu_k.size:
        raise ValueError(f"cu_seqlens_q has {cu_q.size - 1} sequences, "
                         f"cu_seqlens_k {cu_k.size - 1}")
    len_q, len_k = np.diff(cu_q), np.diff(cu_k)
    drop = dropout if training else 0.0
    if flash_enabled() and drop == 0.0 \
            and query.shape[-1] <= PACKED_MAX_HEAD_DIM:
        gap = kernel_gap(query, key, value)
        if gap is None:
            return _unpadded_packed(query, key, value, cu_q, cu_k, len_q,
                                    len_k, scale, causal), None
        if _build.on_cuda(query):
            raise NotImplementedError(f"flash_attn_unpadded: {gap}")
    if len_q.max() > max_seqlen_q or len_k.max() > max_seqlen_k:
        raise ValueError(f"a sequence is longer than max_seqlen "
                         f"({len_q.max()} > {max_seqlen_q} or {len_k.max()} "
                         f"> {max_seqlen_k})")
    return _unpadded_densify(query, key, value, cu_q, cu_k, len_q, len_k,
                             int(max_seqlen_q), int(max_seqlen_k), scale,
                             causal, drop, generator), None


def _densify_rows(cu, lens, S, T):
    """[B, S] gather map into the packed rows; positions past a
    sequence's length point at row ``T``, a zero row appended below."""
    pos = np.arange(S)[None, :]
    return np.where(pos < lens[:, None], cu[:-1, None] + pos, T)


def _unpadded_densify(q, k, v, cu_q, cu_k, len_q, len_k, Sq, Sk, scale,
                      causal, dropout_p, generator):
    """The JAX package's densify route (``flash_attention.py:117-163``):
    one gather per tensor into ``[B, S, H, D]``, a ``[B, 1, Sq, Sk]``
    bias of 0 and -inf (the key must be real and, under causal, at or
    left of the row's bottom-right diagonal), the plain attention, and
    one gather back to the packed query rows."""
    dev = q.device

    def pad_one(a, cu, lens, S):
        idx = torch.as_tensor(_densify_rows(cu, lens, S, a.shape[0]),
                              device=dev)
        return torch.cat([a, a.new_zeros((1,) + a.shape[1:])])[idx]
    qp = pad_one(q, cu_q, len_q, Sq)
    kp, vp = pad_one(k, cu_k, len_k, Sk), pad_one(v, cu_k, len_k, Sk)
    lk = torch.as_tensor(len_k, device=dev)[:, None, None]
    lq = torch.as_tensor(len_q, device=dev)[:, None, None]
    qpos = torch.arange(Sq, device=dev)[None, :, None]
    kpos = torch.arange(Sk, device=dev)[None, None, :]
    allowed = kpos < lk
    if causal:
        allowed = allowed & (kpos <= qpos + (lk - lq))
    bias = torch.zeros(allowed.shape, dtype=q.dtype, device=dev)
    bias = bias.masked_fill(~allowed, _NEG)[:, None]
    out = _sdpa_plain(qp, kp, vp, bias=bias, causal=False, scale=scale,
                      dropout_p=dropout_p, generator=generator)
    seq = np.repeat(np.arange(len(len_q)), len_q)
    pos = np.arange(int(cu_q[-1])) - np.repeat(cu_q[:-1], len_q)
    return out[torch.as_tensor(seq, device=dev),
               torch.as_tensor(pos, device=dev)]


_SEG_CACHE: dict = {}


def _seg_off_device(cu_q, cu_k, len_q, len_k, causal, device):
    """Per-row (segment, offset) metadata and the kernels' tile ranges
    on ``device``, memoized on the ``cu_seqlens`` bytes (at most 513
    entries): a loop over repeated batch shapes builds and uploads them
    once per shape, not once per call. Offsets take the bottom-right
    causal shift ``len_k - len_q`` of their sequence, or ``2**30`` (no
    causal limit) when not causal."""
    key = (cu_q.tobytes(), cu_k.tobytes(), bool(causal), str(device))
    hit = _SEG_CACHE.get(key)
    if hit is not None:
        return hit

    def seg_off(cu, lens):
        seg = np.repeat(np.arange(len(lens)), lens)
        return seg, np.arange(int(cu[-1])) - np.repeat(cu[:-1], lens)
    seg_q, off_q = seg_off(cu_q, len_q)
    seg_k, off_k = seg_off(cu_k, len_k)
    if causal:
        off_q = off_q + np.repeat(len_k - len_q, len_q)
    else:
        off_q = np.full_like(off_q, 2 ** 30)
    meta = [torch.as_tensor(a.astype(np.int32), device=device)
            for a in (seg_q, off_q, seg_k, off_k)]
    out = (*meta, tile_ranges(*meta))
    if len(_SEG_CACHE) > 512:
        _SEG_CACHE.clear()
    _SEG_CACHE[key] = out
    return out


def _unpadded_packed(q, k, v, cu_q, cu_k, len_q, len_k, scale, causal):
    """The packed route: the memoized metadata, then the varlen flash
    op on the packed rows (no densify, no padding of ``T``)."""
    seg_q, off_q, seg_k, off_k, tiles = _seg_off_device(
        cu_q, cu_k, len_q, len_k, causal, q.device)
    return flash_attention_varlen_packed(q, k, v, seg_q, off_q, seg_k,
                                         off_k, scale=scale, tiles=tiles)


class sdp_kernel:
    """Kernel-selection context: ``enable_flash=False`` turns the flash
    kernels off inside the block, in this thread (attention then takes
    the plain routes). The plain route is the guaranteed fallback, so
    ``enable_math=False`` raises instead of silently not applying."""

    def __init__(self, enable_math: bool = True, enable_flash: bool = True,
                 enable_mem_efficient: bool = True):
        if not enable_math:
            raise ValueError(
                "sdp_kernel(enable_math=False): the plain math path is the "
                "guaranteed fallback and cannot be disabled")
        self.enable_flash = enable_flash
        self._prev = None

    def __enter__(self):
        self._prev = flash_enabled()
        set_flash_enabled(bool(self.enable_flash))
        return self

    def __exit__(self, *exc):
        set_flash_enabled(self._prev)
        return False


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q, max_seqlen_k, scale,
                                dropout: float = 0.0, causal: bool = False,
                                return_softmax: bool = False, **kwargs):
    """Varlen packed-QKV variant: qkv ``[total_tokens, 3, h, d]``."""
    return flash_attn_unpadded(qkv[:, 0], qkv[:, 1], qkv[:, 2],
                               cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                               max_seqlen_k, scale, dropout=dropout,
                               causal=causal, return_softmax=return_softmax,
                               **kwargs)


def _masked_softmax_out(scores, allowed, v, out_dtype, eq):
    """Softmax of ``scores`` where ``allowed`` (a row with nothing
    allowed gives 0, not NaN) times ``v``; returns (out, lse)."""
    scores = scores.masked_fill(~allowed, _NEG)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.exp(scores - lse[..., None])
    probs = torch.where(torch.isfinite(lse)[..., None], probs,
                        torch.zeros_like(probs))
    return torch.einsum(eq, probs, v.float()).to(out_dtype), lse


def flashmask_attention(query, key, value, startend_row_indices=None,
                        dropout: float = 0.0, causal: bool = False,
                        window_size=None, return_softmax_lse: bool = False,
                        return_seed_offset: bool = False,
                        fixed_seed_offset=None, rng_name: str = "",
                        training: bool = True, name=None):
    """FlashMask attention: the mask is a column-wise sparse description,
    per key position, of the score rows to mask
    (``startend_row_indices`` ``[B, Hk, Sk, n]``):

      causal, n 1:  mask rows i >= s0[j]            (+ causal)
      causal, n 2:  mask s0[j] <= i < s1[j]         (+ causal)
      bidir,  n 2:  mask i >= s0[j]  or  i < s1[j]
      bidir,  n 4:  mask s0<=i<s1    or  s2<=i<s3

    A fully masked row gives 0. ``dropout`` is taken and unused, as in
    the JAX package."""
    B, Sq, H, D = query.shape
    Sk = key.shape[1]
    dev = query.device
    scale = 1.0 / np.sqrt(D)
    scores = torch.einsum("bqhd,bkhd->bhqk", query.float(),
                          key.float()) * scale
    rows = torch.arange(Sq, device=dev)[:, None]
    cols = torch.arange(Sk, device=dev)[None, :]
    masked = torch.zeros((1, 1, Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        masked = masked | (rows < cols)[None, None]
    if window_size is not None:
        w = ((window_size, window_size) if isinstance(window_size, int)
             else tuple(window_size))
        masked = masked | (rows - cols > w[0])[None, None]
        if not causal:
            masked = masked | (cols - rows > w[1])[None, None]
    if startend_row_indices is not None:
        idx = startend_row_indices.to(torch.int32)
        if idx.shape[1] == 1:
            idx = idx.expand((B, H) + tuple(idx.shape[2:]))
        n = idx.shape[-1]
        i = rows[None, None]                       # [1, 1, Sq, 1]
        s = idx.transpose(2, 3)[:, :, :, None, :]  # [B, H, n, 1, Sk]
        if causal and n == 1:
            band = i >= s[:, :, 0]
        elif causal and n == 2:
            band = (i >= s[:, :, 0]) & (i < s[:, :, 1])
        elif not causal and n == 2:
            band = (i >= s[:, :, 0]) | (i < s[:, :, 1])
        elif not causal and n == 4:
            band = (((i >= s[:, :, 0]) & (i < s[:, :, 1]))
                    | ((i >= s[:, :, 2]) & (i < s[:, :, 3])))
        else:
            raise ValueError(f"startend_row_indices last dim {n} invalid "
                             f"for causal={causal}")
        masked = masked | band
    out, lse = _masked_softmax_out(scores, ~masked, value, query.dtype,
                                   "bhqk,bkhd->bqhd")
    res = (out, lse) if return_softmax_lse else out
    if return_seed_offset:
        extra = torch.zeros((2,), dtype=torch.int32, device=dev)
        return (res + (extra,)) if isinstance(res, tuple) else (res, extra)
    return res


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Block-sparse attention with a CSR pattern: q/k/v ``[B, H, S, D]``;
    query row ``r`` attends only the keys
    ``columns[offset[r]:offset[r+1]]`` (offset ``[B, H, S+1]``, columns
    ``[B, H, nnz]``, entries past ``offset[-1]`` ignored). A key with
    ``key_padding_mask <= -1`` is dropped; ``attn_mask`` is added to the
    scores. A row with no key gives 0."""
    B, H, S, D = query.shape
    dev = query.device
    offset = sparse_csr_offset.to(torch.int64)
    columns = sparse_csr_columns.to(torch.int64)
    nnz = columns.shape[-1]
    e = torch.arange(nnz, device=dev).expand(B, H, nnz).contiguous()
    rows = (torch.searchsorted(offset.contiguous(), e, right=True)
            - 1).clamp(0, S - 1)
    valid = e < offset[..., -1:]
    flat = rows * S + columns.clamp(0, S - 1)
    hits = torch.zeros((B, H, S * S), dtype=torch.int32, device=dev)
    hits.scatter_add_(-1, flat, valid.to(torch.int32))
    allow = (hits > 0).view(B, H, S, S)
    scores = torch.matmul(query.float(), key.float().transpose(-1, -2)) \
        * (1.0 / np.sqrt(D))
    if key_padding_mask is not None:
        allow = allow & (key_padding_mask[:, None, None, :] > -1.0)
    if attn_mask is not None:
        scores = scores + attn_mask.float()
    out, _ = _masked_softmax_out(scores, allow, value, query.dtype,
                                 "bhqk,bhkd->bhqd")
    return out
