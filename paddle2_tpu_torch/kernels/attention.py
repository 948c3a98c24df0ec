"""Scaled dot-product attention for the port's models, and the remat
policy that goes with it.

Counterpart of ``paddle2_tpu/kernels/attention.py``. The JAX package
sent long sequences on an accelerator to its Pallas flash kernel
(S >= 1024, a TPU VMEM threshold), unless the kernel's
``supported()`` refused the shape, and everything else, on the CPU
everything, to an XLA softmax (``_sdpa_xla``). The port routes a call
without a mask and without dropout by the same shape rule
(:func:`pallas_supported`) and then by the device:

- a shape that ``supported()`` refuses (head dim over 256, a length
  with no 8-row tiling, unequal head counts) takes :func:`_sdpa_plain`
  on both devices, as the JAX package takes XLA;
- a shape the CUDA kernels take (head dim 16, 64 or 128, float32 or
  bfloat16, ``Sq <= Sk``) goes through
  :func:`~.flash_attn.flash_attention_bshd`, differentiable, which
  launches the kernels for a CUDA tensor at every length and runs their
  plain versions for a CPU tensor;
- any other shape takes :func:`_sdpa_plain` on the CPU, as the JAX
  package does there, and raises on the card, naming the ROADMAP item
  that ports it: the card never quietly computes in plain torch what
  the JAX package sends to a kernel.

A call with ``attn_mask`` (an additive bias broadcast to ``[B, H, Sq,
Sk]``), with dropout in training, or with the flash kernels turned off
(:func:`flash_enabled`) takes :func:`_sdpa_plain`, the
counterpart of ``_sdpa_xla`` in plain torch. The JAX package never
sends such a call to Pallas (``attention.py:140``), so plain torch here
is the port of an XLA path, not a stand-in for a kernel. Its dropout
draws its keep mask from a ``torch.Generator`` (the default one when
none is given): it cannot give the bits of JAX's keys, so tests hold it
by its statistics.
"""

import functools
import math
import threading
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from . import _build
from . import flash_varlen  # noqa: F401  (registers flash_attn_varlen)
from .flash_attn import SUPPORTED_HEAD_DIMS, flash_attention_bshd

__all__ = ["scaled_dot_product_attention", "remat_policy", "flash_enabled",
           "set_flash_enabled", "pallas_supported"]

# the JAX package's Pallas flash tiling (pallas_flash.py:38-39, :53-62,
# :485-497): its default blocks and its largest head dim
_PALLAS_BLOCK = 1024
_PALLAS_MAX_HEAD_DIM = 256

_aten = torch.ops.aten
_flash_tls = threading.local()  # sdp_kernel toggles it per thread


def flash_enabled() -> bool:
    """Whether the flash kernels serve attention in this thread (on by
    default; ``nn.functional.sdp_kernel(enable_flash=False)`` turns it
    off inside its block, as in the JAX package)."""
    return getattr(_flash_tls, "enabled", True)


def set_flash_enabled(flag: bool) -> None:
    _flash_tls.enabled = bool(flag)


def _dots_policy(ctx, op, *args, **kwargs):
    """"dots": keep the outputs of matrix products without batch
    dimensions (``mm``/``addmm``, as JAX's
    ``dots_with_no_batch_dims_saveable``) and of the flash ops, dense and
    varlen (their ``(o, lse)``, as the JAX package's
    ``flash_out``/``flash_lse`` names); recompute everything else, the
    fused LayerNorm op among it, as the JAX package's remat re-runs its
    Pallas LayerNorm."""
    if op in (_aten.mm.default, _aten.addmm.default,
              torch.ops.paddle2_tpu_torch.flash_attn.default,
              torch.ops.paddle2_tpu_torch.flash_attn_varlen.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_policy(base: str = "dots") -> Optional[Callable]:
    """The ``context_fn`` that ``torch.utils.checkpoint.checkpoint``
    takes for a granularity: "dots" is the selective policy above;
    "full" and "nothing" mean full recompute (None: checkpoint saves
    the block's inputs only). The JAX package's other policies
    ("dots_plus", "dots_plus_ln", "offload", "search") are not ported
    yet (ROADMAP queue 1 item 2)."""
    if base in ("full", "nothing"):
        return None
    if base == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _dots_policy)
    raise NotImplementedError(
        f"remat granularity {base!r} is not ported yet (ROADMAP queue 1 "
        f"item 2); use 'dots' or 'full'")


def _sdpa_plain(q, k, v, bias=None, causal: bool = False,
                scale: Optional[float] = None, dropout_p: float = 0.0,
                generator: Optional[torch.Generator] = None):
    """``_sdpa_xla`` on ``(B, S, H, D)``: the scores in the input dtype,
    ``+ bias``, the bottom-right causal mask by the dtype's finite
    minimum, softmax in f32 cast back to the input dtype, a Bernoulli
    keep mask scaling kept probabilities by ``1/(1-p)``, then the
    product with V."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias
    if causal:
        s, t = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(s, t, dtype=torch.bool,
                          device=q.device).tril(diagonal=t - s)
        logits = logits.masked_fill(~keep, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    if dropout_p > 0.0:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) < 1.0 - dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            0.0).to(q.dtype)
    return torch.matmul(probs, vh).transpose(1, 2)


def _fit_block(s: int, want: int) -> Optional[int]:
    """The Pallas kernel's block for a length ``s``: the largest power of
    two <= ``want`` that divides ``s``, or None when no 8-row tiling
    exists (``pallas_flash._fit_block``)."""
    if s < 8:
        return None
    b = 1 << (min(want, s).bit_length() - 1)
    while b >= 8:
        if s % b == 0:
            return b
        b //= 2
    return None


def pallas_supported(q_shape, k_shape) -> bool:
    """Whether the JAX package's Pallas flash kernel takes ``(B, Sq, H,
    D)`` queries against ``(B, Sk, Hk, D)`` keys at its default blocks
    (``pallas_flash.supported``): both lengths tile in 8-row blocks, the
    head dim is at most 256 and the head counts agree. Where it does
    not, the JAX package computes in XLA on every device."""
    _, Sq, H, D = q_shape
    return (_fit_block(Sq, _PALLAS_BLOCK) is not None
            and _fit_block(k_shape[1], _PALLAS_BLOCK) is not None
            and D <= _PALLAS_MAX_HEAD_DIM and k_shape[2] == H)


def _kernel_gap(q, k, v) -> Optional[str]:
    """Why the CUDA flash kernels do not take these ``(B, S, H, D)``
    inputs, naming the ROADMAP item that ports them; None when they
    do."""
    dtypes = {q.dtype, k.dtype, v.dtype}
    if not dtypes <= {torch.float32, torch.bfloat16}:
        return (f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the flash kernels "
                f"take float32 or bfloat16 (float16 is ROADMAP.md queue 2 "
                f"A2)")
    if q.shape[-1] not in SUPPORTED_HEAD_DIMS:
        return (f"head_dim {q.shape[-1]}: the flash kernels take "
                f"{SUPPORTED_HEAD_DIMS} (the other head dims up to 256 are "
                f"ROADMAP.md queue 2 A1)")
    if q.shape[1] > k.shape[1]:
        return (f"Sq {q.shape[1]} > Sk {k.shape[1]}: the flash kernels take "
                f"Sq <= Sk (ROADMAP.md queue 2 A1)")
    return None


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 scale: Optional[float] = None,
                                 training: bool = True,
                                 generator: Optional[torch.Generator] = None):
    """Attention on ``(batch, seq, num_heads, head_dim)`` tensors. The
    causal mask is aligned to the bottom right, as in the JAX package:
    with ``Sq < Sk`` row ``r`` sees keys ``c <= r + Sk - Sq``.
    ``attn_mask`` is an additive bias broadcast to ``[B, H, Sq, Sk]``;
    dropout applies only when ``training``, drawing from ``generator``.
    With :func:`flash_enabled` off, every call takes the plain route, as
    the JAX package's ``use_pallas`` sends it to XLA; otherwise a call
    routes as the module says."""
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must lie in [0, 1), got {dropout_p}")
    drop = dropout_p if training else 0.0
    if attn_mask is None and drop == 0.0 and flash_enabled() \
            and pallas_supported(query.shape, key.shape):
        gap = _kernel_gap(query, key, value)
        if gap is None:
            return flash_attention_bshd(query, key, value, causal=is_causal,
                                        scale=scale)
        if _build.on_cuda(query):
            raise NotImplementedError(f"scaled_dot_product_attention: {gap}")
    if attn_mask is not None:
        B, Sq, H, _ = query.shape
        want = (B, H, Sq, key.shape[1])
        try:
            fits = torch.broadcast_shapes(attn_mask.shape, want) == want
        except RuntimeError:
            fits = False
        if not fits:
            raise ValueError(f"attn_mask {tuple(attn_mask.shape)} does not "
                             f"broadcast to {want}")
    return _sdpa_plain(query, key, value, attn_mask, is_causal, scale, drop,
                       generator)
