"""Fused functional ops: the counterpart of
``paddle2_tpu/incubate/nn/functional.py``. Only the chunked LM-head
cross-entropy is ported so far (the rest is ROADMAP queue 1 item 9)."""

from ...kernels.fused_ce import fused_linear_cross_entropy as _fused_ce

__all__ = ["fused_linear_cross_entropy"]


def fused_linear_cross_entropy(x, weight, label, ignore_index: int = -100,
                               reduction: str = "mean"):
    """Cross-entropy of ``softmax(x @ weight)`` without holding the
    ``[N, vocab]`` logits (:mod:`paddle2_tpu_torch.kernels.fused_ce`).

    x: ``[N, hidden]`` or ``[B, S, hidden]``; weight: ``[hidden,
    vocab]``; label: int ``[N]`` or ``[B, S]``. reduction: "mean" over
    the tokens not ignored, "sum" or "none"."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    losses, valid = _fused_ce(x.reshape(-1, x.shape[-1]), weight,
                              label.reshape(-1), int(ignore_index))
    if reduction == "mean":
        return losses.sum() / valid.float().sum().clamp_min(1.0)
    if reduction == "sum":
        return losses.sum()
    return losses.reshape(label.shape)
