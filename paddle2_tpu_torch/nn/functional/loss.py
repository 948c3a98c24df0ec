"""``cross_entropy``: the hard-label, mean-reduction case of
``paddle2_tpu/nn/functional/loss.py:33-83``.

``log_softmax`` over the last axis, the label's entry picked, entries
whose label is ``ignore_index`` left out, and the sum divided by the
count of the rest. Labels may be any integer type (the bench's are
int32; torch's gather takes int64, so the cast is made here) and of
shape ``[N]`` or ``[N, 1]``. Soft labels, class weights, label
smoothing, other reductions, another axis and ``use_softmax=False`` are
ROADMAP queue 1 item 2.
"""

import torch
from ...amp.casting import amp_op

__all__ = ["cross_entropy"]


@amp_op("cross_entropy")
def cross_entropy(input, label, weight=None, ignore_index: int = -100,
                  reduction: str = "mean", soft_label: bool = False,
                  axis: int = -1, use_softmax: bool = True,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean cross-entropy of ``input`` logits ``[N, C]`` against integer
    class ``label``s."""
    unported = dict(weight=weight is not None, reduction=reduction != "mean",
                    soft_label=soft_label or label.is_floating_point(),
                    axis=axis not in (-1, input.ndim - 1),
                    use_softmax=not use_softmax,
                    label_smoothing=label_smoothing != 0.0)
    if any(unported.values()):
        raise NotImplementedError(
            f"cross_entropy with {[k for k, v in unported.items() if v]} is "
            f"not ported yet: only hard labels, mean reduction and the "
            f"last axis are (ROADMAP queue 1 item 2)")
    logp = torch.log_softmax(input, dim=-1)
    lbl = label.long()
    if lbl.ndim == input.ndim:
        lbl = lbl.squeeze(-1)
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0)
    picked = -logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    denom = valid.to(picked.dtype).sum()
    picked = torch.where(valid, picked, 0.0)
    return picked.sum() / denom.clamp_min(1e-12)
