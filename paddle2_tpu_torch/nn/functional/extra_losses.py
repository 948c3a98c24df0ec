"""More loss and distance functionals: the counterpart of
``paddle2_tpu/nn/functional/extra_losses.py``, each the JAX function
in torch (its ``lax.scan`` loops as Python loops), under the JAX op's
name for the AMP cast."""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as TF

from ...amp.casting import amp_op

__all__ = ["pairwise_distance", "soft_margin_loss",
           "multi_label_soft_margin_loss", "multi_margin_loss",
           "gaussian_nll_loss", "triplet_margin_with_distance_loss",
           "dice_loss", "npair_loss", "gather_tree", "temporal_shift",
           "hsigmoid_loss", "adaptive_log_softmax_with_loss", "rnnt_loss"]


def _reduce(val, reduction):
    if reduction == "mean":
        return val.mean()
    if reduction == "sum":
        return val.sum()
    return val


@amp_op("pairwise_distance")
def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    return torch.linalg.vector_norm(x - y + epsilon, ord=p, dim=-1,
                                    keepdim=keepdim)


@amp_op("soft_margin_loss")
def soft_margin_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.log1p(torch.exp(-label * input)), reduction)


@amp_op("multi_label_soft_margin_loss")
def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    loss = -(label * TF.logsigmoid(input)
             + (1 - label) * TF.logsigmoid(-input))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss.mean(-1), reduction)


@amp_op("multi_margin_loss")
def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    c = input.shape[1]
    y = label.long()
    correct = input.gather(1, y[:, None])
    m = torch.clamp(margin - correct + input, min=0.0) ** p
    if weight is not None:
        m = m * weight[y][:, None]
    mask = TF.one_hot(y, c) == 0
    return _reduce((m * mask).sum(1) / c, reduction)


@amp_op("gaussian_nll_loss")
def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    var = torch.clamp(variance, min=epsilon)
    loss = 0.5 * (torch.log(var) + torch.square(label - input) / var)
    if full:
        loss = loss + 0.5 * np.log(2 * np.pi)
    return _reduce(loss, reduction)


@amp_op("min")
def _minimum(u, v):
    return torch.minimum(u, v)


@amp_op("triplet_margin_with_distance_loss")
def _triplet_hinge(dp, dn, margin, reduction):
    return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    dist = distance_function or (lambda u, v: pairwise_distance(u, v))
    dp = dist(input, positive)
    dn = dist(input, negative)
    if swap:
        dn = _minimum(dn, dist(positive, negative))
    return _triplet_hinge(dp, dn, margin, reduction)


@amp_op("dice_loss")
def dice_loss(input, label, epsilon=1e-5, name=None):
    """``input`` ``[N, ..., C]`` probabilities, ``label`` ``[N, ..., 1]``."""
    c = input.shape[-1]
    oh = TF.one_hot(label[..., 0].long(), c).to(input.dtype)
    axes = tuple(range(1, input.ndim))
    inter = (input * oh).sum(axes)
    union = (input + oh).sum(axes)
    return (1 - (2 * inter + epsilon) / (union + epsilon)).mean()


@amp_op("npair_loss")
def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    sim = anchor @ positive.T
    same = (labels[:, None] == labels[None, :]).to(anchor.dtype)
    tgt = same / torch.clamp(same.sum(1, keepdim=True), min=1.0)
    xent = -(tgt * torch.log_softmax(sim, dim=1)).sum(1).mean()
    reg = l2_reg * ((anchor * anchor).sum(1).mean()
                    + (positive * positive).sum(1).mean()) * 0.25
    return xent + reg


def gather_tree(ids, parents):
    """Beam-search backtrace over ``[T, B, beam]`` ids and parents."""
    T = ids.shape[0]
    beams = torch.arange(ids.shape[2], device=ids.device)[None, :].expand(
        ids.shape[1:]).long()
    toks = [None] * T
    for t in range(T - 1, -1, -1):
        toks[t] = ids[t].gather(1, beams)
        beams = parents[t].long().gather(1, beams)
    return torch.stack(toks)


@amp_op("temporal_shift")
def temporal_shift(x, seg_num, shift_ratio=0.25, name=None,
                   data_format="NCHW"):
    """TSM: a quarter of the channels shifted back in time, a quarter
    forward, zero-filled."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"unknown data_format {data_format!r}")
    a = x.permute(0, 3, 1, 2) if data_format == "NHWC" else x
    nt, c, h, w = a.shape
    v = a.reshape(nt // seg_num, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    back = torch.cat([v[:, 1:, :fold], torch.zeros_like(v[:, :1, :fold])],
                     dim=1)
    fwd = torch.cat([torch.zeros_like(v[:, :1, fold:2 * fold]),
                     v[:, :-1, fold:2 * fold]], dim=1)
    out = torch.cat([back, fwd, v[:, :, 2 * fold:]], dim=2).reshape(
        nt, c, h, w)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


@amp_op("hsigmoid_loss")
def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid loss. Complete-tree mode: class ``c`` is the
    code ``c + num_classes``; level ``j`` of its path is the internal
    node ``(code >> (j+1)) - 1`` with target bit ``(code >> j) & 1``.
    Per sample, the sum over the path of BCE-with-logits of ``w_row . x
    + b_row`` (logits clipped to [-40, 40]). A custom tree comes as
    ``path_table``/``path_code`` (-1-padded)."""
    if path_table is not None:
        ptab = path_table.long()
        valid = ptab >= 0
        rows = torch.clamp(ptab, min=0)
        bits = path_code.to(torch.float32)
    else:
        code = label.long().reshape(-1) + num_classes
        L = int(np.ceil(np.log2(2 * num_classes)))
        j = torch.arange(L, device=input.device)
        shifted = code[:, None] >> (j[None, :] + 1)
        valid = shifted > 0
        rows = torch.clamp(shifted - 1, min=0)
        bits = ((code[:, None] >> j[None, :]) & 1).to(torch.float32)
    z = torch.einsum("nlf,nf->nl", weight[rows], input)
    if bias is not None:
        z = z + bias.reshape(-1)[rows]
    z = torch.clamp(z, -40.0, 40.0)
    per = torch.logaddexp(torch.zeros((), dtype=z.dtype, device=z.device),
                          z) - bits * z
    return torch.where(valid, per, 0.0).sum(1, keepdim=True)


@amp_op("adaptive_log_softmax")
def adaptive_log_softmax_with_loss(input, label, head_weight, tail_weights,
                                   cutoffs, head_bias=None, name=None):
    """Adaptive softmax: the head scores the shortlist and one logit per
    cluster; a rare class scores through its cluster's logit and a
    low-rank tail. Returns (each sample's target log-probability, the
    loss = -mean)."""
    cutoffs = [int(c) for c in cutoffs]
    shortlist = cutoffs[0] if cutoffs else 0
    lab = label.long().reshape(-1)
    head = input @ head_weight
    if head_bias is not None:
        head = head + head_bias
    head_lp = torch.log_softmax(head, dim=-1)
    out = head_lp.gather(1, torch.clamp(lab, 0, shortlist - 1)[:, None])[:, 0]
    for k, (proj, ow) in enumerate(tail_weights):
        lo = cutoffs[k]
        hi = cutoffs[k + 1] if k + 1 < len(cutoffs) else None
        tail_lp = torch.log_softmax((input @ proj) @ ow, dim=-1)
        in_k = (lab >= lo) & ((lab < hi) if hi is not None
                              else torch.ones_like(lab, dtype=torch.bool))
        local = torch.clamp(lab - lo, 0, ow.shape[1] - 1)
        cand = head_lp[:, shortlist + k] + tail_lp.gather(
            1, local[:, None])[:, 0]
        out = torch.where(in_k, cand, out)
    return out, -out.mean()


@amp_op("rnnt_loss")
def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.001, reduction="mean", name=None):
    """RNN-T loss by the forward variables in log space:
    ``alpha[t, u] = logaddexp(alpha[t-1, u] + blank(t-1, u),
    alpha[t, u-1] + emit(t, u-1))``; the NLL is ``-(alpha[T-1, U] +
    blank(T-1, U))``. FastEmit scales the emission terms' gradient by
    ``1 + lambda`` and leaves the value."""
    lp = torch.log_softmax(input.float(), dim=-1)
    B, T, U1, _ = lp.shape
    U = U1 - 1
    blank_lp = lp[..., blank]                           # [B, T, U+1]
    emit_lp = lp[:, :, :U, :].gather(
        3, label.long()[:, None, :, None].expand(B, T, U, 1))[..., 0]
    if fastemit_lambda:
        lam = float(fastemit_lambda)
        emit_lp = emit_lp * (1.0 + lam) - (emit_lp * lam).detach()
    neg = torch.full((B,), -1e30, dtype=torch.float32, device=lp.device)
    alphas = []
    prev = None
    for t in range(T):
        cols = []
        carry = neg
        for u in range(U1):
            if t > 0:
                from_blank = prev[u] + blank_lp[:, t - 1, u]
            else:
                from_blank = torch.zeros_like(neg) if u == 0 else neg
            if u > 0:
                val = torch.logaddexp(from_blank,
                                      carry + emit_lp[:, t, u - 1])
            else:
                val = from_blank
            cols.append(val)
            carry = val
        prev = cols
        alphas.append(torch.stack(cols, dim=1))
    alphas = torch.stack(alphas, dim=1)                 # [B, T, U+1]
    b = torch.arange(B, device=lp.device)
    t_last = torch.clamp(input_lengths.long() - 1, min=0)
    u_last = torch.clamp(label_lengths.long(), min=0)
    nll = -(alphas[b, t_last, u_last] + blank_lp[b, t_last, u_last])
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    return nll
