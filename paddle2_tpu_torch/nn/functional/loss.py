"""Loss functionals: the counterpart of
``paddle2_tpu/nn/functional/loss.py``.

Each is the JAX function in torch, under the JAX op's name for the AMP
cast (the JAX package computes them in XLA). ``cross_entropy`` takes
every option of the JAX function: hard labels (any integer type, shape
``[..]`` or ``[.., 1]``, ``ignore_index`` left out) or soft ones
(``soft_label``, or float labels of the logits' shape), class
``weight``s (the mean then divides by the weights of the kept labels),
``label_smoothing``, ``reduction`` ``mean``/``sum``/``none``, any
``axis``, and ``use_softmax=False`` (the input is then probabilities,
clipped at 1e-12 before the log).
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as TF

from ...amp.casting import amp_op

__all__ = ["margin_cross_entropy", "cross_entropy",
           "softmax_with_cross_entropy", "nll_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "mse_loss", "l1_loss",
           "smooth_l1_loss", "kl_div", "margin_ranking_loss",
           "hinge_embedding_loss", "cosine_embedding_loss", "ctc_loss",
           "sigmoid_focal_loss", "square_error_cost", "log_loss",
           "triplet_margin_loss", "poisson_nll_loss", "huber_loss"]


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


@amp_op("cross_entropy")
def cross_entropy(input, label, weight=None, ignore_index: int = -100,
                  reduction: str = "mean", soft_label: bool = False,
                  axis: int = -1, use_softmax: bool = True,
                  label_smoothing: float = 0.0, name=None) -> torch.Tensor:
    logp = (torch.log_softmax(input, dim=axis) if use_softmax
            else torch.log(torch.clamp(input, min=1e-12)))
    n_classes = input.shape[axis]
    if soft_label or (label.ndim == input.ndim
                      and label.shape[axis] == n_classes
                      and (label.is_floating_point() or label.is_complex())):
        soft = label
        if label_smoothing > 0:
            soft = soft * (1 - label_smoothing) + label_smoothing / n_classes
        return _reduce(-(soft * logp).sum(dim=axis), reduction)
    lbl = label
    if lbl.ndim == input.ndim:
        lbl = lbl.squeeze(axis)
    lbl = lbl.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0)
    picked = -logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    if label_smoothing > 0:
        uniform = -logp.mean(dim=axis)
        picked = (1 - label_smoothing) * picked + label_smoothing * uniform
    if weight is not None:
        wv = weight[safe]
        picked = picked * wv
        denom = torch.where(valid, wv, 0.0).sum()
    else:
        denom = valid.to(picked.dtype).sum()
    picked = torch.where(valid, picked, 0.0)
    if reduction == "mean":
        return picked.sum() / torch.clamp(denom, min=1e-12)
    if reduction == "sum":
        return picked.sum()
    return picked


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        from .activation import softmax
        return loss, softmax(logits, axis=axis)
    return loss


def _picked_nll(logp, lbl, weight, ignore_index, reduction):
    lbl = lbl.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0)
    picked = -logp.gather(1, safe[:, None])[:, 0]
    if weight is not None:
        wv = weight[safe]
        picked = picked * wv
        denom = torch.where(valid, wv, 0.0).sum()
    else:
        denom = valid.to(picked.dtype).sum()
    picked = torch.where(valid, picked, 0.0)
    if reduction == "mean":
        return picked.sum() / torch.clamp(denom, min=1e-12)
    if reduction == "sum":
        return picked.sum()
    return picked


@amp_op("nll_loss")
def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None) -> torch.Tensor:
    return _picked_nll(input, label, weight, ignore_index, reduction)


@amp_op("bce")
def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None) -> torch.Tensor:
    p = torch.clamp(input, 1e-12, 1 - 1e-12)
    out = -(label * torch.log(p) + (1 - label) * torch.log(1 - p))
    if weight is not None:
        out = out * weight
    return _reduce(out, reduction)


@amp_op("bce_logits")
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None) -> torch.Tensor:
    log_sig = TF.logsigmoid(logit)
    log_sig_neg = TF.logsigmoid(-logit)
    if pos_weight is not None:
        out = -(pos_weight * label * log_sig + (1 - label) * log_sig_neg)
    else:
        out = -(label * log_sig + (1 - label) * log_sig_neg)
    if weight is not None:
        out = out * weight
    return _reduce(out, reduction)


@amp_op("mse_loss")
def mse_loss(input, label, reduction="mean", name=None) -> torch.Tensor:
    return _reduce(torch.square(input - label), reduction)


@amp_op("square_error_cost")
def square_error_cost(input, label) -> torch.Tensor:
    return torch.square(input - label)


@amp_op("l1_loss")
def l1_loss(input, label, reduction="mean", name=None) -> torch.Tensor:
    return _reduce((input - label).abs(), reduction)


@amp_op("smooth_l1")
def smooth_l1_loss(input, label, reduction="mean", delta=1.0,
                   name=None) -> torch.Tensor:
    d = input - label
    ad = d.abs()
    return _reduce(torch.where(ad < delta, 0.5 * d * d / delta,
                               ad - 0.5 * delta), reduction)


@amp_op("huber")
def huber_loss(input, label, delta=1.0, reduction="mean",
               name=None) -> torch.Tensor:
    d = input - label
    ad = d.abs()
    return _reduce(torch.where(ad <= delta, 0.5 * d * d,
                               delta * (ad - 0.5 * delta)), reduction)


@amp_op("kl_div")
def kl_div(input, label, reduction="mean", log_target=False,
           name=None) -> torch.Tensor:
    if log_target:
        out = torch.exp(label) * (label - input)
    else:
        out = label * (torch.log(torch.clamp(label, min=1e-12)) - input)
    return _reduce(out, reduction)


@amp_op("margin_ranking")
def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None) -> torch.Tensor:
    return _reduce(torch.clamp(-label * (input - other) + margin, min=0.0),
                   reduction)


@amp_op("hinge_embedding")
def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None) -> torch.Tensor:
    return _reduce(torch.where(label == 1, input,
                               torch.clamp(margin - input, min=0.0)),
                   reduction)


@amp_op("cosine_embedding")
def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None) -> torch.Tensor:
    cos = (input1 * input2).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1), min=1e-12)
    return _reduce(torch.where(label == 1, 1 - cos,
                               torch.clamp(cos - margin, min=0.0)),
                   reduction)


@amp_op("focal")
def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None) -> torch.Tensor:
    p = torch.sigmoid(logit)
    ce = -(label * TF.logsigmoid(logit) + (1 - label) * TF.logsigmoid(-logit))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    out = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        out = out / normalizer
    return _reduce(out, reduction)


@amp_op("log_loss")
def log_loss(input, label, epsilon=1e-4, name=None) -> torch.Tensor:
    return -(label * torch.log(input + epsilon)
             + (1 - label) * torch.log(1 - input + epsilon))


@amp_op("triplet")
def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None) -> torch.Tensor:
    def dist(u, v):
        return ((u - v + epsilon).abs() ** p).sum(-1) ** (1.0 / p)
    d_pos = dist(input, positive)
    d_neg = dist(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, dist(positive, negative))
    return _reduce(torch.clamp(d_pos - d_neg + margin, min=0.0), reduction)


@amp_op("poisson_nll")
def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None) -> torch.Tensor:
    if log_input:
        out = torch.exp(input) - label * input
    else:
        out = input - label * torch.log(input + epsilon)
    if full:
        stirling = label * torch.log(label + epsilon) - label + 0.5 * \
            torch.log(2 * math.pi * (label + epsilon))
        out = out + torch.where(label > 1, stirling, 0.0)
    return _reduce(out, reduction)


@amp_op("ctc_loss")
def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False) -> torch.Tensor:
    """CTC by the forward algorithm in log space over time (the JAX
    function's ``lax.scan`` as a loop); ``log_probs`` ``[T, B, C]`` are
    log-softmaxed first, as there."""
    lp = torch.log_softmax(log_probs, dim=-1)
    T, B, _ = lp.shape
    S = labels.shape[1]
    L = 2 * S + 1
    neg_inf = -1e30
    dev = lp.device
    ext = torch.full((B, L), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    # emit[b, t, l] = lp[t, b, ext[b, l]]
    emit = torch.gather(lp.transpose(0, 1), 2,
                        ext[:, None, :].expand(B, T, L))
    alpha = torch.full((B, L), neg_inf, dtype=lp.dtype, device=dev)
    alpha = torch.cat([emit[:, 0, :1],
                       emit[:, 0, 1:2] if S > 0 else alpha[:, 1:2],
                       alpha[:, 2:]], dim=1)
    same_prev2 = torch.cat([torch.ones(B, 2, dtype=torch.bool, device=dev),
                            ext[:, 2:] == ext[:, :-2]], dim=1)
    pad1 = torch.full((B, 1), neg_inf, dtype=lp.dtype, device=dev)
    pad2 = torch.full((B, 2), neg_inf, dtype=lp.dtype, device=dev)
    alphas = [alpha]
    for t in range(1, T):
        s1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        s2 = torch.where(same_prev2, neg_inf,
                         torch.cat([pad2, alpha[:, :-2]], dim=1))
        alpha = torch.logaddexp(torch.logaddexp(alpha, s1), s2) + emit[:, t]
        alphas.append(alpha)
    alphas = torch.stack(alphas)                          # [T, B, L]
    t_idx = input_lengths.long() - 1
    final = alphas[t_idx, torch.arange(B, device=dev)]    # [B, L]
    l_end = 2 * label_lengths.long()
    p_blank = final.gather(1, l_end[:, None])[:, 0]
    p_label = final.gather(1, torch.clamp(l_end - 1, min=0)[:, None])[:, 0]
    loss = -torch.logaddexp(p_blank, p_label)
    if reduction == "mean":
        return (loss / torch.clamp(label_lengths.to(loss.dtype),
                                   min=1)).mean()
    if reduction == "sum":
        return loss.sum()
    return loss


@amp_op("margin_cross_entropy")
def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean", name=None):
    """ArcFace-family margin softmax: ``cos(m1 * theta + m2) - m3`` on the
    target logit (logits are cosines), then scaled cross-entropy."""
    yi = label.long().reshape(-1)
    rows = torch.arange(logits.shape[0], device=logits.device)
    tgt = logits[rows, yi]
    theta = torch.arccos(torch.clamp(tgt, -1 + 1e-7, 1 - 1e-7))
    tgt_m = torch.cos(margin1 * theta + margin2) - margin3
    x_m = logits.index_put((rows, yi), tgt_m)
    logp = torch.log_softmax(x_m * scale, dim=-1)
    loss = _reduce(-logp[rows, yi], reduction)
    if return_softmax:
        return loss, torch.exp(logp)
    return loss
