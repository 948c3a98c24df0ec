"""Loss layers: the counterpart of ``paddle2_tpu/nn/layer/loss.py``,
each over its functional."""

from __future__ import annotations

import torch

from ...amp.casting import amp_op
from .. import functional as F
from .layers import Layer

__all__ = ["SoftMarginLoss", "MultiLabelSoftMarginLoss",
           "MultiMarginLoss", "GaussianNLLLoss",
           "TripletMarginWithDistanceLoss", "CrossEntropyLoss", "NLLLoss",
           "BCELoss", "BCEWithLogitsLoss", "MSELoss", "L1Loss",
           "SmoothL1Loss", "KLDivLoss", "MarginRankingLoss",
           "HingeEmbeddingLoss", "CosineEmbeddingLoss", "CTCLoss",
           "TripletMarginLoss", "PoissonNLLLoss", "HuberLoss",
           "HSigmoidLoss", "AdaptiveLogSoftmaxWithLoss", "RNNTLoss"]


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.args = dict(ignore_index=ignore_index, reduction=reduction,
                         soft_label=soft_label, axis=axis,
                         use_softmax=use_softmax,
                         label_smoothing=label_smoothing)

    def forward(self, input, label):
        return F.cross_entropy(input, label, weight=self.weight, **self.args)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self.weight, self.ignore_index, self.reduction = (
            weight, ignore_index, reduction)

    def forward(self, input, label):
        return F.nll_loss(input, label, self.weight, self.ignore_index,
                          self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self.weight,
                                      self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self.weight, self.reduction, self.pos_weight = (weight, reduction,
                                                        pos_weight)

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self.reduction)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction, self.delta = reduction, delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class HuberLoss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction, self.delta = reduction, delta

    def forward(self, input, label):
        return F.huber_loss(input, label, self.delta, self.reduction)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean", log_target=False):
        super().__init__()
        self.reduction, self.log_target = reduction, log_target

    def forward(self, input, label):
        return F.kl_div(input, label, self.reduction, self.log_target)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self.margin,
                                       self.reduction)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction, norm_by_times)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.args = (margin, p, epsilon, swap, reduction)

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative, *self.args)


class PoissonNLLLoss(Layer):
    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__()
        self.args = (log_input, full, epsilon, reduction)

    def forward(self, input, label):
        return F.poisson_nll_loss(input, label, *self.args)


class SoftMarginLoss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.soft_margin_loss(input, label, self.reduction)


class MultiLabelSoftMarginLoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.multi_label_soft_margin_loss(input, label, self.weight,
                                              self.reduction)


class MultiMarginLoss(Layer):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__()
        self.p, self.margin = p, margin
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.multi_margin_loss(input, label, self.p, self.margin,
                                   self.weight, self.reduction)


class GaussianNLLLoss(Layer):
    def __init__(self, full=False, epsilon=1e-6, reduction="mean",
                 name=None):
        super().__init__()
        self.full, self.epsilon = full, epsilon
        self.reduction = reduction

    def forward(self, input, label, variance):
        return F.gaussian_nll_loss(input, label, variance, self.full,
                                   self.epsilon, self.reduction)


class TripletMarginWithDistanceLoss(Layer):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.distance_function = distance_function
        self.margin, self.swap = margin, swap
        self.reduction = reduction

    def forward(self, input, positive, negative):
        return F.triplet_margin_with_distance_loss(
            input, positive, negative, self.distance_function, self.margin,
            self.swap, self.reduction)


class HSigmoidLoss(Layer):
    """A learnable hierarchical-softmax tree over ``num_classes`` leaves
    (the weight's rows are the internal nodes)."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        if not is_custom and num_classes < 2:
            raise ValueError("num_classes must be >= 2")
        self.num_classes = num_classes
        self.is_custom = is_custom
        self.weight = self.create_parameter(
            [num_classes - 1, feature_size], attr=weight_attr)
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_classes - 1, 1], attr=bias_attr, is_bias=True)

    def forward(self, input, label, path_table=None, path_code=None):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               self.bias, path_table=path_table,
                               path_code=path_code)


class AdaptiveLogSoftmaxWithLoss(Layer):
    """A head shortlist and tail clusters shrunk by ``div_value``."""

    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0,
                 head_bias=False, weight_attr=None, bias_attr=None,
                 name=None):
        super().__init__()
        cutoffs = list(cutoffs)
        if (cutoffs != sorted(cutoffs) or min(cutoffs) <= 0
                or max(cutoffs) > n_classes - 1
                or len(set(cutoffs)) != len(cutoffs)):
            raise ValueError(
                "cutoffs should be a sequence of unique, positive "
                "integers sorted in an increasing order, each < n_classes")
        self.in_features = in_features
        self.n_classes = n_classes
        self.cutoffs = cutoffs + [n_classes]
        self.div_value = div_value
        self.shortlist_size = self.cutoffs[0]
        self.n_clusters = len(self.cutoffs) - 1
        self.head_size = self.shortlist_size + self.n_clusters
        self.head_weight = self.create_parameter(
            [in_features, self.head_size], attr=weight_attr)
        self.head_bias = self.create_parameter(
            [self.head_size], attr=bias_attr,
            is_bias=True) if head_bias else None
        self.tail_weights = []
        for i in range(self.n_clusters):
            hsz = max(1, int(in_features // (div_value ** (i + 1))))
            osz = self.cutoffs[i + 1] - self.cutoffs[i]
            proj = self.create_parameter([in_features, hsz],
                                         attr=weight_attr)
            out = self.create_parameter([hsz, osz], attr=weight_attr)
            self.add_parameter(f"tail_proj_{i}", proj)
            self.add_parameter(f"tail_out_{i}", out)
            self.tail_weights.append([proj, out])

    def forward(self, input, label):
        return F.adaptive_log_softmax_with_loss(
            input, label, self.head_weight, self.tail_weights,
            self.cutoffs[:-1], self.head_bias)

    def log_prob(self, input):
        """Full ``[N, n_classes]`` log-probabilities."""
        return _adaptive_log_prob(input, self.head_weight, self.head_bias,
                                  self.tail_weights, self.shortlist_size)

    def predict(self, input):
        return self.log_prob(input).argmax(axis=-1)


@amp_op("adaptive_log_prob")
def _adaptive_log_prob(x, hw, hb, tails, short):
    head = x @ hw
    if hb is not None:
        head = head + hb
    head_lp = torch.log_softmax(head, dim=-1)
    pieces = [head_lp[:, :short]]
    for c, (proj, ow) in enumerate(tails):
        tail_lp = torch.log_softmax((x @ proj) @ ow, dim=-1)
        pieces.append(head_lp[:, short + c:short + c + 1] + tail_lp)
    return torch.cat(pieces, dim=1)


class RNNTLoss(Layer):
    def __init__(self, blank=0, fastemit_lambda=0.001, reduction="mean",
                 name=None):
        super().__init__()
        self.blank = blank
        self.fastemit_lambda = fastemit_lambda
        self.reduction = reduction

    def forward(self, input, label, input_lengths, label_lengths):
        return F.rnnt_loss(input, label, input_lengths, label_lengths,
                           blank=self.blank,
                           fastemit_lambda=self.fastemit_lambda,
                           reduction=self.reduction)
