"""The case tables of the ``test_torch_nn_*.py`` files of the
functionals (see ``torch_core_cases``): ``paddle.nn.functional``'s
deterministic functions, by their dotted path, on the same numpy inputs
in both packages. JAX-free, like the op tables.

- ``ACTIVATIONS``: ``test_torch_nn_activation.py``;
- ``COMMON``: ``test_torch_nn_functional.py``;
- ``SPATIAL`` (``common.py``'s folds, resizes and shuffles):
  ``test_torch_nn_spatial.py``;
- ``LOSSES``: ``test_torch_nn_losses.py``;
- ``NORM``: ``test_torch_nn_norm.py``;
- ``EXTRA``: ``test_torch_nn_extra_losses.py``.

The random ones (the dropouts in training, ``rrelu`` in training,
``gumbel_softmax``, ``class_center_sample``) are held by their
statistics in ``test_torch_nn_functional.py``, and
``adaptive_log_softmax_with_loss`` (whose tails are pairs) in
``test_torch_nn_extra_losses.py``.

Tolerances beyond ``TOL`` are stated beside the case, with the reason.
"""

import numpy as np

from torch_core_cases import Case, I, N, Raw, U, args

F32 = ("float32",)
S = (3, 8)
IMG = (2, 4, 5, 6)
# a bfloat16 loss sums or averages many bfloat16 terms whose roundings
# fall in different places (torch accumulates in f32 inside the kernel,
# XLA rounds the elementwise terms first)
BF16_SUM = {"bfloat16": dict(rtol=2e-2, atol=2e-2)}
# a bfloat16 normalization's gradient sums rounded terms (the mean, the
# variance, the normalized values) in another order: within 1.5 % of
# the largest magnitude (2.75 at the instance norm's shape)
NORM_BF16 = {"bfloat16": dict(rtol=2e-2, atol=4e-2)}


def fn(name):
    return "nn.functional." + name


def _c(name, make, label="", dtypes=("float32", "bfloat16"), **kw):
    return Case(fn(name), make, label=label, dtypes=dtypes, **kw)


def _probs(*shape):
    def make(rng):
        a = rng.random(shape).astype(np.float32) + 0.05
        return a / a.sum(-1, keepdims=True)
    return make


def _pm1(*shape):
    return lambda rng: np.where(rng.random(shape) < 0.5, -1.0,
                                1.0).astype(np.float32)


def _binary(*shape):
    return lambda rng: (rng.random(shape) < 0.5).astype(np.float32)


ACTIVATIONS = [
    _c("relu", args(N(*S))),
    _c("relu6", args(U(-8, 8, *S))),
    _c("elu", args(N(*S)), kwargs=dict(alpha=0.7)),
    _c("selu", args(N(*S))),
    _c("celu", args(N(*S)), kwargs=dict(alpha=1.3)),
    _c("gelu", args(N(*S))),
    _c("gelu", args(N(*S)), label="tanh", kwargs=dict(approximate=True)),
    _c("silu", args(N(*S))),
    _c("swish", args(N(*S))),
    _c("mish", args(N(*S))),
    _c("softplus", args(U(-30, 30, *S))),
    _c("softplus", args(N(*S)), label="beta",
       kwargs=dict(beta=2.0, threshold=3.0)),
    _c("softshrink", args(N(*S)), kwargs=dict(threshold=0.3)),
    _c("hardshrink", args(N(*S)), kwargs=dict(threshold=0.3)),
    _c("tanhshrink", args(N(*S))),
    _c("hardtanh", args(U(-2, 2, *S)), kwargs=dict(min=-0.5, max=0.7)),
    _c("hardsigmoid", args(U(-5, 5, *S))),
    _c("hardswish", args(U(-5, 5, *S))),
    _c("leaky_relu", args(N(*S)), kwargs=dict(negative_slope=0.2)),
    _c("log_sigmoid", args(N(*S))),
    _c("log_softmax", args(N(*S))),
    _c("log_softmax", args(N(2, 3, 4)), label="axis0", kwargs=dict(axis=0)),
    _c("log_softmax", args(N(*S)), label="dtype", dtypes=("bfloat16",),
       kwargs=dict(dtype="float32")),
    _c("softmax", args(N(*S))),
    _c("softmax", args(N(2, 3, 4)), label="axis1", kwargs=dict(axis=1)),
    _c("softmax", args(N(*S)), label="dtype", dtypes=("bfloat16",),
       kwargs=dict(dtype="float32")),
    _c("softsign", args(N(*S))),
    _c("sigmoid", args(N(*S))),
    _c("tanh", args(N(*S))),
    _c("maxout", args(N(2, 6, 3, 3), Raw(3))),
    _c("maxout", args(N(2, 3, 4), Raw(2)), label="last",
       kwargs=dict(axis=-1)),
    _c("prelu", args(N(2, 3, 4, 4), U(0.1, 0.5, 3))),
    _c("prelu", args(N(2, 4, 4, 3), U(0.1, 0.5, 3)), label="nhwc",
       kwargs=dict(data_format="NHWC")),
    _c("prelu", args(N(*S), U(0.1, 0.5, 1)), label="shared"),
    _c("rrelu", args(N(*S)), label="eval", kwargs=dict(training=False)),
    _c("glu", args(N(3, 8))),
    _c("glu", args(N(4, 3)), label="axis0", kwargs=dict(axis=0)),
    _c("thresholded_relu", args(U(-3, 3, *S)),
       kwargs=dict(threshold=0.5)),
]

COMMON = [
    _c("linear", args(N(2, 3, 4), N(4, 5), N(5))),
    _c("linear", args(N(3, 4), N(4, 5)), label="nobias"),
    _c("dropout", args(N(*S)), label="eval", kwargs=dict(training=False)),
    _c("dropout", args(N(*S)), label="infer",
       kwargs=dict(p=0.3, training=False, mode="downscale_in_infer")),
    _c("dropout", args(N(*S)), label="p0", kwargs=dict(p=0.0)),
    _c("dropout2d", args(N(*IMG)), label="eval", kwargs=dict(training=False)),
    _c("dropout3d", args(N(2, 3, 2, 2, 2)), label="eval",
       kwargs=dict(training=False)),
    _c("alpha_dropout", args(N(*S)), label="eval",
       kwargs=dict(training=False)),
    _c("feature_alpha_dropout", args(N(*IMG)), label="eval",
       kwargs=dict(training=False)),
    _c("embedding", args(I(0, 10, 3, 4), N(10, 6))),
    _c("embedding", args(I(0, 10, 3, 4), N(10, 6)), label="pad",
       kwargs=dict(padding_idx=2)),
    _c("embedding", args(I(0, 10, 3, 4), N(10, 6)), label="negpad",
       kwargs=dict(padding_idx=-1)),
    _c("one_hot", args(I(-1, 6, 3, 4), Raw(5)), dtypes=F32, grad=False),
    _c("pad", args(N(2, 3, 4, 5), Raw([1, 2, 0, 3]))),
    _c("pad", args(N(2, 3, 4, 5), Raw([1, 2, 2, 1])), label="reflect",
       kwargs=dict(mode="reflect")),
    _c("pad", args(N(2, 3, 4, 5), Raw([1, 2, 2, 1])), label="replicate",
       kwargs=dict(mode="replicate")),
    _c("pad", args(N(2, 3, 4, 5), Raw([1, 2, 2, 1])), label="circular",
       kwargs=dict(mode="circular")),
    _c("pad", args(N(2, 4, 5, 3), Raw([1, 0, 2, 1])), label="nhwc",
       kwargs=dict(data_format="NHWC", value=0.5)),
    _c("pad", args(N(3, 4), Raw([1, 2, 0, 1])), label="all_axes",
       kwargs=dict(value=-1.0)),
    _c("pad", args(N(2, 3, 5), Raw([2, 1])), label="ncw_reflect",
       kwargs=dict(mode="reflect", data_format="NCW")),
    _c("zeropad2d", args(N(*IMG), Raw([1, 0, 2, 1]))),
    _c("cosine_similarity", args(N(4, 6), N(4, 6)), tol=BF16_SUM),
    _c("cosine_similarity", args(N(4, 6, 3), N(4, 6, 3)), label="axis2",
       kwargs=dict(axis=2), tol=BF16_SUM),
    _c("normalize", args(N(4, 6)), tol=BF16_SUM),
    _c("normalize", args(N(4, 6)), label="p3", kwargs=dict(p=3, axis=0),
       tol=BF16_SUM),
    _c("bilinear", args(N(3, 4), N(3, 5), N(2, 4, 5), N(2)), tol=BF16_SUM),
    _c("bilinear", args(N(3, 4), N(3, 5), N(2, 4, 5)), label="nobias",
       tol=BF16_SUM),
    _c("label_smooth", args(_probs(3, 6))),
    _c("label_smooth", args(_probs(3, 6)), label="prior",
       kwargs=dict(epsilon=0.2, prior_dist=_probs(1, 6)(
           np.random.default_rng(5)))),
]

# the spatial ones: im2col and back, resizing, shuffles
SPATIAL = [
    _c("unfold", args(N(2, 3, 6, 5), Raw([2, 3]))),
    _c("unfold", args(N(2, 3, 7, 6), Raw(3)), label="strided",
       kwargs=dict(strides=2, paddings=[1, 0, 2, 1], dilations=[1, 2])),
    _c("fold", args(N(2, 12, 30), Raw([6, 7]), Raw(2))),
    _c("fold", args(N(2, 27, 12), Raw([7, 6]), Raw(3)), label="strided",
       kwargs=dict(strides=2, paddings=1)),
    _c("interpolate", args(N(*IMG)), label="nearest_up",
       kwargs=dict(scale_factor=2)),
    _c("interpolate", args(N(2, 3, 9, 7)), label="nearest_size",
       kwargs=dict(size=[4, 5])),
    _c("interpolate", args(N(*IMG)), label="bilinear_up",
       kwargs=dict(size=[9, 11], mode="bilinear")),
    _c("interpolate", args(N(2, 3, 9, 10)), label="bilinear_down",
       kwargs=dict(size=[4, 6], mode="bilinear")),
    _c("interpolate", args(N(*IMG)), label="bicubic",
       kwargs=dict(size=[7, 9], mode="bicubic")),
    _c("interpolate", args(N(2, 5, 6, 3)), label="nhwc_bilinear",
       kwargs=dict(scale_factor=1.5, mode="bilinear", data_format="NHWC")),
    _c("interpolate", args(N(2, 3, 7)), label="linear_ncw",
       kwargs=dict(size=[12], mode="linear", data_format="NCW")),
    _c("interpolate", args(N(2, 2, 3, 4, 5)), label="trilinear",
       kwargs=dict(size=[5, 6, 3], mode="trilinear", data_format="NCDHW")),
    _c("upsample", args(N(*IMG)), kwargs=dict(scale_factor=2)),
    _c("pixel_shuffle", args(N(2, 8, 3, 4), Raw(2))),
    _c("pixel_shuffle", args(N(2, 3, 4, 8), Raw(2)), label="nhwc",
       kwargs=dict(data_format="NHWC")),
    _c("pixel_unshuffle", args(N(2, 2, 6, 4), Raw(2))),
    _c("pixel_unshuffle", args(N(2, 6, 4, 2), Raw(2)), label="nhwc",
       kwargs=dict(data_format="NHWC")),
    _c("channel_shuffle", args(N(2, 6, 3, 3), Raw(3))),
    _c("channel_shuffle", args(N(2, 3, 3, 6), Raw(2)), label="nhwc",
       kwargs=dict(data_format="NHWC")),
]

NORM = [
    _c("instance_norm", args(N(2, 3, 4, 5)), tol=NORM_BF16),
    _c("instance_norm", args(N(2, 3, 4, 5)), label="affine",
       kwargs=dict(weight=U(0.5, 1.5, 3)(np.random.default_rng(1)),
                   bias=N(3)(np.random.default_rng(2))), tol=NORM_BF16),
    _c("instance_norm", args(N(2, 4, 5, 3)), label="nhwc",
       kwargs=dict(data_format="NHWC", eps=1e-3), tol=NORM_BF16),
    _c("group_norm", args(N(2, 6, 3, 4), Raw(3), Raw(1e-5), N(6), N(6)),
       tol=NORM_BF16),
    _c("group_norm", args(N(2, 3, 4, 6), Raw(2)), label="nhwc",
       kwargs=dict(data_format="NHWC"), tol=NORM_BF16),
    _c("local_response_norm", args(N(2, 6, 3, 4), Raw(3)), tol=NORM_BF16),
    _c("local_response_norm", args(N(2, 3, 4, 6), Raw(4)), label="nhwc",
       kwargs=dict(data_format="NHWC", alpha=0.1, beta=0.5, k=2.0),
       tol=NORM_BF16),
    _c("rms_norm", args(N(3, 4, 8))),
    _c("rms_norm", args(N(3, 4, 8), U(0.5, 1.5, 8)), label="weight",
       kwargs=dict(epsilon=1e-5)),
    _c("layer_norm", args(N(3, 4, 8), Raw(8), U(0.5, 1.5, 8), N(8)),
       tol=NORM_BF16),
    _c("layer_norm", args(N(3, 4, 8), Raw([4, 8])), label="two_axes",
       tol=NORM_BF16),
]

LOSSES = [
    _c("nll_loss", args(N(5, 6), I(0, 6, 5)), tol=BF16_SUM),
    _c("nll_loss", args(N(5, 6), I(0, 6, 5), U(0.5, 2, 6)), label="weight",
       kwargs=dict(reduction="sum"), dtypes=F32),
    _c("nll_loss", args(N(5, 6), lambda r: np.array([1, -100, 3, 0, -100],
                                                    np.int32)),
       label="ignore", kwargs=dict(reduction="none"), dtypes=F32),
    _c("binary_cross_entropy", args(U(0.05, 0.95, 4, 3), _binary(4, 3)),
       tol=BF16_SUM),
    _c("binary_cross_entropy", args(U(0.05, 0.95, 4, 3), _binary(4, 3),
                                    U(0.5, 2, 4, 3)),
       label="weight_none", kwargs=dict(reduction="none"), dtypes=F32),
    _c("binary_cross_entropy_with_logits", args(N(4, 3), _binary(4, 3)),
       tol=BF16_SUM),
    _c("binary_cross_entropy_with_logits", args(N(4, 3), _binary(4, 3)),
       label="pos_weight", dtypes=F32,
       kwargs=dict(pos_weight=U(0.5, 2, 3)(np.random.default_rng(3)),
                   reduction="sum")),
    _c("binary_cross_entropy_with_logits", args(N(4, 3), _binary(4, 3),
                                                U(0.5, 2, 4, 3)),
       label="weight", dtypes=F32, kwargs=dict(reduction="none")),
    _c("mse_loss", args(N(4, 3), N(4, 3)), tol=BF16_SUM),
    _c("mse_loss", args(N(4, 3), N(4, 3)), label="none",
       kwargs=dict(reduction="none")),
    _c("l1_loss", args(N(4, 3), N(4, 3)), tol=BF16_SUM),
    _c("l1_loss", args(N(4, 3), N(4, 3)), label="sum",
       kwargs=dict(reduction="sum"), tol=BF16_SUM),
    _c("smooth_l1_loss", args(N(4, 3), N(4, 3)), tol=BF16_SUM),
    _c("smooth_l1_loss", args(N(4, 3), N(4, 3)), label="delta",
       kwargs=dict(delta=0.5, reduction="none")),
    _c("kl_div", args(N(4, 5), _probs(4, 5)), tol=BF16_SUM),
    _c("kl_div", args(N(4, 5), N(4, 5)), label="log_target",
       kwargs=dict(log_target=True, reduction="sum"), dtypes=F32),
    _c("margin_ranking_loss", args(N(6), N(6), _pm1(6)), tol=BF16_SUM),
    _c("margin_ranking_loss", args(N(6), N(6), _pm1(6)), label="margin",
       kwargs=dict(margin=0.3, reduction="none")),
    # the +-1 labels only select (JAX gives them a zero gradient, torch
    # none): the inputs' gradients are held
    _c("hinge_embedding_loss", args(N(4, 3), _pm1(4, 3)), tol=BF16_SUM,
       grad_args=(0,)),
    _c("hinge_embedding_loss", args(N(4, 3), _pm1(4, 3)), label="none",
       kwargs=dict(margin=0.5, reduction="none"), grad_args=(0,)),
    _c("cosine_embedding_loss", args(N(4, 6), N(4, 6), _pm1(4)),
       tol=BF16_SUM, grad_args=(0, 1)),
    _c("cosine_embedding_loss", args(N(4, 6), N(4, 6), _pm1(4)),
       label="margin", kwargs=dict(margin=0.2, reduction="sum"),
       dtypes=F32, grad_args=(0, 1)),
    _c("ctc_loss", args(N(7, 2, 5), I(1, 5, 2, 3),
                        lambda r: np.array([7, 5], np.int32),
                        lambda r: np.array([3, 2], np.int32)),
       dtypes=F32, grad_args=(0,)),
    _c("ctc_loss", args(N(6, 3, 4), I(1, 4, 3, 2),
                        lambda r: np.array([6, 6, 4], np.int32),
                        lambda r: np.array([2, 1, 2], np.int32)),
       label="none", kwargs=dict(reduction="none"), dtypes=F32,
       grad_args=(0,)),
    _c("sigmoid_focal_loss", args(N(4, 3), _binary(4, 3)), tol=BF16_SUM),
    _c("sigmoid_focal_loss", args(N(4, 3), _binary(4, 3),
                                  U(1, 3, 1)),
       label="normalizer", kwargs=dict(reduction="mean", gamma=1.5),
       dtypes=F32),
    _c("square_error_cost", args(N(4, 3), N(4, 3))),
    _c("log_loss", args(U(0.05, 0.95, 4, 1), _binary(4, 1))),
    _c("triplet_margin_loss", args(N(4, 5), N(4, 5), N(4, 5)),
       tol=BF16_SUM),
    _c("triplet_margin_loss", args(N(4, 5), N(4, 5), N(4, 5)),
       label="swap_p1", dtypes=F32,
       kwargs=dict(p=1.0, swap=True, margin=0.5, reduction="none")),
    _c("poisson_nll_loss", args(N(4, 3), U(0, 4, 4, 3)), tol=BF16_SUM),
    _c("poisson_nll_loss", args(U(0.2, 3, 4, 3), U(0, 4, 4, 3)),
       label="full", dtypes=F32,
       kwargs=dict(log_input=False, full=True, reduction="sum")),
    _c("huber_loss", args(N(4, 3), N(4, 3)), tol=BF16_SUM),
    _c("huber_loss", args(N(4, 3), N(4, 3)), label="delta",
       kwargs=dict(delta=0.4, reduction="none")),
    _c("softmax_with_cross_entropy", args(N(4, 6), I(0, 6, 4, 1)),
       tol=BF16_SUM),
    _c("softmax_with_cross_entropy", args(N(4, 6), _probs(4, 6)),
       label="soft_return_softmax", dtypes=F32,
       kwargs=dict(soft_label=True, return_softmax=True)),
    _c("margin_cross_entropy", args(U(-0.9, 0.9, 4, 6), I(0, 6, 4)),
       dtypes=F32),
    _c("margin_cross_entropy", args(U(-0.9, 0.9, 4, 6), I(0, 6, 4)),
       label="softmax_none", dtypes=F32,
       kwargs=dict(margin1=0.9, margin2=0.2, margin3=0.1, scale=8.0,
                   return_softmax=True, reduction="none")),
]


def _paths(rng):
    """A custom tree: per sample, three levels of internal-node rows
    (-1 padding at the end) and their bits."""
    table = rng.integers(0, 5, size=(4, 3)).astype(np.int32)
    table[1, 2] = -1
    code = rng.integers(0, 2, size=(4, 3)).astype(np.int32)
    return table, code


def _custom_hsig(rng):
    table, code = _paths(rng)
    return [N(4, 6)(rng), I(0, 6, 4)(rng), Raw(6), N(5, 6)(rng),
            N(5, 1)(rng), table, code]


def _rnnt(rng):
    return [N(2, 4, 3, 5)(rng), I(1, 5, 2, 2)(rng),
            np.array([4, 3], np.int32), np.array([2, 1], np.int32)]


def _gather_tree(rng):
    ids = rng.integers(0, 9, size=(4, 2, 3)).astype(np.int32)
    parents = rng.integers(0, 3, size=(4, 2, 3)).astype(np.int32)
    return [ids, parents]


# the extra losses in float32, and the few that models run in bfloat16
# (distances, the shift, the diagonal) in both
EXTRA = [
    _c("pairwise_distance", args(N(4, 6), N(4, 6)), tol=BF16_SUM),
    _c("pairwise_distance", args(N(4, 6), N(4, 6)), label="p1_keepdim",
       kwargs=dict(p=1.0, keepdim=True), dtypes=F32),
    _c("pairwise_distance", args(N(4, 6), N(4, 6)), label="p3",
       kwargs=dict(p=3.0), dtypes=F32),
    _c("soft_margin_loss", args(N(4, 3), _pm1(4, 3)), tol=BF16_SUM),
    _c("multi_label_soft_margin_loss", args(N(4, 5), _binary(4, 5)),
       dtypes=F32),
    _c("multi_label_soft_margin_loss", args(N(4, 5), _binary(4, 5),
                                            U(0.5, 2, 5)),
       label="weight", kwargs=dict(reduction="none"), dtypes=F32),
    _c("multi_margin_loss", args(N(4, 5), I(0, 5, 4)), dtypes=F32),
    _c("multi_margin_loss", args(N(4, 5), I(0, 5, 4)), label="p2_weight",
       dtypes=F32, kwargs=dict(p=2, margin=0.5, reduction="sum",
                               weight=U(0.5, 2, 5)(
                                   np.random.default_rng(7)))),
    _c("gaussian_nll_loss", args(N(4, 3), N(4, 3), U(0.2, 2, 4, 3)),
       dtypes=F32),
    _c("gaussian_nll_loss", args(N(4, 3), N(4, 3), U(0.2, 2, 4, 3)),
       label="full", kwargs=dict(full=True, reduction="none"), dtypes=F32),
    _c("triplet_margin_with_distance_loss", args(N(4, 5), N(4, 5),
                                                 N(4, 5)), dtypes=F32),
    _c("triplet_margin_with_distance_loss", args(N(4, 5), N(4, 5),
                                                 N(4, 5)),
       label="swap", kwargs=dict(swap=True, margin=0.3, reduction="none"),
       dtypes=F32),
    _c("dice_loss", args(_probs(3, 4, 5), I(0, 5, 3, 4, 1)), dtypes=F32),
    _c("npair_loss", args(N(4, 6), N(4, 6), I(0, 3, 4)), dtypes=F32),
    Case(fn("gather_tree"), _gather_tree, dtypes=F32, grad=False),
    _c("temporal_shift", args(N(6, 8, 2, 3), Raw(3))),
    _c("temporal_shift", args(N(4, 2, 3, 8), Raw(2)), label="nhwc",
       kwargs=dict(shift_ratio=0.125, data_format="NHWC"), dtypes=F32),
    _c("hsigmoid_loss", args(N(4, 6), I(0, 6, 4), Raw(6), N(5, 6), N(5, 1)),
       dtypes=F32),
    Case(fn("hsigmoid_loss"), _custom_hsig, label="custom", dtypes=F32,
         grad_args=(0, 3, 4)),
    Case(fn("rnnt_loss"), _rnnt, dtypes=F32, grad_args=(0,)),
    Case(fn("rnnt_loss"), _rnnt, label="sum_nofastemit", dtypes=F32,
         grad_args=(0,), kwargs=dict(fastemit_lambda=0.0,
                                     reduction="sum")),
    _c("sequence_mask", args(I(0, 6, 2, 3)), dtypes=F32, grad=False),
    _c("sequence_mask", args(I(0, 6, 4)), label="maxlen", dtypes=F32,
       grad=False, kwargs=dict(maxlen=7, dtype="float32")),
    _c("diag_embed", args(N(2, 3))),
    _c("diag_embed", args(N(2, 3)), label="offset",
       kwargs=dict(offset=1, dim1=0, dim2=2), dtypes=F32),
]

