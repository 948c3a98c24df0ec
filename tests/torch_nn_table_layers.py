"""The layer tables of ``test_torch_nn_layers.py`` (activation and
common layers), ``test_torch_nn_norm_layers.py`` and
``test_torch_nn_loss_layers.py``: each ``paddle.nn`` layer class of
this slice, by name, with its constructor arguments and the inputs it
is called on. The tests build the JAX layer and the port's twin from the
same arguments, load the JAX weights into the twin
(``nn_state_from_reference``) and hold the forward, the dtypes and the
gradients of every float input and parameter. JAX-free, like the op
tables.

Numpy arrays among the constructor's keyword arguments become each
package's tensors (no gradient). Layers that draw random numbers are
run in eval mode (``train=False``), where they are deterministic; their
training draws are held by statistics in the test files.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np

from torch_core_cases import I, N, U

F32 = ("float32",)
BOTH = ("float32", "bfloat16")
# as in the functional tables: a bfloat16 reduction (a norm's
# statistics, a loss's mean) sums rounded terms in another order
BF16_SUM = {"bfloat16": dict(rtol=2e-2, atol=4e-2)}
# a batch norm's bfloat16 weight gradient sums, per channel, 60 products
# of values each rounded to bfloat16 in another order: within 2 % of the
# largest magnitude (5.3 here)
BN_BF16 = {"bfloat16": dict(rtol=2e-2, atol=1e-1)}


@dataclass
class L:
    name: str
    args: Tuple[Any, ...] = ()
    kwargs: Dict[str, Any] = field(default_factory=dict)
    inputs: Sequence[Callable] = ()
    label: str = ""
    dtypes: Tuple[str, ...] = F32
    train: bool = True
    tol: Dict[str, Dict[str, float]] = field(default_factory=dict)
    # inputs that take gradients (by position); None: every float input
    grad_inputs: Any = None

    @property
    def id(self):
        return self.name + (f"[{self.label}]" if self.label else "")


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


def _const(a):
    return lambda rng: np.asarray(a)


X = N(3, 8)
IMG = N(2, 4, 5, 6)

ACTIVATION_LAYERS = [
    L("ReLU", inputs=[X], dtypes=BOTH), L("ReLU6", inputs=[U(-8, 8, 3, 8)]),
    L("ELU", (0.5,), inputs=[X]), L("SELU", inputs=[X]),
    L("CELU", inputs=[X]), L("GELU", inputs=[X], dtypes=BOTH),
    L("GELU", kwargs=dict(approximate=True), inputs=[X], label="tanh"),
    L("Sigmoid", inputs=[X]), L("Silu", inputs=[X]), L("Swish", inputs=[X]),
    L("Mish", inputs=[X]), L("Softplus", inputs=[X]),
    L("Softshrink", inputs=[X]), L("Hardshrink", inputs=[X]),
    L("Tanhshrink", inputs=[X]), L("Hardtanh", inputs=[U(-2, 2, 3, 8)]),
    L("Hardsigmoid", inputs=[U(-5, 5, 3, 8)]),
    L("Hardswish", inputs=[U(-5, 5, 3, 8)]),
    L("LeakyReLU", (0.1,), inputs=[X]), L("LogSigmoid", inputs=[X]),
    L("LogSoftmax", inputs=[X]), L("Softmax", inputs=[X], dtypes=BOTH),
    L("Softmax", kwargs=dict(axis=0), inputs=[X], label="axis0"),
    L("Softsign", inputs=[X]), L("Tanh", inputs=[X], dtypes=BOTH),
    L("Maxout", (2,), inputs=[IMG]),
    L("PReLU", (4,), inputs=[IMG]),
    L("PReLU", kwargs=dict(init=0.1), inputs=[X], label="shared"),
    L("GLU", inputs=[X]),
    L("ThresholdedReLU", (0.3,), inputs=[X]),
]

COMMON_LAYERS = [
    L("FeatureAlphaDropout", (0.3,), inputs=[IMG], train=False),
    L("Softmax2D", inputs=[IMG]),
    L("Unflatten", (1, [2, 4]), inputs=[X]),
    L("ZeroPad1D", (2,), inputs=[N(2, 3, 5)]),
    L("ZeroPad3D", (1,), inputs=[N(1, 2, 3, 2, 2)]),
    L("PairwiseDistance", inputs=[N(4, 6), N(4, 6)]),
    L("Linear", (8, 5), inputs=[N(2, 3, 8)], dtypes=BOTH),
    L("Linear", (8, 5), kwargs=dict(bias_attr=False), inputs=[X],
      label="nobias"),
    L("Embedding", (10, 6), inputs=[I(0, 10, 3, 4)], dtypes=BOTH),
    L("Embedding", (10, 6), kwargs=dict(padding_idx=-2),
      inputs=[I(0, 10, 3, 4)], label="negpad"),
    L("Dropout", (0.3,), inputs=[X], train=False),
    L("Dropout", (0.3,), kwargs=dict(mode="downscale_in_infer"),
      inputs=[X], train=False, label="infer"),
    L("Dropout2D", (0.3,), inputs=[IMG], train=False),
    L("Dropout3D", (0.3,), inputs=[N(2, 3, 2, 2, 2)], train=False),
    L("AlphaDropout", (0.3,), inputs=[X], train=False),
    L("Flatten", inputs=[IMG]),
    L("Pad1D", ([1, 2],), kwargs=dict(mode="reflect"),
      inputs=[N(2, 3, 5)]),
    L("Pad2D", ([1, 0, 2, 1],), kwargs=dict(value=0.5), inputs=[IMG]),
    L("Pad3D", ([1, 0, 1, 1, 0, 1],), kwargs=dict(mode="replicate"),
      inputs=[N(1, 2, 3, 2, 2)]),
    L("ZeroPad2D", ([1, 1, 0, 2],), inputs=[IMG]),
    L("Upsample", kwargs=dict(scale_factor=2), inputs=[IMG]),
    L("UpsamplingBilinear2D", kwargs=dict(size=[7, 9]), inputs=[IMG]),
    L("UpsamplingNearest2D", kwargs=dict(scale_factor=2), inputs=[IMG]),
    L("PixelShuffle", (2,), inputs=[IMG]),
    L("PixelUnshuffle", (2,), inputs=[N(2, 2, 4, 6)]),
    L("ChannelShuffle", (2,), inputs=[IMG]),
    L("CosineSimilarity", inputs=[N(4, 6), N(4, 6)]),
    L("Bilinear", (3, 4, 5), inputs=[N(2, 3), N(2, 4)]),
    L("Identity", inputs=[X]),
    L("Unfold", (2,), inputs=[IMG]),
    L("Fold", ([4, 5], 2), inputs=[N(2, 12, 12)]),
    L("LinearLowPrecision", (8, 5), inputs=[X]),
    L("Conv2D", (4, 6, 3), kwargs=dict(padding=1), inputs=[IMG]),
    L("MaxPool2D", (2,), inputs=[IMG]),
    L("AdaptiveAvgPool2D", (2,), inputs=[IMG]),
]

NORM_LAYERS = [
    L("BatchNorm", (4,), inputs=[IMG], tol=BF16_SUM),
    L("BatchNorm1D", (4,), inputs=[N(3, 4, 5)]),
    L("BatchNorm2D", (4,), inputs=[IMG], dtypes=BOTH, tol=BN_BF16),
    L("BatchNorm2D", (4,), inputs=[IMG], train=False, label="eval"),
    L("BatchNorm2D", (4,), kwargs=dict(weight_attr=False, bias_attr=False),
      inputs=[IMG], label="noaffine"),
    L("BatchNorm3D", (2,), inputs=[N(2, 2, 3, 2, 2)]),
    L("SyncBatchNorm", (4,), inputs=[IMG]),
    L("LayerNorm", (8,), inputs=[N(2, 3, 8)], dtypes=BOTH, tol=BF16_SUM),
    L("LayerNorm", ([3, 8],), kwargs=dict(epsilon=1e-3),
      inputs=[N(2, 3, 8)], label="two_axes"),
    L("RMSNorm", (8,), inputs=[N(2, 3, 8)], dtypes=BOTH, tol=BF16_SUM),
    L("InstanceNorm1D", (4,), inputs=[N(3, 4, 5)]),
    L("InstanceNorm2D", (4,), inputs=[IMG]),
    L("InstanceNorm2D", (4,), kwargs=dict(weight_attr=False),
      inputs=[IMG], label="noaffine"),
    L("InstanceNorm3D", (2,), inputs=[N(2, 2, 3, 2, 2)]),
    L("GroupNorm", (2, 4), inputs=[IMG]),
    L("LocalResponseNorm", (3,), inputs=[IMG]),
    L("SpectralNorm", ([4, 6],), kwargs=dict(power_iters=3),
      inputs=[N(4, 6)]),
]

LOSS_LAYERS = [
    L("SoftMarginLoss", inputs=[N(4, 3), _pm1(4, 3)]),
    L("MultiLabelSoftMarginLoss", inputs=[N(4, 5), _binary(4, 5)]),
    L("MultiMarginLoss", inputs=[N(4, 5), I(0, 5, 4)]),
    L("GaussianNLLLoss", inputs=[N(4, 3), N(4, 3), U(0.2, 2, 4, 3)]),
    L("TripletMarginWithDistanceLoss", inputs=[N(4, 5), N(4, 5), N(4, 5)]),
    L("CrossEntropyLoss", inputs=[N(6, 5), I(0, 5, 6)], dtypes=BOTH,
      tol=BF16_SUM),
    L("CrossEntropyLoss",
      kwargs=dict(weight=np.linspace(0.5, 1.5, 5).astype(np.float32),
                  label_smoothing=0.1, reduction="sum", ignore_index=2),
      inputs=[N(6, 5), I(0, 5, 6)], label="weighted"),
    L("CrossEntropyLoss", kwargs=dict(soft_label=True, axis=1),
      inputs=[N(2, 5, 3), lambda r: _probs(2, 3, 5)(r).transpose(0, 2, 1)
              .copy()], label="soft_axis1", grad_inputs=(0,)),
    L("NLLLoss", inputs=[N(6, 5), I(0, 5, 6)]),
    L("BCELoss", inputs=[U(0.05, 0.95, 4, 3), _binary(4, 3)]),
    L("BCEWithLogitsLoss",
      kwargs=dict(pos_weight=np.full(3, 2.0, np.float32)),
      inputs=[N(4, 3), _binary(4, 3)]),
    L("MSELoss", inputs=[N(4, 3), N(4, 3)], dtypes=BOTH, tol=BF16_SUM),
    L("L1Loss", inputs=[N(4, 3), N(4, 3)]),
    L("SmoothL1Loss", inputs=[N(4, 3), N(4, 3)]),
    L("KLDivLoss", inputs=[N(4, 5), _probs(4, 5)]),
    L("MarginRankingLoss", (0.2,), inputs=[N(6), N(6), _pm1(6)]),
    L("HingeEmbeddingLoss", inputs=[N(4, 3), _pm1(4, 3)],
      grad_inputs=(0,)),
    L("CosineEmbeddingLoss", inputs=[N(4, 6), N(4, 6), _pm1(4)],
      grad_inputs=(0, 1)),
    L("CTCLoss", inputs=[N(7, 2, 5), I(1, 5, 2, 3), _const(
        np.array([7, 5], np.int32)), _const(np.array([3, 2], np.int32))]),
    L("TripletMarginLoss", inputs=[N(4, 5), N(4, 5), N(4, 5)]),
    L("PoissonNLLLoss", inputs=[N(4, 3), U(0, 4, 4, 3)]),
    L("HuberLoss", inputs=[N(4, 3), N(4, 3)]),
    L("HSigmoidLoss", (6, 5), inputs=[N(4, 6), I(0, 5, 4)]),
    L("AdaptiveLogSoftmaxWithLoss", (8, 10, [3, 6]),
      kwargs=dict(head_bias=True), inputs=[N(5, 8), _const(
          np.array([0, 2, 4, 6, 9], np.int32))]),
    L("RNNTLoss", inputs=[N(2, 4, 3, 5), I(1, 5, 2, 2), _const(
        np.array([4, 3], np.int32)), _const(np.array([2, 1], np.int32))]),
]
