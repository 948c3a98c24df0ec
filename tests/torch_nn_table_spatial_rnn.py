"""The case tables of the conv, pooling, vision-op and recurrent parts
of ``paddle.nn`` (see ``torch_core_cases`` and ``torch_nn_table_layers``),
JAX-free like the other tables, so that the card runs them too:

- ``CONV``, ``POOL``, ``VISION_OPS``: ``paddle.nn.functional``'s
  convolutions (``test_torch_nn_conv.py``), pools
  (``test_torch_nn_pooling.py``) and ``affine_grid``/``grid_sample``
  (``test_torch_nn_vision_ops.py``), by their dotted path;
- ``CONV_LAYERS``, ``POOL_LAYERS``, ``RNN_LAYERS``: the layers, built in
  both packages from the same arguments (the RNN ones in
  ``test_torch_nn_rnn.py``).

Each case names the JAX package's rule it holds beside it. Tolerances
beyond ``TOL`` are stated beside the case, with the reason.
"""

import numpy as np

from torch_core_cases import Case, N, args
from torch_nn_table_layers import BOTH, L

# a bfloat16 convolution or pool sums rounded products in another order
# than XLA (torch accumulates in f32 inside the kernel): within two
# bfloat16 steps of the largest magnitude
BF16_SUM = {"bfloat16": dict(rtol=2e-2, atol=4e-2)}
# a convolution's gradients sum every output position's products: in
# f32 the two frameworks' orders leave 1e-6 of the largest magnitude
# (~20 here) on the small elements; in bf16 a bias or weight gradient
# of magnitude up to ~50 lands within one bf16 step (2**-8 relative) of
# that magnitude, and an element that cancels near zero keeps only that
CONV_TOL = {"float32": dict(rtol=1e-5, atol=2e-5),
            "bfloat16": dict(rtol=2e-2, atol=2e-1)}
# an RNN carries rounded bfloat16 states through every step, and each
# framework rounds its gates at different places
RNN_BF16 = {"bfloat16": dict(rtol=4e-2, atol=8e-2)}
# a bfloat16 layer that starts from the default float32 states computes
# in float32 after its bfloat16 input products (the promotion JAX
# applies); those products round to bfloat16 at different places, which
# moves the f32 outputs (|h| < 0.3 here) by up to 1.2e-4
PROMOTED = {"float32": dict(rtol=1e-2, atol=1e-3), **RNN_BF16}


def fn(name):
    return "nn.functional." + name


def _c(name, make, label="", dtypes=BOTH, tol=BF16_SUM, **kw):
    return Case(fn(name), make, label=label, dtypes=dtypes, tol=tol, **kw)


def _conv(name, make, label="", **kw):
    return _c(name, make, label, tol=CONV_TOL, **kw)


def _binary(*shape):
    """Values in {0, 1}: a window of them ties often."""
    return lambda rng: (rng.random(shape) < 0.5).astype(np.float32)


def _grid(*shape):
    """Sampling coordinates a little past [-1, 1], so that corners fall
    outside the image."""
    return lambda rng: rng.uniform(-1.2, 1.2, size=shape).astype(np.float32)


def _mask_of(x, kernel, stride=None, padding=0):
    """The flat argmax indices a max pool with ``return_mask`` gives on
    ``x`` (NC-first, non-overlapping windows), to drive ``max_unpool``."""
    n = x.ndim - 2
    k = (kernel,) * n
    s = k if stride is None else (stride,) * n
    outs = [(x.shape[2 + i] + 2 * padding - k[i]) // s[i] + 1
            for i in range(n)]
    mask = np.zeros(x.shape[:2] + tuple(outs), np.int32)
    for pos in np.ndindex(*outs):
        best, where = None, None
        for tap in np.ndindex(*k):
            c = [pos[i] * s[i] + tap[i] - padding for i in range(n)]
            if any(ci < 0 or ci >= x.shape[2 + i] for i, ci in enumerate(c)):
                continue
            v = x[(slice(None), slice(None)) + tuple(c)]
            flat = 0
            for i in range(n):
                flat = flat * x.shape[2 + i] + c[i]
            if best is None:
                best, where = v.copy(), np.full(v.shape, flat, np.int32)
            else:
                better = v > best
                best = np.where(better, v, best)
                where = np.where(better, flat, where)
        mask[(slice(None), slice(None)) + pos] = where
    return mask


def _unpool_args(shape, kernel, stride=None, padding=0):
    """Pooled values and their mask from a random input of ``shape``."""
    def make(rng):
        x = rng.standard_normal(shape).astype(np.float32)
        mask = _mask_of(x, kernel, stride, padding)
        vals = rng.standard_normal(mask.shape).astype(np.float32)
        return [vals, mask]
    return make


def _unpool_inputs(shape, seed):
    """``[values, mask]`` makers for a ``MaxUnPool`` layer: the mask of a
    2-window max pool over an input of ``shape`` drawn from ``seed``."""
    return [lambda rng: _unpool_args(shape, 2)(rng)[0],
            lambda rng: _unpool_args(shape, 2)(
                np.random.default_rng(seed))[1]]


# ------------------------------------------------------------------ conv
CONV = [
    _conv("conv1d", args(N(2, 4, 9), N(6, 4, 3), N(6))),
    # "NCL" is channels first; any other string is channels last
    _conv("conv1d", args(N(2, 9, 4), N(6, 4, 3)), label="nlc",
       kwargs=dict(data_format="NLC", padding=1)),
    _conv("conv1d", args(N(2, 4, 9), N(6, 2, 3)), label="groups_same",
       kwargs=dict(groups=2, padding="SAME", stride=2, dilation=2)),
    _conv("conv1d", args(N(2, 4, 9), N(6, 4, 3)), label="uneven",
       kwargs=dict(padding=[2, 0], stride=2)),
    _conv("conv3d", args(N(2, 3, 5, 6, 4), N(4, 3, 3, 2, 2), N(4))),
    _conv("conv3d", args(N(2, 5, 6, 4, 3), N(4, 3, 3, 2, 2)), label="ndhwc",
       kwargs=dict(data_format="NDHWC", padding=1, stride=2)),
    _conv("conv3d", args(N(1, 4, 5, 5, 5), N(4, 2, 3, 3, 3)),
       label="groups_valid", kwargs=dict(groups=2, padding="VALID")),
    _conv("conv2d", args(N(2, 3, 7, 6), N(4, 3, 3, 3)), label="uneven",
       kwargs=dict(padding=[1, 0, 2, 1])),
    # transposes: symmetric padding within torch's rule
    _conv("conv1d_transpose", args(N(2, 4, 5), N(4, 3, 3), N(3)),
       kwargs=dict(stride=2, padding=1, output_padding=1)),
    # uneven padding: the full transpose, then a crop at each end
    _conv("conv2d_transpose", args(N(2, 4, 5, 4), N(4, 3, 3, 3), N(3)),
       label="uneven", kwargs=dict(stride=2, padding=[0, 1, 1, 2],
                                   output_padding=1)),
    # output_padding at the stride: zeros appended before the bias
    _conv("conv2d_transpose", args(N(1, 2, 3, 3), N(2, 3, 2, 2), N(3)),
       label="outpad_past_stride",
       kwargs=dict(stride=2, padding=0, output_padding=[2, 3])),
    # padding past the dilated kernel: a crop deeper than the border
    _conv("conv1d_transpose", args(N(1, 2, 7), N(2, 3, 2)),
       label="deep_crop", kwargs=dict(stride=1, padding=2)),
    _conv("conv2d_transpose", args(N(2, 4, 4, 5), N(4, 3, 3, 2)),
       label="groups", kwargs=dict(groups=2, stride=(2, 1), padding=1,
                                   dilation=(1, 2))),
    _conv("conv2d_transpose", args(N(2, 4, 5, 4), N(4, 3, 3, 3)), label="nhwc",
       kwargs=dict(stride=2, padding=1, data_format="NHWC")),
    # a string padding at stride 1: a plain convolution with the flipped
    # kernel ("SAME" keeps the size, "VALID" shrinks it)
    _conv("conv1d_transpose", args(N(2, 4, 5), N(4, 3, 3), N(3)),
       label="same_stride1", kwargs=dict(padding="SAME")),
    _conv("conv1d_transpose", args(N(2, 4, 5), N(4, 3, 3)),
       label="valid_stride1", kwargs=dict(padding="VALID")),
    _conv("conv2d_transpose", args(N(1, 4, 5, 5), N(4, 2, 3, 3)),
       label="same_groups", kwargs=dict(padding="SAME", groups=2,
                                        output_padding=1)),
    _conv("conv3d_transpose", args(N(1, 4, 3, 4, 3), N(4, 2, 2, 3, 2), N(2)),
       kwargs=dict(stride=2, padding=[1, 0, 0, 1, 1, 1])),
    _conv("conv3d_transpose", args(N(1, 3, 4, 3, 4), N(4, 2, 2, 2, 3)),
       label="ndhwc", kwargs=dict(stride=1, padding=1,
                                  data_format="NDHWC")),
]

# ---------------------------------------------------------------- pooling
IMG = (2, 3, 7, 6)
POOL = [
    _c("avg_pool1d", args(N(2, 3, 9)), kwargs=dict(kernel_size=3, stride=2)),
    # exclusive (the default) divides by the unpadded count; the
    # ceil_mode extension counts as padding
    _c("avg_pool1d", args(N(2, 3, 9)), label="pad_ceil_exclusive",
       kwargs=dict(kernel_size=3, stride=2, padding=1, ceil_mode=True)),
    _c("avg_pool1d", args(N(2, 3, 9)), label="pad_ceil_inclusive",
       kwargs=dict(kernel_size=3, stride=2, padding=1, ceil_mode=True,
                   exclusive=False)),
    _c("avg_pool2d", args(N(*IMG)), kwargs=dict(kernel_size=2, stride=2)),
    _c("avg_pool2d", args(N(*IMG)), label="pad_ceil_exclusive",
       kwargs=dict(kernel_size=3, stride=2, padding=1, ceil_mode=True)),
    _c("avg_pool2d", args(N(*IMG)), label="uneven_inclusive",
       kwargs=dict(kernel_size=(3, 2), stride=(2, 1), padding=[1, 0, 0, 1],
                   exclusive=False)),
    # a string padding divides by the whole window whatever exclusive says
    _c("avg_pool2d", args(N(*IMG)), label="same_exclusive",
       kwargs=dict(kernel_size=3, stride=2, padding="SAME")),
    # the Inception branch: 3x3, stride 1, padding 1, exclusive
    _c("avg_pool2d", args(N(*IMG)), label="inception",
       kwargs=dict(kernel_size=3, stride=1, padding=1)),
    _c("avg_pool2d", args(N(2, 7, 6, 3)), label="nhwc_divisor",
       kwargs=dict(kernel_size=2, padding=1, data_format="NHWC",
                   divisor_override=7)),
    _c("avg_pool3d", args(N(2, 2, 5, 4, 5)), label="pad_ceil",
       kwargs=dict(kernel_size=2, stride=2, padding=1, ceil_mode=True)),
    _c("max_pool1d", args(N(2, 3, 9)),
       kwargs=dict(kernel_size=3, stride=2, padding=1)),
    _c("max_pool2d", args(N(*IMG)), label="ceil",
       kwargs=dict(kernel_size=3, stride=2, ceil_mode=True)),
    # a tie's gradient goes to the first tap (reduce_window)
    _c("max_pool2d", args(_binary(*IMG)), label="ties",
       kwargs=dict(kernel_size=2, stride=1)),
    _c("max_pool2d", args(N(2, 7, 6, 3)), label="nhwc_same",
       kwargs=dict(kernel_size=3, stride=2, padding="SAME",
                   data_format="NHWC")),
    _c("max_pool3d", args(N(2, 2, 5, 4, 5)),
       kwargs=dict(kernel_size=2, stride=2, padding=[0, 1, 1, 0, 0, 1])),
    # the mask: flat indices into the input plane, the first tap at the
    # max; the gradient split equally among tied taps
    _c("max_pool2d", args(N(*IMG)), label="mask",
       kwargs=dict(kernel_size=3, stride=2, padding=1, return_mask=True)),
    _c("max_pool2d", args(_binary(*IMG)), label="mask_ties",
       kwargs=dict(kernel_size=2, stride=1, return_mask=True)),
    _c("max_pool2d", args(_binary(*IMG)), label="mask_ceil_ties",
       kwargs=dict(kernel_size=3, stride=2, ceil_mode=True,
                   return_mask=True)),
    _c("max_pool1d", args(_binary(2, 3, 9)), label="mask_ties",
       kwargs=dict(kernel_size=3, stride=2, padding=1, return_mask=True)),
    _c("max_pool3d", args(_binary(1, 2, 4, 5, 4)), label="mask_ties",
       kwargs=dict(kernel_size=2, stride=1, return_mask=True)),
    _c("adaptive_avg_pool1d", args(N(2, 3, 10)), kwargs=dict(output_size=4)),
    _c("adaptive_avg_pool3d", args(N(2, 2, 5, 6, 7)),
       kwargs=dict(output_size=(2, 3, 4))),
    _c("adaptive_avg_pool3d", args(N(2, 5, 6, 7, 2)), label="ndhwc",
       kwargs=dict(output_size=3, data_format="NDHWC")),
    _c("adaptive_max_pool1d", args(_binary(2, 3, 10)), label="ties",
       kwargs=dict(output_size=4)),
    _c("adaptive_max_pool2d", args(_binary(*IMG)), label="ties",
       kwargs=dict(output_size=(3, 2))),
    # return_mask gives (out, None)
    _c("adaptive_max_pool2d", args(N(*IMG)), label="mask_none",
       kwargs=dict(output_size=3, return_mask=True)),
    _c("adaptive_max_pool3d", args(N(2, 2, 5, 6, 7)),
       kwargs=dict(output_size=(2, 3, 4))),
    _c("lp_pool1d", args(N(2, 3, 9)), kwargs=dict(norm_type=2,
                                                   kernel_size=3, stride=2)),
    _c("lp_pool2d", args(N(*IMG)), kwargs=dict(norm_type=3, kernel_size=2,
                                               ceil_mode=True)),
    _c("max_unpool1d", _unpool_args((2, 3, 8), 2), grad_args=(0,),
       kwargs=dict(kernel_size=2)),
    _c("max_unpool2d", _unpool_args((2, 3, 6, 8), 2), grad_args=(0,),
       kwargs=dict(kernel_size=2)),
    _c("max_unpool2d", _unpool_args((2, 3, 6, 8), 2), label="output_size",
       grad_args=(0,), kwargs=dict(kernel_size=2, output_size=(7, 9))),
    _c("max_unpool3d", _unpool_args((1, 2, 4, 4, 6), 2), grad_args=(0,),
       kwargs=dict(kernel_size=2)),
    # random_u given: the two packages draw different numbers
    _c("fractional_max_pool2d", args(N(2, 3, 9, 8)),
       kwargs=dict(output_size=(4, 3), random_u=0.3)),
    _c("fractional_max_pool2d", args(_binary(2, 3, 9, 8)),
       label="kernel_mask",
       kwargs=dict(output_size=4, kernel_size=3, random_u=0.7,
                   return_mask=True)),
    _c("fractional_max_pool3d", args(N(1, 2, 6, 5, 7)),
       kwargs=dict(output_size=(3, 2, 4), random_u=0.45, return_mask=True)),
]

# ------------------------------------------------------------ vision ops
VISION_OPS = [
    _c("affine_grid", args(N(2, 2, 3)), kwargs=dict(out_shape=[2, 3, 4, 5])),
    _c("affine_grid", args(N(2, 2, 3)), label="corners_off",
       kwargs=dict(out_shape=[2, 3, 5, 4], align_corners=False)),
    _c("grid_sample", args(N(2, 3, 5, 6), _grid(2, 4, 3, 2))),
    _c("grid_sample", args(N(2, 3, 5, 6), _grid(2, 4, 3, 2)),
       label="corners_off", kwargs=dict(align_corners=False)),
    _c("grid_sample", args(N(2, 3, 5, 6), _grid(2, 4, 3, 2)),
       label="border", kwargs=dict(padding_mode="border")),
    # "reflection" clamps each corner as "border" does
    _c("grid_sample", args(N(2, 3, 5, 6), _grid(2, 4, 3, 2)),
       label="reflection", kwargs=dict(padding_mode="reflection")),
    # nearest rounds half to even; no gradient reaches the grid (the JAX
    # package's is all zeros, the port's none: held in the test file)
    _c("grid_sample", args(N(2, 3, 5, 5), lambda rng: (rng.integers(
        -4, 5, size=(2, 4, 3, 2)) / 4.0).astype(np.float32)),
       label="nearest_halves", grad_args=(0,), kwargs=dict(mode="nearest")),
]

# ---------------------------------------------------------------- layers
X1 = N(2, 4, 9)
X3 = N(2, 3, 5, 4, 5)
CONV_LAYERS = [
    L("Conv1D", (4, 6, 3), dict(padding=1, stride=2), inputs=[X1],
      dtypes=BOTH, tol=CONV_TOL),
    L("Conv1D", (4, 6, 3), dict(groups=2, bias_attr=False,
                                data_format="NLC"),
      inputs=[N(2, 9, 4)], label="nlc_groups", tol=CONV_TOL),
    L("Conv3D", (3, 4, 2), dict(padding="SAME"), inputs=[X3], dtypes=BOTH,
      tol=CONV_TOL),
    L("Conv1DTranspose", (4, 3, 3), dict(stride=2, padding=1,
                                         output_padding=1),
      inputs=[N(2, 4, 5)], dtypes=BOTH, tol=CONV_TOL),
    L("Conv2DTranspose", (4, 6, 3), dict(stride=2, padding=[0, 1, 1, 0],
                                         groups=2),
      inputs=[N(2, 4, 4, 5)], dtypes=BOTH, tol=CONV_TOL),
    L("Conv3DTranspose", (3, 2, 2), dict(stride=2),
      inputs=[N(1, 3, 3, 2, 3)], tol=CONV_TOL),
]

POOL_LAYERS = [
    L("AvgPool1D", (3, 2, 1), dict(ceil_mode=True), inputs=[N(2, 3, 9)]),
    L("AvgPool2D", (2, 2), inputs=[N(*IMG)], dtypes=BOTH, tol=BF16_SUM),
    L("AvgPool2D", (3, 1, 1), dict(exclusive=False), inputs=[N(*IMG)],
      label="inclusive"),
    L("AvgPool3D", (2,), dict(stride=1, padding=1), inputs=[N(1, 2, 3, 4, 3)]),
    L("MaxPool1D", (3, 2), inputs=[N(2, 3, 9)]),
    L("MaxPool2D", (3, 2), dict(ceil_mode=True), inputs=[N(*IMG)],
      dtypes=BOTH),
    L("MaxPool2D", (2, 2), dict(return_mask=True), inputs=[_binary(*IMG)],
      label="mask"),
    L("MaxPool3D", (2, 2), inputs=[N(1, 2, 4, 4, 5)]),
    L("AdaptiveAvgPool1D", (3,), inputs=[N(2, 3, 8)]),
    L("AdaptiveAvgPool2D", ((2, 3),), dict(data_format="NHWC"),
      inputs=[N(2, 7, 6, 3)]),
    L("AdaptiveAvgPool3D", (2,), inputs=[N(1, 2, 5, 4, 3)]),
    L("AdaptiveMaxPool1D", (3,), inputs=[N(2, 3, 8)]),
    L("AdaptiveMaxPool2D", ((3, 2),), dict(return_mask=True),
      inputs=[N(*IMG)]),
    L("AdaptiveMaxPool3D", (2,), inputs=[N(1, 2, 5, 4, 3)]),
    L("LPPool1D", (2, 3), inputs=[N(2, 3, 9)]),
    L("LPPool2D", (2.5, 2), dict(stride=1), inputs=[N(*IMG)]),
    L("MaxUnPool1D", (2,), inputs=_unpool_inputs((2, 3, 8), 1),
      grad_inputs=(0,)),
    L("MaxUnPool2D", (2,), inputs=_unpool_inputs((2, 3, 4, 6), 2),
      grad_inputs=(0,)),
    L("MaxUnPool3D", (2,), inputs=_unpool_inputs((1, 2, 4, 4, 6), 3),
      grad_inputs=(0,)),
    L("FractionalMaxPool2D", ((4, 3),), dict(random_u=0.4),
      inputs=[N(2, 3, 9, 8)]),
    L("FractionalMaxPool3D", (3,), dict(kernel_size=2, random_u=0.6,
                                        return_mask=True),
      inputs=[N(1, 2, 6, 5, 7)]),
]

SEQ = N(3, 5, 4)            # [batch, time, input]
RNN_LAYERS = [
    L("SimpleRNNCell", (4, 6), inputs=[N(3, 4), N(3, 6)], dtypes=BOTH,
      tol=RNN_BF16),
    L("SimpleRNNCell", (4, 6), dict(activation="relu"), inputs=[N(3, 4)],
      label="relu_default_state"),
    L("GRUCell", (4, 6), inputs=[N(3, 4), N(3, 6)], dtypes=BOTH,
      tol=RNN_BF16),
    L("LSTMCell", (4, 6), inputs=[N(3, 4)], label="default_state"),
    L("SimpleRNN", (4, 6), dict(num_layers=2), inputs=[SEQ]),
    L("SimpleRNN", (4, 6), dict(activation="relu", time_major=True),
      inputs=[N(5, 3, 4)], label="relu_time_major"),
    L("GRU", (4, 6), dict(direction="bidirect"), inputs=[SEQ]),
    L("GRU", (4, 6), dict(direction="bidirect"), inputs=[SEQ],
      dtypes=("bfloat16",), tol=PROMOTED, label="promoted"),
    # packed initial states [layers * directions, batch, hidden]
    L("GRU", (4, 6), dict(num_layers=2, direction="bidirectional"),
      inputs=[SEQ, N(4, 3, 6)], label="packed_states"),
    L("LSTM", (4, 6), dict(num_layers=2), inputs=[SEQ]),
    L("LSTM", (4, 6), dict(num_layers=2), inputs=[SEQ],
      dtypes=("bfloat16",), tol=PROMOTED, label="promoted"),
    L("LSTM", (4, 6), dict(num_layers=2, time_major=True,
                           direction="bidirect", proj_size=3),
      inputs=[N(5, 3, 4), lambda rng: [rng.standard_normal(
          (4, 3, 6)).astype(np.float32) for _ in range(2)]],
      label="bidirect_time_major_packed"),
    # dropout between layers only; eval mode is deterministic
    L("LSTM", (4, 6), dict(num_layers=3, dropout=0.5), inputs=[SEQ],
      train=False, label="dropout_eval"),
]
