"""Per-op AMP dtype lists: the port's own copy of
``paddle2_tpu/amp/amp_lists.py``, name for name.

White = products that gain from half-precision inputs; black =
numerically sensitive ops kept in f32. The names are the JAX package's
op names (what its dispatcher casts by), which the port's cast
mechanism (:mod:`paddle2_tpu_torch.amp`) maps its torch calls onto.
"""

WHITE_LIST = {
    "matmul", "linear", "bmm", "mm", "mv", "einsum", "conv1d", "conv2d",
    "conv3d", "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
    "addmm", "sdpa", "flash_attention", "lstm_cell", "gru_cell",
    "simple_rnn_cell", "rnn_scan",
}

BLACK_LIST = {
    "exp", "expm1", "log", "log2", "log10", "log1p", "logsumexp", "pow",
    "pow_op", "square", "reciprocal", "rsqrt", "softmax", "log_softmax",
    "cross_entropy", "nll_loss", "bce", "bce_logits", "ctc_loss", "kl_div",
    "layer_norm", "batch_norm", "instance_norm", "group_norm", "rms_norm",
    "mean", "sum", "var", "std", "norm", "dist", "cumsum", "cumprod",
    "erfinv", "atan2", "cosh", "sinh", "tan", "cholesky", "svd", "qr", "inv",
    "det", "slogdet", "solve",
}
