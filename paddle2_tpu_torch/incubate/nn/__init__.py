"""Incubating nn APIs of the port: the counterpart of
``paddle2_tpu/incubate/nn/__init__.py``.

The four fused layers are ``nn.Module``s over
:mod:`.functional`, with the JAX package's parameter names, shapes and
draws (Xavier-normal weights by its fan rule, zero biases, unit
scales), so a state dict of the JAX layer loads as it is. Parameter
attributes other than None are ROADMAP queue 1 item 2. The layers the
JAX module aliases (``FusedMultiHeadAttention``, ``FusedLinear``,
``FusedTransformerEncoderLayer``, ``MoELayer``) wait for the port of the
layers they alias (ROADMAP queue 1 items 2 and 7).
"""

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ...device import resolve_device
from . import functional

__all__ = ["functional", "FusedDropoutAdd",
           "FusedBiasDropoutResidualLayerNorm", "FusedFeedForward",
           "FusedMultiTransformer"]


def _no_attrs(*attrs):
    if any(a is not None for a in attrs):
        raise NotImplementedError("parameter attributes are not ported "
                                  "(ROADMAP queue 1 item 2)")


class _Params:
    """Makes the JAX layers' parameters: Xavier-normal weights with
    ``_fan_in_out``'s fans, zero biases, unit scales, drawn from one
    ``torch.Generator`` seeded by ``seed``."""

    def __init__(self, device, dtype, seed):
        self.factory = dict(device=resolve_device(device),
                            dtype=dtype or torch.float32)
        self.gen = torch.Generator(device=self.factory["device"])
        self.gen.manual_seed(seed)

    def weight(self, shape):
        if len(shape) == 2:
            fi, fo = shape
        else:
            rec = int(np.prod(shape[2:]))
            fi, fo = shape[1] * rec, shape[0] * rec
        w = torch.randn(shape, generator=self.gen, **self.factory)
        return nn.Parameter(w * math.sqrt(2.0 / (fi + fo)))

    def zeros(self, shape):
        return nn.Parameter(torch.zeros(shape, **self.factory))

    def ones(self, shape):
        return nn.Parameter(torch.ones(shape, **self.factory))


class FusedDropoutAdd(nn.Module):
    """``dropout(x) + y`` (:func:`functional.fused_dropout_add`)."""

    def __init__(self, p=0.5, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, x, y, generator: Optional[torch.Generator] = None):
        return functional.fused_dropout_add(x, y, p=self.p,
                                            training=self.training,
                                            mode=self.mode,
                                            generator=generator)


class FusedBiasDropoutResidualLayerNorm(nn.Module):
    """``LayerNorm(residual + dropout(x + linear_bias))`` with
    ``linear_bias``, ``ln_scale`` and ``ln_bias`` ``[embed_dim]``."""

    def __init__(self, embed_dim, dropout_rate=0.5, weight_attr=None,
                 bias_attr=None, epsilon=1e-5, name=None, *, device=None,
                 dtype=None, seed: int = 0):
        super().__init__()
        _no_attrs(weight_attr, bias_attr)
        mk = _Params(device, dtype, seed)
        self.dropout_rate = dropout_rate
        self.epsilon = epsilon
        self.linear_bias = mk.zeros([embed_dim])
        self.ln_scale = mk.ones([embed_dim])
        self.ln_bias = mk.zeros([embed_dim])

    def forward(self, x, residual,
                generator: Optional[torch.Generator] = None):
        return functional.fused_bias_dropout_residual_layer_norm(
            x, residual, bias=self.linear_bias, ln_scale=self.ln_scale,
            ln_bias=self.ln_bias, dropout_rate=self.dropout_rate,
            ln_epsilon=self.epsilon, training=self.training,
            generator=generator)


class FusedFeedForward(nn.Module):
    """The transformer FFN block (:func:`functional.fused_feedforward`):
    ``linear1_weight [d_model, dim_feedforward]``, ``linear2_weight
    [dim_feedforward, d_model]``, their biases, and two LayerNorms'
    scales and biases ``[d_model]``."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None,
                 ln2_bias_attr=None, nranks=1, ring_id=-1, name=None, *,
                 device=None, dtype=None, seed: int = 0):
        super().__init__()
        _no_attrs(linear1_weight_attr, linear1_bias_attr,
                  linear2_weight_attr, linear2_bias_attr, ln1_scale_attr,
                  ln1_bias_attr, ln2_scale_attr, ln2_bias_attr)
        mk = _Params(device, dtype, seed)
        self.normalize_before = normalize_before
        self.activation = activation
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = (act_dropout_rate
                                 if act_dropout_rate is not None
                                 else dropout_rate)
        self.epsilon = epsilon
        self.linear1_weight = mk.weight([d_model, dim_feedforward])
        self.linear1_bias = mk.zeros([dim_feedforward])
        self.linear2_weight = mk.weight([dim_feedforward, d_model])
        self.linear2_bias = mk.zeros([d_model])
        self.ln1_scale = mk.ones([d_model])
        self.ln1_bias = mk.zeros([d_model])
        self.ln2_scale = mk.ones([d_model])
        self.ln2_bias = mk.zeros([d_model])

    def forward(self, src, cache=None,
                generator: Optional[torch.Generator] = None):
        return functional.fused_feedforward(
            src, self.linear1_weight, self.linear2_weight,
            self.linear1_bias, self.linear2_bias,
            ln1_scale=self.ln1_scale, ln1_bias=self.ln1_bias,
            ln2_scale=self.ln2_scale, ln2_bias=self.ln2_bias,
            dropout1_rate=self.act_dropout_rate,
            dropout2_rate=self.dropout_rate, activation=self.activation,
            pre_layer_norm=self.normalize_before, ln1_epsilon=self.epsilon,
            ln2_epsilon=self.epsilon, training=self.training,
            generator=generator)


# the per-kind lists of FusedMultiTransformer -> the tag of each layer's
# parameter in them, in the JAX layer's order
_MT_LISTS = {"ln_scales": "ln_scale", "ln_biases": "ln_bias",
             "qkv_weights": "qkv_w", "qkv_biases": "qkv_b",
             "linear_weights": "out_w", "linear_biases": "out_b",
             "ffn_ln_scales": "ffn_ln_scale", "ffn_ln_biases": "ffn_ln_bias",
             "ffn1_weights": "ffn1_w", "ffn1_biases": "ffn1_b",
             "ffn2_weights": "ffn2_w", "ffn2_biases": "ffn2_b"}


def _layer_list(tag):
    return property(lambda self: [getattr(self, f"l{i}_{tag}")
                                  for i in range(self.num_layers)])


class FusedMultiTransformer(nn.Module):
    """A pre-LN decoder stack (:func:`functional.fused_multi_transformer`)
    whose layer ``i`` holds ``l{i}_ln_scale``, ``l{i}_ln_bias``,
    ``l{i}_qkv_w [3, heads, head_dim, embed_dim]``, ``l{i}_qkv_b``,
    ``l{i}_out_w``, ``l{i}_out_b``, ``l{i}_ffn_ln_scale``,
    ``l{i}_ffn_ln_bias``, ``l{i}_ffn1_w``, ``l{i}_ffn1_b``,
    ``l{i}_ffn2_w`` and ``l{i}_ffn2_b``, as the JAX layer names them; the
    per-kind lists (``ln_scales``, ``qkv_weights``, ...) read them."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 num_layers=1, epsilon=1e-5, nranks=1, ring_id=-1,
                 name=None, *, device=None, dtype=None, seed: int = 0,
                 **kwargs):
        super().__init__()
        if not normalize_before:
            raise ValueError("FusedMultiTransformer is pre-LN only "
                             "(reference fused_transformer.py assert)")
        if kwargs:
            raise NotImplementedError(
                f"FusedMultiTransformer options {sorted(kwargs)} are not "
                f"ported (ROADMAP queue 1 item 2)")
        mk = _Params(device, dtype, seed)
        hd = embed_dim // num_heads
        self.num_layers = num_layers
        self.dropout_rate = dropout_rate
        self.activation = activation
        self.epsilon = epsilon
        make = {"ln_scale": (mk.ones, [embed_dim]),
                "ln_bias": (mk.zeros, [embed_dim]),
                "qkv_w": (mk.weight, [3, num_heads, hd, embed_dim]),
                "qkv_b": (mk.zeros, [3, num_heads, hd]),
                "out_w": (mk.weight, [embed_dim, embed_dim]),
                "out_b": (mk.zeros, [embed_dim]),
                "ffn_ln_scale": (mk.ones, [embed_dim]),
                "ffn_ln_bias": (mk.zeros, [embed_dim]),
                "ffn1_w": (mk.weight, [embed_dim, dim_feedforward]),
                "ffn1_b": (mk.zeros, [dim_feedforward]),
                "ffn2_w": (mk.weight, [dim_feedforward, embed_dim]),
                "ffn2_b": (mk.zeros, [embed_dim])}
        for i in range(num_layers):
            for tag, (fn, shape) in make.items():
                self.register_parameter(f"l{i}_{tag}", fn(shape))

    def forward(self, src, attn_mask=None, caches=None, time_step=None,
                generator: Optional[torch.Generator] = None):
        if caches is not None or time_step is not None:
            raise NotImplementedError(
                "FusedMultiTransformer caches/time_step are a decode path; "
                "use paddle2_tpu_torch.serving.ServingEngine")
        return functional.fused_multi_transformer(
            src, self.ln_scales, self.ln_biases, self.qkv_weights,
            self.qkv_biases, self.linear_weights, self.linear_biases,
            self.ffn_ln_scales, self.ffn_ln_biases, self.ffn1_weights,
            self.ffn1_biases, self.ffn2_weights, self.ffn2_biases,
            attn_mask=attn_mask, dropout_rate=self.dropout_rate,
            activation=self.activation, epsilon=self.epsilon,
            training=self.training, generator=generator)


for _name, _tag in _MT_LISTS.items():
    setattr(FusedMultiTransformer, _name, _layer_list(_tag))
del _name, _tag
