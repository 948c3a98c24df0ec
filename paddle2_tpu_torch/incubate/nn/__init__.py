"""Incubating nn APIs of the port: the counterpart of
``paddle2_tpu/incubate/nn/__init__.py``, with its ``__all__`` but for
``MoELayer`` (ROADMAP queue 1 item 7).

``FusedMultiHeadAttention``, ``FusedLinear`` and
``FusedTransformerEncoderLayer`` are the port's ``nn.MultiHeadAttention``,
``nn.Linear`` and ``nn.layer.transformer.TransformerEncoderLayer``, as
in the JAX package (``paddle2_tpu/incubate/nn/__init__.py:7-15``).

The four fused layers are ``nn.Module``s over :mod:`.functional`, with
the JAX package's parameter names, shapes and draws (Xavier-normal
weights by its fan rule, zero biases, unit scales, from a generator
seeded by ``seed``), so a state dict of the JAX layer loads as it is.
A parameter attribute (a ``ParamAttr``, an initializer or a name) makes
its parameter through the port's ``create_parameter`` on the layer's
device (the attribute's initializer, else Xavier-normal for a weight,
zeros for a bias, ones for a scale, drawing from ``paddle.seed``'s
generator; its learning rate, clip, regularizer, name and trainable
flag), as the reference's fused layers do; ``False`` leaves a bias or a
scale out and is refused for a weight. The JAX layers honour only
``FusedFeedForward``'s two weight attributes and drop the others
silently.
"""

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ...device import resolve_device
from ...framework import core
from ...nn import Linear as FusedLinear
from ...nn import MultiHeadAttention as FusedMultiHeadAttention
from ...nn import initializer as I
from ...nn.layer.transformer import (
    TransformerEncoderLayer as FusedTransformerEncoderLayer)
from ...ops.misc import create_parameter
from . import functional

__all__ = ["FusedMultiHeadAttention", "FusedLinear",
           "FusedTransformerEncoderLayer", "functional", "FusedDropoutAdd",
           "FusedBiasDropoutResidualLayerNorm", "FusedFeedForward",
           "FusedMultiTransformer"]


class _Params:
    """Makes the JAX layers' parameters: Xavier-normal weights with
    ``_fan_in_out``'s fans, zero biases, unit scales, drawn from one
    ``torch.Generator`` seeded by ``seed``; or, for a parameter given an
    attribute, what the port's ``create_parameter`` makes of it."""

    def __init__(self, device, dtype, seed):
        self.factory = dict(device=resolve_device(device),
                            dtype=dtype or torch.float32)
        self.gen = torch.Generator(device=self.factory["device"])
        self.gen.manual_seed(seed)

    def make(self, kind, shape, attr=None):
        """A ``kind`` ("weight", "zeros" or "ones") parameter of
        ``shape``: the seeded draw when ``attr`` is None, else
        ``create_parameter(attr=attr)`` on the layer's device."""
        if attr is None:
            return getattr(self, kind)(shape)
        if attr is False and kind == "weight":
            raise ValueError("the fused layers keep every weight: a weight "
                             "attribute cannot be False")
        default = {"weight": None, "zeros": None,
                   "ones": I.Constant(1.0)}[kind]
        with core.place_scope(self.factory["device"]):
            return create_parameter(list(shape), self.factory["dtype"],
                                    attr=attr, is_bias=kind == "zeros",
                                    default_initializer=default)

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
        mk = _Params(device, dtype, seed)
        self.dropout_rate = dropout_rate
        self.epsilon = epsilon
        # the reference's mapping: bias_attr for both biases,
        # weight_attr for the LayerNorm scale
        self.linear_bias = mk.make("zeros", [embed_dim], bias_attr)
        self.ln_scale = mk.make("ones", [embed_dim], weight_attr)
        self.ln_bias = mk.make("zeros", [embed_dim], bias_attr)

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
        mk = _Params(device, dtype, seed)
        self.normalize_before = normalize_before
        self.activation = activation
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = (act_dropout_rate
                                 if act_dropout_rate is not None
                                 else dropout_rate)
        self.epsilon = epsilon
        self.linear1_weight = mk.make("weight", [d_model, dim_feedforward],
                                      linear1_weight_attr)
        self.linear1_bias = mk.make("zeros", [dim_feedforward],
                                    linear1_bias_attr)
        self.linear2_weight = mk.make("weight", [dim_feedforward, d_model],
                                      linear2_weight_attr)
        self.linear2_bias = mk.make("zeros", [d_model], linear2_bias_attr)
        self.ln1_scale = mk.make("ones", [d_model], ln1_scale_attr)
        self.ln1_bias = mk.make("zeros", [d_model], ln1_bias_attr)
        self.ln2_scale = mk.make("ones", [d_model], ln2_scale_attr)
        self.ln2_bias = mk.make("zeros", [d_model], ln2_bias_attr)

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
# the reference's attribute argument of each list
_MT_ATTRS = {"ln_scales": "ln_scale_attrs", "ln_biases": "ln_bias_attrs",
             "qkv_weights": "qkv_weight_attrs",
             "qkv_biases": "qkv_bias_attrs",
             "linear_weights": "linear_weight_attrs",
             "linear_biases": "linear_bias_attrs",
             "ffn_ln_scales": "ffn_ln_scale_attrs",
             "ffn_ln_biases": "ffn_ln_bias_attrs",
             "ffn1_weights": "ffn1_weight_attrs",
             "ffn1_biases": "ffn1_bias_attrs",
             "ffn2_weights": "ffn2_weight_attrs",
             "ffn2_biases": "ffn2_bias_attrs"}


def _layer_attr(attrs, i, num_layers, what):
    """Layer ``i``'s attribute: one for every layer, or a list of one per
    layer (the reference's ``get_attr``)."""
    if isinstance(attrs, (list, tuple)):
        if len(attrs) != num_layers:
            raise ValueError(f"{what} has {len(attrs)} entries for "
                             f"{num_layers} layers")
        return attrs[i]
    return attrs


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
    per-kind lists (``ln_scales``, ``qkv_weights``, ...) read them.

    The reference's twelve ``*_attrs`` arguments (``ln_scale_attrs``,
    ``qkv_weight_attrs``, ...: one attribute for every layer, or a list
    of one per layer) and ``trans_qkvw`` (False lays ``qkv_w`` out as
    ``[embed_dim, 3, heads, head_dim]``) are taken; the JAX layer takes
    them and every other keyword into ``**kwargs`` and uses none. Any
    other keyword raises."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 num_layers=1, epsilon=1e-5, nranks=1, ring_id=-1,
                 name=None, *, trans_qkvw: bool = True, device=None,
                 dtype=None, seed: int = 0, **attrs):
        super().__init__()
        if not normalize_before:
            raise ValueError("FusedMultiTransformer is pre-LN only "
                             "(reference fused_transformer.py assert)")
        unknown = sorted(set(attrs) - set(_MT_ATTRS.values()))
        if unknown:
            raise TypeError(f"FusedMultiTransformer takes no options "
                            f"{unknown}")
        mk = _Params(device, dtype, seed)
        hd = embed_dim // num_heads
        self.num_layers = num_layers
        self.dropout_rate = dropout_rate
        self.activation = activation
        self.epsilon = epsilon
        self.trans_qkvw = bool(trans_qkvw)
        qkv_shape = ([3, num_heads, hd, embed_dim] if trans_qkvw
                     else [embed_dim, 3, num_heads, hd])
        make = {"ln_scale": ("ones", [embed_dim]),
                "ln_bias": ("zeros", [embed_dim]),
                "qkv_w": ("weight", qkv_shape),
                "qkv_b": ("zeros", [3, num_heads, hd]),
                "out_w": ("weight", [embed_dim, embed_dim]),
                "out_b": ("zeros", [embed_dim]),
                "ffn_ln_scale": ("ones", [embed_dim]),
                "ffn_ln_bias": ("zeros", [embed_dim]),
                "ffn1_w": ("weight", [embed_dim, dim_feedforward]),
                "ffn1_b": ("zeros", [dim_feedforward]),
                "ffn2_w": ("weight", [dim_feedforward, embed_dim]),
                "ffn2_b": ("zeros", [embed_dim])}
        arg_of = {tag: _MT_ATTRS[lst] for lst, tag in _MT_LISTS.items()}
        for i in range(num_layers):
            for tag, (kind, shape) in make.items():
                attr = _layer_attr(attrs.get(arg_of[tag]), i, num_layers,
                                   arg_of[tag])
                self.register_parameter(f"l{i}_{tag}",
                                        mk.make(kind, shape, attr))

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
            training=self.training, trans_qkvw=self.trans_qkvw,
            generator=generator)


for _name, _tag in _MT_LISTS.items():
    setattr(FusedMultiTransformer, _name, _layer_list(_tag))
del _name, _tag
