"""ERNIE/BERT-style encoder: the port of ``paddle2_tpu/models/ernie.py``
(BASELINE config 2, ERNIE-3.0-base SST-2 fine-tuning).

Same architecture and attribute names as the JAX package (word +
position + optional token-type embeddings, a post-LN encoder with a
``(q|k|v)``-thirds fused projection and exact-erf GELU, a ``tanh``
pooler over the first token, a classification head), as
``torch.nn.Module``s, so a JAX state dict maps onto this one name for
name (:func:`~.convert.ernie_state_from_reference`).

Attention runs through
:func:`paddle2_tpu_torch.kernels.scaled_dot_product_attention`: without
a mask and without dropout it launches the CUDA flash kernels; a padding
``attention_mask`` (or attention dropout in training) takes the plain
counterpart of the JAX package's XLA softmax. LayerNorm is
:class:`paddle2_tpu_torch.nn.LayerNorm`, which takes the fused LayerNorm
kernels under ``FLAGS_pallas_layer_norm``.

``stacked_blocks`` stores the encoder as ``[L, ...]`` leaves
(:mod:`._scan`). Torch has no scan, so stacked or not the layers run as
a Python loop, with or without a mask; the JAX package's
``layer_slice_call`` route for a mask is the same loop here, passing
``attn_bias`` to each block.

Initialisation matches the JAX package's distributions: Normal(0, 0.02)
for every projection and embedding, zero biases, unit LayerNorm scales,
drawn from an explicit ``torch.Generator`` seeded by ``seed``. The two
frameworks draw different numbers from one seed; tests carry weights
across with :func:`~.convert.ernie_state_from_reference`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..device import resolve_device
from ..kernels.attention import scaled_dot_product_attention
from ..nn import LayerNorm
from ._scan import StackedLayerStack
from .gpt import _cross_entropy, _layer_norm

__all__ = ["ErnieConfig", "ErnieSelfAttention", "ErnieLayer", "ErnieModel",
           "ErnieForSequenceClassification", "ernie3_base", "ernie_tiny"]


@dataclass
class ErnieConfig:
    vocab_size: int = 40000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None      # default 4*hidden
    max_position_embeddings: int = 2048
    type_vocab_size: int = 4
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    layer_norm_epsilon: float = 1e-12
    num_classes: int = 2
    # one [L, ...] parameter per encoder-block leaf (models/_scan.py)
    stacked_blocks: bool = False

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


class ErnieSelfAttention(nn.Module):
    def __init__(self, cfg: ErnieConfig, **factory):
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        self.qkv = nn.Linear(h, 3 * h, **factory)
        self.out = nn.Linear(h, h, **factory)

    def forward(self, x, attn_bias=None):
        cfg = self.cfg
        b, s, h = x.shape
        # (q|k|v) thirds, as the JAX model lays them out
        q, k, v = self.qkv(x).reshape(b, s, 3, cfg.num_heads,
                                      cfg.head_dim).unbind(2)
        o = scaled_dot_product_attention(
            q, k, v, attn_mask=attn_bias, is_causal=False,
            dropout_p=cfg.attention_dropout_prob, training=self.training)
        return self.out(o.reshape(b, s, h))


class ErnieLayer(nn.Module):
    """Post-LN encoder block (BERT/ERNIE convention)."""

    def __init__(self, cfg: ErnieConfig, **factory):
        super().__init__()
        eps = cfg.layer_norm_epsilon
        self.attn = ErnieSelfAttention(cfg, **factory)
        self.ln_1 = _layer_norm(cfg.hidden_size, eps, **factory)
        self.up = nn.Linear(cfg.hidden_size, cfg.ffn_size, **factory)
        self.down = nn.Linear(cfg.ffn_size, cfg.hidden_size, **factory)
        self.ln_2 = _layer_norm(cfg.hidden_size, eps, **factory)
        self.drop = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, x, attn_bias=None):
        x = self.ln_1(x + self.drop(self.attn(x, attn_bias)))
        # exact erf GELU, as the JAX package's F.gelu
        return self.ln_2(x + self.drop(self.down(F.gelu(self.up(x)))))


class ErnieModel(nn.Module):
    def __init__(self, cfg: ErnieConfig, **factory):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.word_emb = nn.Embedding(cfg.vocab_size, h, **factory)
        self.pos_emb = nn.Embedding(cfg.max_position_embeddings, h,
                                    **factory)
        self.type_emb = nn.Embedding(cfg.type_vocab_size, h, **factory)
        self.emb_ln = _layer_norm(h, cfg.layer_norm_epsilon, **factory)
        self.drop = nn.Dropout(cfg.hidden_dropout_prob)
        self.layers = nn.ModuleList(ErnieLayer(cfg, **factory)
                                    for _ in range(cfg.num_layers))
        self.pooler = nn.Linear(h, h, **factory)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """``(sequence output [b, s, h], pooled [b, h])``.
        ``attention_mask`` ``[b, s]`` is 1 (or True) for the tokens to
        attend to."""
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = self.word_emb(input_ids) + self.pos_emb(pos)
        if token_type_ids is not None:
            x = x + self.type_emb(token_type_ids)
        x = self.drop(self.emb_ln(x))
        attn_bias = None
        if attention_mask is not None:
            m = torch.as_tensor(attention_mask, device=x.device)
            # the finite minimum of the ACTIVATION dtype: f32's minimum
            # cast to bf16 overflows to -inf, which makes a fully masked
            # row's softmax NaN
            attn_bias = torch.where(m[:, None, None, :].bool(), 0.0,
                                    torch.finfo(x.dtype).min).to(x.dtype)
        if isinstance(self.layers, StackedLayerStack):
            x = self.layers(x, attn_bias=attn_bias)
        else:
            for layer in self.layers:
                x = layer(x, attn_bias)
        return x, torch.tanh(self.pooler(x[:, 0]))


class ErnieForSequenceClassification(nn.Module):
    """SST-2-style fine-tune head (BASELINE config 2 task).

    ``device`` defaults to ``cuda`` and raises without a GPU; pass
    ``device="cpu"`` for the plain path. ``dtype`` is the parameter
    dtype. Weights are drawn from a ``torch.Generator`` on ``device``
    seeded with ``seed``, before the blocks are stacked, so stacked and
    per-block storage hold the same weights from one seed. The model
    starts in training mode, as the JAX package's layers do."""

    def __init__(self, cfg: ErnieConfig, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        factory = {"device": device, "dtype": dtype}
        self.ernie = ErnieModel(cfg, **factory)
        self.drop = nn.Dropout(cfg.hidden_dropout_prob)
        self.classifier = nn.Linear(cfg.hidden_size, cfg.num_classes,
                                    **factory)
        self._init_weights(torch.Generator(device=device).manual_seed(seed))
        if cfg.stacked_blocks:
            self.ernie.layers = StackedLayerStack(list(self.ernie.layers))

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        std = self.cfg.initializer_range
        for m in self.modules():
            if isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.normal_(0.0, std, generator=gen)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        """Logits ``[b, num_classes]``; with ``labels``, ``(logits,
        loss)``: the mean cross-entropy over f32 logits."""
        _, pooled = self.ernie(input_ids, token_type_ids, attention_mask)
        logits = self.classifier(self.drop(pooled))
        if labels is None:
            return logits
        return logits, _cross_entropy(logits.float(), labels.reshape(-1))

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


def ernie3_base(**overrides) -> ErnieConfig:
    """ERNIE-3.0-base geometry (BASELINE config 2)."""
    cfg = dict(vocab_size=40000, hidden_size=768, num_layers=12,
               num_heads=12, max_position_embeddings=2048)
    cfg.update(overrides)
    return ErnieConfig(**cfg)


def ernie_tiny(**overrides) -> ErnieConfig:
    """Test geometry."""
    cfg = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
               max_position_embeddings=64, type_vocab_size=2)
    cfg.update(overrides)
    return ErnieConfig(**cfg)
