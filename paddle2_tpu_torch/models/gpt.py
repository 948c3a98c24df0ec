"""GPT-style decoder LM — the port of ``paddle2_tpu/models/gpt.py``.

Same architecture and attribute names as the JAX package (fused
head-major qkv, pre-LN blocks, exact-erf GELU, learned positions, the
LM head tied to ``wte``), as ``torch.nn.Module``s, so a JAX state dict
maps onto this one name for name (see :mod:`.convert`).

Trains and serves, on one device: no tensor, sequence or context
parallelism yet. Training adds remat (``use_recompute`` with
``recompute_granularity`` "full" or "dots", through
``torch.utils.checkpoint``), stacked ``[L, ...]`` block storage
(``stacked_blocks``, :mod:`._scan`) and the chunked fused LM-head loss
(``fused_head_loss``), and the int8 head fake-quantized per vocab
channel (``quantized_lm_head``). Attention runs through
:func:`paddle2_tpu_torch.kernels.scaled_dot_product_attention`, which
launches the CUDA flash kernels (forward and backward) for a CUDA
tensor at every length. LayerNorm is :class:`paddle2_tpu_torch.nn.LayerNorm`,
which keeps the JAX package's rounding order under AMP O2.

Initialisation matches the JAX package's distributions: Normal(0, 0.02)
for every projection and embedding, the attention out-projection at
``0.02 / sqrt(2 * num_layers)``, zero biases, unit LayerNorm scales —
drawn from an explicit ``torch.Generator`` seeded by ``seed``. The two
frameworks draw different numbers from one seed; tests carry weights
across with :func:`~.convert.gpt_state_from_reference`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..device import resolve_device
from ..distributed.recompute import recompute
from ..incubate.nn.functional import fused_linear_cross_entropy
from ..kernels.attention import scaled_dot_product_attention
from ..nn import LayerNorm
from ._scan import StackedLayerStack

__all__ = ["GPTConfig", "GPTAttention", "GPTMLP", "GPTBlock", "GPTModel",
           "GPTForCausalLM", "gpt3_1p3b", "gpt_small", "gpt_tiny"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 1024
    intermediate_size: Optional[int] = None  # default 4*hidden
    hidden_dropout_prob: float = 0.0
    attention_dropout_prob: float = 0.0
    initializer_range: float = 0.02
    layer_norm_epsilon: float = 1e-5
    tie_word_embeddings: bool = True
    use_recompute: bool = False
    # "full" keeps each block's input only; "dots" also keeps matrix
    # products and the flash op's (o, lse) (kernels.attention.remat_policy)
    recompute_granularity: str = "full"
    # one [L, ...] parameter per block leaf (models/_scan.py)
    stacked_blocks: bool = False
    # forward(labels=...) returns (None, loss) through the chunked fused
    # head + cross-entropy: the [tokens, vocab] logits are never held
    fused_head_loss: bool = False
    # training-time int8 head: the logits matmul reads the head weight
    # fake-quantized per vocab channel (straight-through gradients reach
    # the fp weight and the tied embedding). Not with fused_head_loss
    quantized_lm_head: bool = False

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


class GPTAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, **factory):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.qkv = nn.Linear(h, 3 * h, **factory)
        self.out_proj = nn.Linear(h, h, **factory)

    def forward(self, x, cache=None):
        """cache: optional ``(k, v)`` of past tokens ``[b, s_past, H, D]``
        (an empty tuple on the first call). Autoregressive decode
        appends this step's k/v and attends over the whole prefix; the
        causal mask is aligned to the bottom right, so ``s_q < s_k`` is
        right. Returns out, or ``(out, new_cache)`` when a cache is
        passed."""
        b, s, h = x.shape
        qkv = self.qkv(x)
        # head-major fused layout [heads, (q|k|v), head_dim], as the JAX
        # package lays it out — not torch's (q|k|v) thirds
        q, k, v = qkv.reshape(b, s, self.cfg.num_heads, 3,
                              self.cfg.head_dim).unbind(3)
        new_cache = None
        if cache is not None:
            if len(cache) == 2:
                k = torch.cat([cache[0], k], dim=1)
                v = torch.cat([cache[1], v], dim=1)
            new_cache = (k, v)
        out = scaled_dot_product_attention(
            q, k, v, is_causal=True,
            dropout_p=self.cfg.attention_dropout_prob, training=self.training)
        out = self.out_proj(out.reshape(b, s, h))
        return (out, new_cache) if cache is not None else out


class GPTMLP(nn.Module):
    def __init__(self, cfg: GPTConfig, **factory):
        super().__init__()
        self.up = nn.Linear(cfg.hidden_size, cfg.ffn_size, **factory)
        self.down = nn.Linear(cfg.ffn_size, cfg.hidden_size, **factory)

    def forward(self, x):
        # exact erf GELU, as the JAX package's F.gelu
        return self.down(F.gelu(self.up(x)))


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, **factory):
        super().__init__()
        eps = cfg.layer_norm_epsilon
        self.ln_1 = LayerNorm(cfg.hidden_size, eps=eps, **factory)
        self.attn = GPTAttention(cfg, **factory)
        self.ln_2 = LayerNorm(cfg.hidden_size, eps=eps, **factory)
        self.mlp = GPTMLP(cfg, **factory)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, x, cache=None):
        if cache is not None:
            a, new_cache = self.attn(self.ln_1(x), cache=cache)
            x = x + self.dropout(a)
            x = x + self.dropout(self.mlp(self.ln_2(x)))
            return x, new_cache
        x = x + self.dropout(self.attn(self.ln_1(x)))
        return x + self.dropout(self.mlp(self.ln_2(x)))


class GPTModel(nn.Module):
    """Transformer trunk: embeddings -> blocks -> final LN."""

    def __init__(self, cfg: GPTConfig, **factory):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **factory)
        self.wpe = nn.Embedding(cfg.max_position_embeddings,
                                cfg.hidden_size, **factory)
        self.drop = nn.Dropout(cfg.hidden_dropout_prob)
        self.h = nn.ModuleList(GPTBlock(cfg, **factory)
                               for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_epsilon,
                              **factory)

    def _embed(self, input_ids, position_offset: int):
        s = input_ids.shape[1]
        pos = torch.arange(position_offset, position_offset + s,
                           device=input_ids.device)[None, :]
        return self.drop(self.wte(input_ids) + self.wpe(pos))

    def forward(self, input_ids):
        x = self._embed(input_ids, 0)
        cfg = self.cfg
        remat = (cfg.recompute_granularity
                 if cfg.use_recompute and self.training else None)
        if isinstance(self.h, StackedLayerStack):
            x = self.h(x, remat=remat)
        else:
            for block in self.h:
                x = block(x) if remat is None else \
                    recompute(block, x, policy=remat)
        return self.ln_f(x)

    def blocks(self):
        """Each block in order, bound to its weights while the caller
        holds it (with stacked storage the template is bound to layer
        ``i`` for that step of the iteration)."""
        if isinstance(self.h, StackedLayerStack):
            for i in range(self.h.n_layers):
                with self.h.layer(i) as block:
                    yield block
        else:
            yield from self.h

    def decode_step(self, input_ids, caches, position_offset: int
                    ) -> Tuple[torch.Tensor, List[tuple]]:
        """KV-cached decode: run only the NEW tokens through the trunk,
        appending to per-layer ``(k, v)`` caches (``()`` on the first,
        prefill call). Returns ``(hidden, new_caches)``."""
        x = self._embed(input_ids, position_offset)
        new_caches = []
        for block, cache in zip(self.blocks(), caches, strict=True):
            x, c = block(x, cache=cache)
            new_caches.append(c)
        return self.ln_f(x), new_caches


class GPTForCausalLM(nn.Module):
    """Trunk + LM head (tied to ``wte`` by default).

    ``device`` defaults to ``cuda`` and raises without a GPU; pass
    ``device="cpu"`` for the plain path. ``dtype`` is the parameter
    dtype (float32 or bfloat16). Weights are drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed``, per block,
    before the blocks are stacked, so stacked and per-block storage hold
    the same weights from one seed. The model starts in training mode,
    as the JAX package's layers do."""

    def __init__(self, cfg: GPTConfig, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        if cfg.quantized_lm_head and cfg.fused_head_loss:
            raise ValueError(
                "quantized_lm_head and fused_head_loss are mutually "
                "exclusive: the chunked fused-CE kernel owns the head "
                "matmul, so there is no logits matmul to quantize")
        device = resolve_device(device)
        factory = {"device": device, "dtype": dtype}
        self.gpt = GPTModel(cfg, **factory)
        self.lm_head = (None if cfg.tie_word_embeddings else
                        nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                  bias=False, **factory))
        self._init_weights(torch.Generator(device=device).manual_seed(seed))
        if cfg.stacked_blocks:
            self.gpt.h = StackedLayerStack(list(self.gpt.h))

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        std = self.cfg.initializer_range
        proj_std = std / math.sqrt(2 * self.cfg.num_layers)
        for name, p in self.named_parameters():
            if name.endswith("attn.out_proj.weight"):
                p.normal_(0.0, proj_std, generator=gen)
            elif name.endswith("weight") and p.dim() == 2:
                p.normal_(0.0, std, generator=gen)
            elif name.endswith("weight"):        # LayerNorm scale
                p.fill_(1.0)
            else:                                # biases
                p.zero_()

    def _head(self, hidden):
        # the int8 payload installed by quantization.quantize_lm_head;
        # the embedding lookup keeps the fp table
        wo = self._modules.get("_wo_head")
        if wo is not None:
            return wo(hidden)
        if self.cfg.quantized_lm_head:
            # the head weight [hidden, vocab] fake-quantized per vocab
            # channel; the scale is a constant of the step, as in JAX
            from ..quantization import channel_absmax, fake_quant
            w = (self.gpt.wte.weight if self.lm_head is None
                 else self.lm_head.weight).t()
            w = fake_quant(w, channel_absmax(w.detach(), axis=1), bits=8,
                           quant_axis=1)
            return torch.matmul(*_promoted(hidden, w))
        if self.lm_head is None:
            # f32 hidden states over bf16 weights (a bf16 model
            # calibrating under PTQ, whose fake-quantized activations are
            # f32) take the promoted type, as the JAX package's matmul does
            return F.linear(*_promoted(hidden, self.gpt.wte.weight))
        return self.lm_head(hidden)

    def forward(self, input_ids, labels=None):
        """Logits; with ``labels``, ``(logits, loss)``, or ``(None,
        loss)`` through the fused head when ``fused_head_loss``. The
        loss is the mean cross-entropy over tokens whose label is not
        -100."""
        hidden = self.gpt(input_ids)
        if labels is not None and self.cfg.fused_head_loss:
            w = (self.gpt.wte.weight if self.lm_head is None
                 else self.lm_head.weight)
            return None, fused_linear_cross_entropy(hidden, w.t(), labels)
        logits = self._head(hidden)
        if labels is None:
            return logits
        return logits, _cross_entropy(
            logits.reshape(-1, self.cfg.vocab_size).float(),
            labels.reshape(-1))

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 0.0):
        """Greedy autoregressive decoding through per-layer KV caches
        (prefill once, then one token per step). Returns the prompt and
        its continuation, ``[B, prompt + max_new_tokens]``. Sampling
        (``temperature > 0``) belongs to a later slice."""
        if temperature != 0.0:
            raise NotImplementedError(
                "sampling is not ported yet; use temperature=0.0")
        dev = self.gpt.wte.weight.device
        ids = torch.as_tensor(input_ids, dtype=torch.long, device=dev)
        if ids.dim() == 1:
            ids = ids[None]
        if ids.shape[1] + max_new_tokens > self.cfg.max_position_embeddings:
            raise ValueError(
                f"prompt {ids.shape[1]} + {max_new_tokens} new tokens "
                f"exceed max_position_embeddings "
                f"{self.cfg.max_position_embeddings}")
        caches = [() for _ in range(self.cfg.num_layers)]
        pos = 0
        for _ in range(max_new_tokens):
            hidden, caches = self.gpt.decode_step(ids[:, pos:], caches, pos)
            pos = ids.shape[1]
            logits = self._head(hidden[:, -1]).float()
            nxt = torch.argmax(logits, dim=-1)
            ids = torch.cat([ids, nxt[:, None]], dim=1)
        return ids


def _promoted(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _cross_entropy(logits, labels, ignore_index: int = -100):
    """Mean cross-entropy over the labels not ignored, as the JAX
    package's ``F.cross_entropy`` computes it (nn/functional/loss.py:33):
    log-softmax, the picked log-probability, a sum over valid tokens
    over their count (at least 1e-12)."""
    logp = torch.log_softmax(logits, dim=-1)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    picked = -logp.gather(-1, safe[:, None].long())[:, 0]
    picked = torch.where(valid, picked, torch.zeros_like(picked))
    return picked.sum() / valid.to(picked.dtype).sum().clamp_min(1e-12)


def gpt3_1p3b(**overrides) -> GPTConfig:
    """GPT-3 1.3B geometry (the JAX package's BASELINE config 4)."""
    cfg = dict(vocab_size=50304, hidden_size=2048, num_layers=24,
               num_heads=16, max_position_embeddings=2048)
    cfg.update(overrides)
    return GPTConfig(**cfg)


def gpt_small(**overrides) -> GPTConfig:
    cfg = dict(vocab_size=50304, hidden_size=768, num_layers=12,
               num_heads=12, max_position_embeddings=1024)
    cfg.update(overrides)
    return GPTConfig(**cfg)


def gpt_tiny(**overrides) -> GPTConfig:
    """Test geometry."""
    cfg = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
               max_position_embeddings=64)
    cfg.update(overrides)
    return GPTConfig(**cfg)
