"""Weight-only quantization for serving: the counterpart of the
weight-only part of ``paddle2_tpu/quantization/__init__.py``.

:func:`weight_only_quantize` swaps every ``nn.Linear`` under a module
for a :class:`WeightOnlyLinear` (int8 payload ``[in, out]`` = ``[K, N]``
with per-output-channel f32 scales, as the JAX package lays it out, so
the two payloads compare bitwise); :func:`quantize_lm_head` installs a
:class:`WeightOnlyLMHead` that ``GPTForCausalLM._head`` prefers. Both
run through :func:`~paddle2_tpu_torch.kernels.quant_matmul.int8_weight_only_matmul`,
the CUDA weight-only kernel on the card. Both change the model in
place.

Quantize after casting a model (``model.to(torch.bfloat16)``): the cast
would turn the f32 scale buffers to bf16, which the kernel refuses.

QAT, PTQ, ``QuantedInferenceLinear``, fake quantization, the
training-time ``quantized_lm_head`` and int4 packing wait for ROADMAP
queue 1, item 8.
"""

from typing import Tuple

import torch
from torch import nn

from ..kernels.quant_matmul import (channel_absmax, int8_weight_only_matmul,
                                    quantize_channelwise,
                                    weight_quant_error_bound)

__all__ = ["ChannelWiseAbsMaxObserver", "WeightOnlyLinear",
           "WeightOnlyLMHead", "quantize_lm_head", "weight_only_quantize",
           "channel_absmax", "quantize_channelwise",
           "weight_quant_error_bound"]


class ChannelWiseAbsMaxObserver(nn.Module):
    """Per-channel absmax along ``quant_axis``, as far as the weight-only
    packers use it: one observation, then :meth:`freeze`. Calibration
    over several batches (the JAX observer's moving average) belongs to
    PTQ, which waits with ROADMAP queue 1 item 8."""

    def __init__(self, quant_bits: int = 8, quant_axis: int = -1):
        super().__init__()
        self.quant_bits = quant_bits
        self.quant_axis = quant_axis
        self._frozen = False
        self.register_buffer("_absmax", None, persistent=False)

    def freeze(self) -> None:
        self._frozen = True

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._frozen:
            return x
        if self._absmax is not None:
            raise NotImplementedError(
                "a second observation (moving-average calibration) is not "
                "ported yet (ROADMAP queue 1 item 8)")
        self._absmax = channel_absmax(x, self.quant_axis)
        return x

    def scale(self) -> torch.Tensor:
        """The per-channel scales (ones before any observation)."""
        return torch.ones(()) if self._absmax is None else self._absmax


def _pack_weight_only(w_kn: torch.Tensor, quant_bits: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One observation of a static ``[K, N]`` weight through the
    channel-wise observer, frozen, then packed: ``(w_int8 [K, N],
    scale [N] f32)`` on the weight's device, in the operation order of
    the JAX package's ``_pack_weight_only``: ``w / scale * qmax`` in
    f32, rounded half to even, clipped to ``[-qmax, qmax]``."""
    obs = ChannelWiseAbsMaxObserver(quant_bits=quant_bits, quant_axis=1)
    obs(w_kn)
    obs.freeze()
    scale = obs.scale().float().clamp_min(1e-8)
    qmax = 2 ** (quant_bits - 1) - 1
    w_q = torch.round(w_kn.float() / scale * qmax).clamp(-qmax, qmax)
    return w_q.to(torch.int8).contiguous(), scale.contiguous()


class WeightOnlyLinear(nn.Module):
    """Int8 weight-only Linear: the payload ``weight_int8 [in, out]``,
    f32 per-output-channel ``w_scale`` and the fp ``bias`` are buffers
    (they move with ``.to(device)`` and ride in the state dict under the
    JAX package's names); activations stay floating point."""

    def __init__(self, weight_int8, w_scale, bias=None, quant_bits: int = 8):
        super().__init__()
        self.register_buffer("weight_int8", weight_int8.to(torch.int8))
        self.register_buffer("w_scale", w_scale.to(torch.float32))
        self.register_buffer("bias", bias)
        self.quant_bits = quant_bits

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_weight_only_matmul(x.contiguous(), self.weight_int8,
                                       self.w_scale, bias=self.bias,
                                       quant_bits=self.quant_bits)


class WeightOnlyLMHead(nn.Module):
    """Int8 weight-only LM head: its own payload of the head weight
    ``[hidden, vocab]`` (``wte.weight.T`` when tied), quantized per vocab
    channel; the embedding lookup keeps the fp table."""

    def __init__(self, weight_int8, w_scale, quant_bits: int = 8):
        super().__init__()
        self.register_buffer("weight_int8", weight_int8.to(torch.int8))
        self.register_buffer("w_scale", w_scale.to(torch.float32))
        self.quant_bits = quant_bits

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_weight_only_matmul(x.contiguous(), self.weight_int8,
                                       self.w_scale,
                                       quant_bits=self.quant_bits)


@torch.no_grad()
def quantize_lm_head(model: nn.Module, quant_bits: int = 8) -> nn.Module:
    """Install ``model._wo_head``, a :class:`WeightOnlyLMHead` packed from
    ``wte.weight.T`` (tied embeddings) or ``lm_head.weight.T`` (torch's
    Linear stores ``[out, in]``), which ``GPTForCausalLM._head`` prefers.
    In place; returns ``model``."""
    cfg = getattr(model, "cfg", None)
    if getattr(cfg, "tie_word_embeddings", False):
        w = model.gpt.wte.weight.t()
    elif getattr(model, "lm_head", None) is not None:
        w = model.lm_head.weight.t()
    else:
        raise ValueError("quantize_lm_head: model has neither tied "
                         "embeddings nor an lm_head Linear")
    w_int8, scale = _pack_weight_only(w, quant_bits)
    model.add_module("_wo_head", WeightOnlyLMHead(w_int8, scale,
                                                  quant_bits=quant_bits))
    return model


@torch.no_grad()
def weight_only_quantize(model: nn.Module, quant_bits: int = 8,
                         include_lm_head: bool = False) -> nn.Module:
    """Swap every ``nn.Linear`` under ``model`` (recursively, in place)
    for a :class:`WeightOnlyLinear` packed from its weight, transposed to
    ``[in, out]``, per output channel. ``include_lm_head`` also packs a
    causal LM's head through :func:`quantize_lm_head` (first, so an
    untied ``lm_head`` is read as a head and left in place). Returns
    ``model``."""
    if include_lm_head:
        quantize_lm_head(model, quant_bits=quant_bits)
    for name, child in list(model.named_children()):
        if include_lm_head and name in ("lm_head", "_wo_head"):
            continue
        if isinstance(child, nn.Linear):
            if child.weight is None:
                raise ValueError(
                    f"{name}: a Linear without its own weight (stacked "
                    f"block storage) cannot be quantized; build the model "
                    f"with stacked_blocks=False")
            w_int8, scale = _pack_weight_only(child.weight.t(), quant_bits)
            bias = None if child.bias is None else child.bias.detach().clone()
            model.add_module(name, WeightOnlyLinear(
                w_int8, scale, bias, quant_bits=quant_bits))
        elif not isinstance(child, WeightOnlyLMHead):
            weight_only_quantize(child, quant_bits=quant_bits)
    return model
