"""Quantization: the counterpart of ``paddle2_tpu/quantization/__init__.py``,
with its public names.

* Fake quantization (:func:`fake_quant`, per tensor or per channel, with
  the straight-through estimator), the observers
  (:class:`AbsmaxObserver`, :class:`ChannelWiseAbsMaxObserver`: an
  absmax, then the moving average ``rate * prev + (1 - rate) * cur`` in
  f32, until frozen) and the quanters built on them.
* :class:`QAT` swaps every ``torch.nn.Linear`` and the port's
  ``nn.Conv2D`` for a :class:`_QuantedWrapper` that fake-quantizes the
  activation and the weight; :class:`PTQ` does the same for calibration
  and :meth:`PTQ.convert` turns each Linear wrapper into a
  :class:`QuantedInferenceLinear`, whose int8 x int8 product runs on
  :func:`~paddle2_tpu_torch.kernels.quant_matmul.int8_matmul` (the CUDA
  kernel on the card).
* Weight-only int8 for serving: :func:`weight_only_quantize` swaps every
  ``nn.Linear`` under a module for a :class:`WeightOnlyLinear` (int8
  payload ``[in, out]`` = ``[K, N]`` with per-output-channel f32 scales,
  as the JAX package lays it out, so the two payloads compare bitwise);
  :func:`quantize_lm_head` installs a :class:`WeightOnlyLMHead` that
  ``GPTForCausalLM._head`` prefers. Both run through
  :func:`~paddle2_tpu_torch.kernels.quant_matmul.int8_weight_only_matmul`.

Everything here changes a model in place. Quantize after casting a
model (``model.to(torch.bfloat16)``): the cast would turn the f32 scale
buffers to bf16, which the kernels refuse.

Layouts. The JAX Linear stores its weight ``[in, out]`` with the output
channel on axis 1; ``torch.nn.Linear`` stores ``[out, in]``, so the
port's channel-wise weight quanter reads axis 0 of it, which gives the
JAX per-output-channel scales. The int8 payloads keep the JAX ``[in,
out]`` layout. Observer state lives in buffers on the model's device;
``scale()`` is the one host sync.

Where JAX's weak typing decides a dtype, the port follows it: a Python
scalar combined with a bf16 tensor is rounded to bf16 first
(:class:`QuantedInferenceLinear`'s ``a / s_in``), and an f32 scale
promotes a bf16 tensor to f32 (:func:`fake_quant` returns f32 for bf16
input, as the JAX function does).
"""

import copy
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..kernels.quant_matmul import (channel_absmax as _channel_absmax,
                                    int8_matmul, int8_weight_only_matmul)
# importable from here as before; not in the JAX __all__
from ..kernels.quant_matmul import (quantize_channelwise,  # noqa: F401
                                    weight_quant_error_bound)
from ..nn import Conv2D
from ..nn.functional import conv2d

__all__ = ["QuantConfig", "QAT", "PTQ", "FakeQuanterWithAbsMaxObserver",
           "FakeQuanterChannelWiseAbsMaxObserver", "AbsmaxObserver",
           "ChannelWiseAbsMaxObserver", "QuantedInferenceLinear",
           "WeightOnlyLinear", "WeightOnlyLMHead",
           "weight_only_quantize", "quantize_lm_head",
           "channel_absmax", "quant_aware", "fake_quant"]


def channel_absmax(w, axis: int = 1) -> torch.Tensor:
    """Per-channel absmax along ``axis`` (reduced over every other
    axis), f32: the one reduction the channel-wise observers, the
    weight-only packers and the training-time quantized LM head share.
    Takes a tensor or an array."""
    return _channel_absmax(torch.as_tensor(w), axis)


def fake_quant(x: torch.Tensor, scale, bits: int = 8,
               quant_axis: Optional[int] = None) -> torch.Tensor:
    """Per-tensor (a scalar scale) or per-channel (a 1-D scale along
    ``quant_axis``) fake quantization: ``clip(round(x / s * qmax),
    +-qmax) * s / qmax`` with ``s = max(scale, 1e-8)`` in f32, returned
    as ``x + (deq - x).detach()``, so the gradient is the identity (the
    straight-through estimator). The result has the promoted type of
    ``x`` and f32, as in the JAX package."""
    qmax = float(2 ** (bits - 1) - 1)
    s = torch.as_tensor(scale, dtype=torch.float32,
                        device=x.device).clamp_min(1e-8)
    if quant_axis is not None:
        shape = [1] * x.dim()
        shape[quant_axis] = -1
        s = s.reshape(shape)
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    q = torch.round(x / s * qmax).clamp(-qmax, qmax)
    deq = q * s / qmax
    return x + (deq - x).detach()


# ---------------------------------------------------------------- observers
class _MovingAbsmax(nn.Module):
    """The state the two observers share: ``_absmax`` (f32), ``_seen``
    (0 until the first observation) as non-persistent buffers; the first
    observation is taken as it is, later ones as ``rate * prev + (1 -
    rate) * cur``, in f32, until :meth:`freeze`."""

    def __init__(self, quant_bits: int, moving_rate: float):
        super().__init__()
        self.quant_bits = quant_bits
        self.moving_rate = moving_rate
        self._frozen = False

    def _make_buffers(self, shape, device=None) -> None:
        self.register_buffer("_absmax", torch.zeros(
            shape, dtype=torch.float32, device=device), persistent=False)
        self.register_buffer("_seen", torch.zeros(
            (), dtype=torch.float32, device=device), persistent=False)

    def freeze(self) -> None:
        """Stop scale updates (``PTQ.convert``'s freeze)."""
        self._frozen = True

    @torch.no_grad()
    def _record(self, cur: torch.Tensor) -> None:
        if self._absmax.device != cur.device:
            self._absmax = self._absmax.to(cur.device)
            self._seen = self._seen.to(cur.device)
        rate = self.moving_rate
        new = torch.where(self._seen > 0,
                          self._absmax * rate + cur * (1 - rate), cur)
        self._absmax.copy_(new)
        self._seen.fill_(1.0)

    def raw_scale(self) -> torch.Tensor:
        """The scale on the device: the tracked absmax, 1 before any
        observation. The QAT fake-quant path reads this, so a training
        step never waits on the host."""
        if getattr(self, "_absmax", None) is None:
            return torch.ones(())
        return torch.where(self._seen > 0, self._absmax,
                           torch.ones_like(self._absmax))


class AbsmaxObserver(_MovingAbsmax):
    """Per-tensor absmax observer: records in train and in eval until
    frozen."""

    def __init__(self, quant_bits: int = 8, moving_rate: float = 0.9):
        super().__init__(quant_bits, moving_rate)
        self._make_buffers(())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self._frozen:
            self._record(x.detach().abs().amax().float())
        return x

    def scale(self) -> float:
        return float(self.raw_scale())       # one sync at read time


class ChannelWiseAbsMaxObserver(_MovingAbsmax):
    """Per-channel absmax observer along ``quant_axis``. ``channels``
    (the extent of that axis) sizes the buffer at construction; without
    it the buffer is made at the first observation, on its device."""

    def __init__(self, quant_bits: int = 8, quant_axis: int = -1,
                 moving_rate: float = 0.9, channels: Optional[int] = None):
        super().__init__(quant_bits, moving_rate)
        self.quant_axis = quant_axis
        if channels is not None:
            self._make_buffers((channels,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._frozen:
            return x
        axis = self.quant_axis % x.dim()
        if getattr(self, "_absmax", None) is None:
            self._make_buffers((x.shape[axis],), x.device)
        self._record(_channel_absmax(x.detach(), axis))
        return x

    def scale(self) -> torch.Tensor:
        """The per-channel scales on the host (ones(()) before any
        observation)."""
        return self.raw_scale().cpu()


# ----------------------------------------------------------------- quanters
class FakeQuanterWithAbsMaxObserver(nn.Module):
    """QAT quanter: observes the per-tensor absmax and fake-quantizes
    with the straight-through estimator."""

    def __init__(self, quant_bits: int = 8, moving_rate: float = 0.9,
                 dtype="float32", name=None):
        super().__init__()
        self.observer = AbsmaxObserver(quant_bits, moving_rate)
        self.quant_bits = quant_bits

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self.observer(x)
        return fake_quant(x, self.observer.raw_scale(), self.quant_bits)


class FakeQuanterChannelWiseAbsMaxObserver(nn.Module):
    """Per-channel QAT weight quanter: one scale per output channel.
    ``quant_axis`` 0 is the output channel of a Conv2D weight ``[O, I,
    kh, kw]`` and of a ``torch.nn.Linear`` weight ``[out, in]``;
    :class:`_QuantedWrapper` passes the axis and the channel count."""

    def __init__(self, quant_bits: int = 8, quant_axis: int = 0,
                 moving_rate: float = 0.9, dtype="float32", name=None,
                 channels: Optional[int] = None):
        super().__init__()
        self.observer = ChannelWiseAbsMaxObserver(quant_bits, quant_axis,
                                                  moving_rate,
                                                  channels=channels)
        self.quant_bits = quant_bits
        self.quant_axis = quant_axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self.observer(x)
        return fake_quant(x, self.observer.raw_scale(), self.quant_bits,
                          quant_axis=self.quant_axis % x.dim())


class QuantConfig:
    """The activation and weight quanter factories, with per-layer-type
    overrides (:meth:`add_type_config`)."""

    def __init__(self, activation=None, weight=None):
        self.activation = activation
        self.weight = weight
        self._type_map: Dict[type, Tuple] = {}

    def add_type_config(self, layer_type, activation=None, weight=None):
        self._type_map[layer_type] = (activation, weight)

    def quanter_for(self, layer):
        act, w = self.activation, self.weight
        for t, (a2, w2) in self._type_map.items():
            if isinstance(layer, t):
                act, w = a2 or act, w2 or w
        return act, w


def _promoted(*ts):
    """Cast floating tensors (None passes) to their promoted type, as a
    jnp op over them computes."""
    dt = ts[0].dtype
    for t in ts[1:]:
        if t is not None:
            dt = torch.promote_types(dt, t.dtype)
    return [None if t is None else t.to(dt) for t in ts]


class _QuantedWrapper(nn.Module):
    """Wraps a Linear or Conv2D: the activation fake-quantized on the
    way in, the weight fake-quantized inline (gradients reach the fp
    weight through the straight-through estimator). The quanters' state
    lives on the wrapped layer's device."""

    def __init__(self, inner: nn.Module, act_quanter, w_quanter):
        super().__init__()
        self.inner = inner
        self.act_quanter = act_quanter() if isinstance(act_quanter, type) \
            else act_quanter
        if isinstance(w_quanter, type):
            if issubclass(w_quanter, FakeQuanterChannelWiseAbsMaxObserver):
                # the output channel is axis 0 of both torch layouts
                w_quanter = w_quanter(quant_axis=0,
                                      channels=int(inner.weight.shape[0]))
            else:
                w_quanter = w_quanter()
        self.w_quanter = w_quanter
        dev = inner.weight.device
        for q in (self.act_quanter, self.w_quanter):
            if isinstance(q, nn.Module):
                q.to(dev)

    def forward(self, x):
        if self.act_quanter is not None:
            x = self.act_quanter(x)
        if self.w_quanter is None:
            return self.inner(x)
        fq = self.w_quanter(self.inner.weight)
        if isinstance(self.inner, nn.Linear):
            return F.linear(*_promoted(x, fq, self.inner.bias))
        if isinstance(self.inner, Conv2D):
            c = self.inner
            x, fq, b = _promoted(x, fq, c.bias)
            return conv2d(x, fq, b, stride=c._stride, padding=c._padding,
                          dilation=c._dilation, groups=c._groups,
                          data_format=c._data_format)
        return self.inner(x)


_QUANTABLE = (nn.Linear, Conv2D)


def _swap(model: nn.Module, config: QuantConfig) -> nn.Module:
    for name, child in list(model.named_children()):
        if isinstance(child, _QUANTABLE):
            act, w = config.quanter_for(child)
            if act is None and w is None:
                act = w = FakeQuanterWithAbsMaxObserver
            model.add_module(name, _QuantedWrapper(child, act, w))
        else:
            _swap(child, config)
    return model


class QAT:
    """Quantization-aware training: :meth:`quantize` swaps the
    quantable layers in place."""

    def __init__(self, config: Optional[QuantConfig] = None):
        self.config = config or QuantConfig()

    def quantize(self, model: nn.Module, inplace: bool = True) -> nn.Module:
        return _swap(model, self.config)


# --------------------------------------------------------- full-int8 Linear
class QuantedInferenceLinear(nn.Module):
    """Int8 inference Linear: the payload ``weight_int8 [in, out]``, its
    per-output-channel f32 ``w_scale`` and the ``bias`` are buffers;
    ``act_scale`` (the calibrated per-tensor activation scale) is a
    float attribute, as in the JAX package. The input is quantized to
    int8, multiplied by the payload in int32 through
    :func:`~paddle2_tpu_torch.kernels.quant_matmul.int8_matmul` (the
    CUDA kernel on the card), and dequantized, in the JAX operation
    order."""

    def __init__(self, weight_int8, w_scale, bias, act_scale,
                 quant_bits: int = 8):
        super().__init__()
        self.register_buffer("weight_int8",
                             torch.as_tensor(weight_int8).to(torch.int8))
        self.register_buffer("w_scale",
                             torch.as_tensor(w_scale).to(torch.float32))
        self.register_buffer(
            "bias", None if bias is None else torch.as_tensor(bias))
        self.act_scale = float(act_scale)
        self.qmax = float(2 ** (quant_bits - 1) - 1)

    def forward(self, a: torch.Tensor) -> torch.Tensor:
        K, N = self.weight_int8.shape
        s_in = max(self.act_scale, 1e-8)
        # JAX's weak typing: the Python scalars take a's dtype first
        s_a = torch.tensor(s_in, dtype=a.dtype).item()
        q_in = torch.round(a / s_a * self.qmax).clamp(
            -self.qmax, self.qmax).to(torch.int8)
        acc = int8_matmul(q_in.reshape(-1, K).contiguous(), self.weight_int8)
        deq = acc.float() * (s_in / self.qmax) * (self.w_scale / self.qmax)
        if self.bias is not None:
            deq = deq + self.bias
        return deq.to(a.dtype).reshape(a.shape[:-1] + (N,))


# --------------------------------------------------------- weight-only int8
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
    scale = obs.raw_scale().clamp_min(1e-8)
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


# ---------------------------------------------------------------------- PTQ
class PTQ(QAT):
    """Post-training quantization: :meth:`quantize` inserts the same
    wrappers as QAT, whose observers record during calibration
    forwards; :meth:`convert` freezes the observed scales into int8
    inference layers (per-channel weights, a per-tensor activation)."""

    def convert(self, model: nn.Module, inplace: bool = True) -> nn.Module:
        if not inplace:
            model = copy.deepcopy(model)
        return self._convert_in_place(model)

    @torch.no_grad()
    def _convert_in_place(self, model: nn.Module) -> nn.Module:
        for name, child in list(model.named_children()):
            if isinstance(child, _QuantedWrapper) \
                    and isinstance(child.inner, nn.Linear):
                # the JAX [in, out] weight: scales per output channel
                w = child.inner.weight.t().float()
                w_scale = w.abs().amax(dim=0).clamp_min(1e-8)
                qmax = 2 ** 7 - 1
                w_int8 = torch.round(w / w_scale * qmax).clamp(
                    -qmax, qmax).to(torch.int8).contiguous()
                act_scale = 1.0
                if child.act_quanter is not None and hasattr(
                        child.act_quanter, "observer"):
                    act_scale = float(child.act_quanter.observer.scale())
                bias = None if child.inner.bias is None else \
                    child.inner.bias.detach().clone()
                model.add_module(name, QuantedInferenceLinear(
                    w_int8, w_scale, bias, act_scale))
            elif isinstance(child, _QuantedWrapper):
                # no int8 convolution: freeze the observed scales so the
                # simulated-quant forward stops drifting at inference
                for q in (child.act_quanter, child.w_quanter):
                    obs = getattr(q, "observer", None)
                    if obs is not None:
                        obs.freeze()
            else:
                self._convert_in_place(child)
        return model


def quant_aware(model: nn.Module, config: Optional[QuantConfig] = None):
    return QAT(config).quantize(model)


class BaseObserver(nn.Module):
    """The observer protocol: watch tensors in ``forward``, produce a
    scale. :class:`AbsmaxObserver` and :class:`ChannelWiseAbsMaxObserver`
    are the built-in ones."""

    def forward(self, x):
        raise NotImplementedError

    def scales(self):
        raise NotImplementedError

    def cal_thresholds(self):
        pass


class BaseQuanter(nn.Module):
    """The quanter protocol: fake-quantize in ``forward``
    (:class:`FakeQuanterWithAbsMaxObserver` is the built-in one)."""

    def forward(self, x):
        raise NotImplementedError

    def scales(self):
        raise NotImplementedError

    def zero_points(self):
        return None


def quanter(name):
    """Register a quanter class under ``name`` (a class decorator), so a
    configuration can refer to it by string."""
    def decorator(cls):
        _QUANTER_REGISTRY[name] = cls
        cls.__quanter_name__ = name
        return cls
    return decorator


_QUANTER_REGISTRY = {}

__all__ += ["BaseObserver", "BaseQuanter", "quanter"]
