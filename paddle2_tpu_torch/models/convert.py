"""Carry a JAX-package GPT's, ERNIE's or ResNet's weights into the port.

The JAX package's ``nn.Linear`` stores its weight ``[in, out]``;
``torch.nn.Linear`` stores ``[out, in]``, so linear weights swap their
last two axes (``[L, in, out]`` -> ``[L, out, in]`` for stacked leaves).
Everything else (embeddings, LayerNorm, biases) has the same shape in
both. Names are the same, since the port's modules mirror the JAX
package's attribute names, stacked leaves included
(``gpt.h.stacked_<name with . -> __>``, ``ernie.layers.stacked_...``).
The fused qkv columns keep their layout (GPT's head-major ``[H, (q|k|v),
D]``, ERNIE's ``(q|k|v)`` thirds): the transpose moves the columns to
rows without reordering them.

A ResNet's only Linear is ``fc``; its convolutions (``[O, I/groups, kh,
kw]`` in both packages), BatchNorm parameters and the ``_mean`` /
``_variance`` buffers pass unchanged.

A model quantized to int8 weight-only carries ``<path>.weight_int8``,
``<path>.w_scale`` and ``<path>.bias`` for each swapped Linear and
``_wo_head.*`` for the head. Both packages lay the payload out ``[K, N]``
= ``[in, out]``, so these pass unchanged; :func:`load_weight_only_reference`
gives the port's model the matching modules and loads them. A model
converted by ``PTQ.convert`` carries the same three names for each
``QuantedInferenceLinear``; its activation scale is a float attribute,
not state, so :func:`load_quanted_reference` takes those scales beside
the state.
"""

import re
from collections import defaultdict
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..quantization import (QuantedInferenceLinear, WeightOnlyLinear,
                            WeightOnlyLMHead)

__all__ = ["gpt_state_from_reference", "ernie_state_from_reference",
           "resnet_state_from_reference", "load_weight_only_reference",
           "load_quanted_reference"]

_GPT_LINEARS = ("attn.qkv.weight", "attn.out_proj.weight", "mlp.up.weight",
                "mlp.down.weight", "lm_head.weight")
_ERNIE_LINEARS = ("attn.qkv.weight", "attn.out.weight", "up.weight",
                  "down.weight", "pooler.weight", "classifier.weight")


def _unstack(state, stack):
    prefix = stack + ".stacked_"
    out = {}
    for name, t in state.items():
        if not name.startswith(prefix):
            out[name] = t
            continue
        leaf = name[len(prefix):].replace("__", ".")
        for i in range(t.shape[0]):
            out[f"{stack}.{i}.{leaf}"] = t[i]
    return out


def _stack(state, stack):
    block = re.compile(r"^" + re.escape(stack) + r"\.(\d+)\.(.+)$")
    out, per = {}, defaultdict(dict)
    for name, t in state.items():
        m = block.match(name)
        if m is None:
            out[name] = t
        else:
            per[m.group(2)][int(m.group(1))] = t
    for leaf, layers in per.items():
        out[f"{stack}.stacked_" + leaf.replace(".", "__")] = torch.stack(
            [layers[i] for i in range(len(layers))])
    return out


def _from_reference(state, linears: Sequence[str], stack: str,
                    stacked: Optional[bool]) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for name, arr in state.items():
        a = np.asarray(arr)
        if name.replace("__", ".").endswith(tuple(linears)):
            a = np.swapaxes(a, -1, -2)
        out[name] = torch.from_numpy(np.ascontiguousarray(a))
    is_stacked = any(n.startswith(stack + ".stacked_") for n in out)
    if stacked is None or stacked == is_stacked:
        return out
    return _stack(out, stack) if stacked else _unstack(out, stack)


def gpt_state_from_reference(state: Dict[str, np.ndarray],
                             stacked: Optional[bool] = None
                             ) -> Dict[str, torch.Tensor]:
    """Map ``{name: ndarray}`` from the JAX model's ``state_dict()``,
    per-block or stacked, to a state dict for
    :class:`~.gpt.GPTForCausalLM` (CPU float tensors; ``load_state_dict``
    copies them to the model's device and dtype). ``stacked`` is the
    layout of the result: True for ``[L, ...]`` leaves, False for
    per-block names, None for the layout of ``state``."""
    return _from_reference(state, _GPT_LINEARS, "gpt.h", stacked)


def ernie_state_from_reference(state: Dict[str, np.ndarray],
                               stacked: Optional[bool] = None
                               ) -> Dict[str, torch.Tensor]:
    """As :func:`gpt_state_from_reference`, for the JAX package's
    ``ErnieForSequenceClassification``: the encoder's blocks are
    ``ernie.layers.<i>.*``, stacked ``ernie.layers.stacked_<name with .
    -> __>``; the ``nn.Linear`` weights (qkv, out, up, down, pooler,
    classifier) swap ``[in, out]`` to ``[out, in]``."""
    return _from_reference(state, _ERNIE_LINEARS, "ernie.layers", stacked)


def resnet_state_from_reference(state: Dict[str, np.ndarray]
                                ) -> Dict[str, torch.Tensor]:
    """Map ``{name: ndarray}`` from the JAX package's ResNet
    ``state_dict()`` (parameters and the BatchNorm buffers) to a state
    dict for :class:`paddle2_tpu_torch.vision.models.ResNet`: ``fc``'s
    weight swaps ``[in, out]`` to ``[out, in]``; everything else passes
    unchanged."""
    return _from_reference(state, ("fc.weight",), "", stacked=None)


def _swap_in_payloads(model, state: Dict[str, np.ndarray], make) -> None:
    """For each ``<path>.weight_int8`` in ``state``, put ``make(path,
    w_int8, w_scale, bias)`` at ``<path>`` on the model's device (bias in
    the model's parameter dtype, None where the state has none), then
    load every tensor of ``state``."""
    param = model.gpt.wte.weight
    for name in state:
        if not name.endswith(".weight_int8"):
            continue
        path = name[:-len(".weight_int8")]
        w = torch.from_numpy(np.ascontiguousarray(state[name]))
        s = torch.from_numpy(np.ascontiguousarray(state[path + ".w_scale"]))
        b = state.get(path + ".bias")
        b = None if b is None else torch.from_numpy(np.asarray(b)).to(
            param.dtype)
        parent, _, attr = path.rpartition(".")
        (model.get_submodule(parent) if parent else model).add_module(
            attr, make(path, w, s, b).to(param.device))
    model.load_state_dict(gpt_state_from_reference(state, stacked=False))


def load_weight_only_reference(model, state: Dict[str, np.ndarray],
                               quant_bits: int = 8):
    """Load a quantized JAX model's ``state`` (per-block names) into
    ``model``, a port ``GPTForCausalLM`` of the same configuration: each
    ``<path>.weight_int8`` swaps the Linear at ``<path>`` for a
    ``WeightOnlyLinear`` and ``_wo_head.weight_int8`` installs the
    ``WeightOnlyLMHead``, then every tensor of ``state`` is loaded.
    ``quant_bits`` is the payload's width (the state does not hold it).
    In place; returns ``model``."""
    def make(path, w, s, b):
        if path == "_wo_head":
            return WeightOnlyLMHead(w, s, quant_bits=quant_bits)
        return WeightOnlyLinear(w, s, b, quant_bits=quant_bits)
    _swap_in_payloads(model, state, make)
    return model


def load_quanted_reference(model, state: Dict[str, np.ndarray],
                           act_scales: Dict[str, float]):
    """Load a JAX GPT converted by ``PTQ.convert`` into ``model``, a port
    ``GPTForCausalLM`` of the same configuration (per-block names): each
    ``<path>.weight_int8`` in ``state`` swaps the Linear at ``<path>``
    for a :class:`~paddle2_tpu_torch.quantization.QuantedInferenceLinear`
    with its payload, scales and bias, then every tensor of ``state`` is
    loaded. ``act_scales`` maps each such ``<path>`` to the JAX layer's
    ``act_scale``, which is an attribute and not in ``state_dict()``. In
    place; returns ``model``."""
    missing = [n[:-len(".weight_int8")] for n in state
               if n.endswith(".weight_int8")
               and n[:-len(".weight_int8")] not in act_scales]
    if missing:
        raise ValueError(f"no act_scale for {missing}")
    _swap_in_payloads(model, state, lambda path, w, s, b:
                      QuantedInferenceLinear(w, s, b, act_scales[path]))
    return model
