"""Carry a JAX-package GPT's weights into the port.

The JAX package's ``nn.Linear`` stores its weight ``[in, out]``;
``torch.nn.Linear`` stores ``[out, in]``, so linear weights swap their
last two axes (``[L, in, out]`` -> ``[L, out, in]`` for stacked leaves).
Everything else (embeddings, LayerNorm, biases) has the same shape in
both. Names are the same, since the port's modules mirror the JAX
package's attribute names, stacked leaves included
(``gpt.h.stacked_<name with . -> __>``). The fused qkv columns stay
head-major ``[H, (q|k|v), D]``: the transpose moves the columns to rows
without reordering them.
"""

import re
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["gpt_state_from_reference"]

_LINEARS = ("attn.qkv.weight", "attn.out_proj.weight", "mlp.up.weight",
            "mlp.down.weight", "lm_head.weight")
_STACKED = "gpt.h.stacked_"
_BLOCK = re.compile(r"^gpt\.h\.(\d+)\.(.+)$")


def _unstack(state):
    out = {}
    for name, t in state.items():
        if not name.startswith(_STACKED):
            out[name] = t
            continue
        leaf = name[len(_STACKED):].replace("__", ".")
        for i in range(t.shape[0]):
            out[f"gpt.h.{i}.{leaf}"] = t[i]
    return out


def _stack(state):
    out, per = {}, defaultdict(dict)
    for name, t in state.items():
        m = _BLOCK.match(name)
        if m is None:
            out[name] = t
        else:
            per[m.group(2)][int(m.group(1))] = t
    for leaf, layers in per.items():
        out[_STACKED + leaf.replace(".", "__")] = torch.stack(
            [layers[i] for i in range(len(layers))])
    return out


def gpt_state_from_reference(state: Dict[str, np.ndarray],
                             stacked: Optional[bool] = None
                             ) -> Dict[str, torch.Tensor]:
    """Map ``{name: ndarray}`` from the JAX model's ``state_dict()``,
    per-block or stacked, to a state dict for
    :class:`~.gpt.GPTForCausalLM` (CPU float tensors; ``load_state_dict``
    copies them to the model's device and dtype). ``stacked`` is the
    layout of the result: True for ``[L, ...]`` leaves, False for
    per-block names, None for the layout of ``state``."""
    out: Dict[str, torch.Tensor] = {}
    for name, arr in state.items():
        a = np.asarray(arr)
        if name.replace("__", ".").endswith(_LINEARS):
            a = np.swapaxes(a, -1, -2)
        out[name] = torch.from_numpy(np.ascontiguousarray(a))
    is_stacked = any(n.startswith(_STACKED) for n in out)
    if stacked is None or stacked == is_stacked:
        return out
    return _stack(out) if stacked else _unstack(out)
