"""Carry a JAX-package GPT's weights into the port.

The JAX package's ``nn.Linear`` stores its weight ``[in, out]``;
``torch.nn.Linear`` stores ``[out, in]``. Everything else (embeddings,
LayerNorm, biases) has the same shape in both. Names are the same,
since the port's modules mirror the JAX package's attribute names. The
fused qkv columns stay head-major ``[H, (q|k|v), D]``: the transpose
moves the columns to rows without reordering them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["gpt_state_from_reference"]

_LINEARS = ("attn.qkv.weight", "attn.out_proj.weight", "mlp.up.weight",
            "mlp.down.weight", "lm_head.weight")


def gpt_state_from_reference(state: Dict[str, np.ndarray]
                             ) -> Dict[str, torch.Tensor]:
    """Map ``{name: ndarray}`` from the JAX model's ``state_dict()`` to a
    state dict for :class:`~.gpt.GPTForCausalLM` (CPU float tensors;
    ``load_state_dict`` copies them to the model's device and dtype)."""
    out: Dict[str, torch.Tensor] = {}
    for name, arr in state.items():
        a = np.asarray(arr)
        if name.endswith(_LINEARS):
            a = a.T
        out[name] = torch.from_numpy(np.ascontiguousarray(a))
    return out
