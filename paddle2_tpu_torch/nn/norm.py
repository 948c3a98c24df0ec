"""LayerNorm with the JAX package's mixed-precision numerics.

Counterpart of ``paddle2_tpu/nn/functional/norm.py:113-122`` (the
non-Pallas ``layer_norm``). The JAX package normalises in the *input*
dtype, multiplies by the scale and adds the shift in their own dtype
(under AMP O2 the input is bf16 and the parameters stay f32, so the
result is promoted to f32) and casts back to the input dtype.
``torch.nn.LayerNorm`` with a bf16 input and f32 parameters does
neither, so this module mirrors that order whenever the dtypes differ
or are not f32. In f32 it is ``F.layer_norm``: the same function in one
pass.
"""

import torch
from torch import nn
from torch.nn import functional as F

__all__ = ["LayerNorm"]


class LayerNorm(nn.LayerNorm):
    """``torch.nn.LayerNorm`` (same parameters, names and init) with
    the JAX package's rounding order outside pure f32."""

    def forward(self, x):
        w, b = self.weight, self.bias
        if x.dtype == w.dtype == b.dtype == torch.float32:
            return F.layer_norm(x, self.normalized_shape, w, b, self.eps)
        dims = tuple(range(-len(self.normalized_shape), 0))
        mean = x.mean(dims, keepdim=True)
        var = x.var(dims, keepdim=True, correction=0)
        out = (x - mean) * torch.rsqrt(var + self.eps)
        return (out * w + b).to(x.dtype)
