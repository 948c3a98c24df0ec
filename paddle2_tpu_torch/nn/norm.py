"""LayerNorm with the JAX package's routes and mixed-precision numerics.

The layer is ``torch.nn.LayerNorm`` (same parameters, names and init);
its forward is :func:`paddle2_tpu_torch.nn.functional.layer_norm`, the
counterpart of the JAX package's ``F.layer_norm``: the fused LayerNorm
op under ``FLAGS_pallas_layer_norm``, else the JAX package's rounding
order outside pure f32 (see that module).
"""

from torch import nn

from .functional import layer_norm

__all__ = ["LayerNorm"]


class LayerNorm(nn.LayerNorm):
    """``torch.nn.LayerNorm`` whose forward is the port's
    ``layer_norm``."""

    def forward(self, x):
        return layer_norm(x, self.normalized_shape, self.weight, self.bias,
                          self.eps)
