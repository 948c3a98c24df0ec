"""Normalization functionals: the counterpart of
``paddle2_tpu/nn/functional/norm.py``. ``instance_norm``,
``group_norm``, ``local_response_norm`` and ``rms_norm`` are the JAX
package's XLA functions in torch, in the input dtype as there
(``rms_norm`` in f32, cast back); ``layer_norm`` and ``batch_norm``
are described below (``:72-131`` and ``:23-69`` there).

``batch_norm`` is the JAX function op for op, not
``torch.nn.functional.batch_norm``, for two reasons. The running
variance is the population (biased) variance, where torch's is the
unbiased one; and Paddle's ``momentum=0.9`` keeps 0.9 of the old
statistic. Under AMP O2 the input is bf16 and γ/β stay f32: the batch
mean and variance come back in bf16 (each one rounding of an f32
reduction), ``(x - mean) * rsqrt(var + eps)`` runs in bf16, ``* γ``
promotes to f32, ``+ β`` stays f32, and the result is cast back to
bf16; the running update's ``(1 - momentum) * mean`` is a bf16 product
added to the f32 buffer. cuDNN's BatchNorm computes in f32 throughout
and gives another result. The running statistics are updated in place
on the buffers, once a call in training mode.

``layer_norm``:

Two routes, as in the JAX package:

* **Fused.** With ``FLAGS_pallas_layer_norm`` on, one normalized axis,
  both weight and bias given, and ``H <= 8192``, the call goes through
  the fused LayerNorm op (:mod:`paddle2_tpu_torch.kernels.
  fused_layer_norm`): the CUDA kernels for a CUDA tensor, their plain
  versions for a CPU tensor. Like the JAX gate, this one asks shapes
  only, never dtypes: a float16 LayerNorm (AMP with ``dtype="float16"``)
  reaches the kernels, and a dtype they do not take raises instead of
  taking the other route. The JAX package also asked
  ``pallas_ln.supported`` (``H % 128 == 0`` and a row count that tiles
  within a VMEM budget), a TPU limit the port does not carry over: the
  fused op takes every row count and every ``H`` up to 8192. So at a
  shape the TPU gate refused (say ``H = 200``, or 37 rows), the port
  computes the fused kernel's function (f32 statistics, one rounding)
  where the JAX package computed XLA's. ERNIE's and GPT's shapes pass
  the JAX gate. Above ``H = 8192`` the other route runs, as the JAX
  gate sends such shapes to XLA.

  On the CPU the two packages part on purpose. The JAX package never
  takes its Pallas kernel on a CPU device (``_use_pallas_ln`` is False
  there) and computes XLA's order; the port takes the fused route on a
  CPU tensor too, so that a CPU run computes the function the card
  computes. The two differ by where the rounding falls (one rounding
  of an f32 result against the steps of the input dtype) and by the
  order of the f32 sums.
* **Otherwise** the JAX package's mixed-precision order: normalise in
  the *input* dtype, multiply by the scale and add the shift in their
  own dtype (under AMP O2 the input is bf16 and the parameters stay f32,
  so the result is promoted to f32), cast back to the input dtype.
  ``torch.nn.functional.layer_norm`` with a bf16 input and f32
  parameters does neither, so this order is spelled out whenever a
  dtype is not f32. In pure f32 it is ``torch.nn.functional.layer_norm``:
  the same function in one pass.
"""

from typing import Sequence, Union

import torch
from torch.nn import functional as TF

from ...flags import flag_value
from ...kernels import fused_layer_norm as _fused
from ...amp.casting import amp_op

__all__ = ["batch_norm", "layer_norm", "instance_norm", "group_norm",
           "local_response_norm", "rms_norm"]


def _use_fused(x, n_axes, weight, bias) -> bool:
    """The JAX gate without its TPU limits: the flag, one normalized
    axis, weight and bias given, and a shape the kernels take."""
    return (flag_value("pallas_layer_norm") and n_axes == 1
            and _fused.supported(x, weight, bias))


@amp_op("layer_norm")
def layer_norm(x, normalized_shape: Union[int, Sequence[int]], weight=None,
               bias=None, epsilon: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the trailing ``normalized_shape`` axes of ``x``."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    normalized_shape = tuple(normalized_shape)
    if _use_fused(x, len(normalized_shape), weight, bias):
        return _fused.fused_layer_norm(x, weight, bias, epsilon)
    if x.dtype == torch.float32 and all(
            t is None or t.dtype == torch.float32 for t in (weight, bias)):
        return TF.layer_norm(x, normalized_shape, weight, bias, epsilon)
    dims = tuple(range(-len(normalized_shape), 0))
    mean = x.mean(dims, keepdim=True)
    var = x.var(dims, keepdim=True, correction=0)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)


@amp_op("batch_norm")
def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training: bool = False, momentum: float = 0.9,
               epsilon: float = 1e-5, data_format: str = "NCHW",
               use_global_stats=None) -> torch.Tensor:
    """Normalize ``x`` per channel with the batch's statistics in
    training mode (and fold them into ``running_mean``/``running_var``
    in place), else with the running ones."""
    ch = 1 if data_format.startswith("NC") else x.ndim - 1
    reduce_axes = tuple(i for i in range(x.ndim) if i != ch)
    shape = [1] * x.ndim
    shape[ch] = x.shape[ch]
    use_batch_stats = training and not use_global_stats
    if use_batch_stats:
        mean = x.mean(reduce_axes)
        var = x.var(reduce_axes, correction=0)
    else:
        mean, var = running_mean, running_var
    out = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                  + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    if use_batch_stats:
        with torch.no_grad():
            running_mean.copy_(momentum * running_mean
                               + (1 - momentum) * mean)
            running_var.copy_(momentum * running_var + (1 - momentum) * var)
    return out.to(x.dtype)


def _channel_shape(x, ch):
    shape = [1] * x.ndim
    shape[ch] = x.shape[ch]
    return shape


def _affine(out, weight, bias, shape):
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


@amp_op("rms_norm")
def rms_norm(x, weight=None, epsilon=1e-6, name=None) -> torch.Tensor:
    """RMSNorm over the last axis in f32 (as the JAX function, for bf16
    stability), cast back to the input dtype."""
    h = x.float()
    out = h * torch.rsqrt((h * h).mean(-1, keepdim=True) + epsilon)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)


@amp_op("instance_norm")
def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None) -> torch.Tensor:
    """Each sample's channels normalized over their spatial axes (the
    running statistics are taken and, as in the JAX function, unused)."""
    ch = 1 if data_format.startswith("NC") else x.ndim - 1
    axes = tuple(range(2, x.ndim)) if ch == 1 else tuple(range(1, x.ndim - 1))
    mean = x.mean(axes, keepdim=True)
    var = x.var(axes, keepdim=True, correction=0)
    out = (x - mean) * torch.rsqrt(var + eps)
    return _affine(out, weight, bias, _channel_shape(x, ch)).to(x.dtype)


@amp_op("group_norm")
def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None) -> torch.Tensor:
    channel_last = not data_format.startswith("NC")
    a = x.movedim(-1, 1) if channel_last else x
    n, c = a.shape[0], a.shape[1]
    g = a.reshape(n, num_groups, c // num_groups, *a.shape[2:])
    axes = tuple(range(2, g.ndim))
    mean = g.mean(axes, keepdim=True)
    var = g.var(axes, keepdim=True, correction=0)
    out = ((g - mean) * torch.rsqrt(var + epsilon)).reshape(a.shape)
    out = _affine(out, weight, bias, _channel_shape(out, 1))
    if channel_last:
        out = out.movedim(1, -1)
    return out.to(x.dtype)


@amp_op("local_response_norm")
def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None) -> torch.Tensor:
    """``x / (k + alpha * s / size) ** beta``, ``s`` the sum of squares
    over a window of ``size`` channels (zero-padded, ``size // 2``
    before)."""
    ch = 1 if data_format.startswith("NC") else x.ndim - 1
    half = size // 2
    pad = [0, 0] * (x.ndim - 1 - ch) + [half, size - half - 1]
    sq = TF.pad(x * x, pad)
    c = x.shape[ch]
    s = sum(sq.narrow(ch, j, c) for j in range(size))
    return x / torch.pow(k + alpha * s / size, beta)
