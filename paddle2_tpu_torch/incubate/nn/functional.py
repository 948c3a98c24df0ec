"""paddle.incubate.nn.functional: the counterpart of
``paddle2_tpu/incubate/nn/functional.py``, with the same names in the
same order.

Four functions reach the port's kernels:
- :func:`fused_rms_norm` runs the RMSNorm forward and backward kernels
  (:mod:`paddle2_tpu_torch.kernels.fused_rms_norm`);
- :func:`fused_rotary_position_embedding` with
  ``use_neox_rotary_style=False`` runs the RoPE kernel
  (:mod:`paddle2_tpu_torch.kernels.fused_rope`), forward and backward;
  the neox (adjacent-pair) style is plain torch, as the JAX package's
  XLA route;
- :func:`fused_adamw_kernel` runs the flat AdamW kernel
  (:func:`paddle2_tpu_torch.kernels.fused_adamw.adamw_flat`);
- :func:`fused_linear_cross_entropy` runs the chunked LM-head loss.

On CPU tensors they run the kernels' plain versions. The JAX package
takes its RoPE kernel only on an accelerator and computes the CPU route
in the input dtype; the port's kernel route computes in f32 on both
devices, so a bf16 call on the CPU differs from the JAX CPU route by
bf16 rounding.

The rest are plain torch, as they are plain jnp in the JAX package:
gelu is the tanh form (``jax.nn.gelu``'s default); dropout draws from an
explicit ``generator`` (a ``torch.Generator``, or the global one when
None); ``fused_moe``, ``masked_multihead_attention`` and
``block_multihead_attention`` raise ``NotImplementedError``, as there.
"""

import math
from typing import Optional

import numpy as np
import torch
from torch.nn import functional as F

from ...kernels.fused_adamw import fused_adamw as _fused_adamw
from ...kernels.fused_ce import fused_linear_cross_entropy as _fused_ce
from ...kernels.fused_rms_norm import fused_rms_norm as _rms_norm
from ...kernels.fused_rope import fused_rope as _fused_rope
from ...amp.casting import amp_op

__all__ = ["fused_linear_cross_entropy", "fused_rotary_position_embedding",
           "fused_rms_norm", "fused_adamw_kernel", "swiglu",
           "fused_matmul_bias", "fused_linear", "fused_linear_activation",
           "fused_bias_act", "fused_dropout_add", "fused_layer_norm",
           "fused_bias_dropout_residual_layer_norm", "fused_feedforward",
           "fused_multi_head_attention", "fused_moe",
           "masked_multihead_attention", "block_multihead_attention",
           "blha_get_max_len",
           "variable_length_memory_efficient_attention",
           "fused_multi_transformer"]

# (rows, D, base, neox, dtype, device) -> (cos, sin); at most 64 entries
_ANGLE_CACHE: dict = {}
_ANGLE_CACHE_MAX = 64
# an angle table sized for position_ids past S takes whole buckets of rows
_TABLE_BUCKET = 1024


def _angle_table(S, D, base, neox, dtype, device):
    """Memoised rotary angle tables (a decode loop calls once a step):
    built in float64 numpy, then rounded once to ``dtype``, as
    ``_angle_table`` in the JAX package."""
    key = (S, D, base, neox, dtype, str(device))
    hit = _ANGLE_CACHE.get(key)
    if hit is not None:
        return hit
    inv = 1.0 / (base ** (np.arange(0, D, 2, dtype=np.float64) / D))
    ang = np.arange(S, dtype=np.float64)[:, None] * inv[None]
    full = np.repeat(ang, 2, axis=1) if neox \
        else np.concatenate([ang, ang], axis=1)
    out = tuple(torch.from_numpy(f(full)).to(device=device, dtype=dtype)
                for f in (np.cos, np.sin))
    if len(_ANGLE_CACHE) >= _ANGLE_CACHE_MAX:
        _ANGLE_CACHE.clear()
    _ANGLE_CACHE[key] = out
    return out


def _gather_rows(table, pos):
    """``table[pos]`` with JAX's gather semantics: a negative index counts
    from the end, and an index past either end clamps to it (on the
    device a raw index past the table would read out of bounds)."""
    T = table.shape[0]
    pos = pos.to(device=table.device, dtype=torch.long)
    pos = torch.where(pos < 0, pos + T, pos).clamp(0, T - 1)
    return table[pos]


@amp_op("fused_rope")
def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style: bool = True,
                                    time_major: bool = False,
                                    rotary_emb_base: float = 10000.0):
    """Rotary embedding of q, k and v (each ``[B, S, H, D]``, each rotated
    when passed); returns ``(q_out, k_out, v_out)`` with None passed
    through.

    ``use_neox_rotary_style=False`` (the half-split convention) runs the
    RoPE kernel; the default neox style rotates adjacent pairs in plain
    torch. Without ``cos``/``sin`` the tables are built for
    ``rotary_emb_base`` in the input's dtype; with ``position_ids`` whose
    largest value reaches S, they take ``ceil((max+1)/1024)·1024`` rows.
    Explicit tables longer than S (no ``position_ids``) are cut to S;
    shorter ones raise. ``position_ids`` ``[B, S]`` gather table rows,
    clamped to the table."""
    first = next(t for t in (q, k, v) if t is not None)
    if time_major:
        raise NotImplementedError("time_major=True: transpose to "
                                  "[batch, seq, heads, dim] first")
    B, S, H, D = first.shape
    if sin is None or cos is None:
        rows = S
        if position_ids is not None:
            max_pos = int(torch.as_tensor(position_ids).max())
            if max_pos >= S:
                rows = -(-(max_pos + 1) // _TABLE_BUCKET) * _TABLE_BUCKET
        cos_a, sin_a = _angle_table(rows, D, float(rotary_emb_base),
                                    bool(use_neox_rotary_style),
                                    first.dtype, first.device)
    else:
        cos_a = cos.reshape(-1, D)
        sin_a = sin.reshape(-1, D)
        if cos_a.shape[0] != S and position_ids is None:
            if cos_a.shape[0] > S:
                # a max-position table: positions are 0..S-1 here
                cos_a, sin_a = cos_a[:S], sin_a[:S]
            else:
                raise ValueError(
                    f"cos/sin table has {cos_a.shape[0]} positions but "
                    f"seq_len is {S}; pass position_ids or a table with "
                    "at least seq_len rows")
    if position_ids is not None:
        pos = torch.as_tensor(position_ids)
        cos_a = _gather_rows(cos_a, pos).reshape(B * S, D)
        sin_a = _gather_rows(sin_a, pos).reshape(B * S, D)

    def rot_one(arr):
        if not use_neox_rotary_style:
            return _fused_rope(arr, cos_a, sin_a)
        c = cos_a.reshape(-1, S, 1, D)
        s = sin_a.reshape(-1, S, 1, D)
        rot = torch.stack([-arr[..., 1::2], arr[..., 0::2]],
                          dim=-1).reshape(arr.shape)
        return arr * c + rot * s

    return tuple(None if t is None else rot_one(t) for t in (q, k, v))


@amp_op("fused_rms_norm")
def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon: float = 1e-6,
                   begin_norm_axis: int = -1, bias=None, residual=None):
    """RMSNorm of ``x + bias + residual`` over the last axis on the
    kernels, plus ``norm_bias``. Returns ``(out, x + bias + residual)``
    when ``residual`` is given, else ``out``. Only the last axis is
    normalised: another ``begin_norm_axis`` raises."""
    nd = x.dim()
    if begin_norm_axis not in (-1, nd - 1):
        raise NotImplementedError(
            f"fused_rms_norm normalizes the LAST axis only "
            f"(begin_norm_axis={begin_norm_axis}, ndim={nd}); reshape "
            "so the normalized dims are flattened into the last axis")
    pre = x
    if bias is not None:
        pre = pre + bias
    if residual is not None:
        pre = pre + residual
    out = _rms_norm(pre, norm_weight, epsilon=epsilon)
    if norm_bias is not None:
        out = out + norm_bias
    if residual is not None:
        return out, pre
    return out


def fused_adamw_kernel(param, grad, m, v, master, lr, beta1=0.9,
                       beta2=0.999, epsilon=1e-8, weight_decay=0.01,
                       step=1):
    """One flat AdamW step with an f32 master on the kernel: returns new
    ``(param, m, v, master)`` (param in its dtype, the rest f32), which do
    not require gradients; nothing is updated in place."""
    with torch.no_grad():
        outs = _fused_adamw(*(t.detach().contiguous() for t in
                              (param, grad, m, v, master)), lr, beta1,
                            beta2, epsilon, weight_decay, step)
    return tuple(outs)


@amp_op("fused_linear_cross_entropy")
def fused_linear_cross_entropy(x, weight, label, ignore_index: int = -100,
                               reduction: str = "mean", name=None):
    """Cross-entropy of ``softmax(x @ weight)`` without holding the
    ``[N, vocab]`` logits (:mod:`paddle2_tpu_torch.kernels.fused_ce`).

    x: ``[N, hidden]`` or ``[B, S, hidden]``; weight: ``[hidden,
    vocab]``; label: int ``[N]`` or ``[B, S]``. reduction: "mean" over
    the tokens not ignored, "sum" or "none"."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    # operands of two dtypes (an O2-decorated head under O1: f32 hidden
    # states over f16 weights) take the promoted type, as the JAX
    # package's matmul does
    dt = torch.promote_types(x.dtype, weight.dtype)
    losses, valid = _fused_ce(x.reshape(-1, x.shape[-1]).to(dt),
                              weight.to(dt), label.reshape(-1),
                              int(ignore_index))
    if reduction == "mean":
        return losses.sum() / valid.float().sum().clamp_min(1.0)
    if reduction == "sum":
        return losses.sum()
    return losses.reshape(label.shape)


# ------------------------------------------------------ plain functions

def _gelu(a):
    return F.gelu(a, approximate="tanh")


def _swiglu_split(a):
    u, w = a.chunk(2, dim=-1)
    return F.silu(u) * w


_LINEAR_ACTS = {"gelu": _gelu, "relu": F.relu, "none": lambda a: a,
                None: lambda a: a}
_BIAS_ACTS = {"gelu": _gelu, "relu": F.relu, "swiglu": _swiglu_split,
              "silu": F.silu}


def _act(table, name):
    if name not in table:
        raise ValueError(f"unknown activation {name!r}; one of "
                         f"{[k for k in table if k is not None]}")
    return table[name]


def _dropout(a, p, mode, generator):
    """A Bernoulli(1-p) keep mask from ``generator``; kept values scaled
    by ``1/(1-p)`` in "upscale_in_train" mode, as they are."""
    keep = torch.rand(a.shape, generator=generator, device=a.device) \
        < 1.0 - p
    if mode == "upscale_in_train":
        return torch.where(keep, a / (1.0 - p), torch.zeros_like(a))
    return torch.where(keep, a, torch.zeros_like(a))


@amp_op("swiglu")
def swiglu(x, y=None, name=None):
    """``silu(x) * y``; with one input, its last axis split in half."""
    if y is None:
        return _swiglu_split(x)
    return F.silu(x) * y


@amp_op("fused_matmul_bias")
def fused_matmul_bias(x, y, bias=None, transpose_x: bool = False,
                      transpose_y: bool = False, name=None):
    """``x @ y + bias``, either operand transposed over its last two
    axes first."""
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    out = x @ y
    if bias is not None:
        out = out + bias
    return out


def fused_linear(x, weight, bias=None, transpose_weight: bool = False,
                 name=None):
    return fused_matmul_bias(x, weight, bias, transpose_y=transpose_weight)


def fused_linear_activation(x, y, bias=None, trans_x: bool = False,
                            trans_y: bool = False, activation="gelu",
                            name=None):
    """:func:`fused_matmul_bias` then gelu (tanh form), relu or none."""
    act = _act(_LINEAR_ACTS, activation)
    return act(fused_matmul_bias(x, y, bias, trans_x, trans_y))


@amp_op("fused_bias_act")
def fused_bias_act(x, bias=None, dequant_scales=None, shift=None,
                   smooth=None, act_method="gelu", compute_dtype="default",
                   quant_scale=-1, quant_round_type=0, quant_max_bound=0,
                   quant_min_bound=0, name=None):
    """``act(x + bias)``: gelu (tanh form), relu, swiglu (the last axis
    split in half) or silu. The quantisation arguments are taken and
    unused, as in the JAX package."""
    act = _act(_BIAS_ACTS, act_method)
    if bias is not None:
        x = x + bias
    return act(x)


@amp_op("fused_dropout_add")
def fused_dropout_add(x, y, p=0.5, training: bool = True,
                      mode="upscale_in_train", name=None, *,
                      generator: Optional[torch.Generator] = None):
    """``dropout(x) + y``; with ``p == 0`` or out of training, ``x + y``
    (no scaling in either mode, as in the JAX package)."""
    if not training or p == 0:
        return x + y
    return _dropout(x, p, mode, generator) + y


@amp_op("fused_layer_norm")
def fused_layer_norm(x, norm_weight, norm_bias, epsilon=1e-5,
                     residual_alpha=1.0, begin_norm_axis=1, bias=None,
                     residual=None, quant_scale=-1, quant_round_type=0,
                     quant_max_bound=0, quant_min_bound=0, name=None):
    """LayerNorm of ``x + bias + residual_alpha·residual`` over every axis
    from ``begin_norm_axis`` on (1 by default: all but the batch axis),
    in the input's dtype. Returns ``(out, residual_out)`` when
    ``residual`` is given."""
    a = x
    if bias is not None:
        a = a + bias
    if residual is not None:
        a = a + residual_alpha * residual
    red = tuple(range(begin_norm_axis % a.dim(), a.dim()))
    mu = a.mean(dim=red, keepdim=True)
    var = ((a - mu) ** 2).mean(dim=red, keepdim=True)
    out = (a - mu) / torch.sqrt(var + epsilon)
    if norm_weight is not None:
        out = out * norm_weight
    if norm_bias is not None:
        out = out + norm_bias
    return (out, a) if residual is not None else out


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias=None, ln_scale=None, ln_bias=None,
        dropout_rate=0.5, ln_epsilon=1e-5, training: bool = True,
        mode="upscale_in_train", name=None, *,
        generator: Optional[torch.Generator] = None):
    """``LayerNorm(residual + dropout(x + bias))`` over the last axis."""
    y = fused_dropout_add(x if bias is None else x + bias, residual,
                          p=dropout_rate, training=training, mode=mode,
                          generator=generator)
    return fused_layer_norm(y, ln_scale, ln_bias, epsilon=ln_epsilon,
                            begin_norm_axis=y.dim() - 1)


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm: bool = False, training: bool = True,
                      mode="upscale_in_train", name=None, *,
                      generator: Optional[torch.Generator] = None):
    """The transformer FFN block: (pre-LN), linear1, the activation,
    dropout, linear2, dropout + residual, (post-LN)."""
    h = x
    if pre_layer_norm and ln1_scale is not None:
        h = fused_layer_norm(h, ln1_scale, ln1_bias, epsilon=ln1_epsilon,
                             begin_norm_axis=h.dim() - 1)
    h = fused_linear_activation(h, linear1_weight, linear1_bias,
                                activation=activation)
    if training and dropout1_rate:
        h = _dropout(h, dropout1_rate, "upscale_in_train", generator)
    h = fused_linear(h, linear2_weight, linear2_bias)
    h = fused_dropout_add(h, x, p=dropout2_rate, training=training,
                          mode=mode, generator=generator)
    if not pre_layer_norm and ln2_scale is not None:
        h = fused_layer_norm(h, ln2_scale, ln2_bias, epsilon=ln2_epsilon,
                             begin_norm_axis=h.dim() - 1)
    return h


@amp_op("fused_mha")
def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm: bool = False,
                               pre_ln_scale=None, pre_ln_bias=None,
                               ln_scale=None, ln_bias=None,
                               pre_ln_epsilon=1e-5, qkv_bias=None,
                               linear_bias=None, cache_kv=None,
                               attn_mask=None, dropout_rate=0.5,
                               attn_dropout_rate=0.5, ln_epsilon=1e-5,
                               training: bool = True,
                               mode="upscale_in_train", ring_id=-1,
                               add_residual: bool = True, name=None, *,
                               generator: Optional[torch.Generator] = None):
    """The multi-head attention block with a fused qkv weight
    ``[3, heads, head_dim, hidden]``: (pre-LN), qkv, softmax attention in
    the input's dtype (+ ``attn_mask``, probabilities dropped out in
    training), the out projection, dropout + residual, (post-LN)."""
    if cache_kv is not None:
        raise NotImplementedError(
            "fused_multi_head_attention cache_kv is a decode path; use "
            "paddle2_tpu_torch.serving.ServingEngine for decode")
    h = x
    if pre_layer_norm and pre_ln_scale is not None:
        h = fused_layer_norm(h, pre_ln_scale, pre_ln_bias,
                             epsilon=pre_ln_epsilon,
                             begin_norm_axis=h.dim() - 1)
    B, S, _ = h.shape
    _, nh, hd, _ = qkv_weight.shape
    qkv = torch.einsum("bsh,tndh->tbsnd", h, qkv_weight)
    if qkv_bias is not None:
        qkv = qkv + qkv_bias[:, None, None]
    q, k, v = qkv[0], qkv[1], qkv[2]
    scores = torch.einsum("bsnd,btnd->bnst", q, k) / np.sqrt(hd)
    if attn_mask is not None:
        scores = scores + attn_mask
    p = torch.softmax(scores, dim=-1)
    if training and attn_dropout_rate:
        p = _dropout(p, attn_dropout_rate, "upscale_in_train", generator)
    ctx = torch.einsum("bnst,btnd->bsnd", p, v).reshape(B, S, nh * hd)
    out = fused_linear(ctx, linear_weight, linear_bias)
    if add_residual:
        out = fused_dropout_add(out, x, p=dropout_rate, training=training,
                                mode=mode, generator=generator)
    if not pre_layer_norm and ln_scale is not None:
        out = fused_layer_norm(out, ln_scale, ln_bias, epsilon=ln_epsilon,
                               begin_norm_axis=out.dim() - 1)
    return out


def fused_moe(x, gate_weight, ffn1_weights, ffn2_weights, *args, **kwargs):
    raise NotImplementedError(
        "fused_moe's monolithic kernel has no counterpart in the port; "
        "the MoE layer is ROADMAP queue 1 item 7")


def masked_multihead_attention(x, cache_kv=None, bias=None, src_mask=None,
                               *args, **kwargs):
    raise NotImplementedError(
        "masked_multihead_attention is a serving decode kernel; use "
        "paddle2_tpu_torch.serving.ServingEngine (paged decode)")


def block_multihead_attention(*args, **kwargs):
    raise NotImplementedError(
        "block_multihead_attention (paged KV cache) is a serving kernel; "
        "use paddle2_tpu_torch.serving.ServingEngine (paged decode)")


def blha_get_max_len(seq_lens_encoder, seq_lens_decoder, batch_size):
    """The largest encoder and decoder lengths, each as an int32 ``[1]``
    tensor on the lengths' device (0 for an empty batch)."""
    out = []
    for lens in (seq_lens_encoder, seq_lens_decoder):
        lens = torch.as_tensor(lens)
        top = int(lens.max()) if lens.numel() else 0
        out.append(torch.tensor([top], dtype=torch.int32,
                                device=lens.device))
    return tuple(out)


@amp_op("varlen_mem_eff_attn")
def variable_length_memory_efficient_attention(query, key, value, seq_lens,
                                               kv_seq_lens, mask=None,
                                               scale=None, causal=False,
                                               pre_cache_length=0):
    """Attention on ``[B, H, S, D]`` over each sequence's first
    ``seq_lens`` queries and ``kv_seq_lens`` keys (causal optionally,
    ``mask`` an additive bias); masked scores take -1e9, so rows past a
    length see a uniform softmax, as in the JAX package."""
    _, _, S, D = query.shape
    sc = scale if scale is not None else 1.0 / math.sqrt(D)
    scores = torch.einsum("bhsd,bhtd->bhst", query, key) * sc
    if mask is not None:
        scores = scores + mask
    q_pos = torch.arange(S, device=query.device)[None, None, :, None]
    k_pos = torch.arange(key.shape[2], device=query.device)[
        None, None, None, :]
    sl = torch.as_tensor(seq_lens, device=query.device).reshape(-1)
    kl = torch.as_tensor(kv_seq_lens, device=query.device).reshape(-1)
    valid = ((q_pos < sl[:, None, None, None])
             & (k_pos < kl[:, None, None, None]))
    if causal:
        valid = valid & (k_pos <= q_pos)
    scores = torch.where(valid, scores, torch.full_like(scores, -1e9))
    return torch.einsum("bhst,bhtd->bhsd", torch.softmax(scores, dim=-1),
                        value)


def fused_multi_transformer(x, ln_scales, ln_biases, qkv_weights,
                            qkv_biases, linear_weights, linear_biases,
                            ffn_ln_scales, ffn_ln_biases, ffn1_weights,
                            ffn1_biases, ffn2_weights, ffn2_biases,
                            pre_layer_norm: bool = True, epsilon=1e-5,
                            cache_kvs=None, time_step=None, attn_mask=None,
                            dropout_rate=0.0, activation="gelu",
                            training: bool = False, mode="upscale_in_train",
                            trans_qkvw: bool = True, ring_id=-1, name=None,
                            *, generator: Optional[torch.Generator] = None):
    """A stack of pre-LN transformer layers, each
    :func:`fused_multi_head_attention` then :func:`fused_feedforward`.
    qkv weights are ``[3, heads, head_dim, hidden]``, or ``[hidden, 3,
    heads, head_dim]`` with ``trans_qkvw=False``."""
    h = x
    if not trans_qkvw:
        qkv_weights = [w.permute(1, 2, 3, 0) for w in qkv_weights]
    for i in range(len(qkv_weights)):
        h = fused_multi_head_attention(
            h, qkv_weights[i], linear_weights[i], pre_layer_norm=True,
            pre_ln_scale=ln_scales[i],
            pre_ln_bias=ln_biases[i] if ln_biases else None,
            qkv_bias=qkv_biases[i] if qkv_biases else None,
            linear_bias=linear_biases[i] if linear_biases else None,
            attn_mask=attn_mask, dropout_rate=dropout_rate,
            attn_dropout_rate=dropout_rate, training=training, mode=mode,
            pre_ln_epsilon=epsilon, generator=generator)
        h = fused_feedforward(
            h, ffn1_weights[i], ffn2_weights[i],
            linear1_bias=ffn1_biases[i] if ffn1_biases else None,
            linear2_bias=ffn2_biases[i] if ffn2_biases else None,
            ln1_scale=ffn_ln_scales[i],
            ln1_bias=ffn_ln_biases[i] if ffn_ln_biases else None,
            dropout1_rate=dropout_rate, dropout2_rate=dropout_rate,
            activation=activation, pre_layer_norm=True,
            ln1_epsilon=epsilon, training=training, mode=mode,
            generator=generator)
    return h
