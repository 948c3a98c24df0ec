"""Fused LayerNorm, forward and backward: the CUDA kernels, their
wrappers, their plain versions and the differentiable op over them.

Counterpart of ``paddle2_tpu/kernels/pallas_ln.py`` (``_fwd_kernel``,
``_bwd_kernel`` and the ``fused_layer_norm`` custom_vjp). The kernels
are in ``csrc/layer_norm.cu``, whose note says what bounds them, how dγ
and dβ are summed without atomics, and each direction's two routes: the
vector routes (``layer_norm_fwd_vec_kernel``,
``layer_norm_bwd_vec_kernel``: rows in registers, 16-byte loads) for
every row that 16-byte vectors take, the general routes
(``layer_norm_fwd_kernel``; ``layer_norm_bwd_kernel``) for the rest
(:func:`.row_vec.route`); both backwards end with
``layer_norm_bwd_reduce_kernel``.
LayerNorm over the last axis of ``x [..., H]`` with an affine
``weight`` and ``bias [H]``: x f32, bf16 or f16, the parameters f32,
bf16 or f16 of their own, any row count and ``1 <= H <= 8192``. The
JAX package's ``supported`` gate (``H % 128 == 0`` and a VMEM row
budget) is a TPU limit and is not carried over: :func:`supported` asks
the shape only, as that gate does.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel
or raises. Shapes and dtypes the kernels do not take raise on both
devices. The kernels take one dtype for weight and bias;
:func:`fused_layer_norm` casts a pair of two dtypes to their common one
first (exactly: the kernels compute in f32).

The differentiable op is ``torch.ops.paddle2_tpu_torch.layer_norm``, a
``torch.library`` custom op whose backward recomputes the row
statistics from ``x``: the saved residuals are ``(x, weight)`` only, as
in ``_fwd_rule``. Being a dispatcher op, the "dots" selective-checkpoint
policy (:func:`.attention.remat_policy`) sees it and recomputes it, as
the JAX package's remat re-runs the Pallas forward.
"""

import ctypes
import functools
from typing import Tuple

import torch

from . import _build, row_vec

__all__ = ["MAX_H", "supported", "fwd_route", "bwd_route",
           "layer_norm_fwd", "layer_norm_bwd", "layer_norm_fwd_reference",
           "layer_norm_bwd_reference", "bwd_blocks", "layer_norm",
           "fused_layer_norm"]

MAX_H = 8192
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x, g, b, y, R, H, x dtype, g dtype, eps, stream
    "layer_norm_fwd": [_P] * 4 + [ctypes.c_longlong, _I, _I, _I,
                                  ctypes.c_float, _P],
    # x, g, dy, dx, dg, db, ws, R, H, x dtype, g dtype, eps, blocks, stream
    "layer_norm_bwd": [_P] * 7 + [ctypes.c_longlong, _I, _I, _I,
                                  ctypes.c_float, _I, _P],
}


_lib = None  # the built library, bound at the first launch


def _library():
    global _lib
    if _lib is None:
        _lib = _build.library("layer_norm", _SIGNATURES)
    return _lib


def supported(x, weight, bias) -> bool:
    """Whether the fused op takes these shapes: ``x [..., H]`` with
    ``1 <= H <= MAX_H`` and ``weight`` and ``bias`` ``[H]``. Like the
    JAX package's gate it asks no dtype: a dtype the kernels do not
    take raises in the wrappers."""
    if x.dim() < 1 or weight is None or bias is None:
        return False
    H = x.shape[-1]
    return (1 <= H <= MAX_H and tuple(weight.shape) == (H,)
            and tuple(bias.shape) == (H,))


def _check(x, weight, bias) -> None:
    if not (supported(x, weight, bias) and x.dtype in _DTYPE_CODE
            and weight.dtype in _DTYPE_CODE and bias.dtype == weight.dtype):
        raise ValueError(
            f"fused LayerNorm takes x [..., H] float32/bfloat16/float16 with "
            f"1 <= H <= {MAX_H} and weight, bias [H] of one "
            f"float32/bfloat16/float16 dtype; "
            f"got x {x.dtype} {tuple(x.shape)}, weight "
            f"{getattr(weight, 'dtype', None)} "
            f"{tuple(getattr(weight, 'shape', ()))}, bias "
            f"{getattr(bias, 'dtype', None)}")
    if not (x.device == weight.device == bias.device):
        raise ValueError("x, weight and bias must lie on one device")


# ---------------------------------------------------------------- forward

def layer_norm_fwd_reference(x, weight, bias, eps: float) -> torch.Tensor:
    """The plain forward, the kernel's arithmetic in f32: the mean, the
    variance of the centred row (two passes), ``1/sqrt(v + eps)``, then
    ``xc·r·γ + β`` rounded once to x's dtype."""
    xf = x.float()
    m = xf.mean(-1, keepdim=True)
    xc = xf - m
    r = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    return (xc * r * weight.float() + bias.float()).to(x.dtype)


def fwd_route(x, weight, bias, y) -> str:
    """The forward kernel a CUDA call takes, as the C entry picks it:
    "vec" (``layer_norm_fwd_vec_kernel``) when 16-byte vectors take x's
    rows and x, γ, β and y start on 16-byte boundaries, else "general"
    (``layer_norm_fwd_kernel``)."""
    return row_vec.route(x.shape[-1] * x.element_size(), x.data_ptr(),
                         weight.data_ptr(), bias.data_ptr(), y.data_ptr())


def layer_norm_fwd(x, weight, bias, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis; returns y in x's dtype.
    ``layer_norm_fwd.launches`` counts the kernels' launches,
    ``layer_norm_fwd.route_launches`` those of each route
    (:func:`fwd_route`)."""
    _check(x, weight, bias)
    if not _build.on_card("layer_norm_fwd", x, weight, bias):
        return layer_norm_fwd_reference(x, weight, bias, float(eps))
    H = x.shape[-1]
    R = x.numel() // H
    y = torch.empty_like(x)
    if R == 0:
        return y
    args = (x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            R, H, _DTYPE_CODE[x.dtype], _DTYPE_CODE[weight.dtype],
            float(eps))
    route = row_vec.route(H * x.element_size(), *args[:4])
    dev = x.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            err = _library().layer_norm_fwd(
                *args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        err = _library().layer_norm_fwd(
            *args, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(_lib, err, "layer_norm_fwd")
    layer_norm_fwd.launches += 1
    layer_norm_fwd.route_launches[route] += 1
    return y


layer_norm_fwd.launches = 0
layer_norm_fwd.route_launches = dict.fromkeys(row_vec.ROUTES, 0)


# --------------------------------------------------------------- backward

def layer_norm_bwd_reference(x, weight, dy, eps: float
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The plain backward, as ``_bwd_kernel``: the row statistics
    recomputed from x, ``dx = (dy·γ − mean(dy·γ) − x̂·mean(dy·γ·x̂))·r``
    in x's dtype, ``dγ = Σ dy·x̂`` and ``dβ = Σ dy`` over the rows in f32,
    cast to γ's dtype."""
    H = x.shape[-1]
    xf = x.reshape(-1, H).float()
    dyf = dy.reshape(-1, H).float()
    m = xf.mean(-1, keepdim=True)
    xc = xf - m
    r = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xh = xc * r
    dxh = dyf * weight.float()
    dx = (dxh - dxh.mean(-1, keepdim=True)
          - xh * (dxh * xh).mean(-1, keepdim=True)) * r
    return (dx.to(x.dtype).reshape(x.shape),
            (dyf * xh).sum(0).to(weight.dtype), dyf.sum(0).to(weight.dtype))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def bwd_blocks(rows: int, device) -> int:
    """The backward's block count, four a streaming multiprocessor and at
    most one a row: the general route's grid, and the most blocks (rows
    of partial dγ and dβ sums) the vector route's persistent grid may
    take. Each grid fixes which rows each block sums, so it depends on
    the shape and the card only, never on timing."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    return max(1, min(rows, 4 * _sm_count(index)))


def bwd_route(x, weight, dy, dx, ws) -> str:
    """The backward kernel a CUDA call takes, as the C entry picks it:
    "vec" (``layer_norm_bwd_vec_kernel``) when 16-byte vectors take x's
    rows and x, γ, dy, dx and the partials' workspace start on 16-byte
    boundaries, else "general" (``layer_norm_bwd_kernel``)."""
    return row_vec.route(x.shape[-1] * x.element_size(), x.data_ptr(),
                         weight.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                         ws.data_ptr())


def layer_norm_bwd(x, weight, dy, eps: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx, dγ, dβ)``: dx in x's dtype, dγ and dβ in γ's.
    ``layer_norm_bwd.launches`` counts the kernels' launches (a call, the
    row kernel and the reduction of its partials, is one),
    ``layer_norm_bwd.route_launches`` those of each route
    (:func:`bwd_route`)."""
    _check(x, weight, weight)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {dy.dtype} {tuple(dy.shape)} must have x's "
                         f"dtype and shape {x.dtype} {tuple(x.shape)}")
    if not _build.on_card("layer_norm_bwd", x, weight, dy):
        return layer_norm_bwd_reference(x, weight, dy, float(eps))
    H = x.shape[-1]
    R = x.numel() // H
    dx = torch.empty_like(x)
    if R == 0:
        return dx, torch.zeros_like(weight), torch.zeros_like(weight)
    dg, db = torch.empty_like(weight), torch.empty_like(weight)
    G = bwd_blocks(R, x.device)
    ws = torch.empty(2 * G * H, dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.layer_norm_bwd(
            x.data_ptr(), weight.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dg.data_ptr(), db.data_ptr(), ws.data_ptr(), R, H,
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[weight.dtype], float(eps), G,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "layer_norm_bwd")
    layer_norm_bwd.launches += 1
    layer_norm_bwd.route_launches[bwd_route(x, weight, dy, dx, ws)] += 1
    return dx, dg, db


layer_norm_bwd.launches = 0
layer_norm_bwd.route_launches = dict.fromkeys(row_vec.ROUTES, 0)


# ----------------------------------------------------- differentiable op

@torch.library.custom_op(
    "paddle2_tpu_torch::layer_norm", mutates_args=(),
    schema="(Tensor x, Tensor weight, Tensor bias, float eps) -> Tensor")
def layer_norm(x, weight, bias, eps):
    """Differentiable fused LayerNorm on contiguous tensors: the forward
    is :func:`layer_norm_fwd`, the backward :func:`layer_norm_bwd` on the
    saved ``(x, weight)``."""
    return layer_norm_fwd(x, weight, bias, eps)


@layer_norm.register_fake
def _(x, weight, bias, eps):
    return torch.empty_like(x)


def _layer_norm_setup(ctx, inputs, output):
    x, weight, bias, eps = inputs
    ctx.save_for_backward(x, weight)
    ctx.eps = eps


def _layer_norm_backward(ctx, dy):
    x, weight = ctx.saved_tensors
    dx, dg, db = layer_norm_bwd(x, weight, dy.contiguous(), ctx.eps)
    return dx, dg, db, None


layer_norm.register_autograd(_layer_norm_backward,
                             setup_context=_layer_norm_setup)


def fused_layer_norm(x, weight, bias, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` through the differentiable
    op (``pallas_ln.fused_layer_norm``'s counterpart). A weight and a
    bias of two dtypes are cast to their common dtype (autograd casts
    their gradients back)."""
    if bias.dtype != weight.dtype:
        dt = torch.promote_types(weight.dtype, bias.dtype)
        weight, bias = weight.to(dt), bias.to(dt)
    return layer_norm(x.contiguous(), weight.contiguous(),
                      bias.contiguous(), float(eps))
