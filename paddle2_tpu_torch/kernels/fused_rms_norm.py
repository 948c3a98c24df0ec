"""Fused RMSNorm, forward and backward: the CUDA kernels, their wrappers,
their plain versions and the differentiable op over them.

Counterpart of ``_rmsnorm_fwd_kernel``, ``_rmsnorm_bwd_kernel``, the
``_rmsnorm`` custom_vjp and ``fused_rms_norm`` in
``paddle2_tpu/kernels/pallas_fused.py``. The kernels are in
``csrc/rms_norm.cu``, whose note says what bounds them, how dw is
summed without atomics, and each direction's two routes: the vector
routes (``rms_norm_fwd_vec_kernel``, ``rms_norm_bwd_vec_kernel``: rows in
registers, 16-byte loads) for every row that 16-byte vectors take, the
general routes (``rms_norm_fwd_kernel``; ``rms_norm_bwd_kernel`` and
``rms_norm_bwd_reduce_kernel``) for the rest (:func:`.row_vec.route`).
RMSNorm over the last axis of ``x [..., H]`` with a ``weight [H]``: x
f32, bf16 or f16, the weight f32, bf16 or f16 of its own, any row count
and ``1 <= H <= MAX_H``. The output and dx
take x's dtype, dw the weight's; the saved ``1/rms`` is f32 ``[R]``.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel
or raises. Shapes, dtypes and layouts the kernels do not take raise on
both devices.
"""

import ctypes
import functools
from typing import Tuple

import torch

from . import _build, row_vec

__all__ = ["MAX_H", "fwd_route", "bwd_route", "rms_norm_fwd",
           "rms_norm_bwd",
           "rms_norm_fwd_reference", "rms_norm_bwd_reference", "bwd_blocks",
           "fused_rms_norm"]

MAX_H = 16384
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x, w, o, r, R, H, x dtype, w dtype, eps, stream
    "rms_norm_fwd": [_P] * 4 + [ctypes.c_longlong, _I, _I, _I,
                                ctypes.c_float, _P],
    # x, w, r, do, dx, dw, ws, R, H, x dtype, w dtype, blocks, stream
    "rms_norm_bwd": [_P] * 7 + [ctypes.c_longlong, _I, _I, _I, _I, _P],
}


_lib = None  # the built library, bound at the first launch


def _library():
    global _lib
    if _lib is None:
        _lib = _build.library("rms_norm", _SIGNATURES)
    return _lib


def _check(x, weight) -> None:
    H = x.shape[-1] if x.dim() else 0
    if not (x.dim() >= 1 and 1 <= H <= MAX_H and weight is not None
            and tuple(weight.shape) == (H,) and x.dtype in _DTYPE_CODE
            and weight.dtype in _DTYPE_CODE):
        raise ValueError(
            f"fused RMSNorm takes x [..., H] float32/bfloat16/float16 with "
            f"1 <= H <= {MAX_H} and weight [H] float32/bfloat16/float16; "
            f"got x {x.dtype} {tuple(x.shape)}, weight "
            f"{getattr(weight, 'dtype', None)} "
            f"{tuple(getattr(weight, 'shape', ()))}")
    if x.device != weight.device:
        raise ValueError("x and weight must lie on one device")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("fused RMSNorm needs contiguous x and weight")


# ---------------------------------------------------------------- forward

def rms_norm_fwd_reference(x, weight, eps: float
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward, ``_rmsnorm_fwd_kernel``'s arithmetic: the mean
    square in f32, ``r = rsqrt(ms + eps)``, ``((x·r)·w)`` rounded once to
    x's dtype; returns ``(o, r)`` with r f32 ``[R]``."""
    H = x.shape[-1]
    xf = x.reshape(-1, H).float()
    r = torch.rsqrt((xf * xf).mean(-1) + eps)
    o = ((xf * r[:, None]) * weight.float()).to(x.dtype)
    return o.reshape(x.shape), r


def fwd_route(x, weight, o, r) -> str:
    """The forward kernel a CUDA call takes, as the C entry picks it:
    "vec" (``rms_norm_fwd_vec_kernel``) when 16-byte vectors take x's
    rows and x, the weight, o and r start on 16-byte boundaries, else
    "general" (``rms_norm_fwd_kernel``)."""
    return row_vec.route(x.shape[-1] * x.element_size(), x.data_ptr(),
                         weight.data_ptr(), o.data_ptr(), r.data_ptr())


def rms_norm_fwd(x, weight, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """RMSNorm over the last axis; returns ``(o, r)``: o in x's dtype and
    shape, r = 1/rms f32 ``[R]``. ``rms_norm_fwd.launches`` counts the
    kernels' launches, ``rms_norm_fwd.route_launches`` those of each
    route (:func:`fwd_route`)."""
    _check(x, weight)
    if not _build.on_card("rms_norm_fwd", x, weight):
        return rms_norm_fwd_reference(x, weight, float(eps))
    H = x.shape[-1]
    R = x.numel() // H
    dev = x.device
    o = torch.empty_like(x)
    r = torch.empty(R, dtype=torch.float32, device=dev)
    if R == 0:
        return o, r
    args = (x.data_ptr(), weight.data_ptr(), o.data_ptr(), r.data_ptr(), R,
            H, _DTYPE_CODE[x.dtype], _DTYPE_CODE[weight.dtype], float(eps))
    route = row_vec.route(H * x.element_size(), *args[:4])
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            err = _library().rms_norm_fwd(
                *args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        err = _library().rms_norm_fwd(
            *args, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(_lib, err, "rms_norm_fwd")
    rms_norm_fwd.launches += 1
    rms_norm_fwd.route_launches[route] += 1
    return o, r


rms_norm_fwd.launches = 0
rms_norm_fwd.route_launches = dict.fromkeys(row_vec.ROUTES, 0)


# --------------------------------------------------------------- backward

def rms_norm_bwd_reference(x, weight, r, dout
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain backward, ``_rmsnorm_bwd_kernel``'s arithmetic from the
    saved r: ``x̂ = x·r``, ``dy = do·w``, ``dx = r·(dy − x̂·mean(dy·x̂))``
    in x's dtype, ``dw = Σ_rows do·x̂`` in f32 cast to w's dtype."""
    H = x.shape[-1]
    xh = x.reshape(-1, H).float() * r[:, None]
    do = dout.reshape(-1, H).float()
    dy = do * weight.float()
    mt = (dy * xh).mean(-1, keepdim=True)
    dx = (r[:, None] * (dy - xh * mt)).to(x.dtype)
    return dx.reshape(x.shape), (do * xh).sum(0).to(weight.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def bwd_blocks(rows: int, device) -> int:
    """The backward's block count, four a streaming multiprocessor and at
    most one a row: the general route's grid, and the most blocks (rows
    of partial dw sums) the vector route's persistent grid may take. Each
    grid fixes which rows each block sums into dw, so it depends on the
    shape and the card only, never on timing."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    return max(1, min(rows, 4 * _sm_count(index)))


def bwd_route(x, weight, dout, dx, ws) -> str:
    """The backward kernel a CUDA call takes, as the C entry picks it:
    "vec" (``rms_norm_bwd_vec_kernel``) when 16-byte vectors take x's
    rows and x, the weight, do, dx and the partials' workspace start on
    16-byte boundaries, else "general" (``rms_norm_bwd_kernel``)."""
    return row_vec.route(x.shape[-1] * x.element_size(), x.data_ptr(),
                         weight.data_ptr(), dout.data_ptr(), dx.data_ptr(),
                         ws.data_ptr())


def rms_norm_bwd(x, weight, r, dout) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)`` from x, the weight, the forward's r and the output
    gradient: dx in x's dtype, dw in the weight's.
    ``rms_norm_bwd.launches`` counts the kernels' launches (a call of the
    general route, the row kernel and the reduction of its partials, is
    one), ``rms_norm_bwd.route_launches`` those of each route
    (:func:`bwd_route`)."""
    _check(x, weight)
    if (dout.shape != x.shape or dout.dtype != x.dtype
            or dout.device != x.device):
        raise ValueError(f"do {dout.dtype} {tuple(dout.shape)} must have x's "
                         f"dtype and shape {x.dtype} {tuple(x.shape)}")
    H = x.shape[-1]
    R = x.numel() // H
    if r.shape != (R,) or r.dtype != torch.float32 or r.device != x.device:
        raise ValueError(f"r must be float32 [{R}] on x's device, got "
                         f"{r.dtype} {tuple(r.shape)}")
    if not _build.on_card("rms_norm_bwd", x, weight, r, dout):
        return rms_norm_bwd_reference(x, weight, r, dout)
    dx = torch.empty_like(x)
    if R == 0:
        return dx, torch.zeros_like(weight)
    dw = torch.empty_like(weight)
    G = bwd_blocks(R, x.device)
    ws = torch.empty(G * H, dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.rms_norm_bwd(
            x.data_ptr(), weight.data_ptr(), r.data_ptr(), dout.data_ptr(),
            dx.data_ptr(), dw.data_ptr(), ws.data_ptr(), R, H,
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[weight.dtype], G,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "rms_norm_bwd")
    rms_norm_bwd.launches += 1
    rms_norm_bwd.route_launches[bwd_route(x, weight, dout, dx, ws)] += 1
    return dx, dw


rms_norm_bwd.launches = 0
rms_norm_bwd.route_launches = dict.fromkeys(row_vec.ROUTES, 0)


# ----------------------------------------------------- differentiable op

class _RMSNorm(torch.autograd.Function):
    """The ``_rmsnorm`` custom_vjp: the forward saves ``(x, w, r)``, the
    backward runs :func:`rms_norm_bwd` on them."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        o, r = rms_norm_fwd(x, weight, eps)
        ctx.save_for_backward(x, weight, r)
        return o

    @staticmethod
    def backward(ctx, dout):
        x, weight, r = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, weight, r, dout.contiguous())
        return dx, dw, None


def fused_rms_norm(x, weight, epsilon: float = 1e-6) -> torch.Tensor:
    """Differentiable RMSNorm over the last axis of ``x`` (any leading
    shape), ``pallas_fused.fused_rms_norm``'s counterpart."""
    return _RMSNorm.apply(x.contiguous(), weight.contiguous(),
                          float(epsilon))
