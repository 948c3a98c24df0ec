"""Fused rotary position embedding (half-split): the CUDA kernel, its
wrapper, its plain version and the differentiable op over it.

Counterpart of ``_rope_kernel`` and ``fused_rope`` in
``paddle2_tpu/kernels/pallas_fused.py``. The kernel is
``csrc/rope.cu``: on ``x [B, S, H, D]`` with ``cos``/``sin`` tables of
``[S, D]`` or, gathered by position, ``[B*S, D]``, it computes
``o = x·cos + rot(x)·sin`` in f32 with ``rot(x) = cat(-x[..., D/2:],
x[..., :D/2])`` and rounds once to x's dtype. x f32, bf16 or f16; the
tables f32, bf16 or f16 of their own (the kernel widens them to f32);
D even.

Two kernels, picked by the C entry from the shape and the addresses
(:func:`route` states the same rule): the vector route
(``rope_vec_kernel``: one warp a (b, s) row, 16-byte loads of x, one
row of angles loaded once for all of a lane's heads) when 16-byte
vectors take a half row, else the general route (``rope_kernel``).

The backward is the same kernel rotating by ``-sin``, as the Pallas
custom_vjp has it, and gives no gradient for the tables. That
backward is the transpose of the forward only when the two halves of
each ``sin`` row are equal (``rot(g·s) != rot(g)·s`` otherwise), which
every standard half-split table satisfies; the port keeps the
reference kernel's backward as it is.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel
or raises. Shapes, dtypes and layouts the kernel does not take raise on
both devices.
"""

import ctypes

import torch

from . import _build, row_vec

__all__ = ["route", "rope", "rope_reference", "fused_rope"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# x, cos, sin, o, rows, H, D, table rows, x dtype, table dtype, negate sin,
# stream
_SIGNATURES = {"rope": [_P] * 4 + [_L, _I, _I, _L, _I, _I, _I, _P]}


def _check(x, cos, sin) -> None:
    if x.dim() != 4:
        raise ValueError(f"fused RoPE takes x [B, S, H, D], got "
                         f"{tuple(x.shape)}")
    B, S, H, D = x.shape
    if D % 2:
        raise ValueError(f"fused RoPE needs an even head dim, got D={D}")
    if not (cos.dim() == 2 and cos.shape == sin.shape
            and cos.shape[1] == D and cos.shape[0] in (S, B * S)):
        raise ValueError(f"cos/sin must be [S, D] or [B*S, D] = [{S}, {D}] "
                         f"or [{B * S}, {D}], got {tuple(cos.shape)} and "
                         f"{tuple(sin.shape)}")
    if (x.dtype not in _DTYPE_CODE or cos.dtype not in _DTYPE_CODE
            or sin.dtype != cos.dtype):
        raise ValueError(f"fused RoPE takes x and one table dtype among "
                         f"float32/bfloat16/float16; got x {x.dtype}, cos "
                         f"{cos.dtype}, sin {sin.dtype}")
    if not (x.device == cos.device == sin.device):
        raise ValueError("x, cos and sin must lie on one device")
    if not (x.is_contiguous() and cos.is_contiguous()
            and sin.is_contiguous()):
        raise ValueError("fused RoPE needs contiguous x, cos and sin")


def rope_reference(x, cos, sin, negate_sin: bool = False) -> torch.Tensor:
    """The plain version, ``_rope_kernel``'s arithmetic: each (b, s) row
    takes table row ``(b·S + s) mod T``, broadcast over the heads; one
    f32 product a term, one sum, one rounding to x's dtype."""
    B, S, H, D = x.shape
    T = cos.shape[0]
    x32 = x.float()
    c = cos.float().reshape(T // S if T != S else 1, S, 1, D)
    s = sin.float().reshape(c.shape)
    if negate_sin:
        s = -s
    rot = torch.cat([-x32[..., D // 2:], x32[..., :D // 2]], dim=-1)
    return (x32 * c + rot * s).to(x.dtype)


def route(x, cos, sin, o) -> str:
    """The kernel a CUDA call takes, as the C entry picks it: "vec"
    (``rope_vec_kernel``) when 16-byte vectors take a half row
    (``(D/2)·sizeof(x) % 16 == 0``) and x, cos, sin and o start on
    16-byte boundaries, else "general" (``rope_kernel``)."""
    return row_vec.route(x.shape[-1] // 2 * x.element_size(), x.data_ptr(),
                         cos.data_ptr(), sin.data_ptr(), o.data_ptr())


def rope(x, cos, sin, negate_sin: bool = False) -> torch.Tensor:
    """RoPE over ``x [B, S, H, D]``; ``negate_sin`` rotates by ``-sin``
    (the backward). ``rope.launches`` counts the kernels' launches,
    ``rope.route_launches`` those of each route (:func:`route`)."""
    _check(x, cos, sin)
    if not _build.on_card("rope", x, cos, sin):
        return rope_reference(x, cos, sin, negate_sin)
    B, S, H, D = x.shape
    o = torch.empty_like(x)
    if x.numel() == 0:
        return o
    lib = _build.library("rope", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.rope(
            x.data_ptr(), cos.data_ptr(), sin.data_ptr(), o.data_ptr(),
            B * S, H, D, cos.shape[0], _DTYPE_CODE[x.dtype],
            _DTYPE_CODE[cos.dtype], int(bool(negate_sin)),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "rope")
    rope.launches += 1
    rope.route_launches[route(x, cos, sin, o)] += 1
    return o


rope.launches = 0
rope.route_launches = dict.fromkeys(row_vec.ROUTES, 0)


class _Rope(torch.autograd.Function):
    """``fused_rope``'s custom_vjp: the backward rotates the output
    gradient by ``(cos, -sin)``; the tables get no gradient."""

    @staticmethod
    def forward(ctx, x, cos, sin):
        ctx.save_for_backward(cos, sin)
        return rope(x, cos, sin)

    @staticmethod
    def backward(ctx, g):
        cos, sin = ctx.saved_tensors
        return rope(g.contiguous(), cos, sin, negate_sin=True), None, None


def fused_rope(x, cos, sin) -> torch.Tensor:
    """Differentiable half-split RoPE over ``x [B, S, H, D]`` with
    ``[S, D]`` or ``[B*S, D]`` tables (``pallas_fused.fused_rope``'s
    counterpart)."""
    D = x.shape[-1]
    return _Rope.apply(x.contiguous(), cos.reshape(-1, D).contiguous(),
                       sin.reshape(-1, D).contiguous())
