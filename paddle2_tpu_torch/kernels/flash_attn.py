"""Flash attention, forward and backward: the CUDA kernels, their
wrappers, their plain versions and the differentiable op over them.

Counterpart of ``paddle2_tpu/kernels/pallas_flash.py`` (``_flash_fwd``,
``_flash_bwd``, the ``_flash`` custom_vjp and ``flash_attention_bshd``).
Which kernel serves which dtype:

- forward: bf16 ``csrc/flash_fwd_wgmma.cu`` (tensor cores: wgmma fed by
  TMA), f32 ``csrc/flash_fwd_tf32x3.cu`` (tensor cores, error-compensated
  TF32 on mma.sync: 3 TF32 products per f32 product);
- fused backward: bf16 ``csrc/flash_bwd_wgmma.cu`` (tensor cores), f32
  ``csrc/flash_bwd.cu``'s fused kernel (CUDA cores);
- split backward pair (dK/dV, then dQ): f32 ``csrc/flash_bwd_tf32x3.cu``
  (tensor cores, 3xTF32), bf16 ``csrc/flash_bwd.cu`` (CUDA cores).

The f32 kernels on the tensor cores share their split, products and
fragment walks through ``csrc/tf32x3.cuh``. Each source note says what
bounds it and how it is laid out. One launch counter per wrapper counts
both of its kernels; ``route_launches`` counts each kernel of the
forward and of the split pair.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel
or raises. There is no third path: shapes and dtypes the kernels do not
take raise on both devices, so the CPU tests hold the same contract the
card runs.

The differentiable op is ``torch.ops.paddle2_tpu_torch.flash_attn``, a
``torch.library`` custom op returning ``(o, lse)``, with the backward
registered on it. Being a dispatcher op, it is visible to the
selective-checkpoint policy of :func:`.attention.remat_policy`, which
keeps its outputs, so a rematerialised block never re-runs the forward
kernel (the JAX package names the same residuals ``flash_out`` and
``flash_lse``). A bare ``autograd.Function`` around a ctypes call would
be invisible to that policy and re-run.
"""

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["flash_fwd", "flash_fwd_reference", "flash_bwd",
           "flash_bwd_reference", "flash_bwd_split_dkv",
           "flash_bwd_split_dq", "flash_bwd_fused", "bwd_route",
           "flash_attn", "flash_attention_bshd", "SUPPORTED_HEAD_DIMS",
           "tf32_round", "tf32_split", "tf32_matmul", "SPLIT_ROUTES",
           "FWD_ROUTES"]

SUPPORTED_HEAD_DIMS = (16, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
BWD_ROUTES = ("fused", "split")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# q, k, v, o, lse, B, H, Sq, Sk, D, dtype, scale, causal, stream
_FWD_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P]
# q, k, v, do, lse, delta, <outputs...>, B, H, Sq, Sk, D, dtype, scale,
# causal, stream
_BWD_ARGS = [_P] * 6
_BWD_TAIL = [_I, _I, _I, _I, _I, _I, _F, _I, _P]
_FUSED_ARGS = _BWD_ARGS + [_P, _P, _P] + _BWD_TAIL
# library (the source's stem) -> {C entry: argument types}
_LIBRARIES = {
    "flash_fwd_tf32x3": {"flash_fwd_tf32x3": _FWD_ARGS},
    "flash_fwd_wgmma": {"flash_fwd_wgmma": _FWD_ARGS},
    "flash_bwd": {"flash_bwd_dkv": _BWD_ARGS + [_P, _P] + _BWD_TAIL,
                  "flash_bwd_dq": _BWD_ARGS + [_P] + _BWD_TAIL,
                  "flash_bwd_fused": _FUSED_ARGS},
    "flash_bwd_wgmma": {"flash_bwd_fused_wgmma": _FUSED_ARGS},
    "flash_bwd_tf32x3": {"flash_bwd_dkv_tf32x3": _BWD_ARGS + [_P, _P]
                         + _BWD_TAIL,
                         "flash_bwd_dq_tf32x3": _BWD_ARGS + [_P] + _BWD_TAIL},
}
# (library, C entry) of the forward by dtype, both on the tensor cores:
# bf16 on wgmma, f32 in 3xTF32 on mma.sync; FWD_ROUTES names each, whose
# launches ``flash_fwd.route_launches`` counts
_FWD_ENTRY = {torch.bfloat16: ("flash_fwd_wgmma", "flash_fwd_wgmma"),
              torch.float32: ("flash_fwd_tf32x3", "flash_fwd_tf32x3")}
FWD_ROUTES = {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}
# (library, C entry) of the fused backward by dtype: bf16 on the tensor
# cores, f32 on the CUDA cores
_FUSED_ENTRY = {torch.bfloat16: ("flash_bwd_wgmma", "flash_bwd_fused_wgmma"),
                torch.float32: ("flash_bwd", "flash_bwd_fused")}
# (library, C entry) of each kernel of the split pair, by dtype: f32 on the
# tensor cores in 3xTF32, bf16 on the CUDA cores; SPLIT_ROUTES names the
# two kernels of each wrapper, whose launches ``route_launches`` counts
_DKV_ENTRY = {torch.bfloat16: ("flash_bwd", "flash_bwd_dkv"),
              torch.float32: ("flash_bwd_tf32x3", "flash_bwd_dkv_tf32x3")}
_DQ_ENTRY = {torch.bfloat16: ("flash_bwd", "flash_bwd_dq"),
             torch.float32: ("flash_bwd_tf32x3", "flash_bwd_dq_tf32x3")}
SPLIT_ROUTES = {torch.float32: "tf32x3", torch.bfloat16: "cuda_cores"}


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes (B, H, S, D) tensors")
    B, H, Sq, D = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    Sk = k.shape[2]
    if not 1 <= Sq <= Sk:
        raise ValueError(f"need 1 <= Sq <= Sk, got Sq={Sq} Sk={Sk}")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {SUPPORTED_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need "
                         f"float32 or bfloat16 for all three")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")


def _causal_keep(Sq, Sk, device):
    """Bottom-right aligned causal mask: row r sees keys c <= r + Sk - Sq."""
    return torch.ones(Sq, Sk, dtype=torch.bool,
                      device=device).tril(diagonal=Sk - Sq)


# ---------------------------------------------------------------- forward

def flash_fwd_reference(q, k, v, scale: float, causal: bool,
                        matmul=torch.matmul
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: one softmax over the whole row in f32, the
    probabilities rounded to the input dtype before ``p @ v``, the
    causal mask aligned to the bottom right. ``matmul`` computes the two
    products (e.g. :func:`tf32_matmul`). Returns ``(o, lse)``."""
    Sq, Sk = q.shape[2], k.shape[2]
    s = matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(Sq, Sk, q.device), float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    safe_m = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(s - safe_m)
    l = p.sum(dim=-1, keepdim=True)
    o = matmul(p.to(v.dtype).float(), v.float())
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    lse = torch.where(l == 0, torch.full_like(l, float("-inf")),
                      m + torch.log(safe_l))
    return (o / safe_l).to(q.dtype), lse.squeeze(-1)


def flash_fwd(q, k, v, scale: Optional[float] = None, causal: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash forward on ``(B, H, S, D)``: returns ``o`` (input dtype)
    and ``lse`` (f32, ``(B, H, Sq)``). ``flash_fwd.launches`` counts the
    kernels' launches, ``flash_fwd.route_launches`` those of each
    (:data:`FWD_ROUTES`). Both kernels read q, k and v from 16-byte
    boundaries (TMA, cp.async): a view that starts elsewhere is copied
    first."""
    _check(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not _build.on_card("flash_fwd", q, k, v):
        return flash_fwd_reference(q, k, v, float(scale), bool(causal))
    B, H, Sq, D = q.shape
    q, k, v = (_build.tma_aligned(t) for t in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    name, entry = _FWD_ENTRY[q.dtype]
    lib = _build.library(name, _LIBRARIES[name])
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, H, Sq, k.shape[2], D, _DTYPE_CODE[q.dtype],
            float(scale), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, entry)
    flash_fwd.launches += 1
    flash_fwd.route_launches[FWD_ROUTES[q.dtype]] += 1
    return o, lse


flash_fwd.launches = 0
flash_fwd.route_launches = dict.fromkeys(FWD_ROUTES.values(), 0)


# --------------------------------------------------------------- backward

def _check_bwd(q, k, v, o, lse, do) -> None:
    _check(q, k, v)
    B, H, Sq, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} "
                         f"must have q's shape {tuple(q.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError("o and do must have q's dtype")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {(B, H, Sq)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if not (o.device == lse.device == do.device == q.device):
        raise ValueError("all flash_bwd inputs must lie on one device")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, on the f32 bits: what ``cvt.rna.tf32.f32`` gives."""
    bits = (x.float().view(torch.int32) + 0x1000) & -0x2000
    return torch.where(torch.isnan(x), x.float(), bits.view(torch.float32))


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(big, small)``, both TF32, with ``big + small`` within 2⁻²¹ of
    ``x``: the operand split of ``csrc/tf32x3.cuh`` as the tensor cores
    read it. big is ``x`` rounded (:func:`tf32_round`); small is
    ``x − big`` (exact in f32) truncated to TF32, since the kernel hands
    it to the mma unrounded and the tensor cores read its top 19 bits."""
    big = tf32_round(x)
    rest = (x.float() - big).view(torch.int32) & -0x2000
    return big, rest.view(torch.float32)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor,
                passes: int = 3) -> torch.Tensor:
    """``a @ b`` with the operands in TF32, summed in f32: ``passes`` 3 is
    the error-compensated product of the f32 flash kernels on the tensor
    cores (small·big + big·small + big·big), 1 a single TF32 product. For
    the plain versions (``flash_fwd_reference`` / ``flash_bwd_reference``
    ``(..., matmul=)``) in the CPU tests and the smoke; the main path
    never calls it."""
    if passes == 1:
        return torch.matmul(tf32_round(a), tf32_round(b))
    if passes != 3:
        raise ValueError(f"passes {passes} not in (1, 3)")
    ab, as_ = tf32_split(a)
    bb, bs = tf32_split(b)
    return torch.matmul(ab, bb) + (torch.matmul(as_, bb)
                                   + torch.matmul(ab, bs))


def flash_bwd_reference(q, k, v, o, lse, do, scale: float, causal: bool,
                        out_dtype: Optional[torch.dtype] = None,
                        sum_dtype: torch.dtype = torch.float32,
                        matmul=torch.matmul
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward, mirroring the split Pallas kernels
    (``_bwd_dkv_kernel``, ``_bwd_dq_kernel``): P recomputed from the
    saved lse with the ``lse == -inf`` guard of ``_bwd_p_ds``,
    ``dS = P∘(dO·Vᵀ − delta)``, P and dS rounded to the input dtype
    before each product, sums in ``sum_dtype`` (f32; float64 gives what
    exact sums would). ``matmul`` computes the five products (e.g.
    :func:`tf32_matmul`). Returns ``(dq, dk, dv)`` cast to ``out_dtype``
    (default the input dtype; ``sum_dtype`` keeps the sums as they
    are)."""
    Sq, Sk = q.shape[2], k.shape[2]
    dt = q.dtype
    qf, kf, vf, dof = (t.to(sum_dtype) for t in (q, k, v, do))
    delta = (dof * o.to(sum_dtype)).sum(-1, keepdim=True)
    s = matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(Sq, Sk, q.device), float("-inf"))
    lse = lse[..., None]
    neg = float("-inf")
    p = torch.exp(s - torch.where(lse == neg, torch.zeros_like(lse), lse))
    p = torch.where((s == neg) | (lse == neg), torch.zeros_like(p), p)
    dp = matmul(dof, vf.transpose(-1, -2))
    ds = (p * (dp - delta)).to(dt).to(sum_dtype)
    dv = matmul(p.to(dt).to(sum_dtype).transpose(-1, -2), dof)
    dk = matmul(ds.transpose(-1, -2), qf) * scale
    dq = matmul(ds, kf) * scale
    out = out_dtype or dt
    return dq.to(out), dk.to(out), dv.to(out)


def _bwd_launch(entry, q, k, v, do, lse, delta, outs, scale, causal,
                library="flash_bwd"):
    B, H, Sq, D = q.shape
    lib = _build.library(library, _LIBRARIES[library])
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *[t.data_ptr() for t in outs],
            B, H, Sq, k.shape[2], D, _DTYPE_CODE[q.dtype], float(scale),
            int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, entry)


def _split_inputs(q, k, v, do):
    """f32 inputs on 16-byte boundaries: the tensor-core pair reads them
    in 16-byte ``cp.async`` chunks (a contiguous view can start
    anywhere)."""
    if q.dtype != torch.float32:
        return q, k, v, do
    return tuple(_build.tma_aligned(t) for t in (q, k, v, do))


def flash_bwd_split_dkv(q, k, v, do, lse, delta, scale, causal):
    """Kernel 1 of the split route (``_bwd_dkv_kernel``): dK and dV,
    one block per key tile looping over the query tiles; f32 on the
    tensor cores in 3xTF32 (``flash_bwd_tf32x3.cu``), bf16 on the CUDA
    cores (``flash_bwd.cu``). CUDA tensors only; ``launches`` counts its
    launches, ``route_launches`` those of each kernel (by
    :data:`SPLIT_ROUTES`)."""
    q, k, v, do = _split_inputs(q, k, v, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    library, entry = _DKV_ENTRY[q.dtype]
    _bwd_launch(entry, q, k, v, do, lse, delta, (dk, dv), scale, causal,
                library)
    flash_bwd_split_dkv.launches += 1
    flash_bwd_split_dkv.route_launches[SPLIT_ROUTES[q.dtype]] += 1
    return dk, dv


def flash_bwd_split_dq(q, k, v, do, lse, delta, scale, causal):
    """Kernel 2 of the split route (``_bwd_dq_kernel``): dQ, one block
    per query tile looping over the key tiles; the same kernel files by
    dtype as :func:`flash_bwd_split_dkv`."""
    q, k, v, do = _split_inputs(q, k, v, do)
    dq = torch.empty_like(q)
    library, entry = _DQ_ENTRY[q.dtype]
    _bwd_launch(entry, q, k, v, do, lse, delta, (dq,), scale, causal,
                library)
    flash_bwd_split_dq.launches += 1
    flash_bwd_split_dq.route_launches[SPLIT_ROUTES[q.dtype]] += 1
    return dq


def flash_bwd_fused(q, k, v, do, lse, delta, scale, causal):
    """The fused route (``_bwd_fused_1blk_kernel``): dQ, dK and dV from
    one score and probability tile; bf16 on the tensor cores
    (``flash_bwd_wgmma.cu``), f32 on the CUDA cores (``flash_bwd.cu``).
    Each block owns a key tile and adds its dQ share into an f32 buffer
    with atomics, which is cast to the input dtype after the kernel. The
    order of those additions changes from run to run, so dQ is not
    bitwise deterministic (dK and dV are)."""
    if q.dtype == torch.bfloat16:
        q, k, v, do = (_build.tma_aligned(t) for t in (q, k, v, do))
    dq32 = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    library, entry = _FUSED_ENTRY[q.dtype]
    _bwd_launch(entry, q, k, v, do, lse, delta, (dq32, dk, dv), scale,
                causal, library)
    flash_bwd_fused.launches += 1
    return dq32.to(q.dtype), dk, dv


for _fn in (flash_bwd_split_dkv, flash_bwd_split_dq, flash_bwd_fused):
    _fn.launches = 0
for _fn in (flash_bwd_split_dkv, flash_bwd_split_dq):
    _fn.route_launches = dict.fromkeys(SPLIT_ROUTES.values(), 0)


def bwd_route(dtype: torch.dtype) -> str:
    """The backward route the port takes when the caller names none:
    "fused" for bf16, "split" for f32. PERF.md gives the H100 times at
    the training path's shape that ground the rule: the fused kernel
    does 10 of the split pair's 14 products per tile, and in bf16 it
    runs on the tensor cores (``flash_bwd_wgmma.cu``) where the bf16
    split pair runs on the CUDA cores; in f32 the split pair runs on the
    tensor cores in 3xTF32 (``flash_bwd_tf32x3.cu``), where the fused
    kernel stays on the CUDA cores, and it has no atomics, so f32 (the
    precision a run is checked in) stays bitwise reproducible."""
    return "fused" if dtype == torch.bfloat16 else "split"


def flash_bwd(q, k, v, o, lse, do, scale: Optional[float] = None,
              causal: bool = False, route: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash backward on ``(B, H, S, D)``: ``(dq, dk, dv)`` in the
    input dtype. ``delta = rowsum(dO∘O)`` is plain torch, as it is
    plain XLA in the JAX package. ``route`` ("fused" or "split") forces
    a route; None takes :func:`bwd_route`. A CPU tensor runs
    :func:`flash_bwd_reference` whatever the route."""
    _check_bwd(q, k, v, o, lse, do)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if route is None:
        route = bwd_route(q.dtype)
    if route not in BWD_ROUTES:
        raise ValueError(f"route {route!r} not in {BWD_ROUTES}")
    if not _build.on_card("flash_bwd", q, k, v, o, lse, do):
        return flash_bwd_reference(q, k, v, o, lse, do, float(scale),
                                   bool(causal))
    delta = (do.float() * o.float()).sum(-1)
    if route == "fused":
        return flash_bwd_fused(q, k, v, do, lse, delta, scale, causal)
    dk, dv = flash_bwd_split_dkv(q, k, v, do, lse, delta, scale, causal)
    dq = flash_bwd_split_dq(q, k, v, do, lse, delta, scale, causal)
    return dq, dk, dv


# ----------------------------------------------------- differentiable op

@torch.library.custom_op(
    "paddle2_tpu_torch::flash_attn", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, float scale, bool causal) "
           "-> (Tensor, Tensor)")
def flash_attn(q, k, v, scale, causal):
    """Differentiable flash attention on contiguous ``(B, H, S, D)``:
    returns ``(o, lse)`` from :func:`flash_fwd`; its backward runs
    :func:`flash_bwd` on the saved ``(q, k, v, o, lse)``."""
    return flash_fwd(q, k, v, scale=scale, causal=causal)


@flash_attn.register_fake
def _(q, k, v, scale, causal):
    B, H, Sq, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, H, Sq),
                                            dtype=torch.float32)


def _flash_attn_setup(ctx, inputs, output):
    q, k, v, scale, causal = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.scale, ctx.causal = scale, causal


def _flash_attn_backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(),
                           scale=ctx.scale, causal=ctx.causal)
    return dq, dk, dv, None, None


flash_attn.register_autograd(_flash_attn_backward,
                             setup_context=_flash_attn_setup)


def flash_attention_bshd(q, k, v, causal: bool = False,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable flash attention on ``(batch, seq, heads, dim)``
    tensors, the layout of the JAX package's public flash API. Returns
    ``(B, Sq, H, D)``."""
    _check(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    o, _ = flash_attn(q.transpose(1, 2).contiguous(),
                      k.transpose(1, 2).contiguous(),
                      v.transpose(1, 2).contiguous(), float(scale),
                      bool(causal))
    return o.transpose(1, 2)
