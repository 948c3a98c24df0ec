"""The port's flash backward (paddle2_tpu_torch.kernels.flash_attn) held
against the JAX package's Pallas backward, run in interpret mode, in
both of its routes: a block at least as long as the sequence takes the
one-block fused kernel, block 16 the split dK/dV + dQ pair.

On the CPU ``flash_bwd`` runs its plain version whatever the route; the
CUDA kernels are held against the same plain version on the card by
chip_smoke.py. Both sides get the same q, k, v, dO and the same saved
(o, lse), from the Pallas forward. Tolerances: f32 1e-4 (summation order,
and the fused Pallas kernel scales q before the product where the plain
version scales the product); bf16 2e-2 (P and dS are rounded to bf16
before each product, and the fused Pallas kernel also rounds q·scale to
bf16, which the plain version, mirroring the split kernels, does not).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle2_tpu.kernels.pallas_flash import _flash, _flash_bwd, _flash_fwd
from paddle2_tpu_torch.kernels import flash_attn as fa
from paddle2_tpu_torch.kernels import flash_bwd, flash_bwd_reference

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(seed, B, H, Sq, Sk, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, Sq, D)).astype(np.float32),
            rng.normal(size=(B, H, Sk, D)).astype(np.float32),
            rng.normal(size=(B, H, Sk, D)).astype(np.float32),
            rng.normal(size=(B, H, Sq, D)).astype(np.float32))


def _torch(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(
        getattr(torch, dtype))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("Sq,Sk", [(32, 32), (24, 40)])
@pytest.mark.parametrize("block", [1024, 16], ids=["fused1blk", "split"])
def test_flash_bwd_reference_matches_pallas(dtype, causal, D, Sq, Sk, block):
    q, k, v, do = _inputs(D + Sq + block, 1, 2, Sq, Sk, D)
    jq, jk, jv, jdo = (jnp.asarray(a, JD[dtype]) for a in (q, k, v, do))
    scale = 1.0 / math.sqrt(D)
    o, lse = _flash_fwd(jq, jk, jv, scale, causal, block, block, True)
    want = _flash_bwd(jq, jk, jv, o, lse, jdo, scale, causal, block, block,
                      True)
    got = flash_bwd_reference(_torch(q, dtype), _torch(k, dtype),
                              _torch(v, dtype), _torch(o, dtype),
                              _torch(lse, "float32"), _torch(do, dtype),
                              scale, causal)
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        _close(g, w, TOL[dtype])


@pytest.mark.parametrize("route", [None, "fused", "split"])
def test_flash_bwd_wrapper_runs_the_plain_version_on_cpu(route):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, 1, 2, 8, 24, 16))
    o, lse = fa.flash_fwd(q, k, v, causal=True)
    before = {f: f.launches for f in (fa.flash_bwd_fused,
                                      fa.flash_bwd_split_dkv,
                                      fa.flash_bwd_split_dq, fa.flash_fwd)}
    got = flash_bwd(q, k, v, o, lse, do, causal=True, route=route)
    want = flash_bwd_reference(q, k, v, o, lse, do, 0.25, True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert {f: f.launches for f in before} == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_custom_op_gradients_match_jax_vjp(dtype, causal):
    """Gradients of the registered op through torch.autograd against
    jax.vjp of the JAX package's ``_flash`` custom_vjp (split kernels)."""
    q, k, v, do = _inputs(5 + causal, 2, 2, 24, 40, 16)
    scale = 0.25
    jargs = [jnp.asarray(a, JD[dtype]) for a in (q, k, v)]
    o_ref, vjp = jax.vjp(lambda a, b, c: _flash(a, b, c, scale, causal, 16,
                                                16, True), *jargs)
    want = vjp(jnp.asarray(do, JD[dtype]))
    tq, tk, tv = (_torch(a, dtype).requires_grad_() for a in (q, k, v))
    o, lse = torch.ops.paddle2_tpu_torch.flash_attn(tq, tk, tv, scale,
                                                    causal)
    got = torch.autograd.grad(o, (tq, tk, tv), _torch(do, dtype))
    _close(o.detach(), o_ref, TOL[dtype])
    for g, w in zip(got, want):
        _close(g, w, TOL[dtype])


def test_bshd_attention_is_differentiable():
    """``flash_attention_bshd`` (the SDPA route of the models) carries
    the gradient in the (B, S, H, D) layout."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(9, 1, 2, 16, 16, 16))
    bshd = [t.transpose(1, 2).contiguous().requires_grad_()
            for t in (q, k, v)]
    out = fa.flash_attention_bshd(*bshd, causal=True)
    got = torch.autograd.grad(out, bshd, do.transpose(1, 2))
    o, lse = fa.flash_fwd(q, k, v, causal=True)
    want = flash_bwd_reference(q, k, v, o, lse, do, 0.25, True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w.transpose(1, 2), rtol=1e-5,
                                   atol=1e-5)


def test_backward_route_rule():
    assert fa.bwd_route(torch.bfloat16) == "fused"
    assert fa.bwd_route(torch.float32) == "split"


@pytest.mark.parametrize("bad", [
    dict(D=32),                       # no build for this head dim
    dict(Sq=16, Sk=8),                # Sq > Sk
    dict(dtype=torch.float16),        # no build for this dtype
    dict(lse_dtype=torch.bfloat16),   # lse must be f32
    dict(route="tiled"),              # no such route
])
def test_unsupported_inputs_raise(bad):
    D, Sq, Sk = bad.get("D", 16), bad.get("Sq", 8), bad.get("Sk", 8)
    dtype = bad.get("dtype", torch.float32)
    q = torch.zeros(1, 1, Sq, D, dtype=dtype)
    k = torch.zeros(1, 1, Sk, D, dtype=dtype)
    lse = torch.zeros(1, 1, Sq, dtype=bad.get("lse_dtype", torch.float32))
    with pytest.raises(ValueError):
        flash_bwd(q, k, k.clone(), q.clone(), lse, q.clone(),
                  route=bad.get("route"))
