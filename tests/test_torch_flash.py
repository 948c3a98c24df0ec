"""The port's flash forward (paddle2_tpu_torch.kernels.flash_attn) held
against the JAX package's Pallas flash forward, run in interpret mode.

On the CPU the port's ``flash_fwd`` runs its plain version; the CUDA
kernel is held against the same plain version on the card by
chip_smoke.py. Tolerances: f32 1e-5 (the two differ only in summation
order and in where the scale is applied); bf16 2e-2 (probabilities are
rounded to bf16 before p.V, relative to a running max in the tiled
Pallas kernel and to the row max in the plain version; the one-tile
Pallas kernel also rounds q*scale to bf16).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle2_tpu.kernels.pallas_flash import _flash_fwd
from paddle2_tpu_torch.kernels import (flash_attention_bshd, flash_fwd,
                                       flash_fwd_reference,
                                       scaled_dot_product_attention)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(seed, B, H, Sq, Sk, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, Sq, D)).astype(np.float32),
            rng.normal(size=(B, H, Sk, D)).astype(np.float32),
            rng.normal(size=(B, H, Sk, D)).astype(np.float32))


def _jax_flash(q, k, v, dtype, causal, block):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    scale = 1.0 / math.sqrt(q.shape[-1])
    o, lse = _flash_fwd(jnp.asarray(q, jd), jnp.asarray(k, jd),
                        jnp.asarray(v, jd), scale, causal, block, block,
                        True)
    return np.asarray(o, np.float32), np.asarray(lse, np.float32)


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Sq,Sk", [(32, 32), (8, 40)])
def test_flash_fwd_matches_pallas(dtype, D, causal, Sq, Sk):
    q, k, v = _inputs(D + Sq, 1, 2, Sq, Sk, D)
    o_ref, lse_ref = _jax_flash(q, k, v, dtype, causal, 1024)
    o, lse = flash_fwd(_torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
                       causal=causal)
    assert o.dtype == getattr(torch, dtype) and lse.dtype == torch.float32
    tol = TOL[dtype]
    np.testing.assert_allclose(o.float().numpy(), o_ref, rtol=tol, atol=tol)
    np.testing.assert_allclose(lse.numpy(), lse_ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_fwd_matches_tiled_pallas(dtype, causal):
    """Small Pallas tiles force its online-softmax kernel (several key
    tiles per row, tiles above the diagonal skipped)."""
    q, k, v = _inputs(7, 2, 2, 48, 64, 64)
    o_ref, lse_ref = _jax_flash(q, k, v, dtype, causal, 16)
    o, lse = flash_fwd(_torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
                       causal=causal)
    tol = TOL[dtype]
    np.testing.assert_allclose(o.float().numpy(), o_ref, rtol=tol, atol=tol)
    np.testing.assert_allclose(lse.numpy(), lse_ref, rtol=tol, atol=tol)


def test_ragged_lengths_and_bottom_right_causal():
    """Lengths that are no multiple of any tile, and Sq < Sk: row r sees
    keys c <= r + Sk - Sq (torch's is_causal would align top-left)."""
    q, k, v = _inputs(3, 1, 3, 5, 13, 16)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = flash_fwd(tq, tk, tv, causal=True)
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / 4.0
    keep = np.tril(np.ones((5, 13), bool), k=13 - 5)
    s = np.where(keep, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    ref = np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(o.numpy(), ref, rtol=1e-5, atol=1e-5)
    lse_ref = np.log(np.exp(s).sum(-1))
    np.testing.assert_allclose(lse.numpy(), lse_ref, rtol=1e-5, atol=1e-5)


def test_bshd_layout_and_sdpa_route():
    q, k, v = _inputs(11, 2, 4, 24, 24, 16)
    bshd = [torch.from_numpy(a).transpose(1, 2).contiguous()
            for a in (q, k, v)]
    out = flash_attention_bshd(*bshd, causal=True)
    assert out.shape == (2, 24, 4, 16)
    ref, _ = flash_fwd_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                                 scale=0.25, causal=True)
    assert torch.equal(out, ref.transpose(1, 2))
    assert torch.equal(scaled_dot_product_attention(*bshd, is_causal=True),
                       out)


def test_cpu_runs_plain_version_without_launching():
    before = flash_fwd.launches
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 1, 1, 8, 8, 16))
    flash_fwd(q, k, v, causal=True)
    assert flash_fwd.launches == before


@pytest.mark.parametrize("bad", [
    dict(D=32),                    # head dim the kernel has no build for
    dict(Sq=16, Sk=8),             # Sq > Sk
    dict(dtype=torch.float16),     # dtype the kernel has no build for
])
def test_unsupported_shapes_raise(bad):
    D, Sq, Sk = bad.get("D", 16), bad.get("Sq", 8), bad.get("Sk", 8)
    dtype = bad.get("dtype", torch.float32)
    q = torch.zeros(1, 1, Sq, D, dtype=dtype)
    k = torch.zeros(1, 1, Sk, D, dtype=dtype)
    with pytest.raises(ValueError):
        flash_fwd(q, k, k.clone())


def test_sdpa_rejects_mask_and_dropout():
    """Masks and dropout are ported (tests/test_torch_ernie.py); what the
    attention still refuses is a mask that does not broadcast to [B, H,
    Sq, Sk] and a dropout probability outside [0, 1)."""
    q = torch.zeros(1, 8, 1, 16)
    with pytest.raises(ValueError, match="broadcast"):
        scaled_dot_product_attention(q, q, q, attn_mask=torch.ones(3, 8))
    with pytest.raises(ValueError, match="broadcast"):
        scaled_dot_product_attention(q, q, q,
                                     attn_mask=torch.ones(2, 1, 8, 8))
    for p in (-0.1, 1.0):
        with pytest.raises(ValueError, match="dropout_p"):
            scaled_dot_product_attention(q, q, q, dropout_p=p)
