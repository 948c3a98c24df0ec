"""The port's chunked LM head + cross-entropy
(paddle2_tpu_torch.kernels.fused_ce and its ``reduction`` wrapper in
paddle2_tpu_torch.incubate.nn.functional) held against the JAX package's
``paddle2_tpu.kernels.fused_ce`` on the same numpy inputs: per-token
losses, and dx and dW of the mean loss through ``jax.vjp``, with several
chunks and ignored tokens.

Tolerances (absolute and relative): the losses 1e-5 in both dtypes
(f32 logits from the operands in either, so summation order only);
dx/dW 1e-5 in f32 and 2**-8 in bf16, one bf16 rounding step, where the
two f32 sums land on either side of a rounding boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle2_tpu.kernels import fused_ce as jax_ce
from paddle2_tpu_torch.incubate.nn import functional as IF
from paddle2_tpu_torch.kernels import fused_ce

# (losses, gradients)
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 2 ** -8)}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
N, H, V = 64, 32, 96


def _inputs(seed, n_ignored):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, H)).astype(np.float32)
    w = (rng.normal(size=(H, V)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, size=N).astype(np.int32)
    labels[rng.choice(N, n_ignored, replace=False)] = -100
    return x, w, labels


def _jax(x, w, labels, dtype, chunk):
    def mean_loss(xa, wa):
        losses, valid = jax_ce.fused_linear_cross_entropy(
            xa, wa, jnp.asarray(labels), -100, chunk)
        return jnp.sum(losses) / jnp.maximum(
            jnp.sum(valid.astype(jnp.float32)), 1.0), losses
    (loss, losses), grads = jax.value_and_grad(mean_loss, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(x, JD[dtype]), jnp.asarray(w, JD[dtype]))
    return (np.asarray(losses, np.float32), float(loss),
            [np.asarray(g, np.float32) for g in grads])


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [8, 16, 64])
@pytest.mark.parametrize("n_ignored", [0, 9])
def test_losses_and_grads_match_jax(dtype, chunk, n_ignored):
    x, w, labels = _inputs(chunk + n_ignored, n_ignored)
    losses_ref, loss_ref, (dx_ref, dw_ref) = _jax(x, w, labels, dtype, chunk)
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    tw = torch.from_numpy(w).to(getattr(torch, dtype)).requires_grad_()
    losses, valid = fused_ce.fused_linear_cross_entropy(
        tx, tw, torch.from_numpy(labels), -100, chunk)
    assert losses.dtype == torch.float32
    assert valid.tolist() == (labels != -100).tolist()
    assert torch.all(losses[~valid] == 0)
    loss = losses.sum() / valid.float().sum().clamp_min(1.0)
    loss.backward()
    tol, gtol = TOL[dtype]
    _close(losses.detach(), losses_ref, tol)
    _close(loss.item(), loss_ref, tol)
    assert tx.grad.dtype == tx.dtype and tw.grad.dtype == tw.dtype
    _close(tx.grad.float(), dx_ref, gtol)
    _close(tw.grad.float(), dw_ref, gtol)
    assert torch.all(tx.grad[~valid] == 0)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_reduction_wrapper(reduction):
    """The ``incubate`` wrapper over ``[B, S, H]`` activations, as the
    GPT head calls it, against the JAX package's reductions."""
    x, w, labels = _inputs(3, 5)
    losses_ref, loss_ref, _ = _jax(x, w, labels, "float32", 16)
    out = IF.fused_linear_cross_entropy(
        torch.from_numpy(x).reshape(4, 16, H), torch.from_numpy(w),
        torch.from_numpy(labels).reshape(4, 16), reduction=reduction)
    want = {"mean": loss_ref, "sum": losses_ref.sum(),
            "none": losses_ref.reshape(4, 16)}[reduction]
    _close(out.detach(), want, 1e-5)


def test_chunk_choice():
    """The chunk divides N and fits the budget: 1 GiB on the CPU for the
    three f32 [C, V] blocks of the backward."""
    assert fused_ce.pick_chunk(8192, 32768, "cpu") == 2048
    assert fused_ce.pick_chunk(8192, 128, "cpu") == 8192
    assert fused_ce.pick_chunk(96, 128, "cpu") == 96       # no divisor
    with pytest.raises(ValueError):
        fused_ce.fused_linear_cross_entropy(torch.zeros(10, 4),
                                            torch.zeros(4, 8),
                                            torch.zeros(10), chunk=4)
    with pytest.raises(ValueError):
        IF.fused_linear_cross_entropy(torch.zeros(4, 4), torch.zeros(4, 8),
                                      torch.zeros(4), reduction="max")
