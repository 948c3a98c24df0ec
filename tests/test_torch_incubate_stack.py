"""The incubate slice as a whole: ``chip_smoke.py``'s phase-14 stack (two
pre-norm decoder layers from the public functionals: ``fused_rms_norm``
and its residual form, half-split ``fused_rotary_position_embedding``,
causal ``flash_attention``, ``swiglu``; a final ``fused_rms_norm``; a
squared-error loss) at a tiny width, hidden 64, 4 heads of 16, seq 32,
batch 2, FFN 128, beside the same stack built from
``paddle2_tpu.incubate.nn.functional``. Two loop steps of
``fused_adamw_kernel`` (lr 1e-4) on both sides from the same numpy
weights and batches, in f32.

Tolerances. The two sides differ in the order of their sums (matmuls,
attention, the norms' means): losses to 1e-5 relative, every gradient
to 1e-5 of its largest magnitude. After the AdamW steps, m, v, every
parameter and master to 1e-5 of its largest magnitude: Adam divides
each gradient by its own running magnitude, so a gradient element that
sits near eps turns the sums' f32 differences into a larger change of
its update (at most lr·|Δg|/eps an element, well below 1e-5 of the
weights here).
"""

import numpy as np
import pytest
import torch

import chip_smoke
import paddle2_tpu as paddle
from paddle2_tpu.incubate.nn import functional as JF
from paddle2_tpu.nn.functional.flash_attention import flash_attention
from paddle2_tpu_torch.kernels import flash_attn, fused_adamw, fused_rope
from paddle2_tpu_torch.kernels import fused_rms_norm

CFG = dict(hidden=64, heads=4, layers=2, ffn=128, seq=32, batch=2)
TOL = 1e-5


def _jax_loss(params, x, tgt, cfg):
    """The stack of ``chip_smoke.stack_loss`` over the JAX package's
    functionals."""
    B, S, hid = cfg["batch"], cfg["seq"], cfg["hidden"]
    nh = cfg["heads"]
    h = x
    for i in range(cfg["layers"]):
        w_attn, w_qkv, w_o, w_mlp, w_1, w_2 = params[6 * i:6 * i + 6]
        y = JF.fused_rms_norm(h, w_attn)
        qkv = paddle.matmul(y, w_qkv).reshape([B, S, 3, nh, hid // nh])
        q, k, _ = JF.fused_rotary_position_embedding(
            qkv[:, :, 0], qkv[:, :, 1], use_neox_rotary_style=False)
        o, _ = flash_attention(q, k, qkv[:, :, 2], causal=True)
        a = paddle.matmul(o.reshape([B, S, hid]), w_o)
        y2, h = JF.fused_rms_norm(a, w_mlp, residual=h)
        h = h + paddle.matmul(JF.swiglu(paddle.matmul(y2, w_1)), w_2)
    out = JF.fused_rms_norm(h, params[-1])
    return ((out - tgt) ** 2).mean()


def _jax_steps(host, xs, tgt):
    params = [paddle.to_tensor(t.numpy(), stop_gradient=False)
              for t in host]
    state = [[paddle.to_tensor(np.zeros(t.shape, np.float32)),
              paddle.to_tensor(np.zeros(t.shape, np.float32)),
              paddle.to_tensor(t.numpy())] for t in host]
    losses, grads = [], None
    jt = paddle.to_tensor(tgt.numpy())
    for t, x in enumerate(xs, start=1):
        loss = _jax_loss(params, paddle.to_tensor(x.numpy()), jt, CFG)
        loss.backward()
        losses.append(float(loss.numpy()))
        if grads is None:
            grads = [np.asarray(p.grad.numpy()) for p in params]
        for i, p in enumerate(params):
            pn, mn, vn, wn = JF.fused_adamw_kernel(
                p, p.grad, *state[i], chip_smoke.STACK_LR, step=t)
            params[i] = paddle.to_tensor(np.asarray(pn.numpy()),
                                         stop_gradient=False)
            state[i] = [mn, vn, wn]
    tensors = [[np.asarray(a.numpy()) for a in [p] + st]
               for p, st in zip(params, state)]
    return losses, grads, tensors


def _near(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    lim = TOL * max(float(np.abs(want).max()), 1e-30)
    assert err <= lim, (what, err, lim)


@pytest.fixture
def counted(monkeypatch):
    """Each plain version the CPU path runs in place of a kernel adds one
    to the kernel's wrapper's count, as a launch would on the card."""
    def count(mod, name, counter):
        orig = getattr(mod, name)

        def run(*a, **k):
            counter.launches += 1
            return orig(*a, **k)
        monkeypatch.setattr(mod, name, run)
    count(fused_rms_norm, "rms_norm_fwd_reference",
          fused_rms_norm.rms_norm_fwd)
    count(fused_rms_norm, "rms_norm_bwd_reference",
          fused_rms_norm.rms_norm_bwd)
    count(fused_rope, "rope_reference", fused_rope.rope)
    count(fused_adamw, "adamw_flat_reference", fused_adamw.adamw_flat)
    count(flash_attn, "flash_fwd_reference", flash_attn.flash_fwd)


def test_stack_matches_jax_for_two_steps(counted):
    host = chip_smoke.stack_params(CFG, seed=2)
    xs, tgt = chip_smoke.stack_data(CFG, 2, seed=2)
    params, state = chip_smoke.stack_setup(host, "cpu", torch.float32)
    chip_smoke.reset_counts()
    losses, grads = [], None
    for t, x in enumerate(xs, start=1):
        loss, g = chip_smoke.stack_step(params, state, x, tgt, CFG, t,
                                        keep_grads=t == 1)
        losses.append(float(loss))
        grads = grads or g
    # the loop's launches a step (plain versions here): 5 RMSNorm
    # forwards and backwards, 8 RoPE, 13 flat AdamW, 2 flash forwards
    launches = chip_smoke.counts()
    assert {n: c for n, c in launches.items() if c} == {
        "rms_norm_fwd": 10, "rms_norm_bwd": 10, "rope": 16,
        "adamw_flat": 26, "flash_fwd": 4}
    jlosses, jgrads, jtensors = _jax_steps(host, xs, tgt)
    np.testing.assert_allclose(losses, jlosses, rtol=TOL, atol=0)
    assert len(grads) == len(jgrads) == 13
    for i, (a, b) in enumerate(zip(grads, jgrads)):
        _near(a.numpy(), b, f"grad {i}")
    for i, (p, st) in enumerate(zip(params, state)):
        for what, a, b in zip(("param", "m", "v", "master"),
                              (p.detach(), st["m"], st["v"], st["master"]),
                              jtensors[i]):
            _near(a.numpy(), b, f"{what} {i}")
