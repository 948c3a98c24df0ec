"""``paddle2_tpu_torch.nn``'s Transformer trained and decoded against
the JAX package's on the CPU, on ``test_torch_nn_transformer.py``'s
small translation model (d_model 32, 4 heads, 2 + 2 layers):

- three ``AdamW`` steps against the JAX optimizer's (losses 1e-5; the
  weights after them to 1e-5 of their largest magnitude plus 1e-4 of
  the three steps' reach, ``3 lr``, since Adam's normalized update
  carries the gradients' 1e-4 into each step; the key projections'
  biases, whose gradients are rounding noise that Adam scales into
  whole steps, are held to a zero gradient instead);
- the weights carried by ``nn_state_from_reference`` and by a
  ``paddle2_tpu.save`` file read with ``paddle2_tpu_torch.load``: both
  give the JAX loss (1e-5);
- ``gen_cache`` incremental decoding equal to the full causal forward
  (1e-5), and to the JAX layers' incremental decoding.
"""

import numpy as np
import torch

import paddle2_tpu as jp
import paddle2_tpu_torch as tp
from paddle2_tpu_torch.models import nn_state_from_reference
from test_torch_nn_transformer import (B, LOSS_TOL, _data, _masks, build,
                                       loss_of, pair)
from torch_core_harness import port_on_cpu  # noqa: F401


def test_three_adamw_steps_track_jax():
    jm, tm = pair(normalize_before=True)
    src, tgt, lbl = _data(2)
    kw = dict(learning_rate=1e-3, beta1=0.9, beta2=0.98, epsilon=1e-9,
              weight_decay=0.01)
    jopt = jp.optimizer.AdamW(parameters=jm.parameters(), **kw)
    topt = tp.optimizer.AdamW(parameters=tm.parameters(), **kw)
    masks = _masks("masks")
    for step in range(3):
        jl = loss_of(jp, jm, src, tgt, lbl, masks)
        tl = loss_of(tp, tm, src, tgt, lbl, masks)
        np.testing.assert_allclose(tl.item(), float(jl.numpy()), **LOSS_TOL)
        jl.backward()
        tl.backward()
        jg = {n: np.asarray(p.grad.numpy()) for n, p in
              jm.named_parameters()}
        top = max(np.abs(g).max() for g in jg.values())
        for n, p in tm.named_parameters():
            if n.endswith("k_proj.bias"):
                assert np.abs(p.grad.numpy()).max() < 1e-5 * top, n
                assert np.abs(jg[n]).max() < 1e-5 * top, n
        jopt.step()
        topt.step()
        jopt.clear_grad()
        topt.clear_grad()
    js = jm.state_dict()
    for name, p in tm.state_dict().items():
        if name.endswith("k_proj.bias"):
            continue
        want = np.asarray(js[name].numpy())
        np.testing.assert_allclose(
            p.detach().numpy(), want, rtol=0,
            atol=1e-5 * np.abs(want).max() + 1e-4 * 3 * kw["learning_rate"],
            err_msg=name)


def test_weights_carry_across_by_dict_and_by_file(tmp_path):
    jp.seed(3)
    jm = build(jp.nn, normalize_before=True)
    src, tgt, lbl = _data(3)
    masks = _masks("masks")
    want = float(loss_of(jp, jm, src, tgt, lbl, masks).numpy())
    by_dict = build(tp.nn, normalize_before=True)
    assert by_dict.set_state_dict(nn_state_from_reference(jm)) == ([], [])
    path = str(tmp_path / "transformer.pdparams")
    jp.save(jm.state_dict(), path)
    by_file = build(tp.nn, normalize_before=True)
    assert by_file.set_state_dict(tp.load(path)) == ([], [])
    for model in (by_dict, by_file):
        got = loss_of(tp, model, src, tgt, lbl, masks).item()
        np.testing.assert_allclose(got, want, **LOSS_TOL)


def test_incremental_decoding_equals_the_full_causal_forward():
    """The encoder stack with ``gen_cache``, one token at a time (no
    mask: a query sees the whole cache), equals the full forward with
    the causal mask; so does the decoder stack with its self-attention
    caches; both as the JAX layers give them."""
    jp.seed(4)
    jt = jp.nn.Transformer(32, 4, 2, 2, 64, dropout=0.0)
    tt = tp.nn.Transformer(32, 4, 2, 2, 64, dropout=0.0)
    tt.set_state_dict(nn_state_from_reference(jt))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 6, 32)).astype(np.float32)
    mem = rng.standard_normal((B, 8, 32)).astype(np.float32)
    causal = tp.nn.Transformer.generate_square_subsequent_mask(6)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mem)
    enc = tt.encoder
    full = enc(xt, causal)
    cache = enc.gen_cache(xt)
    steps = []
    for i in range(6):
        out, cache = enc(xt[:, i:i + 1], None, cache)
        steps.append(out)
    np.testing.assert_allclose(torch.cat(steps, 1).detach().numpy(),
                               full.detach().numpy(), rtol=1e-5, atol=1e-5)
    jcache = jt.encoder.gen_cache(jp.to_tensor(x))
    jsteps = []
    for i in range(6):
        out, jcache = jt.encoder(jp.to_tensor(x[:, i:i + 1]), None, jcache)
        jsteps.append(np.asarray(out.numpy()))
    np.testing.assert_allclose(torch.cat(steps, 1).detach().numpy(),
                               np.concatenate(jsteps, 1), rtol=1e-5,
                               atol=1e-5)
    dec = tt.decoder
    full = dec(xt, mt, causal)
    cache = [(layer.self_attn.q_proj.weight.new_zeros(B, 0, 4, 8),) * 2
             for layer in dec.layers]
    cache = [(c,) for c in cache]
    steps = []
    for i in range(6):
        out, cache = dec(xt[:, i:i + 1], mt, None, None, cache)
        steps.append(out)
    np.testing.assert_allclose(torch.cat(steps, 1).detach().numpy(),
                               full.detach().numpy(), rtol=1e-5, atol=1e-5)
    assert tuple(cache[0][0][0].shape) == (B, 6, 4, 8)
