"""``paddle2_tpu_torch.nn``'s Transformer layers against the JAX
package's on the CPU, at d_model 32, 4 heads, 2 + 2 layers (and one
case at d_model 64, head dim 16, which the flash kernels take): a small
translation model (a shared embedding scaled by sqrt(d_model) plus
sinusoidal positions, ``nn.Transformer``, a head and
``nn.CrossEntropyLoss``) built from the JAX model's weights.

- the loss and every gradient, ``normalize_before`` both ways, with and
  without masks, ``FLAGS_pallas_layer_norm`` on and off (f32: the loss
  to 1e-5, each gradient to 1e-4 of its largest magnitude, or of a
  thousandth of the model's largest gradient where that is larger: the
  key projection's bias has a gradient of zero but for rounding, since
  softmax ignores a shift shared by a query's logits);
- the attention route: ``MultiHeadAttention`` reaches
  ``flash_attention_bshd`` (its plain version here) exactly when the JAX
  package's Pallas rule (``pallas_flash.supported``) says the kernel
  route applies, no mask and no dropout given, within the kernels' own
  limit ``Sq <= Sk``;
- a boolean ``attn_mask`` is added as a 0/1 bias, as in the JAX package.

Training, the weights carried across and incremental decoding are
``test_torch_nn_transformer_train.py``'s (the model is this file's).
"""

import math

import numpy as np
import pytest
import torch

import paddle2_tpu as jp
import paddle2_tpu_torch as tp
from paddle2_tpu import flags as jflags
from paddle2_tpu.kernels import pallas_flash
from paddle2_tpu_torch import flags as tflags
from paddle2_tpu_torch.kernels import attention as tattn
from paddle2_tpu_torch.models import nn_state_from_reference
from torch_core_harness import port_on_cpu  # noqa: F401

VOCAB, B, SRC, TGT = 50, 2, 16, 8
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


def _positions(s, d):
    pos = np.arange(s)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    pe = np.zeros((s, d), np.float32)
    pe[:, 0::2] = np.sin(ang)
    pe[:, 1::2] = np.cos(ang)
    return pe


def build(nn, d=32, heads=4, normalize_before=False, dropout=0.0):
    """The model's layers in package ``nn``: embedding, Transformer,
    head, loss."""
    return nn.LayerDict(dict(
        emb=nn.Embedding(VOCAB, d),
        transformer=nn.Transformer(d, heads, 2, 2, 2 * d, dropout=dropout,
                                   normalize_before=normalize_before),
        head=nn.Linear(d, VOCAB, bias_attr=False)))


def loss_of(xp, model, src, tgt, lbl, masks):
    d = model["emb"]._embedding_dim
    to = jp.to_tensor if xp is jp else torch.from_numpy

    def embed(ids):
        return model["emb"](to(ids)) * math.sqrt(d) + \
            to(_positions(ids.shape[1], d))
    out = model["transformer"](embed(src), embed(tgt), **{
        k: (to(v) if isinstance(v, np.ndarray) else v)
        for k, v in masks.items()})
    logits = model["head"](out)
    ce = xp.nn.CrossEntropyLoss(label_smoothing=0.1)
    return ce(logits.reshape([-1, VOCAB]), to(lbl.reshape(-1)))


def _data(seed=0, src_len=SRC, tgt_len=TGT):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, VOCAB, (B, src_len)).astype(np.int32)
    tgt = rng.integers(0, VOCAB, (B, tgt_len)).astype(np.int32)
    lbl = rng.integers(0, VOCAB, (B, tgt_len)).astype(np.int32)
    return src, tgt, lbl


def _masks(kind, src_len=SRC, tgt_len=TGT):
    if kind == "none":
        return {}
    causal = np.asarray(
        jp.nn.Transformer.generate_square_subsequent_mask(tgt_len).numpy())
    src_mask = np.zeros((B, 1, 1, src_len), np.float32)
    src_mask[1, ..., -3:] = -1e9                      # padding in row 1
    return dict(src_mask=src_mask, tgt_mask=causal,
                memory_mask=src_mask.copy())


def pair(**kw):
    jp.seed(0)
    jm = build(jp.nn, **kw)
    tm = build(tp.nn, **kw)
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert tm.set_state_dict(nn_state_from_reference(jm)) == ([], [])
    return jm, tm


def _grads_close(tm, jm):
    jparams = dict(jm.named_parameters())
    pairs = [(n, p.grad.numpy(), np.asarray(jparams[n].grad.numpy()))
             for n, p in tm.named_parameters()]
    top = max(np.abs(b).max() for _, _, b in pairs)
    for name, a, b in pairs:
        scale = max(np.abs(b).max(), 1e-3 * top)
        assert np.abs(a - b).max() <= 1e-4 * scale, name


@pytest.mark.parametrize("flag", [False, True], ids=["ln_plain",
                                                     "ln_fused"])
@pytest.mark.parametrize("masks", ["none", "masks"])
@pytest.mark.parametrize("nb", [False, True], ids=["post_ln", "pre_ln"])
def test_loss_and_every_gradient_match_jax(nb, masks, flag):
    jm, tm = pair(normalize_before=nb)
    src, tgt, lbl = _data()
    jflags.set_flags({"FLAGS_pallas_layer_norm": flag})
    tflags.set_flags({"FLAGS_pallas_layer_norm": flag})
    try:
        jl = loss_of(jp, jm, src, tgt, lbl, _masks(masks))
        tl = loss_of(tp, tm, src, tgt, lbl, _masks(masks))
        jl.backward()
        tl.backward()
    finally:
        jflags.set_flags({"FLAGS_pallas_layer_norm": False})
        tflags.set_flags({"FLAGS_pallas_layer_norm": False})
    np.testing.assert_allclose(tl.item(), float(jl.numpy()), **LOSS_TOL)
    _grads_close(tm, jm)


def test_head_dim_16_takes_the_flash_route_and_matches_jax(monkeypatch):
    """d_model 64 with 4 heads: head dim 16, which the flash kernels
    take, so the port's encoder self-attention and cross-attention run
    ``flash_attention_bshd`` (its plain version on the CPU) while the
    JAX package's CPU path is XLA; the decoder's masked self-attention
    takes the plain route in both."""
    calls = []
    real = tattn.flash_attention_bshd
    monkeypatch.setattr(tattn, "flash_attention_bshd",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jm, tm = pair(d=64, heads=4)
    src, tgt, lbl = _data(1)
    masks = dict(tgt_mask=_masks("masks")["tgt_mask"])
    jl = loss_of(jp, jm, src, tgt, lbl, masks)
    tl = loss_of(tp, tm, src, tgt, lbl, masks)
    assert len(calls) == 4          # 2 encoder self + 2 cross
    jl.backward()
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl.numpy()), **LOSS_TOL)
    _grads_close(tm, jm)


def _route_shapes():
    # (Sq, Sk, head_dim, embed): lengths that tile by 8 or not, head
    # dims the kernels take
    return [(16, 16, 16, 64), (12, 12, 16, 64), (8, 24, 16, 64),
            (24, 8, 16, 64), (16, 20, 64, 128), (32, 16, 64, 128),
            (5, 16, 16, 64)]


@pytest.mark.parametrize("sq,sk,hd,e", _route_shapes())
def test_attention_reaches_the_flash_op_exactly_by_the_pallas_rule(
        sq, sk, hd, e, monkeypatch):
    calls = []
    real = tattn.flash_attention_bshd
    monkeypatch.setattr(tattn, "flash_attention_bshd",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jp.seed(5)
    jmha = jp.nn.MultiHeadAttention(e, e // hd)
    tmha = tp.nn.MultiHeadAttention(e, e // hd)
    tmha.set_state_dict(nn_state_from_reference(jmha))
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, sq, e)).astype(np.float32)
    kv = rng.standard_normal((2, sk, e)).astype(np.float32)
    # the JAX rule, and the kernels' own limit Sq <= Sk (a longer query
    # takes the plain route here and raises on the card: queue 2 A1)
    want_flash = pallas_flash.supported((2, sq, e // hd, hd),
                                        (2, sk, e // hd, hd)) and sq <= sk
    got = tmha(torch.from_numpy(q), torch.from_numpy(kv),
               torch.from_numpy(kv))
    assert len(calls) == int(want_flash)
    want = jmha(jp.to_tensor(q), jp.to_tensor(kv), jp.to_tensor(kv))
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want.numpy()), rtol=1e-5,
                               atol=1e-5)
    # a mask, dropout in training, or a cache takes the plain route
    calls.clear()
    tmha(torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv),
         attn_mask=torch.zeros(sq, sk))
    tmha.dropout = 0.1
    tmha(torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv))
    tmha.eval()
    cache = (torch.zeros(2, sk, e // hd, hd), torch.zeros(2, sk, e // hd,
                                                          hd))
    tmha(torch.from_numpy(q[:, :1]), cache=cache)
    assert calls == []


def test_bool_mask_is_added_as_a_bias_as_in_jax():
    """A documented reference behaviour: the JAX package adds
    ``attn_mask`` to the logits, so a boolean mask adds 1 where True;
    the port does the same (it does not mask)."""
    jp.seed(6)
    jmha = jp.nn.MultiHeadAttention(32, 4)
    tmha = tp.nn.MultiHeadAttention(32, 4)
    tmha.set_state_dict(nn_state_from_reference(jmha))
    x = np.random.default_rng(6).standard_normal((2, 8, 32)).astype(
        np.float32)
    m = np.tril(np.ones((8, 8), bool))
    got = tmha(torch.from_numpy(x), attn_mask=torch.from_numpy(m))
    want = jmha(jp.to_tensor(x), attn_mask=jp.to_tensor(m))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want.numpy()),
                               rtol=1e-5, atol=1e-5)
    as_bias = tmha(torch.from_numpy(x),
                   attn_mask=torch.from_numpy(m.astype(np.float32)))
    np.testing.assert_allclose(got.detach().numpy(),
                               as_bias.detach().numpy(), rtol=1e-6)


def test_transformer_layers_are_deep_copies():
    for xp in (jp, tp):
        layer = xp.nn.TransformerEncoderLayer(16, 2, 32, dropout=0.0)
        enc = xp.nn.TransformerEncoder(layer, 3)
        w = [enc.layers[i].linear1.weight for i in range(3)]
        assert w[0] is not w[1] and w[0] is not layer.linear1.weight
        np.testing.assert_array_equal(np.asarray(w[0].numpy()) if xp is jp
                                      else w[0].detach().numpy(),
                                      np.asarray(w[2].numpy()) if xp is jp
                                      else w[2].detach().numpy())


def test_dropout_in_training_draws_from_the_port_generator():
    """With dropout 0.1 in training, the same ``paddle.seed`` gives the
    same loss; another seed another; eval mode none."""
    tp.seed(0)
    tm = build(tp.nn, dropout=0.1)
    src, tgt, lbl = _data(7)
    losses = []
    for s in (7, 7, 8):
        tp.seed(s)
        losses.append(loss_of(tp, tm, src, tgt, lbl, {}).item())
    assert losses[0] == losses[1] != losses[2]
    tm.eval()
    assert loss_of(tp, tm, src, tgt, lbl, {}).item() == \
        loss_of(tp, tm, src, tgt, lbl, {}).item()
