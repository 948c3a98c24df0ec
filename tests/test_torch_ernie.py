"""ERNIE with the port (paddle2_tpu_torch.models.ernie) against the JAX
package's ERNIE on ernie_tiny, with the same weights (carried across as
numpy by ernie_state_from_reference) and the same token ids, on the CPU
(the kernels' plain versions): the forward (sequence output, pooled
output, logits), the loss and every parameter gradient, five
``jit.train_step`` losses under AMP O2 bf16, the masked attention
against ``_sdpa_xla``, dropout by its statistics, and the dtypes AMP O2
leaves on the LayerNorm parameters.

The JAX model with stacked blocks trains only under jit
(paddle2_tpu/models/_scan.py:25-58), so its gradients come from
``jit.to_static`` + ``backward`` and its steps from ``jit.train_step``.
On the CPU the JAX package never takes its Pallas LayerNorm
(``_use_pallas_ln`` is False there), so with ``FLAGS_pallas_layer_norm``
on, the port's fused route (f32 statistics, one rounding) is held
against the JAX package's XLA LayerNorm.

Tolerances: f32 forward outputs to 1e-5 absolute; the f32 loss to 1e-4
relative and each gradient to 1e-4 of its largest magnitude (the two
frameworks sum in different orders); bf16 O2 losses to 2e-2 relative
(both round activations to bf16, at different places).
"""

import numpy as np
import pytest
import torch

import paddle2_tpu as paddle
import paddle2_tpu.optimizer as jopt
from paddle2_tpu.framework.tensor import Tensor
from paddle2_tpu.kernels.attention import _sdpa_xla
from paddle2_tpu.models.ernie import ErnieForSequenceClassification as JaxErnie
from paddle2_tpu.models.ernie import ernie_tiny as jax_tiny
from paddle2_tpu.nn import functional as JF
from paddle2_tpu_torch import amp, flags, jit
from paddle2_tpu_torch.kernels import fused_layer_norm as fln
from paddle2_tpu_torch.kernels.attention import scaled_dot_product_attention
from paddle2_tpu_torch.models import (ErnieForSequenceClassification,
                                      GPTForCausalLM, ernie3_base,
                                      ernie_state_from_reference, ernie_tiny,
                                      gpt_tiny)
from paddle2_tpu_torch.optimizer import AdamW

B, S = 2, 16
NO_DROP = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


@pytest.fixture
def ln_flag(request):
    before = flags.get_flags("pallas_layer_norm")
    flags.set_flags({"pallas_layer_norm": request.param})
    yield request.param
    flags.set_flags(before)


def _pair(stacked, bf16=False, **over):
    """The JAX model and the port's with the same f32 weights, both
    decorated for AMP O2 when ``bf16``."""
    paddle.seed(0)
    cfg = dict(NO_DROP, stacked_blocks=stacked, **over)
    jm = JaxErnie(jax_tiny(**cfg))
    tm = ErnieForSequenceClassification(ernie_tiny(**cfg), device="cpu",
                                        seed=1)
    state = {k: np.asarray(v.numpy(), np.float32)
             for k, v in jm.state_dict().items()}
    tm.load_state_dict(ernie_state_from_reference(state))
    if bf16:
        jm = paddle.amp.decorate(jm, level="O2", dtype="bfloat16")
        tm = amp.decorate(tm, level="O2", dtype="bfloat16")
    return jm, tm


def _batch(seed, vocab=256):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    tt = rng.integers(0, 2, size=(B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, rng.integers(3, S):] = 0                 # a padded row
    labels = rng.integers(0, 2, size=(B,)).astype(np.int32)
    return ids, tt, mask, labels


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else Tensor(a)


def _near(got, want, tol):
    got = np.asarray(got, np.float32)
    scale = max(float(np.abs(want).max()), 1e-12)
    assert np.abs(got - want).max() <= tol * scale


FWD = [(st, m, tt) for st in (False, True) for m in (False, True)
       for tt in (False, True)]


@pytest.mark.parametrize("stacked,masked,types", FWD,
                         ids=[f"{'stacked' if st else 'blocks'}-"
                              f"{'mask' if m else 'nomask'}-"
                              f"{'types' if tt else 'notypes'}"
                              for st, m, tt in FWD])
def test_forward_matches_jax(stacked, masked, types):
    jm, tm = _pair(stacked)
    jm.eval()
    tm.eval()
    ids, tt, mask, _ = _batch(0)
    tt = tt if types else None
    mask = mask if masked else None
    jx, jp = jm.ernie(Tensor(ids), _j(tt), _j(mask))
    jlogits = jm(Tensor(ids), _j(tt), _j(mask))
    with torch.no_grad():
        tx, tp = tm.ernie(_t(ids), _t(tt), _t(mask))
        tlogits = tm(_t(ids), _t(tt), _t(mask))
    for got, want in ((tx, jx), (tp, jp), (tlogits, jlogits)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                                   atol=1e-5, rtol=0)


GRADS = [(st, m) for st in (False, True) for m in (False, True)]


@pytest.mark.parametrize("ln_flag", [False, True], ids=["ln_xla", "ln_fused"],
                         indirect=True)
@pytest.mark.parametrize("stacked,masked", GRADS,
                         ids=[f"{'stacked' if st else 'blocks'}-"
                              f"{'mask' if m else 'nomask'}"
                              for st, m in GRADS])
def test_loss_and_grads_match_jax(ln_flag, stacked, masked):
    jm, tm = _pair(stacked)
    assert tm.training
    ids, tt, mask, labels = _batch(3)
    mask = mask if masked else None

    def jloss_fn(i, t, m, lab):
        return jm(i, t, m, labels=lab)[1]
    jloss = paddle.jit.to_static(jloss_fn)(Tensor(ids), Tensor(tt), _j(mask),
                                           Tensor(labels))
    jloss.backward()
    jgrads = ernie_state_from_reference(
        {n: np.asarray(p.grad.numpy(), np.float32)
         for n, p in jm.named_parameters()})
    calls = fln.layer_norm_bwd.launches
    _, loss = tm(_t(ids), _t(tt), _t(mask), labels=_t(labels))
    loss.backward()
    assert fln.layer_norm_bwd.launches == calls     # the CPU runs no kernel
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    tgrads = dict(tm.named_parameters())
    assert set(tgrads) == set(jgrads)
    for name, want in jgrads.items():
        p = tgrads[name]
        assert p.grad is not None and p.grad.dtype == p.dtype, name
        _near(p.grad.numpy(), want.numpy(), 1e-4)


@pytest.mark.parametrize("ln_flag", [True], ids=["ln_fused"], indirect=True)
@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "blocks"])
def test_five_train_steps_track_jax(ln_flag, stacked):
    """``bench_ernie``'s configuration at ernie_tiny size: AMP O2 bf16,
    ``AdamW(multi_precision=True)`` with ``fused=None``, int32 labels,
    through ``jit.train_step`` on both sides."""
    jm, tm = _pair(stacked, bf16=True)
    jo = jopt.AdamW(learning_rate=2e-3, parameters=jm.parameters(),
                    multi_precision=True)
    to = AdamW(learning_rate=2e-3, parameters=tm.parameters(),
               multi_precision=True)
    jstep = paddle.jit.train_step(lambda i, lab: jm(i, labels=lab)[1], jo)
    tstep = jit.train_step(lambda i, lab: tm(i, labels=lab)[1], to)
    jl, tl = [], []
    for i in range(5):
        ids, _, _, labels = _batch(10 + i % 2)
        jl.append(float(jstep(Tensor(ids), Tensor(labels))))
        tl.append(float(tstep(_t(ids), _t(labels))))
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    assert tl[-1] < tl[0]
    p = tm.ernie.word_emb.weight
    assert p.dtype == torch.bfloat16
    assert to._states[id(p)]["master"].dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_masked_attention_matches_sdpa_xla(dtype, causal):
    """An additive bias [B, 1, 1, Sk] with a fully masked row, in the
    activation dtype's finite minimum, as ERNIE builds it: the port's
    plain route against ``_sdpa_xla``, finite everywhere."""
    import jax.numpy as jnp
    rng = np.random.default_rng(5)
    Bq, Sq, H, D = 2, 12, 3, 16
    q, k, v = (rng.normal(size=(Bq, Sq, H, D)).astype(np.float32)
               for _ in range(3))
    keep = np.ones((Bq, Sq), bool)
    keep[0, 7:] = False
    keep[1, :] = False                                # fully masked row
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    neg = float(torch.finfo(dtype).min)
    bias = np.where(keep[:, None, None, :], 0.0, neg).astype(np.float32)
    want = _sdpa_xla(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                     bias=jnp.asarray(bias, jdt), causal=causal)
    got = scaled_dot_product_attention(
        *(torch.from_numpy(a).to(dtype) for a in (q, k, v)),
        attn_mask=torch.from_numpy(bias).to(dtype), is_causal=causal)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=tol, rtol=tol)


def test_bf16_padded_model_is_finite():
    """A bf16 model on padded batches, one row all padding: the finite
    minimum of bf16 keeps the softmax finite (f32's minimum cast to bf16
    would be -inf)."""
    _, tm = _pair(True, bf16=True)
    ids, _, mask, labels = _batch(2)
    mask[0, :] = 0
    logits, loss = tm(_t(ids), attention_mask=_t(mask), labels=_t(labels))
    assert torch.isfinite(logits.float()).all() and torch.isfinite(loss)


def test_attention_dropout_statistics():
    """With q = k = 0 the probabilities are uniform (1/Sk) and v = I
    reads each one out: each output entry is 0 (dropped) or
    ``1/(Sk (1-p))``. The keep rate is 1-p and Sk times the mean
    entry stays 1, within 5 binomial standard deviations; the same generator
    seed gives the same mask; out of training nothing is dropped."""
    p, Bq, H, Sk = 0.25, 4, 4, 32
    q = torch.zeros(Bq, Sk, H, Sk)
    v = torch.eye(Sk).expand(Bq, H, Sk, Sk).transpose(1, 2).contiguous()
    bias = torch.zeros(Bq, 1, 1, Sk)

    def run(seed, training=True):
        return scaled_dot_product_attention(
            q, q, v, attn_mask=bias, dropout_p=p, training=training,
            generator=torch.Generator().manual_seed(seed))
    out = run(0) * Sk                  # entries 0 or 1/(1-p)
    sd = (p * (1 - p) / out.numel()) ** 0.5
    assert abs((out > 0).float().mean().item() - (1 - p)) <= 5 * sd
    assert abs(out.mean().item() - 1.0) <= 5 * sd / (1 - p)
    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(1))
    assert torch.allclose(run(0, training=False) * Sk, torch.ones_like(out))
    # without a mask, dropout in training takes the plain route too
    no_mask = scaled_dot_product_attention(
        q, q, v, dropout_p=p, generator=torch.Generator().manual_seed(0))
    assert torch.equal(no_mask, run(0))


def test_hidden_dropout_statistics_match_jax():
    """The port's hidden dropout (``nn.Dropout``) and the JAX package's
    ``F.dropout`` keep 1-p of the entries and scale them by 1/(1-p), so
    the mean is preserved, within 5 binomial standard deviations."""
    p, n = 0.1, 1 << 16
    cfg = ernie_tiny(hidden_dropout_prob=p)
    tm = ErnieForSequenceClassification(cfg, device="cpu")
    torch.manual_seed(0)
    paddle.seed(0)
    outs = [tm.ernie.drop(torch.ones(n)),
            torch.from_numpy(np.asarray(JF.dropout(
                paddle.to_tensor(np.ones(n, np.float32)), p=p,
                training=True).numpy()))]
    sd = (p * (1 - p) / n) ** 0.5
    scaled = torch.tensor(1.0 / (1 - p)).item()      # 1/(1-p) in f32
    for out in outs:
        assert abs((out > 0).float().mean().item() - (1 - p)) <= 5 * sd
        assert abs(out.mean().item() - 1.0) <= 5 * sd / (1 - p)
        assert set(out.unique().tolist()) <= {0.0, scaled}


@pytest.mark.parametrize("kind", ["ernie", "gpt"])
def test_dropout_only_in_training(kind):
    """A model with dropout on gives a new result each training call
    and, in eval mode, the no-dropout model's: ERNIE with both dropouts,
    and GPT with attention dropout (its attention now passes
    ``attention_dropout_prob`` and the mode, as the JAX package's
    does)."""
    if kind == "ernie":
        def make(**drop):
            return ErnieForSequenceClassification(
                ernie_tiny(**drop), device="cpu", seed=2)
        tm = make(hidden_dropout_prob=0.3, attention_dropout_prob=0.3)
        ref = make(**NO_DROP)
    else:
        tm = GPTForCausalLM(gpt_tiny(attention_dropout_prob=0.3),
                            device="cpu", seed=2)
        ref = GPTForCausalLM(gpt_tiny(), device="cpu", seed=2)
    ids = _t(_batch(4, 128)[0])
    with torch.no_grad():
        assert not torch.equal(tm(ids), tm(ids))
        assert torch.equal(tm.eval()(ids), ref.eval()(ids))


@pytest.mark.parametrize("stacked", [False, True], ids=["blocks", "stacked"])
def test_amp_o2_layer_norm_dtypes(stacked):
    """O2 keeps ``emb_ln``'s scale and shift f32 (its own LayerNorm) and
    casts the stacked LayerNorm leaves to bf16 (they belong to the
    stack), as ``paddle2_tpu/amp/__init__.py:84-106``: the fused kernel
    sees both. Per-block LayerNorms stay f32. The same as the JAX
    model."""
    jm, tm = _pair(stacked, bf16=True)
    params = dict(tm.named_parameters())
    assert params["ernie.emb_ln.weight"].dtype == torch.float32
    assert params["ernie.emb_ln.bias"].dtype == torch.float32
    ln = ("ernie.layers.stacked_ln_1__weight" if stacked
          else "ernie.layers.0.ln_1.weight")
    assert params[ln].dtype == (torch.bfloat16 if stacked
                                else torch.float32)
    assert params["ernie.word_emb.weight"].dtype == torch.bfloat16
    jdt = {n: str(np.asarray(p.numpy()).dtype)
           for n, p in jm.named_parameters()}
    for n, p in params.items():
        assert str(p.dtype).replace("torch.", "") == jdt[n], n


@pytest.mark.parametrize("src_stacked", [False, True],
                         ids=["from_blocks", "from_stacked"])
@pytest.mark.parametrize("dst_stacked", [False, True],
                         ids=["to_blocks", "to_stacked"])
def test_converter_consumes_every_parameter(src_stacked, dst_stacked):
    """A JAX state dict, per-block or stacked, loads into a port model of
    either layout: every name is consumed, none is missing, and the two
    models compute the same logits."""
    paddle.seed(0)
    jm = JaxErnie(jax_tiny(stacked_blocks=src_stacked, **NO_DROP))
    jm.eval()
    tm = ErnieForSequenceClassification(
        ernie_tiny(stacked_blocks=dst_stacked, **NO_DROP), device="cpu")
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    conv = ernie_state_from_reference(state, stacked=dst_stacked)
    assert set(conv) == set(tm.state_dict())
    missing, unexpected = tm.load_state_dict(conv, strict=True)
    assert not missing and not unexpected
    if dst_stacked:
        qkv = tm.ernie.layers.stacked_leaf("attn.qkv.weight")
        assert tuple(qkv.shape) == (2, 192, 64)      # [L, out, in]
    ids = _batch(5)[0]
    with torch.no_grad():
        got = tm.eval()(_t(ids)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm(Tensor(ids)).numpy()),
                               atol=1e-5, rtol=0)


def test_entry_point_and_geometry(monkeypatch):
    """The model starts in training mode, defaults to cuda and raises
    without a GPU; the geometry and parameter count match the JAX
    package's (ERNIE-3.0-base: ~118 M parameters)."""
    tm = ErnieForSequenceClassification(ernie_tiny(), device="cpu")
    assert tm.training and all(m.training for m in tm.modules())
    paddle.seed(0)
    assert tm.num_params() == JaxErnie(jax_tiny()).num_params()
    base = ernie3_base()
    assert (base.vocab_size, base.hidden_size, base.num_layers,
            base.num_heads, base.head_dim, base.ffn_size,
            base.layer_norm_epsilon) == (40000, 768, 12, 12, 64, 3072, 1e-12)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ErnieForSequenceClassification(ernie_tiny())
