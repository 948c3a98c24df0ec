"""``paddle2_tpu_torch.incubate.nn``'s aliases and parameter attributes
against the JAX package's ``incubate.nn``, and the ``GradScaler``'s
metrics records against the JAX scaler's.

- ``FusedMultiHeadAttention``, ``FusedLinear`` and
  ``FusedTransformerEncoderLayer``: the JAX layer's state dict loads
  into the port's as it is and, in eval mode, the outputs agree (f32,
  1e-5: the same products, summed in other orders).
- Parameter attributes: where the JAX layers honour one
  (``FusedFeedForward``'s two weight attributes), a constant initializer
  gives the same values and a normal one the same moments (mean within
  4e-3, std within 5 % at 8,192 draws; the two packages draw from
  different generators). Where the JAX layers drop an attribute, the
  port applies it, as the reference's layers do; those cases hold the
  port alone.
- ``FusedMultiTransformer``: per-layer attribute lists and
  ``trans_qkvw=False``, whose forward equals the default layout's with
  the weights permuted (f32, 1e-5).
- ``GradScaler``: the same steps write the same
  ``amp_skipped_steps_total`` counter and ``amp_loss_scale`` gauge in
  both packages' metrics planes.
"""

import numpy as np
import pytest
import torch

import paddle2_tpu as jp
import paddle2_tpu.amp as jamp
import paddle2_tpu.incubate.nn as jinn
import paddle2_tpu.nn as jnn
import paddle2_tpu.optimizer as jopt
from paddle2_tpu.observability import metrics as jmetrics
import paddle2_tpu_torch as tp
import paddle2_tpu_torch.incubate.nn as tinn
import paddle2_tpu_torch.nn as tnn
from paddle2_tpu_torch import amp as tamp
from paddle2_tpu_torch.observability import metrics as tmetrics
from paddle2_tpu_torch.optimizer import SGD


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")
    yield
    jmetrics.disable()
    tmetrics.disable()


def test_the_names_follow_the_jax_all():
    want = [n for n in jinn.__all__ if n != "MoELayer"]
    assert tinn.__all__ == want
    assert tinn.FusedLinear is tnn.Linear
    assert tinn.FusedMultiHeadAttention is tnn.MultiHeadAttention
    from paddle2_tpu_torch.nn.layer.transformer import \
        TransformerEncoderLayer
    assert tinn.FusedTransformerEncoderLayer is TransformerEncoderLayer


ALIASES = {
    "FusedLinear": (lambda m: m.FusedLinear(8, 12), 1),
    "FusedMultiHeadAttention": (
        lambda m: m.FusedMultiHeadAttention(8, 2), 1),
    "FusedTransformerEncoderLayer": (
        lambda m: m.FusedTransformerEncoderLayer(8, 2, 16, dropout=0.0),
        1),
}


@pytest.mark.parametrize("name", list(ALIASES))
def test_alias_state_dicts_and_forwards_match(name):
    make, _ = ALIASES[name]
    jp.seed(0)
    jl = make(jinn)
    tl = make(tinn)
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    assert list(tl.state_dict()) == list(state)
    tl.set_state_dict({k: torch.from_numpy(v.copy())
                       for k, v in state.items()})
    jl.eval()
    tl.eval()
    x = np.random.default_rng(1).standard_normal((2, 5, 8)).astype(
        np.float32)
    want = jl(jp.to_tensor(x)).numpy()
    got = tl(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _ffn(m, **attrs):
    kw = {} if m is jinn else {"device": "cpu"}
    return m.FusedFeedForward(64, 128, 0.0, **attrs, **kw)


def test_weight_attributes_draw_as_the_jax_layers():
    """A constant initializer gives the same tensor; a normal one the
    same moments."""
    const = {"linear1_weight_attr": jnn.ParamAttr(
        initializer=jnn.initializer.Constant(0.25)),
        "linear2_weight_attr": jnn.initializer.Constant(-0.5)}
    jl = _ffn(jinn, **const)
    tl = _ffn(tinn, linear1_weight_attr=tnn.ParamAttr(
        initializer=tnn.initializer.Constant(0.25)),
        linear2_weight_attr=tnn.initializer.Constant(-0.5))
    for n in ("linear1_weight", "linear2_weight"):
        np.testing.assert_array_equal(getattr(tl, n).detach().numpy(),
                                      getattr(jl, n).numpy())
    jp.seed(5)
    tp.seed(5)
    jl = _ffn(jinn, linear1_weight_attr=jnn.initializer.Normal(0.1, 0.02))
    tl = _ffn(tinn, linear1_weight_attr=tnn.initializer.Normal(0.1, 0.02))
    j = jl.linear1_weight.numpy()
    t = tl.linear1_weight.detach().numpy()
    assert t.shape == j.shape == (64, 128)
    assert abs(t.mean() - j.mean()) < 4e-3
    assert abs(t.std() / j.std() - 1.0) < 0.05
    # the default draw (no attribute) is the JAX layers' Xavier normal
    t = _ffn(tinn).linear1_weight.detach().numpy()
    assert abs(t.std() / np.sqrt(2.0 / (64 + 128)) - 1.0) < 0.05


def test_the_port_applies_the_attributes_the_jax_layers_drop():
    tl = tinn.FusedBiasDropoutResidualLayerNorm(
        8, weight_attr=tnn.initializer.Constant(2.0),
        bias_attr=tnn.ParamAttr(initializer=tnn.initializer.Constant(0.5),
                                learning_rate=0.1, need_clip=False),
        device="cpu")
    assert torch.equal(tl.ln_scale, torch.full((8,), 2.0))
    assert torch.equal(tl.linear_bias, torch.full((8,), 0.5))
    assert tl.ln_bias.optimize_attr == {"learning_rate": 0.1}
    assert tl.ln_bias.need_clip is False
    ffn = _ffn(tinn, ln2_scale_attr=tnn.initializer.Constant(3.0),
               linear1_bias_attr=False,
               linear2_bias_attr=tnn.ParamAttr(trainable=False))
    assert torch.equal(ffn.ln2_scale, torch.full((64,), 3.0))
    assert ffn.linear1_bias is None and "linear1_bias" not in \
        ffn.state_dict()
    assert not ffn.linear2_bias.requires_grad
    ffn.eval()
    assert ffn(torch.ones(2, 3, 64)).shape == (2, 3, 64)
    with pytest.raises(ValueError, match="cannot be False"):
        _ffn(tinn, linear1_weight_attr=False)


def test_multi_transformer_takes_attribute_lists_and_the_qkv_layout():
    c = tnn.initializer.Constant
    ml = tinn.FusedMultiTransformer(
        8, 2, 16, num_layers=2, device="cpu",
        qkv_weight_attrs=[c(1.0), c(2.0)], ffn1_bias_attrs=c(0.5))
    assert torch.equal(ml.l0_qkv_w, torch.ones(3, 2, 4, 8))
    assert torch.equal(ml.l1_qkv_w, torch.full((3, 2, 4, 8), 2.0))
    assert all(torch.equal(b, torch.full((16,), 0.5))
               for b in ml.ffn1_biases)
    with pytest.raises(ValueError, match="2 layers"):
        tinn.FusedMultiTransformer(8, 2, 16, num_layers=2, device="cpu",
                                   ln_scale_attrs=[c(1.0)])
    with pytest.raises(TypeError, match="residual_alpha"):
        tinn.FusedMultiTransformer(8, 2, 16, device="cpu",
                                   residual_alpha=2.0)
    # trans_qkvw=False: [embed, 3, heads, head_dim], the same function
    a = tinn.FusedMultiTransformer(8, 2, 16, num_layers=2, device="cpu")
    b = tinn.FusedMultiTransformer(8, 2, 16, num_layers=2, device="cpu",
                                   trans_qkvw=False)
    assert b.l0_qkv_w.shape == (8, 3, 2, 4)
    state = {k: (v.permute(3, 0, 1, 2).contiguous() if k.endswith("qkv_w")
                 else v) for k, v in a.state_dict().items()}
    b.load_state_dict(state)
    a.eval()
    b.eval()
    x = torch.randn(2, 5, 8, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(b(x), a(x), rtol=1e-5, atol=1e-5)


def test_grad_scaler_metrics_records_match(tmp_path):
    """Steps with a non-finite gradient at 1 and 2, growth every 2 good
    steps: the same skipped-step counter and loss-scale gauge, step by
    step, in both planes."""
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)
    tpar = torch.nn.Parameter(torch.ones(3))
    jpar = jp.create_parameter([3], "float32")
    ts, js = tamp.GradScaler(**kw), jamp.GradScaler(**kw)
    topt = SGD(learning_rate=0.1, parameters=[tpar])
    jo = jopt.SGD(learning_rate=0.1, parameters=[jpar])
    tpl = tmetrics.enable(str(tmp_path / "t"), rank=0)
    jpl = jmetrics.enable(str(tmp_path / "j"), rank=0)
    for i in range(6):
        g = np.full(3, np.inf if i in (1, 2) else 1.0, np.float32)
        tpar.grad = torch.from_numpy(g * np.float32(ts.get_loss_scaling()))
        jpar.grad = jp.to_tensor(g * np.float32(js.get_loss_scaling()))
        ts.step(topt)
        js.step(jo)
        ts.update()
        js.update()
        for name, kind in (("amp_skipped_steps_total", "counter"),
                           ("amp_loss_scale", "gauge")):
            assert getattr(tpl, kind)(name).value() == \
                getattr(jpl, kind)(name).value(), (i, name)
    assert tpl.counter("amp_skipped_steps_total").value() == 2.0
    assert tpl.snapshot() == jpl.snapshot()
