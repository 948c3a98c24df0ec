"""The port's quantization module (paddle2_tpu_torch.quantization: fake
quantization, the observers and quanters, QAT, PTQ and its full-int8
``QuantedInferenceLinear``), ``load_quanted_reference``, PTQ serving and
the training-time ``quantized_lm_head``, held against the JAX package on
the same numpy inputs, on the CPU (``int8_matmul`` runs its plain
version there).

Tolerances, with their reasons:
- payloads, scales of weights and int32 products: bitwise (the same f32
  operations on the same values; the int8 products are exact);
- the observers' moving averages: one f32 ulp (``0.9 * prev + 0.1 *
  cur`` in f32 on both sides; XLA may contract it into one rounding);
- ``act_scale`` after calibration through a network: 1e-6 relative (the
  observed activations carry f32 matmul sums taken in another order);
- fake quantization: f32 rtol 1e-6 forward (the same grid, the same
  operations) and 1e-5 of the largest magnitude for gradients through a
  network (matmul sums in another order);
- ``QuantedInferenceLinear`` fed the JAX layer's state: one f32 ulp, and
  one bf16 ulp for a bf16 input;
- a converted gpt_tiny: logits atol 1e-4, the f32 tolerance of the GPT
  tests, with the layer-0 int8 inputs equal (no rounding flip, which
  would show as one quantization step, ~1e-3 here);
- ``quantized_lm_head``: loss 1e-4 relative, gradients 1e-4 of their
  largest magnitude, as the training tests.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle2_tpu as paddle
from paddle2_tpu import nn as jnn
from paddle2_tpu import quantization as jq
from paddle2_tpu.framework.tensor import Tensor
from paddle2_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle2_tpu.models.gpt import gpt_tiny as jax_tiny
from paddle2_tpu.serving import EngineConfig as JaxEngineConfig
from paddle2_tpu.serving import ServingEngine as JaxEngine
from paddle2_tpu_torch import nn as tnn
from paddle2_tpu_torch.framework.core import place_scope
from paddle2_tpu_torch import quantization as tq
from paddle2_tpu_torch.models import (GPTForCausalLM, gpt_state_from_reference,
                                      gpt_tiny, load_quanted_reference)
from paddle2_tpu_torch.serving import EngineConfig, ServingEngine

CHANNELWISE = dict(activation="FakeQuanterWithAbsMaxObserver",
                   weight="FakeQuanterChannelWiseAbsMaxObserver")


def _config(mod, kind):
    """The JAX or the port's QuantConfig: the default (per-tensor
    quanters for both) or per-channel weights."""
    if kind == "default":
        return mod.QuantConfig()
    return mod.QuantConfig(**{k: getattr(mod, v)
                              for k, v in CHANNELWISE.items()})


def _ulps(got, want):
    """Distance in units of the last place of ``want`` (f32)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want) / np.spacing(np.abs(want))


# ------------------------------------------------------------ fake_quant
@pytest.mark.parametrize("per_channel", [False, True])
def test_fake_quant_forward_and_ste_grad_match_jax(per_channel):
    rs = np.random.RandomState(0)
    x = (rs.randn(6, 5) * 3).astype(np.float32)
    if per_channel:
        scale, axis = np.array([1.0, 4.0, 0.5, 2.0, 1e-12], np.float32), 1
    else:
        scale, axis = np.float32(2.5), None
    jx = paddle.to_tensor(x)
    jx.stop_gradient = False
    jout = jq.fake_quant(jx, scale, bits=8, quant_axis=axis)
    (jout * paddle.to_tensor(x)).sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    tout = tq.fake_quant(tx, torch.from_numpy(np.asarray(scale)), bits=8,
                         quant_axis=axis)
    (tout * torch.from_numpy(x)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(),
                               rtol=1e-6, atol=0)
    # the straight-through estimator: the incoming gradient, unchanged
    assert np.array_equal(tx.grad.numpy(), np.asarray(jx.grad.numpy()))
    assert np.array_equal(tx.grad.numpy(), x)


def test_fake_quant_of_bf16_promotes_to_f32_as_jax():
    x = np.linspace(-2, 2, 9).astype(np.float32)
    jout = jq.fake_quant(paddle.to_tensor(x).astype("bfloat16"), 2.0)
    tout = tq.fake_quant(torch.from_numpy(x).bfloat16(), 2.0)
    assert tout.dtype == torch.float32 and str(jout.dtype) == "float32"
    np.testing.assert_allclose(tout.numpy(), jout.numpy(), rtol=1e-6)


# ------------------------------------------------------------- observers
@pytest.mark.parametrize("kind", ["absmax", "channelwise"])
def test_observers_moving_average_matches_jax(kind):
    """Three batches of calibration, then freeze: the moving average
    within one f32 ulp of the JAX observer's after every batch, and
    unchanged by a fourth batch after the freeze."""
    rs = np.random.RandomState(1)
    batches = [(rs.randn(7, 5) * s).astype(np.float32) for s in (1, 3, .5)]
    if kind == "absmax":
        jo, to = jq.AbsmaxObserver(), tq.AbsmaxObserver()
    else:
        jo = jq.ChannelWiseAbsMaxObserver(quant_axis=1, channels=5)
        to = tq.ChannelWiseAbsMaxObserver(quant_axis=1, channels=5)
    assert np.array_equal(np.asarray(to.scale()), np.asarray(jo.scale()))
    for b in batches:
        jo(paddle.to_tensor(b))
        to(torch.from_numpy(b))
        assert _ulps(np.asarray(to.scale()), np.asarray(jo.scale())).max() \
            <= 1.0
        assert isinstance(to.raw_scale(), torch.Tensor)
    jo.freeze()
    to.freeze()
    frozen = np.asarray(to.scale()).copy()
    to(torch.from_numpy(batches[1] * 100))
    assert np.array_equal(np.asarray(to.scale()), frozen)
    assert not any("_absmax" in k or "_seen" in k for k in to.state_dict())


def test_observer_buffers_follow_the_model():
    obs = tq.ChannelWiseAbsMaxObserver(quant_axis=0, channels=3)
    assert obs._absmax.device.type == "cpu"
    obs(torch.ones(3, 2) * torch.tensor([[1.0], [2.0], [3.0]]))
    assert torch.equal(obs.scale(), torch.tensor([1.0, 2.0, 3.0]))


# ------------------------------------------------------------------- QAT
def _linear_nets(seed=0):
    paddle.seed(seed)
    jm = jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(), jnn.Linear(32, 8))
    tm = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.ReLU(),
                             torch.nn.Linear(32, 8))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    with torch.no_grad():
        for i in (0, 2):
            tm[i].weight.copy_(torch.from_numpy(state[f"{i}.weight"].T))
            tm[i].bias.copy_(torch.from_numpy(state[f"{i}.bias"]))
    return jm, tm


def _conv_nets(seed=0):
    paddle.seed(seed)
    jm = jnn.Sequential(jnn.Conv2D(3, 4, 3, padding=1), jnn.ReLU(),
                        jnn.Conv2D(4, 2, 3, stride=2))
    with place_scope("cpu"):
        tm = torch.nn.Sequential(tnn.Conv2D(3, 4, 3, padding=1),
                                 torch.nn.ReLU(),
                                 tnn.Conv2D(4, 2, 3, stride=2))
    tm.load_state_dict({k: torch.from_numpy(np.asarray(v.numpy()))
                        for k, v in jm.state_dict().items()})
    return jm, tm


def _train_step_grads(jm, tm, x, r):
    """One step of ``sum(net(x) * r)``: the loss and every parameter's
    gradient on both sides (JAX names; a Linear's weight transposed to
    the JAX layout)."""
    jloss = (jm(paddle.to_tensor(x)) * paddle.to_tensor(r)).sum()
    jloss.backward()
    tloss = (tm(torch.from_numpy(x)) * torch.from_numpy(r)).sum()
    tloss.backward()
    jg = {n.replace(".inner", ""): np.asarray(p.grad.numpy())
          for n, p in jm.named_parameters()}
    tg = {}
    for n, p in tm.named_parameters():
        g = p.grad.numpy()
        if g.ndim == 2:
            g = g.T
        tg[n.replace(".inner", "")] = g
    return float(jloss), tloss.item(), jg, tg


@pytest.mark.parametrize("kind", ["default", "channelwise"])
@pytest.mark.parametrize("net", ["linear", "conv"])
def test_qat_train_step_grads_match_jax(net, kind):
    jm, tm = (_linear_nets if net == "linear" else _conv_nets)()
    jq.QAT(_config(jq, kind)).quantize(jm)
    tq.QAT(_config(tq, kind)).quantize(tm)
    assert isinstance(tm[0], tq._QuantedWrapper)
    assert isinstance(tm[0].w_quanter,
                      tq.FakeQuanterChannelWiseAbsMaxObserver
                      if kind == "channelwise"
                      else tq.FakeQuanterWithAbsMaxObserver)
    rs = np.random.RandomState(2)
    shape = (4, 16) if net == "linear" else (2, 3, 8, 8)
    x = (rs.randn(*shape) * 2).astype(np.float32)
    out_shape = (4, 8) if net == "linear" else (2, 2, 3, 3)
    r = rs.randn(*out_shape).astype(np.float32)
    jl, tl, jg, tg = _train_step_grads(jm, tm, x, r)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert set(jg) == set(tg)
    for n, want in jg.items():
        scale = np.abs(want).max()
        assert np.abs(tg[n] - want).max() <= 1e-5 * scale, n
    # the weight quanter saw the weight: per output channel when asked
    w_obs = tm[0].w_quanter.observer
    if kind == "channelwise":
        assert tuple(w_obs.scale().shape) == (tm[0].inner.weight.shape[0],)


def test_quant_aware_is_qat():
    _, tm = _linear_nets()
    tq.quant_aware(tm)
    assert all(isinstance(tm[i], tq._QuantedWrapper) for i in (0, 2))


def test_add_type_config_picks_the_layer_type():
    cfg = tq.QuantConfig(activation=tq.FakeQuanterWithAbsMaxObserver)
    cfg.add_type_config(torch.nn.Linear,
                        weight=tq.FakeQuanterChannelWiseAbsMaxObserver)
    act, w = cfg.quanter_for(torch.nn.Linear(2, 3))
    assert act is tq.FakeQuanterWithAbsMaxObserver
    assert w is tq.FakeQuanterChannelWiseAbsMaxObserver
    with place_scope("cpu"):
        conv = tnn.Conv2D(1, 1, 1)
    assert cfg.quanter_for(conv) == (tq.FakeQuanterWithAbsMaxObserver, None)


# ------------------------------------------------------------------- PTQ
@pytest.mark.parametrize("kind", ["default", "channelwise"])
def test_ptq_on_the_jax_tests_sequential(kind):
    """``tests/test_quantization.py``'s PTQ net: four calibration passes,
    then convert. Payloads and weight scales bitwise, ``act_scale`` to
    1e-6 relative, the converted output to one f32 ulp of JAX's (scaled
    by the output's largest magnitude: the int32 products are exact and
    the layers see the same int8 inputs)."""
    jm, tm = _linear_nets()
    rs = np.random.RandomState(0)
    x = rs.randn(8, 16).astype(np.float32)
    jptq, tptq = jq.PTQ(_config(jq, kind)), tq.PTQ(_config(tq, kind))
    jptq.quantize(jm)
    tptq.quantize(tm)
    for _ in range(4):
        jm(paddle.to_tensor(x))
        tm(torch.from_numpy(x))
    jptq.convert(jm)
    tptq.convert(tm)
    for i in (0, 2):
        jl, tl = jm[i], tm[i]
        assert isinstance(tl, tq.QuantedInferenceLinear)
        assert tl.weight_int8.dtype == torch.int8
        assert np.array_equal(tl.weight_int8.numpy(),
                              np.asarray(jl.weight_int8.numpy()))
        assert np.array_equal(tl.w_scale.numpy(),
                              np.asarray(jl.w_scale.numpy()))
        assert np.array_equal(tl.bias.numpy(), np.asarray(jl.bias.numpy()))
        np.testing.assert_allclose(tl.act_scale, jl.act_scale, rtol=1e-6)
    sd = tm.state_dict()
    assert any("weight_int8" in k for k in sd)
    assert any("w_scale" in k for k in sd)
    ref = np.asarray(jm(paddle.to_tensor(x)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert np.abs(got - ref).max() <= np.spacing(np.abs(ref).max())


def test_ptq_convert_freezes_conv_wrappers_and_copies_when_asked():
    _, tm = _conv_nets()
    ptq = tq.PTQ()
    ptq.quantize(tm)
    x = torch.randn(2, 3, 8, 8, generator=torch.Generator().manual_seed(0))
    tm(x)
    copy = ptq.convert(tm, inplace=False)
    assert not tm[0].act_quanter.observer._frozen
    assert copy[0].act_quanter.observer._frozen
    assert copy[0].w_quanter.observer._frozen
    before = copy[0].act_quanter.observer.scale()
    copy(x * 100)
    assert copy[0].act_quanter.observer.scale() == before


def _jax_product(layer, a):
    """The JAX layer's int32 product, by its own operations
    (quantization/__init__.py:349-358)."""
    s_in = max(layer.act_scale, 1e-8)
    q = jnp.clip(jnp.round(a / s_in * layer.qmax), -layer.qmax,
                 layer.qmax).astype(jnp.int8)
    return np.asarray(jax.lax.dot_general(
        q, layer.weight_int8._data, (((a.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_quanted_inference_linear_matches_jax(dtype, with_bias, monkeypatch):
    """The port's layer built from the JAX layer's state and act_scale:
    the int32 product bitwise, the output within one ulp of its dtype."""
    rs = np.random.RandomState(4)
    K, N = 48, 20
    w = rs.randn(K, N).astype(np.float32)
    qmax = 127.0
    w_scale = np.maximum(np.abs(w).max(axis=0), 1e-8)
    w_int8 = np.clip(np.round(w / w_scale * qmax), -qmax,
                     qmax).astype(np.int8)
    bias = rs.randn(N).astype(np.float32) if with_bias else None
    x = (rs.randn(2, 7, K) * 0.8).astype(np.float32)
    act_scale = float(np.abs(x).max()) * 0.9      # some inputs clip
    jl = jq.QuantedInferenceLinear(w_int8, w_scale, bias, act_scale)
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    tl = tq.QuantedInferenceLinear(
        torch.from_numpy(state["weight_int8"]),
        torch.from_numpy(state["w_scale"]),
        None if bias is None else torch.from_numpy(state["bias"]),
        jl.act_scale)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    seen = []
    real = tq.int8_matmul
    monkeypatch.setattr(tq, "int8_matmul",
                        lambda a, b: seen.append(real(a, b)) or seen[-1])
    got = tl(tx)
    want_acc = _jax_product(jl, jx).reshape(-1, N)
    assert np.array_equal(seen[0].numpy(), want_acc)
    ref = jl(Tensor(jx))
    assert got.dtype == tx.dtype and tuple(got.shape) == (2, 7, N)
    if dtype == "float32":
        assert _ulps(got.numpy(), np.asarray(ref.numpy())).max() <= 1.0
    else:
        g = got.float().numpy()
        r = np.asarray(ref.numpy().astype(np.float32))
        step = np.spacing(np.abs(r).astype(np.float32)) * 2 ** 16
        assert (np.abs(g - r) <= step).all()


# ------------------------------------------------------------- gpt_tiny
LINEARS = ("attn.qkv", "attn.out_proj", "mlp.up", "mlp.down")


def _calibration_ids():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 128, (2, 16)).astype(np.int32)
            for _ in range(3)]


def _ptq_jax_tiny():
    """gpt_tiny (per-block storage) through PTQ with per-channel weights
    on each block, three calibration forwards of [2, 16] ids, convert:
    the JAX model, its state and its layers' act_scales; and the fp
    state it started from."""
    paddle.seed(0)
    jm = JaxGPT(jax_tiny(use_scan=False))
    fp_state = {k: np.asarray(v.numpy()) for k, v in
                jm.state_dict().items()}
    ptq = jq.PTQ(_config(jq, "channelwise"))
    for blk in jm.gpt.h:
        ptq.quantize(blk)
    for ids in _calibration_ids():
        jm(Tensor(ids))
    for blk in jm.gpt.h:
        ptq.convert(blk)
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    scales = {n: l.act_scale for n, l in jm.named_sublayers()
              if isinstance(l, jq.QuantedInferenceLinear)}
    return jm, state, scales, fp_state


@pytest.fixture(scope="module")
def ptq_tiny():
    return _ptq_jax_tiny()


def test_gpt_ptq_on_both_sides_agrees(ptq_tiny):
    """The port's PTQ over the same fp weights and calibration ids gives
    the JAX payloads and weight scales bitwise and its act_scales to
    1e-6 relative: 8 QuantedInferenceLinear, four a block."""
    _, state, scales, fp_state = ptq_tiny
    tm = GPTForCausalLM(gpt_tiny(), device="cpu", seed=3)
    tm.load_state_dict(gpt_state_from_reference(fp_state))
    ptq = tq.PTQ(_config(tq, "channelwise"))
    for blk in tm.gpt.h:
        ptq.quantize(blk)
    with torch.no_grad():
        for ids in _calibration_ids():
            tm(torch.from_numpy(ids).long())
    for blk in tm.gpt.h:
        ptq.convert(blk)
    got = {n: m for n, m in tm.named_modules()
           if isinstance(m, tq.QuantedInferenceLinear)}
    assert sorted(got) == sorted(scales) and len(got) == 8
    for n, m in got.items():
        assert np.array_equal(m.weight_int8.numpy(),
                              state[n + ".weight_int8"]), n
        assert np.array_equal(m.w_scale.numpy(), state[n + ".w_scale"]), n
        np.testing.assert_allclose(m.act_scale, scales[n], rtol=1e-6)


def test_load_quanted_reference_carries_the_jax_model(ptq_tiny):
    jm, state, scales, _ = ptq_tiny
    tm = load_quanted_reference(GPTForCausalLM(gpt_tiny(), device="cpu",
                                               seed=5), state, scales)
    blk = tm.gpt.h[0]
    assert all(isinstance(blk.get_submodule(p), tq.QuantedInferenceLinear)
               for p in LINEARS)
    assert torch.equal(blk.attn.qkv.weight_int8,
                       torch.from_numpy(state["gpt.h.0.attn.qkv.weight_int8"]))
    assert blk.mlp.up.act_scale == scales["gpt.h.0.mlp.up"]
    ids = np.random.default_rng(2).integers(0, 128, (2, 24)).astype(np.int32)
    # the layer-0 qkv int8 input on both sides
    j_in, t_in = [], []
    jl = jm.gpt.h[0].attn.qkv
    h = jm.gpt.h[0].ln_1(jm.gpt.wte(Tensor(ids))
                         + jm.gpt.wpe(Tensor(np.arange(24)[None])))
    j_in.append(_jax_product(jl, h._data))
    hook = blk.attn.qkv.register_forward_pre_hook(
        lambda mod, inp: t_in.append(inp[0].detach().clone()))
    ref = np.asarray(jm(Tensor(ids)).numpy())
    with torch.no_grad():
        out = tm(torch.from_numpy(ids).long()).numpy()
    hook.remove()
    t_acc = tq.int8_matmul(
        torch.round(t_in[0] / blk.attn.qkv.act_scale * 127).clamp(
            -127, 127).to(torch.int8).reshape(-1, 64),
        blk.attn.qkv.weight_int8)
    assert np.array_equal(t_acc.numpy(), j_in[0].reshape(-1, 192))
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_load_quanted_reference_needs_every_act_scale(ptq_tiny):
    _, state, scales, _ = ptq_tiny
    partial = dict(scales)
    partial.pop("gpt.h.1.mlp.down")
    with pytest.raises(ValueError, match="gpt.h.1.mlp.down"):
        load_quanted_reference(GPTForCausalLM(gpt_tiny(), device="cpu"),
                               state, partial)


ENGINE_KW = dict(block_size=8, num_blocks=32, max_batch=2)


def _drain(eng, max_steps=200):
    steps = 0
    while not eng.idle() and steps < max_steps:
        eng.tick(now=float(steps))
        steps += 1
    assert eng.idle(), "engine did not drain"


def test_ptq_engine_serves_the_jax_engines_tokens(ptq_tiny):
    """Token for token: the port's engine over the converted gpt_tiny ==
    the JAX engine over the same converted model == the port's dense
    greedy generate; ``weight_only_int8`` finds no Linear left in the
    blocks and changes nothing, as in JAX."""
    jm, state, scales, _ = ptq_tiny
    tm = load_quanted_reference(GPTForCausalLM(gpt_tiny(), device="cpu"),
                                state, scales)
    eng = ServingEngine(tm, EngineConfig(**ENGINE_KW, weight_only_int8=True),
                        device="cpu")
    assert isinstance(tm.gpt.h[0].mlp.up, tq.QuantedInferenceLinear)
    jeng = JaxEngine(jm, config=JaxEngineConfig(**ENGINE_KW))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, size=n).tolist() for n in (11, 6)]
    rids = [eng.submit(p, max_new_tokens=5) for p in prompts]
    jrids = [jeng.submit(p, max_new_tokens=5) for p in prompts]
    _drain(eng)
    _drain(jeng)
    for p, r, jr in zip(prompts, rids, jrids):
        got = eng.sequence(r).generated
        assert got == jeng.sequence(jr).generated
        dense = tm.generate(np.asarray([p]), max_new_tokens=5)
        assert got == dense[0, len(p):].tolist()


# ------------------------------------------------------ quantized_lm_head
@pytest.mark.parametrize("tied", [True, False])
def test_quantized_lm_head_loss_and_grads_match_jax(tied):
    paddle.seed(0)
    kw = dict(quantized_lm_head=True, tie_word_embeddings=tied)
    jm = JaxGPT(jax_tiny(use_scan=False, **kw))
    tm = GPTForCausalLM(gpt_tiny(**kw), device="cpu", seed=1)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm.load_state_dict(gpt_state_from_reference(state))
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 128, (2, 16)).astype(np.int32)
    labels = rng.integers(0, 128, (2, 16)).astype(np.int32)
    jlogits, jloss = jm(Tensor(ids), labels=Tensor(labels))
    jloss.backward()
    jgrads = gpt_state_from_reference(
        {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()})
    logits, loss = tm(torch.from_numpy(ids).long(),
                      labels=torch.from_numpy(labels).long())
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(jlogits.numpy()), atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    for n, p in tm.named_parameters():
        want = jgrads[n].numpy()
        assert np.abs(p.grad.numpy() - want).max() <= \
            1e-4 * np.abs(want).max(), n
    # the head really is fake-quantized: not the fp head's logits
    tm.cfg.quantized_lm_head = False
    with torch.no_grad():
        fp = tm(torch.from_numpy(ids).long())
    assert not torch.equal(fp, logits.detach())


def test_quantized_lm_head_refuses_the_fused_head_as_jax():
    cfg = dict(quantized_lm_head=True, fused_head_loss=True)
    with pytest.raises(ValueError, match="mutually exclusive") as port:
        GPTForCausalLM(gpt_tiny(**cfg), device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive") as ref:
        JaxGPT(jax_tiny(**cfg))
    assert str(port.value) == str(ref.value)


# ---------------------------------------------------------- the surface
def test_public_names_equal_the_jax_all():
    assert tq.__all__ == jq.__all__
    for name in tq.__all__:
        assert hasattr(tq, name), name


def test_quanter_registry():
    @tq.quanter("my_quanter")
    class MyQuanter(tq.BaseQuanter):
        pass
    assert tq._QUANTER_REGISTRY["my_quanter"] is MyQuanter
    assert MyQuanter.__quanter_name__ == "my_quanter"
    assert MyQuanter().zero_points() is None
    with pytest.raises(NotImplementedError):
        tq.BaseObserver()(torch.ones(1))
