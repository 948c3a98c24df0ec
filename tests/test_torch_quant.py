"""The port's int8 weight-only path (paddle2_tpu_torch.kernels.quant_matmul,
paddle2_tpu_torch.quantization and the engine's weight_only_int8 /
weight_only_lm_head) held against the JAX package on the same numpy
inputs, on the CPU (the wrapper runs its plain version there).

Tolerances: f32 rtol 2e-5 / atol 2e-4 (the JAX bench's, the two sum in
different orders); bf16 one output ulp (the f32 sums differ in their
last bits, which can move a bf16 rounding by one step). Payloads and
scales are compared bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle2_tpu as paddle
from paddle2_tpu.framework.tensor import Tensor
from paddle2_tpu.kernels import pallas_matmul as pm
from paddle2_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle2_tpu.models.gpt import gpt_tiny as jax_tiny
from paddle2_tpu.quantization import \
    ChannelWiseAbsMaxObserver as JaxObserver
from paddle2_tpu.quantization import quantize_lm_head as jax_quantize_head
from paddle2_tpu.quantization import weight_only_quantize as jax_quantize
from paddle2_tpu.serving import EngineConfig as JaxEngineConfig
from paddle2_tpu.serving import ServingEngine as JaxEngine
from paddle2_tpu_torch.kernels import quant_matmul as qm
from paddle2_tpu_torch.kernels.quant_matmul import (
    channel_absmax, int8_weight_only_matmul,
    int8_weight_only_matmul_reference, quantize_channelwise,
    weight_quant_error_bound)
from paddle2_tpu_torch.models import (GPTForCausalLM, gpt_state_from_reference,
                                      gpt_tiny, load_weight_only_reference)
from paddle2_tpu_torch.quantization import (ChannelWiseAbsMaxObserver,
                                            WeightOnlyLinear,
                                            WeightOnlyLMHead,
                                            quantize_lm_head,
                                            weight_only_quantize)
from paddle2_tpu_torch.serving import EngineConfig, ServingEngine

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _operands(seed, M, K, N, dtype, with_bias, lead=None):
    """x, w_int8, scale, bias as numpy (x and bias already rounded to
    ``dtype``), quantized by the JAX package."""
    rs = np.random.RandomState(seed)
    x = rs.randn(*(lead or (M,)), K).astype(np.float32)
    w = rs.randn(K, N).astype(np.float32)
    w_i8, scale = pm.quantize_channelwise(jnp.asarray(w), 8, axis=1)
    b = rs.randn(N).astype(np.float32) if with_bias else None
    tdt, _ = DTYPES[dtype]
    rnd = (lambda a: torch.from_numpy(a).to(tdt).float().numpy())
    return (rnd(x), np.asarray(w_i8), np.asarray(scale),
            None if b is None else rnd(b))


def _port(x, w_i8, scale, b, dtype):
    tdt, _ = DTYPES[dtype]
    out = int8_weight_only_matmul(
        torch.from_numpy(x).to(tdt), torch.from_numpy(w_i8),
        torch.from_numpy(scale),
        None if b is None else torch.from_numpy(b).to(tdt))
    assert out.dtype == tdt
    return out


def _jax_args(x, w_i8, scale, b, dtype):
    _, jdt = DTYPES[dtype]
    return (jnp.asarray(x, jdt), jnp.asarray(w_i8), jnp.asarray(scale),
            None if b is None else jnp.asarray(b, jdt))


def _assert_close(got, ref, dtype):
    """f32: the JAX bench's tolerance; bf16: at most one ulp apart."""
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32),
                                   rtol=2e-5, atol=2e-4)
        return
    ref_t = torch.from_numpy(np.asarray(ref.astype(jnp.float32))).to(
        torch.bfloat16)
    bits = (got.view(torch.int16).int() - ref_t.view(torch.int16).int())
    same_sign = torch.sign(got.float()) * torch.sign(ref_t.float()) >= 0
    assert bool(same_sign.all())
    assert int(bits.abs().max()) <= 1, int(bits.abs().max())


# ------------------------------------------------------------------ (a)
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_pallas_kernel_interpret(dtype, with_bias):
    """The plain version against the Pallas kernel in interpret mode, at
    block-aligned shapes (two blocks in each of M, N, K)."""
    ops = _operands(0, 64, 256, 256, dtype, with_bias)
    ref = pm.int8_weight_only_matmul(*_jax_args(*ops, dtype), block_m=32,
                                     block_n=128, block_k=128,
                                     interpret=True)
    _assert_close(_port(*ops, dtype), ref, dtype)


# ------------------------------------------------------------------ (b)
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_xla_fallback_ragged(dtype, with_bias):
    """A ragged shape with two leading axes against the XLA lowering (the
    JAX package's path off the TPU), which scales the weight before the
    product."""
    ops = _operands(1, None, 37, 50, dtype, with_bias, lead=(3, 5))
    ref = pm.int8_weight_only_matmul(*_jax_args(*ops, dtype),
                                     interpret=False)
    got = _port(*ops, dtype)
    assert got.shape == (3, 5, 50)
    _assert_close(got, ref, dtype)


def test_plain_sums_before_scaling():
    """The plain version scales each column once after the f32 sum (the
    Pallas kernel's epilogue), and adds the bias before the one cast."""
    x = torch.tensor([[1.0, 3.0]])
    w = torch.tensor([[1, 2], [3, -4]], dtype=torch.int8)
    s = torch.tensor([127.0, 254.0])
    b = torch.tensor([0.5, -0.5])
    out = int8_weight_only_matmul_reference(x, w, s, b)
    assert out.tolist() == [[10.5, -20.5]]
    assert torch.equal(int8_weight_only_matmul_reference(x, w, s, quant_bits=4),
                       torch.tensor([[10.0, -10.0]]) * (s / 7))


# ------------------------------------------------------------------ (c)
def _jax_tiny():
    paddle.seed(0)
    return JaxGPT(jax_tiny(use_scan=False))


def _port_twin(jm, dtype=torch.float32):
    tm = GPTForCausalLM(gpt_tiny(), device="cpu")
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm.load_state_dict(gpt_state_from_reference(state))
    return tm.to(dtype)


PROJ = ("attn.qkv", "attn.out_proj", "mlp.up", "mlp.down")


@pytest.mark.parametrize("mode", ["blocks_and_head", "root"])
@pytest.mark.parametrize("bits", [8, 4])
def test_payloads_bitwise_equal_jax(bits, mode):
    jm = _jax_tiny()
    tm = _port_twin(jm)
    if mode == "root":
        jax_quantize(jm, quant_bits=bits, include_lm_head=True)
        weight_only_quantize(tm, quant_bits=bits, include_lm_head=True)
    else:
        for jb, tb in zip(jm.gpt.h, tm.gpt.h):
            jax_quantize(jb, quant_bits=bits)
            weight_only_quantize(tb, quant_bits=bits)
        jax_quantize_head(jm, quant_bits=bits)
        quantize_lm_head(tm, quant_bits=bits)
    pairs = [(jm._wo_head, tm._wo_head)]
    for jb, tb in zip(jm.gpt.h, tm.gpt.h):
        for path in PROJ:
            pairs.append((_get(jb, path), tb.get_submodule(path)))
    for jmod, tmod in pairs:
        assert isinstance(tmod, (WeightOnlyLinear, WeightOnlyLMHead))
        assert tmod.quant_bits == bits
        j_w = np.asarray(jmod.weight_int8.numpy())
        assert tmod.weight_int8.dtype == torch.int8
        assert torch.equal(tmod.weight_int8, torch.from_numpy(j_w))
        assert torch.equal(tmod.w_scale,
                           torch.from_numpy(np.asarray(jmod.w_scale.numpy())))
        if isinstance(tmod, WeightOnlyLinear):
            assert torch.equal(tmod.bias,
                               torch.from_numpy(np.asarray(jmod.bias.numpy())))
    # the embedding lookup keeps its fp table
    assert isinstance(tm.gpt.wte, torch.nn.Embedding)


def _get(layer, path):
    for part in path.split("."):
        layer = getattr(layer, part)
    return layer


def test_observer_matches_jax():
    """One observation, then frozen: later inputs leave the scales as
    they were; a second observation before the freeze takes the JAX
    observer's moving average."""
    rs = np.random.RandomState(3)
    a, c = (rs.randn(8, 6).astype(np.float32) for _ in range(2))
    jo = JaxObserver(quant_axis=1, channels=6)
    to = ChannelWiseAbsMaxObserver(quant_axis=1)
    assert torch.equal(to.scale(), torch.ones(()))
    jo(Tensor(jnp.asarray(a)))
    to(torch.from_numpy(a))
    jo.freeze()
    to.freeze()
    jo(Tensor(jnp.asarray(c * 10)))
    to(torch.from_numpy(c * 10))
    assert torch.equal(to.scale(), torch.from_numpy(np.asarray(jo.scale())))
    fresh = ChannelWiseAbsMaxObserver(quant_axis=1)
    jfresh = JaxObserver(quant_axis=1, channels=6)
    for arr in (a, c):
        fresh(torch.from_numpy(arr))
        jfresh(Tensor(jnp.asarray(arr)))
    assert torch.equal(fresh.scale(),
                       torch.from_numpy(np.asarray(jfresh.scale())))


def test_channelwise_primitives_match_jax():
    rs = np.random.RandomState(4)
    w = rs.randn(40, 24).astype(np.float32)
    w[:, 3] = 0.0                                   # a zero channel
    for axis in (0, 1):
        assert torch.equal(channel_absmax(torch.from_numpy(w), axis),
                           torch.from_numpy(np.asarray(
                               pm.channel_absmax(jnp.asarray(w), axis))))
    for bits in (8, 4):
        q, s = quantize_channelwise(torch.from_numpy(w), bits, axis=1)
        jq, js = pm.quantize_channelwise(jnp.asarray(w), bits, axis=1)
        assert torch.equal(q, torch.from_numpy(np.asarray(jq)))
        assert torch.equal(s, torch.from_numpy(np.asarray(js)))
    x = rs.randn(5, 40).astype(np.float32)
    np.testing.assert_allclose(
        weight_quant_error_bound(torch.from_numpy(x), s, 4).numpy(),
        np.asarray(pm.weight_quant_error_bound(jnp.asarray(x), js, 4)),
        rtol=1e-6)


# ------------------------------------------------------------------ (d)
def test_error_bound_holds_and_is_not_vacuous():
    """The bench's gate: the weight-only product stays within the
    analytic bound of x @ W (f64), and a 4-bit payload of the same weight
    breaks the 8-bit bound somewhere."""
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(64, 512).astype(np.float32))
    w = torch.from_numpy(rs.randn(512, 256).astype(np.float32))
    exact = x.double() @ w.double()
    w8, s8 = quantize_channelwise(w, 8)
    y8 = int8_weight_only_matmul(x, w8, s8)
    bound = weight_quant_error_bound(x, s8).double()
    err = (y8.double() - exact).abs()
    assert bool((err <= bound + 1e-4 * y8.double().abs()).all())
    w4, s4 = quantize_channelwise(w, 4)
    err4 = (int8_weight_only_matmul(x, w4, s4, quant_bits=4).double()
            - exact).abs()
    assert bool((err4 > bound).any())
    assert float(bound.max()) < float(exact.abs().max())


# ------------------------------------------------------------------ (e)
def test_wrapper_rejects_bad_operands():
    x = torch.randn(2, 8)
    w, s = quantize_channelwise(torch.randn(8, 4))
    with pytest.raises(ValueError, match="float32"):
        int8_weight_only_matmul(x, w, s.to(torch.bfloat16))
    with pytest.raises(ValueError, match="K = 8"):
        int8_weight_only_matmul(torch.randn(2, 7), w, s)
    with pytest.raises(ValueError, match=r"\[4\]"):
        int8_weight_only_matmul(x, w, s[:3])
    with pytest.raises(ValueError, match="bias"):
        int8_weight_only_matmul(x, w, s, bias=torch.zeros(5))
    with pytest.raises(ValueError, match="int8"):
        int8_weight_only_matmul(x, w.float(), s)
    with pytest.raises(ValueError, match="quant_bits"):
        int8_weight_only_matmul(x, w, s, quant_bits=9)
    with pytest.raises(ValueError, match="unsupported device"):
        int8_weight_only_matmul(x.to("meta"), w.to("meta"), s.to("meta"))


def test_cast_after_quantizing_raises():
    """``module.to(bf16)`` turns the f32 scale buffer to bf16: the layer
    raises instead of mis-scaling."""
    layer = torch.nn.Linear(8, 4)
    holder = torch.nn.Sequential(layer)
    weight_only_quantize(holder)
    holder.to(torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        holder(torch.randn(2, 8, dtype=torch.bfloat16))


def test_stacked_blocks_are_refused():
    m = GPTForCausalLM(gpt_tiny(stacked_blocks=True), device="cpu")
    with pytest.raises(ValueError, match="stacked"):
        weight_only_quantize(m)
    with pytest.raises(ValueError, match="stacked"):
        ServingEngine(m, EngineConfig(weight_only_int8=True), device="cpu")


@pytest.mark.parametrize("K,N", [(2048, 6144), (2048, 2048), (2048, 8192),
                                 (8192, 2048), (2048, 50304), (200, 333)])
@pytest.mark.parametrize("M,resident", [(1, 396), (8, 132)])
def test_decode_k_split_covers_k_in_one_wave(M, resident, K, N):
    """The f32 decode kernel's K splits (``tf32_k_split``): whole 128-row
    runs that cover K once, at most 16 (a column tile's splits are one
    cluster), and within one wave: the column tiles times the splits stay
    within three quarters of the resident blocks, or one split takes them
    all; more than 8 splits only where each keeps 512 rows."""
    per, splits = qm.tf32_k_split(M, K, N, resident)
    assert per % 128 == 0 and per * splits >= K > per * (splits - 1)
    assert 1 <= splits <= 16 and (splits <= 8 or per >= 512)
    tiles = -(-N // 128)
    assert splits == 1 or tiles * splits <= 3 * resident // 4
    assert qm.tf32_k_split(M, K, N, resident) == (per, splits)


# ------------------------------------------------------------------ (f)
ENGINE_KW = dict(block_size=8, num_blocks=32, max_batch=4,
                 prefill_budget_tokens=64, max_model_len=64)


def _drain(eng, max_steps=300):
    steps = 0
    while not eng.idle() and steps < max_steps:
        eng.tick(now=float(steps))
        steps += 1
    assert eng.idle(), "engine did not drain"


@pytest.mark.parametrize("int8,head", [(True, True), (True, False),
                                       (False, True)])
def test_int8_engine_matches_jax_engine_and_generate(int8, head):
    """Token for token: the port's int8 engine == the JAX int8 engine ==
    the port's dense greedy generate of the quantized model, from the
    same gpt_tiny weights; both engines quantize their model in place."""
    jm = _jax_tiny()
    tm = _port_twin(jm)
    opts = dict(weight_only_int8=int8, weight_only_lm_head=head)
    eng = ServingEngine(tm, EngineConfig(**ENGINE_KW, **opts), device="cpu")
    jeng = JaxEngine(jm, config=JaxEngineConfig(**ENGINE_KW, **opts))
    assert isinstance(tm.gpt.h[0].mlp.up,
                      WeightOnlyLinear if int8 else torch.nn.Linear)
    assert ("_wo_head" in tm._modules) == head
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, size=n).tolist() for n in (12, 5, 20)]
    rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    jrids = [jeng.submit(p, max_new_tokens=6) for p in prompts]
    _drain(eng)
    _drain(jeng)
    for p, r, jr in zip(prompts, rids, jrids):
        got = eng.sequence(r).generated
        assert got == jeng.sequence(jr).generated
        dense = tm.generate(np.asarray([p]), max_new_tokens=6)
        assert got == dense[0, len(p):].tolist()


def test_int8_engine_bf16_serves():
    """bf16 model (cast, then quantized by the engine) + bf16 KV: the
    engine agrees with the quantized model's bf16 generate on the first
    token."""
    tm = _port_twin(_jax_tiny(), torch.bfloat16)
    eng = ServingEngine(tm, EngineConfig(**ENGINE_KW, kv_dtype="bfloat16",
                                         weight_only_int8=True,
                                         weight_only_lm_head=True),
                        device="cpu")
    assert tm.gpt.h[1].attn.qkv.bias.dtype == torch.bfloat16
    assert tm._wo_head.w_scale.dtype == torch.float32
    p = np.random.default_rng(7).integers(0, 128, size=11).tolist()
    rid = eng.submit(p, max_new_tokens=4)
    _drain(eng)
    gen = eng.sequence(rid).generated
    dense = tm.generate(np.asarray([p]), max_new_tokens=4)
    assert gen[0] == int(dense[0, len(p)])


def test_head_prefers_the_installed_payload():
    tm = GPTForCausalLM(gpt_tiny(), device="cpu")
    h = torch.randn(3, tm.cfg.hidden_size)
    fp = tm._head(h)
    quantize_lm_head(tm)
    q = tm._head(h)
    assert not torch.equal(q, fp)
    w8, s8 = tm._wo_head.weight_int8, tm._wo_head.w_scale
    assert torch.equal(q, int8_weight_only_matmul_reference(h, w8, s8))
    bound = weight_quant_error_bound(h, s8)
    assert bool(((q - fp).abs() <= bound + 1e-5).all())


def test_untied_head_is_read_as_a_head():
    cfg = gpt_tiny(tie_word_embeddings=False)
    tm = GPTForCausalLM(cfg, device="cpu")
    weight_only_quantize(tm, include_lm_head=True)
    assert isinstance(tm.lm_head, torch.nn.Linear)          # left in place
    assert torch.equal(tm._wo_head.weight_int8,
                       quantize_channelwise(tm.lm_head.weight.t())[0])


# ------------------------------------------------------------------ (g)
@pytest.mark.parametrize("bits", [8, 4])
def test_convert_carries_a_quantized_jax_model(bits):
    """The quantized JAX state loads into a port model whose logits match
    the JAX model's at the f32 tolerance of the GPT tests (atol 1e-4)."""
    jm = _jax_tiny()
    jax_quantize(jm, quant_bits=bits, include_lm_head=True)
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = load_weight_only_reference(
        GPTForCausalLM(gpt_tiny(), device="cpu", seed=5), state,
        quant_bits=bits)
    assert torch.equal(tm.gpt.h[0].attn.qkv.weight_int8,
                       torch.from_numpy(state["gpt.h.0.attn.qkv.weight_int8"]))
    ids = np.random.default_rng(2).integers(0, 128, (2, 24)).astype(np.int32)
    ref = np.asarray(jm(Tensor(ids)).numpy())
    with torch.no_grad():
        out = tm(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
