"""Training with the port (paddle2_tpu_torch): the GPT loss and every
parameter gradient, and five ``jit.train_step`` losses, held against the
JAX package's GPT on gpt_tiny with the same weights (carried across as
numpy by gpt_state_from_reference) and the same token ids, on the CPU
(the kernels' plain versions).

Storage (per-block or stacked ``[L, ...]`` leaves), remat ("none",
"dots", "full") and the head (logits + cross-entropy, or the chunked
fused head) are crossed. The JAX model with stacked blocks trains only
under jit (paddle2_tpu/models/_scan.py:25-58), so its gradients come
from ``jit.to_static`` + ``backward`` and its steps from
``jit.train_step``.

Tolerances: the loss to 1e-4 relative in f32 and 2e-2 under AMP O2
bf16; each gradient to 1e-4 (f32) or 2e-2 (bf16) of its largest
magnitude (the two frameworks sum in different orders; under O2 both
round activations to bf16, at different places: the port's attention
rounds probabilities the flash way, the JAX model's short-sequence
attention is an XLA softmax).
"""

import numpy as np
import pytest
import torch

import paddle2_tpu as paddle
import paddle2_tpu.optimizer as jopt
from paddle2_tpu.framework.tensor import Tensor
from paddle2_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle2_tpu.models.gpt import gpt_tiny as jax_tiny
from paddle2_tpu.nn import functional as JF
from paddle2_tpu_torch import amp, jit
from paddle2_tpu_torch.kernels import flash_attn
from paddle2_tpu_torch.models import (GPTForCausalLM, gpt_state_from_reference,
                                      gpt_tiny)
from paddle2_tpu_torch.nn import LayerNorm
from paddle2_tpu_torch.optimizer import AdamW
from paddle2_tpu_torch.serving import EngineConfig, ServingEngine

TOL = {False: 1e-4, True: 2e-2}          # keyed by bf16
B, S = 2, 16


def _cfg(stacked, remat, fused_head):
    return dict(stacked_blocks=stacked, use_recompute=remat != "none",
                recompute_granularity="full" if remat == "none" else remat,
                fused_head_loss=fused_head)


def _pair(stacked, remat, fused_head, bf16):
    """The JAX model and the port's with the same f32 weights, both
    decorated for AMP O2 when ``bf16``."""
    paddle.seed(0)
    jm = JaxGPT(jax_tiny(**_cfg(stacked, remat, fused_head)))
    tm = GPTForCausalLM(gpt_tiny(**_cfg(stacked, remat, fused_head)),
                        device="cpu", seed=1)
    state = {k: np.asarray(v.numpy(), np.float32)
             for k, v in jm.state_dict().items()}
    tm.load_state_dict(gpt_state_from_reference(state))
    if bf16:
        jm = paddle.amp.decorate(jm, level="O2", dtype="bfloat16")
        tm = amp.decorate(tm, level="O2", dtype="bfloat16")
    return jm, tm


def _batch(seed, vocab):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    labels[0, :3] = -100                 # ignored tokens
    return ids, labels


def _t(a):
    return torch.from_numpy(a).long()


def _jax_loss_fn(jm):
    return lambda ids, labels: jm(ids, labels=labels)[1]


def _near(got, want, tol):
    got = np.asarray(got, np.float32)
    scale = max(float(np.abs(want).max()), 1e-12)
    assert np.abs(got - want).max() <= tol * scale


GRID = [(st, rm, fh) for st in (False, True)
        for rm in ("none", "dots", "full") for fh in (False, True)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16_O2"])
@pytest.mark.parametrize("stacked,remat,fused_head", GRID,
                         ids=[f"{'stacked' if st else 'blocks'}-{rm}-"
                              f"{'fusedhead' if fh else 'logits'}"
                              for st, rm, fh in GRID])
def test_loss_and_grads_match_jax(stacked, remat, fused_head, bf16):
    jm, tm = _pair(stacked, remat, fused_head, bf16)
    assert tm.training
    ids, labels = _batch(3, jm.cfg.vocab_size)
    jloss = paddle.jit.to_static(_jax_loss_fn(jm))(Tensor(ids),
                                                   Tensor(labels))
    jloss.backward()
    jgrads = gpt_state_from_reference(
        {n: np.asarray(p.grad.numpy(), np.float32)
         for n, p in jm.named_parameters()})
    logits, loss = tm(_t(ids), labels=_t(labels))
    assert (logits is None) == fused_head
    loss.backward()
    tol = TOL[bf16]
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=tol)
    tgrads = dict(tm.named_parameters())
    assert set(tgrads) == set(jgrads)
    for name, want in jgrads.items():
        p = tgrads[name]
        assert p.grad is not None and p.grad.dtype == p.dtype, name
        _near(p.grad.float().numpy(), want.numpy(), tol)


@pytest.mark.parametrize("stacked,bf16", [(True, True), (True, False),
                                          (False, True)],
                         ids=["stacked-bf16_O2", "stacked-f32",
                              "blocks-bf16_O2"])
def test_five_train_steps_track_jax(stacked, bf16):
    """bench.py's configuration at gpt_tiny size: "dots" remat, fused
    head, AdamW with multi-precision masters and the fused step, through
    ``jit.train_step`` on both sides."""
    jm, tm = _pair(stacked, "dots", True, bf16)
    jo = jopt.AdamW(learning_rate=1e-2, parameters=jm.parameters(),
                    multi_precision=True, fused=True)
    to = AdamW(learning_rate=1e-2, parameters=tm.parameters(),
               multi_precision=True, fused=True)
    jstep = paddle.jit.train_step(_jax_loss_fn(jm), jo)
    tstep = jit.train_step(lambda ids, labels: tm(ids, labels=labels)[1],
                           to)
    jl, tl = [], []
    for i in range(5):
        ids, labels = _batch(10 + i % 2, jm.cfg.vocab_size)
        jl.append(float(jstep(Tensor(ids), Tensor(labels))))
        tl.append(float(tstep(_t(ids), _t(labels))))
    np.testing.assert_allclose(tl, jl, rtol=TOL[bf16])
    assert tl[-1] < tl[0]
    assert to._step_count == 5
    if bf16:
        p = tm.gpt.wte.weight
        assert p.dtype == torch.bfloat16
        assert to._states[id(p)]["master"].dtype == torch.float32


@pytest.mark.parametrize("stacked", [False, True],
                         ids=["blocks", "stacked"])
@pytest.mark.parametrize("remat,per_layer", [("none", 1), ("dots", 1),
                                             ("full", 2)])
def test_dots_remat_runs_the_flash_forward_once(monkeypatch, stacked, remat,
                                                per_layer):
    """Under "dots" the flash op's (o, lse) are kept, so the backward
    does not run the forward again: one flash forward per layer per
    step, as without remat; "full" recomputes it."""
    calls = []
    plain = flash_attn.flash_fwd_reference

    def counting(*a, **k):
        calls.append(1)
        return plain(*a, **k)
    monkeypatch.setattr(flash_attn, "flash_fwd_reference", counting)
    cfg = gpt_tiny(**_cfg(stacked, remat, True))
    tm = GPTForCausalLM(cfg, device="cpu", seed=0)
    opt = AdamW(learning_rate=1e-3, parameters=tm.parameters())
    step = jit.train_step(lambda ids: tm(ids, labels=ids)[1], opt)
    ids = _t(_batch(0, cfg.vocab_size)[0])
    for _ in range(3):
        step(ids)
    assert len(calls) == 3 * per_layer * cfg.num_layers


def test_model_starts_in_training_mode_and_serves_the_same_tokens():
    """The port's model starts in training mode, as the JAX package's
    layers do; the engine and ``generate`` switch or need no mode, and
    give the same greedy tokens as a model put in eval mode first."""
    cfg = gpt_tiny(stacked_blocks=True, use_recompute=True,
                   recompute_granularity="dots")
    fresh = GPTForCausalLM(cfg, device="cpu", seed=3)
    assert fresh.training
    assert all(m.training for m in fresh.modules())
    evald = GPTForCausalLM(cfg, device="cpu", seed=3).eval()
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                               size=(1, 9))
    dense = fresh.generate(prompt, max_new_tokens=6)
    assert torch.equal(dense, evald.generate(prompt, max_new_tokens=6))
    eng = ServingEngine(fresh, EngineConfig(block_size=8, num_blocks=32,
                                            max_batch=2, max_model_len=64),
                        device="cpu")
    assert not fresh.training            # the engine put it in eval mode
    rid = eng.submit(prompt[0].tolist(), max_new_tokens=6)
    steps = 0
    while not eng.idle() and steps < 100:
        eng.tick(now=float(steps))
        steps += 1
    assert eng.sequence(rid).generated == dense[0, 9:].tolist()


@pytest.mark.parametrize("src_stacked", [False, True],
                         ids=["from_blocks", "from_stacked"])
@pytest.mark.parametrize("dst_stacked", [False, True],
                         ids=["to_blocks", "to_stacked"])
def test_converter_moves_between_storage_layouts(src_stacked, dst_stacked):
    """A JAX state dict, per-block or stacked, loads into a port model of
    either layout, and the two models compute the same logits."""
    paddle.seed(0)
    jm = JaxGPT(jax_tiny(stacked_blocks=src_stacked))
    jm.eval()
    tm = GPTForCausalLM(gpt_tiny(stacked_blocks=dst_stacked), device="cpu")
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm.load_state_dict(gpt_state_from_reference(state, stacked=dst_stacked))
    if dst_stacked:
        qkv = tm.gpt.h.stacked_leaf("attn.qkv.weight")
        assert tuple(qkv.shape) == (2, 192, 64)      # [L, out, in]
    ids = _batch(5, 128)[0]
    with torch.no_grad():
        got = tm.eval()(_t(ids)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm(Tensor(ids)).numpy()),
                               atol=1e-4, rtol=0)


def test_amp_o2_keeps_norm_parameters_f32():
    blocks = amp.decorate(GPTForCausalLM(gpt_tiny(), device="cpu"))
    for name, p in blocks.named_parameters():
        want = torch.float32 if ".ln_" in name else torch.bfloat16
        assert p.dtype == want, name
    # stacked LayerNorm leaves belong to the stack, not to a norm layer,
    # and are cast, as in the JAX package
    stacked = amp.decorate(GPTForCausalLM(gpt_tiny(stacked_blocks=True),
                                          device="cpu"))
    params = dict(stacked.named_parameters())
    assert params["gpt.h.stacked_ln_1__weight"].dtype == torch.bfloat16
    assert params["gpt.ln_f.weight"].dtype == torch.float32
    with pytest.raises(ValueError):
        amp.decorate(stacked, level="O3")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_numerics_match_jax(dtype):
    """Under O2 the input is bf16 and the scale and shift stay f32: the
    JAX package normalises in bf16, applies them in f32 and casts back.
    In pure f32 the port's LayerNorm is ``F.layer_norm`` (the serving
    path's numbers do not change)."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 32)) * 3 + 1).astype(np.float32)
    w = rng.normal(size=32).astype(np.float32)
    b = rng.normal(size=32).astype(np.float32)
    want = JF.layer_norm(paddle.to_tensor(x).astype(dtype), 32,
                         weight=paddle.to_tensor(w),
                         bias=paddle.to_tensor(b), epsilon=1e-5)
    ln = LayerNorm(32, eps=1e-5)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(w))
        ln.bias.copy_(torch.from_numpy(b))
        got = ln(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.numpy(), np.float32),
                               rtol=TOL[dtype == "bfloat16"],
                               atol=TOL[dtype == "bfloat16"])
    if dtype == "float32":
        ref = torch.nn.functional.layer_norm(torch.from_numpy(x), (32,),
                                             ln.weight, ln.bias, 1e-5)
        assert torch.equal(got, ref)


def test_train_step_updates_unreached_parameters():
    """A parameter the loss does not reach gets an all-zeros gradient and
    is still updated (decay and moments apply), as in the JAX package;
    the eager ``optimizer.step()`` would skip it."""
    used = torch.nn.Parameter(torch.ones(3))
    unused = torch.nn.Parameter(torch.ones(3))
    opt = AdamW(learning_rate=1e-1, parameters=[used, unused],
                weight_decay=0.5)
    step = jit.train_step(lambda x: (used * x).sum(), opt)
    loss = step(torch.full((3,), 2.0))
    assert loss.item() == 6.0 and not loss.requires_grad
    assert torch.equal(unused.grad, torch.zeros(3))
    assert torch.all(unused < 1.0)            # decayed
    assert id(unused) in opt._states


def test_train_step_refuses_unported_options():
    opt = AdamW(learning_rate=1e-3, parameters=[torch.nn.Parameter(
        torch.ones(1))])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        jit.train_step(lambda: None, object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        jit.train_step(lambda: None, opt, reliability=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        jit.TrainStepProgram(lambda: None, opt, instrument=True)
    with pytest.raises(ValueError, match="layers"):
        jit.train_step(lambda: None, opt, layers=[])


def test_num_params_matches_jax():
    paddle.seed(0)
    jm = JaxGPT(jax_tiny(stacked_blocks=True))
    for stacked in (False, True):
        tm = GPTForCausalLM(gpt_tiny(stacked_blocks=stacked), device="cpu")
        assert tm.num_params() == jm.num_params()
