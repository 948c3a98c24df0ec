"""The port's GPT (paddle2_tpu_torch.models) held against the JAX
package's GPT with the same weights, carried across as numpy by
gpt_state_from_reference. CPU, f32; logits at atol 1e-4 (the two
frameworks sum in different orders; tokens from greedy decoding must
be equal)."""

import numpy as np
import pytest
import torch

import paddle2_tpu as paddle
from paddle2_tpu.framework.tensor import Tensor
from paddle2_tpu.models.gpt import GPTConfig as JaxConfig
from paddle2_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle2_tpu.models.gpt import gpt_tiny as jax_tiny
from paddle2_tpu_torch.models import (GPTConfig, GPTForCausalLM, gpt3_1p3b,
                                      gpt_state_from_reference, gpt_tiny)

ATOL = 1e-4

# gpt_tiny has head_dim 16; the narrow twin has the 1.3B model's 128
CONFIGS = {
    "tiny": (lambda: jax_tiny(use_scan=False), gpt_tiny),
    "d128": (lambda: JaxConfig(vocab_size=128, hidden_size=256,
                               num_layers=2, num_heads=2,
                               max_position_embeddings=64, use_scan=False),
             lambda: GPTConfig(vocab_size=128, hidden_size=256,
                               num_layers=2, num_heads=2,
                               max_position_embeddings=64)),
}


def _pair(name):
    jcfg, tcfg = CONFIGS[name]
    paddle.seed(0)
    jm = JaxGPT(jcfg())
    jm.eval()
    tm = GPTForCausalLM(tcfg(), device="cpu", seed=1)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm.load_state_dict(gpt_state_from_reference(state))
    return jm, tm


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    return _pair(request.param)


def _ids(seed, vocab, b, s):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)) \
        .astype(np.int32)


def test_full_forward_logits(pair):
    jm, tm = pair
    ids = _ids(0, jm.cfg.vocab_size, 2, 24)
    ref = np.asarray(jm(Tensor(ids)).numpy())
    with torch.no_grad():
        out = tm(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_decode_step_caches_and_hidden(pair):
    jm, tm = pair
    L = jm.cfg.num_layers
    ids = _ids(1, jm.cfg.vocab_size, 1, 12)
    nxt = _ids(2, jm.cfg.vocab_size, 1, 1)
    jh, jc = jm.gpt.decode_step(Tensor(ids), [() for _ in range(L)], 0)
    jh2, jc2 = jm.gpt.decode_step(Tensor(nxt), jc, 12)
    with torch.no_grad():
        th, tc = tm.gpt.decode_step(torch.from_numpy(ids).long(),
                                    [() for _ in range(L)], 0)
        th2, tc2 = tm.gpt.decode_step(torch.from_numpy(nxt).long(), tc, 12)
    for j, t in ((jh, th), (jh2, th2)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j.numpy()),
                                   atol=ATOL, rtol=0)
    for jl, tl in zip(jc2, tc2):
        assert tl[0].shape == (1, 13, jm.cfg.num_heads, jm.cfg.head_dim)
        for ja, ta in zip(jl, tl):
            np.testing.assert_allclose(ta.numpy(), np.asarray(ja.numpy()),
                                       atol=ATOL, rtol=0)


def test_greedy_generate_tokens_equal(pair):
    jm, tm = pair
    prompt = _ids(3, jm.cfg.vocab_size, 2, 10)
    ref = np.asarray(jm.generate(prompt, max_new_tokens=8,
                                 temperature=0.0).numpy())
    out = tm.generate(prompt, max_new_tokens=8).numpy()
    assert out.shape == (2, 18)
    np.testing.assert_array_equal(out, ref)


def test_weight_layout_is_torch_out_in():
    jm, tm = _pair("tiny")
    w = np.asarray(jm.gpt.h[0].attn.qkv.weight.numpy())     # [in, out]
    assert tuple(tm.gpt.h[0].attn.qkv.weight.shape) == w.T.shape
    np.testing.assert_array_equal(
        tm.gpt.h[0].attn.qkv.weight.detach().numpy(), w.T)


def test_initialisation_distributions():
    cfg = gpt_tiny(num_layers=4)
    m = GPTForCausalLM(cfg, device="cpu", seed=5)
    again = GPTForCausalLM(cfg, device="cpu", seed=5)
    for a, b in zip(m.parameters(), again.parameters()):
        assert torch.equal(a, b)                  # seeded, reproducible
    qkv = m.gpt.h[0].attn.qkv.weight
    out = m.gpt.h[0].attn.out_proj.weight
    assert abs(qkv.std().item() - 0.02) < 0.004
    assert abs(out.std().item() - 0.02 / np.sqrt(8)) < 0.002
    assert torch.all(m.gpt.h[0].attn.qkv.bias == 0)
    assert torch.all(m.gpt.ln_f.weight == 1)


def test_device_defaults_to_cuda(monkeypatch):
    """No device argument means cuda; without a GPU that raises rather
    than falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GPTForCausalLM(gpt_tiny())


def test_flagship_geometry():
    cfg = gpt3_1p3b()
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.head_dim,
            cfg.vocab_size, cfg.max_position_embeddings) == \
        (2048, 24, 16, 128, 50304, 2048)
