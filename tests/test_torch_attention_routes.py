"""The port's attention routes (``kernels/attention.py``'s
``scaled_dot_product_attention`` and the packed varlen wrapper) held
against the JAX package on the same numpy inputs, on the CPU.

Where the CUDA flash kernels do not take a shape (a head dim outside 16,
64 and 128, float16, more queries than keys), the port computes on the
CPU as the JAX package does there (its XLA softmax, ``_sdpa_xla``); on
the card it raises, naming the ROADMAP item that ports it. A stand-in
"card" (the routers told their tensors are on it, the built libraries
replaced by a recorder) shows the raise, and that a misaligned bf16
packed view reaches the varlen kernel as an aligned copy.

Tolerances: f32 1e-5 (the two frameworks sum in other orders); f16 1e-2
(scores and probabilities rounded to f16 at the same places, sums in
another order)."""

import contextlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle2_tpu as paddle
from paddle2_tpu.framework.tensor import Tensor
from paddle2_tpu.kernels import attention as jattn
from paddle2_tpu.kernels import pallas_flash
from paddle2_tpu.models.gpt import GPTConfig as JaxConfig
from paddle2_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle2_tpu_torch.kernels import _build, attention, flash_attn
from paddle2_tpu_torch.kernels import flash_varlen as fv
from paddle2_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                      gpt_state_from_reference)

# name -> (Sq, Sk, D, dtype): outside the CUDA kernels' set, each inside
# what the JAX package computes
CASES = {
    "d32": (8, 8, 32, np.float32),
    "d96": (8, 8, 96, np.float32),
    "f16_d64": (8, 8, 64, np.float16),
    "sq9_sk8": (9, 8, 16, np.float32),
    "sq16_sk8": (16, 8, 16, np.float32),
}
TOL = {np.float32: 1e-5, np.float16: 1e-2}
TDT = {np.float32: torch.float32, np.float16: torch.float16}


def _qkv(seed, Sq, Sk, D, dtype, B=1, H=2):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, Sq, H, D).astype(dtype)
    k, v = (rs.randn(B, Sk, H, D).astype(dtype) for _ in range(2))
    return q, k, v


def _port(q, k, v, causal):
    out = attention.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), is_causal=causal)
    assert out.dtype == TDT[q.dtype.type]
    return out.float().numpy()


def _jax(q, k, v, causal):
    out = jattn.scaled_dot_product_attention(
        *(Tensor(jnp.asarray(a)) for a in (q, k, v)), is_causal=causal)
    return np.asarray(out.numpy(), np.float32)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sdpa_outside_the_kernels_matches_jax_on_the_cpu(case, causal):
    """The port's CPU route against the JAX function (XLA on the CPU) on
    shapes the CUDA kernels do not take; no flash kernel's plain
    version runs. float16 (``f16_d64``), which the kernels take since
    their float16 instantiation, goes through the flash route's plain
    version and matches the same way."""
    Sq, Sk, D, dtype = CASES[case]
    q, k, v = _qkv(3, Sq, Sk, D, dtype)
    if case == "d32":
        k, v = q, q                      # the queue item's q = k = v
    ran = []
    with pytest.MonkeyPatch.context() as mp:
        plain = flash_attn.flash_fwd_reference
        mp.setattr(flash_attn, "flash_fwd_reference",
                   lambda *a: ran.append(1) or plain(*a)
                   if case == "f16_d64"
                   else pytest.fail("the flash route ran"))
        got = _port(q, k, v, causal)
    assert bool(ran) == (case == "f16_d64")
    np.testing.assert_allclose(got, _jax(q, k, v, causal),
                               atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("Sq", [9, 16])
def test_sdpa_more_queries_than_keys_against_the_pallas_kernel(Sq, causal):
    """``Sq > Sk`` against ``pallas_flash.flash_attention_bshd(...,
    interpret=True)`` (at Sq 9 its ``supported()`` refuses the tiling
    and it takes XLA; at Sq 16 the Pallas kernel runs). Rows that see a
    key agree. Under the bottom-right causal mask the first ``Sq - Sk``
    rows see no key: there the port gives what the JAX package's XLA
    route gives on the CPU, the mean of v (a softmax over equal masked
    scores), and the Pallas kernel gives 0."""
    Sk = 8
    q, k, v = _qkv(5, Sq, Sk, 16, np.float32)
    got = _port(q, k, v, causal)
    pallas = np.asarray(pallas_flash.flash_attention_bshd(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal,
        interpret=True))
    blind = Sq - Sk if causal else 0
    np.testing.assert_allclose(got[:, blind:], pallas[:, blind:],
                               atol=1e-5, rtol=0)
    if blind and pallas_flash.supported(q.shape, k.shape):
        assert not pallas[:, :blind].any()
        np.testing.assert_allclose(
            got[:, :blind], np.broadcast_to(v.mean(1, keepdims=True),
                                            got[:, :blind].shape),
            atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, _jax(q, k, v, causal), atol=1e-5,
                               rtol=0)


def test_pallas_supported_is_the_jax_arithmetic():
    for Sq, Sk, H, Hk, D in [(8, 8, 2, 2, 256), (8, 8, 2, 2, 272),
                             (12, 16, 2, 2, 64), (16, 12, 2, 2, 64),
                             (1, 9, 2, 2, 64), (2048, 1024, 4, 4, 128),
                             (24, 24, 4, 2, 64), (0, 8, 2, 2, 16)]:
        q_shape, k_shape = (1, Sq, H, D), (1, Sk, Hk, D)
        want = Sq > 0 and pallas_flash.supported(q_shape, k_shape)
        assert attention.pallas_supported(q_shape, k_shape) == want, \
            (Sq, Sk, H, Hk, D)


def test_sdpa_shapes_the_pallas_kernel_refuses_take_the_plain_route():
    """A head dim over 256 or a length with no 8-row tiling takes the
    plain route on either device (the stand-in card too), as the JAX
    package takes XLA."""
    for Sq, D in ((8, 272), (12, 64)):
        q, k, v = _qkv(7, Sq, Sq, D, np.float32)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(_build, "on_cuda", lambda t: True)
            mp.setattr(_build, "on_card", lambda what, *t: True)
            mp.setattr(flash_attn, "flash_fwd_reference",
                       lambda *a: pytest.fail("the flash route ran"))
            got = _port(q, k, v, True)
        np.testing.assert_allclose(got, _jax(q, k, v, True), atol=1e-5,
                                   rtol=0)


def test_gpt_with_head_dim_32_matches_jax_on_the_cpu():
    """GPT at hidden 256 with 8 heads (head dim 32, outside the CUDA
    kernels' set) runs a forward on the CPU and matches the JAX model's
    logits at the GPT tests' atol."""
    kw = dict(vocab_size=128, hidden_size=256, num_layers=2, num_heads=8,
              max_position_embeddings=64)
    paddle.seed(0)
    jm = JaxGPT(JaxConfig(use_scan=False, **kw))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**kw), device="cpu", seed=1)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm.load_state_dict(gpt_state_from_reference(state))
    ids = np.random.default_rng(0).integers(0, 128, size=(2, 24)) \
        .astype(np.int32)
    ref = np.asarray(jm(Tensor(ids)).numpy())
    with torch.no_grad():
        out = tm(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


@pytest.fixture
def card(monkeypatch):
    """The routers and wrappers told their tensors are on the card, the
    built libraries replaced by a recorder of (library, entry,
    arguments), and the plain versions failing if they run."""
    calls = []

    class StandIn:
        def __init__(self, name):
            self.name = name

        def __getattr__(self, entry):
            return lambda *args: calls.append((self.name, entry, args)) or 0
    monkeypatch.setattr(_build, "on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "on_card", lambda what, *t: True)
    monkeypatch.setattr(_build, "library", lambda name, sigs: StandIn(name))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=None))
    for mod, name in ((flash_attn, "flash_fwd_reference"),
                      (fv, "flash_varlen_fwd_reference")):
        monkeypatch.setattr(mod, name, lambda *a: pytest.fail("plain ran"))
    return calls


@pytest.mark.parametrize("case,item", [("d32", "A1"), ("d96", "A1"),
                                       ("f16_d64", "A2"),
                                       ("sq16_sk8", "A1")])
def test_sdpa_outside_the_kernels_raises_on_the_card(card, case, item):
    """On the card a shape the JAX package sends to its kernel and the
    port's kernels do not take raises, naming its queue item; nothing
    is launched and the plain route does not run. float16 (``f16_d64``,
    queue 2 A2, now done) reaches the tensor-core forward's C entry with
    dtype code 2."""
    Sq, Sk, D, dtype = CASES[case]
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, Sq, Sk, D, dtype))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention, "_sdpa_plain",
                   lambda *a, **kw: pytest.fail("the plain route ran"))
        if item == "A2":
            attention.scaled_dot_product_attention(q, k, v, is_causal=True)
            (lib, entry, args), = card
            assert (lib, entry) == ("flash_fwd_wgmma", "flash_fwd_wgmma")
            assert args[10] == 2
            return
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP.md queue 2 {item}"):
            attention.scaled_dot_product_attention(q, k, v, is_causal=True)
    assert card == []


def test_a_misaligned_bf16_packed_view_launches_on_an_aligned_copy(card):
    """``flash_attention_varlen_packed`` copies a bf16 view that starts
    off a 16-byte boundary before the launch (the kernel wrapper would
    raise on it): the forward reaches the tensor-core entry once, with
    aligned pointers that are not the view's."""
    T, H, D = 10, 2, 16
    n = T * H * D
    buf = torch.zeros(3 * n + 1, dtype=torch.bfloat16)
    q, k, v = (buf[1 + i * n:1 + (i + 1) * n].view(T, H, D)
               for i in range(3))
    assert q.is_contiguous() and q.data_ptr() % 16
    seg = torch.tensor([0] * 4 + [1] * 6, dtype=torch.int32)
    off = torch.tensor(list(range(4)) + list(range(6)), dtype=torch.int32)
    before = fv.flash_varlen_fwd.launches
    fv.flash_attention_varlen_packed(q, k, v, seg, off, seg, off)
    assert fv.flash_varlen_fwd.launches == before + 1
    (lib, entry, args), = card
    assert (lib, entry) == ("flash_varlen_wgmma", "flash_varlen_fwd_wgmma")
    ptrs = args[:3]
    assert all(p % 16 == 0 for p in ptrs)
    assert not set(ptrs) & {q.data_ptr(), k.data_ptr(), v.data_ptr()}
