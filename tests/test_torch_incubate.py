"""The port's ``incubate.nn.functional`` and ``incubate.nn`` layers held
against the JAX package's: the module's names; every plain functional
against its JAX twin on the same numpy inputs, forward and the
gradient of every input; dropout by its statistics; the functions that
raise; and the four layers against the JAX layers on one shared numpy
state (the JAX state dict loads into the port's layer as it is).

The kernel routes (``fused_rms_norm``, ``fused_rotary_position_
embedding``, ``fused_adamw_kernel``) have their own files
(``test_torch_rms_norm.py``, ``test_torch_rope.py``,
``test_torch_adamw_flat.py``); the slice as a whole is
``test_torch_incubate_stack.py``.

Tolerance. Both sides compute in f32 in the same op order, and differ
only in the order of their sums (matmuls, means, softmax): every output
and gradient to 1e-5 of its largest magnitude.
"""

import numpy as np
import pytest
import torch

import paddle2_tpu as paddle
import paddle2_tpu.incubate.nn as jnn
from paddle2_tpu.incubate.nn import functional as JF
import paddle2_tpu_torch.incubate.nn as tnn
from paddle2_tpu_torch.incubate.nn import functional as TF

TOL = 1e-5


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    lim = TOL * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= lim, (what, err, lim)


def _run(ns, fn, arrays, dys, leaf, mul):
    leaves = [leaf(a) for a in arrays]
    out = fn(ns, *leaves)
    outs = out if isinstance(out, tuple) else (out,)
    sum(mul(o, d) for o, d in zip(outs, dys)).backward()
    return outs, leaves


def _check(fn, shapes, seed=0, n_out=1):
    """``fn(namespace, *leaves)`` on both sides from numpy inputs of
    ``shapes``: every output and every input's gradient of
    ``sum(out · dy)``."""
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=s).astype(np.float32) for s in shapes]
    with torch.no_grad():
        probe = fn(TF, *(torch.tensor(a) for a in arrays))
    probe = probe if isinstance(probe, tuple) else (probe,)
    assert len(probe) == n_out
    dys = [rng.normal(size=tuple(p.shape)).astype(np.float32)
           for p in probe]
    touts, tl = _run(TF, fn, arrays, dys,
                     lambda a: torch.tensor(a, requires_grad=True),
                     lambda o, d: (o * torch.from_numpy(d)).sum())
    jouts, jl = _run(JF, fn, arrays, dys,
                     lambda a: paddle.to_tensor(a, stop_gradient=False),
                     lambda o, d: (o * paddle.to_tensor(d)).sum())
    for i, (t, j) in enumerate(zip(touts, jouts)):
        _close(t.detach().numpy(), j.numpy(), f"out {i}")
    for i, (t, j) in enumerate(zip(tl, jl)):
        _close(_grad(t.grad, t.shape), _grad(j.grad, t.shape), f"grad {i}")


def _grad(g, shape):
    """A gradient as numpy; an input that does not reach the output
    (None on the torch side) as zeros."""
    return np.zeros(tuple(shape), np.float32) if g is None else g.numpy()


def test_the_module_has_the_jax_names_in_the_jax_order():
    assert TF.__all__ == JF.__all__
    assert all(callable(getattr(TF, n)) for n in TF.__all__)
    layers = ["FusedDropoutAdd", "FusedBiasDropoutResidualLayerNorm",
              "FusedFeedForward", "FusedMultiTransformer"]
    assert all(n in tnn.__all__ and hasattr(tnn, n) for n in layers)


def _mt_fn(ns, x, *p):
    """fused_multi_transformer over 2 layers whose 24 parameters are
    ``p``, 12 a layer in the per-kind lists' order."""
    lists = [[p[i + 12 * layer] for layer in range(2)] for i in range(12)]
    return ns.fused_multi_transformer(x, *lists, training=False)


_MT_SHAPES = [(8,), (8,), (3, 2, 4, 8), (3, 2, 4), (8, 8), (8,), (8,),
              (8,), (8, 16), (16,), (16, 8), (8,)]

CASES = {
    "swiglu_one_input": (lambda ns, x: ns.swiglu(x), [(2, 5, 16)]),
    "swiglu_two_inputs": (lambda ns, x, y: ns.swiglu(x, y),
                          [(2, 5, 8), (2, 5, 8)]),
    "matmul_bias": (lambda ns, x, y, b: ns.fused_matmul_bias(x, y, b),
                    [(3, 4, 8), (8, 6), (6,)]),
    "matmul_bias_transposed": (
        lambda ns, x, y: ns.fused_matmul_bias(x, y, None, True, True),
        [(3, 8, 4), (6, 8)]),
    "linear_transposed_weight": (
        lambda ns, x, w, b: ns.fused_linear(x, w, b, transpose_weight=True),
        [(3, 4, 8), (6, 8), (6,)]),
    **{f"linear_activation_{a}": (
        lambda ns, x, y, b, a=a: ns.fused_linear_activation(
            x, y, b, activation=a), [(4, 8), (8, 6), (6,)])
       for a in ("gelu", "relu", "none")},
    **{f"bias_act_{a}": (
        lambda ns, x, b, a=a: ns.fused_bias_act(x, b, act_method=a),
        [(4, 12), (12,)]) for a in ("gelu", "relu", "swiglu", "silu")},
    "dropout_add_p0": (
        lambda ns, x, y: ns.fused_dropout_add(x, y, p=0.0),
        [(2, 3, 8), (2, 3, 8)]),
    "dropout_add_eval": (
        lambda ns, x, y: ns.fused_dropout_add(x, y, p=0.5, training=False),
        [(2, 3, 8), (2, 3, 8)]),
    "layer_norm_from_axis_1": (
        lambda ns, x, w, b: ns.fused_layer_norm(x, w, b),
        [(3, 4, 8), (4, 8), (4, 8)]),
    "layer_norm_last_axis_bias": (
        lambda ns, x, w, b, c: ns.fused_layer_norm(
            x, w, b, begin_norm_axis=2, bias=c),
        [(3, 4, 8), (8,), (8,), (8,)]),
    "bias_dropout_residual_layer_norm": (
        lambda ns, x, r, b, s, c: ns.fused_bias_dropout_residual_layer_norm(
            x, r, b, s, c, dropout_rate=0.3, training=False),
        [(2, 3, 8), (2, 3, 8), (8,), (8,), (8,)]),
    **{f"feedforward_{'pre' if pre else 'post'}_ln": (
        lambda ns, x, w1, w2, b1, b2, s1, c1, s2, c2, pre=pre, act=act:
        ns.fused_feedforward(x, w1, w2, b1, b2, s1, c1, s2, c2,
                             activation=act, pre_layer_norm=pre,
                             training=False),
        [(2, 3, 8), (8, 16), (16, 8), (16,), (8,), (8,), (8,), (8,), (8,)])
       for pre, act in ((True, "gelu"), (False, "relu"))},
    **{f"multi_head_attention_{'pre' if pre else 'post'}_ln": (
        lambda ns, x, w, o, s, c, qb, ob, m, pre=pre:
        ns.fused_multi_head_attention(
            x, w, o, pre_layer_norm=pre, pre_ln_scale=s, pre_ln_bias=c,
            ln_scale=s, ln_bias=c, qkv_bias=qb, linear_bias=ob,
            attn_mask=m, training=False),
        [(2, 5, 8), (3, 2, 4, 8), (8, 8), (8,), (8,), (3, 2, 4), (8,),
         (2, 2, 5, 5)]) for pre in (True, False)},
    **{f"variable_length_attention_{'causal' if c else 'full'}": (
        lambda ns, q, k, v, c=c: ns.variable_length_memory_efficient_attention(
            q, k, v, _seq_lens(ns, [5, 3]), _seq_lens(ns, [4, 5]), causal=c),
        [(2, 2, 5, 4), (2, 2, 5, 4), (2, 2, 5, 4)]) for c in (True, False)},
    "multi_transformer": (_mt_fn, [(2, 5, 8)] + _MT_SHAPES * 2),
}


def _seq_lens(ns, lens):
    a = np.asarray(lens, np.int32)
    return torch.tensor(a) if ns is TF else paddle.to_tensor(a)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_functional_matches_jax(case):
    fn, shapes = CASES[case]
    _check(fn, shapes)


def test_layer_norm_with_a_residual_returns_the_pre_norm_sum():
    """With ``residual`` (scaled by ``residual_alpha``), a pair ``(out,
    x + bias + alpha·residual)``."""
    _check(lambda ns, x, w, b, c, r: ns.fused_layer_norm(
        x, w, b, residual_alpha=0.5, begin_norm_axis=2, bias=c,
        residual=r), [(3, 4, 8), (8,), (8,), (8,), (3, 4, 8)], n_out=2)


def test_gelu_is_the_tanh_form():
    x = torch.linspace(-3, 3, 61)
    got = TF.fused_bias_act(x, act_method="gelu")
    assert torch.allclose(got, torch.nn.functional.gelu(
        x, approximate="tanh"), rtol=0, atol=0)
    assert (got - torch.nn.functional.gelu(x)).abs().max() > 1e-4


def test_blha_get_max_len():
    enc, dec = TF.blha_get_max_len(torch.tensor([3, 9, 1]),
                                   torch.tensor([0, 2]), 3)
    jenc, jdec = JF.blha_get_max_len(paddle.to_tensor([3, 9, 1]),
                                     paddle.to_tensor([0, 2]), 3)
    assert enc.tolist() == jenc.numpy().tolist() == [9]
    assert dec.tolist() == jdec.numpy().tolist() == [2]
    assert enc.dtype == torch.int32


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_by_its_statistics(mode):
    """In training, ``fused_dropout_add`` drops a fraction p of x drawn
    from the generator (the same generator seed gives the same mask) and
    scales what it keeps by 1/(1-p) in "upscale_in_train" mode, not at
    all in "downscale_in_infer" (as the JAX package)."""
    x, y = torch.ones(400, 500), torch.full((400, 500), 2.0)
    gen = lambda: torch.Generator().manual_seed(5)
    out = TF.fused_dropout_add(x, y, p=0.3, mode=mode, generator=gen())
    kept = out != 2.0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    scale = 1 / 0.7 if mode == "upscale_in_train" else 1.0
    assert torch.allclose(out[kept], torch.tensor(2.0 + scale))
    again = TF.fused_dropout_add(x, y, p=0.3, mode=mode, generator=gen())
    assert torch.equal(out, again)
    ff = TF.fused_feedforward(
        torch.ones(64, 32, 16), torch.eye(16, 64), torch.eye(64, 16),
        dropout1_rate=0.25, dropout2_rate=0.0, activation="none",
        generator=gen())
    # dropout1 on the hidden ones, then the identity-like second linear
    drop1 = (ff - 1.0)
    assert abs((drop1 == 0).float().mean().item() - 0.25) < 0.02
    assert torch.allclose(drop1[drop1 != 0], torch.tensor(1 / 0.75))


@pytest.mark.parametrize("name", ["fused_moe", "masked_multihead_attention",
                                  "block_multihead_attention"])
def test_the_three_raisers_raise(name):
    with pytest.raises(NotImplementedError):
        getattr(TF, name)(torch.zeros(1), torch.zeros(1), torch.zeros(1),
                          torch.zeros(1))
    with pytest.raises(NotImplementedError):
        getattr(JF, name)(paddle.to_tensor(np.zeros(1, np.float32)),
                          None, None, None)


def test_multi_head_attention_with_a_cache_raises():
    with pytest.raises(NotImplementedError):
        TF.fused_multi_head_attention(torch.zeros(1, 2, 8),
                                      torch.zeros(3, 2, 4, 8),
                                      torch.zeros(8, 8),
                                      cache_kv=torch.zeros(1))


# name -> (the layer from a module, with the port's factory arguments;
# its number of inputs)
LAYERS = {
    "dropout_add": (lambda m, **k: m.FusedDropoutAdd(0.5), 2),
    "bias_dropout_residual_layer_norm": (
        lambda m, **k: m.FusedBiasDropoutResidualLayerNorm(8, 0.1, **k), 2),
    "feedforward_pre_ln": (
        lambda m, **k: m.FusedFeedForward(8, 16, 0.1, activation="gelu",
                                          normalize_before=True, **k), 1),
    "feedforward_post_ln": (
        lambda m, **k: m.FusedFeedForward(8, 16, 0.1, **k), 1),
    "multi_transformer": (
        lambda m, **k: m.FusedMultiTransformer(8, 2, 16, num_layers=2, **k),
        1),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_matches_jax_on_one_state(name):
    """The JAX layer's state dict loads into the port's as it is (the
    same names and shapes); in eval mode the outputs and the gradients
    of the inputs and of every parameter agree."""
    make, n_in = LAYERS[name]
    jl = make(jnn)
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    rng = np.random.default_rng(7)
    # non-trivial biases and scales (the JAX layer makes zeros and ones)
    state = {k: (v + rng.normal(size=v.shape).astype(np.float32) * 0.1
                 if v.ndim <= 3 else v) for k, v in state.items()}
    jl.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    tl = make(tnn, device="cpu")
    assert list(tl.state_dict()) == list(state)
    tl.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    jl.eval()
    tl.eval()
    xs = [rng.normal(size=(2, 5, 8)).astype(np.float32)
          for _ in range(n_in)]
    dy = rng.normal(size=(2, 5, 8)).astype(np.float32)
    tx = [torch.tensor(a, requires_grad=True) for a in xs]
    jx = [paddle.to_tensor(a, stop_gradient=False) for a in xs]
    tout, jout = tl(*tx), jl(*jx)
    _close(tout.detach().numpy(), jout.numpy(), "out")
    (tout * torch.tensor(dy)).sum().backward()
    (jout * paddle.to_tensor(dy)).sum().backward()
    for t, j in zip(tx, jx):
        _close(t.grad.numpy(), j.grad.numpy(), "input grad")
    jp = dict(jl.named_parameters())
    for k, p in tl.named_parameters():
        _close(_grad(p.grad, p.shape), _grad(jp[k].grad, p.shape), f"d{k}")


def test_layers_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is taken")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tnn.FusedFeedForward(8, 16)
