"""``FLAGS_check_nan_inf`` on the plain routes that build their own
``-inf`` pads and masks: each runs under the flag in both packages and
both return the same values (f32, atol 1e-6); a NaN input still raises
in both.

The port checks the output of every aten op its process runs, the JAX
package only the ops it dispatches. So the port runs these routes with
the check suspended and checks their outputs
(``ops.dispatch.checks_outputs``): max pooling with an uneven pad
(``ceil_mode``), ``flash_attention(return_softmax=True)`` under causal,
the densified ``flash_attn_unpadded`` route, ``flashmask_attention``,
``sparse_attention`` and the plain split-K paged decode."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

import jax.numpy as jnp
import paddle2_tpu as jp
import paddle2_tpu.flags as jflags
from paddle2_tpu.nn.functional import flash_attention as jfa
from paddle2_tpu.serving.paged_attention import (
    paged_attention_split_reference as jax_split_reference)
import paddle2_tpu_torch as tp
from paddle2_tpu_torch import flags
from paddle2_tpu_torch.nn.functional import flash_attention as tfa
from paddle2_tpu_torch.serving import paged_attention_split_reference

ATOL = 1e-6


@pytest.fixture
def check_on():
    """The flag on in both packages, the port on the CPU; restored."""
    before = flags.get_flags()
    tp.set_device("cpu")
    jflags.set_flags({"check_nan_inf": True})
    flags.set_flags({"check_nan_inf": True})
    try:
        yield
    finally:
        jflags.set_flags({"check_nan_inf": False})
        flags.set_flags(before)


def _tensors(pkg, *arrays):
    """The inputs as tensors of ``pkg``: the port's made out of the
    check's sight, so that a NaN input is first seen by the route."""
    if pkg is jp:
        return [jp.to_tensor(a) for a in arrays]
    with _disable_current_modes():
        return [torch.tensor(a) for a in arrays]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy(), np.float32)
    return np.asarray(x, np.float32)


def _max_pool(pkg, x):
    t, = _tensors(pkg, x)
    return pkg.nn.functional.max_pool2d(t, 2, 2, ceil_mode=True)


def _flash_softmax(pkg, q):
    mod = jfa if pkg is jp else tfa
    t, = _tensors(pkg, q)
    out, softmax = mod.flash_attention(t, t, t, causal=True,
                                       return_softmax=True)
    return out, softmax


def _unpadded(pkg, q):
    """Head dim 32 (no varlen kernel takes it): the densify route on the
    CPU in both packages; equal lengths, so no row is empty."""
    mod = jfa if pkg is jp else tfa
    t, = _tensors(pkg, q)
    cu = np.array([0, 3, 8], np.int32)
    out, _ = mod.flash_attn_unpadded(t, t, t, cu, cu, 5, 5,
                                     1.0 / np.sqrt(q.shape[-1]), causal=True)
    return out


def _flashmask(pkg, q):
    """Causal, one start row a key: rows at or below it masked."""
    mod = jfa if pkg is jp else tfa
    idx = np.array([[[[4], [5], [6], [6], [6], [6]]]], np.int32)
    t, i = _tensors(pkg, q, idx)
    return mod.flashmask_attention(t, t, t, startend_row_indices=i,
                                   causal=True)


def _sparse(pkg, q):
    """Row r of each head sees keys 0..r (a CSR lower triangle) with the
    last key padded out, so the masked scores are filled with -inf."""
    mod = jfa if pkg is jp else tfa
    B, H, S, _ = q.shape
    cols = np.concatenate([np.arange(r + 1) for r in range(S)])
    off = np.concatenate([[0], np.cumsum(np.arange(1, S + 1))])
    off = np.broadcast_to(off, (B, H, S + 1)).astype(np.int32)
    cols = np.broadcast_to(cols, (B, H, cols.size)).astype(np.int32)
    pad = np.zeros((B, S), np.float32)
    pad[:, -1] = -1.0
    args = _tensors(pkg, q, q, q, off, cols, pad)
    return mod.sparse_attention(*args[:5], key_padding_mask=args[5])


SITES = {
    # name: (function of (package, input), input shape)
    "max_pool2d_ceil_mode": (_max_pool, (1, 2, 5, 5)),
    "flash_attention_return_softmax": (_flash_softmax, (1, 8, 2, 16)),
    "flash_attn_unpadded_densify": (_unpadded, (8, 2, 32)),
    "flashmask_attention": (_flashmask, (1, 6, 2, 16)),
    "sparse_attention": (_sparse, (1, 2, 6, 16)),
}


@pytest.mark.parametrize("site", list(SITES))
def test_the_flag_passes_the_port_own_infinities_as_jax_does(check_on,
                                                             site):
    fn, shape = SITES[site]
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = fn(jp, x)
    got = fn(tp, x)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=ATOL)
        assert np.isfinite(_np(g)).all()


@pytest.mark.parametrize("site", list(SITES))
def test_a_nan_input_still_raises_in_both(check_on, site):
    fn, shape = SITES[site]
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    x.reshape(-1)[1] = np.nan
    with pytest.raises(FloatingPointError):
        fn(jp, x)
    with pytest.raises(FloatingPointError):
        fn(tp, x)


def _paged_inputs(nan=False):
    """Two sequences (contexts 5 and 19) over 16-row blocks, two pages
    each, f32; ``nan`` poisons one live key."""
    rng = np.random.default_rng(3)
    bs, H, D = 16, 2, 16
    kp = rng.normal(size=(6, bs, H, D)).astype(np.float32)
    vp = rng.normal(size=(6, bs, H, D)).astype(np.float32)
    if nan:
        kp[1, 0, 0, 0] = np.nan
    q = rng.normal(size=(2, 1, H, D)).astype(np.float32)
    tables = np.array([[1, 0], [2, 3]], np.int32)
    ctx = np.array([5, 19], np.int32)
    return q, kp, vp, tables, ctx


def test_the_plain_split_paged_decode_passes_its_masks(check_on):
    """A dead split (the first sequence's second page) is masked with
    -inf; the JAX reference is one jitted program, outside its check."""
    q, kp, vp, tables, ctx = _paged_inputs()
    want = jax_split_reference(jnp.asarray(q), jnp.asarray(kp),
                               jnp.asarray(vp), jnp.asarray(tables),
                               jnp.asarray(ctx), pages_per_split=1)
    got = paged_attention_split_reference(
        *(torch.from_numpy(a) for a in (q, kp, vp, tables, ctx)),
        pages_per_split=1)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=ATOL)
    args = _tensors(tp, *_paged_inputs(nan=True))
    with pytest.raises(FloatingPointError,
                       match="paged_attention_split_reference"):
        paged_attention_split_reference(*args, pages_per_split=1)
