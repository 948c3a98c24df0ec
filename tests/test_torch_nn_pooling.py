"""``paddle2_tpu_torch.nn``'s pools against ``paddle2_tpu.nn``'s on the
CPU: every ``POOL`` case and ``POOL_LAYERS`` entry of
``torch_nn_table_spatial_rnn`` (forward, masks, dtypes and gradients,
f32 and bf16), and the rules the tables cannot show alone: a tie's
gradient through the mask route split equally and through the plain
route given to the first tap (both against the JAX package), the mask
route's raises, and ``fractional_max_pool2d`` drawing ``random_u`` from
the port's generator."""

import numpy as np
import pytest
import torch

import paddle2_tpu as jp
import paddle2_tpu_torch as tp
from torch_core_harness import port_on_cpu  # noqa: F401
from torch_core_harness import cases_params, run_case
from torch_nn_layer_harness import layer_params, run_layer
from torch_nn_table_spatial_rnn import POOL, POOL_LAYERS

JF, TF = jp.nn.functional, tp.nn.functional


@pytest.mark.parametrize("case,dtype", cases_params(POOL))
def test_pool_matches_jax(case, dtype):
    run_case(case, dtype)


@pytest.mark.parametrize("entry,dtype", layer_params(POOL_LAYERS))
def test_pool_layer_matches_jax(entry, dtype):
    run_layer(entry, dtype)


@pytest.mark.parametrize("mask,want", [(True, [0.5, 0.5, 1.0, 0.0]),
                                       (False, [1.0, 0.0, 1.0, 0.0])])
def test_tie_gradient_by_route(mask, want):
    """A window of two equal maxima: the mask route (``jnp.max`` over the
    stacked taps) gives each half; the plain route (``reduce_window``,
    torch's ``max_pool``) gives the first all of it."""
    x = np.array([[[1.0, 1.0, 0.0, -1.0]]], np.float32)
    jx = jp.to_tensor(x)
    jx.stop_gradient = False
    jout = JF.max_pool1d(jx, 2, return_mask=mask)
    jo = jout[0] if mask else jout
    jg = np.asarray(jp.grad([jo.sum()], [jx])[0].numpy())
    tx = torch.from_numpy(x).requires_grad_()
    tout = TF.max_pool1d(tx, 2, return_mask=mask)
    (tout[0] if mask else tout).sum().backward()
    np.testing.assert_array_equal(jg[0, 0], want)
    np.testing.assert_array_equal(tx.grad.numpy()[0, 0], want)


def test_mask_route_raises_as_jax():
    x = np.zeros((1, 2, 4, 4), np.float32)
    for F, t in ((JF, jp.to_tensor(x)), (TF, torch.from_numpy(x))):
        with pytest.raises(ValueError):
            F.max_pool2d(t, 2, padding="SAME", return_mask=True)
        with pytest.raises(NotImplementedError):
            F.max_pool2d(t, 2, return_mask=True, data_format="NHWC")


def test_fractional_pool_draws_random_u_from_the_port_seed():
    """With ``random_u`` None the window bounds come from the port's
    generator: the same seed gives the same pooling."""
    x = torch.randn(1, 1, 23, 23)
    tp.seed(5)
    a = TF.fractional_max_pool2d(x, 7, return_mask=True)
    tp.seed(5)
    b = TF.fractional_max_pool2d(x, 7, return_mask=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    outs = set()
    for s in range(8):
        tp.seed(s)
        outs.add(tuple(TF.fractional_max_pool2d(x, 7, return_mask=True)[1]
                       .flatten().tolist()))
    assert len(outs) > 1
    with pytest.raises(ValueError, match="random_u"):
        TF.fractional_max_pool2d(x, 7, random_u=1.0)


def test_max_unpool_inverts_the_mask():
    """``max_unpool2d`` of a max pool's values and mask puts each max back
    at its position, zeros elsewhere."""
    x = torch.randn(2, 3, 6, 8)
    out, mask = TF.max_pool2d(x, 2, return_mask=True)
    back = TF.max_unpool2d(out, mask, 2)
    assert back.shape == x.shape
    kept = back != 0
    assert torch.equal(back[kept], x[kept])
    assert int(kept.sum()) == out.numel()
