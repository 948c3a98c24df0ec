"""``paddle2_tpu_torch.nn.functional`` against ``paddle2_tpu.nn.functional``
on the CPU: the common functionals of the table
(``torch_nn_table_functional.COMMON``; the spatial ones are
``test_torch_nn_spatial.py``'s) on the same numpy inputs, forward
values, dtypes and gradients of every float input, in float32 and
bfloat16 (``torch_core_harness``: f32 rtol 1e-5 / atol 1e-6, bf16 one
bf16 step, unless a case states its own); and the random functionals
(the dropouts, ``rrelu``, ``gumbel_softmax``, ``class_center_sample``)
by their statistics."""

import numpy as np
import pytest
import torch

import paddle2_tpu as jp
import paddle2_tpu.nn.functional as JF
import paddle2_tpu_torch as tp
import paddle2_tpu_torch.nn.functional as TF
from torch_core_harness import port_on_cpu  # noqa: F401
from torch_core_harness import cases_params, run_case
from torch_nn_table_functional import COMMON

F32 = dict(rtol=1e-5, atol=1e-6)
F32_GRAD = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case,dtype", cases_params(COMMON))
def test_functional_matches_jax(case, dtype):
    run_case(case, dtype)


# ------------------------------------------------ random, by statistics
def _x(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32) + 3.0)


@pytest.mark.parametrize("p,mode", [(0.3, "upscale_in_train"),
                                    (0.6, "upscale_in_train"),
                                    (0.3, "downscale_in_infer")])
def test_dropout_keep_rate_and_scaling(p, mode):
    x = _x((200, 100))
    tp.seed(5)
    y = TF.dropout(x, p=p, mode=mode)
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - p)) < 0.02
    scale = 1 / (1 - p) if mode == "upscale_in_train" else 1.0
    np.testing.assert_allclose(y[kept].numpy(), (x[kept] * scale).numpy(),
                               rtol=1e-6)
    tp.seed(5)
    assert torch.equal(TF.dropout(x, p=p, mode=mode), y)
    tp.seed(6)
    assert not torch.equal(TF.dropout(x, p=p, mode=mode), y)
    # the gradient passes where kept, scaled
    xg = x.clone().requires_grad_(True)
    tp.seed(5)
    TF.dropout(xg, p=p, mode=mode).sum().backward()
    np.testing.assert_allclose(xg.grad.numpy(), kept.float().numpy() * scale,
                               rtol=1e-6)


@pytest.mark.parametrize("fn,shape,axes", [
    ("dropout2d", (40, 30, 3, 3), (0, 1)),
    ("dropout3d", (40, 30, 2, 2, 2), (0, 1)),
    ("axis", (50, 40, 6), (1,))])
def test_dropout_by_axes_drops_whole_slices(fn, shape, axes):
    x = _x(shape)
    tp.seed(1)
    if fn == "axis":
        y = TF.dropout(x, p=0.4, axis=list(axes))
    else:
        y = getattr(TF, fn)(x, p=0.4)
    kept = (y != 0)
    other = tuple(i for i in range(len(shape)) if i not in axes)
    assert torch.equal(kept.all(dim=other), kept.any(dim=other))
    assert abs(kept.float().mean().item() - 0.6) < 0.05


def test_alpha_dropouts_keep_mean_and_variance():
    """On standard-normal inputs the alpha dropouts keep mean 0. The
    feature form keeps variance 1 and drops whole channels;
    ``alpha_dropout`` keeps the JAX function's variance, ``a**2 (1-p)
    (1 + p alpha'**2)`` with its ``a = (1 - p + p alpha'**2)**-0.5``:
    0.913 at p = 0.2, not 1 (a documented reference behaviour)."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (400, 500)).astype(np.float32))
    tp.seed(3)
    p, ap = 0.2, -1.6732632423543772 * 1.0507009873554805
    y = TF.alpha_dropout(x, p=p)
    want_var = (1 - p) * (1 + p * ap ** 2) / (1 - p + p * ap ** 2)
    assert abs(y.mean().item()) < 0.02
    assert abs(y.var().item() - want_var) < 0.02
    jy = JF.alpha_dropout(jp.to_tensor(x.numpy()), p=p)
    assert abs(float(np.asarray(jy.numpy()).var()) - want_var) < 0.02
    x4 = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (100, 200, 4, 4)).astype(np.float32))
    y4 = TF.feature_alpha_dropout(x4, p=0.2)
    assert abs(y4.mean().item()) < 0.03 and abs(y4.var().item() - 1) < 0.05
    dropped = (y4 == y4[..., :1, :1]).all(-1).all(-1)
    assert 0.15 < dropped.float().mean().item() < 0.25
    assert torch.equal(TF.feature_alpha_dropout(x4, p=1.0),
                       torch.zeros_like(x4))


def test_rrelu_slopes_lie_in_their_range():
    x = -torch.rand(200, 100) - 0.1
    tp.seed(4)
    y = TF.rrelu(x, lower=0.1, upper=0.3)
    slope = y / x
    assert y.dtype == torch.float32
    assert slope.min() >= 0.1 - 1e-6 and slope.max() <= 0.3 + 1e-6
    assert abs(slope.mean().item() - 0.2) < 0.005
    pos = torch.rand(10)
    assert torch.equal(TF.rrelu(pos), pos)
    # a bfloat16 input gives float32 in training (the f32 slopes), as in
    # the JAX function
    xb = x[:4].to(torch.bfloat16)
    assert TF.rrelu(xb).dtype == torch.float32
    jy = JF.rrelu(jp.to_tensor(x[:4].numpy()).astype("bfloat16"))
    assert str(jy.dtype).endswith("float32")


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_samples_by_the_logits(hard):
    """Sample frequencies follow softmax(logits); ``hard`` gives exact
    one-hot rows whose gradient is the soft sample's."""
    logits = torch.log(torch.tensor([0.1, 0.2, 0.3, 0.4])).repeat(4000, 1)
    tp.seed(7)
    x = logits.clone().requires_grad_(True)
    y = TF.gumbel_softmax(x, temperature=0.5, hard=hard)
    assert torch.allclose(y.sum(-1), torch.ones(4000))
    freq = torch.bincount(y.argmax(-1), minlength=4).float() / 4000
    np.testing.assert_allclose(freq.numpy(), [0.1, 0.2, 0.3, 0.4],
                               atol=0.03)
    if hard:
        assert set(torch.unique(y).tolist()) <= {0.0, 1.0}
        g = torch.autograd.grad(y[:, 0].sum(), x)[0]
        tp.seed(7)
        soft = TF.gumbel_softmax(x, temperature=0.5)
        gs = torch.autograd.grad(soft[:, 0].sum(), x)[0]
        np.testing.assert_allclose(g.numpy(), gs.numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_class_center_sample_keeps_the_positives():
    lab = torch.tensor([3, 7, 3, 11, 0], dtype=torch.int32)
    tp.seed(2)
    remapped, sampled = TF.class_center_sample(lab, 20, 8)
    assert remapped.dtype == torch.int32 and sampled.dtype == torch.int32
    assert sampled.numel() == 8
    assert torch.equal(sampled, torch.sort(sampled).values)
    assert {0, 3, 7, 11} <= set(sampled.tolist())
    assert torch.equal(sampled[remapped.long()], lab)
    jr, js = JF.class_center_sample(jp.to_tensor(lab.numpy()), 20, 8)
    assert tuple(js.shape) == (8,)
    tp.seed(2)
    assert torch.equal(TF.class_center_sample(lab, 20, 8)[1], sampled)
