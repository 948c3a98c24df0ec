"""``paddle2_tpu_torch.nn.functional``'s extra losses
(``extra_losses.py``) against the JAX package's on the CPU: the
table's ``EXTRA`` cases (``torch_nn_table_functional``), forward, dtypes
and gradients in float32 (and bfloat16 where the table says), and
``adaptive_log_softmax_with_loss`` (f32: 1e-5, gradients 1e-4)."""

import numpy as np
import pytest
import torch

import paddle2_tpu as jp
import paddle2_tpu.nn.functional as JF
import paddle2_tpu_torch.nn.functional as TF
from torch_core_harness import port_on_cpu  # noqa: F401
from torch_core_harness import cases_params, run_case
from torch_nn_table_functional import EXTRA

F32 = dict(rtol=1e-5, atol=1e-6)
F32_GRAD = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case,dtype", cases_params(EXTRA))
def test_extra_loss_matches_jax(case, dtype):
    run_case(case, dtype)


# --------------------------------------------------- adaptive softmax
def test_adaptive_log_softmax_with_loss_matches_jax():
    """Two tail clusters and a head bias: each sample's log-probability,
    the loss and every gradient, f32."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 8)).astype(np.float32)
    lab = np.array([0, 2, 3, 5, 8], np.int32)
    arrays = [x, rng.standard_normal((8, 5)).astype(np.float32),
              rng.standard_normal(5).astype(np.float32)] + [
        rng.standard_normal(s).astype(np.float32)
        for s in ((8, 4), (4, 3), (8, 2), (2, 4))]
    jt = [jp.to_tensor(a, stop_gradient=False) for a in arrays]
    tt = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    jo = JF.adaptive_log_softmax_with_loss(
        jt[0], jp.to_tensor(lab), jt[1], [jt[3:5], jt[5:7]], [3, 6],
        head_bias=jt[2])
    to = TF.adaptive_log_softmax_with_loss(
        tt[0], torch.from_numpy(lab), tt[1], [tt[3:5], tt[5:7]], [3, 6],
        head_bias=tt[2])
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a.detach().numpy(),
                                   np.asarray(b.numpy()), **F32)
    jg = jp.grad([jo[1]], jt)
    tg = torch.autograd.grad([to[1]], tt)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b.numpy()),
                                   **F32_GRAD)
