"""``paddle2_tpu_torch.nn.functional``'s ``affine_grid`` and
``grid_sample`` against the JAX package's on the CPU: the table's
``VISION_OPS`` cases (``torch_nn_table_spatial_rnn``; forward, dtypes
and the gradients of ``x`` and the grid, f32 and bf16), among them
``"reflection"``, which clamps as ``"border"`` does, and ``"nearest"`` at
half-way coordinates (half to even)."""

import numpy as np
import pytest
import torch

import paddle2_tpu_torch as tp
from torch_core_harness import port_on_cpu  # noqa: F401
from torch_core_harness import cases_params, run_case
from torch_nn_table_spatial_rnn import VISION_OPS


@pytest.mark.parametrize("case,dtype", cases_params(VISION_OPS))
def test_vision_op_matches_jax(case, dtype):
    run_case(case, dtype)


def test_reflection_is_border_and_not_torch_reflection():
    """The JAX package clamps for any mode but zeros: ``"reflection"`` is
    ``"border"``, which ``torch.nn.functional.grid_sample``'s own
    reflection is not."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 2, 4, 5)).astype(
        np.float32))
    g = torch.from_numpy(rng.uniform(-1.5, 1.5, (1, 3, 3, 2)).astype(
        np.float32))
    F = tp.nn.functional
    refl = F.grid_sample(x, g, padding_mode="reflection")
    assert torch.equal(refl, F.grid_sample(x, g, padding_mode="border"))
    theirs = torch.nn.functional.grid_sample(
        x, g, padding_mode="reflection", align_corners=True)
    assert not torch.allclose(refl, theirs)


def test_nearest_sends_no_gradient_to_the_grid():
    """The JAX package's grid gradient under ``"nearest"`` is all zeros
    (a rounded index); the port's grid takes none."""
    import paddle2_tpu as jp
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 2, 4, 4)).astype(np.float32)
    g = rng.uniform(-1, 1, (1, 3, 3, 2)).astype(np.float32)
    jx, jg = jp.to_tensor(x), jp.to_tensor(g)
    jx.stop_gradient = jg.stop_gradient = False
    jout = jp.nn.functional.grid_sample(jx, jg, mode="nearest")
    assert not np.asarray(jp.grad([jout.sum()], [jg])[0].numpy()).any()
    tx = torch.from_numpy(x).requires_grad_()
    tg = torch.from_numpy(g).requires_grad_()
    tout = tp.nn.functional.grid_sample(tx, tg, mode="nearest")
    assert tp.grad([tout.sum()], [tg], allow_unused=True)[0] is None
