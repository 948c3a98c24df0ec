"""``paddle2_tpu_torch.nn.functional``'s losses against the JAX
package's on the CPU: the loss functionals of the table
(``torch_nn_table_functional.LOSSES``), forward, dtypes and gradients in
float32 and bfloat16 (``torch_core_harness``'s tolerances unless a case
states its own), and ``cross_entropy`` with every combination of its
options (f32: loss 1e-5, gradients 1e-4)."""

import itertools

import numpy as np
import pytest
import torch

import paddle2_tpu as jp
import paddle2_tpu.nn.functional as JF
import paddle2_tpu_torch.nn.functional as TF
from torch_core_harness import port_on_cpu  # noqa: F401
from torch_core_harness import cases_params, run_case
from torch_nn_table_functional import LOSSES

F32 = dict(rtol=1e-5, atol=1e-6)
F32_GRAD = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case,dtype", cases_params(LOSSES))
def test_loss_matches_jax(case, dtype):
    run_case(case, dtype)


# ------------------------------------------------------- cross-entropy
_CE_AXES = {-1: (6, 5), 0: (5, 6)}


def _ce_inputs(rng, soft, axis, use_softmax):
    shape = _CE_AXES[axis]
    c = shape[axis % 2]
    n = shape[1 - axis % 2]
    if use_softmax:
        logits = rng.standard_normal(shape).astype(np.float32) * 2
    else:
        logits = rng.random(shape).astype(np.float32) + 0.05
        logits /= logits.sum(axis, keepdims=True)
    if soft:
        lbl = rng.random(shape).astype(np.float32) + 0.05
        lbl /= lbl.sum(axis, keepdims=True)
    else:
        lbl = rng.integers(0, c, size=(n,)).astype(np.int32)
        lbl[1] = 3
    w = np.linspace(0.5, 1.5, c).astype(np.float32)
    return logits, lbl, w


CE_COMBOS = [
    dict(soft=s, weight=w, ignore=ig, reduction=r, axis=ax, use_softmax=us,
         smoothing=ls)
    for s, w, ig, r, ax, us, ls in itertools.product(
        (False, True), (False, True), (False, True),
        ("mean", "sum", "none"), (-1, 0), (True, False), (0.0, 0.1))
    # the JAX function reads weight and ignore_index for hard labels only
    if not (s and (w or ig))]


def _ce_id(c):
    return "-".join([("soft" if c["soft"] else "hard"),
                     ("w" if c["weight"] else "nw"),
                     ("ig" if c["ignore"] else "noig"), c["reduction"],
                     f"ax{c['axis']}", ("sm" if c["use_softmax"] else "p"),
                     f"ls{c['smoothing']}"])


@pytest.mark.parametrize("combo", CE_COMBOS, ids=_ce_id)
def test_cross_entropy_every_option_matches_jax(combo):
    """Loss and input gradient (and the weight's, where given) against
    the JAX function, f32; the label 3 (row 1) is ignored with
    ``ignore_index=3``."""
    rng = np.random.default_rng(11)
    logits, lbl, w = _ce_inputs(rng, combo["soft"], combo["axis"],
                                combo["use_softmax"])
    kw = dict(reduction=combo["reduction"], axis=combo["axis"],
              use_softmax=combo["use_softmax"],
              label_smoothing=combo["smoothing"],
              soft_label=combo["soft"])
    if combo["ignore"]:
        kw["ignore_index"] = 3
    jx = jp.to_tensor(logits, stop_gradient=False)
    tx = torch.from_numpy(logits).requires_grad_(True)
    jw = tw = None
    if combo["weight"]:
        jw = jp.to_tensor(w, stop_gradient=False)
        tw = torch.from_numpy(w).requires_grad_(True)
    jl = JF.cross_entropy(jx, jp.to_tensor(lbl), weight=jw, **kw)
    tl = TF.cross_entropy(tx, torch.from_numpy(lbl), weight=tw, **kw)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl.numpy()),
                               **F32)
    cot = rng.standard_normal(tuple(tl.shape)).astype(np.float32)
    leaves_j = [jx] + ([jw] if jw is not None else [])
    leaves_t = [tx] + ([tw] if tw is not None else [])
    jg = jp.grad([jl], leaves_j, grad_outputs=[jp.to_tensor(cot)])
    tg = torch.autograd.grad([tl], leaves_t, [torch.from_numpy(cot)])
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b.numpy()),
                                   **F32_GRAD)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_cross_entropy_takes_label_shapes_and_int_types(dt):
    """Labels ``[N]`` and ``[N, 1]``, int32 and int64 (both int32 in the
    JAX package, by its x32 policy), in f32 and bf16 (one bf16 step)."""
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((6, 7)).astype(np.float32)
    lbl = rng.integers(0, 7, size=(6,))
    want = JF.cross_entropy(jp.to_tensor(logits).astype(dt),
                            jp.to_tensor(lbl.astype(np.int32)))
    tol = F32 if dt == "float32" else dict(rtol=1e-2, atol=1e-2)
    for lab in (lbl.astype(np.int32), lbl.astype(np.int64),
                lbl[:, None].astype(np.int32)):
        got = TF.cross_entropy(torch.from_numpy(logits).to(
            getattr(torch, dt)), torch.from_numpy(lab))
        assert str(got.dtype).endswith(dt)
        np.testing.assert_allclose(
            got.float().numpy(),
            np.asarray(want.astype("float32").numpy()), **tol)
