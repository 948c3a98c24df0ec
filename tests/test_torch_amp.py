"""Mixed precision (paddle2_tpu_torch.amp) held against the JAX package's
``paddle2_tpu.amp`` on the CPU: the cast by op name (every op of the op
library, under the name the JAX package dispatches it by, and the
result dtype of each white- or black-listed one under O1 and O2 in
bf16 and f16), the custom lists, nesting and ``enable=False``,
``decorate``'s options, and a two-layer GPT's loss and gradients under
``auto_cast`` against the JAX model's under the same ``auto_cast``.

Tolerances for the GPT: the loss to 4 steps of the AMP dtype relative
(2**-9 in f16, 2**-6 in bf16), each gradient to 8 steps of its largest
magnitude (2**-8 in f16, 2**-5 in bf16): both packages round the same
activations to the AMP dtype, but sum the products in other orders and
compute the attention probabilities by other routes (the port's flash
plain version in f32, the JAX model's XLA softmax on the CPU).
"""

import importlib

import numpy as np
import pytest
import torch

import paddle2_tpu as paddle
import paddle2_tpu.amp as jamp
from paddle2_tpu.framework.tensor import Tensor
from paddle2_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle2_tpu.models.gpt import gpt_tiny as jax_tiny
import paddle2_tpu_torch as tp
from paddle2_tpu_torch import amp
from paddle2_tpu_torch.amp import amp_lists
from paddle2_tpu_torch.models import (GPTForCausalLM, gpt_state_from_reference,
                                      gpt_tiny)
from paddle2_tpu_torch.ops import dispatch as tdispatch
import torch_core_harness as H
from torch_core_cases import seed_of
from torch_core_harness import port_on_cpu  # noqa: F401

TABLES = ("math", "manipulation", "linalg", "creation", "logic_misc",
          "extra")
CASES = [c for t in TABLES
         for c in getattr(importlib.import_module(f"torch_core_table_{t}"),
                          "CASES", [])]
LISTED = amp_lists.WHITE_LIST | amp_lists.BLACK_LIST
DT = {"float16": torch.float16, "bfloat16": torch.bfloat16}


def test_lists_are_the_jax_packages():
    assert amp_lists.WHITE_LIST == jamp.amp_lists.WHITE_LIST
    assert amp_lists.BLACK_LIST == jamp.amp_lists.BLACK_LIST


def _jax_names(case):
    """The op names the JAX package's dispatcher casts by during one
    call of ``case`` (under an auto_cast, so that it asks)."""
    seen = []
    orig = jamp.cast_inputs_for_op

    def spy(name, arrays):
        seen.append(name)
        return orig(name, arrays)
    rng = np.random.default_rng(seed_of(case))
    ja, _ = H.build(list(case.make(rng)), "float32", "jax", set())
    jk = H.build_kwargs(case.kwargs, "float32", "jax")
    jamp.cast_inputs_for_op = spy
    try:
        with jamp.auto_cast(level="O1", dtype="float16"):
            getattr(paddle, case.op)(*ja, **jk)
    finally:
        jamp.cast_inputs_for_op = orig
    return list(dict.fromkeys(seen))


# one case an op, every case of the ops named by their arguments
NAME_CASES = [c for i, c in enumerate(CASES)
              if c.op in tdispatch.DISPATCHED_BY
              or all(d.op != c.op for d in CASES[:i])]


@pytest.mark.parametrize("case", NAME_CASES,
                         ids=[c.id for c in NAME_CASES])
def test_each_op_casts_under_the_name_the_jax_package_dispatches(case):
    """An op casts under the first name the JAX op dispatches, and takes
    no cast where the JAX op dispatches nothing."""
    names = _jax_names(case)
    fn = getattr(tp, case.op)
    got = getattr(fn, "amp_name", None)
    if callable(got):           # named by its arguments (pow)
        rng = np.random.default_rng(seed_of(case))
        ta, _ = H.build(list(case.make(rng)), "float32", "torch", set())
        got = got(*ta, **H.build_kwargs(case.kwargs, "float32", "torch"))
    if not names:
        assert got is None, (case.op, got)
    else:
        assert got == names[0], (case.op, got, names)


LISTED_CASES = [c for c in CASES
                if getattr(getattr(tp, c.op), "amp_name", None) in LISTED
                or c.op in tdispatch.DISPATCHED_BY]


def _dtypes(out):
    return [H.dtype_name(o) for o in H.flat(out) if H.is_tensor(o)]


@pytest.mark.parametrize("amp_dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("case", LISTED_CASES,
                         ids=[c.id for c in LISTED_CASES])
def test_listed_ops_give_the_reference_dtype(case, level, amp_dtype):
    """The result dtypes of every white- or black-listed op of the
    library, from f32 inputs, under O1 and O2: the JAX package's."""
    rng = np.random.default_rng(seed_of(case))
    args = list(case.make(rng))
    ja, _ = H.build(args, "float32", "jax", set())
    ta, _ = H.build(args, "float32", "torch", set())
    jk = H.build_kwargs(case.kwargs, "float32", "jax")
    tk = H.build_kwargs(case.kwargs, "float32", "torch")
    with jamp.auto_cast(level=level, dtype=amp_dtype):
        want = getattr(paddle, case.op)(*ja, **jk)
    with amp.auto_cast(level=level, dtype=amp_dtype):
        got = getattr(tp, case.op)(*ta, **tk)
    assert _dtypes(got) == _dtypes(want)


def test_every_listed_name_the_port_dispatches_is_covered():
    """The listed names the op library's table cases reach, and the ones
    its functionals dispatch (held below)."""
    lib = {getattr(getattr(tp, c.op), "amp_name") for c in LISTED_CASES
           if c.op not in tdispatch.DISPATCHED_BY}
    assert {"matmul", "exp", "log", "mean", "sum", "cumsum",
            "logsumexp"} <= lib
    wrapped = {tp.nn.functional.layer_norm.amp_name,
               tp.nn.functional.cross_entropy.amp_name,
               tp.nn.functional.conv2d.amp_name,
               tp.nn.functional.batch_norm.amp_name}
    assert wrapped == {"layer_norm", "cross_entropy", "conv2d", "batch_norm"}


@pytest.mark.parametrize("amp_dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_functionals_give_the_reference_dtype(level, amp_dtype):
    """The kernel wrappers and functionals by their JAX names:
    ``scaled_dot_product_attention`` ("flash_attention"/"sdpa", white),
    ``layer_norm`` and ``cross_entropy`` (black), ``conv2d`` (white)."""
    import paddle2_tpu.nn.functional as JF
    import paddle2_tpu_torch.nn.functional as TF
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 16, 2, 16)).astype(np.float32)
    x = rng.standard_normal((4, 8)).astype(np.float32)
    w = np.ones(8, np.float32)
    img = rng.standard_normal((1, 3, 6, 6)).astype(np.float32)
    ker = rng.standard_normal((4, 3, 3, 3)).astype(np.float32)
    lab = np.array([1, 0, 3, 2], np.int64)
    calls = [
        (lambda m, t: m.scaled_dot_product_attention(t(q), t(q), t(q),
                                                     is_causal=True),
         "attention"),
        (lambda m, t: m.layer_norm(t(x), 8, t(w), t(w)), "layer_norm"),
        (lambda m, t: m.cross_entropy(t(x), t(lab)), "cross_entropy"),
        (lambda m, t: m.conv2d(t(img), t(ker)), "conv2d")]
    for call, what in calls:
        with jamp.auto_cast(level=level, dtype=amp_dtype):
            want = call(JF, paddle.to_tensor)
        with amp.auto_cast(level=level, dtype=amp_dtype):
            got = call(TF, lambda a: torch.from_numpy(a))
        assert H.dtype_name(got) == H.dtype_name(want), what


def _cast_pair(x, name, **kw):
    with jamp.auto_cast(**kw):
        want = jamp.cast_inputs_for_op(name, (paddle.to_tensor(x)._data,))
    with amp.auto_cast(**kw):
        got = amp.cast_inputs_for_op(name, (torch.from_numpy(x),))
    return H.dtype_name(got[0]), str(want[0].dtype)


@pytest.mark.parametrize("kw,name", [
    (dict(custom_white_list={"exp"}), "exp"),
    (dict(custom_black_list={"matmul"}), "matmul"),
    (dict(custom_white_list={"abs"}), "abs"),
    (dict(custom_white_list={"x"}, custom_black_list={"x"}), "x"),
    (dict(level="O2", custom_black_list={"matmul"}), "matmul"),
    (dict(level="O2", custom_white_list={"exp"}), "exp"),
    (dict(enable=False), "matmul")],
    ids=["white_over_black", "black_over_white", "white_neutral",
         "both", "o2_black", "o2_white", "disabled"])
@pytest.mark.parametrize("amp_dtype", ["bfloat16", "float16"])
def test_custom_lists_follow_the_reference(kw, name, amp_dtype):
    x = np.ones(3, np.float32)
    got, want = _cast_pair(x, name, dtype=amp_dtype, **kw)
    assert got == want


def test_nesting_and_enable_false_restore_the_state():
    x = torch.ones(2, 2)
    assert amp.amp_state() is None
    with amp.auto_cast(level="O1", dtype="float16"):
        st = amp.amp_state()
        assert st.level == "O1" and st.dtype == torch.float16
        assert torch.matmul(x, x).dtype == torch.float16
        with amp.auto_cast(enable=False):
            assert amp.amp_state() is None
            assert torch.matmul(x, x).dtype == torch.float32
            assert tp.matmul(x, x).dtype == torch.float32
        with amp.amp_guard(level="O2", dtype="bfloat16"):
            assert tp.abs(x).dtype == torch.bfloat16
            assert (x + x).dtype == torch.bfloat16
        assert amp.amp_state() is st
        assert (x + x).dtype == torch.float32     # neither list: O1 keeps
    assert amp.amp_state() is None
    assert torch.matmul(x, x).dtype == torch.float32


def test_backward_is_not_cast_and_records_name_what_ran():
    """The backward runs as the forward recorded it (nothing cast, even
    inside the block); ``record_casts`` names each cast op with its
    output dtypes."""
    w = torch.nn.Parameter(torch.ones(3, 3))
    x = torch.ones(2, 3)
    with amp.auto_cast(level="O1", dtype="float16"):
        with amp.record_casts() as rec:
            y = torch.nn.functional.linear(x, w)
            z = tp.exp(y)
        z.sum().backward()
    assert rec == [("linear", (torch.float16,)), ("exp", (torch.float32,))]
    assert w.grad.dtype == torch.float32


def _torch_names_reached():
    """The entries of ``TORCH_NAMES`` the cast reaches in the forwards
    and backwards of the port's models (GPT with and without stacked
    blocks, remat and its fake-quantized head, ERNIE, ResNet-18, a packed
    flash_attn_unpadded stack) under O2, where every entry casts."""
    from paddle2_tpu_torch.amp import casting
    from paddle2_tpu_torch.models import (ErnieForSequenceClassification,
                                          ernie_tiny)
    from paddle2_tpu_torch.nn.functional import flash_attn_unpadded
    from paddle2_tpu_torch.framework.core import place_scope
    from paddle2_tpu_torch.vision.models import resnet18
    reached = set()

    class Spy(dict):
        def get(self, func, default=None):
            if dict.__contains__(self, func) and casting._active():
                reached.add(func)
            return dict.get(self, func, default)

    class Packed(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.qkv = torch.nn.Linear(32, 96, bias=False)
            self.out = torch.nn.Linear(32, 32, bias=False)

        def forward(self, x, cu):
            qkv = self.qkv(x).view(x.shape[0], 3, 2, 16)
            o, _ = flash_attn_unpadded(qkv[:, 0], qkv[:, 1], qkv[:, 2], cu,
                                       cu, 7, 7, 0.25, causal=True)
            return x + self.out(o.reshape(x.shape[0], 32))
    with place_scope("cpu"):
        resnet18_on_cpu = resnet18(num_classes=10)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 128, (2, 16)))
    img = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 3, 32, 32)).astype(np.float32))
    cu = torch.tensor([0, 5, 12], dtype=torch.int32)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (12, 32)).astype(np.float32))
    runs = [(GPTForCausalLM(gpt_tiny(**cfg), device="cpu", seed=1),
             lambda m: m(ids, labels=ids)[1])
            for cfg in (dict(), dict(quantized_lm_head=True),
                        dict(stacked_blocks=True, use_recompute=True,
                             recompute_granularity="dots",
                             fused_head_loss=True))]
    runs += [(ErnieForSequenceClassification(ernie_tiny(), device="cpu",
                                             seed=1),
              lambda m: m(ids)[0]),
             (resnet18_on_cpu, lambda m: m(img)),
             (Packed(), lambda m: m(x, cu))]
    prev = casting.TORCH_NAMES
    casting.TORCH_NAMES = Spy(prev)
    try:
        for model, fwd in runs:
            model.train()
            with amp.auto_cast(level="O2", dtype="bfloat16"):
                out = fwd(model)
            out.float().sum().backward()
    finally:
        casting.TORCH_NAMES = prev
    return reached


def test_every_torch_name_is_reached_by_a_models_forward():
    """The cast mode names only torch functions that the port's models
    call where the JAX package's models dispatch the same op."""
    from paddle2_tpu_torch.amp import casting
    missing = [casting.TORCH_NAMES[f] for f in casting.TORCH_NAMES
               if f not in _torch_names_reached()]
    assert not missing, missing


def test_decorate_takes_every_option_as_the_reference():
    """``master_weight``, ``save_dtype`` and ``master_grad`` are taken and
    change nothing, as in the JAX package; O2 casts all but the norms'
    own parameters; O1 casts nothing; the optimizers come back as
    passed."""
    paddle.seed(0)
    jm = JaxGPT(jax_tiny())
    tm = GPTForCausalLM(gpt_tiny(), device="cpu", seed=1)
    opt = object()
    for kw in (dict(master_weight=True, save_dtype="float32",
                    master_grad=True), {}):
        jd = jamp.decorate(JaxGPT(jax_tiny()), level="O2", dtype="float16",
                           **kw)
        td = amp.decorate(GPTForCausalLM(gpt_tiny(), device="cpu", seed=1),
                          level="O2", dtype="float16", **kw)
        want = {n: H.dtype_name(t) for n, t in gpt_state_from_reference(
            {n: np.asarray(p.numpy()) for n, p in jd.named_parameters()}
        ).items()}
        got = {n: H.dtype_name(p) for n, p in td.named_parameters()}
        assert got == want
    assert amp.decorate(tm, opt, level="O1") == (tm, opt)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert amp.decorate([tm], level="O1") == [tm]
    with pytest.raises(ValueError, match="level"):
        amp.decorate(tm, level="O3")
    assert amp.is_float16_supported() and amp.is_bfloat16_supported()
    del jm


def _gpt_pair(stacked, remat, fused, decorated, amp_dtype):
    cfg = dict(stacked_blocks=stacked, use_recompute=remat != "none",
               recompute_granularity="full" if remat == "none" else remat,
               fused_head_loss=fused)
    paddle.seed(0)
    jm = JaxGPT(jax_tiny(**cfg))
    tm = GPTForCausalLM(gpt_tiny(**cfg), device="cpu", seed=1)
    state = {k: np.asarray(v.numpy(), np.float32)
             for k, v in jm.state_dict().items()}
    tm.load_state_dict(gpt_state_from_reference(state))
    if decorated:
        jm = jamp.decorate(jm, level="O2", dtype=amp_dtype)
        tm = amp.decorate(tm, level="O2", dtype=amp_dtype)
    return jm, tm


# (level, stacked, remat, fused head, decorated, AMP dtype): both levels
# and dtypes on per-block storage; stacked storage, "dots" remat and the
# fused head in f16 at both levels; O2 over f32 parameters with "full"
# remat (the recomputed forward cast again) in bf16
GPT_GRID = [(lv, False, "none", False, lv == "O2", dt)
            for lv in ("O1", "O2") for dt in ("bfloat16", "float16")] + \
    [(lv, True, "dots", True, lv == "O2", "float16")
     for lv in ("O1", "O2")] + \
    [("O2", False, "full", False, False, "bfloat16")]
GPT_IDS = [f"{lv}-{'stacked-dots-fusedhead' if st else 'blocks'}"
           f"{'-full-remat-f32params' if rm == 'full' else ''}-{dt}"
           for lv, st, rm, fh, dec, dt in GPT_GRID]
# an O2-decorated model under O1: the fused head takes f32 hidden states
# over f16 weights
GPT_GRID.append(("O1", False, "none", True, True, "float16"))
GPT_IDS.append("O1-blocks-fusedhead-o2params-float16")


@pytest.mark.parametrize("level,stacked,remat,fused,decorated,amp_dtype",
                         GPT_GRID, ids=GPT_IDS)
def test_gpt_under_auto_cast_matches_jax(level, stacked, remat, fused,
                                         decorated, amp_dtype):
    jm, tm = _gpt_pair(stacked, remat, fused, decorated, amp_dtype)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 128, size=(2, 16)).astype(np.int32)
    labels = rng.integers(0, 128, size=(2, 16)).astype(np.int32)
    labels[0, :3] = -100

    def jf(i, lab):
        with jamp.auto_cast(level=level, dtype=amp_dtype):
            return jm(i, labels=lab)[1]
    jloss = paddle.jit.to_static(jf)(Tensor(ids), Tensor(labels))
    jloss.backward()
    jgrads = gpt_state_from_reference(
        {n: np.asarray(p.grad.numpy(), np.float32)
         for n, p in jm.named_parameters()})
    with amp.auto_cast(level=level, dtype=amp_dtype):
        with amp.record_casts() as rec:
            _, loss = tm(torch.from_numpy(ids).long(),
                         labels=torch.from_numpy(labels).long())
    loss.backward()
    step = 2.0 ** (-11 if amp_dtype == "float16" else -8)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=4 * step)
    names = {n: dts for n, dts in rec}
    assert names["linear"] == (DT[amp_dtype],)
    assert names["flash_attention"] == (DT[amp_dtype],)
    assert names["layer_norm"] == (torch.float32,)
    for name, p in tm.named_parameters():
        want = jgrads[name].numpy()
        assert p.grad is not None and p.grad.dtype == p.dtype, name
        got = p.grad.float().numpy()
        assert np.abs(got - want).max() <= 8 * step * max(
            np.abs(want).max(), 1e-12), name
    assert not any(tdispatch.NOT_DISPATCHED & set(names))
