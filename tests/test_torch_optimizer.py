"""The port's optimizers (paddle2_tpu_torch.optimizer) held against the
JAX package's eager AdamW on the same numpy parameters and gradients,
and the fused AdamW step held against the port's own eager chain.

Tolerances: against JAX, 1e-6 of each f32 state's largest magnitude
after 10 steps (the op order is the same; XLA may contract a multiply
and an add into one rounding where torch rounds twice, and numpy's and
XLA's f32 ``pow`` may differ in the last place; the moments' elements
near zero are differences of such terms, so the tolerance is absolute
at the tensor's scale, not relative per element); a bf16 parameter to
one bf16 rounding step (2**-8 relative) of its f32 master. The fused step against the
eager chain: bitwise, on the CPU here (the kernel's plain version) and
on the card in chip_smoke.py (the CUDA kernel).
"""

import inspect

import numpy as np
import pytest
import torch

import paddle2_tpu as paddle
import paddle2_tpu.optimizer as jopt
from paddle2_tpu_torch.kernels import fused_adamw
from paddle2_tpu_torch.optimizer import Adam, AdamW, Momentum, Optimizer

STEPS = 10
SHAPE = (6, 40)


def _data(seed):
    rng = np.random.default_rng(seed)
    init = rng.normal(size=SHAPE).astype(np.float32)
    grads = [(rng.normal(size=SHAPE) * 0.1).astype(np.float32)
             for _ in range(STEPS)]
    return init, grads


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def _jax_adamw(init, grads, bf16, wd):
    p = paddle.to_tensor(init, stop_gradient=False)
    if bf16:
        p._replace_data(p._data.astype(paddle.bfloat16))
    o = jopt.AdamW(learning_rate=1e-2, parameters=[p], weight_decay=wd,
                   multi_precision=bf16)
    for g in grads:
        gt = paddle.to_tensor(g)
        p.grad = gt.astype("bfloat16") if bf16 else gt
        o.step()
    st = o._states[id(p)]
    master = st["master"] if bf16 else None
    inner = st["inner"] if bf16 else st
    f = lambda t: np.asarray(t._data if hasattr(t, "_data") else t,
                             np.float32)
    return (f(p), None if master is None else f(master), f(inner["m"]),
            f(inner["v"]))


def _torch_adamw(init, grads, bf16, wd, fused=None):
    dt = torch.bfloat16 if bf16 else torch.float32
    p = torch.nn.Parameter(torch.tensor(init).to(dt))
    o = AdamW(learning_rate=1e-2, parameters=[p], weight_decay=wd,
              multi_precision=bf16, fused=fused)
    for g in grads:
        p.grad = torch.tensor(g).to(dt)
        o.step()
    st = o._states[id(p)]
    master = st["master"] if bf16 else None
    inner = st["inner"] if bf16 else st
    return p.detach(), master, inner["m"], inner["v"], o


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16_master"])
@pytest.mark.parametrize("wd", [0.01, 0.0], ids=["decay", "no_decay"])
def test_adamw_matches_jax(bf16, wd):
    init, grads = _data(int(bf16) + 2 * int(wd > 0))
    jp, jmaster, jm, jv = _jax_adamw(init, grads, bf16, wd)
    tp, tmaster, tm, tv, o = _torch_adamw(init, grads, bf16, wd)
    assert o._step_count == STEPS
    for got, want in ((tm, jm), (tv, jv)):
        assert got.dtype == torch.float32
        _close(got, want)
    if bf16:
        assert tp.dtype == torch.bfloat16 and tmaster.dtype == torch.float32
        _close(tmaster, jmaster)
        np.testing.assert_allclose(tp.float().numpy(), jp, rtol=2 ** -8,
                                   atol=0)
        # the bf16 parameter is its master rounded
        assert torch.equal(tp, tmaster.to(torch.bfloat16))
    else:
        _close(tp, jp)
    # the parameters moved
    assert not np.allclose(tp.float().numpy(), init)


@pytest.mark.parametrize("bf16,multi", [(False, False), (True, True),
                                        (True, False)],
                         ids=["f32", "bf16_master", "bf16_fallback"])
@pytest.mark.parametrize("wd", [0.01, 0.0], ids=["decay", "no_decay"])
def test_fused_step_is_bitwise_the_eager_chain(bf16, multi, wd):
    """``fused=True`` routes every f32 update through ``adamw_step_multi``;
    on the CPU a bf16 parameter without a master has no f32 update and
    falls back to the eager chain per tensor (on the card it raises:
    see below). Either way the result is bitwise the ``fused=False``
    one."""
    init, grads = _data(7)
    dt = torch.bfloat16 if bf16 else torch.float32
    outs = []
    for fused in (True, False):
        p = torch.nn.Parameter(torch.tensor(init).to(dt))
        o = AdamW(learning_rate=1e-2, parameters=[p], weight_decay=wd,
                  multi_precision=multi, fused=fused)
        for g in grads:
            p.grad = torch.tensor(g).to(dt)
            o.step()
        st = o._states[id(p)]
        outs.append([p.detach()] + [t for t in (
            st.get("master"), st.get("inner", st)["m"],
            st.get("inner", st)["v"]) if t is not None])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _l1(coeff):
    return paddle.regularizer.L1Decay(coeff)


def test_fused_step_l1_decay_falls_back_on_the_cpu():
    """The kernel implements l2 decay only: with l1 every CPU tensor
    takes the eager chain, bitwise the ``fused=False`` result."""
    init, grads = _data(8)
    outs = []
    for fused in (True, False):
        p = torch.nn.Parameter(torch.tensor(init))
        o = AdamW(learning_rate=1e-2, parameters=[p], weight_decay=_l1(0.05),
                  fused=fused)
        assert o._weight_decay == ("l1", 0.05)
        for g in grads:
            p.grad = torch.tensor(g)
            o.step()
        outs.append(p.detach())
    assert torch.equal(*outs)
    assert not torch.equal(outs[0], torch.tensor(init))


@pytest.mark.parametrize("dtype,wd,why", [
    (torch.bfloat16, 0.01, "f32 update"),
    (torch.float32, _l1(0.01), "l1 decay")], ids=["bf16_no_master", "l1"])
def test_fused_step_off_the_cpu_never_falls_back(dtype, wd, why):
    """Off the CPU, a tensor the fused kernel does not take raises
    rather than running the eager chain. ``meta`` tensors stand in for
    the card's here: the routing reads only the device type."""
    p = torch.nn.Parameter(torch.empty(SHAPE, dtype=dtype, device="meta"))
    o = AdamW(learning_rate=1e-2, parameters=[p], weight_decay=wd,
              fused=True)
    p.grad = torch.empty(SHAPE, dtype=dtype, device="meta")
    with pytest.raises(NotImplementedError, match=why):
        o.step()


def test_cpu_step_launches_no_kernel():
    before = fused_adamw.adamw_step.launches
    init, grads = _data(3)
    _torch_adamw(init, grads[:2], False, 0.01, fused=True)
    assert fused_adamw.adamw_step.launches == before


def test_staged_scalars_are_f32():
    sc = fused_adamw.stage_scalars(1e-4, 0.9, 0.999, 1e-8, 0.01, 3)
    assert sc.om1 == float(np.float32(1 - 0.9))
    assert sc.bc1 == float(np.float32(1) - np.float32(0.9) ** np.float32(3))
    assert all(x == float(np.float32(x)) for x in sc)


def test_adam_has_no_decay_and_adamw_decays():
    init, grads = _data(4)
    pa = torch.nn.Parameter(torch.tensor(init))
    pw = torch.nn.Parameter(torch.tensor(init))
    oa = Adam(learning_rate=1e-2, parameters=[pa])
    ow = AdamW(learning_rate=1e-2, parameters=[pw], weight_decay=0.5)
    for g in grads[:3]:
        pa.grad = torch.tensor(g)
        pw.grad = torch.tensor(g)
        oa.step()
        ow.step()
    # decoupled decay pulls every weight toward zero by lr*wd*p a step
    assert (pw.abs() < pa.abs()).float().mean() > 0.9


def test_state_dict_round_trip_and_clear_grad():
    init, grads = _data(5)
    p = torch.nn.Parameter(torch.tensor(init))
    o = AdamW(learning_rate=1e-2, parameters=[p])
    p.grad = torch.from_numpy(grads[0])
    o.step()
    sd = o.state_dict()
    assert sd["_step_count"] == 1 and set(sd["param_0"]) == {"m", "v"}
    m_before = o._states[id(p)]["m"].clone()
    p.grad = torch.from_numpy(grads[1])
    o.step()
    o.set_state_dict(sd)
    assert o._step_count == 1
    assert torch.equal(o._states[id(p)]["m"], m_before)
    o.clear_grad()
    assert p.grad is None


def test_param_groups_and_skipped_params():
    a = torch.nn.Parameter(torch.ones(3))
    b = torch.nn.Parameter(torch.ones(3))
    o = AdamW(learning_rate=1e-2, parameters=[{"params": [a]},
                                             {"params": [b]}])
    a.grad = torch.ones(3)
    o.step()                     # b has no grad: the eager step skips it
    assert not torch.equal(a, torch.ones(3))
    assert torch.equal(b, torch.ones(3)) and id(b) not in o._states


@pytest.mark.parametrize("kwargs", [dict(grad_clip=object()),
                                    dict(learning_rate=lambda step: 1e-3)])
def test_unported_options_raise(kwargs):
    args = dict(learning_rate=1e-3, parameters=[torch.nn.Parameter(
        torch.ones(2))])
    args.update(kwargs)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        AdamW(**args)


def _named_parameters(cls):
    """(name, default) of each named parameter of ``cls.__init__`` in
    order; the JAX base's trailing ``**kwargs`` is not a parameter."""
    return [(n, p.default) for n, p in
            inspect.signature(cls.__init__).parameters.items()
            if n != "self" and p.kind != inspect.Parameter.VAR_KEYWORD]


@pytest.mark.parametrize("name", ["Optimizer", "Momentum", "Adam", "AdamW"])
def test_signatures_match_the_reference(name):
    """The port's constructors take the JAX package's parameters, with
    its defaults, in its positional order (``fused`` last, as there)."""
    port = {"Optimizer": Optimizer, "Momentum": Momentum, "Adam": Adam,
            "AdamW": AdamW}[name]
    assert _named_parameters(port) == _named_parameters(getattr(jopt, name))


@pytest.mark.parametrize("cls", [Momentum, Adam, AdamW])
def test_name_is_taken_and_kept(cls):
    p = torch.nn.Parameter(torch.ones(2))
    o = cls(learning_rate=1e-3, parameters=[p], name="opt")
    assert o._name == "opt"
    p.grad = torch.ones(2)
    o.step()
    assert not torch.equal(p, torch.ones(2))


def test_positional_arguments_bind_as_in_the_reference():
    """AdamW's 7th positional argument is ``lr_ratio`` and Adam's 8th
    ``lazy_mode``, as in the JAX package; a set one raises."""
    params = [torch.nn.Parameter(torch.ones(2))]
    with pytest.raises(NotImplementedError, match="lr_ratio"):
        AdamW(1e-3, 0.9, 0.999, 1e-8, params, 0.01, 0.5)
    with pytest.raises(NotImplementedError, match="lazy_mode"):
        Adam(1e-3, 0.9, 0.999, 1e-8, params, None, None, True)
    o = AdamW(1e-3, 0.9, 0.999, 1e-8, params, 0.01, None, None, None,
              False, True, "o")
    assert o._multi_precision is True and o._name == "o"


@pytest.mark.parametrize("cls,kwargs", [
    (Adam, dict(lazy_mode=True)), (Adam, dict(amsgrad=True)),
    (AdamW, dict(lazy_mode=True)), (AdamW, dict(amsgrad=True)),
    (AdamW, dict(lr_ratio=lambda p: 1.0)),
    (AdamW, dict(apply_decay_param_fun=lambda n: True))],
    ids=["adam-lazy_mode", "adam-amsgrad", "adamw-lazy_mode",
         "adamw-amsgrad", "adamw-lr_ratio", "adamw-apply_decay_param_fun"])
def test_unported_reference_options_raise(cls, kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 2"):
        cls(learning_rate=1e-3, parameters=[torch.nn.Parameter(
            torch.ones(2))], **kwargs)
