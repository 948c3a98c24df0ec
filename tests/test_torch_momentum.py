"""The port's Momentum and its fused step (paddle2_tpu_torch.optimizer.
Momentum, paddle2_tpu_torch.kernels.fused_momentum) held against the JAX
package on the same numpy parameters and gradients: the plain step
against the Pallas kernel (``pallas_fused.fused_momentum_step`` in
interpret mode on the CPU), the multi-tensor step's plain version
against it leaf by leaf on a list that mixes f32 tensors with bf16 ones
that have f32 masters, the optimizer against the JAX ``Momentum`` over
10 steps (eager, ``fused=True`` and ``FLAGS_fused_optimizer_step``
routes on both sides, and a mixed O2 list), the fused route against the
eager chain bitwise, the wrapper's path to its C entry (a stand-in
library records the call and its descriptor table, as there is no card
here: one call a step), and the raise on the card for what the kernel
does not take.

Tolerances. Against JAX, 1e-6 of each f32 result's largest magnitude:
the op order is the same, but XLA contracts a multiply and an add (say
``mom*v + g``) into one rounding inside its fused program, the
interpreted Pallas kernel's included, where torch rounds twice (the
plain step reads up to 2.4e-7 apart on values up to ~4.5; elements that
cancel to near zero make a per-element relative tolerance meaningless);
after 10 optimizer steps the same bound holds; a bf16 parameter to one bf16
rounding step (2**-8 relative) of the master it is cast from. The fused
route against the eager chain: bitwise, on the CPU here (the kernel's
plain version) and on the card in chip_smoke.py (the CUDA kernel).
"""

import contextlib
import ctypes
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle2_tpu as paddle
import paddle2_tpu.optimizer as jopt
from paddle2_tpu import flags as jflags
from paddle2_tpu.framework.tensor import Parameter
from paddle2_tpu.kernels import pallas_fused
from paddle2_tpu_torch import flags
from paddle2_tpu_torch.kernels import _build
from paddle2_tpu_torch.kernels import fused_momentum as fm
from paddle2_tpu_torch.optimizer import Momentum

STEPS = 10
SHAPE = (6, 40)
LR, MOM = 0.1, 0.9
# (nesterov, L2 weight decay)
VARIANTS = {"plain": (False, 0.0), "nesterov": (True, 0.0),
            "l2": (False, 1e-2), "nesterov_l2": (True, 1e-2)}


ROUTES = [("eager", False, False), ("fused", True, False),
          ("flag", None, True)]


@pytest.fixture(params=ROUTES, ids=[r[0] for r in ROUTES])
def route(request):
    """The ``fused=`` argument of a route, with
    ``FLAGS_fused_optimizer_step`` set in both packages as the route
    asks and restored after the test (the flags are process-global)."""
    _, fused, flag_on = request.param
    before = (jflags.get_flags("FLAGS_fused_optimizer_step"),
              flags.get_flags("fused_optimizer_step"))
    jflags.set_flags({"FLAGS_fused_optimizer_step": flag_on})
    flags.set_flags({"fused_optimizer_step": flag_on})
    yield fused
    jflags.set_flags(before[0])
    flags.set_flags(before[1])


def _data(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    init = rng.normal(size=shape).astype(np.float32)
    grads = [(rng.normal(size=shape) * 0.1).astype(np.float32)
             for _ in range(STEPS)]
    return init, grads


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_step_matches_the_pallas_kernel(variant):
    nesterov, wd = VARIANTS[variant]
    rng = np.random.default_rng(1)
    p, g, v = (rng.normal(size=(37, 129)).astype(np.float32)
               for _ in range(3))
    jp, jv = pallas_fused.fused_momentum_step(
        jnp.asarray(p), jnp.asarray(g), jnp.asarray(v),
        jnp.asarray(LR, jnp.float32), momentum=MOM, nesterov=nesterov,
        weight_decay=wd, interpret=True)
    tp, tg, tv = (torch.from_numpy(a.copy()) for a in (p, g, v))
    fm.momentum_step_reference(tp, tg, tv, LR, MOM, nesterov, wd)
    _close(tp, np.asarray(jp))
    _close(tv, np.asarray(jv))
    assert torch.equal(tg, torch.from_numpy(g))      # g is only read


def _jax_momentum(init, grads, bf16, nesterov, wd, fused):
    p = paddle.to_tensor(init, stop_gradient=False)
    if bf16:
        p._replace_data(p._data.astype(paddle.bfloat16))
    o = jopt.Momentum(learning_rate=LR, momentum=MOM, parameters=[p],
                      use_nesterov=nesterov, weight_decay=wd or None,
                      multi_precision=True, fused=fused)
    for g in grads:
        gt = paddle.to_tensor(g)
        p.grad = gt.astype("bfloat16") if bf16 else gt
        o.step()
    st = o._states[id(p)]
    f = lambda t: np.asarray(t, np.float32)
    return (f(p._data), f(st["master"]) if bf16 else None,
            f((st["inner"] if bf16 else st)["velocity"]))


def _torch_momentum(init, grads, bf16, nesterov, wd, fused, multi=True):
    dt = torch.bfloat16 if bf16 else torch.float32
    p = torch.nn.Parameter(torch.tensor(init).to(dt))
    o = Momentum(learning_rate=LR, momentum=MOM, parameters=[p],
                 use_nesterov=nesterov, weight_decay=wd or None,
                 multi_precision=multi, fused=fused)
    for g in grads:
        p.grad = torch.tensor(g).to(dt)
        o.step()
    st = o._states[id(p)]
    inner = st["inner"] if "master" in st else st
    return p.detach(), st.get("master"), inner["velocity"]


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16_master"])
@pytest.mark.parametrize("variant", ["plain", "nesterov_l2"])
def test_momentum_matches_jax(route, bf16, variant):
    """10 steps of the port's Momentum against the JAX package's on the
    same route (``fused=None`` with the flag on, on both sides, for
    "flag")."""
    nesterov, wd = VARIANTS[variant]
    init, grads = _data(2 + int(bf16))
    jp, jmaster, jv = _jax_momentum(init, grads, bf16, nesterov, wd, route)
    tp, tmaster, tv = _torch_momentum(init, grads, bf16, nesterov, wd, route)
    _close(tv, jv)
    assert tv.dtype == torch.float32               # f32 under multi_precision
    if bf16:
        _close(tmaster, jmaster)
        np.testing.assert_allclose(tp.float().numpy(), jp, rtol=2 ** -8,
                                   atol=0)
        assert torch.equal(tp, tmaster.to(torch.bfloat16))
    else:
        _close(tp, jp)


@pytest.mark.parametrize("bf16,multi", [(False, False), (False, True),
                                        (True, True), (True, False)],
                         ids=["f32", "f32_multi", "bf16_master",
                              "bf16_fallback"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_fused_step_is_bitwise_the_eager_chain(bf16, multi, variant):
    """``fused=True`` routes every f32 update through ``momentum_step``;
    on the CPU a bf16 parameter without a master has no f32 update and
    falls back to the eager chain per tensor (on the card it raises: see
    below). Either way the result is bitwise the ``fused=False`` one."""
    nesterov, wd = VARIANTS[variant]
    init, grads = _data(7)
    outs = [_torch_momentum(init, grads, bf16, nesterov, wd, fused, multi)
            for fused in (True, False)]
    for a, b in zip(*outs):
        assert (a is None and b is None) or torch.equal(a, b)
    assert outs[0][2].dtype == (torch.float32 if multi or not bf16
                                else torch.bfloat16)


def test_fused_step_off_the_cpu_never_falls_back():
    """Off the CPU, a bf16 parameter without a master (no f32 update)
    raises rather than running the eager chain. ``meta`` tensors stand
    in for the card's here: the routing reads only the device type."""
    p = torch.nn.Parameter(torch.empty(SHAPE, dtype=torch.bfloat16,
                                       device="meta"))
    o = Momentum(learning_rate=LR, parameters=[p], fused=True)
    p.grad = torch.empty(SHAPE, dtype=torch.bfloat16, device="meta")
    with pytest.raises(NotImplementedError, match="f32 update"):
        o.step()


class _StandInLibrary:
    """Records the C entry's arguments in place of the built library,
    with a copy of the descriptor table its first argument points at
    (the wrapper's numpy records, alive during the call)."""

    def __init__(self):
        self.calls = []

    def momentum_step_multi(self, descs, count, *rest):
        table = np.frombuffer(
            (ctypes.c_char * (count * fm._DESC.itemsize)).from_address(descs),
            dtype=fm._DESC).copy()
        self.calls.append((table, rest))
        return 0


@pytest.fixture
def stand_in(monkeypatch):
    """The wrappers told their tensors are on the card, the library
    replaced by a recorder, and the plain version failing if it runs."""
    lib = _StandInLibrary()
    monkeypatch.setattr(_build, "on_card", lambda what, *t: True)
    monkeypatch.setattr(_build, "library", lambda name, sigs: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(fm, "momentum_step_reference",
                        lambda *a: pytest.fail("the plain version ran"))
    return lib


def _f32(x):
    return float(np.float32(x))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_wrapper_reaches_its_c_entry(stand_in, variant):
    """With the wrapper told its tensors are on the card, the fused
    optimizer step calls ``momentum_step_multi`` in the library once,
    with a one-record table (the tensors' pointers, their length, the
    f32-staged ``weight_decay``, the f32 dtype codes and no low
    parameter), the f32-staged ``lr``/``momentum`` and the Nesterov
    switch, and counts one launch; the plain version does not run."""
    nesterov, wd = VARIANTS[variant]
    p = torch.nn.Parameter(torch.ones(SHAPE))
    o = Momentum(learning_rate=LR, momentum=MOM, parameters=[p],
                 use_nesterov=nesterov, weight_decay=wd or None,
                 fused=True)
    p.grad = torch.ones(SHAPE)
    before = fm.momentum_step.launches
    o.step()
    assert fm.momentum_step.launches == before + 1
    v = o._states[id(p)]["velocity"]
    [(table, rest)] = stand_in.calls
    assert table.tolist() == [(p.data_ptr(), v.data_ptr(),
                               p.grad.data_ptr(), 0, p.numel(), _f32(wd),
                               0)]
    assert rest == (_f32(LR), _f32(MOM), int(nesterov), None)


def _mixed_params(rng, n_f32=3, n_bf16=3):
    """f32 and bf16 parameters of several shapes, every other one
    without weight decay (BatchNorm-like vectors among them)."""
    shapes = [(5, 7), (64,), (3, 4, 5), (129,), (2, 40), (1,)]
    out = []
    for i in range(n_f32 + n_bf16):
        t = torch.tensor(rng.normal(size=shapes[i % len(shapes)])
                         .astype(np.float32))
        if i >= n_f32:
            t = t.to(torch.bfloat16)
        p = torch.nn.Parameter(t)
        p.no_weight_decay = i % 2 == 1
        out.append(p)
    return out


def test_one_c_call_a_step_records_every_tensor(stand_in):
    """A mixed O2 list (f32 parameters, bf16 parameters with f32
    masters, L2 decay on every other tensor) makes one C call a step
    whose table holds each tensor once: the master (or the f32
    parameter) as work, its velocity, its gradient in the stored dtype,
    the bf16 parameter as the low copy, its length, its own ``wd`` and
    the dtype codes."""
    params = _mixed_params(np.random.default_rng(0))
    o = Momentum(learning_rate=LR, momentum=MOM, parameters=params,
                 weight_decay=1e-2, multi_precision=True, fused=True)
    before = fm.momentum_step.launches
    for step in range(2):
        for p in params:
            p.grad = torch.ones_like(p)
        o.step()
        assert len(stand_in.calls) == step + 1
    assert fm.momentum_step.launches == before + 2
    table, rest = stand_in.calls[-1]
    assert rest == (_f32(LR), _f32(MOM), 0, None)
    want = []
    for p in params:
        st = o._states[id(p)]
        bf16 = p.dtype == torch.bfloat16
        work = st["master"] if bf16 else p
        v = (st["inner"] if bf16 else st)["velocity"]
        want.append((work.data_ptr(), v.data_ptr(), p.grad.data_ptr(),
                     p.data_ptr() if bf16 else 0, p.numel(),
                     0.0 if p.no_weight_decay else _f32(1e-2),
                     (1 | 1 << 8) if bf16 else 0))
    assert table.tolist() == want


def test_a_long_list_takes_one_launch_per_table(stand_in):
    n = fm.MAX_TENSORS + 3
    ts = [torch.zeros(2) for _ in range(3 * n)]
    fm.momentum_step_multi(ts[:n], ts[n:2 * n], ts[2 * n:], [None] * n,
                           [0.0] * n, LR, MOM)
    assert [len(t) for t, _ in stand_in.calls] == [fm.MAX_TENSORS, 3]


@pytest.mark.parametrize("why", ["l1", "non_contiguous"])
def test_fused_step_on_the_card_raises_for_what_the_kernel_does_not_take(
        why):
    """Off the CPU (``meta`` tensors stand in for the card's, as in
    ``test_fused_step_off_the_cpu_never_falls_back``), l1 decay and a
    non-contiguous parameter raise rather than run the eager chain."""
    t = torch.empty(SHAPE, device="meta")
    if why == "non_contiguous":
        t = torch.empty(SHAPE[::-1], device="meta").t()
    p = torch.nn.Parameter(t)
    wd = paddle.regularizer.L1Decay(1e-2) if why == "l1" else None
    o = Momentum(learning_rate=LR, parameters=[p], weight_decay=wd,
                 fused=True)
    p.grad = torch.empty_like(p)
    with pytest.raises(NotImplementedError,
                       match="l1 decay" if why == "l1" else "contiguous"):
        o.step()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_multi_plain_matches_the_pallas_kernel_leaf_by_leaf(variant):
    """``momentum_step_multi``'s plain version over a list that mixes
    f32 tensors with bf16 tensors that have f32 masters, L2 decay per
    tensor (every other tensor none), against
    ``pallas_fused.fused_momentum_step(interpret=True)`` on each leaf (the
    JAX fused route: the master and the widened gradient in, the new
    master cast to bf16 after): the f32 results within the module's
    1e-6 of the largest magnitude (XLA contracts a multiply and an add
    inside the interpreted kernel, so bitwise is out of reach there),
    bitwise the per-leaf plain step, and each bf16 parameter bitwise the
    cast of its new master."""
    nesterov, wd = VARIANTS[variant]
    rng = np.random.default_rng(4)
    shapes = [(37, 129), (64,), (5, 3), (1000,)]
    works, grads, vels, lows, wds, want = [], [], [], [], [], []
    for i, sh in enumerate(shapes):
        p, g, v = (rng.normal(size=sh).astype(np.float32) for _ in range(3))
        bf16 = i % 2 == 0
        if bf16:
            g = np.asarray(torch.tensor(g).to(torch.bfloat16).float())
        wd_i = wd if i % 3 != 1 else 0.0
        jp, jv = pallas_fused.fused_momentum_step(
            jnp.asarray(p), jnp.asarray(g), jnp.asarray(v),
            jnp.asarray(LR, jnp.float32), momentum=MOM, nesterov=nesterov,
            weight_decay=wd_i, interpret=True)
        tp, tv = torch.tensor(p), torch.tensor(v)
        tg = torch.tensor(g).to(torch.bfloat16) if bf16 else torch.tensor(g)
        lp, lv = tp.clone(), tv.clone()
        fm.momentum_step_reference(lp, tg, lv, LR, MOM, nesterov, wd_i)
        works.append(tp)
        grads.append(tg)
        vels.append(tv)
        lows.append(torch.empty(sh, dtype=torch.bfloat16) if bf16 else None)
        wds.append(wd_i)
        want.append((np.asarray(jp), np.asarray(jv), lp, lv))
    fm.momentum_step_multi(works, grads, vels, lows, wds, LR, MOM, nesterov)
    for w, v, lo, (jp, jv, lp, lv) in zip(works, vels, lows, want):
        _close(w, jp)
        _close(v, jv)
        assert torch.equal(w, lp) and torch.equal(v, lv)
        if lo is not None:
            assert torch.equal(lo, w.to(torch.bfloat16))


def _mixed_steps(init, grads, fused, nesterov, wd):
    """10 steps of the port's Momentum (multi_precision) on the mixed
    list ``init`` (numpy f32 values; the second half bf16)."""
    half = len(init) // 2
    params = []
    for i, a in enumerate(init):
        t = torch.tensor(a)
        p = torch.nn.Parameter(t.to(torch.bfloat16) if i >= half else t)
        p.no_weight_decay = i % 2 == 1
        params.append(p)
    o = Momentum(learning_rate=LR, momentum=MOM, parameters=params,
                 use_nesterov=nesterov, weight_decay=wd or None,
                 multi_precision=True, fused=fused)
    for step_grads in grads:
        for p, g in zip(params, step_grads):
            p.grad = torch.tensor(g).to(p.dtype)
        o.step()
    out = []
    for p in params:
        st = o._states[id(p)]
        master = st.get("master")
        inner = st["inner"] if master is not None else st
        out.append((p.detach(), master, inner["velocity"]))
    return out


def _jax_mixed_steps(init, grads, nesterov, wd):
    half = len(init) // 2
    params = []
    for i, a in enumerate(init):
        p = Parameter(a, dtype="bfloat16" if i >= half else None)
        p.no_weight_decay = i % 2 == 1
        params.append(p)
    o = jopt.Momentum(learning_rate=LR, momentum=MOM, parameters=params,
                      use_nesterov=nesterov, weight_decay=wd or None,
                      multi_precision=True, fused=True)
    for step_grads in grads:
        for i, (p, g) in enumerate(zip(params, step_grads)):
            gt = paddle.to_tensor(g)
            p.grad = gt.astype("bfloat16") if i >= half else gt
        o.step()
    f = lambda t: np.asarray(t, np.float32)
    out = []
    for i, p in enumerate(params):
        st = o._states[id(p)]
        inner = st["inner"] if i >= half else st
        out.append((f(p._data), f(st["master"]) if i >= half else None,
                    f(inner["velocity"])))
    return out


@pytest.mark.parametrize("variant", ["plain", "nesterov_l2"])
def test_fused_momentum_on_a_mixed_list(variant):
    """``Momentum(fused=True, multi_precision=True)`` on a list of f32
    and bf16 parameters (every other one ``no_weight_decay``): bitwise
    ``fused=False`` after 10 steps, and within the module's tolerance of
    the JAX ``Momentum`` on its fused route."""
    nesterov, wd = VARIANTS[variant]
    rng = np.random.default_rng(5)
    shapes = [(6, 40), (64,), (3, 5), (6, 40), (64,), (3, 5)]
    init = [rng.normal(size=sh).astype(np.float32) for sh in shapes]
    grads = [[(rng.normal(size=sh) * 0.1).astype(np.float32)
              for sh in shapes] for _ in range(STEPS)]
    fused = _mixed_steps(init, grads, True, nesterov, wd)
    eager = _mixed_steps(init, grads, False, nesterov, wd)
    for a, b in zip(fused, eager):
        for x, y in zip(a, b):
            assert (x is None and y is None) or torch.equal(x, y)
    for (tp, tmaster, tv), (jp, jmaster, jv) in zip(
            fused, _jax_mixed_steps(init, grads, nesterov, wd)):
        _close(tv, jv)
        if tmaster is None:
            _close(tp, jp)
        else:
            _close(tmaster, jmaster)
            np.testing.assert_allclose(tp.float().numpy(), jp, rtol=2 ** -8,
                                       atol=0)
            assert torch.equal(tp, tmaster.to(torch.bfloat16))


def test_cpu_step_launches_no_kernel():
    before = fm.momentum_step.launches
    init, grads = _data(3)
    _torch_momentum(init, grads[:2], False, False, 0.0, fused=True)
    assert fm.momentum_step.launches == before


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    p, g, v = (torch.zeros(4, 8) for _ in range(3))
    if bad == "shape":
        v = torch.zeros(4, 9)
    else:
        g = g.double()
    with pytest.raises(ValueError):
        fm.momentum_step(p, g, v, LR, MOM)
