"""The port's Momentum and its fused step (paddle2_tpu_torch.optimizer.
Momentum, paddle2_tpu_torch.kernels.fused_momentum) held against the JAX
package on the same numpy parameters and gradients: the plain step
against the Pallas kernel (``pallas_fused.fused_momentum_step`` in
interpret mode on the CPU), the optimizer against the JAX ``Momentum``
over 10 steps (eager, ``fused=True`` and ``FLAGS_fused_optimizer_step``
routes on both sides), the fused route against the eager chain bitwise,
and the wrapper's path to its C entry (a stand-in library records the
call, as there is no card here).

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
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle2_tpu as paddle
import paddle2_tpu.optimizer as jopt
from paddle2_tpu import flags as jflags
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
    """Records the C entries' arguments in place of the built library."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        return lambda *args: self.calls.append((entry, args)) or 0


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_wrapper_reaches_its_c_entry(monkeypatch, variant):
    """With the wrapper told its tensors are on the card, the fused
    optimizer step calls ``momentum_step`` in the library once a
    parameter, with the tensors' pointers, their length, the f32-staged
    ``lr``/``momentum``/``weight_decay`` and the Nesterov and decay
    switches, and counts one launch; the plain version does not run."""
    lib = _StandInLibrary()
    monkeypatch.setattr(_build, "on_card", lambda what, *t: True)
    monkeypatch.setattr(_build, "library", lambda name, sigs: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(fm, "momentum_step_reference",
                        lambda *a: pytest.fail("the plain version ran"))
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
    f32 = lambda x: float(np.float32(x))
    assert lib.calls == [("momentum_step", (
        p.data_ptr(), p.grad.data_ptr(), v.data_ptr(), p.numel(), f32(LR),
        f32(MOM), f32(wd), int(nesterov), int(wd != 0), None))]


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
