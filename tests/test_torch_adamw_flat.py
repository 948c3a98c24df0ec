"""The port's flat AdamW (paddle2_tpu_torch.kernels.fused_adamw.
adamw_flat, and incubate.nn.functional.fused_adamw_kernel over it) held
against the JAX package on the same numpy state: the plain version
against the Pallas kernel (``pallas_fused.fused_adamw`` in interpret
mode on the CPU) for one and for ten steps, with f32 and bf16 params and
grads and with m/v given in bf16 (they come back f32); the public
function against ``paddle2_tpu.incubate.nn.functional.
fused_adamw_kernel``; and the wrapper's path to its C entry (a stand-in
library records the call, as there is no card here).

Tolerances. Both sides run the same f32 op order, but XLA may contract
a product and a sum into one rounding where torch rounds twice: each f32
result to 1e-6 of its largest magnitude, also after 10 steps; a bf16
param to one bf16 rounding step (2**-8 relative) of the master it is
cast from, and equal to that cast.
"""

import contextlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle2_tpu as paddle
from paddle2_tpu.incubate.nn import functional as JF
from paddle2_tpu.kernels import pallas_fused
from paddle2_tpu_torch.incubate.nn import functional as TF
from paddle2_tpu_torch.kernels import _build
from paddle2_tpu_torch.kernels import fused_adamw as fa

SHAPE = (37, 129)
HP = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _state(seed):
    rng = np.random.default_rng(seed)
    master = rng.normal(size=SHAPE).astype(np.float32)
    m = (rng.normal(size=SHAPE) * 0.1).astype(np.float32)
    v = np.abs(rng.normal(size=SHAPE) * 0.01).astype(np.float32)
    grads = [rng.normal(size=SHAPE).astype(np.float32) for _ in range(10)]
    return master, m, v, grads


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    lim = 1e-6 * max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= lim, (what,
                                            np.abs(got - want).max(), lim)


CASES = [(p, mv) for p in (torch.float32, torch.bfloat16)
         for mv in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("pdt,mvdt", CASES,
                         ids=[f"p{str(p)[6:]}-mv{str(m)[6:]}"
                              for p, m in CASES])
def test_plain_version_tracks_the_pallas_kernel_for_ten_steps(pdt, mvdt):
    """Ten steps from one state: params and grads in ``pdt``, m and v
    given in ``mvdt`` at the first step (they come back f32 on both
    sides), the master f32."""
    master, m, v, grads = _state(1)
    jm, jv = (jnp.asarray(a, JDT[mvdt]) for a in (m, v))
    tm, tv = (torch.tensor(a).to(mvdt) for a in (m, v))
    jw, tw = jnp.asarray(master), torch.tensor(master)
    jp, tp = jnp.asarray(master, JDT[pdt]), torch.tensor(master).to(pdt)
    for step, g in enumerate(grads, start=1):
        jp, jm, jv, jw = pallas_fused.fused_adamw(
            jp, jnp.asarray(g, JDT[pdt]), jm, jv, jw, step=step,
            interpret=True, **HP)
        tp, tm, tv, tw = fa.fused_adamw(tp, torch.tensor(g).to(pdt), tm, tv,
                                        tw, step=step, **HP)
        assert tp.dtype == pdt and tp.shape == SHAPE
        assert tm.dtype == tv.dtype == tw.dtype == torch.float32
        if step == 1:
            for what, t, j in (("m", tm, jm), ("v", tv, jv),
                               ("master", tw, jw)):
                _close(t.numpy(), np.asarray(j), f"{what} after one step")
    for what, t, j in (("m", tm, jm), ("v", tv, jv), ("master", tw, jw)):
        _close(t.numpy(), np.asarray(j), what)
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    if pdt == torch.bfloat16:
        np.testing.assert_allclose(tp.float().numpy(), f32(jp),
                                   rtol=2 ** -8, atol=0)
        assert torch.equal(tp, tw.to(torch.bfloat16))
    else:
        _close(tp.numpy(), f32(jp), "param")


def test_the_param_is_not_read():
    """The param fixes only the output's dtype and shape: two params of
    different values give the same step."""
    master, m, v, grads = _state(2)
    args = [torch.tensor(a) for a in (grads[0], m, v, master)]
    a = fa.fused_adamw(torch.zeros(SHAPE), *args, **HP, step=3)
    b = fa.fused_adamw(torch.full(SHAPE, 7.0), *args, **HP, step=3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_scalars_are_staged_as_the_pallas_wrapper_stages_them():
    """``1 - b`` is the kernel's f32 subtraction, not the rounding of the
    Python double (the eager AdamW's constant): they differ for 0.9."""
    sc = fa.stage_flat_scalars(1e-3, 0.9, 0.999, 1e-8, 0.01, 5)
    f = np.float32
    assert sc.om1 == float(f(1) - f(0.9)) != float(f(1 - 0.9))
    assert sc.bc2 == float(f(1) - f(0.999) ** f(5))


def test_public_function_matches_jax():
    """``fused_adamw_kernel`` with a bf16 param and grad: four new
    tensors (param in its dtype, m, v and master f32) that do not
    require gradients, equal to the JAX function's."""
    master, m, v, grads = _state(3)
    p = torch.nn.Parameter(torch.tensor(master).to(torch.bfloat16))
    outs = TF.fused_adamw_kernel(p, torch.tensor(grads[0]).to(
        torch.bfloat16), torch.tensor(m), torch.tensor(v),
        torch.tensor(master), 1e-3, step=2)
    jouts = JF.fused_adamw_kernel(
        paddle.to_tensor(master).astype("bfloat16"),
        paddle.to_tensor(grads[0]).astype("bfloat16"), paddle.to_tensor(m),
        paddle.to_tensor(v), paddle.to_tensor(master), 1e-3, step=2)
    assert len(outs) == len(jouts) == 4
    assert [t.dtype for t in outs] == [torch.bfloat16] + [torch.float32] * 3
    assert not any(t.requires_grad for t in outs)
    for what, t, j in zip(("m", "v", "master"), outs[1:], jouts[1:]):
        _close(t.numpy(), np.asarray(j.numpy()), what)
    np.testing.assert_allclose(outs[0].float().numpy(),
                               np.asarray(jouts[0].astype("float32").numpy()),
                               rtol=2 ** -8, atol=0)


class _StandInLibrary:
    """Records the C entries' arguments in place of the built library."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        return lambda *args: self.calls.append((entry, args)) or 0


@pytest.fixture
def card(monkeypatch):
    """The wrapper told its tensors are on the card, with a stand-in
    library in place of the built one; the plain version must not run."""
    lib = _StandInLibrary()
    monkeypatch.setattr(_build, "on_card", lambda what, *t: True)
    monkeypatch.setattr(_build, "library", lambda name, sigs: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(fa, "adamw_flat_reference",
                        lambda *a: pytest.fail("the plain version ran"))
    return lib


def _offset(t):
    """A contiguous view of ``t``'s values one element past a 16-byte
    boundary."""
    buf = torch.zeros(t.numel() + 8, dtype=t.dtype)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


def test_wrapper_reaches_its_c_entry(card):
    """One call on tensors that start on 16-byte boundaries reaches the
    vector route's entry ``adamw_flat_vec`` in the library once, with the
    grad, m, v and master pointers (m and v given in bf16 are widened to
    f32 first), four new outputs, the length, the p and g dtype codes
    and the staged scalars, and counts one launch on the "vec" route;
    the plain version does not run."""
    lib = card
    p, g = (torch.zeros(SHAPE, dtype=torch.bfloat16) for _ in range(2))
    m, v = (torch.zeros(SHAPE, dtype=torch.bfloat16) for _ in range(2))
    master = torch.zeros(SHAPE)
    before = fa.adamw_flat.launches
    routes = dict(fa.adamw_flat.route_launches)
    outs = TF.fused_adamw_kernel(p, g, m, v, master, 1e-3, step=4)
    assert fa.adamw_flat.launches == before + 1
    assert fa.adamw_flat.route_launches == dict(routes,
                                                vec=routes["vec"] + 1)
    ((entry, args),) = lib.calls
    sc = fa.stage_flat_scalars(1e-3, 0.9, 0.999, 1e-8, 0.01, 4)
    assert entry == "adamw_flat_vec"
    assert args[0] == g.data_ptr() and args[3] == master.data_ptr()
    assert args[1] not in (m.data_ptr(), v.data_ptr())   # widened copies
    assert args[4:8] == tuple(t.data_ptr() for t in outs)
    assert args[8:] == (p.numel(), 1, 1, *sc, None)


@pytest.mark.parametrize("bad", ["size", "dtype", "layout"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    t = [torch.zeros(4, 8) for _ in range(5)]
    if bad == "size":
        t[2] = torch.zeros(4, 9)
    elif bad == "dtype":
        t[1] = t[1].double()
    else:
        t[3] = torch.zeros(8, 4).t()
    with pytest.raises(ValueError):
        fa.adamw_flat(*t, fa.stage_flat_scalars(1e-3, 0.9, 0.999, 1e-8,
                                                0.01, 1))


@pytest.mark.parametrize("which", ["grad", "m", "v", "master"])
@pytest.mark.parametrize("pdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_an_offset_view_takes_the_general_entry(card, which, pdt):
    """One input one element past a 16-byte boundary (an offset view of
    a larger buffer) sends the call to the general route's entry
    ``adamw_flat`` with that view's pointer, and counts one launch on
    the "general" route; the other three inputs and the outputs are as
    on the vector route."""
    lib = card
    master = torch.zeros(SHAPE)
    t = dict(grad=torch.zeros(SHAPE, dtype=pdt), m=torch.zeros(SHAPE),
             v=torch.zeros(SHAPE), master=master)
    t[which] = _offset(t[which])
    routes = dict(fa.adamw_flat.route_launches)
    outs = fa.adamw_flat(torch.zeros(SHAPE, dtype=pdt), t["grad"], t["m"],
                         t["v"], t["master"],
                         fa.stage_flat_scalars(1e-3, 0.9, 0.999, 1e-8,
                                               0.01, 2))
    assert fa.adamw_flat.route_launches == dict(
        routes, general=routes["general"] + 1)
    ((entry, args),) = lib.calls
    assert entry == "adamw_flat"
    assert args[:4] == tuple(t[k].data_ptr()
                             for k in ("grad", "m", "v", "master"))
    assert args[4:8] == tuple(o.data_ptr() for o in outs)
    assert args[8:11] == (t["grad"].numel(), fa._DTYPE_CODE[pdt],
                          fa._DTYPE_CODE[pdt])


def test_route_rule():
    """"vec" only when every tensor starts on a 16-byte boundary."""
    a = torch.zeros(64)
    assert fa.flat_route(a, a[4:], a[8:]) == "vec"
    assert fa.flat_route(a, a[1:]) == "general"
    assert fa.flat_route(a[2:], a) == "general"
    assert set(fa.FLAT_ROUTES) == set(fa.adamw_flat.route_launches)


@pytest.mark.parametrize("N", [1, 7, 8, 513, 4099])
@pytest.mark.parametrize("pdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_version_tracks_the_pallas_kernel_at_odd_sizes(N, pdt):
    """The plain version (what both routes are held to bitwise on the
    card) against ``pallas_fused.fused_adamw`` in interpret mode at sizes
    around the vector route's 8-element steps, on offset views: each f32
    result to 1e-6 of its largest magnitude, as above (XLA contracts
    some products and sums, so the two are not bitwise equal), p equal
    to the master rounded."""
    rng = np.random.default_rng(N)
    master = rng.normal(size=N).astype(np.float32)
    g = rng.normal(size=N).astype(np.float32)
    m = (rng.normal(size=N) * 0.1).astype(np.float32)
    v = np.abs(rng.normal(size=N) * 0.01).astype(np.float32)
    jp, jm, jv, jw = pallas_fused.fused_adamw(
        jnp.asarray(master, JDT[pdt]), jnp.asarray(g, JDT[pdt]),
        jnp.asarray(m), jnp.asarray(v), jnp.asarray(master), step=3,
        interpret=True, **HP)
    tg = _offset(torch.tensor(g).to(pdt))
    tm, tv, tw = (_offset(torch.tensor(a)) for a in (m, v, master))
    tp, tm2, tv2, tw2 = fa.fused_adamw(torch.zeros(N, dtype=pdt), tg, tm,
                                       tv, tw, step=3, **HP)
    for what, t, j in (("m", tm2, jm), ("v", tv2, jv), ("master", tw2, jw)):
        _close(t.numpy(), np.asarray(j), what)
    assert torch.equal(tp, tw2.to(pdt))
