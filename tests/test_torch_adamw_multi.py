"""The multi-tensor AdamW step (paddle2_tpu_torch.kernels.fused_adamw
``adamw_step_multi``, ``csrc/adamw_step.cu``) and the fused AdamW route
that gathers every tensor into it, held against the port's eager AdamW
and the JAX package on the same numpy parameters and gradients, on the
CPU, where the wrapper runs its plain version:

- the plain multi-tensor version over a mixed list (f32 parameters, bf16
  parameters with f32 masters, decay on and off per tensor) bitwise the
  eager AdamW;
- the same list leaf by leaf against ``pallas_fused.fused_adamw_step``
  in interpret mode (the JAX fused route: the master and the widened
  gradient in, the new master cast to bf16 after);
- ``AdamW(fused=True)`` on a mixed list against the JAX AdamW over 10
  steps;
- one C call a step through a stand-in library that copies the
  descriptor table it is given (each tensor's pointers, size, dtype
  codes and decay flag; the staged scalars as launch arguments), the
  table cache reused while the pointers hold and rebuilt when one
  changes, one launch per 256 tensors;
- on the card (``meta`` tensors stand in for the card's), what the
  kernel does not take raises rather than running the eager chain.

Tolerances (``tests/test_torch_optimizer.py``'s): against JAX, 1e-6 of
each f32 result's largest magnitude (the op order is the same; XLA may
contract a multiply and an add into one rounding, and numpy's and XLA's
f32 ``pow`` may differ in the last place); a bf16 parameter within one
bf16 rounding step (2**-8 relative) of the JAX one, and bitwise the cast
of its own master. Against the eager chain: bitwise.
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
from paddle2_tpu.framework.tensor import Parameter
from paddle2_tpu.kernels import pallas_fused
from paddle2_tpu_torch.kernels import _build
from paddle2_tpu_torch.kernels import fused_adamw as fa
from paddle2_tpu_torch.optimizer import AdamW

STEPS = 10
LR, B1, B2, EPS, WD = 1e-2, 0.9, 0.999, 1e-8, 0.01
SHAPES = [(6, 40), (64,), (3, 5), (129,), (6, 40), (64,), (3, 5), (1,)]


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def _mixed(seed, steps=STEPS):
    """Initial values and ``steps`` gradients (numpy f32) for SHAPES; the
    second half of the tensors is bf16 with a master, every other tensor
    without weight decay."""
    rng = np.random.default_rng(seed)
    init = [rng.normal(size=sh).astype(np.float32) for sh in SHAPES]
    grads = [[(rng.normal(size=sh) * 0.1).astype(np.float32)
              for sh in SHAPES] for _ in range(steps)]
    return init, grads


def _params(init):
    half = len(init) // 2
    out = []
    for i, a in enumerate(init):
        t = torch.tensor(a)
        p = torch.nn.Parameter(t.to(torch.bfloat16) if i >= half else t)
        p.no_weight_decay = i % 2 == 1
        out.append(p)
    return out


def _torch_steps(init, grads, fused, wd=WD):
    params = _params(init)
    o = AdamW(learning_rate=LR, beta1=B1, beta2=B2, epsilon=EPS,
              parameters=params, weight_decay=wd, multi_precision=True,
              fused=fused)
    for step_grads in grads:
        for p, g in zip(params, step_grads):
            p.grad = torch.tensor(g).to(p.dtype)
        o.step()
    out = []
    for p in params:
        st = o._states[id(p)]
        master = st.get("master")
        inner = st["inner"] if master is not None else st
        out.append((p.detach(), master, inner["m"], inner["v"]))
    return out


@pytest.mark.parametrize("wd", [WD, 0.0], ids=["decay", "no_decay"])
def test_fused_route_is_bitwise_the_eager_chain_on_a_mixed_list(wd):
    """``AdamW(fused=True)`` (one multi-tensor call a step; its plain
    version here) and ``fused=False`` (the eager chain, tensor by tensor)
    agree bitwise on every parameter, master, m and v after 3 steps."""
    init, grads = _mixed(0, steps=3)
    fused = _torch_steps(init, grads, True, wd)
    eager = _torch_steps(init, grads, False, wd)
    for a, b in zip(fused, eager):
        for x, y in zip(a, b):
            assert (x is None and y is None) or torch.equal(x, y)


def test_multi_plain_matches_the_pallas_kernel_leaf_by_leaf():
    """``adamw_step_multi``'s plain version over f32 tensors and bf16
    tensors with f32 masters (decay per tensor) against
    ``pallas_fused.fused_adamw_step(interpret=True)`` on each leaf, fed
    the master and the widened gradient: within 1e-6 of the largest
    magnitude; bitwise the per-leaf plain step; each bf16 parameter
    bitwise the cast of its new master."""
    rng = np.random.default_rng(4)
    step = 3
    sc = fa.stage_scalars(LR, B1, B2, EPS, WD, step)
    works, grads, ms, vs, lows, decays, want = [], [], [], [], [], [], []
    for i, sh in enumerate([(37, 129), (64,), (5, 3), (1000,)]):
        p, g = (rng.normal(size=sh).astype(np.float32) for _ in range(2))
        m = (rng.normal(size=sh) * 0.1).astype(np.float32)
        v = rng.random(size=sh).astype(np.float32) * 0.01
        bf16 = i % 2 == 0
        if bf16:
            g = np.asarray(torch.tensor(g).to(torch.bfloat16).float())
        decay = i % 3 != 1
        jp, jm, jv = pallas_fused.fused_adamw_step(
            jnp.asarray(p), jnp.asarray(g), jnp.asarray(m), jnp.asarray(v),
            jnp.asarray(LR, jnp.float32), jnp.asarray(step, jnp.int32),
            beta1=B1, beta2=B2, eps=EPS, weight_decay=WD if decay else 0.0,
            interpret=True)
        tp, tm, tv = torch.tensor(p), torch.tensor(m), torch.tensor(v)
        tg = torch.tensor(g).to(torch.bfloat16) if bf16 else torch.tensor(g)
        lp, lm, lv = tp.clone(), tm.clone(), tv.clone()
        fa.adamw_step_reference(lp, tg.float(), lm, lv, sc, decay)
        works.append(tp)
        grads.append(tg)
        ms.append(tm)
        vs.append(tv)
        lows.append(torch.empty(sh, dtype=torch.bfloat16) if bf16 else None)
        decays.append(decay)
        want.append((np.asarray(jp), np.asarray(jm), np.asarray(jv), lp, lm,
                     lv))
    fa.adamw_step_multi(works, grads, ms, vs, lows, decays, sc)
    for w, m, v, lo, (jp, jm, jv, lp, lm, lv) in zip(works, ms, vs, lows,
                                                      want):
        _close(w, jp)
        _close(m, jm)
        _close(v, jv)
        assert torch.equal(w, lp) and torch.equal(m, lm) and \
            torch.equal(v, lv)
        if lo is not None:
            assert torch.equal(lo, w.to(torch.bfloat16))


def _jax_steps(init, grads):
    half = len(init) // 2
    params = []
    for i, a in enumerate(init):
        p = Parameter(a, dtype="bfloat16" if i >= half else None)
        p.no_weight_decay = i % 2 == 1
        params.append(p)
    o = jopt.AdamW(learning_rate=LR, beta1=B1, beta2=B2, epsilon=EPS,
                   parameters=params, weight_decay=WD, multi_precision=True,
                   fused=True)
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
                    f(inner["m"]), f(inner["v"])))
    return out


def test_fused_adamw_tracks_the_jax_adamw_for_10_steps():
    """``AdamW(fused=True, multi_precision=True)`` on the mixed list
    against the JAX ``AdamW`` on its fused route, 10 steps."""
    init, grads = _mixed(5)
    for (tp, tmaster, tm, tv), (jp, jmaster, jm, jv) in zip(
            _torch_steps(init, grads, True), _jax_steps(init, grads)):
        _close(tm, jm)
        _close(tv, jv)
        if tmaster is None:
            _close(tp, jp)
        else:
            _close(tmaster, jmaster)
            np.testing.assert_allclose(tp.float().numpy(), jp, rtol=2 ** -8,
                                       atol=0)
            assert torch.equal(tp, tmaster.to(torch.bfloat16))


# ---------------------------------------------------------- on a card
class _StandInLibrary:
    """Records the C entry's arguments in place of the built library,
    with the pointer it was given and a copy of the descriptor table it
    points at (the wrapper's numpy records, alive during the call)."""

    def __init__(self):
        self.calls = []

    def adamw_step_multi(self, descs, count, *rest):
        table = np.frombuffer(
            (ctypes.c_char * (count * fa._DESC.itemsize)).from_address(descs),
            dtype=fa._DESC).copy()
        self.calls.append((descs, table, rest))
        return 0


@pytest.fixture
def stand_in(monkeypatch):
    """The wrapper told its tensors are on the card, the library replaced
    by a recorder, the table cache empty, and the plain version failing
    if it runs."""
    lib = _StandInLibrary()
    monkeypatch.setattr(_build, "on_card", lambda what, *t: True)
    monkeypatch.setattr(_build, "library", lambda name, sigs: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(fa, "_TABLES", {})
    monkeypatch.setattr(fa, "adamw_step_multi_reference",
                        lambda *a: pytest.fail("the plain version ran"))
    return lib


def _f32(x):
    return float(np.float32(x))


def test_one_c_call_a_step_records_every_tensor(stand_in):
    """The fused AdamW on a mixed O2 list makes one C call a step whose
    table holds each tensor once: the master (or the f32 parameter) as
    work, m, v, its gradient in the stored dtype, the bf16 parameter as
    the low copy, its length, the dtype codes and its decay flag; the
    step's scalars, staged in f32, follow as launch arguments."""
    init, _ = _mixed(1, steps=0)
    params = _params(init)
    o = AdamW(learning_rate=LR, beta1=B1, beta2=B2, epsilon=EPS,
              parameters=params, weight_decay=WD, multi_precision=True,
              fused=True)
    before = fa.adamw_step.launches
    for step in range(2):
        for p in params:
            p.grad = torch.ones_like(p)
        o.step()
        assert len(stand_in.calls) == step + 1
    assert fa.adamw_step.launches == before + 2
    _, table, rest = stand_in.calls[-1]
    assert rest == (*fa.stage_scalars(LR, B1, B2, EPS, WD, 2), None)
    assert all(x == _f32(x) for x in rest[:-1])
    want = []
    for p in params:
        st = o._states[id(p)]
        bf16 = p.dtype == torch.bfloat16
        work = st["master"] if bf16 else p
        inner = st["inner"] if bf16 else st
        want.append((work.data_ptr(), inner["m"].data_ptr(),
                     inner["v"].data_ptr(), p.grad.data_ptr(),
                     p.data_ptr() if bf16 else 0, p.numel(),
                     ((1 | 1 << 8) if bf16 else 0)
                     | (0 if p.no_weight_decay else 1 << 16), 0))
    assert table.tolist() == want


def test_the_table_is_reused_and_rebuilt_when_a_pointer_changes(stand_in):
    """Two calls on the same tensors pass the same table (made once);
    a tensor with new storage makes a new table, whose record for it
    holds the new pointer."""
    ts = [torch.zeros(3, 5) for _ in range(8)]
    works, grads, ms, vs = ts[:2], ts[2:4], ts[4:6], ts[6:]
    sc = fa.stage_scalars(LR, B1, B2, EPS, WD, 1)
    for _ in range(2):
        fa.adamw_step_multi(works, grads, ms, vs, [None, None],
                            [True, False], sc)
    (p1, t1, _), (p2, t2, _) = stand_in.calls
    assert p1 == p2 and len(fa._TABLES) == 1
    assert t1.tolist() == t2.tolist()
    grads = [torch.zeros(3, 5), grads[1]]
    fa.adamw_step_multi(works, grads, ms, vs, [None, None], [True, False],
                        sc)
    p3, t3, _ = stand_in.calls[-1]
    assert p3 != p1 and len(fa._TABLES) == 2
    assert t3["grad"][0] == grads[0].data_ptr() != t1["grad"][0]
    assert t3["codes"].tolist() == [1 << 16, 0]


def test_a_long_list_takes_one_launch_per_table(stand_in):
    n = fa.MAX_TENSORS + 3
    ts = [torch.zeros(2) for _ in range(4 * n)]
    before = fa.adamw_step.launches
    fa.adamw_step_multi(ts[:n], ts[n:2 * n], ts[2 * n:3 * n], ts[3 * n:],
                        [None] * n, [False] * n,
                        fa.stage_scalars(LR, B1, B2, EPS, WD, 1))
    assert [len(t) for _, t, _ in stand_in.calls] == [fa.MAX_TENSORS, 3]
    assert fa.adamw_step.launches == before + 2


def test_launch_error_raises(monkeypatch):
    """A launch the C entry reports as failed raises; nothing is
    counted."""
    class Failing:
        def error_string(self, err):
            return b"invalid argument"

        def adamw_step_multi(self, *args):
            return 1
    monkeypatch.setattr(_build, "on_card", lambda what, *t: True)
    monkeypatch.setattr(_build, "library", lambda name, sigs: Failing())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(fa, "_TABLES", {})
    p, g, m, v = (torch.zeros(4) for _ in range(4))
    before = fa.adamw_step.launches
    with pytest.raises(RuntimeError, match="adamw_step_multi: CUDA error 1"):
        fa.adamw_step(p, g, m, v, fa.stage_scalars(LR, B1, B2, EPS, WD, 1),
                      True)
    assert fa.adamw_step.launches == before


@pytest.mark.parametrize("why,match", [
    ("l1", "l1 decay"), ("bf16_no_master", "f32 update"),
    ("non_contiguous", "contiguous")])
def test_fused_step_on_the_card_raises_for_what_the_kernel_does_not_take(
        why, match):
    """Off the CPU (``meta`` tensors stand in for the card's), l1 decay,
    a bf16 parameter without a master and a non-contiguous parameter
    raise rather than run the eager chain, beside a tensor the kernel
    takes."""
    ok = torch.nn.Parameter(torch.empty(4, 8, device="meta"))
    dt = torch.bfloat16 if why == "bf16_no_master" else torch.float32
    t = torch.empty(6, 40, dtype=dt, device="meta")
    if why == "non_contiguous":
        t = torch.empty(40, 6, device="meta").t()
    p = torch.nn.Parameter(t)
    wd = paddle.regularizer.L1Decay(1e-2) if why == "l1" else WD
    o = AdamW(learning_rate=LR, parameters=[ok, p], weight_decay=wd,
              fused=True)
    for q in (ok, p):
        q.grad = torch.empty_like(q)
    with pytest.raises(NotImplementedError, match=match):
        o.step()


@pytest.mark.parametrize("bad", ["size", "grad_dtype", "state_dtype"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    p, g, m, v = (torch.zeros(4, 8) for _ in range(4))
    if bad == "size":
        v = torch.zeros(4, 9)
    elif bad == "grad_dtype":
        g = g.to(torch.bfloat16)      # bf16 only beside a bf16 parameter
    else:
        m = m.double()
    with pytest.raises(ValueError):
        fa.adamw_step_multi([p], [g], [m], [v], [None], [True],
                            fa.stage_scalars(LR, B1, B2, EPS, WD, 1))


def test_cpu_step_launches_no_kernel():
    before = fa.adamw_step.launches
    init, grads = _mixed(2, steps=2)
    _torch_steps(init, grads, True)
    assert fa.adamw_step.launches == before
