"""Dynamic loss scaling (paddle2_tpu_torch.amp.GradScaler) held step by
step against the JAX package's ``GradScaler`` on the same numpy
gradients, with infinities and NaNs injected: the scale, the skipped
steps, the good and bad counters, ``ScaleSaturationError``, two
optimizers sharing one scaler, ``minimize``, the switches, and the
``state_dict`` round trip.

The scaler's state is compared exactly (host-side Python floats and
ints); the parameters to 1e-6 of their largest magnitude in f32 (the
unscale is one f32 multiply in both packages, the SGD step the same
ops), and an f16 parameter (with its f32 master) to one f16 step
(2**-11) relative.
"""

import numpy as np
import pytest
import torch

import paddle2_tpu as paddle
import paddle2_tpu.amp as jamp
import paddle2_tpu.optimizer as jopt
from paddle2_tpu_torch import amp as tamp
from paddle2_tpu_torch.optimizer import SGD

STEPS = 30
SHAPE = (4, 6)
# step -> what the gradient holds there
BAD = {3: "inf", 4: "nan", 9: "-inf", 15: "inf", 16: "inf", 22: "nan"}


def _grads(seed, bad=BAD):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(STEPS):
        g = rng.standard_normal(SHAPE).astype(np.float32)
        if i in bad:
            g[1, 2] = {"inf": np.inf, "-inf": -np.inf, "nan": np.nan}[bad[i]]
        out.append(g)
    return out


def _state(s):
    return (s.get_loss_scaling(), s._good_steps, s._bad_steps,
            s._consecutive_skips)


class Pair:
    """One parameter, optimizer and scaler in each package."""

    def __init__(self, init, dtype="float32", **kw):
        self.tp = torch.nn.Parameter(torch.from_numpy(init.copy()).to(
            getattr(torch, dtype)))
        self.jp = paddle.create_parameter(list(init.shape), dtype)
        self.jp.set_value(paddle.to_tensor(init).astype(dtype))
        assert str(self.jp.dtype) == dtype
        multi = dtype != "float32"
        self.to = SGD(learning_rate=0.1, parameters=[self.tp],
                      multi_precision=multi)
        self.jo = jopt.SGD(learning_rate=0.1, parameters=[self.jp],
                           multi_precision=multi)
        self.ts = tamp.GradScaler(**kw)
        self.js = jamp.GradScaler(**kw)
        self.dtype = dtype

    def set_grads(self, g):
        """The gradient a backward of the scaled loss would give."""
        self.ts.scale(torch.ones(()))
        self.js.scale(paddle.to_tensor(1.0))
        scaled = g * np.float32(self.ts.get_loss_scaling())
        # a copy: the port unscales in place, and the JAX array may share
        # the numpy buffer
        self.tp.grad = torch.from_numpy(scaled.copy()).to(self.tp.dtype)
        self.jp.grad = paddle.to_tensor(scaled).astype(self.dtype)

    def close(self):
        want = np.asarray(self.jp.numpy(), np.float32)
        got = self.tp.detach().float().numpy()
        tol = 1e-6 if self.dtype == "float32" else 2 ** -11
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * np.abs(want).max())


KW = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=3,
          decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.5,
          max_loss_scaling=2.0 ** 12, min_loss_scaling=2.0 ** 8)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_thirty_steps_follow_the_reference(dtype):
    init = np.random.default_rng(0).standard_normal(SHAPE).astype(np.float32)
    pr = Pair(init, dtype, **KW)
    skipped = 0
    for g in _grads(1):
        pr.set_grads(g)
        before = pr.tp.detach().clone()
        pr.ts.step(pr.to)
        pr.js.step(pr.jo)
        stepped = not torch.equal(before, pr.tp.detach())
        skipped += not stepped
        pr.ts.update()
        pr.js.update()
        assert _state(pr.ts) == _state(pr.js)
        pr.close()
    assert skipped == len(BAD)
    assert pr.ts.get_loss_scaling() in (2.0 ** k for k in range(8, 13))


def test_saturation_raises_where_the_reference_does():
    init = np.ones(SHAPE, np.float32)
    bad = {i: "inf" for i in range(5, STEPS)}
    pr = Pair(init, max_consecutive_skips=3, **KW)
    raised = []
    for i, g in enumerate(_grads(2, bad)):
        pr.set_grads(g)
        pr.ts.step(pr.to)
        pr.js.step(pr.jo)
        errs = []
        for s in (pr.ts, pr.js):
            try:
                s.update()
            except RuntimeError as e:
                errs.append(type(e).__name__)
        if errs:
            assert errs == ["ScaleSaturationError"] * 2
            raised.append(i)
            break
        assert _state(pr.ts) == _state(pr.js)
    assert raised == [7]
    assert issubclass(tamp.ScaleSaturationError, RuntimeError)


def test_two_optimizers_share_one_scaler():
    """A non-finite gradient of one optimizer skips its step only, and
    the shared scale backs off once for the cycle."""
    rng = np.random.default_rng(3)
    inits = [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2)]
    ts, js = tamp.GradScaler(**KW), jamp.GradScaler(**KW)
    tps = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in inits]
    jps = []
    for a in inits:
        p = paddle.create_parameter(list(SHAPE), "float32")
        p.set_value(paddle.to_tensor(a))
        jps.append(p)
    tos = [SGD(learning_rate=0.1, parameters=[p]) for p in tps]
    jos = [jopt.SGD(learning_rate=0.1, parameters=[p]) for p in jps]
    ga, gb = _grads(4, {}), _grads(5, {2: "inf", 6: "nan", 7: "inf"})
    for i in range(10):
        ts.scale(torch.ones(()))
        js.scale(paddle.to_tensor(1.0))
        for p, q, g in zip(tps, jps, (ga[i], gb[i])):
            scaled = g * np.float32(ts.get_loss_scaling())
            p.grad = torch.from_numpy(scaled.copy())
            q.grad = paddle.to_tensor(scaled)
        befores = [p.detach().clone() for p in tps]
        for o, q in zip(tos, jos):
            ts.step(o)
            js.step(q)
        moved = [not torch.equal(b, p.detach()) for b, p in zip(befores, tps)]
        assert moved == [True, i not in (2, 6, 7)]
        ts.update()
        js.update()
        assert _state(ts) == _state(js)
        for p, q in zip(tps, jps):
            np.testing.assert_allclose(p.detach().numpy(), q.numpy(),
                                       rtol=0, atol=1e-6)


def test_state_dict_round_trip():
    """After 12 steps the scaler's state loads into a fresh scaler (and
    into the JAX package's, whose keys it has); a parameter and optimizer
    copied at that point then step with the fresh scaler exactly as the
    original ones do with the uninterrupted scaler."""
    init = np.random.default_rng(6).standard_normal(SHAPE).astype(np.float32)
    grads = _grads(7)

    def run(scaler, p, opt, gs):
        for g in gs:
            scaler.scale(torch.ones(()))
            p.grad = torch.from_numpy(
                g * np.float32(scaler.get_loss_scaling()))
            scaler.step(opt)
            scaler.update()

    s = tamp.GradScaler(**KW)
    p = torch.nn.Parameter(torch.from_numpy(init.copy()))
    o = SGD(learning_rate=0.1, parameters=[p])
    run(s, p, o, grads[:12])
    sd = s.state_dict()
    assert set(sd) == set(jamp.GradScaler().state_dict())
    fresh = tamp.GradScaler(**KW)
    fresh.load_state_dict(sd)
    assert _state(fresh) == _state(s) and fresh.state_dict() == sd
    j = jamp.GradScaler(**KW)
    j.load_state_dict(sd)
    assert _state(j) == _state(s)
    q = torch.nn.Parameter(p.detach().clone())
    run(s, p, o, grads[12:])
    run(fresh, q, SGD(learning_rate=0.1, parameters=[q]), grads[12:])
    assert _state(fresh) == _state(s)
    assert torch.equal(p, q)


def test_minimize_switches_and_refusals():
    init = np.ones(SHAPE, np.float32)
    g = _grads(8, {})[0]
    pr = Pair(init, **KW)
    pr.set_grads(g)
    pr.ts.minimize(pr.to, None)
    pr.js.minimize(pr.jo, None)
    assert _state(pr.ts) == _state(pr.js)
    pr.close()
    off = tamp.GradScaler(enable=False)
    loss = torch.ones(())
    assert off.scale(loss) is loss and not off.is_enable()
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.full((3,), float("inf"))
    off.step(SGD(learning_rate=0.1, parameters=[p]))
    assert torch.isinf(p).all()          # no check: the step ran
    static = tamp.GradScaler(use_dynamic_loss_scaling=False,
                             init_loss_scaling=8.0)
    static._cycle_found_inf = True
    static.update()
    assert static.get_loss_scaling() == 8.0
    assert not static.is_use_dynamic_loss_scaling()
    static.set_init_loss_scaling(16.0)
    assert static.get_loss_scaling() == 16.0
    with pytest.raises(ValueError, match="min_loss_scaling"):
        tamp.GradScaler(min_loss_scaling=4.0, max_loss_scaling=2.0)
    with pytest.raises(NotImplementedError, match="item 7"):
        static.note_fused_step(False)


def test_unscale_is_one_check_and_keeps_dtypes():
    """``unscale_`` divides in place, keeps each gradient's dtype, reads
    the flag back once, and a second call in the same cycle does
    nothing."""
    a = torch.nn.Parameter(torch.ones(3, dtype=torch.float16))
    b = torch.nn.Parameter(torch.ones(2))
    s = tamp.GradScaler(init_loss_scaling=4.0)
    o = SGD(learning_rate=0.1, parameters=[a, b], multi_precision=True)
    a.grad = torch.full((3,), 8.0, dtype=torch.float16)
    b.grad = torch.full((2,), 2.0)
    s.unscale_(o)
    assert a.grad.dtype == torch.float16 and torch.equal(
        a.grad, torch.full((3,), 2.0, dtype=torch.float16))
    assert torch.equal(b.grad, torch.full((2,), 0.5))
    s.unscale_(o)
    assert torch.equal(b.grad, torch.full((2,), 0.5))
    flag, pairs = tamp.grad_scaler.grads_nonfinite_flag(o, 1.0)
    assert flag.dim() == 0 and not bool(flag) and len(pairs) == 2
