"""The port's learning-rate schedulers (paddle2_tpu_torch.optimizer.lr)
held against the JAX package's: all 17, 60 steps each, equal (not
close: both are the same host-side Python float arithmetic),
``ReduceOnPlateau`` on a fixed metric sequence, the ``state_dict`` round
trip, and a scheduler driving an optimizer's learning rate."""

import math

import numpy as np
import pytest
import torch

import paddle2_tpu.optimizer.lr as jlr
from paddle2_tpu_torch.optimizer import SGD
from paddle2_tpu_torch.optimizer import lr as tlr

STEPS = 60


def _lam(epoch):
    return 0.95 ** epoch


def _mul(epoch):
    return 0.97


# (name, args, kwargs); callables are module-level so both packages get
# the same ones
SCHEDULERS = [
    ("NoamDecay", (512, 10), dict(learning_rate=2.0)),
    ("ExponentialDecay", (0.5, 0.93), {}),
    ("NaturalExpDecay", (0.5, 0.07), {}),
    ("InverseTimeDecay", (0.5, 0.3), {}),
    ("PolynomialDecay", (0.5, 25), dict(end_lr=0.01, power=2.0)),
    ("PolynomialDecay", (0.5, 7), dict(end_lr=0.01, power=1.5, cycle=True)),
    ("PiecewiseDecay", ([5, 17, 40], [0.1, 0.05, 0.01, 0.001]), {}),
    ("LinearWarmup", (0.3, 12, 0.0, 0.3), {}),
    ("StepDecay", (0.5, 7), dict(gamma=0.6)),
    ("MultiStepDecay", (0.5, [4, 9, 33]), dict(gamma=0.3)),
    ("LambdaDecay", (0.5, _lam), {}),
    ("MultiplicativeDecay", (0.5, _mul), {}),
    ("CosineAnnealingDecay", (0.5, 23), dict(eta_min=0.01)),
    ("CyclicLR", (0.01, 0.1, 6), dict(step_size_down=9)),
    ("CyclicLR", (0.01, 0.1, 5), dict(mode="triangular2")),
    ("CyclicLR", (0.01, 0.1, 5), dict(mode="exp_range", exp_gamma=0.97)),
    ("CyclicLR", (0.01, 0.1, 5), dict(scale_fn=_lam, scale_mode="iterations")),
    ("OneCycleLR", (0.1, 50), {}),
    ("OneCycleLR", (0.1, 50), dict(anneal_strategy="linear", phase_pct=0.2)),
    ("CosineAnnealingWarmRestarts", (0.5, 7), dict(T_mult=2, eta_min=0.001)),
    ("LinearLR", (0.5, 30), dict(start_factor=0.2, end_factor=0.9)),
]
IDS = [f"{n}-{i}" for i, (n, _, _) in enumerate(SCHEDULERS)]


def _values(mod, name, args, kwargs):
    s = getattr(mod, name)(*args, **kwargs)
    out = [s()]
    for _ in range(STEPS):
        s.step()
        out.append(s())
    return out, s


@pytest.mark.parametrize("name,args,kwargs", SCHEDULERS, ids=IDS)
def test_values_equal_the_reference(name, args, kwargs):
    got, _ = _values(tlr, name, args, kwargs)
    want, _ = _values(jlr, name, args, kwargs)
    assert got == want
    assert all(isinstance(v, float) for v in got)


def test_linear_warmup_into_cosine_equals_the_reference():
    """The recipe's schedule: a warmup wrapping a cosine decay."""
    def make(mod):
        return mod.LinearWarmup(mod.CosineAnnealingDecay(1e-4, T_max=100),
                                warmup_steps=2, start_lr=0.0, end_lr=1e-4)
    t, j = make(tlr), make(jlr)
    got, want = [t()], [j()]
    for _ in range(STEPS):
        t.step()
        j.step()
        got.append(t())
        want.append(j())
    assert got == want
    assert got[0] == 0.0 and got[1] == 5e-5 and got[2] < 1e-4


def test_all_seventeen_are_exported():
    names = set(tlr.__all__) - {"LRScheduler"}
    assert len(names) == 17
    assert names == set(jlr.__all__) - {"LRScheduler"}
    assert {n for n, _, _ in SCHEDULERS} | {"ReduceOnPlateau"} == names


METRICS = [1.0, 0.9, 0.95, 0.96, 0.97, 0.89, 0.9, 0.91, 0.92, 0.93, 0.94,
           0.95, 0.88, 0.88, 0.88, 0.88, 0.88, 0.7, 0.71, 0.72, 0.73, 0.74]


@pytest.mark.parametrize("kwargs", [
    dict(patience=2), dict(patience=1, cooldown=2, factor=0.5),
    dict(mode="max", patience=2), dict(threshold_mode="abs", threshold=0.05,
                                       patience=1, min_lr=0.02)],
    ids=["min", "cooldown", "max", "abs_min_lr"])
def test_reduce_on_plateau_follows_the_reference(kwargs):
    t = tlr.ReduceOnPlateau(0.1, **kwargs)
    j = jlr.ReduceOnPlateau(0.1, **kwargs)
    got, want = [], []
    for m in METRICS:
        t.step(torch.tensor(m, dtype=torch.float64))
        j.step(m)
        got.append((t(), t.num_bad, t.cooldown_counter, t.best))
        want.append((j(), j.num_bad, j.cooldown_counter, j.best))
    assert got == want
    assert got[-1][0] < 0.1 or kwargs.get("mode") == "max"


@pytest.mark.parametrize("name,args,kwargs", SCHEDULERS, ids=IDS)
def test_state_dict_round_trip(name, args, kwargs):
    """After 20 steps, a scheduler's state loads into a fresh one, which
    then gives the uninterrupted one's values; the state holds what the
    JAX package's does."""
    ran, s = _values(tlr, name, args, kwargs)
    _, j = _values(jlr, name, args, kwargs)
    sd = s.state_dict()
    jsd = j.state_dict()
    assert {k: v for k, v in sd.items() if k != "lr_sched"} == jsd
    fresh = getattr(tlr, name)(*args, **kwargs)
    fresh.set_state_dict(sd)
    assert fresh() == s()
    for _ in range(5):
        s.step()
        fresh.step()
        assert fresh() == s()


def test_warmup_keeps_its_wrapped_schedulers_state():
    """LinearWarmup saves the wrapped scheduler's state (the JAX package
    drops it), so a run resumed past the warmup equals one that was not
    interrupted."""
    def make():
        return tlr.LinearWarmup(tlr.CosineAnnealingDecay(1e-4, T_max=100),
                                warmup_steps=2, start_lr=0.0, end_lr=1e-4)
    a = make()
    for _ in range(5):
        a.step()
    b = make()
    b.set_state_dict(a.state_dict())
    for _ in range(10):
        a.step()
        b.step()
        assert a() == b()


def test_a_scheduler_drives_the_learning_rate():
    """The optimizer reads the scheduler at each step; ``set_lr`` raises
    under a scheduler; ``set_lr_scheduler`` swaps one in."""
    p = torch.nn.Parameter(torch.ones(3))
    sched = tlr.StepDecay(0.5, 2, gamma=0.5)
    opt = SGD(learning_rate=sched, parameters=[p])
    seen = []
    for _ in range(5):
        p.grad = torch.ones(3)
        before = p.detach().clone()
        opt.step()
        seen.append(float((before - p.detach())[0]))
        assert opt.get_lr() == sched()
        sched.step()
    np.testing.assert_allclose(seen, [0.5, 0.5, 0.25, 0.25, 0.125])
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.1)
    opt2 = SGD(learning_rate=0.3, parameters=[p])
    opt2.set_lr(0.2)
    assert opt2.get_lr() == 0.2
    opt2.set_lr_scheduler(tlr.ExponentialDecay(0.4, 0.5))
    assert opt2.get_lr() == 0.4 and opt2._learning_rate is not None
    assert math.isclose(opt2.get_lr(), 0.4)
