"""The fifteen optimizers of the port (paddle2_tpu_torch.optimizer) held
against the JAX package's on the same numpy parameters and gradients,
ten steps each: f32 with an L2 decay, a global-norm clip and a
scheduler; f32 with an L1 decay and a clip by value; bf16 (with
``multi_precision`` where the JAX constructor passes it on); Adam's
``lazy_mode`` and ``amsgrad``, AdamW's ``lr_ratio`` and
``apply_decay_param_fun``, Lamb's exclusion, LBFGS with a closure; and
an optimizer state written by ``paddle2_tpu.save`` (with its scheduler)
loading into the port.

Tolerances: f32 to 1e-5 of each tensor's largest magnitude (the op order
is the JAX package's, but XLA may contract a multiply and an add into
one rounding where torch rounds twice, and its f32 ``pow``, ``sqrt`` and
norms may differ from torch's in the last place; Lamb's trust ratio and
RAdam's rectification carry such differences into every element). A
bf16 parameter to 2 bf16 steps (2**-7) of its largest magnitude: a bf16
update rounds once per op in torch, and XLA may keep a fused chain's
intermediates in f32 and round once; an f32 master as in f32.
"""

import zlib

import numpy as np
import pytest
import torch

import paddle2_tpu as paddle
import paddle2_tpu.nn as jnn
import paddle2_tpu.optimizer as jopt
import paddle2_tpu_torch as tp
import paddle2_tpu_torch.nn as tnn
import paddle2_tpu_torch.optimizer as topt

STEPS = 10
SHAPES = [(6, 8), (5,)]
NAMES = ["w_0", "b_0"]

# name -> (learning rate, extra kwargs, takes weight_decay,
#          passes multi_precision to the base)
OPTS = {
    "SGD": (0.05, {}, True, True),
    "Momentum": (0.05, dict(momentum=0.8), True, True),
    "Adam": (0.01, {}, True, True),
    "AdamW": (0.01, {}, True, True),
    "Adamax": (0.01, {}, True, False),
    "Adagrad": (0.05, dict(initial_accumulator_value=0.1), True, False),
    "Adadelta": (0.5, dict(rho=0.9), True, False),
    "RMSProp": (0.01, dict(momentum=0.5, centered=True), True, False),
    "Lamb": (0.01, dict(lamb_weight_decay=0.02), False, True),
    "Lion": (0.003, {}, True, False),
    "NAdam": (0.01, {}, True, True),
    "RAdam": (0.01, {}, True, True),
    "ASGD": (0.05, dict(batch_num=3), True, False),
    "Rprop": (0.01, dict(learning_rate_range=(1e-4, 0.5)), False, False),
}


def _data(seed):
    rng = np.random.default_rng(seed)
    inits = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.standard_normal(s) * 0.5).astype(np.float32)
              for s in SHAPES] for _ in range(STEPS)]
    return inits, grads


def _params(side, inits, dtype):
    out = []
    for a, name in zip(inits, NAMES):
        if side == "jax":
            p = paddle.create_parameter(list(a.shape), dtype,
                                        attr=paddle.ParamAttr(name=name))
            p.set_value(paddle.to_tensor(a).astype(dtype))
        else:
            p = torch.nn.Parameter(torch.from_numpy(a.copy()).to(
                getattr(torch, dtype)))
            p.paddle_name = name
        out.append(p)
    return out


def _run(side, name, inits, grads, dtype, decay=None, clip=None, sched=None,
         multi=False, **extra):
    """Ten steps of optimizer ``name`` in one package; returns the
    parameters and the optimizer."""
    mod = jopt if side == "jax" else topt
    params = _params(side, inits, dtype)
    lr, kwargs, takes_wd, takes_mp = OPTS[name]
    kwargs = dict(kwargs, **extra)
    if sched is not None:
        lr = sched(mod.lr)
    if decay is not None:
        kwargs["weight_decay"] = decay(side)
    if clip is not None:
        kwargs["grad_clip"] = clip(side)
    if multi:
        kwargs["multi_precision"] = True
    opt = getattr(mod, name)(learning_rate=lr, parameters=params, **kwargs)
    for gs in grads:
        for p, g in zip(params, gs):
            if side == "jax":
                p.grad = paddle.to_tensor(g).astype(dtype)
            else:
                p.grad = torch.from_numpy(g.copy()).to(getattr(torch, dtype))
        opt.step()
        if sched is not None:
            lr.step()
    return params, opt


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t._data.astype("float32") if hasattr(t, "_data")
                      else t.astype("float32"), np.float32)


def _close(got, want, tol):
    g, w = _np(got), _np(want)
    np.testing.assert_allclose(g, w, rtol=0,
                               atol=tol * max(np.abs(w).max(), 1e-12))


def _close_signs(got, want, tol, lr):
    """Lion in bf16: its update is ``lr * sign(m')``, and where the bf16
    momentum mix ``m'`` lies within a rounding of zero the two packages
    may take opposite signs; each such flip moves an element by
    ``2 lr``. At most a tenth of the elements may differ past ``tol``,
    and none by more than ``2 lr`` a step."""
    g, w = _np(got), _np(want)
    off = np.abs(g - w) > tol * max(np.abs(w).max(), 1e-12)
    assert off.mean() <= 0.1
    assert np.abs(g - w).max() <= 2 * lr * STEPS


def _masters(opt, side):
    out = []
    for p in opt._parameter_list():
        st = opt._states.get(id(p))
        out.append(st["master"] if isinstance(st, dict) and "master" in st
                   else None)
    return out


def _l2(side):
    return (paddle if side == "jax" else tp).regularizer.L2Decay(0.01)


def _l1(side):
    return (paddle if side == "jax" else tp).regularizer.L1Decay(0.01)


def _global(side):
    return (jnn if side == "jax" else tnn).ClipGradByGlobalNorm(1.0)


def _by_value(side):
    return (jnn if side == "jax" else tnn).ClipGradByValue(0.6)


def _step_decay(lrmod):
    return lrmod.StepDecay(0.02, 3, gamma=0.5)


def _check(name, dtype="float32", **kw):
    inits, grads = _data(zlib.crc32(f"{name}-{dtype}".encode()) % 1000)
    jps, jo = _run("jax", name, inits, grads, dtype, **kw)
    tps, to = _run("torch", name, inits, grads, dtype, **kw)
    assert to._step_count == jo._step_count
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    for t, j, a in zip(tps, jps, inits):
        assert t.dtype == getattr(torch, dtype)
        if name == "Lion" and dtype == "bfloat16":
            _close_signs(t, j, tol, OPTS[name][0])
        else:
            _close(t, j, tol)
        assert not np.allclose(_np(t), a)
    for tm, jm in zip(_masters(to, "torch"), _masters(jo, "jax")):
        assert (tm is None) == (jm is None)
        if tm is not None:
            assert tm.dtype == torch.float32
            _close(tm, jm, 1e-5)


@pytest.mark.parametrize("name", list(OPTS))
def test_f32_with_l2_decay_global_clip_and_a_scheduler(name):
    takes_wd = OPTS[name][2]
    _check(name, decay=_l2 if takes_wd else None, clip=_global,
           sched=None if name == "Rprop" else _step_decay)


@pytest.mark.parametrize("name", list(OPTS))
def test_f32_with_l1_decay_and_a_clip_by_value(name):
    takes_wd = OPTS[name][2]
    _check(name, decay=_l1 if takes_wd else None, clip=_by_value)


@pytest.mark.parametrize("name", list(OPTS))
def test_bf16_with_multi_precision(name):
    """bf16 parameters; the constructors that pass ``multi_precision``
    on keep f32 masters (held as f32), the others step in bf16, as in
    the JAX package."""
    _check(name, "bfloat16", decay=_l2 if OPTS[name][2] else None,
           multi=OPTS[name][3])


@pytest.mark.parametrize("name,extra", [
    ("Adam", dict(lazy_mode=True)), ("Adam", dict(amsgrad=True)),
    ("AdamW", dict(amsgrad=True)), ("AdamW", dict(lazy_mode=True)),
    ("AdamW", dict(lr_ratio=lambda p: 0.5)),
    ("AdamW", dict(apply_decay_param_fun=lambda n: n == "w_0")),
    ("NAdam", dict(amsgrad=True)),
    ("Lamb", dict(exclude_from_weight_decay_fn=lambda p: p.ndim == 1)),
    ("RMSProp", dict(centered=False, momentum=0.0)),
    ("Momentum", dict(use_nesterov=True))],
    ids=["adam-lazy_mode", "adam-amsgrad", "adamw-amsgrad",
         "adamw-lazy_mode", "adamw-lr_ratio", "adamw-apply_decay_param_fun",
         "nadam-amsgrad", "lamb-exclude", "rmsprop-plain",
         "momentum-nesterov"])
def test_options(name, extra):
    _check(name, decay=_l2 if OPTS[name][2] else None, **extra)


def test_amsgrad_keeps_a_running_maximum_and_fused_takes_the_chain():
    """amsgrad's state holds ``vmax``; with ``fused=True`` AdamW takes the
    eager chain for it (the kernel has no running maximum), as the JAX
    package does, and counts no launch."""
    from paddle2_tpu_torch.kernels import fused_adamw
    inits, grads = _data(5)
    outs = []
    for fused in (True, False):
        ps = _params("torch", inits, "float32")
        o = topt.AdamW(0.01, parameters=ps, amsgrad=True, fused=fused)
        for gs in grads:
            for p, g in zip(ps, gs):
                p.grad = torch.from_numpy(g.copy())
            o.step()
        outs.append(ps)
        assert set(o._states[id(ps[0])]) == {"m", "v", "vmax"}
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert fused_adamw.adamw_step.launches == 0


def test_apply_decay_param_fun_reads_paddle_names():
    """The function sees each parameter's ``paddle_name`` (None for a
    plain ``torch.nn.Parameter``) and marks the refused ones."""
    seen = []
    a = torch.nn.Parameter(torch.ones(2))
    b = torch.nn.Parameter(torch.ones(2))
    b.paddle_name = "linear_0.b_0"
    topt.AdamW(parameters=[a, b],
               apply_decay_param_fun=lambda n: seen.append(n) or False)
    assert seen == [None, "linear_0.b_0"]
    assert a.no_weight_decay and b.no_weight_decay


def _quadratic(seed=9):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((8, 5)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    w0 = rng.standard_normal(5).astype(np.float32)
    return A, b, w0


def test_lbfgs_with_a_closure_matches_jax():
    A, b, w0 = _quadratic()
    jw = paddle.create_parameter([5], "float32", name="w")
    jw.set_value(paddle.to_tensor(w0))
    jo = jopt.LBFGS(learning_rate=0.05, parameters=[jw], history_size=4)
    JA, jb = paddle.to_tensor(A), paddle.to_tensor(b)

    def jclosure():
        jo.clear_grad()
        loss = ((paddle.matmul(JA, jw) - jb) ** 2).sum()
        loss.backward()
        return loss

    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    to = topt.LBFGS(learning_rate=0.05, parameters=[tw], history_size=4)
    TA, tb = torch.from_numpy(A), torch.from_numpy(b)
    losses = []

    def tclosure():
        to.clear_grad()
        loss = ((TA @ tw - tb) ** 2).sum()
        loss.backward()
        losses.append(loss.item())
        return loss

    for _ in range(8):
        jo.step(jclosure)
        to.step(tclosure)
        _close(tw, jw, 1e-5)
    assert to._step_count == jo._step_count == 8
    assert losses[-1] < losses[0]
    assert len(to._hist_s) <= 4


def test_signatures_cover_every_optimizer():
    assert set(topt.__all__) - {"lr", "Optimizer"} == set(OPTS) | {"LBFGS"}


def test_a_jax_optimizer_state_with_a_scheduler_loads(tmp_path):
    """``paddle2_tpu.save`` of an optimizer's ``state_dict`` (named
    parameters, a scheduler, bf16 masters) loads with ``paddle.load`` in
    the port, and ``set_state_dict`` resumes it: the next steps equal
    the JAX package's."""
    inits, grads = _data(11)

    def make(side, dtype):
        mod = jopt if side == "jax" else topt
        ps = _params(side, inits, dtype)
        sched = mod.lr.StepDecay(0.02, 2, gamma=0.5)
        return ps, mod.AdamW(learning_rate=sched, parameters=ps,
                             multi_precision=True), sched

    jps, jo, js = make("jax", "bfloat16")
    for gs in grads[:4]:
        for p, g in zip(jps, gs):
            p.grad = paddle.to_tensor(g).astype("bfloat16")
        jo.step()
        js.step()
    path = tmp_path / "opt.pdopt"
    paddle.save(jo.state_dict(), str(path))
    paddle.save(js, str(tmp_path / "sched.pdsched"))
    sd = tp.load(str(path))
    assert set(sd) == {"_step_count", "LR_Scheduler", "w_0", "b_0"}
    assert sd["w_0"]["master"].dtype == torch.float32
    assert tp.load(str(tmp_path / "sched.pdsched")) == js.state_dict()
    tps, to, ts = make("torch", "bfloat16")
    for t, j in zip(tps, jps):
        t.data.copy_(torch.from_numpy(_np(j)).to(torch.bfloat16))
    to.set_state_dict(sd)
    assert to._step_count == 4 and ts.last_epoch == js.last_epoch
    assert to.get_lr() == jo.get_lr()
    for gs in grads[4:]:
        for p, q, g in zip(tps, jps, gs):
            p.grad = torch.from_numpy(g.copy()).to(torch.bfloat16)
            q.grad = paddle.to_tensor(g).astype("bfloat16")
        to.step()
        jo.step()
        ts.step()
        js.step()
    for t, j in zip(tps, jps):
        _close(t, j, 2 ** -7)
    for tm, jm in zip(_masters(to, "torch"), _masters(jo, "jax")):
        _close(tm, jm, 1e-5)


def test_the_ports_optimizer_state_round_trips(tmp_path):
    """The port's ``state_dict`` (scheduler included) saved with
    ``paddle.save`` loads back into fresh objects, which then step
    bitwise as the uninterrupted ones."""
    inits, grads = _data(12)

    def make():
        ps = _params("torch", inits, "float32")
        sched = topt.lr.LinearWarmup(topt.lr.CosineAnnealingDecay(
            0.01, T_max=20), 2, 0.0, 0.01)
        return ps, topt.AdamW(learning_rate=sched, parameters=ps,
                              grad_clip=tnn.ClipGradByGlobalNorm(1.0)), sched

    def steps(ps, o, s, gs):
        for g in gs:
            for p, a in zip(ps, g):
                p.grad = torch.from_numpy(a.copy())
            o.step()
            s.step()

    ps, o, s = make()
    steps(ps, o, s, grads[:4])
    tp.save(o.state_dict(), str(tmp_path / "o.pdopt"))
    tp.save({n: p for n, p in zip(NAMES, ps)}, str(tmp_path / "m.pdparams"))
    qs, o2, s2 = make()
    for q, p in zip(qs, tp.load(str(tmp_path / "m.pdparams")).values()):
        q.data.copy_(p)
    o2.set_state_dict(tp.load(str(tmp_path / "o.pdopt")))
    steps(ps, o, s, grads[4:])
    steps(qs, o2, s2, grads[4:])
    for a, b in zip(ps, qs):
        assert torch.equal(a, b)
