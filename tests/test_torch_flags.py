"""The port's flag registry (paddle2_tpu_torch.flags) against the JAX
package's (paddle2_tpu.flags): all twelve core flags with the JAX
names, defaults and types, the ``FLAGS_`` environment override and
typed coercion, ``set_flags``/``get_flags``, ``AdamW(fused=None)``
following ``FLAGS_fused_optimizer_step``, ``FLAGS_check_nan_inf`` naming
the op on a forward and a backward, ``FLAGS_log_level`` and
``FLAGS_conv_prefer_channels_last``."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle2_tpu.flags as jflags
from paddle2_tpu_torch import flags
from paddle2_tpu_torch.optimizer import AdamW
from paddle2_tpu_torch.optimizer import optimizers as topt

ROOT = Path(__file__).resolve().parents[1]
PORTED = ("check_nan_inf", "enable_api_kernel_fallback", "eager_vjp_cache",
          "log_level", "compilation_cache_dir", "conv_prefer_channels_last",
          "pallas_layer_norm", "max_program_cache_size",
          "donate_optimizer_buffers", "fused_optimizer_step",
          "xla_latency_hiding_scheduler", "xla_async_collectives")


@pytest.fixture
def restore_flags():
    before = flags.get_flags()
    yield
    flags.set_flags(before)


def test_the_ported_flags_and_their_defaults_match_jax():
    """The registry holds the JAX package's twelve core flags; a process
    with no ``FLAGS_`` in its environment starts them at the JAX
    defaults, of the JAX types."""
    assert set(flags._REGISTRY) == set(PORTED)
    assert set(PORTED) <= set(jflags._REGISTRY)
    for n in PORTED:
        assert flags._REGISTRY[n].type is jflags._REGISTRY[n].type, n
        assert flags._REGISTRY[n].default == jflags._REGISTRY[n].default
    code = ("from paddle2_tpu_torch.flags import get_flags; "
            "print(sorted(get_flags().items()))")
    env = {k: v for k, v in os.environ.items() if not k.startswith("FLAGS_")}
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    want = sorted(("FLAGS_" + n, jflags._REGISTRY[n].default)
                  for n in PORTED)
    assert out.stdout.strip() == str(want)


@pytest.mark.parametrize("env,want", [("1", True), ("ON", True),
                                      ("no", False)])
def test_environment_overrides_the_default(env, want):
    code = ("from paddle2_tpu_torch.flags import flag_value, get_flags; "
            "print(flag_value('pallas_layer_norm'), "
            "get_flags('FLAGS_pallas_layer_norm'))")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=str(ROOT), capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "FLAGS_pallas_layer_norm": env})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(want),
                                  f"{{'FLAGS_pallas_layer_norm':", f"{want}}}"]


@pytest.mark.parametrize("default,env,want", [
    (False, "yes", True), (3, "7", 7), (0.5, "0.25", 0.25), ("a", "b", "b")])
def test_define_flag_coerces_the_environment_like_jax(monkeypatch, default,
                                                      env, want):
    name = f"port_test_{type(default).__name__}"
    monkeypatch.setenv("FLAGS_" + name, env)
    for reg in (flags, jflags):
        try:
            reg.define_flag(name, default, "a test flag")
            assert reg.flag_value(name) == want
            assert type(reg.flag_value(name)) is type(default)
            reg.define_flag(name, not default)    # a second define keeps
            assert reg.flag_value(name) == want
        finally:
            reg._REGISTRY.pop(name, None)


def test_set_and_get_flags_like_jax(restore_flags):
    assert flags.get_flags(["pallas_layer_norm"]) == \
        {"FLAGS_pallas_layer_norm": False}
    flags.set_flags({"FLAGS_pallas_layer_norm": "true",
                     "fused_optimizer_step": 1})
    assert flags.get_flags(["pallas_layer_norm",
                            "FLAGS_fused_optimizer_step"]) == {
        "FLAGS_pallas_layer_norm": True, "FLAGS_fused_optimizer_step": True}
    assert flags.flag_value("pallas_layer_norm") is True
    flags.set_flags({"pallas_layer_norm": "off"})
    assert flags.flag_value("pallas_layer_norm") is False
    for reg in (flags, jflags):
        with pytest.raises(ValueError, match="unknown flag"):
            reg.set_flags({"FLAGS_no_such_flag": 1})
        with pytest.raises(ValueError, match="unknown flag"):
            reg.get_flags("no_such_flag")


@pytest.mark.parametrize("flag,fused,kernel", [
    (False, None, False), (True, None, True), (True, False, False),
    (False, True, True)])
def test_adamw_fused_none_follows_the_flag(monkeypatch, restore_flags, flag,
                                           fused, kernel):
    """``fused=None`` takes the one-pass step exactly when the flag is
    on; an explicit ``fused=`` wins either way. Both routes give the
    same f32 parameters (the fused step is bitwise the eager chain)."""
    calls = []
    step = topt.adamw_step_multi

    def counting(*a, **k):
        calls.append(1)
        return step(*a, **k)
    monkeypatch.setattr(topt, "adamw_step_multi", counting)
    flags.set_flags({"fused_optimizer_step": flag})
    rng = np.random.default_rng(0)
    init = rng.normal(size=(3, 5)).astype(np.float32)
    grad = rng.normal(size=(3, 5)).astype(np.float32)
    out = []
    for f in (fused, False):
        p = torch.nn.Parameter(torch.from_numpy(init.copy()))
        opt = AdamW(learning_rate=1e-2, parameters=[p], fused=f)
        for _ in range(2):
            p.grad = torch.from_numpy(grad)
            opt.step()
        out.append(p.detach())
    assert len(calls) == (2 if kernel else 0)
    assert torch.equal(out[0], out[1])


@pytest.fixture
def check_on(restore_flags):
    flags.set_flags({"check_nan_inf": True})
    yield
    flags.set_flags({"check_nan_inf": False})


def test_check_nan_inf_names_the_forward_op(check_on):
    x = torch.tensor([1.0, 0.0])
    with pytest.raises(FloatingPointError, match="aten.log"):
        torch.log(x)
    import paddle2_tpu_torch as paddle
    with pytest.raises(FloatingPointError, match="aten.div"):
        paddle.divide(torch.tensor([1.0]), torch.tensor([0.0]))
    assert torch.equal(torch.exp(x), torch.exp(x))     # finite: no error


def test_check_nan_inf_names_the_backward_op(check_on):
    x = torch.tensor([4.0, 0.0], requires_grad=True)
    y = torch.sqrt(x).sum()                            # finite forward
    with pytest.raises(FloatingPointError,
                       match="in the backward of SqrtBackward0"):
        y.backward()


def test_check_nan_inf_matches_jax_and_switches_off(restore_flags):
    import paddle2_tpu as jpaddle
    jflags.set_flags({"check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError, match="'log'"):
            jpaddle.log(jpaddle.to_tensor(np.array([0.0], np.float32)))
    finally:
        jflags.set_flags({"check_nan_inf": False})
    flags.set_flags({"check_nan_inf": True})
    flags.set_flags({"check_nan_inf": False})
    assert torch.isinf(torch.log(torch.tensor([0.0]))).all()


def test_check_nan_inf_checks_a_kernel_wrapper_not_its_inside(check_on):
    """The plain flash forward masks with -inf inside: its wrapper
    checks only what it returns, and names itself when that is not
    finite."""
    from paddle2_tpu_torch.kernels.flash_attn import flash_fwd
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 8, 16, generator=g) for _ in range(3))
    o, lse = flash_fwd(q, k, v, causal=True)
    assert torch.isfinite(o).all()
    flags.set_flags({"check_nan_inf": False})
    v[0, 0, 3, 0] = float("nan")
    flags.set_flags({"check_nan_inf": True})
    with pytest.raises(FloatingPointError, match="'flash_fwd'"):
        flash_fwd(q, k, v, causal=True)


def test_log_level_sets_the_logger(restore_flags):
    import logging
    for level, want in ((0, logging.WARNING), (1, logging.INFO),
                        (3, logging.DEBUG)):
        flags.set_flags({"FLAGS_log_level": level})
        assert flags.LOGGER.level == want


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
def test_conv_prefer_channels_last_same_result(restore_flags, dtype, atol):
    """The NHWC route inside conv2d returns an NCHW tensor equal to the
    NCHW route's within the convolution's tolerance, and to the JAX
    package's conv2d with its flag on."""
    import paddle2_tpu as jpaddle
    from paddle2_tpu.nn import functional as JF
    from paddle2_tpu_torch.nn.functional import conv2d
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 9, 9)).astype(np.float32)
    w = rng.standard_normal((4, 3, 3, 3)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    tx, tw, tb = (torch.from_numpy(a).to(dtype) for a in (x, w, b))
    ref = conv2d(tx, tw, tb, stride=2, padding=1)
    flags.set_flags({"conv_prefer_channels_last": True})
    got = conv2d(tx, tw, tb, stride=2, padding=1)
    assert got.shape == ref.shape and got.is_contiguous()
    torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                               rtol=atol)
    jflags.set_flags({"conv_prefer_channels_last": True})
    try:
        want = np.asarray(JF.conv2d(jpaddle.to_tensor(x),
                                    jpaddle.to_tensor(w),
                                    jpaddle.to_tensor(b), stride=2,
                                    padding=1).numpy())
    finally:
        jflags.set_flags({"conv_prefer_channels_last": False})
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
