"""The port's flag registry (paddle2_tpu_torch.flags) against the JAX
package's (paddle2_tpu.flags): the ``FLAGS_`` environment override and
typed coercion, ``set_flags``/``get_flags``, and ``AdamW(fused=None)``
following ``FLAGS_fused_optimizer_step``."""

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
PORTED = ("pallas_layer_norm", "fused_optimizer_step")


@pytest.fixture
def restore_flags():
    before = flags.get_flags()
    yield
    flags.set_flags(before)


def test_the_ported_flags_and_their_defaults_match_jax():
    """The registry holds the two flags the port reads; a process with
    no ``FLAGS_`` in its environment starts them at the JAX defaults."""
    assert set(flags._REGISTRY) == set(PORTED)
    code = ("from paddle2_tpu_torch.flags import get_flags; "
            "print(sorted(get_flags().items()))")
    env = {k: v for k, v in os.environ.items() if not k.startswith("FLAGS_")}
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    want = sorted(("FLAGS_" + n, jflags._REGISTRY[n].default)
                  for n in PORTED)
    assert out.stdout.strip() == str(want)
    assert all(v is False for _, v in want)


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
    assert flags.get_flags(list(PORTED)) == {
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
