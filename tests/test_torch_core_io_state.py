"""``paddle2_tpu_torch.save`` / ``load`` (``framework/io_state.py``):
checkpoints that the JAX package's ``paddle2_tpu.save`` wrote load in the
port, float32 and bfloat16, with leaves bitwise equal to the JAX arrays
and without ``ml_dtypes``; a GPT carried across as a file gives the JAX
model's logits (``tests/test_torch_gpt.py``'s atol 1e-4); corrupt and
truncated files raise ``CheckpointCorruptionError``; bare pickles load;
``return_numpy=True`` refuses bfloat16; the port's own files round-trip."""

import io
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle2_tpu as jp
from paddle2_tpu.framework.tensor import Tensor as JTensor
from paddle2_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle2_tpu.models.gpt import gpt_tiny as jax_tiny
import paddle2_tpu_torch as tp
from paddle2_tpu_torch.framework.io_state import CheckpointCorruptionError
from paddle2_tpu_torch.models import (GPTForCausalLM, gpt_state_from_reference,
                                      gpt_tiny)
from torch_core_harness import port_on_cpu  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-4


@pytest.fixture(scope="module")
def jax_gpt():
    jp.seed(0)
    jm = JaxGPT(jax_tiny(use_scan=False))
    jm.eval()
    return jm


@pytest.fixture(scope="module")
def saved(tmp_path_factory, jax_gpt):
    """The JAX GPT's state dict written by ``paddle2_tpu.save``, in
    float32 and bfloat16."""
    d = tmp_path_factory.mktemp("ckpt")
    paths = {}
    for dt in ("float32", "bfloat16"):
        state = {k: (v if dt == "float32" else v.astype(dt))
                 for k, v in jax_gpt.state_dict().items()}
        paths[dt] = d / f"gpt_{dt}.pdparams"
        jp.save(state, str(paths[dt]))
    return paths


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_jax_checkpoint_leaves_are_bitwise(saved, jax_gpt, dt):
    state = tp.load(str(saved[dt]))
    want = {k: np.asarray(v.numpy()) for k, v in
            jax_gpt.state_dict().items()}
    assert set(state) == set(want)
    for k, t in state.items():
        assert t.device.type == "cpu"
        assert str(t.dtype) == f"torch.{dt}"
        w = want[k] if dt == "float32" else np.asarray(
            jp.to_tensor(want[k]).astype(dt).numpy())
        got = t.detach().view(torch.int16).numpy() if dt == "bfloat16" \
            else t.detach().numpy()
        np.testing.assert_array_equal(_bits(got), _bits(w.view(
            np.int16) if dt == "bfloat16" else w))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_gpt_crosses_over_as_a_file(saved, jax_gpt, dt):
    """load -> gpt_state_from_reference -> the port's model gives the
    JAX model's logits (the bfloat16 weights compared in float32 on both
    sides, so the check is of the weights, not of bfloat16 sums)."""
    state = tp.load(str(saved[dt]))
    tm = GPTForCausalLM(gpt_tiny(), device="cpu", seed=1)
    tm.load_state_dict(gpt_state_from_reference(
        {k: v.detach() for k, v in state.items()}))
    jm = jax_gpt
    if dt == "bfloat16":
        jp.seed(0)
        jm = JaxGPT(jax_tiny(use_scan=False))
        jm.eval()
        jm.set_state_dict({k: v.astype(dt).astype("float32")
                           for k, v in jax_gpt.state_dict().items()})
    ids = np.random.default_rng(0).integers(0, 128, (2, 24)).astype(
        np.int32)
    ref = np.asarray(jm(JTensor(ids)).numpy())
    with torch.no_grad():
        out = tm(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_load_without_ml_dtypes(saved):
    """A process where ``ml_dtypes`` cannot be imported (the card's
    machine has none) loads the bfloat16 checkpoint."""
    code = f"""
import sys
sys.modules["ml_dtypes"] = None
import torch, paddle2_tpu_torch as paddle
s = paddle.load({str(saved['bfloat16'])!r})
assert all(t.dtype == torch.bfloat16 for t in s.values())
assert "ml_dtypes" not in sys.modules or sys.modules["ml_dtypes"] is None
assert not any(m == "jax" or m.startswith("paddle2_tpu.")
               for m in sys.modules)
print(len(s))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) == len(tp.load(str(saved["bfloat16"])))


def test_return_numpy(saved):
    arrays = tp.load(str(saved["float32"]), return_numpy=True)
    assert all(isinstance(a, np.ndarray) and a.dtype == np.float32
               for a in arrays.values())
    with pytest.raises(TypeError, match="return_numpy=False"):
        tp.load(str(saved["bfloat16"]), return_numpy=True)


def test_parameters_names_and_stop_gradient(tmp_path):
    p = jp.Parameter(jp.to_tensor(np.ones((2, 2), np.float32)), name="w")
    frozen = jp.Parameter(jp.to_tensor(np.ones(2, np.float32)),
                          name="b", trainable=False)
    buf = jp.to_tensor(np.arange(3, dtype=np.int32))
    live = jp.to_tensor(np.ones(2, np.float32), stop_gradient=False)
    path = tmp_path / "mixed.pd"
    jp.save({"w": p, "b": frozen, "buf": buf, "live": live,
             "meta": {"step": 3, "names": ["a", "b"]}, "raw": np.ones(2)},
            str(path))
    out = tp.load(str(path))
    assert isinstance(out["w"], torch.nn.Parameter) and \
        out["w"].requires_grad and out["w"].paddle_name == "w"
    assert isinstance(out["b"], torch.nn.Parameter) and \
        not out["b"].requires_grad
    assert out["buf"].dtype == torch.int32 and not out["buf"].requires_grad
    assert not isinstance(out["live"], torch.nn.Parameter) and \
        out["live"].requires_grad
    assert out["meta"] == {"step": 3, "names": ["a", "b"]}
    np.testing.assert_array_equal(out["raw"], np.ones(2))
    placed = tp.load(str(path), place="cpu")
    assert placed["w"].device.type == "cpu"


def test_corrupt_and_truncated_files_raise(saved, tmp_path):
    blob = Path(saved["bfloat16"]).read_bytes()
    flipped = bytearray(blob)
    flipped[len(blob) // 2] ^= 0x40
    cases = {"flipped": bytes(flipped), "truncated": blob[:-100],
             "header only": blob[:12]}
    for name, data in cases.items():
        f = tmp_path / name
        f.write_bytes(data)
        with pytest.raises(CheckpointCorruptionError):
            tp.load(str(f))
        with pytest.raises(jp.framework.io_state.CheckpointCorruptionError):
            jp.load(str(f))
    with pytest.raises(ValueError, match="no such file"):
        tp.load(str(tmp_path / "missing"))


def test_bare_pickle_and_envelope_load(jax_gpt):
    """A file from before the integrity header (a bare pickle of the
    payload) and the envelope dict that a stream which cannot seek
    gets both load."""
    from paddle2_tpu.framework import io_state as jio
    state = {k: v for k, v in list(jax_gpt.state_dict().items())[:3]}
    bare = pickle.dumps(jio._to_saveable(state), protocol=4)
    out = tp.load(io.BytesIO(bare))
    for k, v in state.items():
        np.testing.assert_array_equal(out[k].detach().numpy(),
                                      np.asarray(v.numpy()))

    class Pipe(io.RawIOBase):
        def __init__(self):
            self.buf = io.BytesIO()

        def writable(self):
            return True

        def seekable(self):
            return False

        def write(self, b):
            return self.buf.write(b)
    pipe = Pipe()
    jp.save(state, pipe)
    data = pipe.buf.getvalue()
    assert not data.startswith(b"P2TCKPT")
    out = tp.load(io.BytesIO(data))
    assert set(out) == set(state)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16, torch.int32])
def test_port_round_trip(tmp_path, dt):
    t = (torch.randn(3, 5) * 10).to(dt)
    p = torch.nn.Parameter(torch.randn(4).to(torch.bfloat16))
    p.paddle_name = "p0"
    path = tmp_path / "port.pd"
    tp.save({"t": t, "p": p, "list": [t, 1.5]}, str(path))
    assert not (tmp_path / "port.pd.tmp").exists()
    assert path.read_bytes().startswith(b"P2TCKPT\x01")
    out = tp.load(str(path))
    assert out["t"].dtype == dt and torch.equal(out["t"], t)
    assert isinstance(out["p"], torch.nn.Parameter)
    assert torch.equal(out["p"].detach(), p.detach())
    assert out["p"].paddle_name == "p0"
    assert torch.equal(out["list"][0], t) and out["list"][1] == 1.5
    data = tp._io_state.save_to_bytes({"t": t})
    assert torch.equal(tp._io_state.load_from_bytes(data)["t"], t)
    if dt == torch.bfloat16:
        with pytest.raises(TypeError, match="bfloat16"):
            tp._io_state.load_from_bytes(data, return_numpy=True)


def test_save_refuses_and_saves_modules(tmp_path):
    with pytest.raises(TypeError, match="unsupported"):
        tp.save(object(), str(tmp_path / "x"))
    with pytest.raises(ValueError, match="directory"):
        tp.save({}, str(tmp_path))
    m = torch.nn.Linear(2, 3)
    tp.save(m, str(tmp_path / "m.pd"))
    out = tp.load(str(tmp_path / "m.pd"))
    assert set(out) == {"weight", "bias"}
    assert torch.equal(out["weight"], m.weight)


@pytest.mark.parametrize("which", ["gpt", "ernie", "resnet"])
def test_converters_take_torch_tensors(which):
    """The three converters (one ``_from_reference``) map torch tensors as
    they map numpy arrays, and keep a bfloat16 tensor's dtype and bits."""
    from paddle2_tpu_torch.models import convert
    fn, names = {
        "gpt": (convert.gpt_state_from_reference,
                ["gpt.h.0.attn.qkv.weight", "gpt.wte.weight"]),
        "ernie": (convert.ernie_state_from_reference,
                  ["ernie.layers.stacked_attn__qkv__weight",
                   "ernie.embeddings.word_embeddings.weight"]),
        "resnet": (convert.resnet_state_from_reference,
                   ["fc.weight", "conv1.weight"]),
    }[which]
    rng = np.random.default_rng(0)
    state = {n: rng.standard_normal((2, 3, 4)).astype(np.float32)
             for n in names}
    want = fn(state)
    got = fn({k: torch.from_numpy(v) for k, v in state.items()})
    bf = fn({k: torch.from_numpy(v).to(torch.bfloat16)
             for k, v in state.items()})
    for k in want:
        assert torch.equal(got[k], want[k])
        assert bf[k].dtype == torch.bfloat16
        assert torch.equal(bf[k], want[k].to(torch.bfloat16))
        assert bf[k].is_contiguous()
