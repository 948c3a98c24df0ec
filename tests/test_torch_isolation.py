"""The port stands alone: no module of paddle2_tpu_torch, and not
chip_smoke.py or the port's measuring scripts, imports JAX or the JAX
package, and importing the port builds and loads no kernel."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "paddle2_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "phase_runner.py",
     ROOT / "variant_harness.py"] + sorted(ROOT.glob("*_variants.py"))


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "paddle2_tpu")]
    assert not bad, f"{path.name} imports {bad}"


def test_import_builds_nothing_and_pulls_no_jax():
    code = """
import ctypes, subprocess, sys
import numpy, torch    # before the hooks: torch itself loads with ctypes
calls = []
subprocess.Popen.__init__ = lambda *a, **k: calls.append(a)
ctypes.CDLL.__init__ = lambda *a, **k: calls.append(a)
import paddle2_tpu_torch
import paddle2_tpu_torch.kernels, paddle2_tpu_torch.models
import paddle2_tpu_torch.serving
import paddle2_tpu_torch.optimizer, paddle2_tpu_torch.amp
import paddle2_tpu_torch.jit, paddle2_tpu_torch.quantization
import paddle2_tpu_torch.flags, paddle2_tpu_torch.nn.functional
import paddle2_tpu_torch.vision.models
import paddle2_tpu_torch.incubate.nn, paddle2_tpu_torch.incubate.nn.functional
from paddle2_tpu_torch.kernels import _build
assert not calls, calls
assert not _build._LIBS
assert not any(m == "jax" or m.startswith(("jax.", "paddle2_tpu."))
               or m == "paddle2_tpu" for m in sys.modules), \\
    [m for m in sys.modules if "jax" in m or m.startswith("paddle2_tpu.")]
assert torch.backends.cuda.matmul.allow_tf32 is False
assert torch.backends.cudnn.allow_tf32 is False
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_resolve_device(monkeypatch):
    import torch
    from paddle2_tpu_torch import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")


def test_kernel_sources_are_found():
    from paddle2_tpu_torch.kernels import _build
    names = _build.sources()
    assert set(names) == {"flash_fwd_tf32x3", "paged_decode", "flash_bwd",
                          "adamw_step", "wo_matmul", "layer_norm",
                          "momentum_step", "flash_varlen", "rms_norm",
                          "rope", "adamw_flat", "i8i8_matmul",
                          "flash_fwd_wgmma", "flash_bwd_wgmma",
                          "flash_varlen_wgmma", "flash_varlen_bwd_wgmma",
                          "wo_matmul_wgmma", "flash_bwd_tf32x3"}
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.BUILD_DIR == ROOT / "build" / "paddle2_tpu_torch"
