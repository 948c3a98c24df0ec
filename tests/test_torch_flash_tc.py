"""The tensor-core flash kernels' contract, held on the CPU.

bf16 CUDA tensors reach ``flash_fwd_wgmma.cu`` and
``flash_bwd_wgmma.cu``, f32 ones the CUDA-core kernels, with the same
C arguments; a launch error raises (no fallback); and the plain versions
that chip_smoke.py holds the kernels against on the card agree with the
JAX package's Pallas kernels (interpret mode) at the new kernels' tile
edges: lengths 127/128/129/255 around their 128-row tiles, Sq < Sk, head
dims 16/64/128.

Tolerances are test_torch_flash.py's and test_torch_flash_bwd.py's:
forward f32 1e-5, backward f32 1e-4 (summation order, and where the
scale is applied), both bf16 2e-2 (P and dS rounded to bf16 before each
product, against a running max in the tiled Pallas kernel; the one-tile
Pallas kernels also round q*scale to bf16).
"""

import ast
import contextlib
import math
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle2_tpu.kernels.pallas_flash import _flash_bwd, _flash_fwd
from paddle2_tpu_torch.kernels import _build
from paddle2_tpu_torch.kernels import flash_attn as fa

FWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# (library, C entry) each dtype must reach
FWD_WANT = {torch.bfloat16: ("flash_fwd_wgmma", "flash_fwd_wgmma"),
            torch.float32: ("flash_fwd", "flash_fwd")}
FUSED_WANT = {torch.bfloat16: ("flash_bwd_wgmma", "flash_bwd_fused_wgmma"),
              torch.float32: ("flash_bwd", "flash_bwd_fused")}


class _Recorder:
    """Stands in for the built libraries: records (library, entry, args)
    and returns ``rc`` from every entry."""

    def __init__(self, rc=0):
        self.calls, self.rc = [], rc

    def library(self, name, signatures):
        rec = self

        class _Lib:
            def __getattr__(self, entry):
                if entry == "error_string":
                    return lambda err: b"stand-in launch failure"
                assert entry in signatures, (name, entry)

                def call(*args):
                    assert len(args) == len(signatures[entry])
                    rec.calls.append((name, entry, args))
                    return rec.rc
                return call
        return _Lib()


@pytest.fixture
def on_card(monkeypatch):
    """The wrappers believe their CPU tensors lie on the card and call a
    recorder in place of the built libraries."""
    def install(rc=0):
        rec = _Recorder(rc)
        monkeypatch.setattr(_build, "on_card", lambda what, *t: True)
        monkeypatch.setattr(_build, "library", rec.library)
        monkeypatch.setattr(torch.cuda, "device",
                            lambda d: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda d: SimpleNamespace(cuda_stream=None))
        return rec
    return install


def _qkv(dtype, B=2, H=3, Sq=40, Sk=72, D=64):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(B, H, S, D, generator=g).to(dtype)
            for S in (Sq, Sk, Sk, Sq)]


def _tail(args):
    """The C call's arguments after the pointers: B, H, Sq, Sk, D,
    dtype code, scale, causal (the stream is last)."""
    return args[-9:-1]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_each_dtype_reaches_its_forward_kernel(on_card, dtype):
    rec = on_card()
    q, k, v, _ = _qkv(dtype)
    before = fa.flash_fwd.launches
    fa.flash_fwd(q, k, v, scale=0.125, causal=True)
    assert fa.flash_fwd.launches == before + 1
    [(name, entry, args)] = rec.calls
    assert (name, entry) == FWD_WANT[dtype]
    assert _tail(args) == (2, 3, 40, 72, 64, fa._DTYPE_CODE[dtype], 0.125, 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_each_dtype_reaches_its_fused_backward_kernel(on_card, dtype):
    rec = on_card()
    q, k, v, do = _qkv(dtype)
    lse = torch.zeros(2, 3, 40)
    before = fa.flash_bwd_fused.launches
    dq, dk, dv = fa.flash_bwd(q, k, v, q, lse, do, scale=0.125, causal=True,
                              route="fused")
    assert fa.flash_bwd_fused.launches == before + 1
    assert (dq.dtype, dk.dtype, dv.dtype) == (dtype,) * 3
    [(name, entry, args)] = rec.calls
    assert (name, entry) == FUSED_WANT[dtype]
    assert _tail(args) == (2, 3, 40, 72, 64, fa._DTYPE_CODE[dtype], 0.125, 1)


def test_bf16_inputs_reach_tma_on_16_byte_boundaries(on_card):
    """TMA reads from 16-byte aligned addresses: a contiguous bf16 view
    that starts elsewhere is copied before the launch, and only then."""
    rec = on_card()
    B, H, S, D = 1, 2, 8, 16
    n = B * H * S * D
    buf = torch.randn(3 * n + 1).to(torch.bfloat16)
    q, k, v = (buf[1 + i * n:1 + (i + 1) * n].view(B, H, S, D)
               for i in range(3))
    assert q.data_ptr() % 16 != 0 and q.is_contiguous()
    fa.flash_fwd(q, k, v, causal=True)
    fa.flash_fwd(*(t.clone() for t in (q, k, v)), causal=True)
    (_, _, moved), (_, _, kept) = rec.calls
    assert all(p % 16 == 0 for p in moved[:5])
    assert all(p % 16 == 0 for p in kept[:5])


def test_bf16_and_f32_entries_share_one_c_signature():
    lib = fa._LIBRARIES
    assert lib["flash_fwd_wgmma"]["flash_fwd_wgmma"] == \
        lib["flash_fwd"]["flash_fwd"]
    assert lib["flash_bwd_wgmma"]["flash_bwd_fused_wgmma"] == \
        lib["flash_bwd"]["flash_bwd_fused"]


def test_bf16_backward_by_default_takes_the_tensor_core_kernel(on_card):
    """The default bf16 route is "fused", so a bf16 backward with no
    route named, and a bf16 forward, reach the wgmma kernels only."""
    rec = on_card()
    q, k, v, do = _qkv(torch.bfloat16)
    fa.flash_bwd(q, k, v, q, torch.zeros(2, 3, 40), do, causal=True)
    fa.flash_fwd(q, k, v, causal=False)
    assert [c[1] for c in rec.calls] == ["flash_bwd_fused_wgmma",
                                         "flash_fwd_wgmma"]


def test_split_route_keeps_the_cuda_core_pair_in_bf16(on_card):
    rec = on_card()
    q, k, v, do = _qkv(torch.bfloat16)
    fa.flash_bwd(q, k, v, q, torch.zeros(2, 3, 40), do, route="split")
    assert [c[1] for c in rec.calls] == ["flash_bwd_dkv", "flash_bwd_dq"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("what", ["forward", "fused", "op_backward"])
def test_a_launch_error_raises(on_card, dtype, what):
    """A C entry that reports a CUDA error raises RuntimeError: nothing
    in the wrappers catches it and turns to another kernel or to the
    plain version. ``op_backward`` runs the differentiable op's forward
    on the CPU, then its backward against the failing library."""
    q, k, v, do = _qkv(dtype)
    if what == "op_backward":
        q.requires_grad_()
        o, _ = torch.ops.paddle2_tpu_torch.flash_attn(q, k, v, 0.125, True)
    rec = on_card(rc=719)
    with pytest.raises(RuntimeError, match="CUDA error 719"):
        if what == "forward":
            fa.flash_fwd(q, k, v, causal=True)
        elif what == "fused":
            fa.flash_bwd(q, k, v, q, torch.zeros(2, 3, 40), do,
                         route="fused")
        else:
            o.backward(do)
    want = "flash_fwd" if what == "forward" else "flash_bwd"
    assert len(rec.calls) == 1 and rec.calls[0][0].startswith(want)


def test_plain_backward_gives_its_f32_sums_on_request():
    """``out_dtype=torch.float32`` returns the sums the default output
    rounds (the card holds the tensor-core backward to them)."""
    q, k, v, do = _qkv(torch.bfloat16, Sq=24, Sk=40, D=16)
    o, lse = fa.flash_fwd_reference(q, k, v, 0.25, True)
    sums = fa.flash_bwd_reference(q, k, v, o, lse, do, 0.25, True,
                                  out_dtype=torch.float32)
    rounded = fa.flash_bwd_reference(q, k, v, o, lse, do, 0.25, True)
    for a, b in zip(sums, rounded):
        assert a.dtype == torch.float32 and b.dtype == torch.bfloat16
        assert torch.equal(a.to(torch.bfloat16), b)
    # float64 sums (what exact sums give) keep the bf16 rounding points
    exact = fa.flash_bwd_reference(q, k, v, o, lse, do, 0.25, True,
                                   out_dtype=torch.float64,
                                   sum_dtype=torch.float64)
    for a, b in zip(exact, sums):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a.float(), b, rtol=1e-4, atol=1e-4)


def test_flash_attn_module_has_no_exception_handler():
    tree = ast.parse(Path(fa.__file__).read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


# ------------------------------------------- plain versions against Pallas

def _padded(Sq, Sk, causal, tile=128):
    """Front padding of the queries and end padding of both sides that
    bring (Sq, Sk) to multiples of ``tile`` without changing what a real
    row sees under the bottom-right causal mask: padding both ends by the
    same b keeps Sk - Sq, a front query pad a shifts rows and offset
    alike, and the padded keys lie past every real row's reach. Without
    a mask no padding is exact, so the lengths must be multiples."""
    b = (-Sk) % tile
    a = (-(Sq + b)) % tile
    assert causal or a == b == 0
    return a, b


CASES = [(127, 127, True), (128, 128, True), (129, 129, True),
         (255, 255, True), (129, 255, True), (128, 256, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("Sq,Sk,causal", CASES,
                         ids=[f"{a}-{b}-{'causal' if c else 'full'}"
                              for a, b, c in CASES])
def test_plain_versions_match_pallas_at_tile_edges(dtype, D, Sq, Sk, causal):
    rng = np.random.default_rng(Sq * 7 + Sk + D)
    q, do = (rng.normal(size=(1, 2, Sq, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(1, 2, Sk, D)).astype(np.float32)
            for _ in range(2))
    a, b = _padded(Sq, Sk, causal)
    padq = ((0, 0), (0, 0), (a, b), (0, 0))
    padk = ((0, 0), (0, 0), (0, b), (0, 0))
    jq, jdo = (jnp.asarray(np.pad(t, padq), JD[dtype]) for t in (q, do))
    jk, jv = (jnp.asarray(np.pad(t, padk), JD[dtype]) for t in (k, v))
    scale = 1.0 / math.sqrt(D)
    jo, jlse = _flash_fwd(jq, jk, jv, scale, causal, 128, 128, True)
    want_b = _flash_bwd(jq, jk, jv, jo, jlse, jdo, scale, causal, 128, 128,
                        True)
    rows, keys = slice(a, a + Sq), slice(0, Sk)

    def t(x, dt=dtype):
        return torch.from_numpy(np.array(x, np.float32)).to(
            getattr(torch, dt))

    tq, tk, tv, tdo = t(q), t(k), t(v), t(do)
    o, lse = fa.flash_fwd_reference(tq, tk, tv, scale, causal)
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(jo, np.float32)[:, :, rows],
                               rtol=FWD_TOL[dtype], atol=FWD_TOL[dtype])
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :, rows],
                               rtol=FWD_TOL[dtype], atol=FWD_TOL[dtype])
    # both backwards start from the Pallas forward's (o, lse)
    got = fa.flash_bwd_reference(
        tq, tk, tv, t(np.asarray(jo, np.float32)[:, :, rows]),
        t(np.asarray(jlse)[:, :, rows], "float32"), tdo, scale, causal)
    for g, w, sl in zip(got, want_b, (rows, keys, keys)):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32)[:, :, sl],
                                   rtol=BWD_TOL[dtype], atol=BWD_TOL[dtype])
