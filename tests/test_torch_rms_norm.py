"""The fused RMSNorm of the port (paddle2_tpu_torch.kernels.fused_rms_norm
and incubate.nn.functional.fused_rms_norm) held against the JAX
package on the same numpy inputs: the plain forward, its saved 1/rms and
the plain backward against the Pallas kernels
(``pallas_fused.fused_rms_norm`` and its ``jax.vjp``, in interpret mode
on the CPU); the public function with every bias/residual combination
against ``paddle2_tpu.incubate.nn.functional.fused_rms_norm``, forward
and gradients; and the wrappers' path to their C entries (a stand-in
library records the calls, as there is no card here).

Tolerances. Both sides compute in f32 and differ only in the order of
their sums: f32 results to 1e-5 (absolute below 1, relative above), dw
to 1e-5 of its largest magnitude. A bf16 result is one rounding of such
an f32 value: within one bf16 ulp (8 significant bits) of the larger of
the two values, plus 1e-5 of the tensor's largest magnitude for values
that cancel to near zero (dx).
"""

import contextlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle2_tpu as paddle
from paddle2_tpu.incubate.nn import functional as JF
from paddle2_tpu.kernels import pallas_fused
from paddle2_tpu_torch.incubate.nn import functional as TF
from paddle2_tpu_torch.kernels import _build
from paddle2_tpu_torch.kernels import fused_rms_norm as frn

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
EPS = 1e-6
# x and w dtypes: f32, bf16, and bf16 activations with an f32 weight
DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.bfloat16, torch.float32)]
# rows that are and are not a multiple of the Pallas row block (512)
GRID = [(rows, H, xdt, wdt) for rows, H in ((37, 128), (64, 384))
        for xdt, wdt in DTYPES]
IDS = [f"R{r}-H{h}-x{str(x)[6:]}-w{str(w)[6:]}" for r, h, x, w in GRID]


def _close(got, want, dtype, what, rel_to_max=False):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    d = np.abs(got - want)
    amax = float(np.abs(want).max())
    if dtype == torch.bfloat16:
        _, e = np.frexp(np.maximum(np.abs(got), np.abs(want)))
        lim = np.ldexp(1.0, e - 8) + 1e-5 * amax
    elif rel_to_max:
        lim = 1e-5 * max(amax, 1e-30) * np.ones_like(d)
    else:
        lim = 1e-5 * np.maximum(np.abs(want), 1.0)
    assert (d <= lim).all(), (what, float((d - lim).max()))


def _inputs(rows, H, xdt, wdt, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, H)) * 2 + 0.5).astype(np.float32)
    w = rng.normal(size=H).astype(np.float32)
    do = rng.normal(size=(rows, H)).astype(np.float32)
    t = [torch.from_numpy(x).to(xdt), torch.from_numpy(w).to(wdt),
         torch.from_numpy(do).to(xdt)]
    j = [jnp.asarray(x, JDT[xdt]), jnp.asarray(w, JDT[wdt]),
         jnp.asarray(do, JDT[xdt])]
    return t, j


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("rows,H,xdt,wdt", GRID, ids=IDS)
def test_plain_forward_matches_pallas(rows, H, xdt, wdt):
    (x, w, _), (jx, jw, _) = _inputs(rows, H, xdt, wdt)
    want, jr = pallas_fused._rmsnorm_fwd(jx, jw, EPS, 512, True)
    got, r = frn.rms_norm_fwd(x, w, EPS)
    assert got.dtype == xdt and want.dtype == JDT[xdt]
    assert r.dtype == torch.float32 and r.shape == (rows,)
    _close(got.float().numpy(), _f32(want), xdt, "o")
    _close(r.numpy(), _f32(jr), torch.float32, "r")
    # the public kernel entry of the JAX package, any leading shape
    want3 = pallas_fused.fused_rms_norm(jx.reshape(1, rows, H), jw, EPS,
                                        interpret=True)
    got3 = frn.fused_rms_norm(x.reshape(1, rows, H), w, EPS)
    _close(got3.float().numpy(), _f32(want3), xdt, "o (3-d)")


@pytest.mark.parametrize("rows,H,xdt,wdt", GRID, ids=IDS)
def test_plain_backward_matches_pallas_vjp(rows, H, xdt, wdt):
    (x, w, do), (jx, jw, jdo) = _inputs(rows, H, xdt, wdt, seed=1)
    _, vjp = jax.vjp(lambda a, b: pallas_fused.fused_rms_norm(
        a, b, EPS, interpret=True), jx, jw)
    jdx, jdw = vjp(jdo)
    _, r = frn.rms_norm_fwd(x, w, EPS)
    dx, dw = frn.rms_norm_bwd(x, w, r, do)
    assert dx.dtype == xdt and dw.dtype == wdt
    _close(dx.float().numpy(), _f32(jdx), xdt, "dx")
    _close(dw.float().numpy(), _f32(jdw), wdt, "dw", rel_to_max=True)


def test_op_backward_is_the_exact_gradient():
    """The custom backward (from the saved r) against torch's autograd of
    the plain forward in float64 arithmetic on the same f32 values."""
    (x, w, do), _ = _inputs(29, 96, torch.float32, torch.float32, seed=2)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    frn.fused_rms_norm(xr, wr, EPS).backward(do)
    xd, wd = (t.double().requires_grad_() for t in (x, w))
    o = xd * torch.rsqrt((xd * xd).mean(-1, keepdim=True) + EPS) * wd
    o.backward(do.double())
    _close(xr.grad.numpy(), xd.grad.numpy(), torch.float32, "dx")
    _close(wr.grad.numpy(), wd.grad.numpy(), torch.float32, "dw", True)


# (norm_bias, bias, residual)
COMBOS = [(nb, b, r) for nb in (False, True) for b in (False, True)
          for r in (False, True)]


@pytest.mark.parametrize("nb,b,r", COMBOS,
                         ids=[f"nb{int(a)}-b{int(c)}-r{int(d)}"
                              for a, c, d in COMBOS])
def test_fused_rms_norm_matches_jax(nb, b, r):
    """``incubate.nn.functional.fused_rms_norm`` with every combination of
    ``norm_bias``, ``bias`` and ``residual``, f32 ``[2, 7, 64]``: the
    return type (a pair only with ``residual``), the outputs and the
    gradients of every input."""
    rng = np.random.default_rng(3)
    shape = (2, 7, 64)
    arrays = {"x": rng.normal(size=shape), "w": rng.normal(size=64),
              "norm_bias": rng.normal(size=64), "bias": rng.normal(size=64),
              "residual": rng.normal(size=shape)}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    dys = [rng.normal(size=shape).astype(np.float32) for _ in range(2)]
    used = ["x", "w"] + [k for k, on in (("norm_bias", nb), ("bias", b),
                                         ("residual", r)) if on]

    def run(fn, leaf, mul):
        leaves = {k: leaf(arrays[k]) for k in used}
        kw = {k: leaves[k] for k in used[2:]}
        out = fn(leaves["x"], leaves["w"], epsilon=EPS, **kw)
        outs = out if isinstance(out, tuple) else (out,)
        assert isinstance(out, tuple) == r
        sum(mul(o, dy) for o, dy in zip(outs, dys)).backward()
        return outs, leaves

    touts, tl = run(TF.fused_rms_norm,
                    lambda a: torch.tensor(a, requires_grad=True),
                    lambda o, dy: (o * torch.from_numpy(dy)).sum())
    jouts, jl = run(JF.fused_rms_norm,
                    lambda a: paddle.to_tensor(a, stop_gradient=False),
                    lambda o, dy: (o * paddle.to_tensor(dy)).sum())
    for t, j in zip(touts, jouts):
        _close(t.detach().numpy(), np.asarray(j.numpy()), torch.float32,
               "out")
    for k in used:
        _close(tl[k].grad.numpy(), np.asarray(jl[k].grad.numpy()),
               torch.float32, f"d{k}", rel_to_max=True)


def test_fused_rms_norm_normalises_the_last_axis_only():
    x, w = torch.zeros(2, 3, 8), torch.ones(8)
    assert TF.fused_rms_norm(x, w, begin_norm_axis=2).shape == x.shape
    with pytest.raises(NotImplementedError):
        TF.fused_rms_norm(x, w, begin_norm_axis=1)


class _StandInLibrary:
    """Records the C entries' arguments in place of the built library."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        return lambda *args: self.calls.append((entry, args)) or 0


@pytest.mark.parametrize("xdt,wdt", [(torch.bfloat16, torch.float32),
                                     (torch.float16, torch.float16)],
                         ids=["x_bf16-w_f32", "x_f16-w_f16"])
def test_wrapper_reaches_its_c_entries(monkeypatch, xdt, wdt):
    """With the wrappers told their tensors are on the card, a forward and
    a backward through ``fused_rms_norm`` call ``rms_norm_fwd`` and
    ``rms_norm_bwd`` in the library once each, with the rows, the width,
    both dtype codes, eps and the block count, and count one launch
    each; the plain versions do not run."""
    lib = _StandInLibrary()
    monkeypatch.setattr(_build, "on_card", lambda what, *t: True)
    monkeypatch.setattr(frn, "_lib", lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(frn, "bwd_blocks", lambda rows, dev: 3)
    for n in ("rms_norm_fwd_reference", "rms_norm_bwd_reference"):
        monkeypatch.setattr(frn, n, lambda *a: pytest.fail("plain ran"))
    x = torch.zeros(2, 5, 64, dtype=xdt, requires_grad=True)
    w = torch.ones(64, dtype=wdt, requires_grad=True)
    before = (frn.rms_norm_fwd.launches, frn.rms_norm_bwd.launches)
    TF.fused_rms_norm(x, w, epsilon=1e-5).backward(torch.ones_like(x))
    assert (frn.rms_norm_fwd.launches - before[0],
            frn.rms_norm_bwd.launches - before[1]) == (1, 1)
    codes = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
    fwd, bwd = lib.calls
    # rms_norm_fwd: x, w, o, r, R, H, x dtype, w dtype, eps, stream
    # rms_norm_bwd: x, w, r, do, dx, dw, ws, R, H, x dtype, w dtype, G, ...
    assert fwd[0] == "rms_norm_fwd" and fwd[1][4:] == (
        10, 64, codes[xdt], codes[wdt], 1e-5, None)
    assert bwd[0] == "rms_norm_bwd" and bwd[1][7:] == (
        10, 64, codes[xdt], codes[wdt], 3, None)
    assert bwd[1][2] == fwd[1][3]            # the forward's r


@pytest.mark.parametrize("bad", ["dtype", "weight", "width", "layout"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    x, w = torch.zeros(4, 8), torch.ones(8)
    if bad == "dtype":
        x = x.double()
    elif bad == "weight":
        w = torch.ones(9)
    elif bad == "width":
        x, w = torch.zeros(1, frn.MAX_H + 1), torch.ones(frn.MAX_H + 1)
    else:
        x = torch.zeros(8, 4).t()
    with pytest.raises(ValueError):
        frn.rms_norm_fwd(x, w, EPS)


def test_cpu_call_launches_no_kernel():
    before = (frn.rms_norm_fwd.launches, frn.rms_norm_bwd.launches)
    x = torch.ones(3, 16, requires_grad=True)
    TF.fused_rms_norm(x, torch.ones(16)).sum().backward()
    assert (frn.rms_norm_fwd.launches,
            frn.rms_norm_bwd.launches) == before
