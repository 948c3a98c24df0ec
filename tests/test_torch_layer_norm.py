"""The fused LayerNorm of the port (paddle2_tpu_torch.kernels.
fused_layer_norm): its plain forward and backward held against the JAX
package's Pallas kernel (``pallas_ln.fused_layer_norm`` and its
``jax.vjp``, in interpret mode on the CPU) on the same numpy inputs;
the ``FLAGS_pallas_layer_norm`` route of ``nn.functional.layer_norm``
(a float16 call reaches the kernel, as the JAX gate asks no dtype);
the custom op under the "dots" remat policy.

Tolerances. Both sides compute in f32 and differ only in the order of
their sums: f32 outputs to 1e-5 (absolute below 1, relative above) and
dγ/dβ to 1e-5 of their largest magnitude. A bf16 or f16 output is one
rounding of such an f32 value: within one ulp of its type (8 or 11
significant bits) of the larger of the two values, plus 1e-5 of the
tensor's largest magnitude for values that cancel to near zero (dx).
"""

import contextlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle2_tpu.kernels import pallas_ln
from paddle2_tpu.kernels.pallas_flash import _interpret_default
from paddle2_tpu_torch import flags, jit
from paddle2_tpu_torch.framework.core import place_scope
from paddle2_tpu_torch.kernels import _build
from paddle2_tpu_torch.kernels import fused_layer_norm as fln
from paddle2_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle2_tpu_torch.nn import LayerNorm
from paddle2_tpu_torch.nn.functional import layer_norm
from paddle2_tpu_torch.optimizer import AdamW

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.float16: jnp.float16}
# significant bits of the half-precision types
BITS = {torch.bfloat16: 8, torch.float16: 11}


@pytest.fixture
def flag_on():
    before = flags.get_flags("pallas_layer_norm")
    flags.set_flags({"pallas_layer_norm": True})
    yield
    flags.set_flags(before)


def _ulp(v, dtype):
    """One ulp of ``dtype`` (bf16 or f16) at |v|."""
    _, e = np.frexp(np.abs(v))
    return np.ldexp(1.0, e - BITS[dtype])


def _close(got, want, dtype, what, rel_to_max=False):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    d = np.abs(got - want)
    amax = float(np.abs(want).max())
    if dtype in BITS:
        lim = _ulp(np.maximum(np.abs(got), np.abs(want)), dtype) + 1e-5 * amax
    elif rel_to_max:
        lim = 1e-5 * max(amax, 1e-30) * np.ones_like(d)
    else:
        lim = 1e-5 * np.maximum(np.abs(want), 1.0)
    assert (d <= lim).all(), (what, float((d - lim).max()))


def _inputs(rows, H, xdt, gdt, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, H)) * 2 + 0.5).astype(np.float32)
    g = rng.normal(size=H).astype(np.float32)
    b = rng.normal(size=H).astype(np.float32)
    dy = rng.normal(size=(rows, H)).astype(np.float32)
    t = [torch.from_numpy(x).to(xdt), torch.from_numpy(g).to(gdt),
         torch.from_numpy(b).to(gdt), torch.from_numpy(dy).to(xdt)]
    j = [jnp.asarray(x, JDT[xdt]), jnp.asarray(g, JDT[gdt]),
         jnp.asarray(b, JDT[gdt]), jnp.asarray(dy, JDT[xdt])]
    return t, j


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


# x and γ/β dtypes: f32 and bf16 every way, and AMP float16's two pairs
# (f16 activations with f32 γ/β, and with f16 stacked leaves)
DTYPES = [(xdt, gdt) for xdt in (torch.float32, torch.bfloat16)
          for gdt in (torch.float32, torch.bfloat16)] + [
    (torch.float16, torch.float32), (torch.float16, torch.float16)]
GRID = [(rows, H, xdt, gdt) for rows in (16, 64) for H in (128, 768)
        for xdt, gdt in DTYPES]
IDS = [f"R{r}-H{h}-x{str(x)[6:]}-g{str(g)[6:]}" for r, h, x, g in GRID]
# ERNIE's eps at its width, the GPT default elsewhere
EPS = {768: 1e-12, 128: 1e-5}


def test_pallas_runs_in_interpret_mode_here():
    assert _interpret_default()


@pytest.mark.parametrize("rows,H,xdt,gdt", GRID, ids=IDS)
def test_plain_forward_matches_pallas(rows, H, xdt, gdt):
    (x, g, b, _), (jx, jg, jb, _) = _inputs(rows, H, xdt, gdt)
    eps = EPS[H]
    want = pallas_ln.fused_layer_norm(jx, jg, jb, eps)
    got = fln.layer_norm_fwd(x, g, b, eps)
    assert got.dtype == xdt and want.dtype == JDT[xdt]
    _close(got.float().numpy(), _f32(want), xdt, "y")


@pytest.mark.parametrize("rows,H,xdt,gdt", GRID, ids=IDS)
def test_plain_backward_matches_pallas_vjp(rows, H, xdt, gdt):
    (x, g, _, dy), (jx, jg, jb, jdy) = _inputs(rows, H, xdt, gdt, seed=1)
    eps = EPS[H]
    _, vjp = jax.vjp(lambda a, w, c: pallas_ln.fused_layer_norm(a, w, c,
                                                                eps),
                     jx, jg, jb)
    jdx, jdg, jdb = vjp(jdy)
    dx, dg, db = fln.layer_norm_bwd(x, g, dy, eps)
    assert dx.dtype == xdt and dg.dtype == gdt and db.dtype == gdt
    _close(dx.float().numpy(), _f32(jdx), xdt, "dx")
    _close(dg.float().numpy(), _f32(jdg), gdt, "dg", rel_to_max=True)
    _close(db.float().numpy(), _f32(jdb), gdt, "db", rel_to_max=True)


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_op_backward_is_the_plain_backward(xdt):
    """The custom op's registered backward against torch's autograd of
    the plain forward (f32 math), and the CPU wrappers count no launch."""
    (x, g, b, dy), _ = _inputs(8, 200, xdt, torch.float32, seed=2)
    before = (fln.layer_norm_fwd.launches, fln.layer_norm_bwd.launches)
    xs, gs, bs = (t.clone().requires_grad_() for t in (x, g, b))
    fln.fused_layer_norm(xs, gs, bs, 1e-5).backward(dy)
    xr, gr, br = (t.float().clone().requires_grad_() for t in (x, g, b))
    fln.layer_norm_fwd_reference(xr, gr, br, 1e-5).backward(dy.float())
    for got, ref, dt in ((xs, xr, xdt), (gs, gr, torch.float32),
                         (bs, br, torch.float32)):
        _close(got.grad.float().numpy(), ref.grad.to(dt).float().numpy(), dt,
               "grad", rel_to_max=got is not xs)
    assert (fln.layer_norm_fwd.launches,
            fln.layer_norm_bwd.launches) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flag_routes_layer_norm(monkeypatch, dtype):
    """Off: the JAX package's XLA-order path, bit for bit as before (an
    f32 call is ``torch.nn.functional.layer_norm``). On: the fused op,
    whose forward is the plain version on the CPU."""
    calls = []
    plain = fln.layer_norm_fwd_reference

    def counting(*a, **k):
        calls.append(1)
        return plain(*a, **k)
    monkeypatch.setattr(fln, "layer_norm_fwd_reference", counting)
    (x, g, b, _), _ = _inputs(4, 96, dtype, torch.float32, seed=3)
    off = layer_norm(x, 96, g, b, 1e-5)
    if dtype == torch.float32:
        want = torch.nn.functional.layer_norm(x, (96,), g, b, 1e-5)
    else:
        mean = x.mean((-1,), keepdim=True)
        var = x.var((-1,), keepdim=True, correction=0)
        want = (((x - mean) * torch.rsqrt(var + 1e-5)) * g + b).to(dtype)
    assert torch.equal(off, want) and not calls
    before = flags.get_flags("FLAGS_pallas_layer_norm")
    flags.set_flags({"FLAGS_pallas_layer_norm": True})
    try:
        on = layer_norm(x, 96, g, b, 1e-5)
        # still the other route: two normalized axes, a missing bias,
        # H past the kernels' limit
        layer_norm(x.reshape(4, 8, 12), (8, 12), g.reshape(8, 12),
                   b.reshape(8, 12))
        layer_norm(x, 96, g, None)
        big = torch.ones(2, fln.MAX_H + 1, dtype=dtype)
        w = torch.ones(fln.MAX_H + 1)
        layer_norm(big, fln.MAX_H + 1, w, w)
    finally:
        flags.set_flags(before)
    assert len(calls) == 1
    assert torch.equal(on, plain(x, g, b, 1e-5))


def test_layer_norm_module_takes_the_flag(flag_on):
    with place_scope("cpu"):
        ln = LayerNorm(64, epsilon=1e-5)
    x = torch.randn(2, 3, 64, generator=torch.Generator().manual_seed(0))
    y = ln(x)
    y.sum().backward()
    assert torch.equal(y, fln.layer_norm_fwd_reference(x, ln.weight,
                                                       ln.bias, 1e-5))
    assert ln.weight.grad is not None and ln.bias.grad is not None


@pytest.mark.parametrize("stacked", [False, True], ids=["blocks", "stacked"])
@pytest.mark.parametrize("remat,per_step", [("none", 5), ("dots", 9),
                                            ("full", 9)])
def test_dots_remat_recomputes_the_op(monkeypatch, flag_on, stacked, remat,
                                      per_step):
    """gpt_tiny (2 blocks, 2 LayerNorms each, and ln_f) with the flag on:
    without remat 5 fused forwards a step; "dots" keeps matrix products
    and the flash op's outputs but recomputes the LayerNorm op in the
    backward, as the JAX package's remat re-runs its Pallas kernel (4
    more); "full" recomputes it too. One fused backward a LayerNorm."""
    fwd, bwd = [], []
    pf, pb = fln.layer_norm_fwd_reference, fln.layer_norm_bwd_reference
    monkeypatch.setattr(fln, "layer_norm_fwd_reference",
                        lambda *a: fwd.append(1) or pf(*a))
    monkeypatch.setattr(fln, "layer_norm_bwd_reference",
                        lambda *a: bwd.append(1) or pb(*a))
    cfg = gpt_tiny(stacked_blocks=stacked, use_recompute=remat != "none",
                   recompute_granularity="full" if remat == "none"
                   else remat, fused_head_loss=True)
    tm = GPTForCausalLM(cfg, device="cpu", seed=0)
    step = jit.train_step(lambda ids: tm(ids, labels=ids)[1],
                          AdamW(learning_rate=1e-3,
                                parameters=tm.parameters()))
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 16)))
    for _ in range(2):
        step(ids)
    assert len(fwd) == 2 * per_step
    assert len(bwd) == 2 * 5


def test_stacked_bf16_leaves_get_their_gradients(flag_on):
    """The stacked LayerNorm leaves, cast to bf16 under O2, reach the op
    as ``torch.unbind`` slices; the op's dγ/dβ flow back into the leaf,
    equal to the per-block model's."""
    from paddle2_tpu_torch import amp
    grads = {}
    for stacked in (False, True):
        tm = amp.decorate(GPTForCausalLM(gpt_tiny(stacked_blocks=stacked),
                                         device="cpu", seed=4))
        if not stacked:
            for blk in tm.gpt.h:       # the stacked model's leaf dtype
                blk.ln_1.to(torch.bfloat16)
                blk.ln_2.to(torch.bfloat16)
        ids = torch.from_numpy(np.random.default_rng(1).integers(
            0, 128, size=(2, 16)))
        tm(ids, labels=ids)[1].backward()
        grads[stacked] = (
            torch.stack([b.ln_1.weight.grad for b in tm.gpt.h]) if not stacked
            else tm.gpt.h.stacked_leaf("ln_1.weight").grad)
    assert grads[True].dtype == torch.bfloat16
    assert torch.equal(grads[True], grads[False])


class _StandInLibrary:
    """Records the C entries' arguments in place of the built library."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        return lambda *args: self.calls.append((entry, args)) or 0


@pytest.mark.parametrize("gdt", [torch.float32, torch.float16],
                         ids=["g_f32", "g_f16"])
def test_float16_on_the_flag_route_reaches_the_kernels(monkeypatch, flag_on,
                                                       gdt):
    """AMP with ``dtype="float16"`` gives f16 activations with f32 γ/β
    (``emb_ln``) or f16 γ/β (stacked leaves). As the JAX gate asks
    shapes only, both reach the kernels: with the wrappers told they are
    on the card (a stand-in library records the C calls), the forward
    and the backward each launch once, with x's dtype code 2 (f16) and
    γ's own code."""
    lib = _StandInLibrary()
    monkeypatch.setattr(_build, "on_card", lambda what, *t: True)
    monkeypatch.setattr(fln, "_lib", lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(fln, "bwd_blocks", lambda rows, dev: 2)
    (x, g, b, dy), _ = _inputs(4, 64, torch.float16, gdt)
    x.requires_grad_()
    before = (fln.layer_norm_fwd.launches, fln.layer_norm_bwd.launches)
    layer_norm(x, 64, g, b, 1e-5).backward(dy)
    assert (fln.layer_norm_fwd.launches - before[0],
            fln.layer_norm_bwd.launches - before[1]) == (1, 1)
    code = {torch.float32: 0, torch.float16: 2}[gdt]
    # layer_norm_fwd: x, g, b, y, R, H, x dtype, g dtype, eps, stream
    # layer_norm_bwd: x, g, dy, dx, dg, db, ws, R, H, x dtype, g dtype, ...
    assert [(e, a[4:8] if e == "layer_norm_fwd" else a[7:11])
            for e, a in lib.calls] == [
        ("layer_norm_fwd", (4, 64, 2, code)),
        ("layer_norm_bwd", (4, 64, 2, code))]


def test_a_dtype_the_kernels_do_not_take_raises_on_the_flag_route(flag_on):
    """The gate asks no dtype, so a float64 LayerNorm with the flag on
    raises in the fused op, where a quiet turn to the other route would
    hide that the kernels never ran."""
    x = torch.zeros(4, 64, dtype=torch.float64)
    w = torch.ones(64, dtype=torch.float64)
    with pytest.raises(ValueError, match="fused LayerNorm takes"):
        layer_norm(x, 64, w, w)


def test_op_takes_a_weight_and_bias_of_two_dtypes():
    """An f32 weight with a bf16 bias: the op casts the pair to f32
    (exactly: the kernels compute in f32) and each gradient comes back
    in its parameter's dtype."""
    (x, g, b, dy), _ = _inputs(8, 64, torch.bfloat16, torch.float32, seed=5)
    b = b.bfloat16()
    xs, gs, bs = (t.clone().requires_grad_() for t in (x, g, b))
    y = fln.fused_layer_norm(xs, gs, bs, 1e-5)
    y.backward(dy)
    assert torch.equal(y, fln.layer_norm_fwd_reference(x, g, b.float(),
                                                       1e-5))
    dx, dg, db = fln.layer_norm_bwd_reference(x, g, dy, 1e-5)
    assert (gs.grad.dtype, bs.grad.dtype) == (torch.float32, torch.bfloat16)
    assert torch.equal(xs.grad, dx) and torch.equal(gs.grad, dg)
    assert torch.equal(bs.grad, db.to(torch.bfloat16))


@pytest.mark.parametrize("bad", ["f64", "mixed", "wide", "shape"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    """The wrappers raise on both devices for a dtype without a build
    (f64), a weight and bias of two dtypes (the op casts such a pair
    first), H past MAX_H and a γ of the wrong length; the gate
    (``supported``) turns away only the shapes."""
    x = torch.zeros(4, 64)
    g = torch.ones(64)
    b = torch.zeros(64)
    if bad == "f64":
        x = x.double()
    elif bad == "mixed":
        b = b.bfloat16()
    elif bad == "wide":
        x = torch.zeros(2, fln.MAX_H + 1)
        g = b = torch.ones(fln.MAX_H + 1)
    else:
        g = torch.ones(32)
    assert fln.supported(x, g, b) == (bad in ("f64", "mixed"))
    with pytest.raises(ValueError):
        fln.layer_norm_fwd(x, g, b, 1e-5)
    if bad != "mixed":                   # the backward takes no bias
        with pytest.raises(ValueError):
            fln.layer_norm_bwd(x, g, torch.zeros_like(x), 1e-5)
