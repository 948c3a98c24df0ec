"""The fused RoPE of the port (paddle2_tpu_torch.kernels.fused_rope and
incubate.nn.functional.fused_rotary_position_embedding) held against the
JAX package on the same numpy inputs: the plain version against the
Pallas kernel (``pallas_fused.fused_rope`` in interpret mode on the
CPU), forward and gradient, with ``[S, D]`` and ``[B*S, D]`` tables; the
kernel's backward on a ``sin`` table whose halves differ; the public
function against ``paddle2_tpu.incubate.nn.functional.
fused_rotary_position_embedding``; and the wrapper's path to its C entry
(a stand-in library records the calls, as there is no card here).

On the CPU the JAX public function takes its XLA route, which computes
in the input dtype, where the port's kernel route computes in f32 on
both devices. So the public functions are held against each other in
f32; a bf16 call is held against the interpreted kernel.

Tolerances. Both sides compute ``x·cos + rot(x)·sin`` in f32, and XLA
may contract a product and the sum into one rounding where torch rounds
twice: f32 results to 1e-6 of the tensor's largest magnitude, bf16
within one bf16 ulp (8 significant bits) of the larger value.
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
from paddle2_tpu_torch.kernels import fused_rope as fr

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
B, S, H, D = 2, 8, 3, 16


def _close(got, want, dtype, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    d = np.abs(got - want)
    if dtype == torch.bfloat16:
        _, e = np.frexp(np.maximum(np.abs(got), np.abs(want)))
        lim = np.ldexp(1.0, e - 8)
    else:
        lim = 1e-6 * max(float(np.abs(want).max()), 1e-30)
    assert (d <= lim).all(), (what, float((d - lim).max()))


def _tables(T, equal_halves=True, seed=0):
    """cos/sin tables of T rows: the half-split convention's angles, or
    (``equal_halves=False``) random values whose two halves differ."""
    if equal_halves:
        inv = 1.0 / (10000.0 ** (np.arange(0, D, 2) / D))
        ang = (np.arange(T)[:, None] * 0.37 + 1.0) * inv[None]
        full = np.concatenate([ang, ang], axis=1)
        return np.cos(full).astype(np.float32), np.sin(full).astype(
            np.float32)
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(T, D)).astype(np.float32),
            rng.normal(size=(T, D)).astype(np.float32))


def _pallas(x, cos, sin, g, dtype):
    """The Pallas kernel's output and its custom_vjp's x gradient."""
    jx, jc, js, jg = (jnp.asarray(a, JDT[dtype]) for a in (x, cos, sin, g))
    out, vjp = jax.vjp(lambda a: pallas_fused.fused_rope(
        a, jc, js, interpret=True), jx)
    (dx,) = vjp(jg)
    f = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    return f(out), f(dx)


def _port(x, cos, sin, g, dtype):
    tx = torch.tensor(x).to(dtype).requires_grad_()
    out = fr.fused_rope(tx, torch.tensor(cos).to(dtype),
                        torch.tensor(sin).to(dtype))
    out.backward(torch.tensor(g).to(dtype))
    assert out.dtype == dtype and tx.grad.dtype == dtype
    return out.detach().float().numpy(), tx.grad.float().numpy()


CASES = [(dt, T) for dt in (torch.float32, torch.bfloat16)
         for T in (S, B * S)]


@pytest.mark.parametrize("dtype,T", CASES,
                         ids=[f"{str(d)[6:]}-T{t}" for d, t in CASES])
def test_plain_version_matches_the_pallas_kernel(dtype, T):
    """Forward and gradient, with an ``[S, D]`` table (the Pallas wrapper
    tiles it B times; the port reads row ``s`` of it) and a gathered
    ``[B*S, D]`` one."""
    rng = np.random.default_rng(1)
    x, g = (rng.normal(size=(B, S, H, D)).astype(np.float32)
            for _ in range(2))
    cos, sin = _tables(T)
    want, wdx = _pallas(x, cos, sin, g, dtype)
    got, gdx = _port(x, cos, sin, g, dtype)
    _close(got, want, dtype, "out")
    _close(gdx, wdx, dtype, "dx")


def test_backward_is_the_pallas_minus_sin_rotation_for_unequal_sin_halves():
    """The reference behaviour: the kernel's backward rotates the output
    gradient by ``(cos, -sin)``, the transpose of the forward only when
    the two halves of each ``sin`` row are equal. With halves that
    differ, the port gives the Pallas route's gradient, not the autodiff
    gradient of the forward's formula (which differs by O(1) here)."""
    rng = np.random.default_rng(2)
    x, g = (rng.normal(size=(B, S, H, D)).astype(np.float32)
            for _ in range(2))
    cos, sin = _tables(S, equal_halves=False)
    _, wdx = _pallas(x, cos, sin, g, torch.float32)
    _, gdx = _port(x, cos, sin, g, torch.float32)
    _close(gdx, wdx, torch.float32, "dx")
    tx = torch.tensor(x, requires_grad=True)
    fr.rope_reference(tx, torch.tensor(cos), torch.tensor(sin)).backward(
        torch.tensor(g))
    assert np.abs(tx.grad.numpy() - gdx).max() > 0.5
    # with equal halves the kernel's backward is the exact gradient
    cos, sin = _tables(S)
    _, gdx = _port(x, cos, sin, g, torch.float32)
    tx.grad = None
    fr.rope_reference(tx, torch.tensor(cos), torch.tensor(sin)).backward(
        torch.tensor(g))
    _close(gdx, tx.grad.numpy(), torch.float32, "dx (equal halves)")


def _qkv(seed=3, shape=(B, S, H, D)):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]


def _run_both(kw_t, kw_j, n_in=2):
    """The public function on both sides with q (and k, v) from numpy, in
    f32; returns the outputs and the inputs (their gradients of ``sum(out
    · g)`` set)."""
    q, k, v, g = _qkv()
    arrays = [q, k, v][:n_in]
    tl = [torch.tensor(a, requires_grad=True) for a in arrays]
    jl = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    touts = TF.fused_rotary_position_embedding(*tl, **kw_t)
    jouts = JF.fused_rotary_position_embedding(*jl, **kw_j)
    assert len(touts) == len(jouts) == 3
    assert [o is None for o in touts] == [o is None for o in jouts]
    sum((o * torch.tensor(g)).sum() for o in touts
        if o is not None).backward()
    sum((o * paddle.to_tensor(g)).sum() for o in jouts
        if o is not None).backward()
    return touts, jouts, tl, jl


STYLES = [(neox, n_in) for neox in (False, True) for n_in in (1, 2, 3)]


@pytest.mark.parametrize("neox,n_in", STYLES,
                         ids=[f"{'neox' if n else 'half'}-{i}in"
                              for n, i in STYLES])
def test_public_function_matches_jax(neox, n_in):
    """Both styles, with q alone, q and k, and q, k and v (v is rotated
    when passed); the tables built from ``rotary_emb_base``; the outputs
    and the inputs' gradients, f32."""
    kw = dict(use_neox_rotary_style=neox, rotary_emb_base=500.0)
    touts, jouts, tl, jl = _run_both(kw, kw, n_in)
    for t, j in zip(touts, jouts):
        if t is not None:
            _close(t.detach().numpy(), np.asarray(j.numpy()),
                   torch.float32, "out")
    for t, j in zip(tl, jl):
        _close(t.grad.numpy(), np.asarray(j.grad.numpy()), torch.float32,
               "grad")


@pytest.mark.parametrize("neox", [False, True], ids=["half", "neox"])
def test_position_ids_past_seq_len(neox):
    """Positions 100..103 on a sequence of 4 size the table to whole
    buckets of 1024 rows, equal the JAX function, and equal the matching
    window of a rotated longer sequence."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(1, 4, 2, D)).astype(np.float32)
    pos = (np.arange(4)[None] + 100).astype(np.int64)
    out, _, _ = TF.fused_rotary_position_embedding(
        torch.tensor(q), position_ids=torch.tensor(pos),
        use_neox_rotary_style=neox)
    jout, _, _ = JF.fused_rotary_position_embedding(
        paddle.to_tensor(q), position_ids=paddle.to_tensor(pos),
        use_neox_rotary_style=neox)
    _close(out.numpy(), np.asarray(jout.numpy()), torch.float32, "out")
    big = np.concatenate([np.zeros((1, 100, 2, D), np.float32), q], axis=1)
    ref, _, _ = TF.fused_rotary_position_embedding(
        torch.tensor(big), use_neox_rotary_style=neox)
    _close(out.numpy(), ref[:, 100:].numpy(), torch.float32, "window")
    assert any(k[0] == 1024 for k in TF._ANGLE_CACHE)


def test_gathered_positions_and_explicit_tables_match_jax():
    """``position_ids`` (reversed positions, and one past an explicit
    table, which clamps as JAX's gather does) with explicit ``cos``/
    ``sin`` tables, forward and gradient."""
    cos, sin = _tables(S + 3)
    pos = np.tile(np.arange(S)[::-1], (B, 1)).astype(np.int64)
    pos[1, 0] = S + 50
    kt = dict(cos=torch.tensor(cos), sin=torch.tensor(sin),
              position_ids=torch.tensor(pos), use_neox_rotary_style=False)
    kj = dict(cos=paddle.to_tensor(cos), sin=paddle.to_tensor(sin),
              position_ids=paddle.to_tensor(pos),
              use_neox_rotary_style=False)
    touts, jouts, tl, jl = _run_both(kt, kj, 2)
    for t, j in zip(touts[:2], jouts[:2]):
        _close(t.detach().numpy(), np.asarray(j.numpy()), torch.float32,
               "out")
    for t, j in zip(tl, jl):
        _close(t.grad.numpy(), np.asarray(j.grad.numpy()), torch.float32,
               "grad")


def test_explicit_tables_too_long_are_cut_and_too_short_raise():
    q, *_ = _qkv()
    cos, sin = _tables(S + 5)
    out, _, _ = TF.fused_rotary_position_embedding(
        torch.tensor(q), cos=torch.tensor(cos), sin=torch.tensor(sin),
        use_neox_rotary_style=False)
    jout, _, _ = JF.fused_rotary_position_embedding(
        paddle.to_tensor(q), cos=paddle.to_tensor(cos),
        sin=paddle.to_tensor(sin), use_neox_rotary_style=False)
    _close(out.numpy(), np.asarray(jout.numpy()), torch.float32, "out")
    short = torch.tensor(cos[:S - 1])
    with pytest.raises(ValueError, match="seq_len"):
        TF.fused_rotary_position_embedding(torch.tensor(q), cos=short,
                                           sin=short)
    with pytest.raises(ValueError, match="seq_len"):
        JF.fused_rotary_position_embedding(
            paddle.to_tensor(q), cos=paddle.to_tensor(cos[:S - 1]),
            sin=paddle.to_tensor(cos[:S - 1]))


def test_time_major_raises():
    q = torch.zeros(B, S, H, D)
    with pytest.raises(NotImplementedError):
        TF.fused_rotary_position_embedding(q, time_major=True)


def test_bf16_public_call_is_the_kernel_in_f32():
    """A bf16 half-split call rotates by the bf16-rounded tables (built in
    float64, rounded once to the input's dtype, as the JAX package's
    ``_angle_table``) in f32 arithmetic: the interpreted Pallas kernel on
    the JAX package's own bf16 tables."""
    q, *_ = _qkv()
    out, _, _ = TF.fused_rotary_position_embedding(
        torch.tensor(q).to(torch.bfloat16), use_neox_rotary_style=False)
    jc, js = JF._angle_table(S, D, 10000.0, False, "bfloat16")
    tc, ts = TF._angle_table(S, D, 10000.0, False, torch.bfloat16, "cpu")
    assert np.array_equal(np.asarray(jnp.asarray(jc, jnp.float32)),
                          tc.float().numpy())
    want = pallas_fused.fused_rope(jnp.asarray(q, jnp.bfloat16), jc, js,
                                   interpret=True)
    _close(out.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)),
           torch.bfloat16, "out")


class _StandInLibrary:
    """Records the C entries' arguments in place of the built library."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        return lambda *args: self.calls.append((entry, args)) or 0


def test_wrapper_reaches_its_c_entry(monkeypatch):
    """With the wrapper told its tensors are on the card, a half-split
    call on q and k and its backward launch the ``rope`` entry four
    times: two forwards, then two backwards with ``negate_sin`` set, with
    rows B*S, H, D, the table's rows and both dtype codes; the plain
    version does not run."""
    lib = _StandInLibrary()
    monkeypatch.setattr(_build, "on_card", lambda what, *t: True)
    monkeypatch.setattr(_build, "library", lambda name, sigs: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(fr, "rope_reference",
                        lambda *a: pytest.fail("the plain version ran"))
    q, k = (torch.zeros(B, S, H, D, dtype=torch.bfloat16,
                        requires_grad=True) for _ in range(2))
    before = fr.rope.launches
    qo, ko, vo = TF.fused_rotary_position_embedding(
        q, k, use_neox_rotary_style=False)
    assert vo is None
    (qo.float().sum() + ko.float().sum()).backward()
    assert fr.rope.launches == before + 4
    # rope: x, cos, sin, o, rows, H, D, T, x dtype, table dtype, neg, stream
    assert [(e, a[4:]) for e, a in lib.calls] == \
        [("rope", (B * S, H, D, S, 1, 1, 0, None))] * 2 + \
        [("rope", (B * S, H, D, S, 1, 1, 1, None))] * 2


def test_neox_style_launches_no_kernel(monkeypatch):
    monkeypatch.setattr(_build, "on_card",
                        lambda what, *t: pytest.fail("reached a kernel"))
    q = torch.zeros(B, S, H, D)
    TF.fused_rotary_position_embedding(q, q, q)


@pytest.mark.parametrize("bad", ["odd_d", "table_rows", "dtype", "layout"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    x = torch.zeros(B, S, H, D)
    c = torch.zeros(S, D)
    if bad == "odd_d":
        x, c = torch.zeros(B, S, H, 7), torch.zeros(S, 7)
    elif bad == "table_rows":
        c = torch.zeros(S + 1, D)
    elif bad == "dtype":
        x = x.double()
    else:
        x = torch.zeros(B, S, D, H).transpose(2, 3)
    with pytest.raises(ValueError):
        fr.rope(x, c, c)
