"""RoPE's vector route (``rope_vec_kernel`` in
``paddle2_tpu_torch/kernels/csrc/rope.cu``) on the CPU, where no card
runs it:

- the route rule: the wrapper's ``route`` and the route its launch is
  counted on, on D, the dtypes and each pointer's alignment, through a
  stand-in card (the wrapper told its tensors are on it, the built
  library replaced by a recorder); one C call a launch either way, with
  the C entry's arguments unchanged, and a launch error raises with
  nothing counted;
- a host model of the lane map: a warp a (b, s) row on a persistent
  grid, the row's (head, chunk) pairs to the lanes in turn, advanced by
  adding 32 with no division, ``VEC_PAIRS`` pairs of x chunks loaded
  before the first is computed, the four table chunks loaded once a row
  where the chunk count divides 32 and again where a lane's chunk
  changes; every (row, head, d) pair computed once from table row
  ``(b·S + s) mod T``, bitwise equal to ``rope_reference`` forward and
  backward, at D 128, 64, 80 (5 chunks in bf16, which do not divide
  32) and 512 (64 chunks in f32);
- ``rope_reference`` (what the card holds both routes against), forward
  and ``negate_sin``, against the JAX package's Pallas kernel
  (``pallas_fused.fused_rope(..., interpret=True)``) and its
  ``jax.vjp`` at the stack's H 16 D 128, with ``[S, D]`` and ``[B*S,
  D]`` tables, in bf16 and f32.

Tolerances (``tests/test_torch_rope.py``'s): f32 results to 1e-6 of the
tensor's largest magnitude (XLA may contract a product and the sum into
one rounding); a bf16 result within one bf16 ulp of the larger value
(the port's route computes in f32 and rounds once, as its kernels do).
The host model is held bitwise: it makes the kernel's own roundings.
"""

import contextlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle2_tpu.kernels import pallas_fused
from paddle2_tpu_torch.kernels import _build, row_vec
from paddle2_tpu_torch.kernels import fused_rope as fr
from test_torch_rope import JDT, _close

VEC_WARPS = row_vec.VEC_NT // 32
VEC_PAIRS = 4                          # csrc/rope.cu
CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


class _StandInLibrary:
    def __init__(self, err=0):
        self.calls, self.err = [], err

    def error_string(self, err):
        return b"stand-in error"

    def __getattr__(self, entry):
        return lambda *args: self.calls.append((entry, args)) or self.err


@pytest.fixture
def card(monkeypatch):
    lib = _StandInLibrary()
    monkeypatch.setattr(_build, "on_card", lambda what, *t: True)
    monkeypatch.setattr(_build, "library", lambda name, sigs: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(fr, "rope_reference",
                        lambda *a: pytest.fail("the plain version ran"))
    return lib


def _unaligned(t):
    buf = torch.empty(t.numel() + 16, dtype=t.dtype)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


# ------------------------------------------------------------- the route
@pytest.mark.parametrize("D,xdt,cdt,want", [
    (128, torch.bfloat16, torch.bfloat16, "vec"),
    (128, torch.float32, torch.float32, "vec"),
    (128, torch.bfloat16, torch.float32, "vec"),
    (128, torch.float32, torch.bfloat16, "vec"),
    (64, torch.float16, torch.float16, "vec"),
    (80, torch.bfloat16, torch.bfloat16, "vec"),
    (16, torch.bfloat16, torch.bfloat16, "vec"),
    (24, torch.float32, torch.float32, "vec"),
    (8, torch.bfloat16, torch.bfloat16, "general"),
    (6, torch.bfloat16, torch.bfloat16, "general"),
    (12, torch.float32, torch.float32, "general"),
    (72, torch.bfloat16, torch.bfloat16, "general")])
@pytest.mark.parametrize("neg", [False, True], ids=["fwd", "bwd"])
def test_the_route_follows_the_half_row(card, D, xdt, cdt, want, neg):
    """A half row of a multiple of 16 bytes, on 16-byte boundaries, takes
    the vector route; any other the general one. One C call either way,
    with the entry's arguments as before (rows B*S, H, D, the table's
    rows, both dtype codes, negate_sin); one launch in the total and one
    on the route."""
    B, S, H = 2, 3, 5
    x = torch.randn(B, S, H, D).to(xdt)
    c, s = torch.randn(S, D).to(cdt), torch.randn(S, D).to(cdt)
    before = (fr.rope.launches, dict(fr.rope.route_launches))
    o = fr.rope(x, c, s, negate_sin=neg)
    moved = {k: fr.rope.route_launches[k] - before[1][k] for k in before[1]}
    assert moved == {k: int(k == want) for k in row_vec.ROUTES}
    assert fr.rope.launches == before[0] + 1
    assert fr.route(x, c, s, o) == want
    (entry, args), = card.calls
    assert entry == "rope"
    assert args == (x.data_ptr(), c.data_ptr(), s.data_ptr(), o.data_ptr(),
                    B * S, H, D, S, CODES[xdt], CODES[cdt], int(neg), None)


@pytest.mark.parametrize("what", ["x", "cos", "sin", "o"])
def test_each_pointer_off_a_boundary_takes_the_general_route(what):
    """``route`` asks the half row's bytes and the four pointers the
    vector kernel reads or writes (x, cos, sin, o): any one of them one
    element past a 16-byte boundary is "general"."""
    x = torch.randn(2, 4, 3, 128).to(torch.bfloat16)
    t = {"x": x, "cos": torch.randn(4, 128).to(torch.bfloat16),
         "sin": torch.randn(4, 128).to(torch.bfloat16),
         "o": torch.empty_like(x)}
    assert fr.route(t["x"], t["cos"], t["sin"], t["o"]) == "vec"
    t[what] = _unaligned(t[what])
    assert fr.route(t["x"], t["cos"], t["sin"], t["o"]) == "general"


def test_an_unaligned_view_is_counted_on_the_general_route(card):
    x = _unaligned(torch.randn(2, 4, 3, 128).to(torch.bfloat16))
    c = torch.randn(4, 128).to(torch.bfloat16)
    before = dict(fr.rope.route_launches)
    fr.rope(x, c, c)
    assert fr.rope.route_launches["general"] == before["general"] + 1
    assert fr.rope.route_launches["vec"] == before["vec"]


def test_a_launch_error_raises(card):
    card.err = 719
    x = torch.randn(2, 4, 3, 128).to(torch.bfloat16)
    c = torch.randn(4, 128).to(torch.bfloat16)
    before = (fr.rope.launches, dict(fr.rope.route_launches))
    with pytest.raises(RuntimeError, match="rope: CUDA error 719"):
        fr.rope(x, c, c)
    assert (fr.rope.launches, fr.rope.route_launches) == before


# ------------------------------------------------------------ the lane map
def _model(x, cos, sin, neg, warps, E):
    """``rope_vec_kernel`` on the host, in numpy f32 (each product and
    sum rounded once, as the kernel's ``__fmul_rn``/``__fadd_rn``), with
    chunks of E elements (8 for a 2-byte x, 4 for f32). ``x [B*S, H,
    D]``; returns the output, how often each (row, head, d) was
    computed, the table rows each warp read, and the table loads of each
    lane in each row."""
    rows, H, D = x.shape
    T = cos.shape[0]
    half = D // 2
    C = half // E
    pairs = H * C
    o = np.zeros_like(x)
    seen = np.zeros(x.shape, np.int64)
    table_rows, loads = {}, np.zeros((rows, 32), np.int64)
    step_h, step_c = 32 // C, 32 % C
    for w in range(warps):
        for row in range(w, rows, warps):
            tb = row % T
            table_rows.setdefault(w, []).append(tb)
            for lane in range(32):
                h, c, cur = lane // C, lane % C, -1
                for p0 in range(lane, pairs, 32 * VEC_PAIRS):
                    batch = []
                    for k in range(VEC_PAIRS):
                        if p0 + 32 * k < pairs:
                            assert (h, c) == divmod(p0 + 32 * k, C)
                            batch.append((h, c))
                        h, c = h + step_h, c + step_c
                        if c >= C:
                            h, c = h + 1, c - C
                    for h_, c_ in batch:
                        if c_ != cur:
                            loads[row, lane] += 1
                            cur = c_
                        d = np.arange(c_ * E, c_ * E + E)
                        x1 = x[row, h_, d]
                        x2 = x[row, h_, d + half]
                        c1, c2 = cos[tb, d], cos[tb, d + half]
                        s1, s2 = sin[tb, d], sin[tb, d + half]
                        if neg:
                            s1, s2 = -s1, -s2
                        o[row, h_, d] = x1 * c1 + (-x2) * s1
                        o[row, h_, d + half] = x2 * c2 + x1 * s2
                        seen[row, h_, d] += 1
                        seen[row, h_, d + half] += 1
    return o, seen, table_rows, loads


@pytest.mark.parametrize("D,itemsize", [(128, 2), (128, 4), (64, 2),
                                        (64, 4), (80, 2), (80, 4),
                                        (512, 4)])
@pytest.mark.parametrize("table", ["S", "pos"])
def test_the_lane_map_computes_every_pair_once(D, itemsize, table):
    """Every (row, head, d) once, the table row ``(b·S + s) mod T``, the
    four table chunks loaded once a row by each lane with work where the
    chunk count divides 32 (D 128 and 64), at most once a pair where it
    does not (D 80: 5 chunks in bf16, 10 in f32; D 512 in f32: 64, more
    than a warp's lanes), and the output bitwise
    equal to ``rope_reference``'s, forward and backward, in f32 (the
    model's arithmetic; a 2-byte x only sets the chunk). B2 S5 H7 on 3
    warps: rows that a warp walks twice, heads that leave lanes idle in
    a row's last batch."""
    B, S, H = 2, 5, 7
    rng = np.random.default_rng(D + itemsize)
    x = rng.normal(size=(B * S, H, D)).astype(np.float32)
    T = S if table == "S" else B * S
    cos = rng.normal(size=(T, D)).astype(np.float32)
    sin = rng.normal(size=(T, D)).astype(np.float32)
    E = 16 // itemsize
    C = D // 2 // E
    for neg in (False, True):
        o, seen, table_rows, loads = _model(x, cos, sin, neg, 3, E)
        assert (seen == 1).all()
        assert all(tb == r % T for w, tbs in table_rows.items()
                   for tb, r in zip(tbs, range(w, B * S, 3)))
        busy = np.arange(32) < H * C
        if 32 % C == 0:
            assert (loads[:, busy] == 1).all()
        else:
            assert (loads <= -(-H * C // 32)).all()
            assert (loads[:, busy] >= 1).all()
        ref = fr.rope_reference(torch.from_numpy(x).reshape(B, S, H, D),
                                torch.from_numpy(cos),
                                torch.from_numpy(sin), neg)
        assert np.array_equal(o, ref.reshape(B * S, H, D).numpy())


def test_the_grid_walks_every_row_once():
    """The persistent grid's warps take rows w, w + W, ...: every row
    once for any warp count, and a warp's table row is one modulus a
    row."""
    for rows in (1, 7, 8, 100, 16384):
        for W in (1, 3, 8, 132 * 8 * 3):
            taken = np.zeros(rows, np.int64)
            for w in range(min(W, rows)):
                taken[w::W] += 1
            assert (taken == 1).all()


# ------------------------------- the plain version against Pallas
def _tables(T, D, seed):
    inv = 1.0 / (10000.0 ** (np.arange(0, D, 2) / D))
    ang = (np.random.default_rng(seed).integers(0, 2048, T)[:, None]
           * inv[None])
    full = np.concatenate([ang, ang], axis=1)
    return np.cos(full).astype(np.float32), np.sin(full).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("table", ["S", "pos"])
def test_plain_version_matches_pallas_at_the_stack_width(dtype, table):
    """H 16 D 128 (the stack's heads), forward and the custom_vjp's
    backward (``negate_sin``), with an ``[S, D]`` table and a
    ``position_ids``-gathered ``[B*S, D]`` one."""
    B, S, H, D = 2, 8, 16, 128
    rng = np.random.default_rng(7)
    x, g = (rng.normal(size=(B, S, H, D)).astype(np.float32)
            for _ in range(2))
    cos, sin = _tables(S if table == "S" else B * S, D, seed=3)
    jx, jc, js, jg = (jnp.asarray(a, JDT[dtype]) for a in (x, cos, sin, g))
    out, vjp = jax.vjp(lambda a: pallas_fused.fused_rope(
        a, jc, js, interpret=True), jx)
    (jdx,) = vjp(jg)
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    tx, tc, ts, tg = (torch.from_numpy(a).to(dtype)
                      for a in (x, cos, sin, g))
    got = fr.rope_reference(tx, tc, ts)
    gdx = fr.rope_reference(tg, tc, ts, negate_sin=True)
    assert got.dtype == dtype and gdx.dtype == dtype
    _close(got.float().numpy(), f32(out), dtype, "out")
    _close(gdx.float().numpy(), f32(jdx), dtype, "dx")
