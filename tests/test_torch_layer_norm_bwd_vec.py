"""The LayerNorm backward's vector route (``layer_norm_bwd_vec_kernel`` in
``paddle2_tpu_torch/kernels/csrc/layer_norm.cu``) on the CPU, where no
card runs it:

- the route rule: the backward wrapper's ``bwd_route`` and the route its
  launch is counted on, for aligned rows (the vector route) and for rows
  16-byte vectors cannot take or views off a 16-byte boundary (x, dy or
  γ: the general route), through a stand-in card (the wrapper told its
  tensors are on it, the built library replaced by a recorder); one C
  call a backward either way, and a launch error raises with nothing
  counted;
- the plan: ``row_vec.vec_plan`` with the backward's cap of
  ``LN_BWD_MAX_VPL`` vectors a lane (x, dy and the lane's dγ and dβ sums
  stay in registers), at most the block's 8 warps a row;
- a host model of the kernel's walk and sums: every element of every row
  read once by one lane, every (row, column) product dy·x̂ and every dy
  added into dγ and dβ exactly once, in a fixed order (a lane's rows in
  order, the block's row slots in slot order, the blocks' partials by
  ``layer_norm_bwd_reduce_kernel``: 32 columns a block, dγ's and dβ's in
  blocks of their own, slices s, s + 8, ... of the G partials, then the 8
  slices in order); its f32 sums equal the float64 ones to 1e-5 and are
  the same on a second run;
- the shared memory the kernel asks: γ in its own type rounded up to 16
  bytes, then H floats each of dγ and dβ, 16-byte aligned, within the
  card's 227 KB at the widest row;
- the plain backward, which the card holds both routes against, against
  the JAX package's Pallas kernel (``pallas_ln.fused_layer_norm`` and its
  ``jax.vjp``, in interpret mode, its default on the CPU) at ERNIE's H
  768 and the GPT bench's H 1024, x and γ in f32 and bf16, on the same
  numpy inputs.

Tolerances (``tests/test_torch_layer_norm.py``'s): f32 results to 1e-5
(absolute below 1, relative above), dγ and dβ to 1e-5 of their largest
magnitude; a bf16 result within one bf16 ulp of the larger of the two
values plus 1e-5 of the tensor's largest magnitude.
"""

import contextlib
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from paddle2_tpu.kernels import pallas_ln
from paddle2_tpu.kernels.pallas_flash import _interpret_default
from paddle2_tpu_torch.kernels import _build, row_vec
from paddle2_tpu_torch.kernels import fused_layer_norm as fln
from test_torch_layer_norm import EPS, _close, _f32, _inputs

VEC_WARPS = row_vec.VEC_NT // 32
RED_COLS, RED_SLICES = 32, 8          # csrc/layer_norm.cu's reduction
SMEM = 232448                         # an H100 block's shared memory
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
    """The backward wrapper on a stand-in card, with 3 blocks."""
    lib = _StandInLibrary()
    monkeypatch.setattr(_build, "on_card", lambda what, *t: True)
    monkeypatch.setattr(fln, "_lib", lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(fln, "bwd_blocks", lambda rows, dev: 3)
    return lib


def _unaligned(t):
    buf = torch.empty(t.numel() + 16, dtype=t.dtype)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def _operands(R, H, xdt, gdt):
    return (torch.randn(R, H).to(xdt), torch.randn(H).to(gdt),
            torch.randn(R, H).to(xdt))


# ------------------------------------------------------------- the route
@pytest.mark.parametrize("H,xdt,gdt,want", [
    (768, torch.bfloat16, torch.bfloat16, "vec"),
    (768, torch.bfloat16, torch.float32, "vec"),
    (1024, torch.bfloat16, torch.bfloat16, "vec"),
    (768, torch.float32, torch.float32, "vec"),
    (768, torch.float16, torch.float32, "vec"),
    (8192, torch.float32, torch.float32, "vec"),
    (200, torch.bfloat16, torch.float32, "vec"),
    (8, torch.float16, torch.float16, "vec"),
    (771, torch.bfloat16, torch.bfloat16, "general"),
    (771, torch.float32, torch.float32, "general"),
    (6, torch.float32, torch.float32, "general"),
    (1, torch.float32, torch.float32, "general")])
def test_the_route_follows_the_row_width(card, H, xdt, gdt, want):
    """Rows of a multiple of 16 bytes on 16-byte boundaries take the
    vector route, any other width the general one; one C call either
    way, with the rows, the width, both dtype codes, eps and the block
    cap; the call counts one launch in the total and one on its route."""
    x, g, dy = _operands(5, H, xdt, gdt)
    before = (fln.layer_norm_bwd.launches,
              dict(fln.layer_norm_bwd.route_launches))
    dx, dg, db = fln.layer_norm_bwd(x, g, dy, 1e-12)
    moved = {k: fln.layer_norm_bwd.route_launches[k] - before[1][k]
             for k in before[1]}
    assert moved == {k: int(k == want) for k in row_vec.ROUTES}
    assert fln.layer_norm_bwd.launches == before[0] + 1
    (entry, args), = card.calls
    assert entry == "layer_norm_bwd"
    assert args[:6] == (x.data_ptr(), g.data_ptr(), dy.data_ptr(),
                        dx.data_ptr(), dg.data_ptr(), db.data_ptr())
    assert args[7:11] == (5, H, CODES[xdt], CODES[gdt])
    assert args[11] == pytest.approx(1e-12) and args[12:] == (3, None)
    assert args[6] % 16 == 0                    # the partials' workspace


@pytest.mark.parametrize("what", ["x", "dy", "g"])
def test_an_unaligned_operand_takes_the_general_route(card, what):
    """x, dy or γ one element past a 16-byte boundary sends an otherwise
    aligned row to the general route."""
    x, g, dy = _operands(4, 768, torch.bfloat16, torch.bfloat16)
    if what == "x":
        x = _unaligned(x)
    elif what == "dy":
        dy = _unaligned(dy)
    else:
        g = _unaligned(g)
    before = dict(fln.layer_norm_bwd.route_launches)
    fln.layer_norm_bwd(x, g, dy, 1e-12)
    assert fln.layer_norm_bwd.route_launches["general"] == \
        before["general"] + 1
    assert fln.layer_norm_bwd.route_launches["vec"] == before["vec"]


def test_bwd_route_is_the_rule_on_the_call_tensors():
    """``bwd_route`` asks ``row_vec.route`` with the row's bytes and the
    five data pointers the vector kernel reads or writes in 16-byte
    vectors or stages (x, γ, dy, dx, the workspace): any one off a
    boundary, or a row that is not a whole number of 16-byte vectors, is
    "general"."""
    x, g, dy = _operands(3, 64, torch.float32, torch.float32)
    dx, ws = torch.empty_like(x), torch.empty(2 * 64)
    assert fln.bwd_route(x, g, dy, dx, ws) == "vec"
    for i in range(5):
        args = [x, g, dy, dx, ws]
        args[i] = _unaligned(args[i])
        assert fln.bwd_route(*args) == "general"
    x6 = torch.zeros(3, 6)
    assert fln.bwd_route(x6, torch.zeros(6), x6, x6, ws) == "general"


def test_a_vector_route_launch_error_raises(card):
    """A launch the C entry reports as failed raises, naming the entry,
    and counts nothing; the plain version does not run."""
    card.err = 719
    x, g, dy = _operands(4, 768, torch.bfloat16, torch.bfloat16)
    before = (fln.layer_norm_bwd.launches,
              dict(fln.layer_norm_bwd.route_launches))
    with pytest.raises(RuntimeError, match="layer_norm_bwd: CUDA error 719"):
        fln.layer_norm_bwd(x, g, dy, 1e-12)
    assert (fln.layer_norm_bwd.launches,
            fln.layer_norm_bwd.route_launches) == before


# -------------------------------------------------------------- the plan
@pytest.mark.parametrize("H,size,plan", [
    (768, 2, (2, 2)), (1024, 2, (2, 2)), (768, 4, (4, 2)),
    (1024, 4, (4, 2)), (2048, 2, (4, 2)), (4096, 2, (8, 2)),
    (8192, 2, (8, 4)), (4096, 4, (8, 4)), (8192, 4, (8, 8)),
    (200, 2, (1, 1)), (8, 2, (1, 1)), (64, 4, (1, 1))])
def test_the_backward_plan_caps_a_lane(H, size, plan):
    """The cap is 2 vectors a lane: ERNIE's H 768 and the GPT bench's H
    1024 in bf16 are two warps a row with 2 vectors a lane (at H 768 half
    the lanes use one); a lane holds more than the cap only where the
    block's 8 warps cannot take the row otherwise (H 8192 in bf16, H >=
    4096 in f32), and no bf16 or f16 row takes 8."""
    assert row_vec.LN_BWD_MAX_VPL == 2
    nv = H * size // 16
    wpr, vpl = row_vec.vec_plan(nv, row_vec.LN_BWD_MAX_VPL)
    assert (wpr, vpl) == plan
    assert 32 * wpr * vpl >= nv and wpr <= VEC_WARPS
    assert vpl <= row_vec.LN_BWD_MAX_VPL or wpr == VEC_WARPS
    assert vpl <= 8 and (vpl < 8 or size == 4)


@pytest.mark.parametrize("gsize", [4, 2])
def test_the_shared_memory_fits_and_aligns(gsize):
    """γ in its own type rounded up to 16 bytes, then H f32 dγ sums and
    H f32 dβ sums: both on 16-byte boundaries (16-byte copies to the
    workspace), and the widest row within a block's shared memory beside
    the static buffers (two exchange buffers)."""
    for H in (8, 200, 768, 1024, 4096, fln.MAX_H):
        g_bytes = (H * gsize + 15) // 16 * 16
        assert g_bytes % 16 == 0 and g_bytes >= H * gsize
        assert (g_bytes + 4 * H) % 16 == 0
        assert g_bytes + 8 * H + 4 * (2 * VEC_WARPS + 4 * VEC_WARPS) \
            <= SMEM


# ------------------------------------- the walk and the dγ, dβ sums
def _reduce(parts, G, H):
    """``layer_norm_bwd_reduce_kernel`` on one sum's G partial rows."""
    f = np.float32
    out = np.zeros(H, f)
    for grp in range(-(-H // RED_COLS)):
        cols = np.arange(grp * RED_COLS, min(H, grp * RED_COLS + RED_COLS))
        sl = [np.zeros(len(cols), f) for _ in range(RED_SLICES)]
        for k in range(G):
            sl[k % RED_SLICES] = (sl[k % RED_SLICES] + parts[k, cols]) \
                .astype(f)
        tot = np.zeros(len(cols), f)
        for k in range(RED_SLICES):
            tot = (tot + sl[k]).astype(f)
        out[cols] = tot
    return out


def _model(x, dy, g, eps, G, wpr, E):
    """The vector kernel's walk and sums on the host in f32: block b's
    row slot s takes rows b * rpb + s + i * G * rpb; lane t of the slot
    holds vectors t, t + T, ... of E elements; the row's statistics are
    the mean, then the mean square of the centred row; the lanes' dγ and
    dβ sums run over their rows in order; the block adds its slots in
    slot order into its partial rows; the reduction adds the G partials
    of each column. Returns dx, dγ, dβ and how often each (row, column)
    entered each sum."""
    R, H = x.shape
    nv, T, rpb = H // E, 32 * wpr, VEC_WARPS // wpr
    vpl = -(-nv // T)
    f = np.float32
    dx = np.zeros((R, H), f)
    pg, pb = np.zeros((G, H), f), np.zeros((G, H), f)
    count = np.zeros((2, R, H), np.int64)
    inv_h = f(1.0) / f(H)
    cols = [np.arange((t + k * T) * E, (t + k * T + 1) * E)
            for t in range(T) for k in range(vpl) if t + k * T < nv]
    for b in range(G):
        for s in range(rpb):
            lane_g, lane_b = np.zeros(H, f), np.zeros(H, f)
            for row in range(b * rpb + s, R, G * rpb):
                xr, dr = x[row], dy[row]
                m = f(np.sum([np.sum(xr[c], dtype=f) for c in cols],
                             dtype=f) * inv_h)
                xc = (xr - m).astype(f)
                v = f(np.sum([np.sum((xc[c] * xc[c]).astype(f), dtype=f)
                              for c in cols], dtype=f) * inv_h)
                r = f(1.0 / np.sqrt(np.float64(v) + eps))
                xh = (xc * r).astype(f)
                dxh = (dr * g).astype(f)
                m1 = f(np.sum([np.sum(dxh[c], dtype=f) for c in cols],
                              dtype=f) * inv_h)
                m2 = f(np.sum([np.sum((dxh[c] * xh[c]).astype(f), dtype=f)
                               for c in cols], dtype=f) * inv_h)
                for c in cols:
                    lane_g[c] = (lane_g[c] + (dr[c] * xh[c]).astype(f)) \
                        .astype(f)
                    lane_b[c] = (lane_b[c] + dr[c]).astype(f)
                    count[:, row, c] += 1
                dx[row] = ((dxh - m1 - (xh * m2).astype(f)) * r).astype(f)
            if s:
                pg[b] = (pg[b] + lane_g).astype(f)
                pb[b] = (pb[b] + lane_b).astype(f)
            else:
                pg[b], pb[b] = lane_g, lane_b
    return dx, _reduce(pg, G, H), _reduce(pb, G, H), count


@pytest.mark.parametrize("R,H,size,G", [(37, 64, 4, 3), (64, 256, 2, 5),
                                        (9, 768, 2, 2), (100, 96, 2, 20),
                                        (20, 1024, 4, 4), (5, 2048, 2, 1)])
def test_the_model_takes_every_product_once_in_a_fixed_order(R, H, size, G):
    """Every (row, column) dy·x̂ and dy enters dγ and dβ once; the
    model's f32 dγ, dβ and dx equal the float64 backward to 1e-5 and
    repeat bitwise."""
    rng = np.random.default_rng(R * H)
    x = (rng.normal(size=(R, H)) * 2 + 0.5).astype(np.float32)
    dy = rng.normal(size=(R, H)).astype(np.float32)
    g = rng.normal(size=H).astype(np.float32)
    eps = 1e-12 if H == 768 else 1e-5
    E = 16 // size
    wpr, _ = row_vec.vec_plan(H // E, row_vec.LN_BWD_MAX_VPL)
    G = min(G, -(-R // (VEC_WARPS // wpr)))
    dx, dg, db, count = _model(x, dy, g, eps, G, wpr, E)
    assert (count == 1).all()
    x64, dy64, g64 = (a.astype(np.float64) for a in (x, dy, g))
    xc = x64 - x64.mean(1, keepdims=True)
    r = 1.0 / np.sqrt((xc * xc).mean(1, keepdims=True) + eps)
    xh = xc * r
    dxh = dy64 * g64
    dx64 = (dxh - dxh.mean(1, keepdims=True)
            - xh * (dxh * xh).mean(1, keepdims=True)) * r
    dg64, db64 = (dy64 * xh).sum(0), dy64.sum(0)
    assert np.abs(dg - dg64).max() <= 1e-5 * np.abs(dg64).max()
    assert np.abs(db - db64).max() <= 1e-5 * np.abs(db64).max()
    assert (np.abs(dx - dx64) <= 1e-5 * np.maximum(np.abs(dx64), 1)).all()
    again = _model(x, dy, g, eps, G, wpr, E)
    assert all(np.array_equal(a, b) for a, b in zip(again[:3], (dx, dg, db)))


# -------------------------------- the plain backward against Pallas
@pytest.mark.parametrize("H", [768, 1024])
@pytest.mark.parametrize("xdt,gdt", [(torch.float32, torch.float32),
                                     (torch.float32, torch.bfloat16),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32)],
                         ids=["f32", "x_f32-g_bf16", "bf16",
                              "x_bf16-g_f32"])
def test_plain_backward_matches_pallas_at_the_main_widths(xdt, gdt, H):
    """The plain backward (what the card holds both routes against)
    against the Pallas kernel's vjp in interpret mode at ERNIE's and the
    GPT bench's widths (ERNIE's eps 1e-12 at H 768)."""
    (x, g, b, dy), (jx, jg, jb, jdy) = _inputs(16, H, xdt, gdt, seed=H)
    eps = EPS.get(H, 1e-5)
    assert _interpret_default()
    _, vjp = jax.vjp(lambda a, w, c: pallas_ln.fused_layer_norm(
        a, w, c, eps), jx, jg, jb)
    jdx, jdg, jdb = vjp(jdy)
    dx, dg, db = fln.layer_norm_bwd(x, g, dy, eps)
    assert dx.dtype == xdt and dg.dtype == gdt and db.dtype == gdt
    _close(dx.float().numpy(), _f32(jdx), xdt, "dx")
    _close(dg.float().numpy(), _f32(jdg), gdt, "dg", rel_to_max=True)
    _close(db.float().numpy(), _f32(jdb), gdt, "db", rel_to_max=True)
