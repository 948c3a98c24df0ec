"""The RMSNorm backward's vector route (``rms_norm_bwd_vec_kernel`` in
``paddle2_tpu_torch/kernels/csrc/rms_norm.cu``) on the CPU, where no card
runs it:

- the route rule: the backward wrapper's ``bwd_route`` and the route
  its launch is counted on, for aligned rows (the vector route) and for
  rows 16-byte vectors cannot take or views off a 16-byte boundary (x,
  do or the weight: the general route), through a stand-in card (the
  wrapper told its tensors are on it, the built library replaced by a
  recorder); one C call a backward either way, and a launch error
  raises with nothing counted;
- the plan: ``row_vec.vec_plan`` with the backward's cap of 4 vectors a
  lane (x, do and the lane's dw sums stay in registers), at most the
  block's 8 warps a row;
- a host model of the kernel's walk and sums: every element of every row
  read once by one lane, every (row, column) product do·x̂ added into
  dw exactly once, in a fixed order (a lane's rows in order, the block's
  row slots in slot order, the blocks' partials by
  ``rms_norm_bwd_reduce_kernel``: 32 columns a block, slices s, s + 8,
  ... of the G partials, then the 8 slices in order); its f32 sums equal the
  float64 ones to 1e-5 and are the same on a second run;
- the shared memory the kernel asks: w in its own type rounded up to 16
  bytes, then H floats of dw, 16-byte aligned, within the card's 227 KB
  at the widest row;
- the plain forward and backward, which the card holds both routes
  against, against the JAX package's Pallas kernel
  (``pallas_fused.fused_rms_norm(..., interpret=True)`` and its
  ``jax.vjp``) at the main path's widths on the same numpy inputs.

Tolerances (``tests/test_torch_rms_norm.py``'s): f32 results to 1e-5
(absolute below 1, relative above), dw to 1e-5 of its largest magnitude;
a bf16 result within one bf16 ulp of the larger of the two values plus
1e-5 of the tensor's largest magnitude.
"""

import contextlib
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from paddle2_tpu.kernels import pallas_fused
from paddle2_tpu_torch.kernels import _build, row_vec
from paddle2_tpu_torch.kernels import fused_rms_norm as frn
from test_torch_rms_norm import EPS, _close, _f32, _inputs

VEC_WARPS = row_vec.VEC_NT // 32
RED_COLS, RED_SLICES = 32, 8          # csrc/rms_norm.cu's reduction
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
    monkeypatch.setattr(frn, "_lib", lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(frn, "bwd_blocks", lambda rows, dev: 3)
    return lib


def _unaligned(t):
    buf = torch.empty(t.numel() + 16, dtype=t.dtype)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def _operands(R, H, xdt, wdt):
    x = torch.randn(R, H).to(xdt)
    return x, torch.randn(H).to(wdt), torch.rand(R) + 0.5, \
        torch.randn(R, H).to(xdt)


# ------------------------------------------------------------- the route
@pytest.mark.parametrize("H,xdt,wdt,want", [
    (2048, torch.bfloat16, torch.bfloat16, "vec"),
    (1024, torch.bfloat16, torch.float32, "vec"),
    (2048, torch.float32, torch.float32, "vec"),
    (8, torch.float16, torch.float16, "vec"),
    (16384, torch.float32, torch.float32, "vec"),
    (771, torch.bfloat16, torch.bfloat16, "general"),
    (6, torch.float32, torch.float32, "general"),
    (1, torch.float32, torch.float32, "general")])
def test_the_route_follows_the_row_width(card, H, xdt, wdt, want):
    """Rows of a multiple of 16 bytes on 16-byte boundaries take the
    vector route, any other width the general one; one C call either
    way, with the rows, the width, both dtype codes and the block cap;
    the call counts one launch in the total and one on its route."""
    x, w, r, do = _operands(5, H, xdt, wdt)
    before = (frn.rms_norm_bwd.launches, dict(frn.rms_norm_bwd.route_launches))
    dx, dw = frn.rms_norm_bwd(x, w, r, do)
    moved = {k: frn.rms_norm_bwd.route_launches[k] - before[1][k]
             for k in before[1]}
    assert moved == {k: int(k == want) for k in row_vec.ROUTES}
    assert frn.rms_norm_bwd.launches == before[0] + 1
    (entry, args), = card.calls
    assert entry == "rms_norm_bwd"
    assert args[:6] == (x.data_ptr(), w.data_ptr(), r.data_ptr(),
                        do.data_ptr(), dx.data_ptr(), dw.data_ptr())
    assert args[7:] == (5, H, CODES[xdt], CODES[wdt], 3, None)
    assert args[6] % 16 == 0                    # the partials' workspace


@pytest.mark.parametrize("what", ["x", "do", "w"])
def test_an_unaligned_operand_takes_the_general_route(card, what):
    """x, do or the weight one element past a 16-byte boundary sends an
    otherwise aligned row to the general route."""
    x, w, r, do = _operands(4, 2048, torch.bfloat16, torch.bfloat16)
    if what == "x":
        x = _unaligned(x)
    elif what == "do":
        do = _unaligned(do)
    else:
        w = _unaligned(w)
    before = dict(frn.rms_norm_bwd.route_launches)
    dx, _ = frn.rms_norm_bwd(x, w, r, do)
    assert frn.rms_norm_bwd.route_launches["general"] == \
        before["general"] + 1
    assert frn.rms_norm_bwd.route_launches["vec"] == before["vec"]


def test_bwd_route_is_the_rule_on_the_call_tensors():
    """``bwd_route`` asks ``row_vec.route`` with the row's bytes and the
    five data pointers the vector kernel reads or writes in 16-byte
    vectors (x, w, do, dx, the workspace): any one off a boundary, or a
    row that is not a whole number of 16-byte vectors, is "general"."""
    x, w, r, do = _operands(3, 64, torch.float32, torch.float32)
    dx, ws = torch.empty_like(x), torch.empty(64)
    assert frn.bwd_route(x, w, do, dx, ws) == "vec"
    for i in range(5):
        args = [x, w, do, dx, ws]
        args[i] = _unaligned(args[i])
        assert frn.bwd_route(*args) == "general"
    x6, do6 = torch.zeros(3, 6), torch.zeros(3, 6)
    assert frn.bwd_route(x6, torch.zeros(6), do6, do6, ws) == "general"


def test_a_vector_route_launch_error_raises(card):
    """A launch the C entry reports as failed raises, naming the entry,
    and counts nothing; the plain version does not run."""
    card.err = 719
    x, w, r, do = _operands(4, 2048, torch.bfloat16, torch.bfloat16)
    before = (frn.rms_norm_bwd.launches, dict(frn.rms_norm_bwd.route_launches))
    with pytest.raises(RuntimeError, match="rms_norm_bwd: CUDA error 719"):
        frn.rms_norm_bwd(x, w, r, do)
    assert (frn.rms_norm_bwd.launches,
            frn.rms_norm_bwd.route_launches) == before


# -------------------------------------------------------------- the plan
@pytest.mark.parametrize("H,size,plan", [
    (2048, 2, (2, 4)), (1024, 2, (1, 4)), (768, 2, (1, 4)),
    (4096, 2, (4, 4)), (16384, 2, (8, 8)), (2048, 4, (4, 4)),
    (1024, 4, (2, 4)), (8192, 4, (8, 8)), (16384, 4, (8, 16)),
    (8, 2, (1, 1)), (64, 4, (1, 1))])
def test_the_backward_plan_caps_a_lane_at_4_vectors(H, size, plan):
    """The stack's H 2048 in bf16 is two warps a row with 4 vectors a
    lane, the docstring's H 1024 one warp; a lane holds more than 4 only
    where the block's 8 warps cannot take the row otherwise (H 16384 in
    bf16, H >= 8192 in f32); the forwards keep their cap of 16."""
    nv = H * size // 16
    wpr, vpl = row_vec.vec_plan(nv, row_vec.BWD_MAX_VPL)
    assert (wpr, vpl) == plan
    assert 32 * wpr * vpl >= nv and wpr <= VEC_WARPS
    assert vpl <= row_vec.BWD_MAX_VPL or wpr == VEC_WARPS
    assert row_vec.vec_plan(nv) == row_vec.vec_plan(nv, row_vec.MAX_VPL)


@pytest.mark.parametrize("wsize", [4, 2])
def test_the_shared_memory_fits_and_aligns(wsize):
    """w in its own type rounded up to 16 bytes, then H f32 dw sums: the
    dw buffer on a 16-byte boundary (16-byte copies to the workspace),
    and the widest row within a block's shared memory beside the static
    buffers."""
    for H in (8, 200, 1024, 2048, 8192, frn.MAX_H):
        w_bytes = (H * wsize + 15) // 16 * 16
        assert w_bytes % 16 == 0 and w_bytes >= H * wsize
        assert w_bytes + 4 * H + 4 * (2 * VEC_WARPS + RED_COLS
                                      * RED_SLICES) <= SMEM


# -------------------------------------------- the walk and the dw sums
def _model(x, do, w, r, G, wpr, E):
    """The vector kernel's walk and sums on the host in f32: block b's
    row slot s takes rows b * rpb + s + i * G * rpb; lane t of the slot
    holds vectors t, t + T, ... of E elements; its dw sums run over its
    rows in order; the block adds its slots in slot order into its
    partial row; ``rms_norm_bwd_reduce_kernel`` adds the G partials of
    each column (slices s, s + 8, ..., then the slices in order). Returns
    dx, dw
    and how often each (row, column) entered dw."""
    R, H = x.shape
    nv, T, rpb = H // E, 32 * wpr, VEC_WARPS // wpr
    vpl = -(-nv // T)
    f = np.float32
    dx = np.zeros((R, H), f)
    parts = np.zeros((G, H), f)
    count = np.zeros((R, H), np.int64)
    for b in range(G):
        block = np.zeros(H, f)
        for s in range(rpb):
            lane_dw = np.zeros(H, f)
            for row in range(b * rpb + s, R, G * rpb):
                cols = [np.arange((t + k * T) * E, (t + k * T + 1) * E)
                        for t in range(T) for k in range(vpl)
                        if t + k * T < nv]
                xh = (x[row] * r[row]).astype(f)
                dy = (do[row] * w).astype(f)
                lane_s = [np.sum((dy[c] * xh[c]).astype(f), dtype=f)
                          for c in cols]
                mt = f(np.sum(np.array(lane_s, f), dtype=f) / f(H))
                for c in cols:
                    lane_dw[c] = (lane_dw[c] + do[row, c] * xh[c]).astype(f)
                    count[row, c] += 1
                dx[row] = (r[row] * (dy - xh * mt)).astype(f)
            block = (block + lane_dw).astype(f) if s else lane_dw
        parts[b] = block
    dw = np.zeros(H, f)
    for grp in range(-(-H // RED_COLS)):
        cols = np.arange(grp * RED_COLS, min(H, grp * RED_COLS + RED_COLS))
        sl = [np.zeros(len(cols), f) for _ in range(RED_SLICES)]
        for k in range(G):
            sl[k % RED_SLICES] = (sl[k % RED_SLICES] + parts[k, cols]) \
                .astype(f)
        tot = np.zeros(len(cols), f)
        for k in range(RED_SLICES):
            tot = (tot + sl[k]).astype(f)
        dw[cols] = tot
    return dx, dw, count


@pytest.mark.parametrize("R,H,size,G", [(37, 64, 4, 3), (64, 256, 2, 5),
                                        (9, 1024, 4, 2), (100, 96, 2, 20),
                                        (5, 2048, 2, 1)])
def test_the_model_takes_every_product_once_in_a_fixed_order(R, H, size, G):
    """Every (row, column) product enters dw once; the model's f32 dw and
    dx equal the float64 backward to 1e-5 and repeat bitwise."""
    rng = np.random.default_rng(R * H)
    x = (rng.normal(size=(R, H)) * 2 + 0.5).astype(np.float32)
    do = rng.normal(size=(R, H)).astype(np.float32)
    w = rng.normal(size=H).astype(np.float32)
    r = (1.0 / np.sqrt((x.astype(np.float64) ** 2).mean(1) + EPS)) \
        .astype(np.float32)
    E = 16 // size
    wpr, _ = row_vec.vec_plan(H // E, row_vec.BWD_MAX_VPL)
    G = min(G, -(-R // (VEC_WARPS // wpr)))
    dx, dw, count = _model(x, do, w, r, G, wpr, E)
    assert (count == 1).all()
    x64, do64, w64 = (a.astype(np.float64) for a in (x, do, w))
    xh = x64 * r[:, None]
    dy = do64 * w64
    dx64 = r[:, None] * (dy - xh * (dy * xh).mean(1, keepdims=True))
    dw64 = (do64 * xh).sum(0)
    assert np.abs(dw - dw64).max() <= 1e-5 * np.abs(dw64).max()
    assert (np.abs(dx - dx64) <= 1e-5 * np.maximum(np.abs(dx64), 1)).all()
    again = _model(x, do, w, r, G, wpr, E)
    assert np.array_equal(again[0], dx) and np.array_equal(again[1], dw)


# -------------------------------- the plain versions against Pallas
@pytest.mark.parametrize("H", [1024, 2048])
@pytest.mark.parametrize("xdt,wdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32)],
                         ids=["f32", "bf16", "x_bf16-w_f32"])
def test_plain_backward_matches_pallas_at_the_main_widths(xdt, wdt, H):
    """The plain forward and backward (what the card holds both routes
    against) against the Pallas kernel and its vjp in interpret mode at
    the docstring's and the stack's widths."""
    (x, w, do), (jx, jw, jdo) = _inputs(16, H, xdt, wdt, seed=H)
    want, jvjp = jax.vjp(lambda a, b: pallas_fused.fused_rms_norm(
        a, b, EPS, interpret=True), jx, jw)
    jdx, jdw = jvjp(jdo)
    o, r = frn.rms_norm_fwd(x, w, EPS)
    dx, dw = frn.rms_norm_bwd(x, w, r, do)
    _close(o.float().numpy(), _f32(want), xdt, "o")
    _close(dx.float().numpy(), _f32(jdx), xdt, "dx")
    _close(dw.float().numpy(), _f32(jdw), wdt, "dw", rel_to_max=True)
