"""The norms' vector forwards (``rms_norm_fwd_vec_kernel`` and
``layer_norm_fwd_vec_kernel`` in ``paddle2_tpu_torch/kernels/csrc``) on
the CPU, where no card runs them:

- the route each forward wrapper picks, for every x / parameter dtype
  pair and row width, and for unaligned views, through a stand-in card
  (the wrappers told their tensors are on it, the built libraries
  replaced by recorders); a launch error on the vector route raises and
  nothing else is launched;
- a host model of the vector kernels' index arithmetic
  (``csrc/row_vec.cuh``): lane -> vector -> element, the warps a row,
  the persistent grid's rows, the shared-memory layout of the
  parameters, and the shuffle reduction's sums;
- the plain forwards, which the card holds both kernels against,
  against the JAX package's Pallas kernels (``pallas_fused.
  fused_rms_norm(..., interpret=True)``, ``pallas_ln.fused_layer_norm``
  in interpret mode) on the same numpy inputs.

Tolerances (those of ``test_torch_rms_norm.py`` and
``test_torch_layer_norm.py``): both sides compute in f32 and differ
only in the order of their sums: f32 outputs to 1e-5 (absolute below
1, relative above); a bf16 or f16 output within one ulp of its type of
the larger of the two values, plus 1e-5 of the tensor's largest
magnitude. The shuffle reduction's model is held to the float64 sum at
1e-5 relative (f32 sums of at most 16384 terms of one sign).
"""

import contextlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle2_tpu.kernels import pallas_fused, pallas_ln
from paddle2_tpu_torch.kernels import _build, row_vec
from paddle2_tpu_torch.kernels import fused_layer_norm as fln
from paddle2_tpu_torch.kernels import fused_rms_norm as frn

DTYPES = (torch.float32, torch.bfloat16, torch.float16)
PAIRS = [(x, p) for x in DTYPES for p in DTYPES]
PAIR_IDS = [f"x{str(x)[6:]}-p{str(p)[6:]}" for x, p in PAIRS]
WIDTHS = [1, 7, 200, 768, 771, 1024, 2048, 4096, 8192, 16384]
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.float16: jnp.float16}
BITS = {torch.bfloat16: 8, torch.float16: 11}
VEC_WARPS = row_vec.VEC_NT // 32


class _StandInLibrary:
    """Records the C entries' calls in place of a built library; each
    returns ``err``."""

    def __init__(self, err=0):
        self.calls, self.err = [], err

    def error_string(self, err):
        return b"stand-in error"

    def __getattr__(self, entry):
        return lambda *args: self.calls.append((entry, args)) or self.err


@pytest.fixture
def card(monkeypatch):
    """The wrappers on a stand-in card: told their tensors are on it,
    with recorders for the rms_norm and layer_norm libraries."""
    libs = {"rms": _StandInLibrary(), "ln": _StandInLibrary()}
    monkeypatch.setattr(_build, "on_card", lambda what, *t: True)
    monkeypatch.setattr(frn, "_lib", libs["rms"])
    monkeypatch.setattr(fln, "_lib", libs["ln"])
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=None))
    return libs


def _forward(norm, x, p):
    """One forward on the stand-in card; returns the wrapper (for its
    counts)."""
    if norm == "rms":
        frn.rms_norm_fwd(x, p, 1e-6)
        return frn.rms_norm_fwd
    fln.layer_norm_fwd(x, p, p, 1e-5)
    return fln.layer_norm_fwd


def _launch_on(card, norm, x, p, want):
    """The forward counts one launch on route ``want``, none on the
    other, and makes one C call with the rows and the width."""
    wrapper = {"rms": frn.rms_norm_fwd, "ln": fln.layer_norm_fwd}[norm]
    before = dict(wrapper.route_launches)
    _forward(norm, x, p)
    moved = {k: wrapper.route_launches[k] - before[k] for k in before}
    assert moved == {r: int(r == want) for r in row_vec.ROUTES}
    (entry, args), = card[norm].calls
    assert entry == {"rms": "rms_norm_fwd", "ln": "layer_norm_fwd"}[norm]
    assert args[4:6] == (x.numel() // x.shape[-1], x.shape[-1])


# ------------------------------------------------------------- routes

@pytest.mark.parametrize("H", WIDTHS)
@pytest.mark.parametrize("xdt,pdt", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("norm", ["rms", "ln"])
def test_the_route_follows_the_row_width(card, norm, xdt, pdt, H):
    """On aligned tensors a forward takes the vector route exactly when
    16-byte vectors take the row (``H * sizeof(x) % 16 == 0``), whatever
    the parameters' dtype; a LayerNorm wider than its MAX_H raises
    before any launch."""
    x = torch.zeros(2, H, dtype=xdt)
    p = torch.ones(H, dtype=pdt)
    if norm == "ln" and H > fln.MAX_H:
        with pytest.raises(ValueError):
            _forward(norm, x, p)
        assert card[norm].calls == []
        return
    want = "vec" if H * x.element_size() % 16 == 0 else "general"
    _launch_on(card, norm, x, p, want)


@pytest.mark.parametrize("H", [768, 2048])
@pytest.mark.parametrize("xdt", DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("norm", ["rms", "ln"])
def test_an_unaligned_view_takes_the_general_route(card, norm, xdt, H):
    """``buf[1:1 + R*H].view(R, H)`` starts one element past a 16-byte
    boundary: the general route, though its width would take vectors."""
    R = 3
    buf = torch.zeros(R * H + 16, dtype=xdt)
    x = buf[1:1 + R * H].view(R, H)
    assert x.is_contiguous() and x.data_ptr() % 16
    _launch_on(card, norm, x, torch.ones(H, dtype=xdt), "general")


@pytest.mark.parametrize("norm", ["rms", "ln"])
def test_an_unaligned_parameter_takes_the_general_route(card, norm):
    H = 1024
    p = torch.ones(H + 8, dtype=torch.bfloat16)[1:1 + H]
    x = torch.zeros(4, H, dtype=torch.bfloat16)
    assert p.data_ptr() % 16
    _launch_on(card, norm, x, p, "general")


@pytest.mark.parametrize("norm", ["rms", "ln"])
def test_fwd_route_is_the_rule_on_the_call_tensors(norm):
    """``fwd_route`` asks x's width and every pointer the C entry
    checks: x, the parameters and the outputs."""
    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    p = torch.ones(64, dtype=torch.bfloat16)
    odd = torch.zeros(4 * 64 + 8, dtype=torch.bfloat16)[1:257].view(4, 64)
    oddr = torch.zeros(8)[1:5]
    if norm == "rms":
        r = torch.zeros(4)
        assert frn.fwd_route(x, p, x, r) == "vec"
        assert frn.fwd_route(x, p, odd, r) == "general"
        assert frn.fwd_route(x, p, x, oddr) == "general"
    else:
        assert fln.fwd_route(x, p, p, x) == "vec"
        assert fln.fwd_route(x, p, p, odd) == "general"
        assert fln.fwd_route(x, p, odd[0], x) == "general"


@pytest.mark.parametrize("norm", ["rms", "ln"])
def test_a_vector_route_launch_error_raises(card, norm):
    """No fallback: an error from the C entry on the vector route raises
    RuntimeError, counts no launch and tries no other kernel."""
    card[norm].err = 700
    wrapper = {"rms": frn.rms_norm_fwd, "ln": fln.layer_norm_fwd}[norm]
    before = (wrapper.launches, dict(wrapper.route_launches))
    x = torch.zeros(4, 768, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        _forward(norm, x, torch.ones(768, dtype=torch.bfloat16))
    assert len(card[norm].calls) == 1
    assert (wrapper.launches, wrapper.route_launches) == before


# ------------------------------------------- the kernels' index model

def _lane_owner(H, size):
    """The lane of the row that reads and writes each element, from
    ``row_vec.cuh``'s mapping: lane t holds vectors t + k * 32 * wpr,
    k < vpl, those below nv; -1 where no lane does, and the count of
    lanes that claim each element."""
    E = 16 // size
    nv = H // E
    wpr, vpl = row_vec.vec_plan(nv)
    T = 32 * wpr
    t = np.arange(T)[:, None]
    v = t + np.arange(vpl)[None, :] * T              # [lane, k]
    claims = np.zeros(H, np.int64)
    owner = np.full(H, -1)
    for lane, k in zip(*np.nonzero(v < nv)):
        els = np.arange(v[lane, k] * E, v[lane, k] * E + E)
        claims[els] += 1
        owner[els] = lane
    return owner, claims, wpr, vpl


VEC_CASES = [(H, d) for H in WIDTHS for d in DTYPES
             if H * d.itemsize % 16 == 0]


@pytest.mark.parametrize("H,xdt", VEC_CASES,
                         ids=[f"H{h}-{str(d)[6:]}" for h, d in VEC_CASES])
def test_every_element_is_read_and_written_once(H, xdt):
    """Each element of a row belongs to exactly one lane (its load and
    its store use the same vector); the plan keeps a lane at 16 vectors
    or fewer with the fewest warps (a power of two, at most the block's
    8), and its vectors a lane are the power of two that covers the
    row."""
    owner, claims, wpr, vpl = _lane_owner(H, xdt.itemsize)
    assert (claims == 1).all()
    nv = H // (16 // xdt.itemsize)
    assert wpr in (1, 2, 4, 8) and wpr <= VEC_WARPS
    assert vpl in (1, 2, 4, 8, 16) and vpl <= row_vec.MAX_VPL
    assert 32 * wpr * vpl >= nv
    assert wpr == 1 or (wpr // 2) * 32 * row_vec.MAX_VPL < nv
    assert vpl == 1 or (vpl // 2) * 32 * wpr < nv
    # one warp a row up to 4096 bf16 / 2048 f32 elements
    assert (wpr == 1) == (nv <= 512)
    # neighbouring lanes read neighbouring vectors
    E = 16 // xdt.itemsize
    if nv >= 32:
        assert list(owner[:32 * E:E]) == list(range(32))


@pytest.mark.parametrize("H,xdt", VEC_CASES,
                         ids=[f"H{h}-{str(d)[6:]}" for h, d in VEC_CASES])
def test_the_partial_sums_cover_the_row(H, xdt):
    """The reduction's model in f32: each lane sums its own elements,
    the xor shuffle tree leaves every lane of a warp with the same warp
    sum, the row's warps add their sums in warp order; the result is
    the row's sum (to 1e-5 of the float64 sum of these positive
    terms)."""
    owner, _, wpr, _ = _lane_owner(H, xdt.itemsize)
    vals = np.random.default_rng(H).random(H).astype(np.float32) + 0.5
    lane = np.zeros(32 * wpr, np.float32)
    for i in range(H):                       # a lane's elements in order
        lane[owner[i]] = np.float32(lane[owner[i]] + vals[i])
    warps = lane.reshape(wpr, 32)
    for o in (16, 8, 4, 2, 1):
        warps = warps + warps[:, np.arange(32) ^ o]
    assert (warps == warps[:, :1]).all()
    total = np.float32(0)
    for w in range(wpr):
        total = np.float32(total + warps[w, 0])
    want = vals.astype(np.float64).sum()
    assert abs(float(total) - want) <= 1e-5 * want


@pytest.mark.parametrize("wpr", [1, 2, 4, 8])
@pytest.mark.parametrize("R", [1, 5, 37, 4096, 16385])
def test_the_persistent_grid_visits_every_row_once(R, wpr):
    """Block b's row slot s walks rows b * rpb + s + i * G * rpb (rpb =
    8 / wpr rows a block, G blocks): every row once, for grids smaller
    than, equal to and larger than the rows need."""
    rpb = VEC_WARPS // wpr
    for G in {1, 7, 132 * 3, -(-R // rpb)}:
        G = min(G, -(-R // rpb))          # persistent_blocks' cap
        first = np.arange(G)[:, None] * rpb + np.arange(rpb)[None, :]
        rows = np.concatenate([np.arange(f, R, G * rpb)
                               for f in first.ravel()])
        assert np.array_equal(np.sort(rows), np.arange(R))


@pytest.mark.parametrize("xdt,pdt", PAIRS, ids=PAIR_IDS)
def test_the_parameters_chunks_are_aligned_in_shared_memory(xdt, pdt):
    """The vector kernels keep w (RMSNorm) or gamma then beta from the
    first 16-byte boundary after gamma (LayerNorm) in shared memory in
    their own type; the chunk of E = 16 / sizeof(x) parameters that a
    vector reads is 8, 16 or 32 bytes and lies on a multiple of its
    size's load (8 bytes for uint2, 16 for uint4); the staged bytes are
    a multiple of 8, as ``stage`` copies them."""
    for H in WIDTHS:
        if H * xdt.itemsize % 16:
            continue
        E = 16 // xdt.itemsize
        chunk = E * pdt.itemsize
        assert chunk in (8, 16, 32)
        gbytes = H * pdt.itemsize
        assert gbytes % 8 == 0
        boff = (gbytes + 15) & ~15
        need = 8 if chunk == 8 else 16
        offs = np.arange(H // E) * chunk
        assert (offs % need == 0).all() and ((boff + offs) % need == 0).all()


# ---------------------------------- the plain forwards against Pallas

def _close(got, want, dtype, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    d = np.abs(got - want)
    amax = float(np.abs(want).max())
    if dtype in BITS:
        _, e = np.frexp(np.maximum(np.abs(got), np.abs(want)))
        lim = np.ldexp(1.0, e - BITS[dtype]) + 1e-5 * amax
    else:
        lim = 1e-5 * np.maximum(np.abs(want), 1.0)
    assert (d <= lim).all(), (what, float((d - lim).max()))


def _inputs(rows, H, xdt, pdt, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, H)) * 2 + 0.5).astype(np.float32)
    p = [rng.normal(size=H).astype(np.float32) for _ in range(2)]
    return ([torch.from_numpy(x).to(xdt)]
            + [torch.from_numpy(a).to(pdt) for a in p],
            [jnp.asarray(x, JDT[xdt])] + [jnp.asarray(a, JDT[pdt])
                                          for a in p])


RMS_PAIRS = [(torch.float32, torch.float32),
             (torch.bfloat16, torch.bfloat16),
             (torch.bfloat16, torch.float32)]
LN_PAIRS = RMS_PAIRS + [(torch.float32, torch.bfloat16),
                        (torch.float16, torch.float32),
                        (torch.float16, torch.float16)]


@pytest.mark.parametrize("H", [768, 2048])
@pytest.mark.parametrize("xdt,pdt", RMS_PAIRS,
                         ids=[f"x{str(x)[6:]}-w{str(p)[6:]}"
                              for x, p in RMS_PAIRS])
def test_plain_rms_forward_matches_the_pallas_kernel(xdt, pdt, H):
    (x, w, _), (jx, jw, _) = _inputs(16, H, xdt, pdt, seed=H)
    want = pallas_fused.fused_rms_norm(jx, jw, 1e-6, interpret=True)
    got, _ = frn.rms_norm_fwd_reference(x, w, 1e-6)
    assert got.dtype == xdt
    _close(got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)),
           xdt, "o")


@pytest.mark.parametrize("H", [768, 2048])
@pytest.mark.parametrize("xdt,pdt", LN_PAIRS,
                         ids=[f"x{str(x)[6:]}-g{str(p)[6:]}"
                              for x, p in LN_PAIRS])
def test_plain_layer_norm_forward_matches_the_pallas_kernel(xdt, pdt, H):
    eps = 1e-12 if H == 768 else 1e-5
    (x, g, b), (jx, jg, jb) = _inputs(16, H, xdt, pdt, seed=H + 1)
    want = pallas_ln.fused_layer_norm(jx, jg, jb, eps)
    got = fln.layer_norm_fwd_reference(x, g, b, eps)
    assert got.dtype == xdt
    _close(got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)),
           xdt, "y")
