"""The bf16 decode route of the int8 weight-only matmul on the tensor
cores (``wo_gemv_mma_kernel`` in
``paddle2_tpu_torch/kernels/csrc/wo_matmul.cu``), on the CPU, where no
card runs it:

- the route rule: bf16 with M <= 8 takes "gemv_mma", f32 with M <= 8
  keeps "gemv" (``wo_gemv_kernel``), M > 8 routes as before;
- a host mirror of ``mma.sync.m16n8k16``'s bf16 fragment layouts (PTX
  ISA, "Matrix Fragments for mma.m16n8k16") and of the kernel's column
  and k maps: what each thread packs into its A and B registers and
  where its accumulators land. Walked over the kernel's grid (column
  tiles, K splits, the warps' steps), it meets every (m, k, n) product
  of the output exactly once, and its sums equal ``x @ w``;
- the widening (``wo::i8x4_to_f32``, then a bf16 pair), exact for all
  256 int8 values;
- the K-split rule: each split a whole number of 128-row runs, the
  splits covering K once, and the blocks filling the card at the main
  shapes;
- the plain version, which the card holds the kernel against, against
  the JAX package's Pallas kernel in interpret mode at M 1, 2, 3, 5 and
  8 and against its XLA route at ragged K and N;
- the wrapper's path to the new C entry through a stand-in library
  (``tests/test_torch_int8_matmul.py``'s ``wo_card`` fixture), and that
  a launch error raises.

Tolerances: the mirror's sums are of small integers, exact in float64,
so they are compared exactly; the plain version against JAX as
``tests/test_torch_quant.py`` holds it (f32 sums in another order: a
bf16 output within one ulp).
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle2_tpu.kernels import pallas_matmul as pm
from paddle2_tpu_torch.kernels import _build
from paddle2_tpu_torch.kernels import quant_matmul as qm
from test_torch_int8_matmul import wo_card  # noqa: F401 (the fixture)

# csrc/wo_matmul.cu's tensor-core decode kernel
WARPS = 4            # warps a block
COLS = 128           # columns of a block (and of each warp)
KSTEP = 16           # rows of K a warp takes a step


# -------------------------------------------------------------- the route
@pytest.mark.parametrize("M,dtype,route", [
    (1, torch.bfloat16, "gemv_mma"), (5, torch.bfloat16, "gemv_mma"),
    (8, torch.bfloat16, "gemv_mma"), (1, torch.float32, "gemv"),
    (8, torch.float32, "gemv"), (9, torch.bfloat16, "wgmma"),
    (9, torch.float32, "gemm")])
def test_decode_route_by_dtype(M, dtype, route):
    """bf16 decode takes the tensor cores at any K and N (ragged ones
    too); f32 decode keeps the CUDA cores (its tensor-core form is still
    to be written); prefill keeps its routes."""
    assert qm.wo_route(M, 2048, 8192, dtype) == route
    if M <= 8:
        assert qm.wo_route(M, 200, 333, dtype) == route


# ---------------------------------------------- the mma fragment layouts
# PTX ISA, mma.m16n8k16 with .bf16 operands: lane = 4 g + t. Each 32-bit
# register holds two bf16 values, the lower index in the low half.
def ptx_a(lane, reg, half):
    """(row, k) of A (16 x 16, row-major) in half ``half`` of A register
    ``reg`` (a0: row g, k 2t..; a1: row g+8; a2: k 2t+8..; a3: both)."""
    g, t = divmod(lane, 4)
    return g + 8 * (reg % 2), 2 * t + half + 8 * (reg // 2)


def ptx_b(lane, reg, half):
    """(k, column) of B (16 x 8) in half ``half`` of B register ``reg``."""
    g, t = divmod(lane, 4)
    return 2 * t + half + 8 * reg, g


def ptx_c(lane, reg):
    """(row, column) of C/D (16 x 8) in accumulator ``reg``."""
    g, t = divmod(lane, 4)
    return g + 8 * (reg // 2), 2 * t + reg % 2


# What the kernel puts there (csrc/wo_matmul.cu, `mma_word` and the
# partial sums' store): thread (g, t) copies rows 4t .. 4t+3 of a step at
# columns 16g .. 16g+15 of its warp's tile.
def kernel_a(lane, j, reg, half):
    """(column of the tile, row of the step) of w that the thread packs
    into half ``half`` of A register ``reg`` of the step's mma ``j``:
    word q = j // 2 of its rows, column 4q + 2 (j % 2) (+1 in a1, a3);
    rows 4t, 4t+1 (a0, a1) or 4t+2, 4t+3 (a2, a3), the lower row low."""
    g, t = divmod(lane, 4)
    q, h = divmod(j, 2)
    return 16 * g + 4 * q + 2 * h + reg % 2, 4 * t + 2 * (reg // 2) + half


def kernel_b(lane, reg, half):
    """(row of the step, row m of x) in half ``half`` of B register
    ``reg``: one 8-byte load of x's row g at the step's k 4t .. 4t+3."""
    g, t = divmod(lane, 4)
    return 4 * t + 2 * reg + half, g


def kernel_c(lane, j, reg):
    """(column of the tile, row m of y) that the kernel stores
    accumulator ``reg`` of mma ``j`` to: red[w][2t][16g + 2j] gets (c0,
    c2), red[w][2t + 1][16g + 2j] gets (c1, c3)."""
    g, t = divmod(lane, 4)
    return 16 * g + 2 * j + reg // 2, 2 * t + reg % 2


def _maps():
    """For each mma j: A's (column, step row) by (row, k) and B's (step
    row, m) by (k, column), filled from the kernel's registers through
    the PTX layouts; each position filled exactly once."""
    a_col = np.full((8, 16, 16), -1)
    a_row = np.full((8, 16, 16), -1)
    b_row = np.full((16, 8), -1)
    b_m = np.full((16, 8), -1)
    for lane in range(32):
        for reg in range(4):
            for half in range(2):
                for j in range(8):
                    r, k = ptx_a(lane, reg, half)
                    assert a_col[j, r, k] == -1
                    a_col[j, r, k], a_row[j, r, k] = kernel_a(lane, j, reg,
                                                              half)
        for reg in range(2):
            for half in range(2):
                k, c = ptx_b(lane, reg, half)
                assert b_row[k, c] == -1
                b_row[k, c], b_m[k, c] = kernel_b(lane, reg, half)
    assert (a_col >= 0).all() and (b_row >= 0).all()
    return a_col, a_row, b_row, b_m


def test_fragment_maps_are_consistent():
    """Each A row stands for one column of the tile and each B column for
    one row of x; A's and B's k slots stand for the same step row (the k
    map); each accumulator is the product of the A row and the B column
    that the kernel's store says (the column map); the 8 mmas of a step
    cover the warp's 128 columns and 16 rows once."""
    a_col, a_row, b_row, b_m = _maps()
    assert (a_col == a_col[:, :, :1]).all()      # one column an A row
    assert (b_m == b_m[:1, :]).all()             # one x row a B column
    assert (a_row == b_row[:, 0][None, None, :]).all()
    assert sorted(b_row[:, 0]) == list(range(16))
    assert sorted(b_m[0]) == list(range(8))
    assert sorted(a_col[:, :, 0].ravel()) == list(range(COLS))
    for lane in range(32):
        for j in range(8):
            for reg in range(4):
                r, c = ptx_c(lane, reg)
                assert kernel_c(lane, j, reg) == (a_col[j, r, 0], b_m[0, c])


def _mirror(x, w, per):
    """The kernel's products through the mirror, at K split ``per``: the
    grid's column tiles and splits, warp w taking its block's steps w, w
    + 4, ...; each mma multiplies the A and B that the maps gather
    (zeros past K, N and M, as the kernel's zero-filled copies and x's
    zero rows give) and scatters D through the column map. Returns the
    sums and how often each (m, k, n) product was taken."""
    M, K = x.shape
    N = w.shape[1]
    a_col, a_row, b_row, b_m = _maps()
    y = np.zeros((M, N))
    seen = np.zeros((M, K, N), dtype=np.int64)
    kk = b_row[:, 0]
    for bx in range(-(-N // COLS)):
        for by in range(-(-K // per)):
            kbeg, kend = by * per, min(K, by * per + per)
            steps = -(-(kend - kbeg) // KSTEP)
            for warp in range(WARPS):
                for s in range(warp, steps, WARPS):
                    k0 = kbeg + KSTEP * s
                    for j in range(8):
                        cols = bx * COLS + a_col[j, :, 0]       # [16]
                        ks = k0 + kk                            # [16]
                        a = np.zeros((16, 16))
                        b = np.zeros((16, 8))
                        for r in range(16):
                            for q in range(16):
                                k = k0 + a_row[j, r, q]
                                if k < kend and cols[r] < N:
                                    a[r, q] = w[k, cols[r]]
                        for q in range(16):
                            for c in range(8):
                                if ks[q] < kend and b_m[q, c] < M:
                                    b[q, c] = x[b_m[q, c], ks[q]]
                        d = a @ b
                        for r in range(16):
                            for c in range(8):
                                m = b_m[0, c]
                                if m < M and cols[r] < N:
                                    y[m, cols[r]] += d[r, c]
                                    for q in range(16):
                                        if ks[q] < kend:
                                            seen[m, ks[q], cols[r]] += 1
    return y, seen


@pytest.mark.parametrize("M,K,N,per", [(8, 256, 128, 128), (3, 200, 333, 128),
                                       (1, 37, 5, 128), (5, 300, 130, 256),
                                       (8, 129, 256, 1024)])
def test_mirror_takes_every_product_once_and_equals_x_at_w(M, K, N, per):
    """Through the mirror, every product of ``x @ w`` is taken exactly
    once (ragged K and N, a K split whose last part is short, steps past
    a split's end, a single split larger than K) and the sums equal the
    float64 product of the small integers exactly."""
    rs = np.random.RandomState(M * K + N)
    x = rs.randint(-3, 4, size=(M, K)).astype(np.float64)
    w = rs.randint(-128, 128, size=(K, N)).astype(np.float64)
    y, seen = _mirror(x, w, per)
    assert (seen == 1).all()
    assert np.array_equal(y, x @ w)


# ---------------------------------------------------------- the widening
def byte_perm(a, b, sel):
    """CUDA's ``__byte_perm(a, b, sel)``: byte i of the result is byte
    ``sel``'s nibble i (its low 3 bits) of the 8 bytes of (a, b)."""
    src = [(a >> 8 * i) & 0xFF for i in range(4)] + \
        [(b >> 8 * i) & 0xFF for i in range(4)]
    return sum(src[(sel >> 4 * i) & 7] << 8 * i for i in range(4))


def i8x4_to_f32(word):
    """``wo::i8x4_to_f32`` (csrc/wo_common.cuh): flip each sign bit,
    place the byte in the low mantissa bits of 2**23, subtract 2**23 +
    128 in f32."""
    u = word ^ 0x80808080
    bits = np.array([byte_perm(u, 0x4B000000, 0x7540 + e) for e in range(4)],
                    dtype=np.uint32)
    return bits.view(np.float32) - np.float32(8388736.0)


def test_widening_is_exact_for_every_int8_value():
    """All 256 int8 values, four to a word in every byte position: the
    f32 values equal the integers, and their bf16 pair (round to nearest
    even, as ``cvt.rn.bf16x2.f32``) equals the int8 value cast to bf16:
    every int8 value is exact in bf16's 8 significant bits."""
    vals = np.arange(-128, 128, dtype=np.int8)
    for rot in range(4):
        words = np.roll(vals, rot).view(np.uint32)
        got = np.concatenate([i8x4_to_f32(int(wd)) for wd in words])
        want = np.roll(vals, rot).astype(np.float32)
        assert np.array_equal(got, want)
        pairs = torch.from_numpy(got).to(torch.bfloat16)
        assert torch.equal(pairs, torch.from_numpy(want).to(torch.bfloat16))
        assert torch.equal(pairs.float(), torch.from_numpy(want))


# ------------------------------------------------------------ the K split
@pytest.mark.parametrize("M", [1, 3, 8])
@pytest.mark.parametrize("K,N", [(2048, 6144), (2048, 2048), (2048, 8192),
                                 (8192, 2048), (2048, 50304), (200, 333),
                                 (7, 5), (16384, 64), (33000, 16)])
@pytest.mark.parametrize("resident", [132, 396, 528])
def test_k_split_covers_k_once(M, K, N, resident):
    """Every split is a whole number of 128-row runs (the C entry refuses
    anything else), there are at most 8 (one cluster), every split holds
    rows, and the splits cover [0, K) once."""
    per, splits = qm.mma_k_split(M, K, N, resident)
    assert per % 128 == 0 and per > 0 and splits <= 8
    assert splits == -(-K // per) and (splits - 1) * per < K <= splits * per
    cover = np.zeros(K, dtype=np.int64)
    for s in range(splits):
        cover[s * per:min(K, s * per + per)] += 1
    assert (cover == 1).all()


def test_k_split_fills_the_card_at_the_main_shapes():
    """At GPT-3 1.3B's decode shapes on 528 resident blocks (four of 128
    threads an SM on 132 SMs), K is split into the fewest parts whose
    blocks fill two an SM (264), at most 8 (a cluster), rounded to whole
    128-row runs: qkv (48 column tiles) 6 ways, out_proj and down (16) 8
    ways, up (64) 4 ways (five parts would be 410 rows, rounded to 512),
    the head's 393 tiles not at all."""
    want = {(2048, 6144): (384, 6), (2048, 2048): (256, 8),
            (2048, 8192): (512, 4), (8192, 2048): (1024, 8),
            (2048, 50304): (2048, 1)}
    for (K, N), plan in want.items():
        assert qm.mma_k_split(8, K, N, 528) == plan


# -------------------------------------------------- the plain version vs JAX
def _operands(seed, M, K, N, with_bias):
    rs = np.random.RandomState(seed)
    x = rs.randn(M, K).astype(np.float32)
    w = rs.randn(K, N).astype(np.float32)
    w_i8, scale = pm.quantize_channelwise(jnp.asarray(w), 8, axis=1)
    b = rs.randn(N).astype(np.float32) if with_bias else None
    rnd = (lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy())
    return (rnd(x), np.asarray(w_i8), np.asarray(scale),
            None if b is None else rnd(b))


def _port(x, w_i8, scale, b):
    return qm.int8_weight_only_matmul(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w_i8),
        torch.from_numpy(scale),
        None if b is None else torch.from_numpy(b).to(torch.bfloat16))


def _jax(x, w_i8, scale, b, **kw):
    return pm.int8_weight_only_matmul(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w_i8), jnp.asarray(scale),
        None if b is None else jnp.asarray(b, jnp.bfloat16), **kw)


def _within_one_ulp(got, ref):
    ref_t = torch.from_numpy(np.asarray(ref.astype(jnp.float32))).to(
        torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == ref_t.shape
    same_sign = torch.sign(got.float()) * torch.sign(ref_t.float()) >= 0
    assert bool(same_sign.all())
    bits = got.view(torch.int16).int() - ref_t.view(torch.int16).int()
    assert int(bits.abs().max()) <= 1, int(bits.abs().max())


@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("M", [1, 2, 3, 5, 8])
def test_plain_matches_pallas_kernel_interpret_at_decode(M, with_bias):
    """The plain version (what the card holds the kernel against) against
    ``_wo_pallas`` in interpret mode at decode rows, K 256 and N 256 in
    two blocks each."""
    ops = _operands(M, M, 256, 256, with_bias)
    assert pm.wo_supported(M, 256, 256, 32, 128, 128)
    ref = _jax(*ops, block_m=32, block_n=128, block_k=128, interpret=True)
    _within_one_ulp(_port(*ops), ref)


@pytest.mark.parametrize("M,K,N", [(1, 200, 333), (3, 37, 50), (5, 1030, 7),
                                   (8, 129, 336)])
def test_plain_matches_xla_route_ragged_at_decode(M, K, N):
    """Ragged K and N, which the Pallas tiling refuses, against the JAX
    package's XLA route."""
    ops = _operands(M + K, M, K, N, True)
    ref = _jax(*ops, interpret=False)
    _within_one_ulp(_port(*ops), ref)


# ----------------------------------------------------- the C entry on a card
def _operands_on_card(M, K, N, bias=True):
    x = torch.zeros(M, K, dtype=torch.bfloat16)
    w = torch.zeros(K, N, dtype=torch.int8)
    s = torch.ones(N)
    return x, w, s, torch.zeros(N, dtype=torch.bfloat16) if bias else None


@pytest.mark.parametrize("M,K,N,bias", [(8, 2048, 8192, True),
                                        (1, 2048, 50304, False),
                                        (3, 200, 333, True),
                                        (5, 8192, 2048, False)])
def test_bf16_decode_reaches_the_tensor_core_entry(wo_card, M, K, N, bias):
    """A bf16 call at M <= 8 calls ``wo_gemv_mma`` in the ``wo_matmul``
    library once, with the operands' and the output's pointers (no
    workspace: the splits of a column tile add through distributed shared
    memory), M, K, N, the split the plan chose (at most 8 of them), qmax
    and the stream, and counts one launch in the total and in the
    "gemv_mma" route."""
    x, w, s, b = _operands_on_card(M, K, N, bias)
    f = qm.int8_weight_only_matmul
    total, routes = f.launches, dict(f.route_launches)
    y = f(x, w, s, b)
    per, splits = qm.mma_k_split(M, K, N, 396)
    (lib, entry, args), = wo_card
    assert (lib, entry) == ("wo_matmul", "wo_gemv_mma")
    assert args[:5] == (x.data_ptr(), w.data_ptr(), s.data_ptr(),
                        None if b is None else b.data_ptr(), y.data_ptr())
    assert args[5:] == (M, K, N, per, 127.0, None) and splits <= 8
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (M, N)
    routes["gemv_mma"] += 1
    assert (f.launches, f.route_launches) == (total + 1, routes)


def test_unaligned_x_and_int4_reach_the_entry_as_they_are(wo_card):
    """The decode kernels read any alignment: an x view off a 16-byte
    boundary reaches the entry as it is (no copy), and a 4-bit payload
    passes qmax 7."""
    buf = torch.zeros(4 * 2048 + 1, dtype=torch.bfloat16)
    x = buf[1:].view(4, 2048)
    assert x.data_ptr() % 16
    w = torch.zeros(2048, 2048, dtype=torch.int8)
    qm.int8_weight_only_matmul(x, w, torch.ones(2048), quant_bits=4)
    (_, entry, args), = wo_card
    assert entry == "wo_gemv_mma" and args[0] == x.data_ptr()
    assert args[9] == 7.0


def test_launch_error_raises(monkeypatch):
    """A launch the C entry reports as failed raises, naming the entry;
    nothing else runs and nothing is counted."""
    class Failing:
        def error_string(self, err):
            return b"too many resources requested for launch"

        def __getattr__(self, entry):
            return lambda *args: 7
    monkeypatch.setattr(_build, "on_card", lambda what, *t: True)
    monkeypatch.setattr(_build, "library", lambda name, sigs: Failing())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(qm, "_raw_stream", lambda index: None)
    monkeypatch.setattr(qm, "_resident", lambda *a: 264)
    monkeypatch.setattr(qm, "_PLANS", {})
    monkeypatch.setattr(qm, "int8_weight_only_matmul_reference",
                        lambda *a: pytest.fail("the plain version ran"))
    x, w, s, b = _operands_on_card(8, 2048, 2048)
    before = qm.int8_weight_only_matmul.route_launches["gemv_mma"]
    with pytest.raises(RuntimeError, match="wo_gemv_mma: CUDA error 7"):
        qm.int8_weight_only_matmul(x, w, s, b)
    assert qm.int8_weight_only_matmul.route_launches["gemv_mma"] == before


def test_c_entry_signature_is_the_wrapper_call():
    """The entry's ctypes signature: five pointers (x, w, s, bias, y), four
    ints (M, K, N, the split), qmax as a float and the stream; the
    occupancy entry takes vec and a pointer."""
    P, I = ctypes.c_void_p, ctypes.c_int
    assert qm._SIGNATURES["wo_gemv_mma"] == [P] * 5 + [I] * 4 + [
        ctypes.c_float, P]
    assert qm._SIGNATURES["wo_gemv_mma_blocks_per_sm"] == [I, P]
