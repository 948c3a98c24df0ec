"""The f32 decode route of the int8 weight-only matmul on the tensor cores
in two TF32 passes (``wo_gemv_tf32_kernel`` in
``paddle2_tpu_torch/kernels/csrc/wo_matmul.cu``), on the CPU, where no
card runs it:

- the route rule: f32 with M <= 8 takes "gemv", whose C entry is now
  ``wo_gemv_tf32``; bf16 decode keeps ``wo_gemv_mma``;
- a host mirror of ``mma.sync.m16n8k8``'s TF32 fragment layouts (PTX
  ISA, "Matrix Fragments for mma.m16n8k8", .tf32) and of the kernel's
  column and k maps (``tf32_word``): thread (g, t)'s rows 4t .. 4t+3 of a
  16-row step are two k8 mmas, rows 4t, 4t+1 in k slots t, t+4 of the
  first and rows 4t+2, 4t+3 of the second, so B's two registers are
  neighbouring values of x's row g. Walked over the kernel's grid
  (column tiles, K splits, the warps' steps) for M 1..8 at ragged K and
  N, it meets every (m, k, n) product exactly once (so every (k, n) of w
  and every (m, k) of x meets its partners once) and its sums equal
  ``x @ w``;
- the two passes lane by lane: each mma of the mirror run on per-lane
  fragments as the PTX ISA lays them out, x split once (``tf32_split``:
  big rounded to TF32, small truncated by the tensor cores), gives the
  f32 product within the f32 limit, one pass does not;
- the second sum: a host model of a warp's walk takes every step once
  and no accumulator more than 512 rows at any K and split;
- the K-split plan (``tf32_k_split``): whole 128-row runs covering K
  once, a power of two of them, the most whose blocks stay within three
  quarters of the resident ones, up to 8, and 16 where a split keeps 512
  rows;
- the plain version, which the card holds the kernel against, against
  the JAX package's ``_wo_pallas`` in interpret mode at M 1, 2, 3, 5 and
  8 and against its XLA route at ragged K and N, in f32;
- the wrapper's path to the C entry through a stand-in library
  (``tests/test_torch_int8_matmul.py``'s ``wo_card`` fixture), the
  occupancy entry it asks once, and that a launch error raises.

Tolerances: the mirror's sums of small integers are exact in float64 and
compared exactly; the two-pass products against float64 at the smoke's
f32 limit (1e-4, absolute below 1 and relative above) with a tenth of it
to spare; the plain version against Pallas at that limit too (f32 sums
in another order).
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle2_tpu.kernels import pallas_matmul as pm
from paddle2_tpu_torch.kernels import _build
from paddle2_tpu_torch.kernels import flash_attn as fa
from paddle2_tpu_torch.kernels import quant_matmul as qm
from test_torch_int8_matmul import wo_card  # noqa: F401 (the fixture)

TOL = 1e-4           # chip_smoke.TOL[torch.float32]
WARPS = 4            # warps a block
COLS = 128           # columns of a block (and of each warp)
KSTEP = 16           # rows of K a warp takes a step
AHEAD = 1            # steps a thread keeps in flight (f32)
CHUNK = 32           # steps a warp's accumulators take (512 rows)


# -------------------------------------------------------------- the route
@pytest.mark.parametrize("M,K,N", [(1, 2048, 8192), (8, 2048, 50304),
                                   (5, 1030, 7), (3, 200, 333)])
def test_f32_decode_takes_the_tf32_route(M, K, N):
    """f32 at M <= 8 takes "gemv", whose entry is the TF32 decode
    kernel's; bf16 keeps its own; M 9 is prefill."""
    assert qm.wo_route(M, K, N, torch.float32) == "gemv"
    assert qm._ENTRIES["gemv"] == "wo_gemv_tf32"
    assert qm.wo_route(M, K, N, torch.bfloat16) == "gemv_mma"
    assert qm.wo_route(9, K, N, torch.float32) == "gemm"


# ---------------------------------------------- the mma fragment layouts
# PTX ISA, mma.m16n8k8 with .tf32 operands: lane = 4 g + t; one value a
# 32-bit register.
def ptx_a(lane, reg):
    """(row, k) of A (16 x 8) in A register ``reg``: a0 (g, t), a1 (g+8,
    t), a2 (g, t+4), a3 (g+8, t+4)."""
    g, t = divmod(lane, 4)
    return g + 8 * (reg % 2), t + 4 * (reg // 2)


def ptx_b(lane, reg):
    """(k, column) of B (8 x 8) in B register ``reg``: b0 (t, g), b1 (t+4,
    g)."""
    g, t = divmod(lane, 4)
    return t + 4 * reg, g


def ptx_c(lane, reg):
    """(row, column) of C/D (16 x 8) in accumulator ``reg``."""
    g, t = divmod(lane, 4)
    return g + 8 * (reg // 2), 2 * t + reg % 2


# What the kernel puts there (csrc/wo_matmul.cu, `tf32_word`): thread (g,
# t) holds rows 4t .. 4t+3 of a step at columns 16g .. 16g+15; the word q
# of its rows gives mmas j = 2q (columns 4q, 4q+1) and 2q+1 (4q+2, 4q+3),
# each in two k8 halves h.
def kernel_a(lane, j, h, reg):
    """(column of the tile, row of the step) of w in A register ``reg`` of
    mma ``j``'s half ``h``: a0 = lo[c], a1 = lo[c+1], a2 = hi[c], a3 =
    hi[c+1], with lo / hi rows 4t + 2h / 4t + 2h + 1 and c = 4q + 2(j %
    2)."""
    g, t = divmod(lane, 4)
    q, hc = divmod(j, 2)
    return 16 * g + 4 * q + 2 * hc + reg % 2, 4 * t + 2 * h + reg // 2


def kernel_b(lane, h, reg):
    """(row of the step, row m of x) in B register ``reg`` of half ``h``:
    x's row g at the step's k 4t + 2h (b0) and 4t + 2h + 1 (b1), two
    neighbouring floats of one 16-byte load."""
    g, t = divmod(lane, 4)
    return 4 * t + 2 * h + reg, g


def kernel_c(lane, j, reg):
    """(column of the tile, row m of y) the kernel stores accumulator
    ``reg`` of mma ``j`` to (as the bf16 kernel: red[w][2t][16g + 2j]
    gets (c0, c2), red[w][2t + 1][16g + 2j] gets (c1, c3))."""
    g, t = divmod(lane, 4)
    return 16 * g + 2 * j + reg // 2, 2 * t + reg % 2


def _maps():
    """For each mma j and half h: A's (column, step row) by (row, k) and
    B's (step row, m) by (k, column), filled from the kernel's registers
    through the PTX layouts, each position exactly once."""
    a_col = np.full((8, 2, 16, 8), -1)
    a_row = np.full((8, 2, 16, 8), -1)
    b_row = np.full((2, 8, 8), -1)
    b_m = np.full((2, 8, 8), -1)
    for lane in range(32):
        for h in range(2):
            for reg in range(4):
                r, k = ptx_a(lane, reg)
                for j in range(8):
                    assert a_col[j, h, r, k] == -1
                    a_col[j, h, r, k], a_row[j, h, r, k] = kernel_a(
                        lane, j, h, reg)
            for reg in range(2):
                k, c = ptx_b(lane, reg)
                assert b_row[h, k, c] == -1
                b_row[h, k, c], b_m[h, k, c] = kernel_b(lane, h, reg)
    assert (a_col >= 0).all() and (b_row >= 0).all()
    return a_col, a_row, b_row, b_m


def test_fragment_maps_are_consistent():
    """Each A row stands for one column of the tile and each B column for
    one row of x; A's and B's k slots stand for the same step row in
    each half; the two halves take the step's 16 rows once; each
    accumulator is the product of the A row and B column the kernel's
    store says; the 8 mmas of a step cover the warp's 128 columns once."""
    a_col, a_row, b_row, b_m = _maps()
    assert (a_col == a_col[:, :, :, :1]).all()   # one column an A row
    assert (a_col == a_col[:, :1]).all()         # the same in both halves
    assert (b_m == b_m[:, :1, :]).all()          # one x row a B column
    assert (a_row == b_row[:, :, 0][None, :, None, :]).all()
    assert sorted(b_row[:, :, 0].ravel()) == list(range(16))
    assert sorted(b_m[0, 0]) == list(range(8))
    assert sorted(a_col[:, 0, :, 0].ravel()) == list(range(COLS))
    for lane in range(32):
        for j in range(8):
            for reg in range(4):
                r, c = ptx_c(lane, reg)
                assert kernel_c(lane, j, reg) == (a_col[j, 0, r, 0],
                                                  b_m[0, 0, c])


def _mirror(x, w, per):
    """The kernel's products through the mirror, at K split ``per``: the
    grid's column tiles and splits, warp w taking its block's steps w, w
    + 4, ...; each mma multiplies the A and B that the maps gather
    (zeros past K, N and M, as the kernel's zero-filled loads and x's
    rows past M give) and scatters D through the column map. Returns the
    sums and how often each (m, k, n) product was taken."""
    M, K = x.shape
    N = w.shape[1]
    a_col, a_row, b_row, b_m = _maps()
    y = np.zeros((M, N))
    seen = np.zeros((M, K, N), dtype=np.int64)
    for bx in range(-(-N // COLS)):
        for by in range(-(-K // per)):
            kbeg, kend = by * per, min(K, by * per + per)
            steps = -(-(kend - kbeg) // KSTEP)
            for warp in range(WARPS):
                for s in range(warp, steps, WARPS):
                    k0 = kbeg + KSTEP * s
                    for j in range(8):
                        cols = bx * COLS + a_col[j, 0, :, 0]     # [16]
                        for h in range(2):
                            ks = k0 + b_row[h, :, 0]              # [8]
                            a = np.zeros((16, 8))
                            b = np.zeros((8, 8))
                            for r in range(16):
                                for q in range(8):
                                    k = k0 + a_row[j, h, r, q]
                                    if k < kend and cols[r] < N:
                                        a[r, q] = w[k, cols[r]]
                            for q in range(8):
                                for c in range(8):
                                    if ks[q] < kend and b_m[h, q, c] < M:
                                        b[q, c] = x[b_m[h, q, c], ks[q]]
                            d = a @ b
                            for r in range(16):
                                for c in range(8):
                                    m = b_m[h, 0, c]
                                    if m < M and cols[r] < N:
                                        y[m, cols[r]] += d[r, c]
                                        for q in range(8):
                                            if ks[q] < kend:
                                                seen[m, ks[q], cols[r]] += 1
    return y, seen


@pytest.mark.parametrize("M,K,N,per", [(8, 256, 128, 128), (3, 200, 333, 128),
                                       (1, 37, 5, 128), (5, 300, 130, 256),
                                       (2, 129, 256, 1024), (7, 33, 17, 128),
                                       (4, 260, 144, 128), (6, 48, 9, 128)])
def test_mirror_takes_every_product_once_and_equals_x_at_w(M, K, N, per):
    """Through the mirror, every product of ``x @ w`` is taken exactly
    once for M 1..8 (ragged K and N, a K split whose last part is short,
    steps past a split's end, a split larger than K) and the sums of
    small integers equal the float64 product exactly."""
    rs = np.random.RandomState(M * K + N)
    x = rs.randint(-3, 4, size=(M, K)).astype(np.float64)
    w = rs.randint(-128, 128, size=(K, N)).astype(np.float64)
    y, seen = _mirror(x, w, per)
    assert (seen == 1).all()
    assert np.array_equal(y, x @ w)


# ------------------------------------------------------ the two passes
def _lane_mma(c, a, b):
    """One mma.sync.m16n8k8 (tf32 operands as given, float64 sums) on
    per-lane fragments laid out as the PTX ISA has them: a [32, 4], b
    [32, 2], c [32, 4]."""
    A, B = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        for reg in range(4):
            A[ptx_a(lane, reg)] = a[lane, reg]
        for reg in range(2):
            B[ptx_b(lane, reg)] = b[lane, reg]
    D = A @ B
    out = c.copy()
    for lane in range(32):
        for reg in range(4):
            out[lane, reg] += D[ptx_c(lane, reg)]
    return out


def _warp_tile(x, w, passes):
    """One warp's tile (128 columns, K a multiple of 16, M <= 8) through
    ``tf32_word`` lane by lane: per step, each thread's w rows and x's
    row g, x split once into big and small, then for each mma j and half
    h the small pass (when ``passes`` is 2) and the big one."""
    M, K = x.shape
    xp = np.zeros((8, K))
    xp[:M] = x
    big, small = (t.double().numpy() for t in fa.tf32_split(
        torch.from_numpy(xp).float()))
    acc = np.zeros((8, 32, 4))
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    for k0 in range(0, K, KSTEP):
        for j in range(8):
            q, hc = divmod(j, 2)
            col = 16 * g + 4 * q + 2 * hc
            for h in range(2):
                lo, hi = k0 + 4 * t + 2 * h, k0 + 4 * t + 2 * h + 1
                a = np.stack([w[lo, col], w[lo, col + 1], w[hi, col],
                              w[hi, col + 1]], axis=1)
                for xs in ([small, big] if passes == 2 else [big]):
                    b = np.stack([xs[g, lo], xs[g, hi]], axis=1)
                    acc[j] = _lane_mma(acc[j], a, b)
    y = np.zeros((8, COLS))
    for j in range(8):
        for lane in range(32):
            for reg in range(4):
                col, m = kernel_c(lane, j, reg)
                y[m, col] = acc[j, lane, reg]
    return y[:M]


@pytest.mark.parametrize("M", [1, 3, 8])
def test_two_passes_keep_f32_accuracy_and_one_pass_does_not(M):
    """x f32 from randn, w int8 at the smoke's scale (y within a few
    units): the two-pass tile is within a tenth of the f32 limit of the
    float64 product, scaled as ``chip_smoke.check_wo`` scales it (the
    per-product error is below 2**-21 of |x w|); one pass reads past the
    limit."""
    rs = np.random.RandomState(M)
    K = 512
    x = rs.randn(M, K).astype(np.float32).astype(np.float64)
    w = rs.randint(-127, 128, size=(K, COLS)).astype(np.float64)
    s = 1.0 / (127.0 * 12.0)          # y = x @ w * s, |y| ~ 2
    exact = x @ w * s
    scaled = (lambda y: float((np.abs(y * s - exact)
                               / np.maximum(np.abs(exact), 1.0)).max()))
    assert scaled(_warp_tile(x, w, 2)) <= TOL / 10
    assert scaled(_warp_tile(x, w, 1)) > TOL


# --------------------------------------------------------- the second sum
def _walk(steps, warp):
    """A warp's walk over its split's steps (w, w + 4, ...) as the kernel
    takes it (AHEAD steps a loop turn): the steps, and the rows each
    accumulator takes between the folds into the second sum (every CHUNK
    steps of a walk of more than CHUNK)."""
    mine = -(-(steps - warp) // WARPS) if warp < steps else 0
    taken, runs, run = [], [], 0
    chunked = mine > CHUNK
    for i in range(0, mine, AHEAD):
        for a in range(AHEAD):
            if i + a < mine:
                taken.append(warp + WARPS * (i + a))
                run += KSTEP
        if chunked and (i + AHEAD) % CHUNK == 0 and i + AHEAD < mine:
            runs.append(run)
            run = 0
    runs.append(run)
    return taken, runs


@pytest.mark.parametrize("K", [16, 2048, 8192, 8208, 20480, 32768, 131072])
@pytest.mark.parametrize("splits", [1, 3, 8])
def test_the_second_sum_keeps_each_accumulator_to_512_rows(K, splits):
    """Every step of a split is taken once by one warp, and no mma
    accumulator takes more than 512 rows before it is added into the
    second sum, at any K and split."""
    per = -(-(-(-K // splits)) // 128) * 128
    for by in range(-(-K // per)):
        steps = -(-(min(K, by * per + per) - by * per) // KSTEP)
        seen = []
        for warp in range(WARPS):
            taken, runs = _walk(steps, warp)
            seen += taken
            assert max(runs) <= CHUNK * KSTEP
            assert sum(runs) == len(taken) * KSTEP
        assert sorted(seen) == list(range(steps))


# ------------------------------------------------------------ the K split
@pytest.mark.parametrize("M", [1, 3, 8])
@pytest.mark.parametrize("K,N", [(2048, 6144), (2048, 2048), (2048, 8192),
                                 (8192, 2048), (2048, 50304), (200, 333),
                                 (7, 5), (16384, 64), (33000, 16),
                                 (20480, 34816)])
@pytest.mark.parametrize("resident", [132, 396, 528])
def test_k_split_covers_k_once(M, K, N, resident):
    """Every split is a whole number of 128-row runs (the C entry refuses
    anything else), there are at most 16 (one cluster), and more than 8
    only where each keeps 512 rows; every split holds rows, and the
    splits cover [0, K) once."""
    per, splits = qm.tf32_k_split(M, K, N, resident)
    assert per % 128 == 0 and per > 0 and splits <= 16
    assert splits <= 8 or per >= 512
    assert splits == -(-K // per) and (splits - 1) * per < K <= splits * per
    cover = np.zeros(K, dtype=np.int64)
    for s in range(splits):
        cover[s * per:min(K, s * per + per)] += 1
    assert (cover == 1).all()


def test_k_split_fills_the_card_at_the_main_shapes():
    """At GPT-3 1.3B's decode shapes on 528 resident blocks (four of 128
    threads an SM on 132 SMs), K is split into the most parts, a power of
    two, whose blocks stay within 396 (three quarters of them), up to 8,
    or 16 where a split keeps 512 rows, in whole 128-row runs: qkv (48
    column tiles) and out_proj (16) 8 ways, down (16, K 8192) 16 ways, up
    (64) 4 ways, the head's 393 tiles not at all; at M 1 the same."""
    want = {(2048, 6144): (256, 8), (2048, 2048): (256, 8),
            (2048, 8192): (512, 4), (8192, 2048): (512, 16),
            (2048, 50304): (2048, 1)}
    for (K, N), plan in want.items():
        assert qm.tf32_k_split(8, K, N, 528) == plan
        assert qm.tf32_k_split(1, K, N, 528) == plan


@pytest.mark.parametrize("resident", [132, 264, 396, 528, 792])
@pytest.mark.parametrize("N", [5, 333, 2048, 6144, 8192, 50304, 262144])
def test_k_split_is_the_most_power_of_two_within_the_card(resident, N):
    """Before the rounding to 128-row runs, the split count is a power of
    two, its blocks within three quarters of the resident ones (or one
    split), and twice as many would pass them or 16; at K 4096 a split
    keeps 512 rows only up to 8 splits."""
    K = 1 << 16
    _, splits = qm.tf32_k_split(8, K, N, resident)
    tiles = -(-N // 128)
    assert splits in (1, 2, 4, 8, 16)
    assert splits == 1 or tiles * splits <= 3 * resident // 4
    assert splits == 16 or 2 * splits * tiles > 3 * resident // 4
    assert qm.tf32_k_split(8, 4096, N, resident)[1] == min(splits, 8)


# -------------------------------------------------- the plain version vs JAX
def _operands(seed, M, K, N, with_bias):
    rs = np.random.RandomState(seed)
    x = rs.randn(M, K).astype(np.float32)
    w = rs.randn(K, N).astype(np.float32)
    w_i8, scale = pm.quantize_channelwise(jnp.asarray(w), 8, axis=1)
    b = rs.randn(N).astype(np.float32) if with_bias else None
    return x, np.asarray(w_i8), np.asarray(scale), b


def _port(x, w_i8, scale, b):
    return qm.int8_weight_only_matmul(
        torch.from_numpy(x), torch.from_numpy(w_i8),
        torch.from_numpy(scale), None if b is None else torch.from_numpy(b))


def _jax(x, w_i8, scale, b, **kw):
    return pm.int8_weight_only_matmul(
        jnp.asarray(x), jnp.asarray(w_i8), jnp.asarray(scale),
        None if b is None else jnp.asarray(b), **kw)


def _close(got, ref):
    ref = np.asarray(ref)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    d = np.abs(got.numpy().astype(np.float64) - ref)
    assert (d <= TOL * np.maximum(np.abs(ref), 1.0)).all(), float(d.max())


@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("M", [1, 2, 3, 5, 8])
def test_plain_matches_pallas_kernel_interpret_at_f32_decode(M, with_bias):
    """The plain version (what the card holds the kernel against) against
    ``_wo_pallas`` in interpret mode at decode rows in f32, K 256 and N
    256 in two blocks each."""
    ops = _operands(100 + M, M, 256, 256, with_bias)
    assert pm.wo_supported(M, 256, 256, 32, 128, 128)
    ref = _jax(*ops, block_m=32, block_n=128, block_k=128, interpret=True)
    _close(_port(*ops), ref)


@pytest.mark.parametrize("M,K,N", [(1, 200, 333), (3, 37, 50), (5, 1030, 7),
                                   (8, 129, 336)])
def test_plain_matches_xla_route_ragged_at_f32_decode(M, K, N):
    """Ragged K and N, which the Pallas tiling refuses, against the JAX
    package's XLA route, in f32."""
    ops = _operands(M + K, M, K, N, True)
    _close(_port(*ops), _jax(*ops, interpret=False))


# ----------------------------------------------------- the C entry on a card
@pytest.mark.parametrize("M,K,N,bias", [(8, 2048, 8192, True),
                                        (1, 2048, 50304, False),
                                        (3, 200, 333, True),
                                        (5, 8192, 2048, False)])
def test_f32_decode_reaches_the_tf32_entry(wo_card, M, K, N, bias):
    """An f32 call at M <= 8 calls ``wo_gemv_tf32`` in the ``wo_matmul``
    library once, with the operands' and the output's pointers (no
    workspace: the splits of a column tile add through distributed shared
    memory), M, K, N, the split ``tf32_k_split`` chose, qmax and the
    stream, and counts one launch in the total and in the "gemv" route;
    a bf16 call of the same shape still reaches ``wo_gemv_mma``."""
    x = torch.zeros(M, K)
    w = torch.zeros(K, N, dtype=torch.int8)
    s = torch.ones(N)
    b = torch.zeros(N) if bias else None
    f = qm.int8_weight_only_matmul
    total, routes = f.launches, dict(f.route_launches)
    y = f(x, w, s, b)
    (lib, entry, args), = wo_card
    assert (lib, entry) == ("wo_matmul", "wo_gemv_tf32")
    assert args[:5] == (x.data_ptr(), w.data_ptr(), s.data_ptr(),
                        None if b is None else b.data_ptr(), y.data_ptr())
    assert args[5:] == (M, K, N, qm.tf32_k_split(M, K, N, 396)[0], 127.0,
                        None)
    assert y.dtype == torch.float32 and tuple(y.shape) == (M, N)
    routes["gemv"] += 1
    assert (f.launches, f.route_launches) == (total + 1, routes)
    f(x.to(torch.bfloat16), w, s, None if b is None else b.bfloat16())
    assert wo_card[-1][1] == "wo_gemv_mma"


def test_the_resident_blocks_come_from_the_f32_occupancy_entry(monkeypatch):
    """The plan asks ``wo_gemv_tf32_blocks_per_sm`` (vec = N % 16 == 0)
    once a device, N alignment and dtype, and multiplies by the SMs."""
    asked = []

    class Lib:
        def wo_gemv_tf32_blocks_per_sm(self, vec, out):
            asked.append(vec)
            out._obj.value = 3
            return 0
    monkeypatch.setattr(qm, "_RESIDENT", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: type("P", (), {
                            "multi_processor_count": 132}))
    dev = torch.device("cuda", 0)
    assert qm._resident(Lib(), dev, 8192, torch.float32, "gemv") == 396
    assert qm._resident(Lib(), dev, 2048, torch.float32, "gemv") == 396
    assert qm._resident(Lib(), dev, 333, torch.float32, "gemv") == 396
    assert asked == [1, 0]


def test_launch_error_raises(monkeypatch):
    """A launch the C entry reports as failed raises, naming the entry;
    the plain version does not run and nothing is counted."""
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
    before = qm.int8_weight_only_matmul.route_launches["gemv"]
    with pytest.raises(RuntimeError, match="wo_gemv_tf32: CUDA error 7"):
        qm.int8_weight_only_matmul(torch.zeros(8, 2048),
                                   torch.zeros(2048, 2048, dtype=torch.int8),
                                   torch.ones(2048), torch.zeros(2048))
    assert qm.int8_weight_only_matmul.route_launches["gemv"] == before


def test_c_entry_signatures_are_the_wrapper_calls():
    """The entry's ctypes signature is the bf16 decode entry's: five
    pointers (x, w, s, bias, y), four ints (M, K, N, the split), qmax as
    a float and the stream; the occupancy entry takes vec and a pointer;
    the CUDA-core entries are gone."""
    P, I = ctypes.c_void_p, ctypes.c_int
    assert qm._SIGNATURES["wo_gemv_tf32"] == [P] * 5 + [I] * 4 + [
        ctypes.c_float, P]
    assert qm._SIGNATURES["wo_gemv_tf32_blocks_per_sm"] == [I, P]
    assert "wo_matmul" not in qm._SIGNATURES
    assert "wo_gemv_blocks_per_sm" not in qm._SIGNATURES


def test_the_smoke_names_every_instantiation():
    """``chip_smoke.tf32_instance`` reads the 16-byte loads of w and x
    from the kernel's mangled names; its SASS check requires the four,
    and the one the model's path runs (w and x in 16-byte loads) must not
    spill."""
    import chip_smoke as cs
    tail = "EEvPKfPKaS1_S1_Pfiiiif"
    names = {cs.tf32_instance(f"_ZN12_GLOBAL__N_119wo_gemv_tf32_kernelILb"
                              f"{wv}ELb{xv}{tail}")
             for wv in (0, 1) for xv in (0, 1)}
    want = cs.TF32_KERNELS["wo_matmul"]["wo_gemv_tf32_kernel"]
    assert len(want) == 4
    assert names == {("wo_gemv_tf32_kernel", i) for i in want}
    assert ("wo_gemv_tf32_kernel", "f32 decode w16 x16") in \
        cs.TF32_MAIN_PATH
