"""The int8 x int8 matmul on the tensor cores (``i8i8_wgmma_kernel`` and
``i8i8_gemv_mma_kernel`` in ``paddle2_tpu_torch/kernels/csrc/i8i8_matmul.cu``),
on the CPU, where no card runs them:

- ``transpose4x4``'s byte map (``__byte_perm`` modelled in numpy), bit for
  bit;
- a host model of the prefill kernel: the warpgroups' rewrite of a
  TMA-landed ``[128, BN]`` w tile into the K-major tile in the 128-byte
  swizzle (``transpose_tile``), replayed thread by thread on bytes, read
  back through the swizzle the wgmma descriptor names, with its loads and
  stores free of bank conflicts; and the walk over the grid (M tiles, N
  tiles, the K splits of a cluster, stages, the two warpgroups, the two
  64-row halves, the k32 steps), the m64nNk32 accumulator layout and the
  split reduction's share of the outputs, meeting every (m, k, n) product
  once at ragged M, N and K;
- a host mirror of ``mma.sync.m16n8k32``'s s8 fragment layouts (PTX ISA,
  "Matrix Fragments for mma.m16n8k32") and the decode kernel's swapped
  maps: A's and B's k slots stand for the same rows of w and x, each A row
  for one column of w; walked over the grid (column tiles, K splits, M
  tiles, the warps' steps), every product once, and the sums equal
  ``x @ w``;
- the plans: the route boundary, the tile width, both kernels' K splits;
- the wrapper's path to both C entries through a stand-in library (the
  right pointers, ints and split; y from ``torch.empty``; one launch
  counted in the total and in its route), a launch error raising, and the
  plain version against the JAX package at the boundary's rows.

Tolerances: every model sums small integers exactly (int64), so sums
and maps are compared exactly; the plain version against JAX bitwise.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle2_tpu.kernels import pallas_matmul as pm
from paddle2_tpu_torch.kernels import _build
from paddle2_tpu_torch.kernels import quant_matmul as qm

BM, BK = 128, 128          # the prefill kernel's rows of x and of K
COLS, KSTEP, WARPS = 128, 32, 4   # the decode kernel's tile, step, warps


# ------------------------------------------------------------ transpose4x4
def byte_perm(a, b, sel):
    """CUDA's ``__byte_perm(a, b, sel)``: byte i of the result is byte
    ``sel``'s nibble i (its low 3 bits) of the 8 bytes of (a, b)."""
    src = [(a >> 8 * i) & 0xFF for i in range(4)] + \
        [(b >> 8 * i) & 0xFF for i in range(4)]
    return sum(src[(sel >> 4 * i) & 7] << 8 * i for i in range(4))


def transpose4x4(r0, r1, r2, r3):
    """``transpose4x4`` of csrc/i8i8_matmul.cu, its six byte
    permutations as written."""
    lo01 = byte_perm(r0, r1, 0x5140)
    hi01 = byte_perm(r0, r1, 0x7362)
    lo23 = byte_perm(r2, r3, 0x5140)
    hi23 = byte_perm(r2, r3, 0x7362)
    return (byte_perm(lo01, lo23, 0x5410), byte_perm(lo01, lo23, 0x7632),
            byte_perm(hi01, hi23, 0x5410), byte_perm(hi01, hi23, 0x7632))


def _words(rows):
    """Four little-endian 32-bit words from a [4, 4] uint8 array."""
    return [int(v) for v in np.ascontiguousarray(rows).view("<u4").ravel()]


@pytest.mark.parametrize("seed", range(4))
def test_transpose4x4_is_the_byte_transpose(seed):
    """Rows r0..r3 of four bytes (byte j of row i = w[k + i, n + j]):
    word j of the result holds column j's four k values, k in byte order,
    for random bytes and for the 16 distinct bytes 0..15."""
    rs = np.random.RandomState(seed)
    blocks = [rs.randint(0, 256, size=(4, 4)).astype(np.uint8),
              np.arange(16, dtype=np.uint8).reshape(4, 4)]
    for blk in blocks:
        out = transpose4x4(*_words(blk))
        got = np.array(out, dtype="<u4").view(np.uint8).reshape(4, 4)
        assert np.array_equal(got, blk.T)


# ----------------------------------------------- the prefill kernel's rewrite
def transpose_tile(raw, tk, BN, counts=None):
    """``transpose_tile<BN>`` for both warpgroups, thread by thread: raw
    is the TMA-landed tile ``[BK rows][BN bytes]`` (flat uint8), tk the
    K-major tile ``[BN rows][128 bytes]`` in the 128-byte swizzle (flat
    uint8), written in place. ``counts`` (if given) collects the word and
    chunk addresses of each warp instruction for the bank checks."""
    G, U = BN // 8, BN // 128
    for h in range(2):
        for wq in range(4):
            for u in range(U):
                loads = [[None] * 32 for _ in range(16)]
                stores = [[None] * 32 for _ in range(4)]
                for lane in range(32):
                    cg, hi = lane % G, lane // G
                    kc = (((cg >> 1) + wq) & 3) + 4 * (hi + u)
                    src = 16 * kc * BN + h * (BN // 2) + 4 * cg
                    r = []
                    for i in range(16):
                        a = src + i * BN
                        loads[i][lane] = a
                        r.append(int(raw[a:a + 4].view("<u4")[0]))
                    tq = [transpose4x4(*r[4 * q:4 * q + 4]) for q in range(4)]
                    for j in range(4):
                        n = h * (BN // 2) + 4 * cg + j
                        dst = n * 128 + ((kc ^ (n & 7)) * 16)
                        stores[j][lane] = dst
                        chunk = np.array([tq[q][j] for q in range(4)],
                                         dtype="<u4").view(np.uint8)
                        tk[dst:dst + 16] = chunk
                if counts is not None:
                    counts.append((loads, stores))


def k_major_read(tk, n, k):
    """Byte k of K-major row n as the wgmma descriptor's 128-byte swizzle
    places it: 16-byte chunk k // 16 of the row at chunk (k // 16) ^ (n %
    8)."""
    return tk[n * 128 + (((k // 16) ^ (n % 8)) * 16) + k % 16]


@pytest.mark.parametrize("BN", [128, 256])
def test_rewrite_is_the_k_major_swizzled_tile(BN):
    """Every byte of the raw tile (w[k, n] at k * BN + n) lands exactly
    once, at the place where the descriptor reads row n, byte k; every
    16-byte chunk of the K-major tile is written exactly once."""
    rs = np.random.RandomState(BN)
    raw = rs.randint(0, 256, size=BK * BN).astype(np.uint8)
    tk = np.zeros(BN * 128, dtype=np.uint8)
    counts = []
    transpose_tile(raw, tk, BN, counts)
    w = raw.reshape(BK, BN)
    got = np.array([[k_major_read(tk, n, k) for k in range(BK)]
                    for n in range(BN)], dtype=np.uint8)
    assert np.array_equal(got, w.T)
    dsts = sorted(d for _, stores in counts for row in stores for d in row)
    assert dsts == list(range(0, BN * 128, 16))
    srcs = sorted(a for loads, _ in counts for row in loads for a in row)
    assert srcs == list(range(0, BK * BN, 4))


@pytest.mark.parametrize("BN", [128, 256])
def test_rewrite_loads_and_stores_avoid_bank_conflicts(BN):
    """Each warp's 4-byte load reads 32 different banks (row stride BN
    bytes is a multiple of 128; the lanes take different column words)
    where the tile is 256 columns wide, and at most 2 words a bank at 128
    (the warpgroup's half is 16 words); each 8-lane phase of a 16-byte
    store writes 8 different chunk positions of a 128-byte line (no
    conflict)."""
    raw = np.zeros(BK * BN, dtype=np.uint8)
    tk = np.zeros(BN * 128, dtype=np.uint8)
    counts = []
    transpose_tile(raw, tk, BN, counts)
    for loads, stores in counts:
        for row in loads:
            banks = np.bincount([(a // 4) % 32 for a in row], minlength=32)
            assert banks.max() == (1 if BN == 256 else 2)
        for row in stores:
            for p in range(4):
                phase = row[8 * p:8 * p + 8]
                assert len({(d // 16) % 8 for d in phase}) == 8


def acc_owner(N):
    """The m64nNk32 s32 accumulator (PTX, "wgmma .m64nNk32 register
    fragment", the f32/s32 D layout): thread (warp w, lane l) of the
    warpgroup holds d[4 j + 2 hh + e] at row 16 w + l / 4 + 8 hh, column 8 j
    + 2 (l % 4) + e. Returns owner[row, col] = (w, l, reg), each once."""
    owner = {}
    for w in range(4):
        for lane in range(32):
            for j in range(N // 8):
                for hh in range(2):
                    for e in range(2):
                        key = (16 * w + lane // 4 + 8 * hh,
                               8 * j + 2 * (lane % 4) + e)
                        assert key not in owner
                        owner[key] = (w, lane, 4 * j + 2 * hh + e)
    assert len(owner) == 64 * N
    return owner


@pytest.mark.parametrize("N", [64, 128])
def test_accumulator_layout_covers_the_tile_once(N):
    owner = acc_owner(N)
    assert {k for k in owner} == {(r, c) for r in range(64)
                                  for c in range(N)}
    regs = {(w, lane) for w, lane, _ in owner.values()}
    assert len(regs) == 128
    assert max(reg for _, _, reg in owner.values()) == N // 2 - 1


def prefill_model(x, w, bn, per):
    """The prefill kernel's walk, with TMA's zero fill: grid (M tiles, N
    tiles, K splits of ``per`` rows), each block's stages of 128 rows of
    K, warpgroup h's columns h bn/2 .. of both 64-row halves, 4 k32 steps
    a stage. The products go through the swizzled tiles: x's 128 x 128
    tile as TMA's 128-byte swizzle lands it (row r, chunk c at c ^ (r %
    8)) and w's tile rewritten by ``transpose_tile`` (first stage of the
    first block thread by thread; the rest by its proven map). Then the
    accumulators go to y: one split through their owners, several through
    the cluster's reduction (rank r adds outputs o = tid + 288 (r + S i)
    of the tile's rows below M). Returns y and how often each (m, k, n)
    product and each output was taken."""
    M, K = x.shape
    N = w.shape[1]
    splits = -(-K // per)
    y = np.zeros((M, N), dtype=np.int64)
    seen = np.zeros((M, K, N), dtype=np.int64)
    written = np.zeros((M, N), dtype=np.int64)
    first = True
    for bx in range(-(-M // BM)):
        for by in range(-(-N // bn)):
            m0, n0 = bx * BM, by * bn
            parts = []
            for bz in range(splits):
                kb = bz * per
                n_k = -(-(min(K, kb + per) - kb) // BK)
                acc = np.zeros((BM, bn), dtype=np.int64)
                for i in range(n_k):
                    k0 = kb + i * BK
                    xt = np.zeros((BM, BK), dtype=np.int64)
                    wt = np.zeros((BK, bn), dtype=np.int64)
                    mm, kk_ = min(M, m0 + BM) - m0, min(K, k0 + BK) - k0
                    nn = min(N, n0 + bn) - n0
                    xt[:mm, :kk_] = x[m0:m0 + mm, k0:k0 + kk_]
                    wt[:kk_, :nn] = w[k0:k0 + kk_, n0:n0 + nn]
                    # x as TMA swizzles it, read back as the descriptor does
                    xs = np.zeros(BM * BK, dtype=np.int64)
                    for r in range(BM):
                        for c in range(8):
                            p = r * 128 + ((c ^ (r % 8)) * 16)
                            xs[p:p + 16] = xt[r, 16 * c:16 * c + 16]
                    xr = np.array([[xs[r * 128 + (((k // 16) ^ (r % 8)) * 16)
                                       + k % 16] for k in range(BK)]
                                   for r in range(BM)])
                    if first:
                        raw = (wt.astype(np.int8).view(np.uint8)
                               .reshape(-1).copy())
                        tk = np.zeros(bn * 128, dtype=np.uint8)
                        transpose_tile(raw, tk, bn)
                        wr = np.array([[k_major_read(tk, n, k)
                                        for k in range(BK)]
                                       for n in range(bn)], dtype=np.uint8)
                        wr = wr.view(np.int8).astype(np.int64)
                        first = False
                    else:
                        wr = wt.T
                    for h in range(2):
                        cols = slice(h * bn // 2, (h + 1) * bn // 2)
                        for mb in range(2):
                            rows = slice(64 * mb, 64 * mb + 64)
                            for kk in range(BK // 32):
                                ks = slice(32 * kk, 32 * kk + 32)
                                acc[rows, cols] += xr[rows, ks] @ wr[cols, ks].T
                                gm = np.arange(m0 + 64 * mb, m0 + 64 * mb + 64)
                                gk = np.arange(k0 + 32 * kk, k0 + 32 * kk + 32)
                                gn = np.arange(n0 + h * bn // 2,
                                               n0 + (h + 1) * bn // 2)
                                ok_m, ok_k, ok_n = gm < M, gk < K, gn < N
                                seen[np.ix_(gm[ok_m], gk[ok_k], gn[ok_n])] += 1
                parts.append(acc)
            if splits == 1:
                owner_cols = {}
                for (r, c), own in acc_owner(bn // 2).items():
                    owner_cols[(r, c)] = own
                for mb in range(2):
                    for h in range(2):
                        for (r, c) in owner_cols:
                            m, n = m0 + 64 * mb + r, n0 + h * bn // 2 + c
                            if m < M and n < N:
                                y[m, n] = parts[0][64 * mb + r,
                                                   h * bn // 2 + c]
                                written[m, n] += 1
            else:
                rows_valid, Q = min(BM, M - m0), bn // 4
                for r in range(splits):
                    for tid in range(288):
                        for o in range(tid + 288 * r, rows_valid * Q,
                                       288 * splits):
                            m, c = o // Q, (o % Q) * 4
                            if n0 + c >= N:
                                continue
                            s = sum(p[m, c:c + 4] for p in parts)
                            y[m0 + m, n0 + c:n0 + c + 4] = s
                            written[m0 + m, n0 + c:n0 + c + 4] += 1
    return y, seen, written


@pytest.mark.parametrize("M,K,N,bn,per", [
    (130, 256, 256, 128, 256),     # two M tiles, one split
    (37, 208, 144, 128, 128),      # ragged M, K past a stage, N past a tile
    (200, 384, 288, 256, 128),     # three splits (a cluster), ragged N
    (17, 130, 16, 128, 256),       # K not a multiple of 16 in the model
    (140, 640, 256, 256, 256),     # splits of 2 stages, the last short
    (260, 300, 144, 128, 384),     # three M tiles, two N tiles, one split
    (300, 200, 256, 256, 256)])    # a 256-wide tile past N's rows
def test_prefill_model_takes_every_product_once(M, K, N, bn, per):
    """Through the model every product of ``x @ w`` is taken exactly
    once, every output written exactly once, and the sums equal the
    int64 product: ragged M, N and K, splits whose last part is short,
    tiles past M and N."""
    rs = np.random.RandomState(M + K + N)
    x = rs.randint(-128, 128, size=(M, K)).astype(np.int64)
    w = rs.randint(-128, 128, size=(K, N)).astype(np.int64)
    y, seen, written = prefill_model(x, w, bn, per)
    assert (seen == 1).all()
    assert (written == 1).all()
    assert np.array_equal(y, x @ w)


# --------------------------------------------- the decode kernel's maps
# PTX ISA, mma.m16n8k32 with .s8 operands: lane = 4 g + t; each 32-bit
# register holds four bytes, the lowest index in the low byte.
def ptx_a(lane, reg, b):
    """(row, k) of A (16 x 32, row-major) in byte b of register ``reg``:
    a0 row g, k 4t+b; a1 row g+8; a2 row g, k 16+4t+b; a3 row g+8."""
    g, t = divmod(lane, 4)
    return g + 8 * (reg % 2), 4 * t + b + 16 * (reg // 2)


def ptx_b(lane, reg, b):
    """(k, column) of B (32 x 8) in byte b of register ``reg``: b0 k
    4t+b, b1 k 16+4t+b, column g."""
    g, t = divmod(lane, 4)
    return 4 * t + b + 16 * reg, g


def ptx_c(lane, reg):
    """(row, column) of C/D (16 x 8, s32) in accumulator ``reg``."""
    g, t = divmod(lane, 4)
    return g + 8 * (reg // 2), 2 * t + reg % 2


# What the kernel puts there: thread (g, t) loads rows 8t .. 8t+7 of a
# step at columns 16g .. 16g+15; word q of rows 8t..8t+3 transposed is
# `lo`, of rows 8t+4..8t+7 `hi`; mma j = 2q + p takes a0 = lo word 2p, a1
# = lo word 2p+1, a2 = hi word 2p, a3 = hi word 2p+1, and x's row as b0 (k
# 8t..8t+3) and b1 (k 8t+4..8t+7).
def kernel_a(lane, j, reg, b):
    """(column of the tile, row of the step) of w in byte b of A
    register ``reg`` of mma j."""
    g, t = divmod(lane, 4)
    q, p = divmod(j, 2)
    col = 16 * g + 4 * q + 2 * p + reg % 2
    return col, 8 * t + 4 * (reg // 2) + b


def kernel_b(lane, reg, b):
    """(row of the step, row m of x's n8 tile) in byte b of B register
    ``reg``: one 8-byte load of x's row g at the step's k 8t .. 8t+7."""
    g, t = divmod(lane, 4)
    return 8 * t + 4 * reg + b, g


def kernel_c(lane, j, reg):
    """(column of the tile, row m of the n8 tile) the kernel stores
    accumulator ``reg`` of mma j to: red[w][2t][16g + 2j] gets (c0, c2),
    red[w][2t + 1][16g + 2j] gets (c1, c3)."""
    g, t = divmod(lane, 4)
    return 16 * g + 2 * j + reg // 2, 2 * t + reg % 2


def _maps():
    """For each mma j: A's (column, step row) by (row, k) and B's (step
    row, m) by (k, column), filled from the kernel's registers through
    the PTX layouts, each position once."""
    a_col = np.full((8, 16, 32), -1)
    a_row = np.full((8, 16, 32), -1)
    b_row = np.full((32, 8), -1)
    b_m = np.full((32, 8), -1)
    for lane in range(32):
        for j in range(8):
            for reg in range(4):
                for b in range(4):
                    r, k = ptx_a(lane, reg, b)
                    assert a_col[j, r, k] == -1
                    a_col[j, r, k], a_row[j, r, k] = kernel_a(lane, j, reg, b)
        for reg in range(2):
            for b in range(4):
                k, c = ptx_b(lane, reg, b)
                assert b_row[k, c] == -1
                b_row[k, c], b_m[k, c] = kernel_b(lane, reg, b)
    assert (a_col >= 0).all() and (b_row >= 0).all()
    return a_col, a_row, b_row, b_m


def test_decode_fragment_maps_agree():
    """Each A row stands for one column of the tile and each B column for
    one row of x; A's and B's k slots stand for the same step row (the k
    map, a permutation of the step's 32 rows); each accumulator is the
    product of the A row and B column the kernel's store says (the column
    map); the 8 mmas of a step cover the warp's 128 columns once."""
    a_col, a_row, b_row, b_m = _maps()
    assert (a_col == a_col[:, :, :1]).all()
    assert (b_m == b_m[:1, :]).all()
    assert (a_row == b_row[:, 0][None, None, :]).all()
    assert sorted(b_row[:, 0]) == list(range(32))
    assert sorted(b_m[0]) == list(range(8))
    assert sorted(a_col[:, :, 0].ravel()) == list(range(COLS))
    for lane in range(32):
        for j in range(8):
            for reg in range(4):
                r, c = ptx_c(lane, reg)
                assert kernel_c(lane, j, reg) == (a_col[j, r, 0], b_m[0, c])


def test_decode_a_fragment_is_transpose4x4_of_the_loaded_rows():
    """Bit for bit: the thread's eight 16-byte rows (uint4 words q),
    transposed word by word as the kernel does, give A registers whose
    byte b holds w at the (column, row) ``kernel_a`` names."""
    rs = np.random.RandomState(3)
    rows = rs.randint(0, 256, size=(8, 16)).astype(np.uint8)  # [row][col]
    for j in range(8):
        q, p = divmod(j, 2)
        lo = transpose4x4(*[int(rows[r, 4 * q:4 * q + 4].view("<u4")[0])
                            for r in range(4)])
        hi = transpose4x4(*[int(rows[r, 4 * q:4 * q + 4].view("<u4")[0])
                            for r in range(4, 8)])
        regs = [lo[2 * p], lo[2 * p + 1], hi[2 * p], hi[2 * p + 1]]
        for reg, val in enumerate(regs):
            for b in range(4):
                col, row = kernel_a(0, j, reg, b)     # g = 0, t = 0
                assert (val >> 8 * b) & 0xFF == rows[row, col]


def decode_model(x, w, per):
    """The decode kernel's products through the maps: grid (column tiles,
    K splits of ``per`` rows, M tiles of 8 NT8 rows), warp w taking its
    block's steps w, w + 4, ...; zeros past K, N and M; the cluster's
    reduction (rank r adds outputs o = tid + 128 (r + S i) of the M
    tile's rows below M). Returns y, how often each product was taken and
    each output written."""
    M, K = x.shape
    N = w.shape[1]
    rm = 8 if M <= 8 else 16
    a_col, a_row, b_row, b_m = _maps()
    kk = b_row[:, 0]
    splits = -(-K // per)
    y = np.zeros((M, N), dtype=np.int64)
    seen = np.zeros((M, K, N), dtype=np.int64)
    written = np.zeros((M, N), dtype=np.int64)
    for bx in range(-(-N // COLS)):
        for bz in range(-(-M // rm)):
            parts = []
            for by in range(splits):
                kbeg, kend = by * per, min(K, by * per + per)
                steps = -(-(kend - kbeg) // KSTEP)
                part = np.zeros((rm, COLS), dtype=np.int64)
                for warp in range(WARPS):
                    for s in range(warp, steps, WARPS):
                        k0 = kbeg + KSTEP * s
                        ks = k0 + kk
                        for tile in range(rm // 8):
                            ms = bz * rm + 8 * tile + b_m[0]
                            b = np.zeros((32, 8), dtype=np.int64)
                            for q in range(32):
                                for c in range(8):
                                    if ks[q] < kend and ms[c] < M:
                                        b[q, c] = x[ms[c], ks[q]]
                            for j in range(8):
                                cols = bx * COLS + a_col[j, :, 0]
                                a = np.zeros((16, 32), dtype=np.int64)
                                for r in range(16):
                                    for q in range(32):
                                        k = k0 + a_row[j, r, q]
                                        if k < kend and cols[r] < N:
                                            a[r, q] = w[k, cols[r]]
                                d = a @ b
                                for r in range(16):
                                    for c in range(8):
                                        part[8 * tile + b_m[0, c],
                                             a_col[j, r, 0]] += d[r, c]
                                        m = ms[c]
                                        if m < M and cols[r] < N:
                                            for q in range(32):
                                                if ks[q] < kend:
                                                    seen[m, ks[q], cols[r]] += 1
                parts.append(part)
            rows = min(rm, M - bz * rm)
            for r in range(splits):
                for tid in range(128):
                    for o in range(tid + 128 * r, rows * COLS,
                                   128 * splits):
                        n = bx * COLS + o % COLS
                        if n >= N:
                            continue
                        m = bz * rm + o // COLS
                        y[m, n] = sum(p[o // COLS, o % COLS] for p in parts)
                        written[m, n] += 1
    return y, seen, written


@pytest.mark.parametrize("M,K,N,per", [(8, 256, 128, 128), (3, 200, 133, 128),
                                       (1, 37, 5, 128), (9, 300, 130, 256),
                                       (16, 129, 256, 1024),
                                       (21, 160, 40, 128)])
def test_decode_model_takes_every_product_once(M, K, N, per):
    """Every product of ``x @ w`` taken exactly once (ragged K and N, a
    short last split, steps past a split's end, M 9..16 on two n8 tiles,
    M 21 on two M tiles off TMA's rule), every output written once, and
    the sums equal the int64 product."""
    rs = np.random.RandomState(M * K + N)
    x = rs.randint(-128, 128, size=(M, K)).astype(np.int64)
    w = rs.randint(-128, 128, size=(K, N)).astype(np.int64)
    y, seen, written = decode_model(x, w, per)
    assert (seen == 1).all()
    assert (written == 1).all()
    assert np.array_equal(y, x @ w)


# ---------------------------------------------------------------- plans
@pytest.mark.parametrize("M,K,N,route", [
    (1, 2048, 8192, "mma"), (8, 2048, 6144, "mma"), (9, 2048, 2048, "mma"),
    (16, 8192, 2048, "mma"), (17, 2048, 2048, "wgmma"),
    (32, 2048, 8192, "wgmma"), (1008, 8192, 2048, "wgmma"),
    (37, 200, 336, "mma"), (1008, 208, 333, "mma"), (37, 208, 336, "wgmma")])
def test_route_boundary_and_tma_rule(M, K, N, route):
    """Up to 16 rows the decode kernel, above it the prefill kernel, but
    only where K and N are multiples of 16 (TMA's rule)."""
    assert qm.I8I8_DECODE_MAX_M == 16
    assert qm.i8i8_route(M, K, N) == route


@pytest.mark.parametrize("M", [17, 32, 48, 144, 272, 624, 1008])
@pytest.mark.parametrize("K,N", [(2048, 6144), (2048, 2048), (2048, 8192),
                                 (8192, 2048), (208, 336), (16, 16)])
@pytest.mark.parametrize("sms", [132, 114, 16])
def test_prefill_split_is_one_cluster_of_whole_stages(M, K, N, sms):
    """The prefill plan: the tile 256 wide where those tiles fill a wave
    or K is at least 4096 rows, else 128; K split 1, 2, 4 or 8 ways into
    whole 128-row stages, at least 4 a split, with every block in one wave
    (the SMs for clusters of 2, half of them for 4 and 8); the largest
    such split; the splits cover K once."""
    bn = qm.i8i8_tile_n(M, K, N, sms)
    per, splits = qm.i8i8_split(M, K, N, sms)
    tiles = -(-M // BM) * -(-N // bn)
    stages = -(-K // BK)
    assert (bn == 256) == (-(-M // BM) * -(-N // 256) >= sms or K >= 4096)
    assert bn in (128, 256)
    assert splits in (1, 2, 4, 8) and per % BK == 0
    assert splits == -(-K // per) and (splits - 1) * per < K <= splits * per
    fits = lambda s: (stages >= 4 * s and   # noqa: E731
                      tiles * s <= (sms if s <= 2 else sms // 2))
    assert splits == 1 or fits(splits)
    assert not any(fits(s) for s in (2, 4, 8) if s > splits)


def test_prefill_plans_at_the_main_shapes():
    """On 132 SMs, the plans the card timed fastest: M 1008 up and qkv on
    256-wide tiles unsplit (256 and 192 tiles), out_proj on 128-wide tiles
    unsplit (128), down 256 wide in 2 splits (64 tiles); M 144 up and qkv
    128 wide unsplit, out_proj 2 splits (32 tiles), down 256 wide in 4
    (16 tiles); M 32 up and qkv 2 splits, out_proj 4 (16 tiles), down 256
    wide in 8 (8 tiles)."""
    want = {(1008, 2048, 8192): (256, 2048, 1),
            (1008, 2048, 6144): (256, 2048, 1),
            (1008, 2048, 2048): (128, 2048, 1),
            (1008, 8192, 2048): (256, 4096, 2),
            (144, 2048, 8192): (128, 2048, 1),
            (144, 2048, 6144): (128, 2048, 1),
            (144, 2048, 2048): (128, 1024, 2),
            (144, 8192, 2048): (256, 2048, 4),
            (32, 2048, 8192): (128, 1024, 2),
            (32, 2048, 6144): (128, 1024, 2),
            (32, 2048, 2048): (128, 512, 4),
            (32, 8192, 2048): (256, 1024, 8)}
    for (M, K, N), plan in want.items():
        assert (qm.i8i8_tile_n(M, K, N, 132),) + qm.i8i8_split(M, K, N,
                                                            132) == plan


@pytest.mark.parametrize("M", [1, 5, 8, 9, 16, 37])
@pytest.mark.parametrize("K,N", [(2048, 6144), (2048, 2048), (2048, 8192),
                                 (8192, 2048), (200, 333), (7, 5),
                                 (33000, 16)])
@pytest.mark.parametrize("sms", [132, 114, 16])
def test_decode_split_covers_k_in_whole_runs(M, K, N, sms):
    """Every split whole 128-row runs (32 rows for each of 4 warps; the C
    entry refuses anything else), at most 8 (one cluster), each holding
    rows, covering K once; the tiles times the splits within two blocks
    an SM (where the tiles alone do not pass it)."""
    per, splits = qm.i8i8_mma_split(M, K, N, sms)
    assert per % 128 == 0 and per > 0 and 1 <= splits <= 8
    assert splits == -(-K // per) and (splits - 1) * per < K <= splits * per
    tiles = -(-N // COLS) * -(-M // (8 if M <= 8 else 16))
    assert splits == 1 or tiles * splits <= 2 * sms


def test_decode_plans_at_the_main_shapes():
    """At M 8 on 132 SMs: qkv (48 column tiles: 5 splits of 410 rows
    round to 4 of 512) and up (64) 4 splits of 512 rows, out_proj (16) 8
    of 256, down (16) 8 of 1024."""
    want = {(2048, 6144): (512, 4), (2048, 2048): (256, 8),
            (2048, 8192): (512, 4), (8192, 2048): (1024, 8)}
    for (K, N), plan in want.items():
        assert qm.i8i8_mma_split(8, K, N, 132) == plan


# ---------------------------------------------------- the C entries, a card
@pytest.fixture
def i8_card(monkeypatch):
    """``int8_matmul`` told its tensors are on the card, the built
    library replaced by a recorder of (entry, arguments), 132 SMs; the
    plain version fails if called."""
    calls = []

    class StandIn:
        def __getattr__(self, entry):
            return lambda *args: calls.append((entry, args)) or 0
    monkeypatch.setattr(_build, "on_card", lambda what, *t: True)
    monkeypatch.setattr(_build, "library", lambda name, sigs: StandIn())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(qm, "_raw_stream", lambda index: None)
    monkeypatch.setattr(qm, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(qm, "_I8_PLANS", {})
    monkeypatch.setattr(qm, "int8_matmul_reference",
                        lambda *a: pytest.fail("the plain version ran"))
    return calls


@pytest.mark.parametrize("M,K,N", [(1, 2048, 6144), (8, 2048, 8192),
                                   (9, 2048, 2048), (16, 8192, 2048),
                                   (17, 2048, 2048), (32, 2048, 2048),
                                   (144, 2048, 8192), (1008, 8192, 2048),
                                   (37, 200, 333)])
def test_wrapper_routes_to_its_entry(i8_card, monkeypatch, M, K, N):
    """One call, one C entry: ``i8i8_gemv_mma(x, w, y, M, K, N, split,
    stream)`` up to 16 rows and off TMA's rule, ``i8i8_wgmma(x, w, y, M,
    K, N, tile width, split, stream)`` above; y is a fresh int32 [M, N]
    (no zeros: the splits add through distributed shared memory); one
    launch in the total and in the route."""
    monkeypatch.setattr(torch, "zeros",
                        lambda *a, **k: pytest.fail("y was zeroed"))
    x = torch.ones(M, K, dtype=torch.int8)
    w = torch.ones(K, N, dtype=torch.int8)
    f = qm.int8_matmul
    total, routes = f.launches, dict(f.route_launches)
    y = f(x, w)
    route = qm.i8i8_route(M, K, N)
    (entry, args), = i8_card
    assert args[:3] == (x.data_ptr(), w.data_ptr(), y.data_ptr())
    if route == "wgmma":
        per, splits = qm.i8i8_split(M, K, N, 132)
        assert entry == "i8i8_wgmma"
        assert args[3:] == (M, K, N, qm.i8i8_tile_n(M, K, N, 132), per, None)
    else:
        per, splits = qm.i8i8_mma_split(M, K, N, 132)
        assert entry == "i8i8_gemv_mma"
        assert args[3:] == (M, K, N, per, None)
    assert splits <= 8
    assert y.dtype == torch.int32 and tuple(y.shape) == (M, N)
    routes[route] += 1
    assert (f.launches, f.route_launches) == (total + 1, routes)


def test_wgmma_route_copies_an_operand_off_16_bytes(i8_card):
    """TMA reads from 16-byte boundaries: an x view one byte past one
    reaches the prefill entry as an aligned copy; w as it is."""
    buf = torch.zeros(32 * 2048 + 1, dtype=torch.int8)
    x = buf[1:].view(32, 2048)
    assert x.data_ptr() % 16
    w = torch.zeros(2048, 2048, dtype=torch.int8)
    qm.int8_matmul(x, w)
    (entry, args), = i8_card
    assert entry == "i8i8_wgmma"
    assert args[0] != x.data_ptr() and args[0] % 16 == 0
    assert args[1] == w.data_ptr()


def test_plans_are_made_once_per_shape(i8_card):
    """The second call of a shape reuses its plan: the SM count and the
    entry lookups are not repeated."""
    x = torch.zeros(8, 2048, dtype=torch.int8)
    w = torch.zeros(2048, 2048, dtype=torch.int8)
    qm.int8_matmul(x, w)
    plan = qm._I8_PLANS[(x.device, 8, 2048, 2048)]
    qm.int8_matmul(x, w)
    assert qm._I8_PLANS[(x.device, 8, 2048, 2048)] is plan
    assert [e for e, _ in i8_card] == ["i8i8_gemv_mma"] * 2


@pytest.mark.parametrize("M,route,entry", [(8, "mma", "i8i8_gemv_mma"),
                                           (1008, "wgmma", "i8i8_wgmma")])
def test_launch_error_raises(monkeypatch, M, route, entry):
    """A launch the C entry reports as failed raises, naming the entry;
    nothing is counted and the plain version does not run."""
    class Failing:
        def error_string(self, err):
            return b"too many resources requested for launch"

        def __getattr__(self, name):
            return lambda *args: 7
    monkeypatch.setattr(_build, "on_card", lambda what, *t: True)
    monkeypatch.setattr(_build, "library", lambda name, sigs: Failing())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(qm, "_raw_stream", lambda index: None)
    monkeypatch.setattr(qm, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(qm, "_I8_PLANS", {})
    monkeypatch.setattr(qm, "int8_matmul_reference",
                        lambda *a: pytest.fail("the plain version ran"))
    x = torch.zeros(M, 2048, dtype=torch.int8)
    w = torch.zeros(2048, 2048, dtype=torch.int8)
    f = qm.int8_matmul
    total, routes = f.launches, dict(f.route_launches)
    with pytest.raises(RuntimeError, match=f"{entry}: CUDA error 7"):
        f(x, w)
    assert (f.launches, f.route_launches) == (total, routes)


def test_c_entry_signatures_are_the_wrapper_calls():
    """Three pointers (x, w, y), then M, K, N (and the tile width for the
    prefill entry) and the split, then the stream."""
    P, I = ctypes.c_void_p, ctypes.c_int
    assert qm._I8_SIGNATURES == {"i8i8_wgmma": [P] * 3 + [I] * 5 + [P],
                                 "i8i8_gemv_mma": [P] * 3 + [I] * 4 + [P]}


# ------------------------------------------- the plain version at the edges
@pytest.mark.parametrize("M", [1, 8, 9, 16, 17, 32])
def test_plain_matches_jax_at_the_boundary(M):
    """The plain version (what the card holds both kernels against)
    against ``pallas_matmul.int8_matmul`` at the rows around the kernels'
    boundary and n8 tiles, bitwise; M 32 through the Pallas kernel in
    interpret mode (32 x 128 x 128 blocks)."""
    rs = np.random.RandomState(M)
    K, N = 256, 256
    x = rs.randint(-128, 128, size=(M, K)).astype(np.int8)
    w = rs.randint(-128, 128, size=(K, N)).astype(np.int8)
    kw = (dict(block_m=32, block_n=128, block_k=128, interpret=True)
          if M == 32 else {})
    ref = np.asarray(pm.int8_matmul(jnp.asarray(x), jnp.asarray(w), **kw))
    got = qm.int8_matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert np.array_equal(got, ref)
