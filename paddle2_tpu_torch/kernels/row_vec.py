"""The route rule and launch plan of the norms' vector kernels, on the
host: the Python side of ``csrc/row_vec.cuh``.

The C entries ``rms_norm_fwd``, ``rms_norm_bwd``, ``layer_norm_fwd``,
``layer_norm_bwd`` and ``rope`` pick their kernel by this rule
themselves (from the shape and the addresses alone); the wrappers ask
:func:`route` only to count each launch on its route, and the tests read
:func:`vec_plan` to model the kernels' mapping.
"""

from typing import Tuple

__all__ = ["ROUTES", "VEC_NT", "VEC_WARPS", "MAX_VPL", "BWD_MAX_VPL",
           "LN_BWD_MAX_VPL", "route", "vec_plan"]

ROUTES = ("vec", "general")
VEC_NT = 256
VEC_WARPS = VEC_NT // 32
# the vectors a lane holds at most: the forwards; the RMSNorm backward
# (csrc/rms_norm.cu), whose lanes hold x, do and their dw sums; the
# LayerNorm backward (csrc/layer_norm.cu), whose lanes hold x, dy and
# their dγ and dβ sums
MAX_VPL = 16
BWD_MAX_VPL = 4
LN_BWD_MAX_VPL = 2


def route(row_bytes: int, *ptrs: int) -> str:
    """"vec" when 16-byte vectors take a row of ``row_bytes`` bytes
    (``H * sizeof(x) % 16 == 0``) and every data pointer in ``ptrs``
    lies on a 16-byte boundary; else "general"."""
    bad = row_bytes
    for p in ptrs:
        bad |= p
    return "general" if bad & 15 else "vec"


def vec_plan(nv: int, max_vpl: int = MAX_VPL) -> Tuple[int, int]:
    """``(warps a row, vectors a lane)`` for a row of ``nv`` 16-byte
    vectors: the fewest warps (a power of two, at most a block's
    ``VEC_WARPS``) that keep a lane at ``max_vpl`` vectors or fewer, then
    the power of two that covers the row."""
    w = 1
    while w * 32 * max_vpl < nv and w < VEC_WARPS:
        w *= 2
    per = -(-nv // (32 * w))
    p = 1
    while p < per:
        p *= 2
    return w, p
