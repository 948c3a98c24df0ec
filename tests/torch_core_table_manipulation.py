"""The case table of ``test_torch_core_manipulation.py`` (see
``torch_core_cases``): JAX-free, so that ``chip_smoke.py`` runs it on
the card."""

import numpy as np

from torch_core_cases import (Bo, Case, I, N, Raw, U, args, lst)  # noqa: F401

F32 = ("float32",)


def perm_index(n, k=None):
    return lambda r: r.permutation(n)[:k or n].astype(np.int32)


CASES = [
    Case("reshape", args(N(2, 6), Raw([3, 4]))),
    Case("reshape", args(N(2, 6), Raw([-1, 3])), label="-1"),
    Case("transpose", args(N(2, 3, 4), Raw([2, 0, 1]))),
    Case("t", args(N(3, 4))),
    Case("t", args(N(4)), label="1-D"),
    Case("flatten", args(N(2, 3, 4))),
    Case("flatten", args(N(2, 3, 4, 5)), kwargs=dict(start_axis=1,
                                                     stop_axis=2),
         label="middle"),
    Case("squeeze", args(N(1, 3, 1, 4))),
    Case("squeeze", args(N(1, 3, 1, 4)), kwargs=dict(axis=2), label="axis"),
    Case("squeeze", args(N(1, 3, 1, 4)), kwargs=dict(axis=[0, 1]),
         label="not one"),
    Case("unsqueeze", args(N(3, 4), 1)),
    Case("unsqueeze", args(N(3, 4), Raw([0, -1])), label="two"),
    Case("concat", args(lst(N(2, 3), N(4, 3)))),
    Case("concat", args(lst(N(2, 3), N(2, 1))), kwargs=dict(axis=1),
         label="axis1"),
    Case("stack", args(lst(N(2, 3), N(2, 3), N(2, 3)))),
    Case("stack", args(lst(N(2, 3), N(2, 3))), kwargs=dict(axis=-1),
         label="last"),
    Case("split", args(N(6, 4), 3)),
    Case("split", args(N(4, 7), Raw([2, -1, 3])), kwargs=dict(axis=1),
         label="sections"),
    Case("chunk", args(N(6, 4), 2)),
    Case("unstack", args(N(3, 4)), kwargs=dict(axis=1)),
    Case("unbind", args(N(3, 4))),
    Case("tile", args(N(2, 3), Raw([2, 1, 2]))),
    Case("expand", args(N(3, 1), Raw([2, 3, 4]))),
    Case("expand", args(N(3, 1), Raw([-1, 5])), label="-1"),
    Case("expand_as", args(N(1, 4), N(3, 4)), grad_args=(0,)),
    Case("broadcast_to", args(N(4), Raw([2, 4]))),
    Case("broadcast_tensors", args(lst(N(3, 1), N(1, 4)))),
    Case("flip", args(N(3, 4), 1)),
    Case("flip", args(N(2, 3, 4), Raw([0, 2])), label="two"),
    Case("rot90", args(N(3, 4))),
    Case("rot90", args(N(2, 3, 4)), kwargs=dict(k=3, axes=(1, 2)),
         label="k3"),
    Case("roll", args(N(3, 4), 2)),
    Case("roll", args(N(3, 4), Raw([1, -1])), kwargs=dict(axis=[0, 1]),
         label="axes"),
    Case("gather", args(N(5, 3), perm_index(5, 3))),
    Case("gather", args(N(3, 5), perm_index(5, 2)), kwargs=dict(axis=1),
         label="axis1"),
    Case("gather_nd", args(N(3, 4, 2), lambda r: np.stack(
        [r.integers(0, 3, 5), r.integers(0, 4, 5)], -1).astype(np.int32))),
    Case("scatter", args(N(5, 3), perm_index(5, 3), N(3, 3))),
    Case("scatter", args(N(5, 3), lambda r: np.array([1, 3, 1], np.int32),
                         N(3, 3)), kwargs=dict(overwrite=False),
         label="accumulate"),
    Case("scatter_nd", args(lambda r: np.array([[1], [3], [1]], np.int32),
                            N(3, 4), Raw([5, 4]))),
    Case("scatter_nd_add", args(N(4, 3), lambda r: np.array(
        [[0, 1], [2, 2], [0, 1]], np.int32), N(3))),
    Case("index_select", args(N(5, 3), perm_index(5, 4))),
    Case("index_sample", args(N(3, 5), I(0, 5, 3, 2))),
    Case("index_add", args(N(5, 3), lambda r: np.array([0, 2, 2], np.int32),
                           0, N(3, 3))),
    Case("index_put", args(N(4, 3), Raw(None), N(2)),
         label="placeholder"),
    Case("masked_select", args(N(3, 4), Bo(3, 4))),
    Case("masked_fill", args(N(3, 4), Bo(3, 4), 0.5)),
    Case("masked_fill", args(N(3, 4), Bo(3, 4), U(0, 1)), grad_args=(0,),
         label="tensor value"),
    Case("where", args(Bo(3, 4), N(3, 4), N(3, 4))),
    Case("where", args(Bo(3, 4), N(3, 4), 0.0), label="scalar"),
    Case("where", args(Bo(3, 4)), grad=False, label="nonzero"),
    Case("nonzero", args(Bo(3, 4)), grad=False),
    Case("nonzero", args(Bo(3, 4)), kwargs=dict(as_tuple=True), grad=False,
         label="tuple"),
    Case("take_along_axis", args(N(3, 5), I(0, 5, 3, 2), 1)),
    Case("put_along_axis", args(N(3, 5), lambda r: np.stack(
        [r.permutation(5)[:2] for _ in range(3)]).astype(np.int32),
        N(3, 2), 1)),
    Case("put_along_axis", args(N(3, 5), lambda r: np.stack(
        [r.permutation(5)[:2] for _ in range(3)]).astype(np.int32),
        N(3, 2), 1), kwargs=dict(reduce="add"), label="add"),
    Case("put_along_axis", args(N(3, 5), lambda r: np.stack(
        [r.permutation(5)[:2] for _ in range(3)]).astype(np.int32),
        2.0, 1), kwargs=dict(reduce="multiply"), label="multiply",
        # the JAX package differentiates no scatter-multiply
        grad=False),
    Case("repeat_interleave", args(N(3, 2), 2), kwargs=dict(axis=0)),
    Case("repeat_interleave", args(N(3, 2), lambda r: np.array(
        [1, 0, 3], np.int32)), kwargs=dict(axis=0), label="tensor"),
    Case("repeat_interleave", args(N(3, 2), 2), label="flat"),
    Case("unique", args(I(0, 5, 12)), kwargs=dict(
        return_index=True, return_inverse=True, return_counts=True),
        grad=False, dtypes=F32),
    Case("unique", args(I(0, 3, 3, 4)), kwargs=dict(return_inverse=True),
         grad=False, dtypes=F32, label="2-D"),
    Case("unique", args(lambda r: np.array(
        [[1, 2], [0, 1], [1, 2]], np.float32)), kwargs=dict(
        axis=0, return_inverse=True, return_counts=True), grad=False,
        label="axis"),
    Case("unique_consecutive", args(lambda r: np.array(
        [1, 1, 2, 2, 2, 1, 3, 3], np.int32)), kwargs=dict(
        return_inverse=True, return_counts=True), grad=False, dtypes=F32),
    Case("sort", args(N(3, 5))),
    Case("sort", args(N(3, 5)), kwargs=dict(axis=0, descending=True),
         label="desc"),
    Case("argsort", args(N(3, 5)), grad=False),
    Case("argsort", args(N(3, 5)), kwargs=dict(descending=True), grad=False,
         label="desc"),
    Case("slice", args(N(4, 5, 6), Raw([0, 2]), Raw([1, -4]),
                       Raw([3, 100]))),
    Case("strided_slice", args(N(6, 7), Raw([0, 1]), Raw([0, 6]),
                               Raw([6, 0]), Raw([2, -2]))),
    Case("crop", args(N(4, 5)), kwargs=dict(shape=[2, 3],
                                            offsets=[1, 2])),
    Case("moveaxis", args(N(2, 3, 4), 0, 2)),
    Case("swapaxes", args(N(2, 3, 4), 0, 2)),
    Case("as_complex", args(N(3, 2)), dtypes=F32),
    Case("as_real", args(N(3, 2)), post=lambda o, xp: o, dtypes=F32,
         label="real input"),
    Case("cast", args(N(3, 4), "float32"), label="to f32"),
    Case("cast", args(N(3, 4), "bfloat16"), label="to bf16"),
    Case("cast", args(U(-9, 9, 3, 4), "int64"), grad=False, label="to int"),
    Case("numel", args(N(3, 4)), grad=False),
    Case("shard_index", args(I(0, 20, 8, 1), 20, 4, 1), grad=False,
         dtypes=F32),
    Case("unfold", args(N(3, 8), 1, 3, 2)),
    Case("tensordot", args(N(3, 4, 5), N(4, 5, 2))),
    Case("tensordot", args(N(3, 4), N(4, 5)), kwargs=dict(axes=1),
         label="int"),
    Case("tensordot", args(N(3, 4, 5), N(5, 3, 2)), kwargs=dict(
        axes=[[0, 2], [1, 0]]), label="pairs"),
    Case("atleast_1d", args(lambda r: np.float32(r.standard_normal()))),
    Case("atleast_2d", args(N(3))),
    Case("atleast_3d", args(N(3, 4))),
    Case("atleast_3d", args(N(3)), label="1-D"),
    Case("view", args(N(2, 6), Raw([3, 4]))),
    Case("view", args(N(2, 6), "int32"), dtypes=F32, grad=False,
         label="dtype"),
    Case("view_as", args(N(2, 6), N(3, 4)), grad_args=(0,)),
    Case("pad_basic", args(N(2, 3, 4), Raw([1, 2, 0, 1]))),
    Case("pad_basic", args(N(2, 3), Raw([1, 1])), kwargs=dict(value=2.0),
         label="value"),
]
CASES = [c for c in CASES if c.label != "placeholder"]
CASES += [
    Case("index_put", args(N(4, 3), lambda r: [
        np.array([0, 2, 2], np.int32), np.array([1, 0, 1], np.int32)],
        N(3))),
    Case("index_put", args(N(4, 3), lambda r: [
        np.array([0, 2, 2], np.int32), np.array([1, 0, 0], np.int32)],
        N(3)), kwargs=dict(accumulate=True), label="accumulate"),
]


