"""The op cases of the ``test_torch_core_*.py`` files, free of JAX, so
that ``chip_smoke.py`` runs the same table on the card: ``Case``, the
input makers, the tolerances, and :func:`run_on_devices`, which holds an
op on a CUDA device against the same op on the CPU. The tables are the
``torch_core_table_*.py`` modules.

Tolerances are stated per dtype, as ``tests/op_test.py:19-26`` states
them: float32 ``rtol 1e-5, atol 1e-6``; bfloat16 ``rtol 1e-2, atol
1e-2``. A case may widen them where two implementations compute the op
by different algorithms; it says why beside the case.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "bfloat16": dict(rtol=1e-2, atol=1e-2)}
FLOAT_DTYPES = ("float32", "bfloat16")


@dataclass
class Raw:
    """An argument passed as it is to both packages."""
    value: Any


@dataclass
class Case:
    """One op case. ``make(rng)`` gives the positional arguments: numpy
    arrays become tensors (float ones in the case's dtype), lists of
    arrays lists of tensors, ``Raw`` values pass as they are. ``kwargs``
    may hold arrays too (made tensors, no gradient)."""
    op: str
    make: Callable[[np.random.Generator], Sequence[Any]]
    kwargs: Dict[str, Any] = field(default_factory=dict)
    dtypes: Tuple[str, ...] = FLOAT_DTYPES
    grad: bool = True
    grad_args: Optional[Tuple[int, ...]] = None
    post: Optional[Callable] = None     # post(out, xp) -> what to compare
    # a tolerance by output dtype name, where TOL's does not hold
    tol: Dict[str, Dict[str, float]] = field(default_factory=dict)
    label: str = ""
    shape_only: bool = False

    @property
    def id(self):
        return self.op + (f"[{self.label}]" if self.label else "")


def seed_of(case: Case) -> int:
    return zlib.crc32(case.id.encode())


def seed_of(case: Case) -> int:
    return zlib.crc32(case.id.encode())


def _is_float_np(a) -> bool:
    return isinstance(a, np.ndarray) and a.dtype.kind == "f"


def flat(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in flat(o)]
    return [out]


def dtype_name(t) -> str:
    if isinstance(t, torch.Tensor):
        return str(t.dtype).rpartition(".")[2]
    return np.dtype(t.dtype).name


def as_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t._is_zerotensor():      # a gradient torch knows is zero
            t = torch.zeros(t.shape, dtype=t.dtype)
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    a = np.asarray(t.numpy())
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def is_tensor(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype") and \
        not isinstance(x, (np.ndarray, np.generic))


def assert_same(got, want, tol, what=""):
    """``got`` (the port's) against ``want`` (the JAX package's): the
    same structure, dtypes and values."""
    g, w = flat(got), flat(want)
    assert len(g) == len(w), f"{what}: {len(g)} outputs, want {len(w)}"
    for i, (a, b) in enumerate(zip(g, w)):
        if not is_tensor(b):
            assert not is_tensor(a), f"{what}[{i}]: a tensor, want {b!r}"
            assert a == b or (isinstance(b, float) and np.isclose(a, b)), \
                f"{what}[{i}]: {a!r} != {b!r}"
            continue
        assert is_tensor(a), f"{what}[{i}]: {a!r} is not a tensor"
        assert dtype_name(a) == dtype_name(b), \
            f"{what}[{i}]: dtype {dtype_name(a)}, want {dtype_name(b)}"
        assert tuple(a.shape) == tuple(b.shape), \
            f"{what}[{i}]: shape {tuple(a.shape)}, want {tuple(b.shape)}"
        na, nb = as_np(a), as_np(b)
        if na.dtype.kind in "fc":
            t = tol.get(dtype_name(b), TOL["float32"])
            np.testing.assert_allclose(na, nb, equal_nan=True,
                                       err_msg=f"{what}[{i}]", **t)
        else:
            np.testing.assert_array_equal(na, nb, err_msg=f"{what}[{i}]")


# ------------------------------------------------------------ inputs

def U(lo=-1.0, hi=1.0, *shape):
    """An input maker: uniform float32 in [lo, hi)."""
    def make(rng):
        return rng.uniform(lo, hi, size=shape).astype(np.float32)
    return make


def N(*shape):
    return lambda rng: rng.standard_normal(shape).astype(np.float32)


def I(lo, hi, *shape):
    return lambda rng: rng.integers(lo, hi, size=shape).astype(np.int32)


def Bo(*shape):
    return lambda rng: rng.random(shape) < 0.5


def args(*makers):
    """``make`` for a case: each maker called in turn (a non-callable
    passes as it is)."""
    def make(rng):
        return [m(rng) if callable(m) else m for m in makers]
    return make


def lst(*makers):
    """A list argument of arrays."""
    def make(rng):
        return [m(rng) for m in makers]
    return make


# ----------------------------------------------------- one device vs another

def _torch_args(paddle, args, dtype, device, grad_ids):
    """``args`` as tensors on ``device`` (float arrays in ``dtype``, the
    rest under the x32 rules of ``paddle.to_tensor``), and the leaves
    that take gradients."""
    leaves, out = [], []

    def make(a, rg):
        if _is_float_np(a):
            t = torch.from_numpy(a.astype(np.float32)).to(device)
            if dtype == "bfloat16":
                t = t.to(torch.bfloat16)
            if rg:
                leaves.append(t.requires_grad_())
            return t
        if isinstance(a, (np.ndarray, np.generic)):
            return paddle.to_tensor(a, place=device)
        return a
    for i, a in enumerate(args):
        if isinstance(a, Raw):
            out.append(a.value)
        elif isinstance(a, list):
            out.append([make(a2, i in grad_ids) for a2 in a])
        else:
            out.append(make(a, i in grad_ids))
    return out, leaves


def resolve(pkg, op: str):
    """``pkg``'s op by its dotted path (``"nn.functional.relu"``)."""
    for part in op.split("."):
        pkg = getattr(pkg, part)
    return pkg


def _on(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, (tuple, list)):
        return type(x)(_on(o, device) for o in x)
    return x


def run_on_devices(case: Case, dtype: str, paddle, device) -> float:
    """``paddle.<op>`` on ``device`` against the same op on the CPU, on
    the same inputs: the same outputs (dtypes, shapes, values at the
    case's tolerance) and, for a differentiable op, the same gradients.
    ``paddle`` is ``paddle2_tpu_torch``; its current place is set to each
    device in turn (creation ops land there). Returns the largest
    absolute difference seen. Raises on a mismatch."""
    rng = np.random.default_rng(seed_of(case))
    args = list(case.make(rng))
    grad_ids = set(case.grad_args if case.grad_args is not None
                   else range(len(args))) if case.grad else set()
    tol = {**TOL, **case.tol}
    runs = []
    for dev in ("cpu", device):
        paddle.set_device("cpu" if dev == "cpu" else "gpu:%d" % (
            torch.device(dev).index or 0))
        a, leaves = _torch_args(paddle, args, dtype, dev, grad_ids)
        kw = {k: _torch_args(paddle, [v], dtype, dev, set())[0][0]
              for k, v in case.kwargs.items()}
        out = resolve(paddle, case.op)(*a, **kw)
        if case.post is not None:
            out = case.post(out, paddle)
        grads = None
        diff = [o for o in flat(out) if isinstance(o, torch.Tensor)
                and o.requires_grad]
        if case.grad and leaves and diff:
            crng = np.random.default_rng(seed_of(case) + 1)
            cots = [torch.from_numpy(crng.standard_normal(
                tuple(o.shape)).astype(np.float32)).to(dev, o.dtype)
                for o in diff]
            grads = paddle.grad(diff, leaves, grad_outputs=cots,
                                allow_unused=True)
        runs.append((out, grads))
    (cpu_out, cpu_g), (dev_out, dev_g) = runs
    for o in flat(dev_out):
        if isinstance(o, torch.Tensor):
            assert o.device.type == torch.device(device).type, \
                f"{case.id}: an output on {o.device}"
    got, want = _on(dev_out, "cpu"), cpu_out
    if case.shape_only:
        return 0.0
    assert_same(got, want, tol, case.id)
    err = 0.0
    for a, b in zip(flat(got), flat(want)):
        if isinstance(a, torch.Tensor) and a.is_floating_point() and \
                a.numel():
            diff = (a.detach().float() - b.detach().float()).abs()
            err = max(err, float(diff.nan_to_num(0.0).max()))
    if cpu_g is not None:
        assert dev_g is not None and len(dev_g) == len(cpu_g)
        for i, (a, b) in enumerate(zip(_on(dev_g, "cpu"), cpu_g)):
            if a is None or b is None:
                assert a is None and b is None, f"{case.id} grad {i}"
                continue
            assert_same(a, b, tol, f"{case.id} grad {i}")
    return err


def run_layer_on_devices(entry, dtype: str, paddle, device) -> float:
    """A layer table entry (``torch_nn_table_layers.L``) on ``device``
    against the same layer on the CPU: the layer built on each device
    from the same arguments with the CPU twin's state, the same inputs
    (float ones in ``dtype``, lists as tuples), and the same outputs,
    buffers and gradients of every float input and trainable parameter
    (at ``TOL`` or the entry's tolerance). Returns the largest absolute
    difference of the outputs."""
    rng = np.random.default_rng(zlib.crc32(entry.id.encode()))
    arrays = [m(rng) for m in entry.inputs]
    grad_ids = set(range(len(arrays)) if entry.grad_inputs is None
                   else entry.grad_inputs)
    tol = {**TOL, **entry.tol}
    runs, state = [], None
    for dev in ("cpu", device):
        paddle.set_device("cpu" if dev == "cpu" else "gpu:%d" % (
            torch.device(dev).index or 0))
        kw = {k: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray)
              else v for k, v in entry.kwargs.items()}
        layer = getattr(paddle.nn, entry.name)(*entry.args, **kw)
        if state is None:
            state = {k: v.detach().clone() for k, v in
                     layer.state_dict().items()}
        else:
            layer.set_state_dict(state)
        if dtype != "float32":
            layer.to(dtype=dtype)
        if not entry.train:
            layer.eval()
        leaves = []

        def make(a, rg):
            t = torch.from_numpy(a).to(dev)
            if a.dtype.kind != "f":
                return t
            t = t.to(getattr(torch, dtype)).requires_grad_(rg)
            if rg:
                leaves.append(t)
            return t
        ins = [tuple(make(x, i in grad_ids) for x in a)
               if isinstance(a, list) else make(a, i in grad_ids)
               for i, a in enumerate(arrays)]
        out = layer(*ins)
        params = [p for p in layer.parameters() if p.requires_grad]
        diff = [o for o in flat(out) if isinstance(o, torch.Tensor)
                and o.requires_grad]
        grads = None
        if diff:
            crng = np.random.default_rng(1)
            cots = [torch.from_numpy(crng.standard_normal(
                tuple(o.shape)).astype(np.float32)).to(dev, o.dtype)
                for o in diff]
            grads = torch.autograd.grad(diff, leaves + params, cots,
                                        allow_unused=True)
        runs.append((out, dict(layer.named_buffers()), grads))
    (cpu_out, cpu_buf, cpu_g), (dev_out, dev_buf, dev_g) = runs
    for o in flat(dev_out):
        if isinstance(o, torch.Tensor):
            assert o.device.type == torch.device(device).type, \
                f"{entry.id}: an output on {o.device}"
    got = _on(dev_out, "cpu")
    assert_same(got, cpu_out, tol, entry.id)
    for name, b in cpu_buf.items():
        assert_same(dev_buf[name].cpu(), b, tol, f"{entry.id} buffer {name}")
    if cpu_g is not None:
        for i, (a, b) in enumerate(zip(_on(dev_g, "cpu"), cpu_g)):
            if a is None or b is None:
                assert a is None and b is None, f"{entry.id} grad {i}"
                continue
            assert_same(a, b, tol, f"{entry.id} grad {i}")
    err = 0.0
    for a, b in zip(flat(got), flat(cpu_out)):
        if isinstance(a, torch.Tensor) and a.is_floating_point() and \
                a.numel():
            d = (a.detach().float() - b.detach().float()).abs()
            err = max(err, float(d.nan_to_num(0.0).max()))
    return err
