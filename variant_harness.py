"""What the kernel-variant scripts share (``wo_wgmma_variants.py``,
``norm_fwd_variants.py``, ``flash_bwd_tf32x3_variants.py``,
``flash_fwd_tf32x3_variants.py``): copy a
kernel source once a variant with textual edits, build the copies with
nvcc (sm_90a) in parallel, load their C entries through ctypes, and time
them by CUDA events, in turns. Each script keeps only its edit table,
its inputs, its checks and its probes.

Needs a machine with a CUDA GPU and nvcc; imports nothing of the port,
and ``torch`` only inside :func:`event_ms`.
"""

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "paddle2_tpu_torch" / "kernels" / "csrc"
NVCC = "/usr/local/cuda/bin/nvcc"


def nvidia_smi():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()


def edited(text, edits, name):
    """``text`` with each ``(old, new)`` of ``edits`` replaced; exits
    naming the variant where the source no longer holds an ``old``."""
    for old, new in edits:
        if old not in text:
            sys.exit(f"variant {name}: the source no longer holds "
                     f"{old.strip()[:60]!r}")
        text = text.replace(old, new)
    return text


def build(out, sources, flags=("-std=c++17",)):
    """Writes ``sources`` ({variant: CUDA text}) to ``out/<variant>.cu``
    and builds each into ``out/<variant>.so``, all nvcc processes started
    together (includes from the port's ``csrc``, ptxas verbose). Returns
    {variant: nvcc's log}; exits on the first build that fails."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = out / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", *flags, "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC), "-Xptxas",
             "-v", "-o", str(out / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for name, proc in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"variant {name} did not build:\n{logs[name]}")
    return logs


def ptxas_lines(log, keep=lambda kernel: True):
    """ptxas's register and spill lines of a build log, by mangled kernel
    name, for the kernels ``keep`` accepts."""
    out, kernel = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif kernel and keep(kernel) and ("registers" in line
                                          or "spill" in line):
            out.setdefault(kernel, []).append(line.strip())
    return out


def load(path, entries):
    """The C entries of the library at ``path``: {name: argtypes} to
    {name: function} (each returns an int, 0 or a CUDA error)."""
    lib = ctypes.CDLL(str(path))
    fns = {}
    for name, argtypes in entries.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def event_ms(fn, iters=30, inner=10, warmup=3):
    """ms a call of ``fn``: CUDA events around ``inner`` calls, the
    median of ``iters``, after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def in_turns(names, measure):
    """{name: [measure(name), ...]} taken in turns: the names in order,
    then backwards, so a drift of the card's clock falls on every name
    alike."""
    times = {n: [] for n in names}
    for n in list(names) + list(names)[::-1]:
        times[n].append(measure(n))
    return times
