"""Global RNG state: the counterpart of ``paddle2_tpu/framework/random.py``.

The port draws from its own ``torch.Generator``s, one for the CPU and
one per CUDA device, and hands them explicitly to every random op
(``ops/random.py``); torch's default generators are left alone.
``seed(n)`` reseeds every generator of the port, and those made later
start from the same seed. JAX draws from threefry keys, so the values
differ from the JAX package's; what is kept is the contract: the same
seed gives the same draws, and ``set_rng_state(get_rng_state())``
replays them.
"""

from __future__ import annotations

import threading
from typing import Dict, Union

import torch

__all__ = ["seed", "get_rng_state", "set_rng_state", "generator"]

_lock = threading.Lock()
_seed = 0
_generators: Dict[str, torch.Generator] = {}


def _key(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    index = device.index
    return f"cuda:{torch.cuda.current_device() if index is None else index}"


def generator(device: Union[str, torch.device] = "cpu") -> torch.Generator:
    """The port's generator for ``device``, made on first use."""
    key = _key(torch.device(device))
    with _lock:
        g = _generators.get(key)
        if g is None:
            g = torch.Generator(device=key)
            g.manual_seed(_seed)
            _generators[key] = g
        return g


def seed(value: int) -> int:
    """Reseed every generator of the port (``paddle.seed``)."""
    global _seed
    with _lock:
        _seed = int(value)
        for g in _generators.values():
            g.manual_seed(_seed)
    return value


def get_rng_state() -> Dict[str, torch.Tensor]:
    """``{device: generator state}`` for every generator made so far."""
    with _lock:
        return {k: g.get_state() for k, g in _generators.items()}


def set_rng_state(state: Dict[str, torch.Tensor]) -> None:
    """Restore states that :func:`get_rng_state` returned."""
    for key, st in state.items():
        generator(key).set_state(st)
