"""Random ops: the counterpart of ``paddle2_tpu/ops/random.py``.

Every op draws from the port's generator for its device
(``framework.random.generator``), passed explicitly; ``seed`` reseeds
them. The values differ from the JAX package's (threefry keys); shapes,
dtypes, the distributions and determinism under ``seed`` are the
contract.
"""

from __future__ import annotations

import torch

from ..framework import core
from ..framework import random as fr
from .dispatch import ensure_tensor

__all__ = ["rand", "randn", "randint", "randint_like", "randperm", "uniform",
           "normal", "standard_normal", "poisson", "bernoulli", "multinomial",
           "uniform_", "normal_", "exponential_", "binomial", "standard_gamma",
           "log_normal", "cauchy_", "geometric_"]


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s.item()) if isinstance(s, torch.Tensor) else int(s)
                 for s in shape)


def _dt(dtype):
    d = core.convert_dtype(dtype)
    return d if d is not None else core.get_default_dtype()


def _gen(device):
    return fr.generator(device)


def rand(shape, dtype=None, name=None):
    dev = core.current_device()
    return torch.rand(_shape(shape), generator=_gen(dev), dtype=_dt(dtype),
                      device=dev)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = core.current_device()
    if seed:
        g = torch.Generator(device=dev)
        g.manual_seed(int(seed))
    else:
        g = _gen(dev)
    out = torch.empty(_shape(shape), dtype=_dt(dtype), device=dev)
    return out.uniform_(min, max, generator=g)


def randn(shape, dtype=None, name=None):
    dev = core.current_device()
    return torch.randn(_shape(shape), generator=_gen(dev), dtype=_dt(dtype),
                       device=dev)


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        ref = mean if isinstance(mean, torch.Tensor) else std
        shp = torch.broadcast_shapes(
            tuple(mean.shape) if isinstance(mean, torch.Tensor) else (),
            tuple(std.shape) if isinstance(std, torch.Tensor) else ())
        eps = torch.randn(shp, generator=_gen(ref.device),
                          dtype=core.get_default_dtype(), device=ref.device)
        return mean + std * eps
    dev = core.current_device()
    eps = torch.randn(_shape(shape if shape is not None else [1]),
                      generator=_gen(dev), dtype=core.get_default_dtype(),
                      device=dev)
    return mean + std * eps


def log_normal(mean=1.0, std=2.0, shape=None, name=None):
    return torch.exp(normal(mean, std, shape))


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = core.current_device()
    return torch.randint(low, high, _shape(shape), generator=_gen(dev),
                         dtype=core.convert_dtype(dtype), device=dev)


def randint_like(x, low=0, high=None, dtype=None, name=None):
    x = ensure_tensor(x)
    if high is None:
        low, high = 0, low
    dt = core.convert_dtype(dtype) or x.dtype
    out = torch.randint(low, high, tuple(x.shape), generator=_gen(x.device),
                        dtype=torch.int32, device=x.device)
    return out.to(dt)


def randperm(n, dtype="int64", name=None):
    dev = core.current_device()
    return torch.randperm(n, generator=_gen(dev), device=dev).to(
        core.convert_dtype(dtype))


def poisson(x, name=None):
    x = ensure_tensor(x)
    return torch.poisson(x, generator=_gen(x.device)).to(x.dtype)


def bernoulli(x, name=None):
    x = ensure_tensor(x)
    return torch.bernoulli(x, generator=_gen(x.device)).to(x.dtype)


def binomial(count, prob, name=None):
    count, prob = ensure_tensor(count), ensure_tensor(prob)
    prob = prob.float()
    out = torch.binomial(count.float().expand_as(prob), prob,
                         generator=_gen(prob.device))
    return out.to(torch.int32)


def standard_gamma(x, name=None):
    x = ensure_tensor(x)
    return torch._standard_gamma(x.float(), generator=_gen(x.device)).to(
        x.dtype)


def multinomial(x, num_samples=1, replacement=False, name=None):
    x = ensure_tensor(x)
    out = torch.multinomial(x.float(), num_samples, replacement,
                            generator=_gen(x.device))
    return out.to(torch.int32)


# in-place fills (no gradient, as the JAX package's payload swap)

def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    with torch.no_grad():
        return x.uniform_(min, max, generator=_gen(x.device))


def normal_(x, mean=0.0, std=1.0, name=None):
    with torch.no_grad():
        return x.normal_(mean, std, generator=_gen(x.device))


def exponential_(x, lam=1.0, name=None):
    with torch.no_grad():
        return x.exponential_(lam, generator=_gen(x.device))


def cauchy_(x, loc=0, scale=1, name=None):
    with torch.no_grad():
        return x.cauchy_(loc, scale, generator=_gen(x.device))


def geometric_(x, probs, name=None):
    with torch.no_grad():
        return x.geometric_(float(probs), generator=_gen(x.device))
