"""A zoo model in both packages on the same weights, for the
``test_torch_vision_*.py`` files: the port's draw, loaded into the JAX
model, which is built from zeros (``jax.random`` patched while it is
built: its random draws compile at every new shape, which the
weights it then takes make moot)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np

import paddle2_tpu_torch as tp
from paddle2_tpu.vision import models as JM
from paddle2_tpu_torch.vision import models as TM


def _zeros(key, shape=(), dtype=jnp.float32, *args, **kwargs):
    return jnp.asarray(np.zeros(tuple(shape), np.float32)).astype(dtype)


@contextlib.contextmanager
def zero_draws():
    """``jax.random``'s uniform, normal and truncated normal draws give
    zeros while the block runs."""
    saved = jax.random.uniform, jax.random.normal, jax.random.truncated_normal
    jax.random.uniform = jax.random.normal = _zeros
    jax.random.truncated_normal = lambda key, a, b, shape=(), \
        dtype=jnp.float32: _zeros(key, shape, dtype)
    try:
        yield
    finally:
        (jax.random.uniform, jax.random.normal,
         jax.random.truncated_normal) = saved


def twins(name, seed=0, **kwargs):
    """The port's model drawn from ``seed`` and the JAX model with the
    port's weights (built from zeros, then ``set_state_dict``)."""
    tp.seed(seed)
    tm = getattr(TM, name)(**kwargs)
    with zero_draws():
        jm = getattr(JM, name)(**kwargs)
    state = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    missing, unexpected = jm.set_state_dict(state)
    assert not missing and not unexpected
    return jm, tm
