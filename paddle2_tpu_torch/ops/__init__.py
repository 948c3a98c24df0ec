"""The op library: the counterpart of ``paddle2_tpu/ops/__init__.py``.

Every op of ``creation``, ``math``, ``manipulation``, ``linalg``,
``logic``, ``random``, ``extra`` and ``misc`` is re-exported here (and
from there at the package's top level), casts under
``paddle.amp.auto_cast`` as :mod:`.dispatch` says, and each one that the JAX
package installs as a tensor method becomes a ``torch.Tensor`` method
where torch lacks the name (``x.concat``, ``x.scale_``, ``x.mean_all``
...); a name torch has keeps torch's meaning. Indexing and the
operators are torch's own.
"""

from __future__ import annotations

import torch

from . import creation, extra, linalg, logic, manipulation, math, misc, random
from .dispatch import cast_op_library, ensure_tensor
from ..framework import random as _fr
from ..framework.tensor import install_methods

cast_op_library((creation, math, manipulation, linalg, logic, random, extra,
                 misc))

from .math import *          # noqa: F401,F403
from .creation import *      # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .linalg import *        # noqa: F401,F403
from .logic import *         # noqa: F401,F403
from .random import *        # noqa: F401,F403
from .extra import *         # noqa: F401,F403
from .misc import *          # noqa: F401,F403


def bernoulli_(x, p=0.5, name=None):
    """In-place Bernoulli fill."""
    with torch.no_grad():
        return x.bernoulli_(p, generator=_fr.generator(x.device))


def log_normal_(x, mean=1.0, std=2.0, name=None):
    """In-place log-normal fill."""
    with torch.no_grad():
        return x.log_normal_(mean, std, generator=_fr.generator(x.device))


def where_(condition, x, y, name=None):
    """In-place where: the selected values written into ``x`` (the
    condition is a read-only mask)."""
    return x.copy_(manipulation.where(condition, x, y))


def _methods():
    names = {}
    for nm in ("rank", "is_complex", "is_integer", "is_floating_point",
               "reduce_as", "as_strided", "diagonal_scatter"):
        names[nm] = getattr(misc, nm)
    skip = {"to_tensor", "as_tensor", "pow"}
    for mod in (math, creation, manipulation, linalg, logic, random, extra):
        for nm in mod.__all__:
            fn = getattr(mod, nm)
            if nm not in skip and nm not in names and callable(fn):
                names[nm] = fn
    names["scale_"] = lambda s, *a, **k: s.copy_(math.scale(s, *a, **k))
    names["mean_all"] = lambda s: math.mean(s)
    names["bernoulli_"] = bernoulli_
    names["log_normal_"] = log_normal_
    names["where_"] = lambda self, condition, y, name=None: where_(
        condition, self, y)
    return names


install_methods(_methods())

# the names ``from .ops import *`` gives the package: the ops, not the
# modules that hold them
__all__ = sorted({n for mod in (creation, math, manipulation, linalg, logic,
                                random, extra, misc) for n in mod.__all__}
                 | {"bernoulli_", "log_normal_", "where_"})
