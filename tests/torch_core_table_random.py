"""The draws of ``test_torch_core_random.py``: JAX-free, so that
``chip_smoke.py`` runs them on the card. Each is ``(op, positional
arguments, keyword arguments)``; array arguments become tensors."""

import numpy as np

P = np.full((3, 4), 0.3, np.float32)
LAM = np.full((3, 4), 2.0, np.float32)
PROBS = np.array([[0.1, 0.2, 0.7], [0.5, 0.5, 0.0]], np.float32)

# (op, positional args for both packages, kwargs); array args become
# tensors
DRAWS = [
    ("rand", ([3, 4],), {}),
    ("rand", ([3, 4],), dict(dtype="bfloat16")),
    ("randn", ([2, 5],), {}),
    ("standard_normal", ([2, 5],), {}),
    ("uniform", ([3, 4],), dict(min=-2.0, max=3.0)),
    ("uniform", ([3, 4],), dict(dtype="bfloat16")),
    ("normal", (1.0, 2.0, [3, 4]), {}),
    ("normal", (np.zeros((2, 3), np.float32), 1.0), {}),
    ("log_normal", (0.0, 0.5, [3, 4]), {}),
    ("randint", (0, 7, [3, 4]), {}),
    ("randint", (5,), dict(shape=[6])),
    ("randint_like", (np.zeros((2, 3), np.float32), 0, 9), {}),
    ("randperm", (7,), {}),
    ("poisson", (LAM,), {}),
    ("bernoulli", (P,), {}),
    ("binomial", (np.full((3, 4), 10, np.int32), P), {}),
    ("standard_gamma", (LAM,), {}),
    ("multinomial", (PROBS, 2), {}),
    ("multinomial", (PROBS[:1], 5), dict(replacement=True)),
]
