"""Typed serving errors.

Counterpart of the error half of ``paddle2_tpu/serving/reliability.py``:
only the types this slice raises. Admission control, load shedding,
SLOs, hot swap and the flight-recorder hooks wait for the serving queue
in ROADMAP.md.
"""

from __future__ import annotations

__all__ = ["ServingError", "RequestRejected", "PromptTooLongError",
           "EngineFailedError"]


class ServingError(RuntimeError):
    """Base of every typed serving failure."""


class RequestRejected(ServingError, ValueError):
    """The request was refused at submission. Also a ``ValueError``, as
    in the JAX package."""


class PromptTooLongError(RequestRejected):
    """``len(prompt) + max_new_tokens`` exceeds ``max_model_len``."""


class EngineFailedError(ServingError):
    """The engine died: it refuses all further work."""
