"""Fault tolerance: the parts the serving plane calls.

Counterpart of part of ``paddle.distributed.fault_tolerance``:

* :mod:`.flight_recorder` — per-rank fixed-size event rings dumped with
  thread stacks to ``PADDLE_FLIGHT_DIR`` (the JAX module's schema and
  file names; either package's ``flight_doctor`` reads either's dumps);
* :mod:`.chaos` — the deterministic fault injector (``FLAGS_chaos``),
  its whole spec grammar, and the serving plane's hooks;
* :mod:`.health` — :class:`HealthReport` and :func:`node_id`.

Checkpoint integrity, preemption, in-job retry, the numerical and SDC
guards, buddy replication, the quarantine store and the probes wait for
ROADMAP queue 1 item 7.
"""

from . import chaos  # noqa: F401
from . import flight_recorder  # noqa: F401
from . import health  # noqa: F401
from .health import HealthReport, node_id

__all__ = ["chaos", "flight_recorder", "health", "HealthReport", "node_id"]
