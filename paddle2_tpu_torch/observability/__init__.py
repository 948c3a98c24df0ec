"""paddle2_tpu_torch.observability: the counterpart of
``paddle2_tpu.observability``, with its ``__all__``.

Three coordinated planes over one process:

* :mod:`.metrics` — the always-on Counter/Gauge/Histogram registry with
  a per-rank JSONL stream (``PADDLE_METRICS_DIR/metrics_rank_N.jsonl``,
  the JAX package's schema and file names) and a Prometheus textfile
  export; step windows split a step into input / compute / collective /
  host, summing exactly to the step's total;
* :mod:`.cost_model` — deterministic step-cost accounting (FLOPs from
  ``torch.utils.flop_counter``, collective wire traffic under an
  NVLink-vs-InfiniBand link model, MFU, roofline) against the card's
  figures;
* :mod:`.tracing` — per-request lifecycle span trees for serving
  (``PADDLE_TRACE_DIR/trace_rank_N.jsonl``, chrome-trace export) with
  an exact tail-latency decomposition, which ``tools/serve_doctor``
  reads.

``tools/perf_doctor`` joins the metrics stream with flight rings and
merged chrome traces into a triage report, and diffs two streams.

The metrics and tracing hooks cost one module-attribute load per site
when their plane is off.
"""

from . import cost_model, metrics, tracing  # noqa: F401
from .cost_model import (CollectiveTraffic, LinkModel, StepCost,  # noqa: F401
                         chip_peak, program_cost, wire_bytes)
from .metrics import (Counter, Gauge, Histogram, MetricsPlane,  # noqa: F401
                      METRICS_DIR_ENV)
from .tracing import TracePlane, TRACE_DIR_ENV  # noqa: F401

__all__ = ["metrics", "cost_model", "tracing", "Counter", "Gauge",
           "Histogram", "MetricsPlane", "METRICS_DIR_ENV", "TracePlane",
           "TRACE_DIR_ENV", "CollectiveTraffic", "LinkModel", "StepCost",
           "chip_peak", "program_cost", "wire_bytes"]
