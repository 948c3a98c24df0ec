"""Offline operator tooling (``python -m paddle2_tpu_torch.tools.<tool>``):
the port's own copies of ``paddle2_tpu/tools``' ``perf_doctor``,
``serve_doctor`` and ``flight_doctor``.

Kept import-light: these run on a dead job's artifacts (metrics streams,
request traces, flight-recorder dumps), often on a machine with no
accelerator. They import the standard library only (``serve_doctor``
also the port's stdlib-only ``observability.tracing``).
"""
