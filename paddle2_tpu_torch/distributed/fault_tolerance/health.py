"""Probe reports and node identity.

The counterpart of part of ``paddle2_tpu/distributed/fault_tolerance/
health.py``: :class:`HealthReport`, the outcome of one probe, and
:func:`node_id`, this process's quarantine identity. The failover
router's health sweep (``serving.simulate.EngineFailoverRouter.probe``)
yields one report per engine. The quarantine store, the device self-test,
the loopback echo, the launcher preflight and the periodic prober wait
for ROADMAP queue 1 item 7.
"""

from __future__ import annotations

import os
import socket
from typing import Any, Dict, Optional

__all__ = ["HealthReport", "node_id", "NODE_ID_ENV"]

# launcher-stamped node identity (hostname[/sN]); workers inherit it
NODE_ID_ENV = "PADDLE_NODE_ID"


def node_id() -> str:
    """This process's quarantine identity: the launcher-stamped
    ``PADDLE_NODE_ID`` when present, else the hostname."""
    return os.environ.get(NODE_ID_ENV) or socket.gethostname()


class HealthReport:
    """Outcome of one probe: ``ok``, the result ``digest``, and a
    human-readable ``reason`` when not ok."""

    def __init__(self, ok: bool, digest: Optional[int] = None,
                 reason: str = "", device: str = "",
                 probe: str = "selftest"):
        self.ok = bool(ok)
        self.digest = digest
        self.reason = reason
        self.device = device
        self.probe = probe

    def as_dict(self) -> Dict[str, Any]:
        return {"ok": self.ok, "digest": self.digest,
                "reason": self.reason, "device": self.device,
                "probe": self.probe}

    def __repr__(self):
        return (f"HealthReport(ok={self.ok}, probe={self.probe!r}, "
                f"digest={self.digest}, reason={self.reason!r})")
