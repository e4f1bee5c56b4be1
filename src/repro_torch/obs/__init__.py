"""Structured telemetry: spans, counters, the event ring and its trace
export (stdlib only).

The port's copy of the JAX package's ``obs``; the engine's spans and
counters keep their names (the ``kernel.dispatch.*`` counters name the
device where the reference names its mode).  Off by default;
``obs.configure()`` flips the process-global switch.

The calibration pass (:mod:`repro_torch.obs.calibrate`) is deliberately
NOT re-exported here: it needs numpy and the cost model, and keeping it a
leaf submodule keeps ``import repro_torch.obs`` free of both torch and
numpy.
"""

from .core import (NULL_SPAN, Span, Telemetry, VALID_CLOCKS, clear,
                   configure, count, disable, enabled, event,
                   events_snapshot, gauge, get, metrics_snapshot, scoped,
                   span, track)
from .trace import chrome_trace, write_trace

__all__ = [
    "NULL_SPAN", "Span", "Telemetry", "VALID_CLOCKS",
    "chrome_trace", "clear", "configure", "count", "disable", "enabled",
    "event", "events_snapshot", "gauge", "get", "metrics_snapshot",
    "scoped", "span", "track", "write_trace",
]
