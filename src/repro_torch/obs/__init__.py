"""Structured telemetry: spans, counters and the event ring (stdlib only).

The port's copy of the JAX package's ``obs`` core; the engine's spans and
counters keep their names.  Trace export and calibration are not ported
yet.
"""

from .core import (NULL_SPAN, Span, Telemetry, VALID_CLOCKS, clear,
                   configure, count, disable, enabled, event,
                   events_snapshot, gauge, get, metrics_snapshot, scoped,
                   span, track)

__all__ = [
    "NULL_SPAN", "Span", "Telemetry", "VALID_CLOCKS", "clear", "configure",
    "count", "disable", "enabled", "event", "events_snapshot", "gauge", "get",
    "metrics_snapshot", "scoped", "span", "track",
]
