"""Chrome/Perfetto trace export: the event ring as ``trace.json``.

Maps the telemetry vocabulary onto the Chrome Trace Event format (the
JSON flavour Perfetto's legacy importer and ``chrome://tracing`` both
read): spans become complete duration events (``ph="X"``), instant
events become ``ph="i"``, and each distinct **track** label (shard,
tenant, deployment) becomes its own named thread via ``thread_name``
metadata events — so a fleet run renders as one lane per shard/tenant.

Counters are aggregate-only in this plane (no per-sample timeline), so
the exporter emits each one as a single terminal counter sample
(``ph="C"``) on its own track; the full totals live in the ``metrics``
block of the BENCH payload.

Timestamps: wall-clock spans are seconds and scale to microseconds;
under the deterministic ``ticks`` clock one tick maps to 1 µs, which
keeps golden traces byte-stable.  Stdlib-only, like the rest of
:mod:`repro_torch.obs`: the port's copy of ``repro/obs/trace.py``, the
same document for the same events.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..faults import atomic_write_json

from .core import Telemetry, get

_MAIN_TRACK = "main"


def _ts_scale(clock: str) -> float:
    return 1.0 if clock == "ticks" else 1e6


def chrome_trace(events: List[dict], clock: str = "wall",
                 counters: Optional[Dict[str, float]] = None,
                 process_name: str = "repro") -> dict:
    """Render ring events as a ``{"traceEvents": [...]}`` document."""
    scale = _ts_scale(clock)
    out: List[dict] = [{
        "ph": "M", "name": "process_name", "pid": 1, "tid": 0,
        "args": {"name": process_name},
    }]
    tids: Dict[str, int] = {}

    def tid_of(track: str) -> int:
        label = track or _MAIN_TRACK
        tid = tids.get(label)
        if tid is None:
            tid = tids[label] = len(tids) + 1
            out.append({"ph": "M", "name": "thread_name", "pid": 1,
                        "tid": tid, "args": {"name": label}})
        return tid

    last_ts = 0.0
    for ev in events:
        tid = tid_of(ev.get("track", ""))
        ts = float(ev.get("ts", 0.0)) * scale
        last_ts = max(last_ts, ts)
        tev = {"name": ev.get("name", ""), "cat": ev.get("kind", "event"),
               "pid": 1, "tid": tid, "ts": ts}
        if ev.get("kind") == "span":
            tev["ph"] = "X"
            tev["dur"] = max(float(ev.get("dur", 0.0)) * scale, 0.0)
        else:
            tev["ph"] = "i"
            tev["s"] = "t"
        args = dict(ev.get("attrs", {}))
        args["seq"] = ev.get("seq", 0)
        tev["args"] = args
        out.append(tev)
    for name in sorted(counters or {}):
        out.append({"ph": "C", "name": name, "pid": 1, "tid": 0,
                    "ts": last_ts, "args": {"value": counters[name]}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_trace(path: str, telemetry: Optional[Telemetry] = None) -> int:
    """Export the live (or given) telemetry ring to ``path`` atomically.

    Returns the number of ring events exported (0 when disabled)."""
    t = telemetry if telemetry is not None else get()
    if t is None:
        atomic_write_json(path, {"traceEvents": [], "displayTimeUnit": "ms"})
        return 0
    events = t.events_snapshot()
    snap = t.metrics_snapshot()
    atomic_write_json(path, chrome_trace(events, clock=t.clock,
                                         counters=snap["counters"]))
    return len(events)
