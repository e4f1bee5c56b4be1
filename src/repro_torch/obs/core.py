"""The telemetry core: spans, counters/gauges, and the event ring.

The port's own copy of the JAX package's ``obs/core.py`` (stdlib only, the
same span and counter names), so ``repro_torch`` imports nothing of
``repro``.

One process-global switch (:func:`configure` / :func:`disable`):
telemetry is a pure execution choice, never an engine-config field, so
configs stay hashable and JSON-round-trippable.  **Off by default** — every
instrumentation point in the engine boils down to one module-global
``is None`` check when disabled, and the enabled path only appends plain
dicts to a bounded ring, so engine results are bit-identical either way.

Vocabulary (see ``docs/observability.md`` for the span/event taxonomy):

* **span** — a named duration with attached attributes (op counts,
  ``IOStats`` deltas): ``with obs.span("engine.flush", entries=n) as sp:
  ...; sp.set(pages=k)``.  Spans nest; each event records its ``sid`` and
  enclosing ``parent`` sid, per thread.
* **counter / gauge** — monotonically accumulated named totals
  (``obs.count("engine.flush")``) and last-value-wins observations
  (``obs.gauge(...)``).  Aggregate-only: they live in the metrics
  snapshot, not the ring, so the hottest seams cost one dict op.
* **event** — an instant ring entry (``obs.event("drift.decide",
  reason=..., kl=...)``) for decisions worth trace-diffing.
* **track** — a thread-local label (``with obs.track("w0/klsm")``)
  inherited by every span/event inside it; the Perfetto export maps one
  track per shard/tenant/deployment.

Determinism: with ``clock="ticks"`` timestamps are a process-global
monotonic counter instead of wall time, so a seeded run emits a
bit-reproducible event stream (the golden schema tests pin this).  The
ring is bounded (``capacity``); overflow drops the oldest events and
counts them in ``events_dropped``.  An optional JSONL sink streams every
event to disk as it is emitted.

Set ``REPRO_OBS=1`` to auto-enable at import.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

VALID_CLOCKS = ("wall", "ticks")

DEFAULT_CAPACITY = 65536


class Span:
    """One open span; emitted to the ring when the ``with`` block exits."""

    __slots__ = ("_t", "name", "attrs", "sid", "parent", "_t0")

    def __init__(self, telemetry: "Telemetry", name: str, attrs: dict):
        self._t = telemetry
        self.name = name
        self.attrs = attrs
        self.sid = 0
        self.parent = 0
        self._t0 = 0.0

    def set(self, **attrs) -> "Span":
        """Attach/overwrite attributes (op counts, IOStats deltas) before
        the span closes."""
        self.attrs.update(attrs)
        return self

    def __bool__(self) -> bool:
        return True

    def __enter__(self) -> "Span":
        t = self._t
        self.sid = t.new_sid()
        stack = t.span_stack()
        self.parent = stack[-1].sid if stack else 0
        stack.append(self)
        self._t0 = t.now()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t = self._t
        stack = t.span_stack()
        if stack and stack[-1] is self:
            stack.pop()
        t.emit("span", self.name, self._t0, t.now() - self._t0, self.attrs,
               sid=self.sid, parent=self.parent)


class _NullSpan:
    """The disabled path: a shared no-op context manager."""

    __slots__ = ()

    def set(self, **attrs) -> "_NullSpan":
        return self

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


NULL_SPAN = _NullSpan()


class Telemetry:
    """The process-global telemetry state: ring + counters + sink."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 clock: str = "wall", jsonl_path: str = ""):
        if clock not in VALID_CLOCKS:
            raise ValueError(f"unknown clock {clock!r}; one of "
                             f"{VALID_CLOCKS}")
        self.capacity = int(capacity)
        self.clock = clock
        self.jsonl_path = str(jsonl_path or "")
        self.events: deque = deque(maxlen=self.capacity)
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, Any] = {}
        self.seq = 0                     # events ever emitted (ring + dropped)
        self._sids = 0
        self._ticks = 0
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._sink = open(self.jsonl_path, "w") if self.jsonl_path else None

    # -- clocks / ids ------------------------------------------------------

    def now(self) -> float:
        """Seconds since configure (wall) or a deterministic tick count."""
        if self.clock == "ticks":
            with self._lock:
                self._ticks += 1
                return float(self._ticks)
        return time.perf_counter() - self._t0

    def new_sid(self) -> int:
        with self._lock:
            self._sids += 1
            return self._sids

    # -- thread-local span/track state -------------------------------------

    def span_stack(self) -> List[Span]:
        stack = getattr(self._tls, "spans", None)
        if stack is None:
            stack = self._tls.spans = []
        return stack

    def track_stack(self) -> List[str]:
        stack = getattr(self._tls, "tracks", None)
        if stack is None:
            stack = self._tls.tracks = []
        return stack

    def current_track(self) -> str:
        stack = getattr(self._tls, "tracks", None)
        return stack[-1] if stack else ""

    # -- emission ----------------------------------------------------------

    def emit(self, kind: str, name: str, ts: float, dur: float,
             attrs: Optional[dict], sid: int = 0, parent: int = 0) -> dict:
        ev = {"seq": 0, "kind": kind, "name": name,
              "ts": round(float(ts), 9), "track": self.current_track()}
        if kind == "span":
            ev["dur"] = round(float(dur), 9)
            ev["sid"] = sid
            ev["parent"] = parent
        if attrs:
            ev["attrs"] = attrs
        with self._lock:
            self.seq += 1
            ev["seq"] = self.seq
            self.events.append(ev)       # maxlen drops the oldest silently
            sink = self._sink
        if sink is not None:
            try:
                sink.write(json.dumps(ev, default=_json_default) + "\n")
            except (ValueError, OSError):
                pass                     # a closed/full sink never raises
        return ev

    def count(self, name: str, n: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value) -> None:
        with self._lock:
            self.gauges[name] = value

    # -- snapshots ---------------------------------------------------------

    @property
    def dropped(self) -> int:
        return max(0, self.seq - len(self.events))

    def events_snapshot(self) -> List[dict]:
        with self._lock:
            return list(self.events)

    def metrics_snapshot(self) -> Dict[str, Any]:
        """The ``metrics`` block merged into the Report/BENCH schema."""
        with self._lock:
            return {
                "counters": {k: self.counters[k]
                             for k in sorted(self.counters)},
                "gauges": {k: _json_default_pass(self.gauges[k])
                           for k in sorted(self.gauges)},
                "events_total": self.seq,
                "events_dropped": self.dropped,
                "clock": self.clock,
            }

    def clear(self) -> None:
        """Reset ring/counters/clock state; the configuration stays."""
        with self._lock:
            self.events.clear()
            self.counters.clear()
            self.gauges.clear()
            self.seq = 0
            self._sids = 0
            self._ticks = 0
            self._t0 = time.perf_counter()

    def dump_jsonl(self, path: str) -> int:
        """Write the current ring as JSON lines; returns the event count."""
        events = self.events_snapshot()
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            for ev in events:
                f.write(json.dumps(ev, default=_json_default) + "\n")
        os.replace(tmp, path)
        return len(events)

    def close(self) -> None:
        sink, self._sink = self._sink, None
        if sink is not None:
            try:
                sink.close()
            except OSError:
                pass


def _json_default(x):
    """Sink serialization for numpy scalars/arrays without importing
    numpy: anything with ``.item()`` or ``.tolist()`` lowers itself."""
    if hasattr(x, "tolist"):
        return x.tolist()
    if hasattr(x, "item"):
        return x.item()
    return str(x)


def _json_default_pass(x):
    if isinstance(x, (dict, list, tuple, str, int, float, bool)) or x is None:
        return x
    return _json_default(x)


# ---------------------------------------------------------------------------
# The process-global switch (the lsm/read_path.py mode pattern)
# ---------------------------------------------------------------------------

_T: Optional[Telemetry] = None


def configure(enabled: bool = True, capacity: int = DEFAULT_CAPACITY,
              clock: str = "wall", jsonl_path: str = ""
              ) -> Optional[Telemetry]:
    """Install (or tear down) the process-global telemetry plane.

    Returns the live :class:`Telemetry` (or None when ``enabled=False``).
    Reconfiguring closes the previous sink and starts a fresh ring."""
    global _T
    if _T is not None:
        _T.close()
    _T = Telemetry(capacity=capacity, clock=clock,
                   jsonl_path=jsonl_path) if enabled else None
    return _T


def disable() -> None:
    configure(enabled=False)


def enabled() -> bool:
    return _T is not None


def get() -> Optional[Telemetry]:
    return _T


@contextmanager
def scoped(enabled: bool = True, **kw):
    """Scoped :func:`configure` (tests / benchmarks): restores the previous
    telemetry object — including its ring — on exit."""
    global _T
    prev = _T
    _T = Telemetry(**kw) if enabled else None
    try:
        yield _T
    finally:
        if _T is not None:
            _T.close()
        _T = prev


# -- the instrumentation surface (all no-ops when disabled) -----------------

def span(name: str, **attrs):
    t = _T
    if t is None:
        return NULL_SPAN
    return Span(t, name, attrs)


def count(name: str, n: float = 1) -> None:
    t = _T
    if t is not None:
        t.count(name, n)


def gauge(name: str, value) -> None:
    t = _T
    if t is not None:
        t.gauge(name, value)


def event(name: str, **attrs) -> None:
    t = _T
    if t is not None:
        ts = t.now()
        t.emit("event", name, ts, 0.0, attrs)


@contextmanager
def track(label):
    """Scoped track label (one Perfetto track per shard/tenant).  A falsy
    label — or disabled telemetry — is a pure pass-through."""
    t = _T
    if t is None or not label:
        yield
        return
    stack = t.track_stack()
    stack.append(str(label))
    try:
        yield
    finally:
        stack.pop()


def metrics_snapshot() -> Dict[str, Any]:
    t = _T
    return t.metrics_snapshot() if t is not None else {}


def events_snapshot() -> List[dict]:
    t = _T
    return t.events_snapshot() if t is not None else []


def clear() -> None:
    t = _T
    if t is not None:
        t.clear()


# CI's obs leg: REPRO_OBS=1 runs the whole tier-1 suite with telemetry
# live, so instrumentation drift (an event that perturbs engine results,
# an attribute that stops serializing) fails tests instead of landing.
if os.environ.get("REPRO_OBS") == "1":     # pragma: no cover - env-driven
    configure(enabled=True)
