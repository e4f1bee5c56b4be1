"""The trace-shaped scenario library (the port of
``repro/scenarios/library.py``, numpy float64 as there).

Four stress patterns the synthetic gradual/flip/cyclic drifts never
reach, each chosen so the executed workload tilts toward *expensive*
query classes (the direction the KL worst case points and the robust
hedge anticipates — see the "direction matters" finding in
``docs/online.md``):

* :class:`ZipfMigrateScenario` — heavy-tailed key skew whose hot set
  migrates every segment (caching/Bloom locality keeps breaking);
* :class:`BurstStormScenario` — flash crowds: periodic segments arrive at
  ``amplitude`` x the baseline volume under a different (read-heavy) mix;
* :class:`TombstoneChurnScenario` — queue-like insert/delete churn: a
  write-dominant mix where a fraction of writes delete the oldest live
  keys (the Sarkar et al. taxonomy's tombstone workload);
* :class:`ScanHeavyScenario` — analytics arriving: the mix ramps toward
  range scans and the scans themselves widen.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .base import Scenario


class ZipfMigrateScenario(Scenario):
    """Zipf(a) key skew on non-empty reads with a per-segment hot-set
    migration: segment s rotates the rank->key mapping by
    ``migrate * s * n_existing`` positions, so yesterday's hot keys are
    cold today.  The mix ramps from the expected toward a non-empty-read-
    dominant target (skew only matters on reads that hit)."""

    kind = "zipf_migrate"
    PARAMS = {"zipf_a": 1.35, "migrate": 0.25}

    def schedule(self, expected) -> np.ndarray:
        S = int(self.drift.segments)
        t = np.arange(S, dtype=np.float64) / max(S - 1, 1)
        return self.ramp(expected, self.target_mix((0.10, 0.70, 0.10, 0.10)),
                         t)

    def session_kwargs(self, segment: int, n_existing: int) -> Dict[str, Any]:
        shift = int(float(self.params["migrate"]) * segment
                    * max(n_existing, 1))
        return {"zipf_a": float(self.params["zipf_a"]),
                "hot_offset": shift}


class BurstStormScenario(Scenario):
    """Flash crowds: every ``period``-th segment is a burst arriving at
    ``amplitude`` x the baseline volume (up to 1000x) under the target mix
    (default read-heavy — a crowd reads); quiet segments run the expected
    mix at baseline volume.  KL-only triggers lag here: the estimator's
    window dilutes a short burst, which is what the Page-Hinkley detector
    option (``DriftSpec.detector``) is for."""

    kind = "burst_storm"
    PARAMS = {"amplitude": 8.0, "period": 4}

    def __init__(self, drift):
        super().__init__(drift)
        amp = float(self.params["amplitude"])
        if not 1.0 <= amp <= 1000.0:
            raise ValueError(f"burst amplitude {amp} outside [1, 1000]")
        if int(self.params["period"]) < 2:
            raise ValueError("burst period must be >= 2 segments")

    def is_burst(self, segment: int) -> bool:
        period = int(self.params["period"])
        return segment % period == period - 1

    def schedule(self, expected) -> np.ndarray:
        S = int(self.drift.segments)
        t = np.array([1.0 if self.is_burst(s) else 0.0 for s in range(S)])
        return self.ramp(expected, self.target_mix((0.25, 0.60, 0.10, 0.05)),
                         t)

    def segment_queries(self, segment: int) -> int:
        base = int(self.drift.n_queries)
        if self.is_burst(segment):
            return max(1, int(round(base * float(self.params["amplitude"]))))
        return base


class TombstoneChurnScenario(Scenario):
    """Queue-like churn: after a calm first segment the mix flips to the
    write-dominant target and ``delete_fraction`` of every session's
    writes become deletes of the *oldest* live keys (tombstones flow down
    toward the data they shadow — the pattern that exposes round-robin
    partial-compaction slice selection and motivates overlap-based
    selection in ``lsm/planner.py``)."""

    kind = "tombstone_churn"
    PARAMS = {"delete_fraction": 0.5}

    def __init__(self, drift):
        super().__init__(drift)
        df = float(self.params["delete_fraction"])
        if not 0.0 <= df <= 1.0:
            raise ValueError(f"delete_fraction {df} outside [0, 1]")

    def schedule(self, expected) -> np.ndarray:
        S = int(self.drift.segments)
        t = (np.arange(S) >= 1).astype(np.float64)
        return self.ramp(expected, self.target_mix((0.05, 0.10, 0.05, 0.80)),
                         t)

    def session_kwargs(self, segment: int, n_existing: int) -> Dict[str, Any]:
        if segment == 0:
            return {}
        return {"delete_fraction": float(self.params["delete_fraction"])}


class ScanHeavyScenario(Scenario):
    """Analytics arriving: the mix ramps linearly toward a range-scan-
    dominant target while the scans widen to ``scan_scale`` x the spec's
    ``range_fraction`` — the workload the paper's q-cost term (and
    fence/seek accounting) is most sensitive to."""

    kind = "scan_heavy"
    PARAMS = {"scan_scale": 8.0}

    def schedule(self, expected) -> np.ndarray:
        S = int(self.drift.segments)
        t = np.arange(S, dtype=np.float64) / max(S - 1, 1)
        return self.ramp(expected, self.target_mix((0.05, 0.10, 0.80, 0.05)),
                         t)

    def session_kwargs(self, segment: int, n_existing: int) -> Dict[str, Any]:
        S = int(self.drift.segments)
        t = segment / max(S - 1, 1)
        scale = 1.0 + (float(self.params["scan_scale"]) - 1.0) * t
        return {"range_fraction": float(self.drift.range_fraction) * scale}
