"""Deterministic fault injection and crash-safe artifacts: the port of
``repro.faults`` so far (stdlib only).

* :mod:`repro_torch.faults.spec` — :class:`FaultSpec` / :class:`FaultPlan`,
  the seeded chaos schedule carried on ``ExperimentSpec.faults``;
* :mod:`repro_torch.faults.artifacts` — atomic writes and the content
  checksums every ``BENCH_<suite>.json`` carries.

``retry.py`` and the job pickles wait for the subprocess backend
(ROADMAP.md queue 5).
"""

from .artifacts import (CHECKSUM_KEY, TornWriteError, atomic_write_bytes,
                        atomic_write_json, canonical_json, checksum_ok,
                        load_checked_json, payload_checksum, stamp_checksum)
from .spec import (ARTIFACT_KINDS, HANG_SLEEP_S, KINDS, WORKER_KINDS,
                   FaultAction, FaultPlan, FaultSpec, u01)

__all__ = [
    "FaultSpec", "FaultPlan", "FaultAction",
    "KINDS", "WORKER_KINDS", "ARTIFACT_KINDS", "HANG_SLEEP_S", "u01",
    "CHECKSUM_KEY", "TornWriteError", "atomic_write_bytes",
    "atomic_write_json", "canonical_json", "checksum_ok",
    "load_checked_json", "payload_checksum", "stamp_checksum",
]
