"""Deterministic fault injection and the crash-safe execution substrate:
the port of ``repro.faults`` (stdlib only, so a worker imports it cheaply).

* :mod:`repro_torch.faults.spec` — :class:`FaultSpec` / :class:`FaultPlan`,
  the seeded chaos schedule carried on ``ExperimentSpec.faults``;
* :mod:`repro_torch.faults.artifacts` — atomic writes and content
  checksums for every persisted artifact (``BENCH_<suite>.json``, the
  subprocess backend's per-shard job pickles, traces);
* :mod:`repro_torch.faults.retry` — :class:`RetryPolicy` (seeded backoff,
  per-attempt timeouts) and :class:`ShardSupervisor` (dead-worker
  membership and elastic re-sharding), which the subprocess backend
  (:class:`repro_torch.api.SubprocessBackend`) runs on.
"""

from .artifacts import (CHECKSUM_KEY, TornWriteError, atomic_write_bytes,
                        atomic_write_json, canonical_json, checksum_ok,
                        dump_job, load_checked_json, load_job,
                        payload_checksum, stamp_checksum)
from .retry import RetryPolicy, ShardSupervisor
from .spec import (ARTIFACT_KINDS, HANG_SLEEP_S, KINDS, WORKER_KINDS,
                   FaultAction, FaultPlan, FaultSpec, u01)

__all__ = [
    "FaultSpec", "FaultPlan", "FaultAction",
    "KINDS", "WORKER_KINDS", "ARTIFACT_KINDS", "HANG_SLEEP_S", "u01",
    "RetryPolicy", "ShardSupervisor",
    "CHECKSUM_KEY", "TornWriteError", "atomic_write_bytes",
    "atomic_write_json", "canonical_json", "checksum_ok", "dump_job",
    "load_checked_json", "load_job", "payload_checksum", "stamp_checksum",
]
