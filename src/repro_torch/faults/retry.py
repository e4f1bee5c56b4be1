"""Retry policy and worker-shard membership for fault-tolerant sweeps.

The port's own copy of ``repro/faults/retry.py`` (stdlib only).  The
elastic-training pattern — pure-policy membership decisions (dead-worker
detection, remesh over survivors) consumed by a thin actuation loop —
re-applied at fleet-trial granularity.  Here the observation channel
is direct (a shard launch returns, times out, or exits nonzero; no
heartbeat table needed) and "remesh" becomes re-sharding: a dead shard's
trees are regrouped onto fresh worker slots.  Both halves stay pure data +
pure functions so they unit-test without processes.

Everything is deterministic: backoff delays are hash draws over
``(seed, shard, attempt)`` (:func:`repro_torch.faults.spec.u01`), and
re-assignment is a sorted round-robin — the same failure schedule always
produces the same recovery schedule.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

from .spec import u01


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded, seeded exponential backoff for shard launches.

    A shard is attempted at most ``max_retries + 1`` times; attempt ``a``
    (a >= 1) is preceded by a delay of ``backoff_s * 2**(a-1)`` scaled by a
    deterministic jitter in [0.5, 1.5) drawn from ``(seed, shard, a)`` —
    jitter de-synchronizes a fleet of retrying shards without making the
    schedule irreproducible.  ``timeout_s`` is the per-attempt deadline
    after which a worker is declared hung and killed."""

    max_retries: int = 2
    backoff_s: float = 0.05
    timeout_s: float = 900.0
    seed: int = 0

    def attempts(self) -> int:
        return self.max_retries + 1

    def delay(self, shard: int, attempt: int) -> float:
        if attempt <= 0:
            return 0.0
        jitter = 0.5 + u01(self.seed, "backoff", shard, attempt)
        return self.backoff_s * (2.0 ** (attempt - 1)) * jitter


@dataclasses.dataclass
class ShardSupervisor:
    """Membership + failure bookkeeping for one sweep's worker shards.

    The shape of an elastic run supervisor (record observations, then ask
    for a decision), with the sweep's direct failure signal standing in for
    heartbeats: a shard that exhausts its retry
    budget is *dead*, and :meth:`reassign` is the remesh — its trees move
    onto fresh jobs sized to the surviving capacity."""

    failures: Dict[int, List[str]] = dataclasses.field(default_factory=dict)
    dead: List[int] = dataclasses.field(default_factory=list)
    completed: List[int] = dataclasses.field(default_factory=list)

    def record_failure(self, shard: int, error: str) -> None:
        self.failures.setdefault(shard, []).append(error)

    def mark_dead(self, shard: int) -> None:
        if shard not in self.dead:
            self.dead.append(shard)

    def mark_completed(self, shard: int) -> None:
        self.completed.append(shard)

    def last_error(self, shard: int) -> str:
        errs = self.failures.get(shard)
        return errs[-1] if errs else "<no error recorded>"

    @property
    def retries(self) -> int:
        """Total failed attempts across all shards (retried or not)."""
        return sum(len(v) for v in self.failures.values())

    def reassign(self, trees: Sequence[int], capacity: int
                 ) -> List[List[int]]:
        """Regroup dead shards' trees onto at most ``capacity`` fresh jobs.

        Sorted round-robin: deterministic, and it splits a dead shard's
        load across survivors instead of recreating the same doomed shard
        (different shard ids also re-roll the fault draws, which is exactly
        how a preempted-slot retry behaves on real infrastructure)."""
        if not trees:
            return []
        n = max(1, min(len(trees), capacity))
        jobs: List[List[int]] = [[] for _ in range(n)]
        for i, t in enumerate(sorted(trees)):
            jobs[i % n].append(t)
        return jobs
