"""Failure / straggler / elasticity policy for 1000+-node runs.

The port's copy of ``repro/launch/elastic.py`` (pure Python).

This module is deliberately *pure policy* — decisions are computed from
heartbeat tables and timing stats so they can be unit-tested on CPU; the
cluster-facing actuation (killing a pod, relaunching with a new mesh) is the
thin launcher loop in train.py that consumes these decisions.

Mechanisms:
* step-granular checkpoints with the data cursor inside (exactly-once),
* deterministic data re-sharding (data/pipeline.py) so surviving workers
  re-derive a lost worker's batches without coordination,
* straggler ejection by robust z-score on per-step times,
* elastic remesh: the largest (data x model) mesh that fits the survivors,
  keeping the model axis fixed (weight layout preserved; see
  CheckpointStore.restore's re-shard-on-load path).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ElasticPolicy:
    heartbeat_timeout_s: float = 120.0
    straggler_zscore: float = 4.0
    min_data_parallel: int = 1
    checkpoint_interval: int = 100


def dead_workers(heartbeats: Dict[int, Dict], now: float, num_workers: int,
                 policy: ElasticPolicy) -> List[int]:
    """Workers whose last heartbeat is too old (or missing entirely)."""
    dead = []
    for w in range(num_workers):
        hb = heartbeats.get(w)
        if hb is None or (now - float(hb["t"])) > policy.heartbeat_timeout_s:
            dead.append(w)
    return dead


def stragglers(step_times: Dict[int, Sequence[float]],
               policy: ElasticPolicy) -> List[int]:
    """Robust z-score on median per-worker step time (MAD-based)."""
    med = {w: _median(list(ts)) for w, ts in step_times.items() if ts}
    if len(med) < 3:
        return []
    vals = sorted(med.values())
    m = _median(vals)
    mad = _median([abs(v - m) for v in vals]) or 1e-9
    return [w for w, v in med.items()
            if (v - m) / (1.4826 * mad) > policy.straggler_zscore]


def _median(xs: List[float]) -> float:
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def remesh(num_alive: int, model_parallel: int,
           policy: ElasticPolicy) -> Optional[Tuple[int, int]]:
    """Largest (data, model) mesh over the survivors, model axis fixed.

    Returns None if survivors cannot host even the minimum mesh."""
    if num_alive < model_parallel * policy.min_data_parallel:
        return None
    data = num_alive // model_parallel
    return (data, model_parallel)


def reshard_plan(old_shards: int, new_shards: int,
                 global_batch: int) -> Dict[int, List[int]]:
    """Which old data-shard ranges each new shard re-derives.

    Because batches are pure functions of (seed, step, shard), the 'plan' is
    informational — workers just switch shard ids; this mapping is used to
    verify coverage in tests."""
    assert global_batch % new_shards == 0
    per_new = global_batch // new_shards
    per_old = global_batch // old_shards
    plan: Dict[int, List[int]] = {}
    for ns in range(new_shards):
        lo, hi = ns * per_new, (ns + 1) * per_new
        plan[ns] = sorted({i // per_old for i in range(lo, hi)})
    return plan


@dataclasses.dataclass
class RunSupervisor:
    """Tracks run health; the launcher queries `decide` each step."""
    num_workers: int
    model_parallel: int
    policy: ElasticPolicy = ElasticPolicy()
    step_times: Dict[int, List[float]] = dataclasses.field(
        default_factory=dict)

    def record_step(self, worker: int, seconds: float) -> None:
        self.step_times.setdefault(worker, []).append(seconds)

    def decide(self, heartbeats: Dict[int, Dict], now: float) -> Dict:
        dead = dead_workers(heartbeats, now, self.num_workers, self.policy)
        slow = [w for w in stragglers(self.step_times, self.policy)
                if w not in dead]
        alive = self.num_workers - len(dead) - len(slow)
        action: Dict = {"dead": dead, "stragglers": slow, "action": "none"}
        if dead or slow:
            new_mesh = remesh(alive, self.model_parallel, self.policy)
            if new_mesh is None:
                action["action"] = "halt"
            else:
                action["action"] = "restart_from_checkpoint"
                action["new_mesh"] = new_mesh
        return action
