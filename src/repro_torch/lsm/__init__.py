"""Executable LSM-tree storage engine on torch devices: the port of
``repro.lsm``.

Three layers: a structure-of-arrays run store with device arenas
(:mod:`repro_torch.lsm.store`), the host-side compaction planner
(:mod:`repro_torch.lsm.planner`), and the batched engine + session executor
(:mod:`repro_torch.lsm.engine`, :mod:`repro_torch.lsm.workload_runner`),
whose merges and point reads run the port's kernels."""

from .bloom import BloomFilter, BloomPack, monkey_bits_per_key
from .engine import EngineConfig, IOStats, LSMTree, TOMBSTONE
from .planner import (POLICIES, CompactionPolicy, KLSMPlanner,
                      LazyLevelingPlanner, MergePlan,
                      PartialCompactionPlanner, TombstoneTTLPlanner,
                      make_planner)
from .store import RunStore, ValueCodec
from .workload_runner import (SessionPlan, SessionResult, draw_keys,
                              execute_session, materialize_session,
                              measured_cost_vector, populate, run_fleet,
                              run_policy_fleet, run_session)

__all__ = ["BloomFilter", "BloomPack", "monkey_bits_per_key", "EngineConfig",
           "IOStats", "LSMTree", "TOMBSTONE", "CompactionPolicy",
           "KLSMPlanner", "LazyLevelingPlanner", "PartialCompactionPlanner",
           "TombstoneTTLPlanner", "POLICIES", "make_planner", "MergePlan",
           "RunStore", "ValueCodec", "SessionPlan", "SessionResult",
           "draw_keys", "execute_session", "materialize_session",
           "measured_cost_vector", "populate", "run_fleet",
           "run_policy_fleet", "run_session"]
