"""Online drift subsystem: observe -> estimate -> re-tune, closed (the port
of ``repro.online``).

* **observe** — the session executor emits per-flush-window op counts
  (``SessionResult.window_ops``, :mod:`repro_torch.lsm.workload_runner`);
* **estimate** (:mod:`repro_torch.online.estimate`) — bounded window
  histories, sliding-window / EWMA mix estimators, and rho-from-history
  budgets (scalar + fleet-vectorized);
* **decide + re-tune** (:mod:`repro_torch.online.retune`) — KL-threshold,
  budget-exhaustion, Page-Hinkley and CUSUM triggers, storms batched
  through ``repro_torch.checkpoint.store.retune_storm``;
* **drive** (:mod:`repro_torch.online.session`) — :class:`OnlineSession`
  swaps tunings at flush boundaries via ``LSMTree.retune``;
  :func:`execute_drift` runs whole drift experiments (the
  ``repro_torch.api`` `DriftSpec` lowering);
* **arbitrate** (:mod:`repro_torch.online.memory`) — fleet-level memory as
  a single global budget: :class:`MemoryBudget` / :class:`FleetArbiter`
  divide it across tenants by marginal cost-model benefit and re-divide on
  the drift triggers; :func:`execute_memory_fleet` runs whole arbitration
  experiments (the ``repro_torch.api`` `MemorySpec` lowering).
"""

from .estimate import (ESTIMATORS, EWMAEstimator, SlidingWindowEstimator,
                       WindowHistory, kl_np, make_estimator,
                       normalize_counts, rho_from_history_batch,
                       rho_from_windows, smooth_mix)
from .memory import (MEMORY_ARMS, FleetArbiter, MemoryBudget, divide_budget,
                     execute_memory_fleet, memory_cost_curves)
from .retune import (CusumDetector, DriftPolicy, PageHinkleyDetector,
                     RetuneRequest, retune_fleet)
from .session import (ARMS, DriftArmResult, OnlineSession, SegmentRecord,
                      execute_drift)

__all__ = [
    "WindowHistory", "SlidingWindowEstimator", "EWMAEstimator",
    "ESTIMATORS", "make_estimator", "normalize_counts", "kl_np",
    "rho_from_windows", "rho_from_history_batch", "smooth_mix",
    "CusumDetector", "DriftPolicy", "PageHinkleyDetector", "RetuneRequest",
    "retune_fleet",
    "ARMS", "OnlineSession", "SegmentRecord", "DriftArmResult",
    "execute_drift",
    "MEMORY_ARMS", "MemoryBudget", "FleetArbiter", "divide_budget",
    "memory_cost_curves", "execute_memory_fleet",
]
