"""ENDURE / K-LSM core on PyTorch: the port of ``repro.core``.

- lsm_cost:  the unified K-LSM cost model (Eqs. 1-9), lane-batched
- designs:   Table-3 design-space parameterizations
- nominal:   NOMINAL TUNING (Problem 1): multi-start Adam + SLSQP
- robust:    ROBUST TUNING (Problem 2) via the KL dual (Eqs. 16-17)
- batch:     the (workload x rho x design) sweep as one lane batch, with
             the warm dual solve on the CUDA kernel at every Adam step
- workload:  KL uncertainty regions, exact inner maximizer, rho heuristics
- uncertainty_bench: Table 4 expected workloads + benchmark set B
- metrics:   Delta-throughput and throughput-range (Section 8.1)
"""

from .batch import (build_results, solve_grid, tune_nominal_many,
                    tune_robust_many)
from .designs import (ENGINE_POLICIES, LAZY_LEVELING_FILL, DesignSpace,
                      describe, policy_effective_phi, to_phi, to_phi_policy)
from .lsm_cost import (LSMSystem, Phi, cost_across_memory, cost_vector,
                       expected_cost, leveling_phi, make_phi, num_levels,
                       throughput, tiering_phi)
from .metrics import delta_throughput, delta_throughput_batch, throughput_range
from .nominal import TuningResult, tune_nominal, tune_nominal_slsqp
from .robust import (dual_solve_cold, dual_solve_warm, primal_worst_case,
                     robust_cost, tune_robust, tune_robust_slsqp)
from .uncertainty_bench import (EXPECTED_WORKLOADS, WORKLOAD_CATEGORY,
                                sample_benchmark, zippydb_like)
from .workload import (kl_divergence, rho_from_history, rho_from_pair,
                       rho_from_ranges, worst_case_workload)

__all__ = [
    "DesignSpace", "LSMSystem", "Phi", "TuningResult",
    "cost_vector", "cost_across_memory", "expected_cost", "throughput",
    "num_levels",
    "make_phi", "leveling_phi", "tiering_phi", "describe", "to_phi",
    "to_phi_policy", "ENGINE_POLICIES", "policy_effective_phi",
    "tune_nominal", "tune_nominal_slsqp", "tune_robust", "tune_robust_slsqp",
    "tune_nominal_many", "tune_robust_many", "solve_grid", "build_results",
    "LAZY_LEVELING_FILL",
    "robust_cost", "dual_solve_cold", "dual_solve_warm",
    "primal_worst_case", "worst_case_workload",
    "kl_divergence", "rho_from_history", "rho_from_pair", "rho_from_ranges",
    "delta_throughput", "delta_throughput_batch", "throughput_range",
    "EXPECTED_WORKLOADS", "WORKLOAD_CATEGORY", "sample_benchmark",
    "zippydb_like",
]
