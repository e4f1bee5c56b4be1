"""Paper Figure 19 + Section 10: flexibility does NOT imply robustness.

For w7 and w11, obtain nominal tunings from every design (incl. K-LSM,
Fluid, Lazy Leveling, Dostoevsky) and ENDURE's robust tuning (rho=2), then
evaluate C(w_hat, Phi) as the observed workload drifts away (binned by
KL-divergence).

Claims: flexible designs win at KL ~ 0 (Fig 4 regime) but degrade like the
classic nominal tunings under drift; only the robust tuning stays flat —
robustness comes from the tuning process, not the design.

The nominal designs are ONE declarative spec with the design space as an
axis (``DesignSpec.spaces``, each arm tuned over the shared cell grid and
scored on the shared benchmark set); the robust reference is its own spec
(a different tuning process, not another design arm)."""

from __future__ import annotations

import time
from typing import List

from ..api import DesignSpec, ExperimentSpec, Row, WorkloadSpec, \
    run_experiment
from ..core import EXPECTED_WORKLOADS, kl_divergence
from .common import own_starts

WIDX = (7, 11)
BINS = [(0.0, 0.2), (0.5, 1.0), (2.0, 6.0)]
N_STARTS = 64
KLSM_STARTS = 192
STEPS = 250
RHO = 2.0


def nominal_models():
    """curve label -> design-space arm (name, n_starts) of the axis spec."""
    return [("nominal_classic", "classic", N_STARTS),
            ("lazy_leveling", "lazy_leveling", N_STARTS),
            ("dostoevsky", "dostoevsky", N_STARTS),
            ("fluid", "fluid", N_STARTS),
            ("klsm", "klsm", KLSM_STARTS)]


def axis_spec() -> ExperimentSpec:
    return ExperimentSpec(
        name="fig19_designs",
        workload=WorkloadSpec(indices=WIDX, nominal=True,
                              bench_n=10_000, bench_seed=0),
        design=DesignSpec(space="classic", n_starts=N_STARTS, steps=STEPS,
                          seed=0,
                          spaces=tuple((space, n_starts) for _, space,
                                       n_starts in nominal_models())))


def robust_spec() -> ExperimentSpec:
    return ExperimentSpec(
        name="fig19_endure_rho2",
        workload=WorkloadSpec(indices=WIDX, rhos=(RHO,), nominal=False,
                              bench_n=10_000, bench_seed=0),
        design=DesignSpec(space="classic", n_starts=N_STARTS, steps=STEPS,
                          seed=0))


def run(device=None, starts=own_starts) -> List[Row]:
    t0 = time.time()
    axis = run_experiment(axis_spec(), device=device, starts=starts)
    robust = run_experiment(robust_spec(), device=device, starts=starts)
    models = nominal_models()
    us_tune = (time.time() - t0) * 1e6 / ((len(models) + 1) * len(WIDX))

    rows: List[Row] = []
    for k, widx in enumerate(WIDX):
        kls = kl_divergence(axis.bench_set, EXPECTED_WORKLOADS[widx]).numpy()

        def binned(costs):
            return [float(costs[(kls >= lo) & (kls < hi)].mean())
                    for lo, hi in BINS]

        curves = {name: binned(axis.design_bench_costs[space][(k, None)])
                  for name, space, _ in models}
        curves["endure_rho2"] = binned(robust.bench_costs[(k, RHO)])

        # degradation = cost at far drift / cost near expected
        degr = {k2: v[-1] / v[0] for k2, v in curves.items()}
        flex_near = min(curves["klsm"][0], curves["fluid"][0])
        robust_flattest = degr["endure_rho2"] <= min(
            v for k2, v in degr.items() if k2 != "endure_rho2") * 1.05
        robust_best_far = curves["endure_rho2"][-1] <= min(
            v[-1] for k2, v in curves.items() if k2 != "endure_rho2") * 1.05
        rows.append(Row(
            f"fig19_flex_vs_robust_w{widx}", us_tune,
            cost_near_klsm=round(curves["klsm"][0], 3),
            cost_near_endure=round(curves["endure_rho2"][0], 3),
            cost_far_klsm=round(curves["klsm"][-1], 3),
            cost_far_endure=round(curves["endure_rho2"][-1], 3),
            claim_flexible_wins_near=flex_near <= curves["endure_rho2"][0]
            * 1.02,
            claim_robust_flattest=robust_flattest,
            claim_robust_best_under_drift=robust_best_far,
            degradation={k2: round(v, 2) for k2, v in degr.items()},
        ))
    return rows
