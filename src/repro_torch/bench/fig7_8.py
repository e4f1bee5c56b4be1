"""Paper Figures 7 & 8: impact of rho for w11 (read-heavy).

Fig 7: Delta(Phi_N, Phi_R) grows with the observed KL-divergence; rho=0
matches nominal.  Fig 8: the throughput range Theta_B shrinks as rho grows
(robustness = consistency).

One declarative spec through ``run_experiment``: w11 x four rhos + the
nominal baseline, model-scored over the benchmark set (the robust grid is
one lane batch, which launches ``dual_solve`` once per Adam step plus
once for the final iterate)."""

from __future__ import annotations

import time
from typing import List

from ..api import DesignSpec, ExperimentSpec, Row, WorkloadSpec, \
    run_experiment
from ..core import EXPECTED_WORKLOADS, kl_divergence, throughput_range
from .common import own_starts

RHOS = (0.0, 0.5, 1.0, 2.0)
WIDX = 11
BINS = [(0.0, 0.2), (0.2, 0.5), (0.5, 1.0), (1.0, 2.0), (2.0, 10.0)]
N_STARTS = 64
STEPS = 250


def make_spec() -> ExperimentSpec:
    return ExperimentSpec(
        name="fig7_8",
        workload=WorkloadSpec(indices=(WIDX,), rhos=RHOS, nominal=True,
                              bench_n=10_000, bench_seed=0),
        design=DesignSpec(n_starts=N_STARTS, steps=STEPS))


def run(device=None, starts=own_starts) -> List[Row]:
    t0 = time.time()
    report = run_experiment(make_spec(), device=device, starts=starts)
    B = report.bench_set
    kls = kl_divergence(B, EXPECTED_WORKLOADS[WIDX]).numpy()

    rows: List[Row] = []
    theta_by_rho = {}
    for rho in RHOS:
        d = report.delta_tp_vs_nominal(0, rho)
        derived = {}
        for lo, hi in BINS:
            sel = (kls >= lo) & (kls < hi)
            if sel.any():
                derived[f"delta_kl_{lo}_{hi}"] = round(float(d[sel].mean()),
                                                       3)
        theta = float(throughput_range(B, report.tuning((0, rho)).phi,
                                       report.sys))
        theta_by_rho[rho] = theta
        derived["theta_range"] = round(theta, 4)
        rows.append(Row(f"fig7_delta_vs_kl_rho{rho}", 0.0, **derived))
    us = (time.time() - t0) * 1e6 / len(RHOS)
    for r in rows:
        r.us = us

    # Fig 8 claim: Theta decreases with rho (higher consistency).
    thetas = [theta_by_rho[r] for r in RHOS]
    rows.append(Row("fig8_theta_shrinks", us,
                    theta_rho0=round(thetas[0], 4),
                    theta_rho2=round(thetas[-1], 4),
                    claim_monotone_shrink=bool(thetas[-1] < thetas[0])))
    return rows
