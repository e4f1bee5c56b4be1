"""Paper Figure 9: Delta(Phi_N, Phi_R) over the (rho, observed-KL) plane.

Claim: nominal wins only (1) when the observed workload is ~= expected
(KL ~ 0) or (2) when rho < 0.2 while real variation is higher; elsewhere
robust dominates.  Rule of thumb validated: pick rho ~= max pairwise KL of
observed workloads.

One declarative spec through ``run_experiment``: w7 x six rhos + nominal,
model-scored over B (the robust grid is one lane batch)."""

from __future__ import annotations

import time
from typing import List

import numpy as np

from ..api import DesignSpec, ExperimentSpec, Row, WorkloadSpec, \
    run_experiment
from ..core import EXPECTED_WORKLOADS, kl_divergence
from .common import own_starts

RHOS = (0.1, 0.25, 0.5, 1.0, 2.0, 3.0)
WIDX = 7
KL_BINS = [(0.0, 0.2), (0.2, 0.6), (0.6, 1.2), (1.2, 2.5), (2.5, 10.0)]
N_STARTS = 64
STEPS = 250


def make_spec() -> ExperimentSpec:
    return ExperimentSpec(
        name="fig9",
        workload=WorkloadSpec(indices=(WIDX,), rhos=RHOS, nominal=True,
                              bench_n=10_000, bench_seed=0),
        design=DesignSpec(n_starts=N_STARTS, steps=STEPS))


def run(device=None, starts=own_starts) -> List[Row]:
    t0 = time.time()
    report = run_experiment(make_spec(), device=device, starts=starts)
    kls = kl_divergence(report.bench_set, EXPECTED_WORKLOADS[WIDX]).numpy()

    grid = {}
    for rho in RHOS:
        d = report.delta_tp_vs_nominal(0, rho)
        for lo, hi in KL_BINS:
            sel = (kls >= lo) & (kls < hi)
            if sel.any():
                grid[(rho, lo)] = float(d[sel].mean())
    us = (time.time() - t0) * 1e6

    # nominal should only win near (small KL) or (tiny rho)
    nominal_wins = [(rho, lo) for (rho, lo), v in grid.items() if v < 0]
    ok = all(lo < 0.2 or rho < 0.2 for rho, lo in nominal_wins)
    robust_region = [v for (rho, lo), v in grid.items()
                     if rho >= 0.25 and lo >= 0.2]
    return [Row("fig9_rho_choice", us,
                claim_nominal_wins_only_near_zero=ok,
                mean_gain_in_robust_region=round(float(np.mean(
                    robust_region)), 3),
                n_grid_cells=len(grid),
                worst_cell=round(float(np.min(list(grid.values()))), 3))]
