"""Paper Figure 6 + Section 8.3: avg Delta-throughput of robust vs nominal
per workload category, as a function of rho.

Paper claims reproduced here:
  * >= 95% average improvement for unimodal/bimodal/trimodal expected
    workloads once rho >= 0.5;
  * uniform (w0) is the one case where nominal stays ~5% ahead;
  * robust tunings win the overwhelming majority of the ~2M comparisons.

The whole figure is one declarative spec: all 15 expected workloads x 5
rhos plus the nominal baselines, scored over the Section 7 benchmark set,
lowered onto two lane batches (one nominal, one robust grid)."""

from __future__ import annotations

import time
from collections import defaultdict
from typing import List

import numpy as np

from ..api import ExperimentSpec, Row, WorkloadSpec, run_experiment
from ..core import WORKLOAD_CATEGORY
from .common import own_starts

RHOS = (0.25, 0.5, 1.0, 2.0, 3.0)
SPEC = ExperimentSpec(
    name="fig6",
    workload=WorkloadSpec(indices=tuple(range(15)), rhos=RHOS,
                          nominal=True, bench_n=10_000, bench_seed=0),
)


def rows_of(report, us: float) -> List[Row]:
    """The suite's rows from a finished report (``us``: the wall time)."""
    cat_delta = defaultdict(lambda: defaultdict(list))
    wins = total = 0
    for widx in range(15):
        cat = WORKLOAD_CATEGORY[widx]
        for rho in RHOS:
            d = report.delta_tp_vs_nominal(widx, rho)
            cat_delta[cat][rho].append(float(d.mean()))
            wins += int((d > 0).sum())
            total += d.size

    rows: List[Row] = []
    for cat, per_rho in cat_delta.items():
        derived = {f"avg_delta_rho{rho}": round(float(np.mean(v)), 3)
                   for rho, v in per_rho.items()}
        rows.append(Row(f"fig6_avg_delta_{cat}", us / 4, **derived))

    win_rate = wins / max(total, 1)
    nonuni = [np.mean(cat_delta[c][rho])
              for c in ("unimodal", "bimodal", "trimodal")
              for rho in (0.5, 1.0, 2.0)]
    rows.append(Row(
        "fig6_summary", us,
        robust_win_rate=round(win_rate, 3),
        claim_win_majority=win_rate > 0.8,          # paper: >80% of comps
        min_nonuniform_gain_rho_ge_05=round(float(np.min(nonuni)), 3),
        claim_95pct_gain=bool(np.mean(nonuni) > 0.95),
        max_delta=round(float(np.max([v for d in cat_delta.values()
                                      for vs in d.values()
                                      for v in np.atleast_1d(vs)])), 2),
    ))
    return rows


def run(device=None, starts=own_starts) -> List[Row]:
    t0 = time.time()
    report = run_experiment(SPEC, device=device, starts=starts)
    return rows_of(report, (time.time() - t0) * 1e6)
