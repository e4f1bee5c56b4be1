"""Beyond-paper: robust mesh/layout selection from dry-run records.

Builds layout candidates for archs with full 4-shape coverage from the
dry-run roofline step times of a records directory (``records``, the
port's ``launch/dryrun.py`` records on the ``single`` mesh, tags
``baseline`` and ``opt``), then compares the nominal pick (best for the
expected traffic mix) with the ENDURE-style robust pick (best worst case
over a KL ball of mixes) under a long-context burst
(:mod:`repro_torch.core.robust_sharding`).

Without a records directory, or for an arch with fewer than two tagged
candidates, the suite prints a skip row, as the committed
``BENCH_robust_sharding.json`` holds for all three.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from ..api import Row
from ..core.robust_sharding import (adversarial_mix, candidates_from_dryrun,
                                    nominal_layout, robust_layout)
from .common import own_starts

#: the records directory when the caller names none (none: the skip rows)
DRYRUN = None
# archs that run all four shapes (incl. long_500k)
ARCHS = ("mixtral-8x7b", "jamba-1.5-large-398b", "rwkv6-3b")
SKIPPED = "needs >=2 tagged dry-run configs"


def run(device=None, starts=own_starts, records=None) -> List[Row]:
    """The suite's rows; ``records``: a directory of dry-run records (none:
    the skip rows).  It runs no tuner, so ``starts`` is unused."""
    rows: List[Row] = []
    expected = np.array([0.70, 0.15, 0.14, 0.01])   # training-dominated
    burst = np.array([0.30, 0.10, 0.20, 0.40])      # long-context burst
    for arch in ARCHS:
        t0 = time.time()
        where = DRYRUN if records is None else records
        cands = [] if where is None else candidates_from_dryrun(
            arch, str(where), tags=("baseline", "opt"))
        if len(cands) < 2:
            rows.append(Row(f"robust_sharding_{arch}", 0.0,
                            skipped=SKIPPED))
            continue
        nom = nominal_layout(cands, expected)
        rob = robust_layout(cands, expected, rho=1.0, device=device)
        adv = adversarial_mix(nom, expected, rho=1.0, device=device)
        us = (time.time() - t0) * 1e6
        rows.append(Row(
            f"robust_sharding_{arch}", us,
            candidates=len(cands),
            nominal=nom.name.split(":")[1],
            robust=rob.name.split(":")[1],
            nominal_expected_s=round(nom.expected_cost(expected), 2),
            robust_worst_case_s=round(rob.worst_case, 2),
            nominal_worst_case_s=round(rob.nominal_worst_case, 2),
            robust_no_worse_in_worst_case=rob.worst_case
            <= rob.nominal_worst_case * (1 + 1e-6),
            nominal_burst_s=round(nom.expected_cost(burst), 2),
            robust_burst_s=round(rob.expected_cost(burst), 2),
            adversarial_mix_long_frac=round(float(adv[3]), 3),
        ))
    return rows
