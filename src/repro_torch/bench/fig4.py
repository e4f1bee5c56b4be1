"""Paper Figure 4: nominal tunings of flexible vs classic LSM designs.

For the mixed read/write workload (w7) and the read-heavy workload (w11),
solve NOMINAL TUNING per design and report average I/Os per query
normalized to K-LSM.  Expected (paper 5.3): the flexible designs (K-LSM,
Fluid) match or beat the others; w11 collapses to leveling; Dostoevsky
(fixed memory) is worst.  Both workloads are tuned per design in one lane
batch on the card."""

from __future__ import annotations

import time
from typing import List

from ..api.report import Row
from ..core import EXPECTED_WORKLOADS, DesignSpace, tune_nominal_many
from .common import SYS, own_starts

DESIGNS = [
    ("leveling", DesignSpace.LEVELING),
    ("tiering", DesignSpace.TIERING),
    ("lazy_leveling", DesignSpace.LAZY_LEVELING),
    ("1-leveling", DesignSpace.ONE_LEVELING),
    ("dostoevsky", DesignSpace.DOSTOEVSKY),
    ("fluid", DesignSpace.FLUID),
    ("klsm", DesignSpace.KLSM),
]
WIDX = (7, 11)
N_STARTS = 64
KLSM_STARTS = 192
STEPS = 250


def run(device=None, starts=own_starts) -> List[Row]:
    W = EXPECTED_WORKLOADS[list(WIDX)]
    t0 = time.time()
    costs = {}            # name -> [cost for w7, cost for w11]
    for name, design in DESIGNS:
        n_starts = KLSM_STARTS if design is DesignSpace.KLSM else N_STARTS
        results = tune_nominal_many(W, SYS, design, n_starts=n_starts,
                                    steps=STEPS, seed=0, device=device,
                                    starts=starts(design, n_starts, 0))
        costs[name] = [r.cost for r in results]
    us = (time.time() - t0) * 1e6 / (len(DESIGNS) * len(WIDX))

    rows: List[Row] = []
    for k, widx in enumerate(WIDX):
        per_design = {name: c[k] for name, c in costs.items()}
        base = per_design["klsm"]
        derived = {f"io_norm_{name}": round(v / base, 3)
                   for name, v in per_design.items()}
        # paper claim: flexible designs produce the best tunings
        derived["klsm_best"] = all(base <= v * 1.02
                                   for v in per_design.values())
        derived["klsm_io"] = round(base, 3)
        rows.append(Row(f"fig4_nominal_designs_w{widx}", us, **derived))
    return rows
