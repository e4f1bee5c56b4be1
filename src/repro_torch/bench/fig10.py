"""Paper Figure 10: sensitivity of tuning performance to entry size E.

Claim: for the mixed workload (w7) ENDURE beats nominal at every entry
size; for the read-heavy workload (w11) nominal is better at small E but
ENDURE gains as E grows (memory becomes a smaller fraction of the data).
Per entry size both workloads are tuned nominally in one lane batch and
robustly in another (the robust one launches ``dual_solve`` once per Adam
step, plus once for the final iterate)."""

from __future__ import annotations

import time
from typing import List

import numpy as np

from ..api.report import Row, delta_tp
from ..core import (EXPECTED_WORKLOADS, DesignSpace, LSMSystem, cost_vector,
                    tune_nominal_many, tune_robust_many)
from .common import B_SET, own_starts

ENTRY_BITS = [128 * 8, 512 * 8, 1024 * 8, 4096 * 8, 8192 * 8]
RHO = 1.0
WIDX = (7, 11)
N_STARTS = 64
STEPS = 250


def robust_tunings(sys_e: LSMSystem, device=None, starts=own_starts):
    """The suite's robust call at one entry size: both workloads at
    ``RHO``, one lane batch."""
    return tune_robust_many(EXPECTED_WORKLOADS[list(WIDX)], [RHO], sys_e,
                            n_starts=N_STARTS, steps=STEPS, seed=0,
                            device=device,
                            starts=starts(DesignSpace.CLASSIC, N_STARTS, 0))


def run(device=None, starts=own_starts) -> List[Row]:
    t0 = time.time()
    W = EXPECTED_WORKLOADS[list(WIDX)]
    gains = {widx: {} for widx in WIDX}
    for eb in ENTRY_BITS:
        sys_e = LSMSystem(entry_bits=float(eb))
        nom = tune_nominal_many(W, sys_e, n_starts=N_STARTS, steps=STEPS,
                                seed=0, device=device,
                                starts=starts(DesignSpace.CLASSIC, N_STARTS,
                                              0))
        rob = robust_tunings(sys_e, device, starts)
        for k, widx in enumerate(WIDX):
            cn = B_SET @ cost_vector(nom[k].phi, sys_e).numpy().astype(
                np.float64)
            cr = B_SET @ cost_vector(rob[k][0].phi, sys_e).numpy().astype(
                np.float64)
            gains[widx][eb] = float(delta_tp(cn, cr).mean())
    us = (time.time() - t0) * 1e6 / (len(ENTRY_BITS) * len(WIDX))

    rows: List[Row] = []
    for widx in WIDX:
        g = [gains[widx][eb] for eb in ENTRY_BITS]
        derived = {f"gain_E{eb // 8}B": round(gains[widx][eb], 3)
                   for eb in ENTRY_BITS}
        if widx == 7:
            derived["claim_robust_wins_all_E"] = all(x > 0 for x in g)
        else:
            derived["claim_gain_grows_with_E"] = g[-1] > g[0]
        rows.append(Row(f"fig10_entry_size_w{widx}", us, **derived))
    return rows
