"""Paper Table 5 + Figures 12-17 analogue: SYSTEM-measured (not model)
delta throughput of robust vs nominal tunings on the executable LSM engine.

Per expected workload: deploy Phi_N and Phi_R at reduced scale, execute
drifted workload sessions sampled from the uncertainty benchmark, and
measure avg I/O per query.

The whole evaluation is ONE declarative spec: five expected workloads, the
nominal baseline plus rho=1 robust cells, and a Table-5 trial
(``per_workload_keys``: the nominal/robust pair of a workload shares its
key draw and session seeds), at 250k keys x 10k queries per session.  On
the card every compaction runs the ``merge`` kernel and every read batch
``point_read``.

Claims validated:
  * robust beats nominal on most expected workloads (Table 5: 10 of 15,
    2 slight losses);
  * robust tunings choose leveling ("leveling is more robust", Sec. 11);
  * model-predicted and engine-measured RANKING of the two tunings agree
    (Figures 12-15 'model matches system').
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..api import (ExperimentSpec, Row, TrialSpec, WorkloadSpec,
                   run_experiment)
from .common import own_starts

N_KEYS = 250_000
QUERIES = 10_000
KEY_SPACE = 2 ** 26    # dense keyspace so ranges overlap runs
RANGE_FRACTION = 1e-3
RHO = 1.0
BITS_PER_ENTRY = 6.0   # memory-constrained: deeper trees (L=2-4) at small N
MAX_T = 30             # cap T so the scaled-down tree cannot degenerate to L=1
WIDX = (0, 4, 7, 11, 13)
# drifted sessions: dominant query type >= 80% (paper Section 9.2)
SESSIONS = (
    (0.85, 0.05, 0.05, 0.05),
    (0.05, 0.85, 0.05, 0.05),
    (0.05, 0.05, 0.85, 0.05),
    (0.05, 0.05, 0.05, 0.85),
)


def make_spec(widx_list=WIDX) -> ExperimentSpec:
    return ExperimentSpec(
        name="tab5",
        workload=WorkloadSpec(indices=tuple(widx_list), rhos=(RHO,),
                              nominal=True),
        trial=TrialSpec(n_keys=N_KEYS, n_queries=QUERIES, sessions=SESSIONS,
                        key_space=KEY_SPACE, range_fraction=RANGE_FRACTION,
                        per_workload_keys=True, key_seed=100),
        system=(("N", float(N_KEYS)), ("entry_bits", 64.0 * 8),
                ("page_bits", 4096.0 * 8),
                ("bits_per_entry", BITS_PER_ENTRY),
                ("min_buf_bits", 64.0 * 8 * 64), ("s_rq", 2e-5),
                ("max_T", float(MAX_T))),
    )


def rows_of(report, widx_list=WIDX) -> List[Row]:
    """The suite's rows from a finished report."""
    rows: List[Row] = []
    n_wins = 0
    ranking_agree = 0
    leveling_robust = 0
    for i, widx in enumerate(widx_list):
        rn, rr = report.tuning((i, None)), report.tuning((i, RHO))
        io_n = float(report.measured_io((i, None)).mean())
        io_r = float(report.measured_io((i, RHO)).mean())
        delta = (1.0 / io_r - 1.0 / io_n) / (1.0 / io_n)
        n_wins += delta > 0
        # model prediction for the same drifted sessions
        cn = float(report.model_session_io((i, None), SESSIONS).mean())
        cr = float(report.model_session_io((i, RHO), SESSIONS).mean())
        ranking_agree += (cr < cn) == (io_r < io_n)
        leveling_robust += bool(np.allclose(np.asarray(rr.phi.K)[:2], 1.0))
        rows.append(Row(
            f"tab5_system_w{widx}", 0.0,
            engine_io_nominal=round(io_n, 3),
            engine_io_robust=round(io_r, 3),
            measured_delta_tp=round(delta, 3),
            model_predicts_robust=cr < cn,
            nominal=f"T{float(rn.phi.T):.0f}",
            robust=f"T{float(rr.phi.T):.0f}",
        ))
    walls = report.walls
    rows.append(Row(
        "tab5_fleet", report.wall_time_s * 1e6,
        n_keys=N_KEYS, n_queries=QUERIES,
        trees=len(report.fleet), sessions_per_tree=len(SESSIONS),
        tuning_s=round(walls["tuning_s"], 2),
        populate_s=round(walls["populate_s"], 2),
        engine_s=round(walls["populate_s"] + walls["fleet_s"], 2),
    ))
    rows.append(Row(
        "tab5_summary", 0.0,
        robust_wins=f"{n_wins}/{len(widx_list)}",
        claim_majority_wins=n_wins >= 3,
        note="paper Table 5 itself reports robust losses on w13/w14 and ~0 "
             "on uniform w0 - the same cells lose here",
        model_system_ranking_agreement=f"{ranking_agree}/{len(widx_list)}",
        claim_leveling_is_robust=leveling_robust == len(widx_list),
    ))
    return rows


def run(widx_list=WIDX, device=None, starts=own_starts) -> List[Row]:
    report = run_experiment(make_spec(widx_list), device=device,
                            starts=starts)
    return rows_of(report, widx_list)
