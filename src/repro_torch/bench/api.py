"""API smoke suite: one tiny declarative experiment, end to end.

Exercises the whole facade in small form — spec -> JSON -> spec round
trip, a two-workload (nominal + robust) grid with the compaction policy as
a discrete arm, and a reduced-scale engine trial — and emits the unified
report's rows, plus the ``api_fleet`` row (the measured-over-model
agreement and the arm each cell chose)."""

from __future__ import annotations

from typing import List

import numpy as np

from ..api import (DesignSpec, ExperimentSpec, Row, TrialSpec, WorkloadSpec,
                   run_experiment)
from .common import own_starts

N_KEYS = 40_000
QUERIES = 2000
SESSIONS = (
    (0.05, 0.85, 0.05, 0.05),
    (0.05, 0.05, 0.05, 0.85),
)

SPEC = ExperimentSpec(
    name="api",
    workload=WorkloadSpec(indices=(4, 11), rhos=(1.0,), nominal=True),
    design=DesignSpec(n_starts=16, steps=120, seed=0,
                      policies=("klsm", "lazy_leveling"),
                      policy_params=(
                          ("lazy_leveling", (("read_trigger", 512),)),)),
    trial=TrialSpec(n_keys=N_KEYS, n_queries=QUERIES, sessions=SESSIONS,
                    key_space=2 ** 24, range_fraction=1e-3,
                    per_workload_keys=True, key_seed=100),
    system=(("N", float(N_KEYS)), ("entry_bits", 64.0 * 8),
            ("page_bits", 4096.0 * 8), ("bits_per_entry", 6.0),
            ("min_buf_bits", 64.0 * 8 * 64), ("s_rq", 1e-3),
            ("max_T", 20.0)),
)


def rows_of(report) -> List[Row]:
    """The suite's rows from a finished report."""
    rows = report.rows()           # one row per cell + the walls row
    walls = report.walls
    measured = np.concatenate([report.measured_io(c) for c in report.cells])
    model = np.concatenate([
        np.asarray(report.model_session_io(c, SESSIONS)).ravel()
        for c in report.cells])
    rows.append(Row(
        "api_fleet", report.wall_time_s * 1e6,
        n_keys=N_KEYS, n_queries=QUERIES, trees=len(report.fleet),
        sessions_per_tree=len(SESSIONS),
        tuning_s=round(walls["tuning_s"], 2),
        engine_s=round(walls["populate_s"] + walls["fleet_s"], 2),
        mean_agreement=round(float(measured.mean() / model.mean()), 3),
        arms_chosen={f"w{i}" + ("" if rho is None else f"_rho{rho:g}"):
                     report.chosen[(i, rho)]
                     for (i, rho) in report.cells},
    ))
    return rows


def run(device=None, starts=own_starts) -> List[Row]:
    # the JSON round trip is part of the smoke surface
    spec = ExperimentSpec.from_json(SPEC.to_json())
    assert spec == SPEC, "ExperimentSpec JSON round-trip drifted"
    return rows_of(run_experiment(spec, device=device, starts=starts))
