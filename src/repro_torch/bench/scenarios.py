"""Scenario stress suite: the named workload generators + the live adversary.

The online suite moves mixes along synthetic paths; this suite replays the
richer stress patterns of :mod:`repro_torch.scenarios` on the executable
engine at 100,000 keys x 8 segments of 600 baseline queries per deployment
and measures three arms per scenario — ``stale_nominal`` (tuned once for
the expected mix), ``static_robust`` (one ENDURE robust tuning at the
measured ``rho_source="from_history"`` budget), and ``online`` (the
adaptive loop) — plus the ``oracle`` upper bound for context:

* ``zipf_migrate`` — Zipf-skewed reads whose hot set rotates per segment;
* ``burst_storm`` — periodic read-heavy flash crowds at ``amplitude`` x
  baseline volume, watched by the Page-Hinkley change-point detector;
* ``tombstone_churn`` — write-dominant delete churn against a read-tuned
  deployment (expected mix is the read-trimodal w11);
* ``scan_heavy`` — mix ramps toward range scans while the scans widen;
* ``adversary`` — the robust objective's inner max played live: each
  segment the worst-case mix inside the defender's rho-ball is solved
  exactly and executed against every arm, emitting per-window measured
  regret next to the independently-solved KL dual bound.

Every scenario drifts toward *expensive* query classes relative to its
expected mix.  All arms of a scenario share the key population and the
per-segment session plans, so throughput differences are tuning
differences.  On the card the trees' compactions run ``merge`` (the
tombstones of the churn flow through its newest-wins drop), their reads
``point_read``, and the robust tunings and re-tune storms ``dual_solve``.

Claims: on every scenario ``static_robust >= stale_nominal`` in throughput
(the paper's hedge survives every named stress pattern), and on every
adversary window the realized model cost stays under the KL dual bound
(``claim_regret_le_dual_bound``).
"""

from __future__ import annotations

from typing import List

from ..api import (DesignSpec, DriftSpec, ExperimentSpec, Row, WorkloadSpec,
                   run_experiment)
from ..core import EXPECTED_WORKLOADS
from .common import own_starts

N_KEYS = 100_000
SEGMENTS = 8
SEG_QUERIES = 600            # baseline; burst segments arrive at amplitude x
KEY_SPACE = 2 ** 26
RANGE_FRACTION = 5e-4
BITS_PER_ENTRY = 6.0
MAX_T = 30

#: (kind, expected workload index, history drift row, scenario_params,
#: detector).  The history row feeds ``rho_source="from_history"`` — the
#: robust arm's budget is the *measured* KL of the drift the scenario
#: executes, not a guessed rho.  Expected mixes: write-heavy w4 for the
#: read-tilting scenarios, read-trimodal w11 for tombstone churn (so the
#: write-dominant churn is the expensive direction).  The adversary's
#: history row is milder: it keeps the defender's ball non-degenerate
#: (rho < ln 4), so the inner max stays an interior tilt rather than a
#: point mass — the regime where the dual-bound cross-check has teeth.
SCENARIOS = (
    ("zipf_migrate", 4, (0.10, 0.70, 0.10, 0.10), (), "kl"),
    ("burst_storm", 4, (0.25, 0.60, 0.10, 0.05),
     (("amplitude", 6.0), ("period", 3)), "page_hinkley"),
    ("tombstone_churn", 11, (0.05, 0.10, 0.05, 0.80), (), "kl"),
    ("scan_heavy", 4, (0.05, 0.10, 0.80, 0.05), (), "kl"),
    ("adversary", 4, (0.10, 0.25, 0.10, 0.55), (), "kl"),
)

ARMS = ("stale_nominal", "static_robust", "online", "oracle")

SYSTEM = (("N", float(N_KEYS)), ("entry_bits", 64.0 * 8),
          ("page_bits", 4096.0 * 8), ("bits_per_entry", BITS_PER_ENTRY),
          ("min_buf_bits", 64.0 * 8 * 64), ("s_rq", 2e-5),
          ("max_T", float(MAX_T)))


def make_spec(kind: str, widx: int, history_row, scenario_params,
              detector: str, n_keys: int = N_KEYS,
              segments: int = SEGMENTS,
              seg_queries: int = SEG_QUERIES) -> ExperimentSpec:
    expected = tuple(float(x) for x in EXPECTED_WORKLOADS[widx])
    return ExperimentSpec(
        name=f"scenarios_{kind}",
        workload=WorkloadSpec(indices=(widx,), nominal=True,
                              rho_source="from_history",
                              history=(expected, tuple(history_row))),
        design=DesignSpec(seed=0),
        drift=DriftSpec(kind=kind, segments=segments, n_queries=seg_queries,
                        scenario_params=tuple(scenario_params),
                        detector=detector, n_keys=n_keys,
                        key_space=KEY_SPACE, range_fraction=RANGE_FRACTION,
                        key_seed=100, estimator="window", window=4,
                        capacity=64, kl_threshold=0.2, budget_slack=1.0,
                        min_windows=2, cooldown=2,
                        retune_starts=16, retune_steps=120),
        system=SYSTEM)


def specs() -> list:
    """``[(kind, spec), ...]`` of every scenario at the module's sizes."""
    return [(kind, make_spec(kind, widx, history_row, params, detector,
                             N_KEYS, SEGMENTS, SEG_QUERIES))
            for kind, widx, history_row, params, detector in SCENARIOS]


def scenario_reports(device=None, starts=own_starts) -> list:
    """``[(kind, report), ...]``: each scenario's ``run_experiment``."""
    return [(kind, run_experiment(spec, device=device, starts=starts))
            for kind, spec in specs()]


def rows_of(reports) -> List[Row]:
    """The suite's rows from :func:`scenario_reports`."""
    rows: List[Row] = []
    orderings = []
    regret_claims = []
    drift_s = tuning_s = 0.0
    for kind, report in reports:
        res = {arm: report.drift[(0, arm)] for arm in ARMS}
        tp = {arm: r.throughput for arm, r in res.items()}
        # same 0.999 machine-noise slack as the online suite's ordering
        ordered = tp["static_robust"] >= tp["stale_nominal"] * 0.999
        orderings.append((kind, ordered))
        drift_s += report.walls["drift_s"]
        tuning_s += report.walls["tuning_s"]
        rho0 = report.cells[-1][1]
        derived = dict(
            tp_stale_nominal=round(tp["stale_nominal"], 4),
            tp_static_robust=round(tp["static_robust"], 4),
            tp_online=round(tp["online"], 4),
            tp_oracle=round(tp["oracle"], 4),
            claim_robust_ge_stale=ordered,
            online_retunes=res["online"].retunes,
            rho_from_history=round(float(rho0), 3),
            segment_queries=[r.queries for r in res["online"].records],
            segment_io_robust=[round(r.avg_io_per_query, 3)
                               for r in res["static_robust"].records],
            segment_io_stale=[round(r.avg_io_per_query, 3)
                              for r in res["stale_nominal"].records],
        )
        if kind == "adversary":
            recs = report.regret[0]
            claim = bool(all(r["le_dual_bound"] for r in recs))
            regret_claims.append(claim)
            derived.update(
                defender=recs[-1]["defender"],
                claim_regret_le_dual_bound=claim,
                max_regret=round(max(r["regret"] for r in recs), 6),
                max_kl_adv=round(max(r["kl_adv"] for r in recs), 6),
                bound_margin_min=round(
                    min(r["dual_bound"] - r["cost_adv"] for r in recs), 6),
            )
        rows.append(Row(f"scenarios_{kind}", 0.0, **derived))
    rows.append(Row(
        "scenarios_fleet", drift_s * 1e6,
        n_keys=N_KEYS, segments=SEGMENTS, seg_queries=SEG_QUERIES,
        scenarios=len(SCENARIOS), arms=len(ARMS),
        tuning_s=round(tuning_s, 2), engine_s=round(drift_s, 2),
    ))
    rows.append(Row(
        "scenarios_summary", 0.0,
        claim_robust_ge_stale=all(ok for _, ok in orderings),
        claim_regret_le_dual_bound=all(regret_claims),
        ordering={kind: ok for kind, ok in orderings},
    ))
    return rows


def run(device=None, starts=own_starts) -> List[Row]:
    return rows_of(scenario_reports(device, starts))
