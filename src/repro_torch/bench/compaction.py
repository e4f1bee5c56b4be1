"""Compaction design-space evaluation: measured vs model, per policy.

ONE declarative spec deploys a single pinned tuning (``DesignSpec.fixed``)
under every compaction policy in the planner registry (K-LSM baseline +
lazy leveling + partial compaction + tombstone-TTL) — the policy axis as
discrete arms — populates each tree from a shared 250k-key draw, seeds real
tombstones (1% deletes, so the TTL sweeps have something to age out), and
runs the same four drifted 10k-query sessions against every tree as ONE
fleet grid: the Section 9 experiment design extended along the
Sarkar-taxonomy policy axis.  It runs no tuner, so every held field is the
exact engine's; on the card every compaction runs ``merge`` and every read
batch ``point_read``, and nothing runs ``dual_solve``.

Per policy the suite reports measured avg I/O per query per session next
to the cost model's prediction through
:func:`repro_torch.core.policy_effective_phi` (the policy's steady-state K
profile), plus the policy-specific invariants from the facade's tree
probes: the lazy tree's last-level run count (read pressure keeps it
squeezed), the TTL tree's maximum surviving tombstone age, and that
deletes never resurface.

Claims validated:
  * the model's predicted ORDERING of policies by cost matches the
    engine's measured ordering on most distinguishable (policy, policy,
    session) pairs (the design-space analogue of 'model matches system');
  * lazy leveling cuts write I/O vs leveling while read-triggered
    squeezes keep point reads close to leveled cost;
  * tombstone-TTL bounds delete persistence (max tombstone age <= TTL)
    at a measurable write-amplification premium on write-heavy sessions.
"""

from __future__ import annotations

from typing import List

from ..api import (DesignSpec, ExperimentSpec, Row, TrialSpec, WorkloadSpec,
                   run_experiment)
from .common import own_starts

N_KEYS = 250_000
QUERIES = 10_000
KEY_SPACE = 2 ** 26    # dense keyspace so ranges overlap runs
RANGE_FRACTION = 1e-3  # of the keyspace == expected fraction of N per range,
                       # so the model system below uses s_rq = RANGE_FRACTION
BITS_PER_ENTRY = 6.0   # memory-constrained: deeper trees at small N
DELETE_FRACTION = 0.01
TTL_FLUSHES = 8        # short enough that sweeps fire inside the sessions
T, FILT_BPE = 6, 4.0   # one mid-range leveled tuning, shared by all policies

POLICIES = ("klsm", "lazy_leveling", "partial", "tombstone_ttl")
# drifted sessions: dominant query type >= 80% (paper Section 9.2)
SESSIONS = (
    (0.85, 0.05, 0.05, 0.05),
    (0.05, 0.85, 0.05, 0.05),
    (0.05, 0.05, 0.85, 0.05),
    (0.05, 0.05, 0.05, 0.85),
)
CELL = (0, None)       # the single pinned-tuning cell


def make_spec() -> ExperimentSpec:
    """The suite's spec at the module's sizes."""
    return ExperimentSpec(
        name="compaction",
        workload=WorkloadSpec(workloads=((0.25, 0.25, 0.25, 0.25),),
                              rhos=(), nominal=True),
        design=DesignSpec(fixed=(float(T), FILT_BPE, 1.0),
                          policies=POLICIES,
                          policy_params=(
                              ("lazy_leveling", (("read_trigger", 512),)),
                              ("partial", (("parts", 4),)),
                              ("tombstone_ttl",
                               (("ttl_flushes", TTL_FLUSHES),)),
                          )),
        trial=TrialSpec(n_keys=N_KEYS, n_queries=QUERIES, sessions=SESSIONS,
                        key_space=KEY_SPACE, range_fraction=RANGE_FRACTION,
                        key_seed=77, session_seeds=(200, 201, 202, 203),
                        delete_fraction=DELETE_FRACTION),
        system=(("N", float(N_KEYS)), ("entry_bits", 64.0 * 8),
                ("page_bits", 4096.0 * 8),
                ("bits_per_entry", BITS_PER_ENTRY),
                ("min_buf_bits", 64.0 * 8 * 64), ("s_rq", RANGE_FRACTION),
                ("max_T", 30.0)))


def rows_of(report) -> List[Row]:
    """The suite's rows from a finished report."""
    rows: List[Row] = []
    measured_by_policy, model_by_policy = {}, {}
    for pol in POLICIES:
        measured = report.measured_io(CELL, pol)
        model = report.model_session_io(CELL, SESSIONS, pol)
        measured_by_policy[pol] = measured
        model_by_policy[pol] = model
        probe = report.probes[(CELL, pol)]
        rows.append(Row(
            f"compaction_{pol}", 0.0,
            measured_io=[round(float(x), 3) for x in measured],
            model_io=[round(float(x), 3) for x in model],
            agreement_ratio=round(float(measured.mean() / model.mean()), 3),
            last_level_runs=probe.last_level_runs,
            max_tombstone_age_flushes=int(probe.max_tombstone_age),
            dead_keys_resurfaced=probe.dead_keys_resurfaced,
        ))

    # model-vs-system ranking agreement, pairwise per drifted session: only
    # pairs the model actually distinguishes (>2% predicted gap) count —
    # klsm/partial/tombstone_ttl share a steady-state profile, so the model
    # deliberately predicts ties for them
    agree = total = 0
    for s in range(len(SESSIONS)):
        for a in range(len(POLICIES)):
            for b in range(a + 1, len(POLICIES)):
                dm = model_by_policy[POLICIES[a]][s] \
                    - model_by_policy[POLICIES[b]][s]
                if abs(dm) < 0.02 * model_by_policy[POLICIES[a]][s]:
                    continue
                de = measured_by_policy[POLICIES[a]][s] \
                    - measured_by_policy[POLICIES[b]][s]
                total += 1
                agree += (dm > 0) == (de > 0)
    lazy_w = float(measured_by_policy["lazy_leveling"][3])
    klsm_w = float(measured_by_policy["klsm"][3])
    ttl_probe = report.probes[(CELL, "tombstone_ttl")]
    rows.append(Row(
        "compaction_summary", 0.0,
        policies=len(POLICIES),
        pairwise_rank_agreement=f"{agree}/{total}",
        lazy_beats_leveling_on_writes=lazy_w < klsm_w,
        ttl_bound_holds=all(age < TTL_FLUSHES
                            for age in ttl_probe.tomb_ages),
    ))
    walls = report.walls
    trial = report.spec.trial
    rows.append(Row(
        "compaction_fleet", report.wall_time_s * 1e6,
        n_keys=trial.n_keys, n_queries=trial.n_queries,
        trees=len(report.fleet), sessions_per_tree=len(SESSIONS),
        populate_s=round(walls["populate_s"], 2),
        engine_s=round(walls["populate_s"] + walls["fleet_s"], 2),
    ))
    return rows


def run(device=None, starts=own_starts) -> List[Row]:
    """The suite on ``device``; it runs no tuner, so ``starts`` is
    unused."""
    return rows_of(run_experiment(make_spec(), device=device,
                                  starts=starts))
