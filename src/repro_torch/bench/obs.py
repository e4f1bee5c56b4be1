"""Telemetry plane: overhead, result identity, measured-cost calibration.

Three contracts of :mod:`repro_torch.obs`, each measured on the same
scaled-down compaction fleet (the four-policy, four-drifted-session design
of the compaction suite, shrunk so the suite re-runs it five times):

  * **overhead** — the fully instrumented engine (spans on flush /
    compaction, per-batch read counters, per-window session events)
    against the disabled path.  Disabled-path calls are a single ``None``
    check, so the tax only exists while a trace is being captured.  The
    ratio of two wall times is printed as time.
  * **identity** — tracing never perturbs results: per-session avg I/O,
    window op counts, and observed mixes are bit-identical between the
    enabled and disabled legs (telemetry only *reads* IOStats deltas).
  * **calibration** — the captured ``session.execute`` spans are enough
    to refit the cost model's profile constants (per-op I/O weights per
    policy, the lazy-leveling fill factor) via
    :mod:`repro_torch.obs.calibrate`, and the fitted model agrees with
    measurement at least as well as the hand-calibrated constants for
    EVERY policy (``claim_fit_ge_hand``).  When ``REPRO_OBS_OUT`` is set
    (the runner's ``--trace DIR``), the calibration artifact is written
    there.

On the card every leg's compactions run ``merge`` and its read batches
``point_read``; nothing runs ``dual_solve`` (the design is pinned).  The
sizes are module constants, read when the suite runs.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from .. import obs
from ..api import (DesignSpec, ExperimentSpec, Row, TrialSpec, WorkloadSpec,
                   run_experiment)
from ..obs.calibrate import calibrate, write_calibration
from .common import own_starts

N_KEYS = 50_000
QUERIES = 2_500
KEY_SPACE = 2 ** 24
RANGE_FRACTION = 1e-3
BITS_PER_ENTRY = 6.0
TTL_FLUSHES = 8
T, FILT_BPE = 6, 4.0
REPS = 2              # timed repetitions per leg (after a shared warmup)
OVERHEAD_BOUND = 1.05

POLICIES = ("klsm", "lazy_leveling", "partial", "tombstone_ttl")
SESSIONS = (
    (0.85, 0.05, 0.05, 0.05),
    (0.05, 0.85, 0.05, 0.05),
    (0.05, 0.05, 0.85, 0.05),
    (0.05, 0.05, 0.05, 0.85),
)
CELL = (0, None)


def make_spec() -> ExperimentSpec:
    """The suite's spec at the module's sizes."""
    return ExperimentSpec(
        name="obs",
        workload=WorkloadSpec(workloads=((0.25, 0.25, 0.25, 0.25),),
                              rhos=(), nominal=True),
        design=DesignSpec(fixed=(float(T), FILT_BPE, 1.0), policies=POLICIES,
                          policy_params=(
                              ("lazy_leveling", (("read_trigger", 512),)),
                              ("partial", (("parts", 4),)),
                              ("tombstone_ttl",
                               (("ttl_flushes", TTL_FLUSHES),)),
                          )),
        trial=TrialSpec(n_keys=N_KEYS, n_queries=QUERIES, sessions=SESSIONS,
                        key_space=KEY_SPACE, range_fraction=RANGE_FRACTION,
                        key_seed=77, session_seeds=(300, 301, 302, 303),
                        delete_fraction=0.01),
        system=(("N", float(N_KEYS)), ("entry_bits", 64.0 * 8),
                ("page_bits", 4096.0 * 8), ("bits_per_entry", BITS_PER_ENTRY),
                ("min_buf_bits", 64.0 * 8 * 64), ("s_rq", RANGE_FRACTION),
                ("max_T", 30.0)),
    )


def _engine_s(report) -> float:
    return float(report.walls["populate_s"] + report.walls["fleet_s"])


def run_leg(traced: bool, device=None):
    """One fleet run with telemetry on/off; returns (report, engine_s,
    telemetry) — the leg's own ``Telemetry`` (its ring and counters), None
    on the disabled leg."""
    with obs.scoped(enabled=traced, clock="wall") as t:
        report = run_experiment(make_spec(), device=device)
    return report, _engine_s(report), t


def _fleet_signature(report):
    """Everything the engine measured, exactly: per-(policy, session)
    avg I/O and the full per-window op-count matrices."""
    sig = {}
    for pol in POLICIES:
        for i, res in enumerate(report.fleet[(CELL, pol)]):
            sig[(pol, i)] = (float(res.avg_io_per_query),
                             np.asarray(res.window_ops).copy())
    return sig


def calibration(events, report, device=None) -> dict:
    """The calibration payload of one traced leg's events."""
    return calibrate(
        events,
        model_costs=report.model_costs[CELL],
        phi_by_policy={p: report.tuning(CELL, p).phi for p in POLICIES},
        sys=report.sys,
        policy_params=report.spec.design.policy_params,
        device=device,
    )


def run(device=None, starts=own_starts) -> List[Row]:
    """The suite on ``device``; it runs no tuner, so ``starts`` is
    unused."""
    rows: List[Row] = []
    run_leg(False, device)                    # warmup: builds, caches
    disabled, enabled = [], []
    events, report_on, report_off = [], None, None
    for _ in range(REPS):
        report_off, s_off, _ = run_leg(False, device)
        disabled.append(s_off)
        report_on, s_on, t = run_leg(True, device)
        enabled.append(s_on)
        events = t.events_snapshot()          # any rep's ring will do
    off_s = float(np.median(disabled))
    on_s = float(np.median(enabled))
    ratio = on_s / off_s
    rows.append(Row(
        "obs_overhead", 0.0,
        overhead_ratio=round(ratio, 4),
        overhead_bound=OVERHEAD_BOUND,
        enabled_engine_s=round(on_s, 3),
        disabled_engine_s=round(off_s, 3),
        reps=REPS,
    ))

    sig_on = _fleet_signature(report_on)
    sig_off = _fleet_signature(report_off)
    identical = sig_on.keys() == sig_off.keys() and all(
        sig_on[k][0] == sig_off[k][0]
        and np.array_equal(sig_on[k][1], sig_off[k][1])
        for k in sig_on)
    rows.append(Row(
        "obs_identity", 0.0,
        claim_bit_identical=bool(identical),
        sessions_compared=len(sig_on),
        trees=len(POLICIES),
    ))

    cal = calibration(events, report_on, device)
    out_dir = os.environ.get("REPRO_OBS_OUT")
    if out_dir:
        write_calibration(os.path.join(out_dir, "calibration_obs.json"), cal)
    lazy = cal["policies"].get("lazy_leveling", {})
    rows.append(Row(
        "obs_calibration", 0.0,
        claim_fit_ge_hand=bool(cal["all_fitted_ge_hand"]),
        policies_fit=len(cal["policies"]),
        closeness_hand={p: f["closeness_hand"]
                        for p, f in cal["policies"].items()},
        closeness_fitted={p: f["closeness_fitted"]
                          for p, f in cal["policies"].items()},
        lazy_fill_hand=lazy.get("fill", {}).get("fill_hand"),
        lazy_fill_fitted=lazy.get("fill", {}).get("fill_fitted"),
    ))

    n_spans = sum(ev.get("kind") == "span" for ev in events)
    rows.append(Row(
        "obs_trace", 0.0,
        events=len(events),
        spans=n_spans,
        session_spans=sum(ev.get("name") == "session.execute"
                          for ev in events),
    ))
    rows.append(Row(
        "obs_fleet", off_s * 1e6,
        n_keys=N_KEYS, n_queries=QUERIES, trees=len(POLICIES),
        sessions_per_tree=len(SESSIONS),
        engine_s=round(off_s, 2),
    ))
    return rows
