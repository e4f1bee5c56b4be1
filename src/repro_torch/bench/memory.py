"""Fleet memory arbitration: one shared budget, divided where it pays.

The fixed deployment gives every tenant an equal slice of the fleet's
memory (``bits_per_entry``), set at tune time.  The arbitration loop
(:mod:`repro_torch.online.memory`) scores marginal cost-model benefit per
byte per tenant, re-divides the shared budget when the drift loop's KL
triggers fire, and re-tunes the moved tenants — this suite measures
whether that buys fleet throughput on the executable engine, as a paired
comparison: a ``static`` fleet on the equal split vs an ``arbitrated``
fleet on the same traffic (identical key populations and session plans,
drift-arm seed conventions).  On the card the trees' compactions run
``merge``, their reads ``point_read``, and the first tunings and every
robust re-tune storm ``dual_solve``.

Scenarios (2 tenants each, 50k keys x 8 segments x 500 queries):

* ``skew_flip`` — a write-heavy tenant (w4) next to a read-bimodal one;
  mid-run the write-heavy tenant flips read-heavy.  The initial division
  drains filter memory from the write-heavy tenant (filters buy reads
  continuously; the write cost only moves when ceil(L) steps), and the
  flip fires KL-triggered re-divisions that re-score the moved tenant.
* ``skew_gradual`` — the same skewed start, gradually rotating toward a
  trimodal read mix: the division must track a moving target.

Claims: on every scenario the arbitrated fleet's throughput >= the static
split's, and with ``enabled: false`` the arbitrated fleet is
*bit-identical* to the static one (the fixed-split path is untouched when
the feature is off).
"""

from __future__ import annotations

from typing import List

from ..api import (DesignSpec, DriftSpec, ExperimentSpec, MemorySpec, Row,
                   WorkloadSpec, run_experiment)
from .common import own_starts

N_KEYS = 50_000
SEGMENTS = 8
SEG_QUERIES = 500
KEY_SPACE = 2 ** 24
RANGE_FRACTION = 1e-3
BITS_PER_ENTRY = 6.0          # the equal split each tenant starts from
#: the disabled-arbitration check's size
DISABLED_SIZES = dict(n_keys=6_000, segments=3, seg_queries=200)

#: the fleet: a write-heavy tenant next to a read-bimodal one — maximal
#: skew in where marginal memory pays (filters buy read classes
#: continuously, so the arbiter drains the write-heavy tenant's share).
TENANTS = ((0.01, 0.01, 0.01, 0.97), (0.49, 0.49, 0.01, 0.01))

#: (drift kind, shared drift target).  The target is near the read
#: tenant's own mix, so under ``flip`` the read tenant's traffic barely
#: moves while the write tenant flips read-heavy — a single-tenant shift
#: the arbiter must answer with a re-division.
SCENARIOS = (
    ("skew_flip", (0.45, 0.45, 0.09, 0.01)),
    ("skew_gradual", (0.33, 0.33, 0.33, 0.01)),
)

SYSTEM = (("N", float(N_KEYS)), ("entry_bits", 64.0 * 8),
          ("page_bits", 4096.0 * 8), ("bits_per_entry", BITS_PER_ENTRY),
          ("min_buf_bits", 64.0 * 8 * 64), ("s_rq", 2e-5),
          ("max_T", 30.0))


def make_spec(kind: str, target, enabled: bool = True,
              n_keys: int = N_KEYS, segments: int = SEGMENTS,
              seg_queries: int = SEG_QUERIES) -> ExperimentSpec:
    drift_kind = "flip" if kind.endswith("flip") else "gradual"
    return ExperimentSpec(
        name=f"memory_{kind}",
        workload=WorkloadSpec(workloads=TENANTS, nominal=False,
                              rhos=(0.5,)),
        design=DesignSpec(seed=0),
        drift=DriftSpec(kind=drift_kind, segments=segments,
                        n_queries=seg_queries, target=tuple(target),
                        n_keys=n_keys, key_space=KEY_SPACE,
                        range_fraction=RANGE_FRACTION, key_seed=100,
                        arms=("static_robust",), estimator="window",
                        window=4, capacity=64, kl_threshold=0.2,
                        budget_slack=1.0, min_windows=2, cooldown=2,
                        retune_starts=32, retune_steps=200),
        memory=MemorySpec(enabled=enabled, floor_bits_per_entry=2.0,
                          quantum_bits_per_entry=1.0, min_windows=2,
                          cooldown=2),
        system=SYSTEM)


def record_tuple(rec):
    """The fields of a segment record the disabled check compares."""
    return (rec.index, rec.avg_io_per_query, rec.queries, rec.windows,
            tuple(rec.observed_mix.tolist()))


def disabled_identical(report) -> bool:
    """``enabled: false`` must leave the fixed-split path bit-identical:
    both fleets of a disabled run give the same per-segment records, and
    the arbiter records no division."""
    if report.memory_events:
        return False
    for f in range(len(TENANTS)):
        static = report.memory[(f, "static")].records
        arb = report.memory[(f, "arbitrated")].records
        if [record_tuple(r) for r in static] \
                != [record_tuple(r) for r in arb]:
            return False
    return True


def specs() -> list:
    """``[(kind, spec), ...]`` for every scenario at the module's sizes,
    then ``("disabled", spec)`` for the disabled check."""
    out = [(kind, make_spec(kind, target, n_keys=N_KEYS, segments=SEGMENTS,
                            seg_queries=SEG_QUERIES))
           for kind, target in SCENARIOS]
    out.append(("disabled", make_spec("skew_flip", SCENARIOS[0][1],
                                      enabled=False, **DISABLED_SIZES)))
    return out


def scenario_reports(device=None, starts=own_starts) -> list:
    """``[(kind, report), ...]``: each of :func:`specs`'
    ``run_experiment``."""
    return [(kind, run_experiment(spec, device=device, starts=starts))
            for kind, spec in specs()]


def rows_of(reports) -> List[Row]:
    """The suite's rows from :func:`scenario_reports`."""
    rows: List[Row] = []
    speedups = []
    ordered = []
    engine_s = tuning_s = 0.0
    by_kind = dict(reports)
    for kind, _ in SCENARIOS:
        report = by_kind[kind]
        tp_static = report.memory_fleet_throughput("static")
        tp_arb = report.memory_fleet_throughput("arbitrated")
        speedup = tp_arb / max(tp_static, 1e-9)
        speedups.append(speedup)
        ordered.append(tp_arb >= tp_static * 0.999)
        engine_s += report.walls["memory_s"]
        tuning_s += report.walls["tuning_s"]
        final_shares = report.memory_events[-1]["shares"] \
            if report.memory_events else []
        rows.append(Row(
            f"memory_{kind}", 0.0,
            tp_static=round(tp_static, 4),
            tp_arbitrated=round(tp_arb, 4),
            fleet_speedup=round(speedup, 4),
            divisions=len(report.memory_events),
            redivisions=len([e for e in report.memory_events
                             if e["segment"] >= 0]),
            final_shares=[round(s, 2) for s in final_shares],
            arbitrated_retunes=sum(
                report.memory[(f, "arbitrated")].retunes
                for f in range(len(TENANTS))),
            claim_arbitrated_ge_static=ordered[-1],
            segment_io_static=[
                round(r.avg_io_per_query, 3)
                for f in range(len(TENANTS))
                for r in report.memory[(f, "static")].records],
            segment_io_arbitrated=[
                round(r.avg_io_per_query, 3)
                for f in range(len(TENANTS))
                for r in report.memory[(f, "arbitrated")].records],
        ))
    rows.append(Row(
        "memory_fleet", engine_s * 1e6,
        n_keys=N_KEYS, segments=SEGMENTS, seg_queries=SEG_QUERIES,
        tenants=len(TENANTS), scenarios=len(SCENARIOS), fleets=2,
        total_bits_per_entry=len(TENANTS) * BITS_PER_ENTRY,
        tuning_s=round(tuning_s, 2), engine_s=round(engine_s, 2),
    ))
    rows.append(Row(
        "memory_summary", 0.0,
        fleet_speedup_min=round(min(speedups), 4),
        claim_arbitrated_ge_static=all(ordered),
        claim_disabled_identical=disabled_identical(by_kind["disabled"]),
    ))
    return rows


def run(device=None, starts=own_starts) -> List[Row]:
    return rows_of(scenario_reports(device=device, starts=starts))
