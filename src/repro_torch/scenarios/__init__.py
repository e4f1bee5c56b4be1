"""Scenario engine: adversarial and trace-shaped workload generators (the
port of ``repro.scenarios``).

A *scenario* is a named stress pattern from real deployments —
heavy-tailed key skew with a migrating hot set, flash crowds, queue-like
tombstone churn, range-scan-dominant analytics — plus an *adversary* that
plays the robust formulation's inner max live: each drift window it solves
``argmax_{w' in U^rho_w} w'^T c`` against the deployed tuning and executes
that worst case, so the paper's KL dual bound becomes a measured claim
(``claim_regret_le_dual_bound``).

Every scenario lowers onto the drift loop: it is a
:class:`repro_torch.api.DriftSpec` ``kind`` whose generator supplies the
per-segment true-mix schedule plus session-plan shaping
(:func:`repro_torch.lsm.materialize_session` kwargs — Zipf exponent and
hot-set offset, per-segment arrival scaling, delete fraction, range-scan
span), so the library runs on the ``inline`` and ``sharded`` backends,
with memory arbitration composing on top, and lands in the same
``Report`` / BENCH schema.

The package is numpy-only at import time (specs load without torch); the
adversary's solver imports torch when it attacks.
"""

from __future__ import annotations

from .adversary import AdversaryScenario
from .base import Scenario
from .library import (BurstStormScenario, ScanHeavyScenario,
                      TombstoneChurnScenario, ZipfMigrateScenario)

#: kind -> generator class; ``DriftSpec.kind`` selects from here.
SCENARIOS = {
    cls.kind: cls
    for cls in (ZipfMigrateScenario, BurstStormScenario,
                TombstoneChurnScenario, ScanHeavyScenario,
                AdversaryScenario)
}

SCENARIO_KINDS = frozenset(SCENARIOS)


def get_scenario(drift) -> "Scenario | None":
    """Instantiate the generator for a drift spec, or None for the classic
    kinds (gradual / flip / cyclic / schedule)."""
    cls = SCENARIOS.get(drift.kind)
    return cls(drift) if cls is not None else None


def validate_scenario_params(kind: str, pairs) -> None:
    """Spec-time validation: every (name, value) pair must be a knob the
    scenario declares (typos surface at construction, not mid-run)."""
    cls = SCENARIOS[kind]
    unknown = sorted(set(dict(pairs)) - set(cls.PARAMS))
    if unknown:
        raise ValueError(f"unknown {kind!r} scenario params {unknown}; "
                         f"known: {sorted(cls.PARAMS)}")


__all__ = ["Scenario", "ZipfMigrateScenario", "BurstStormScenario",
           "TombstoneChurnScenario", "ScanHeavyScenario",
           "AdversaryScenario", "SCENARIOS", "SCENARIO_KINDS",
           "get_scenario", "validate_scenario_params"]
