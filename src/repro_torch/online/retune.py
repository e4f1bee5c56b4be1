"""Drift triggers and the storm-batched re-tune path: the port of
``repro/online/retune.py``.

The *policy* half of the online loop: :class:`DriftPolicy` decides — from
the estimator's current mix and the tuning's expected mix — whether a
deployment's tuning is stale, and :func:`retune_fleet` turns every fired
trigger across a fleet into ONE batched tuner dispatch through
``repro_torch.checkpoint.store.retune_storm`` (workloads on one grid axis,
distinct rhos on the other, power-of-two shape bucketing of the lane
batch).  On the card a robust storm runs the ``dual_solve`` kernel at every
Adam step.

Two triggers, both in KL space (the same divergence the uncertainty region
is defined in):

* **threshold** — the estimated mix drifted more than ``kl_threshold`` nats
  from the mix the live tuning was derived for;
* **budget exhaustion** — the drift exceeds ``budget_slack`` x the live
  tuning's own rho: the executed workload left the uncertainty ball the
  robust tuning was hedged over, so its worst-case guarantee no longer
  covers reality.

``min_windows`` gates both (no re-tuning off a cold estimator) and
``cooldown`` enforces a minimum number of segments between re-tunes
(hysteresis: a re-tune moves the expected mix to the estimate, so a noisy
estimator cannot thrash the solver).

A third, optional trigger lives in *sequence* space rather than KL space:
:class:`PageHinkleyDetector` (Page 1954; Hinkley 1971 — the CUSUM family)
watches the per-segment KL observations as a time series and alarms on a
sustained upward shift of their mean.  Where the KL threshold compares a
*windowed estimate* to a fixed bar — so a short burst is diluted by the
estimator's memory — Page-Hinkley accumulates deviation-above-mean and
alarms when the cumulative excursion since its running minimum exceeds
``lambda``, catching changes whose per-window magnitude never clears the
threshold.  Select it per-experiment with ``DriftSpec.detector =
"page_hinkley"``.

:class:`CusumDetector` (Page 1954) is the classical one-sided upper CUSUM
beside it: ``s_t = max(0, s_{t-1} + x_t - k)`` alarms when ``s_t > h``.
Unlike Page-Hinkley it carries no running mean — the reference level ``k``
is an absolute bar in KL space, so it reacts faster to a level shift but
must be re-centred by hand when the baseline moves.  Select with
``DriftSpec.detector = "cusum"``; every trigger decision is emitted as a
``drift.decide`` telemetry event (:mod:`repro_torch.obs`), so detector
comparisons are trace-diffable."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np

from .. import obs


class PageHinkleyDetector:
    """Page-Hinkley change-point test over a scalar observation stream.

    Maintains the running mean ``x_bar_t`` and the cumulative statistic
    ``m_t = sum_{i<=t} (x_i - x_bar_i - delta)``; alarms when
    ``m_t - min_{i<=t} m_i > lambda`` — i.e. the observations have run
    ``delta``-above their own mean long enough to climb ``lambda`` from the
    deepest trough.  ``delta`` sets the magnitude considered "no change"
    (noise floor), ``lambda`` the evidence required.  Stateful: callers
    (:class:`repro_torch.online.session.OnlineSession`) feed one observation per
    segment and :meth:`reset` after acting on an alarm."""

    def __init__(self, delta: float = 0.005, lam: float = 0.25):
        self.delta = float(delta)
        self.lam = float(lam)
        self.reset()

    def reset(self) -> None:
        self.n = 0
        self.mean = 0.0
        self.m = 0.0
        self.m_min = 0.0

    def update(self, x: float) -> bool:
        """Feed one observation; True when the test alarms."""
        x = float(x)
        self.n += 1
        self.mean += (x - self.mean) / self.n
        self.m += x - self.mean - self.delta
        self.m_min = min(self.m_min, self.m)
        return self.m - self.m_min > self.lam


class CusumDetector:
    """One-sided (upper) CUSUM test over a scalar observation stream.

    ``s_t = max(0, s_{t-1} + x_t - k)``; alarms when ``s_t > h``.  ``k``
    is the reference level (observations below it drain the statistic),
    ``h`` the decision interval.  Same stateful contract as
    :class:`PageHinkleyDetector`: one :meth:`update` per segment,
    :meth:`reset` after an alarm is acted on."""

    def __init__(self, k: float = 0.01, h: float = 0.15):
        self.k = float(k)
        self.h = float(h)
        self.reset()

    def reset(self) -> None:
        self.n = 0
        self.s = 0.0

    def update(self, x: float) -> bool:
        """Feed one observation; True when the test alarms."""
        self.n += 1
        self.s = max(0.0, self.s + float(x) - self.k)
        return self.s > self.h


@dataclasses.dataclass(frozen=True)
class DriftPolicy:
    kl_threshold: float = 0.05
    budget_slack: float = 1.0
    min_windows: int = 2
    cooldown: int = 1
    #: floor for re-derived rho budgets (a steady post-drift history still
    #: keeps a hedge; also keeps the re-tune on the robust solver path)
    rho_floor: float = 0.05
    #: which change signal arms the trigger: "kl" (threshold + budget, the
    #: default), "page_hinkley", or "cusum" (each adds its sequential test
    #: on the per-segment KL stream; both KL triggers stay active)
    detector: str = "kl"
    ph_delta: float = 0.005
    ph_lambda: float = 0.25
    cusum_k: float = 0.01
    cusum_h: float = 0.15

    def make_detector(self
                      ) -> Optional[Union[PageHinkleyDetector,
                                          CusumDetector]]:
        """The stateful sequential detector this policy asks for, or None.
        The policy itself is frozen; the owner (one per deployment) holds
        the detector and feeds it the per-segment KL observations."""
        if self.detector == "page_hinkley":
            return PageHinkleyDetector(delta=self.ph_delta,
                                       lam=self.ph_lambda)
        if self.detector == "cusum":
            return CusumDetector(k=self.cusum_k, h=self.cusum_h)
        return None

    def decide(self, kl_obs: float, rho_live: float, n_windows: int,
               since_retune: int,
               change_point: bool = False) -> Optional[str]:
        """The trigger: a reason string when a re-tune should fire, else
        None.  ``since_retune`` counts segments since the last swap;
        ``change_point`` is the sequential detector's alarm for this
        segment (False when the policy runs KL-only)."""
        if n_windows < self.min_windows or since_retune < self.cooldown:
            return None
        if rho_live > 0.0 and kl_obs > self.budget_slack * rho_live:
            return "budget_exhausted"
        if kl_obs > self.kl_threshold:
            return "kl_threshold"
        if change_point:
            return "change_point"
        return None


@dataclasses.dataclass
class RetuneRequest:
    """One fleet member's fired trigger: re-tune for ``w`` at budget
    ``rho`` (``rho <= 0`` requests the nominal solver — the oracle path)."""

    w: np.ndarray
    rho: float
    reason: str = ""


def retune_fleet(requests: Sequence[RetuneRequest], sys, design=None,
                 n_starts: int = 32, steps: int = 200, lr: float = 0.25,
                 seed: int = 0, device=None, starts=None) -> List[object]:
    """Solve every fired trigger of a fleet in one storm dispatch.

    Thin adapter onto :func:`repro_torch.checkpoint.store.retune_storm`
    (the framework's one batched re-tune path) with shape bucketing
    enabled.  ``design`` pins the design space the deployments were tuned
    in (None = the tuners' default) so a re-tune never swaps a tree across
    spaces; ``device`` and ``starts`` go to the tuners.  Returns one
    ``TuningResult`` per request, in order."""
    from ..checkpoint.store import retune_storm
    if not requests:
        return []
    obs.count("tuner.retune_fleet")
    with obs.span("tuner.retune_fleet", requests=len(requests),
                  reasons=[r.reason for r in requests]):
        W = np.stack([np.asarray(r.w, np.float64) for r in requests])
        rhos = [float(r.rho) for r in requests]
        return retune_storm(W, rhos, sys, seed=seed, design=design,
                            n_starts=n_starts, steps=steps, lr=lr,
                            pad_pow2=True, device=device, starts=starts)
