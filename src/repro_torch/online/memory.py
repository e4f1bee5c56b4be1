"""Fleet-level adaptive memory arbitration: one byte budget, N tenants —
the port of ``repro/online/memory.py``.

Everywhere else each tree owns a fixed ``(buffer, bloom bits)`` split
chosen at tune time — ``LSMSystem.bits_per_entry`` is a per-tree constant.
This module makes memory a *fleet-level* resource instead: a single global
budget of :class:`MemoryBudget` is divided across N tenants' write buffers
and Bloom/filter memory, and re-divided online as their workload mixes
drift — write-heavy tenants borrow buffer from read-heavy ones.

Three pieces:

* :class:`MemoryBudget` — the budget semantics: a global total (bits per
  tenant-entry), a per-tenant floor, and an allocation quantum that
  discretizes the candidate shares (bounding both the greedy search and the
  number of distinct systems the re-tune storms solve against).
* :func:`divide_budget` + the cost curves — every tenant's marginal benefit
  per quantum is scored by the cost model:
  :func:`repro_torch.core.cost_across_memory` sweeps the tenant's *current*
  tuning across the share grid in one batched cost evaluation, and a
  deterministic greedy water-fill grants each quantum to the tenant whose
  modeled, traffic-weighted cost drops most.
* :class:`FleetArbiter` — the online controller: per-tenant KL drift
  triggers (the :class:`~repro_torch.online.retune.DriftPolicy` contract —
  ``min_windows`` cold-start gate, fleet-level ``cooldown`` hysteresis),
  one re-division when any tenant fires, and re-tune storms grouped by
  granted share (``retune_storm`` solves one system per storm).  New splits
  land through :meth:`repro_torch.lsm.LSMTree.retune` at flush boundaries,
  so transition compaction is charged to measured I/O.

:func:`execute_memory_fleet` is the driver the execution backends call for
a compiled :class:`repro_torch.api.MemorySpec` experiment: a paired
comparison of a ``static`` fleet (the fixed equal split, exactly the
:func:`~repro_torch.online.session.execute_drift` ``static_robust`` path)
against an ``arbitrated`` fleet (initial division from expected mixes,
online re-division on drift) over the same keys and session plans.  With
arbitration disabled the arbitrated fleet never deviates from the equal
split, and its results are bit-identical to the static fleet.  On the card
the trees' compactions run the ``merge`` kernel, their reads
``point_read``, and the robust storms ``dual_solve``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import obs

from .estimate import make_estimator, rho_from_windows, smooth_mix
from .retune import DriftPolicy, RetuneRequest, retune_fleet
from .session import DriftArmResult, OnlineSession

#: memory-experiment fleets, in report order.
MEMORY_ARMS = ("static", "arbitrated")


@dataclasses.dataclass(frozen=True)
class MemoryBudget:
    """The global memory budget and its division semantics.

    All quantities are **bits per tenant-entry** (the unit
    ``LSMSystem.bits_per_entry`` / ``LSMTree.config_from_phi`` already
    speak): a tenant granted share ``b`` deploys under
    ``sys.replace(bits_per_entry=b)``, i.e. ``b * n_keys`` bits split
    between its write buffer and Bloom filters by its own tuning.  With
    equal per-tenant key populations (the fleet driver's convention) this
    is exactly a global byte budget.

    ``total_bpe`` is the fleet-wide sum of shares; ``floor_bpe`` the
    minimum any tenant can be squeezed to (a tree needs *some* buffer and
    filter memory to function); ``quantum_bpe`` the granularity shares move
    in — hysteresis in space, complementing the arbiter's cooldown in time
    (a re-division below one quantum is not worth a transition
    compaction)."""

    total_bpe: float
    floor_bpe: float = 2.0
    quantum_bpe: float = 0.5

    def __post_init__(self):
        if self.floor_bpe <= 0.0:
            raise ValueError("floor_bpe must be > 0")
        if self.quantum_bpe <= 0.0:
            raise ValueError("quantum_bpe must be > 0")

    def validate(self, n_tenants: int) -> None:
        if self.total_bpe < n_tenants * self.floor_bpe - 1e-9:
            raise ValueError(
                f"budget total_bpe={self.total_bpe:g} cannot cover "
                f"{n_tenants} tenants at floor_bpe={self.floor_bpe:g}")

    def units(self, n_tenants: int) -> int:
        """Divisible quanta above the all-at-floor baseline."""
        return int((self.total_bpe - n_tenants * self.floor_bpe)
                   / self.quantum_bpe + 1e-9)

    def grid(self, n_tenants: int) -> np.ndarray:
        """Candidate per-tenant shares: floor, floor + q, ..., floor + Uq
        (one tenant absorbing every free quantum)."""
        return self.floor_bpe + self.quantum_bpe * np.arange(
            self.units(n_tenants) + 1, dtype=np.float64)


def memory_cost_curves(phis: Sequence[object], sys_list: Sequence[object],
                       mixes: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """``(F, G)`` modeled expected cost of tenant ``f``'s current tuning
    re-deployed at grid share ``g``, under its current mix estimate: one
    ``cost_across_memory`` per tenant on its tuning's device, its float32
    ``(G, 4)`` cost vectors taken to float64 before the product with the
    float64 mix."""
    from ..core import cost_across_memory
    M = np.atleast_2d(np.asarray(mixes, np.float64))
    g = np.asarray(grid, np.float32)
    curves = np.empty((len(phis), len(grid)), np.float64)
    for f, (phi, sys_f) in enumerate(zip(phis, sys_list)):
        c = cost_across_memory(phi, sys_f, g).detach().cpu().numpy()
        curves[f] = c.astype(np.float64) @ M[f]             # (G, 4) @ (4,)
    return curves


def divide_budget(curves: np.ndarray, weights: np.ndarray,
                  budget: MemoryBudget) -> np.ndarray:
    """Greedy marginal water-fill of the global budget, deterministic.

    Every tenant starts at the floor; each free quantum goes to the tenant
    with the largest traffic-weighted modeled cost drop for one more grid
    step (``weights[f] * (C[f, g] - C[f, g+1])``), ties to the lowest
    tenant index.  Returns the (F,) shares in bits/entry, summing to
    ``floor + units * quantum`` exactly."""
    F, G = curves.shape
    w = np.asarray(weights, np.float64)
    alloc = np.zeros(F, np.int64)
    for _ in range(budget.units(F)):
        nxt = np.minimum(alloc + 1, G - 1)
        gains = w * (curves[np.arange(F), alloc]
                     - curves[np.arange(F), nxt])
        gains[alloc + 1 >= G] = -np.inf          # at the grid cap
        alloc[int(np.argmax(gains))] += 1
    return budget.floor_bpe + budget.quantum_bpe * alloc.astype(np.float64)


class FleetArbiter:
    """The fleet-level memory controller.

    Holds the budget, the base (equal-split) system, and the drift policy;
    :meth:`initial_shares` divides the budget from the expected mixes at
    deploy time, :meth:`step` watches every tenant's KL drift trigger after
    each executed segment and — when one fires and the fleet-level cooldown
    has passed — re-divides the budget from the current mix estimates and
    re-tunes every affected tenant (share changed, or trigger fired) in
    share-grouped storms.  ``events`` records every division for the
    report.  The storms run on ``device`` (``None``: the card) from the
    starts ``starts(design or CLASSIC, n_starts, seed)`` gives
    (``repro_torch.bench.common``; None draws the tuners' own)."""

    def __init__(self, budget: MemoryBudget, base_sys, policy: DriftPolicy,
                 design=None, n_starts: int = 32, steps: int = 200,
                 lr: float = 0.25, seed: int = 0, device=None, starts=None):
        from ..core import DesignSpace
        self.budget = budget
        self.base_sys = base_sys
        self.policy = policy
        self.design = design
        self.retune_kw = dict(
            design=design, n_starts=n_starts, steps=steps, lr=lr, seed=seed,
            device=device,
            starts=None if starts is None else starts(
                design or DesignSpace.CLASSIC, n_starts, seed))
        self._since = 10 ** 9           # fleet-level cooldown counter
        self.events: List[dict] = []

    # -- division ----------------------------------------------------------

    def sys_for(self, share: float):
        return self.base_sys.replace(bits_per_entry=float(share))

    def arbitrate(self, phis, sys_list, mixes, weights) -> np.ndarray:
        grid = self.budget.grid(len(phis))
        curves = memory_cost_curves(phis, sys_list, mixes, grid)
        return divide_budget(curves, weights, self.budget)

    def initial_shares(self, tunings, expected: np.ndarray) -> np.ndarray:
        """Deploy-time division: no history yet, so the expected mixes are
        the evidence and traffic weights are uniform."""
        F = len(tunings)
        shares = self.arbitrate([t.phi for t in tunings],
                                [self.base_sys] * F,
                                np.asarray(expected, np.float64),
                                np.ones(F))
        self.events.append(dict(segment=-1, reason="initial_division",
                                shares=[float(s) for s in shares],
                                retuned=[]))
        if obs.enabled():
            obs.event("arbiter.division", **self.events[-1])
            obs.count("arbiter.divisions")
        return shares

    # -- the online trigger ------------------------------------------------

    def step(self, sessions: Sequence[OnlineSession], tunings: List[object],
             segment: int) -> Optional[np.ndarray]:
        """One post-segment decision for the arbitrated fleet.

        Returns the new shares when a re-division fired (mutating
        ``sessions`` — swaps applied — and ``tunings`` in place), else
        None.  The per-tenant trigger is exactly the drift loop's
        :meth:`DriftPolicy.decide`; ``cooldown`` hysteresis is fleet-level
        (one re-division resets the whole fleet's counter, so a noisy
        tenant cannot thrash everyone's memory)."""
        self._since += 1
        reasons: Dict[int, str] = {}
        for f, sess in enumerate(sessions):
            rec = sess.records[-1]
            why = self.policy.decide(rec.kl_est, sess.rho,
                                     len(sess.history), self._since)
            if obs.enabled():
                obs.event("arbiter.decide", segment=int(segment), tenant=f,
                          kl=round(float(rec.kl_est), 9),
                          rho_live=round(float(sess.rho), 9),
                          since=min(self._since, 10 ** 9),
                          reason=why or "none")
                obs.count("arbiter.trigger." + (why or "none"))
            if why is not None:
                reasons[f] = why
        if not reasons:
            return None

        F = len(sessions)
        mixes = np.stack([smooth_mix(s.estimator.estimate(s.history))
                          for s in sessions])
        weights = np.array([max(float(s.history.counts().sum()), 1.0)
                            for s in sessions])
        shares = self.arbitrate([t.phi for t in tunings],
                                [s.sys for s in sessions], mixes, weights)

        # re-tune: any tenant whose share moved >= half a quantum, plus any
        # whose own trigger fired (drifted in place — re-center it even if
        # its share held)
        moved = [f for f in range(F)
                 if abs(shares[f] - sessions[f].sys.bits_per_entry)
                 >= 0.5 * self.budget.quantum_bpe]
        retune = sorted(set(moved) | set(reasons))
        by_share: Dict[float, List[int]] = {}
        for f in retune:
            by_share.setdefault(float(shares[f]), []).append(f)
        for share, fs in sorted(by_share.items()):
            sys_f = self.sys_for(share)
            reqs = [RetuneRequest(
                w=mixes[f],
                rho=rho_from_windows(sessions[f].history.counts(),
                                     center=mixes[f],
                                     floor=self.policy.rho_floor),
                reason=reasons.get(f, "rebalance")) for f in fs]
            sols = retune_fleet(reqs, sys_f, **self.retune_kw)
            for f, req, tr in zip(fs, reqs, sols):
                sessions[f].apply(tr, w_center=req.w, rho=req.rho,
                                  reason=req.reason, sys=sys_f)
                tunings[f] = tr
        self._since = 0
        self.events.append(dict(
            segment=int(segment),
            reason=";".join(f"w{f}:{r}" for f, r in sorted(reasons.items())),
            shares=[float(s) for s in shares],
            retuned=[int(f) for f in retune]))
        if obs.enabled():
            obs.event("arbiter.division", **self.events[-1])
            obs.count("arbiter.divisions")
        return shares


def execute_memory_fleet(plan, device=None, starts=None
                         ) -> Tuple[Dict[Tuple[int, str], DriftArmResult],
                                    List[dict]]:
    """Run a compiled memory-arbitration experiment
    (:class:`repro_torch.api.compile.MemoryPlan`); returns
    ``({(tenant index, fleet): DriftArmResult}, division events)``.

    Paired by construction: both fleets share per-tenant key populations
    (seed ``key_seed + widx``) and per-segment session plans (seed
    ``session_seed + widx * S + s``) — the :func:`execute_drift`
    conventions exactly, so the ``static`` fleet is bit-identical to that
    driver's ``static_robust`` arm, and throughput differences between the
    fleets are memory-division differences.  Like the drift loop, the
    segment loop is a feedback system and inherently sequential; every
    backend runs this same inline driver.  The trees live on ``device``
    (``None``: the card) and every storm runs there from the starts
    ``starts(design, n_starts, seed)`` gives.  The trace-shaped scenario
    kinds shape each segment's session as in :func:`execute_drift`."""
    from ..lsm import LSMTree, draw_keys, materialize_session, populate
    d, m = plan.drift, plan.memory
    S = int(d.segments)
    F = len(plan.expected)
    budget = MemoryBudget(
        total_bpe=(m.total_bits_per_entry if m.total_bits_per_entry
                   is not None else F * plan.sys.bits_per_entry),
        floor_bpe=m.floor_bits_per_entry,
        quantum_bpe=m.quantum_bits_per_entry)
    budget.validate(F)
    policy = DriftPolicy(
        kl_threshold=(m.rebalance_kl if m.rebalance_kl is not None
                      else d.kl_threshold),
        budget_slack=d.budget_slack, min_windows=m.min_windows,
        cooldown=m.cooldown, rho_floor=d.rho_floor)
    arbiter = FleetArbiter(budget, plan.sys, policy, design=plan.design,
                           n_starts=d.retune_starts, steps=d.retune_steps,
                           seed=d.retune_seed, device=device, starts=starts)

    # -- initial division + per-tenant (re-)tunes for non-equal shares -----
    shares = np.full(F, plan.sys.bits_per_entry, np.float64)
    tunings = list(plan.tunings)
    if m.enabled:
        shares = arbiter.initial_shares(tunings, plan.expected)
        by_share: Dict[float, List[int]] = {}
        for f in range(F):
            if abs(shares[f] - plan.sys.bits_per_entry) \
                    >= 0.5 * budget.quantum_bpe:
                by_share.setdefault(float(shares[f]), []).append(f)
        for share, fs in sorted(by_share.items()):
            sys_f = arbiter.sys_for(share)
            reqs = [RetuneRequest(w=plan.expected[f], rho=plan.rho0,
                                  reason="initial_division") for f in fs]
            sols = retune_fleet(reqs, sys_f, **arbiter.retune_kw)
            for f, tr in zip(fs, sols):
                tunings[f] = tr
        arbiter.events[-1]["retuned"] = sorted(
            f for fs in by_share.values() for f in fs)

    # -- deploy: shared keys per tenant, one tree per (tenant, fleet) ------
    keys: Dict[int, np.ndarray] = {}
    sessions: Dict[Tuple[int, str], OnlineSession] = {}
    for f in range(F):
        keys[f] = draw_keys(d.n_keys, seed=d.key_seed + f,
                            key_space=d.key_space)
        for arm in MEMORY_ARMS:
            tuning = plan.tunings[f] if arm == "static" else tunings[f]
            sys_f = plan.sys if arm == "static" \
                else arbiter.sys_for(shares[f])
            tree = LSMTree.from_phi(tuning.phi, sys_f,
                                    expected_entries=d.n_keys,
                                    entry_bytes=d.entry_bytes,
                                    policy=plan.policies[f],
                                    policy_params=plan.policy_params[f],
                                    device=device)
            tree.obs_label = f"t{f}.{arm}/{plan.policies[f]}"
            populate(tree, d.n_keys, key_space=d.key_space, keys=keys[f])
            sessions[(f, arm)] = OnlineSession(
                tree, expected=plan.expected[f], rho=plan.rho0, sys=sys_f,
                mode="static", policy=policy,
                estimator=make_estimator(d.estimator, alpha=d.alpha,
                                         window=d.window),
                capacity=d.capacity, f_a=d.f_a, f_seq=d.f_seq)
    arb_sessions = [sessions[(f, "arbitrated")] for f in range(F)]
    arb_tunings = list(tunings)

    # -- the segment loop --------------------------------------------------
    scenario = getattr(plan, "scenario", None)   # trace-shaped kinds only:
    # the spec rejects the adversary on the memory axis (no defender arm)
    for s in range(S):
        for f in range(F):
            mix = plan.schedules[f][s]
            nq = d.n_queries
            extra = {}
            if scenario is not None:
                nq = int(scenario.segment_queries(s))
                extra = dict(scenario.session_kwargs(s, len(keys[f])))
            rf = float(extra.pop("range_fraction", d.range_fraction))
            splan = materialize_session(
                keys[f], mix, n_queries=nq,
                seed=d.session_seed + f * S + s, key_space=d.key_space,
                range_fraction=rf, **extra)
            for arm in MEMORY_ARMS:
                sessions[(f, arm)].execute_segment(splan, mix, s)
            keys[f] = np.concatenate([keys[f], splan.insert_keys])
        if m.enabled and s < S - 1:    # a re-division after the last
            arbiter.step(arb_sessions, arb_tunings, segment=s)

    results = {(f, arm): DriftArmResult(widx=f, arm=arm,
                                        records=sessions[(f, arm)].records)
               for f in range(F) for arm in MEMORY_ARMS}
    return results, arbiter.events
