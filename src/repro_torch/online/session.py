"""The online loop: interleave fleet execution segments with re-tune
decisions — the port of ``repro/online/session.py``.

:class:`OnlineSession` wraps one deployed :class:`repro_torch.lsm.LSMTree`
with the observe -> estimate -> decide state machine: every executed
segment feeds its per-flush-window op counts (``SessionResult.window_ops``)
into a :class:`~repro_torch.online.estimate.WindowHistory`, the estimator
produces the current mix, and — in ``online`` mode — the
:class:`~repro_torch.online.retune.DriftPolicy` may emit a
:class:`RetuneRequest`.  Tuning swaps land through
:meth:`repro_torch.lsm.LSMTree.retune`, i.e. exactly at flush boundaries,
and the transition compaction they cause is measured workload I/O like any
other.

:func:`execute_drift` is the fleet driver the execution backends call for a
compiled :class:`repro_torch.api.DriftSpec` experiment: it steps every arm
(``stale_nominal`` / ``static_robust`` / ``online`` / ``oracle``) of every
workload through the drift schedule in lockstep — arms of one workload
share the key population and the materialized session plan per segment, so
the comparison is paired — and batches all re-tunes that fire at a segment
boundary (the whole fleet's, across workloads) into ONE
:func:`~repro_torch.online.retune.retune_fleet` storm.  The oracle arm
re-tunes every segment to the *true* upcoming mix; its solves for the
entire schedule are one storm up front.  On the card the trees' compactions
run the ``merge`` kernel, their reads ``point_read``, and the robust storms
``dual_solve``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import obs

from .estimate import (WindowHistory, kl_np, make_estimator,
                       rho_from_windows, smooth_mix)
from .retune import DriftPolicy, RetuneRequest, retune_fleet

#: drift-experiment arms, in report order.
ARMS = ("stale_nominal", "static_robust", "online", "oracle")


@dataclasses.dataclass
class SegmentRecord:
    """One executed segment of an online session."""

    index: int
    true_mix: np.ndarray
    observed_mix: np.ndarray          # executed counts, normalized
    est_mix: np.ndarray               # estimator output after this segment
    kl_est: float                     # I_KL(est_mix, live expected mix)
    rho_live: float                   # budget of the deployed tuning
    avg_io_per_query: float
    queries: int
    windows: int
    retuned: bool = False             # ran under a tuning swapped at start
    retune_reason: str = ""


@dataclasses.dataclass
class DriftArmResult:
    """All segments of one (workload, arm) deployment."""

    widx: int
    arm: str
    records: List[SegmentRecord]

    @property
    def avg_io_per_query(self) -> float:
        q = sum(r.queries for r in self.records)
        return sum(r.avg_io_per_query * r.queries
                   for r in self.records) / max(q, 1)

    @property
    def throughput(self) -> float:
        return 1.0 / max(self.avg_io_per_query, 1e-9)

    @property
    def retunes(self) -> int:
        return sum(r.retuned for r in self.records)


class OnlineSession:
    """Observe -> estimate -> decide around one deployed tree.

    ``mode``: ``"static"`` never re-tunes (it still observes, so drift
    diagnostics are recorded); ``"online"`` emits a :class:`RetuneRequest`
    when the policy fires (the caller executes it — batched across the
    fleet — and calls :meth:`apply`); ``"oracle"`` expects the caller to
    :meth:`apply` the true mix's tuning before every segment."""

    MODES = ("static", "online", "oracle")

    def __init__(self, tree, expected, rho: float, sys, mode: str = "online",
                 policy: Optional[DriftPolicy] = None, estimator=None,
                 capacity: int = 128, f_a: float = 1.0, f_seq: float = 1.0,
                 phi=None):
        if mode not in self.MODES:
            raise ValueError(f"mode {mode!r} not in {self.MODES}")
        self.tree = tree
        self.sys = sys
        self.mode = mode
        self.expected = np.asarray(expected, np.float64)
        self.rho = float(rho)
        #: the deployed tuning's design point — what an adversary scenario
        #: reads to cost its attack; kept current across :meth:`apply`.
        self.phi = phi
        self.policy = policy or DriftPolicy()
        self.estimator = estimator or make_estimator("window")
        #: the policy's optional sequential change-point test; the policy
        #: object is frozen and fleet-shared, so the per-deployment state
        #: (running mean, cumulative statistic) lives here
        self.detector = self.policy.make_detector()
        self.history = WindowHistory(capacity)
        self.records: List[SegmentRecord] = []
        self._since_retune = 10 ** 9
        self._swap_reason: Optional[str] = None
        self._pending: Optional[RetuneRequest] = None
        self.f_a = f_a
        self.f_seq = f_seq

    def execute_segment(self, plan, true_mix, index: int) -> SegmentRecord:
        """Run one materialized session segment and update the loop state."""
        from ..lsm import execute_session
        res = execute_session(self.tree, plan, f_a=self.f_a, f_seq=self.f_seq)
        self.history.append(res.window_ops)
        # smoothed: the estimate serves as a KL center and re-tune target,
        # so zero-count classes must not produce unbounded divergences
        est = smooth_mix(self.estimator.estimate(self.history))
        kl = float(kl_np(est, self.expected))
        rec = SegmentRecord(
            index=index, true_mix=np.asarray(true_mix, np.float64),
            observed_mix=res.observed_mix, est_mix=est, kl_est=kl,
            rho_live=self.rho, avg_io_per_query=res.avg_io_per_query,
            queries=res.queries, windows=len(res.window_ops),
            retuned=self._swap_reason is not None,
            retune_reason=self._swap_reason or "")
        self._swap_reason = None
        self.records.append(rec)
        self._since_retune += 1
        change_point = (self.detector.update(kl)
                        if self.detector is not None else False)
        if self.mode == "online":
            reason = self.policy.decide(kl, self.rho, len(self.history),
                                        self._since_retune,
                                        change_point=change_point)
            if obs.enabled():
                obs.event("drift.decide", segment=index,
                          kl=round(kl, 9), rho_live=round(self.rho, 9),
                          since_retune=min(self._since_retune, 10 ** 9),
                          windows=len(self.history),
                          detector=self.policy.detector,
                          change_point=bool(change_point),
                          reason=reason or "none")
                obs.count("drift.trigger." + (reason or "none"))
            if reason is not None:
                # re-center on the estimate; budget = measured spread of the
                # history around it (Algorithm 1, floored)
                rho_new = rho_from_windows(self.history.counts(), center=est,
                                           floor=self.policy.rho_floor)
                self._pending = RetuneRequest(w=est, rho=rho_new,
                                              reason=reason)
        return rec

    def take_request(self) -> Optional[RetuneRequest]:
        req, self._pending = self._pending, None
        return req

    def apply(self, tuning, w_center, rho: float, reason: str,
              sys=None) -> None:
        """Swap the deployed tuning (at a flush boundary) and re-center the
        drift reference on what the new tuning was derived for.  ``sys``
        replaces the session's live system first — the fleet memory arbiter
        re-tunes a tenant *under a new memory share*, so the system the
        tuning was solved against must land with it."""
        if sys is not None:
            self.sys = sys
        if obs.enabled():
            obs.event("drift.apply", reason=reason, rho=round(float(rho), 9),
                      label=self.tree.obs_label)
            obs.count("drift.retunes")
        self.tree.retune(tuning.phi, self.sys)
        self.phi = tuning.phi
        self.expected = np.asarray(w_center, np.float64)
        self.rho = float(rho)
        self._since_retune = 0
        self._swap_reason = reason
        if self.detector is not None:
            self.detector.reset()    # the change was acted on; re-arm


def execute_drift(plan, device=None, starts=None):
    """Run a compiled drift experiment (:class:`repro_torch.api.compile
    .DriftPlan`); returns ``(results, regret)`` where ``results`` is
    ``{(workload index, arm): DriftArmResult}`` and ``regret`` is
    ``{workload index: [per-segment regret record, ...]}`` — non-empty only
    under an adversary scenario, where each record carries the attacked
    mix, the model costs, and the KL dual bound it must stay under.

    Inherently sequential across segments (the loop is a feedback system),
    so every execution backend runs this same inline driver; within a
    segment boundary all fired re-tunes are one storm.  The trees live on
    ``device`` (``None``: the card), and every storm and every adversary
    solve runs there; ``starts(design, n_starts, seed)``
    (``repro_torch.bench.common``) gives the storms' starts, None the
    tuners' own draw.  Scenario kinds (:mod:`repro_torch.scenarios`) hook
    in at three points: the compiled schedule (already lowered by
    :func:`repro_torch.api.compile.drift_schedule`), the per-segment
    session shaping (query volume, skew/rotation, deletes, scan width),
    and — for the adversary — the per-segment mix itself, re-solved inside
    the defender's live rho-ball."""
    from ..core import DesignSpace
    from ..lsm import LSMTree, draw_keys, materialize_session, populate
    from ..scenarios.adversary import DEFENDER_ORDER
    d = plan.drift
    S = int(d.segments)
    scenario = getattr(plan, "scenario", None)
    adversary = scenario if scenario is not None and scenario.is_adversary \
        else None
    policy = DriftPolicy(kl_threshold=d.kl_threshold,
                         budget_slack=d.budget_slack,
                         min_windows=d.min_windows, cooldown=d.cooldown,
                         rho_floor=d.rho_floor, detector=d.detector,
                         ph_delta=d.ph_delta, ph_lambda=d.ph_lambda,
                         cusum_k=d.cusum_k, cusum_h=d.cusum_h)
    design = getattr(plan, "design", None)
    retune_kw = dict(design=design, n_starts=d.retune_starts,
                     steps=d.retune_steps, seed=d.retune_seed, device=device,
                     starts=None if starts is None else starts(
                         design or DesignSpace.CLASSIC, d.retune_starts,
                         d.retune_seed))

    # -- oracle: the whole schedule's nominal tunings in one storm ----------
    oracle_arms = [a for a in plan.arms if a.arm == "oracle"]
    oracle_tunings: Dict[Tuple[int, int], object] = {}
    if oracle_arms:
        widxs = sorted({a.widx for a in oracle_arms})
        reqs = [RetuneRequest(w=plan.schedules[w][s], rho=0.0,
                              reason="oracle")
                for w in widxs for s in range(S)]
        sols = retune_fleet(reqs, plan.sys, **retune_kw)
        for (w, s), tr in zip(((w, s) for w in widxs for s in range(S)),
                              sols):
            oracle_tunings[(w, s)] = tr

    # -- deploy: per-workload shared key population, one tree per arm -------
    keys: Dict[int, np.ndarray] = {}
    sessions: Dict[Tuple[int, str], OnlineSession] = {}
    for a in plan.arms:
        if a.widx not in keys:
            keys[a.widx] = draw_keys(d.n_keys, seed=d.key_seed + a.widx,
                                     key_space=d.key_space)
        tuning = oracle_tunings[(a.widx, 0)] if a.arm == "oracle" \
            else a.tuning
        tree = LSMTree.from_phi(tuning.phi, plan.sys,
                                expected_entries=d.n_keys,
                                entry_bytes=d.entry_bytes, policy=a.policy,
                                policy_params=a.policy_params, device=device)
        tree.obs_label = f"w{a.widx}.{a.arm}/{a.policy}"
        populate(tree, d.n_keys, key_space=d.key_space, keys=keys[a.widx])
        mode = {"online": "online", "oracle": "oracle"}.get(a.arm, "static")
        expected = plan.schedules[a.widx][0] if a.arm == "oracle" \
            else plan.expected[a.widx]
        sessions[(a.widx, a.arm)] = OnlineSession(
            tree, expected=expected, rho=a.rho, sys=plan.sys, mode=mode,
            policy=policy, phi=tuning.phi,
            estimator=make_estimator(d.estimator, alpha=d.alpha,
                                     window=d.window),
            capacity=d.capacity, f_a=d.f_a, f_seq=d.f_seq)

    # -- the segment loop ---------------------------------------------------
    regret: Dict[int, List[dict]] = {w: [] for w in keys}
    for s in range(S):
        if s > 0:
            for a in oracle_arms:
                sessions[(a.widx, a.arm)].apply(
                    oracle_tunings[(a.widx, s)],
                    w_center=plan.schedules[a.widx][s], rho=0.0,
                    reason="oracle")
        for widx in sorted(keys):
            mix = plan.schedules[widx][s]
            rec = None
            if adversary is not None:
                # attack the preferred deployed arm's live state; every arm
                # then executes the attacked mix (the comparison stays
                # paired — same keys, same session plan)
                defender_arm = next(arm for arm in DEFENDER_ORDER
                                    if (widx, arm) in sessions)
                defender = sessions[(widx, defender_arm)]
                mix, rec = adversary.attack(defender.phi, defender.expected,
                                            defender.rho, plan.sys,
                                            device=device)
            nq = d.n_queries
            extra = {}
            if scenario is not None:
                nq = int(scenario.segment_queries(s))
                extra = dict(scenario.session_kwargs(s, len(keys[widx])))
            rf = float(extra.pop("range_fraction", d.range_fraction))
            splan = materialize_session(
                keys[widx], mix, n_queries=nq,
                seed=d.session_seed + widx * S + s, key_space=d.key_space,
                range_fraction=rf, **extra)
            for a in plan.arms:
                if a.widx == widx:
                    sessions[(widx, a.arm)].execute_segment(splan, mix, s)
            if rec is not None:
                rec["segment"] = s
                rec["widx"] = widx
                rec["defender"] = defender_arm
                rec["measured_io"] = float(
                    defender.records[-1].avg_io_per_query)
                regret[widx].append(rec)
            keys[widx] = np.concatenate([keys[widx], splan.insert_keys])
        fired = [(key, req) for key, sess in sessions.items()
                 for req in [sess.take_request()] if req is not None]
        if fired and s < S - 1:        # a swap after the last segment is moot
            sols = retune_fleet([req for _, req in fired], plan.sys,
                                **retune_kw)
            for (key, req), tr in zip(fired, sols):
                sessions[key].apply(tr, w_center=req.w, rho=req.rho,
                                    reason=req.reason)

    results = {key: DriftArmResult(widx=key[0], arm=key[1],
                                   records=sess.records)
               for key, sess in sessions.items()}
    return results, {w: r for w, r in regret.items() if r}
