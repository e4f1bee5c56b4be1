"""Carry the JAX package's tunings across into the port's trial, drift and
memory executors (the tests' helper, not a test module).

The engine and the online loop are bit-exact; the float32 Adam tuners are
not (a 1-ulp difference in a step grows until two starts end in different
integral tunings, ROADMAP.md section 3).  So a test that holds the engine
or the loop against the reference runs both from the SAME tunings: the
reference's, converted here, with every re-tune storm replayed in order.
Storms come from two modules: ``online.session`` (the drift loop) and
``online.memory`` (the memory arbiter, whose storms also differ by the
system they solve against: the granted share).  Under the adversary
scenario the attacked mixes are carried across too: the port's own attack
on the same defender is held to the reference's record to rel 1e-5, and
the reference's mix is executed, so the sessions stay bit for bit.
"""

import contextlib
import dataclasses
from pathlib import Path

import numpy as np

import repro_torch.api as T
import repro_torch.core as TC
from repro_torch.api import compile as tcompile
from repro_torch.convert import phi_from_numpy
from repro_torch.scenarios import AdversaryScenario, get_scenario
from repro_torch.scenarios.adversary import record_mismatches

REPO = Path(__file__).resolve().parents[1]


def port_tuning(r):
    """A reference ``TuningResult`` as the port's (float32 CPU tensors)."""
    if r is None:
        return None
    raw = None if r.raw_phi is None else phi_from_numpy(
        np.asarray(r.raw_phi.T), np.asarray(r.raw_phi.mfilt_bits),
        np.asarray(r.raw_phi.K))
    return TC.TuningResult(
        phi=phi_from_numpy(np.asarray(r.phi.T), np.asarray(r.phi.mfilt_bits),
                           np.asarray(r.phi.K)),
        cost=float(r.cost), design=TC.DesignSpace(r.design.value),
        raw_phi=raw, solver=r.solver)


def port_sys(sys):
    return TC.LSMSystem(**dataclasses.asdict(sys))


def port_spec(spec):
    return T.ExperimentSpec.from_json(spec.to_json())


def port_trial_plan(ref_plan):
    fields = dataclasses.asdict(ref_plan)
    fields["trees"] = [tcompile.TreeBuild(**dataclasses.asdict(b))
                       for b in ref_plan.trees]
    return tcompile.TrialPlan(**fields)


def port_drift_plan(ref_plan, spec):
    """The reference's compiled ``DriftPlan`` as the port's: the same arms
    (the reference's tunings), mixes, schedules and system."""
    arms = [tcompile.DriftArmInit(widx=a.widx, arm=a.arm,
                                  tuning=port_tuning(a.tuning), rho=a.rho,
                                  policy=a.policy,
                                  policy_params=a.policy_params)
            for a in ref_plan.arms]
    drift = port_spec(spec).drift
    return tcompile.DriftPlan(
        arms=arms, expected=np.asarray(ref_plan.expected),
        schedules=np.asarray(ref_plan.schedules), drift=drift,
        sys=port_sys(ref_plan.sys),
        design=TC.DesignSpace(ref_plan.design.value),
        scenario=get_scenario(drift))


def port_memory_plan(ref_plan, spec):
    """The reference's compiled ``MemoryPlan`` as the port's: the same
    tenants (the reference's tunings), arms, mixes, schedules, budget spec
    and system."""
    tspec = port_spec(spec)
    return tcompile.MemoryPlan(
        tunings=[port_tuning(t) for t in ref_plan.tunings],
        policies=list(ref_plan.policies),
        policy_params=list(ref_plan.policy_params), rho0=ref_plan.rho0,
        expected=np.asarray(ref_plan.expected),
        schedules=np.asarray(ref_plan.schedules), drift=tspec.drift,
        memory=tspec.memory, sys=port_sys(ref_plan.sys),
        design=TC.DesignSpace(ref_plan.design.value),
        scenario=get_scenario(tspec.drift))


@contextlib.contextmanager
def recorded_storms(session_module):
    """Record every ``retune_fleet`` storm a run makes through
    ``session_module`` (the reference's or the port's ``online.session``
    or ``online.memory``): a list of ``(requests, results, sys)``."""
    storms = []
    real = session_module.retune_fleet

    def record(requests, sys, **kw):
        out = real(requests, sys, **kw)
        storms.append((list(requests), list(out), sys))
        return out

    session_module.retune_fleet = record
    try:
        yield storms
    finally:
        session_module.retune_fleet = real


@contextlib.contextmanager
def replayed_storms(session_module, storms, convert=port_tuning):
    """Answer the port's storms with recorded ones, in order; each storm's
    requests must equal the recorded storm's (mix, budget and reason, bit
    for bit), and its system's ``bits_per_entry`` (the share a memory
    storm solves under) the recorded one's.  Yields the list of storms
    replayed."""
    real = session_module.retune_fleet
    done = []

    def replay(requests, sys, **kw):
        want, results, want_sys = storms[len(done)]
        assert float(sys.bits_per_entry) == float(want_sys.bits_per_entry)
        assert len(requests) == len(want)
        for got, ref in zip(requests, want):
            np.testing.assert_array_equal(np.asarray(got.w),
                                          np.asarray(ref.w))
            assert (float(got.rho), got.reason) == (float(ref.rho),
                                                    ref.reason)
        done.append(requests)
        return [convert(r) for r in results]

    session_module.retune_fleet = replay
    try:
        yield done
    finally:
        session_module.retune_fleet = real
    assert len(done) == len(storms), "a recorded storm was not replayed"


@contextlib.contextmanager
def recorded_attacks(adversary_cls):
    """Record every ``adversary_cls.attack`` (the reference's or the
    port's ``AdversaryScenario``): a list of ``(inputs, (mix, record))``,
    the inputs as ``(T, mfilt_bits, K, w_center, rho_live)`` in numpy."""
    attacks = []
    real = adversary_cls.attack

    def record(self, phi, w_center, rho_live, sys, **kw):
        out = real(self, phi, w_center, rho_live, sys, **kw)
        attacks.append((attack_inputs(phi, w_center, rho_live),
                        (np.array(out[0]), dict(out[1]))))
        return out

    adversary_cls.attack = record
    try:
        yield attacks
    finally:
        adversary_cls.attack = real


def attack_inputs(phi, w_center, rho_live):
    return (np.asarray(phi.T, np.float32).copy(),
            np.asarray(phi.mfilt_bits, np.float32).copy(),
            np.asarray(phi.K, np.float32).copy(),
            np.array(w_center, np.float64), float(rho_live))


def assert_records_close(got, want, rtol=1e-5):
    """Two regret records agree by the port's one rule
    (:func:`repro_torch.scenarios.adversary.record_mismatches`)."""
    bad = record_mismatches(got, want, rtol)
    assert not bad, {k: (got.get(k), want.get(k)) for k in bad}


@contextlib.contextmanager
def replayed_attacks(attacks, rtol=1e-5):
    """Answer the port's attacks with recorded ones, in order: each attack
    must come from the recorded defender state (its tuning, center and
    budget bit for bit); the port's own attack is computed on it and held
    to the recorded record to ``rtol``, and the recorded mix and record
    are returned.  Yields the port's own ``(mix, record)`` per attack."""
    real = AdversaryScenario.attack
    own = []

    def replay(self, phi, w_center, rho_live, sys, device=None):
        inputs, (mix, rec) = attacks[len(own)]
        for a, b in zip(attack_inputs(phi, w_center, rho_live), inputs):
            np.testing.assert_array_equal(a, b)
        got = real(self, phi, w_center, rho_live, sys, device=device)
        assert_records_close(got[1], rec, rtol)
        np.testing.assert_allclose(got[0], mix, rtol=rtol, atol=1e-7)
        own.append(got)
        return np.array(mix), dict(rec)

    AdversaryScenario.attack = replay
    try:
        yield own
    finally:
        AdversaryScenario.attack = real
    assert len(own) == len(attacks), "a recorded attack was not replayed"


@contextlib.contextmanager
def retune_calls(tree_cls):
    """Record every ``tree_cls.retune`` call (the reference's or the
    port's ``LSMTree``), noop or not: a list of (tree label, engine config
    as a dict) after each call."""
    calls = []
    real = tree_cls.retune

    def retune(tree, phi, sys):
        real(tree, phi, sys)
        calls.append((tree.obs_label, dataclasses.asdict(tree.cfg)))

    tree_cls.retune = retune
    try:
        yield calls
    finally:
        tree_cls.retune = real


def record_fields(rec):
    """A ``SegmentRecord`` as plain, comparable values."""
    d = dataclasses.asdict(rec)
    return {k: (np.asarray(v).tolist() if isinstance(v, np.ndarray) else v)
            for k, v in d.items()}


def drift_records(results):
    """``{(widx, arm): [record fields, ...]}`` of a drift run."""
    return {key: [record_fields(r) for r in res.records]
            for key, res in results.items()}


def port_report(ref, fleet=None, drift=None, memory=None,
                memory_events=None, regret=None):
    """The port's ``Report`` holding the reference report's tunings, arms,
    costs and walls, with the port's own ``fleet`` (trial results),
    ``drift`` (drift results) and ``regret`` or ``memory`` and
    ``memory_events`` (memory results) when given, else the reference's
    fleet."""
    from repro_torch.api import report as treport
    return treport.Report(
        spec=port_spec(ref.spec), sys=port_sys(ref.sys), cells=ref.cells,
        tunings={c: {p: port_tuning(r) for p, r in arms.items()}
                 for c, arms in ref.tunings.items()},
        arm_costs=ref.arm_costs, chosen=ref.chosen,
        model_costs=ref.model_costs, bench_costs=ref.bench_costs,
        bench_set=ref.bench_set,
        fleet=ref.fleet if fleet is None else fleet,
        drift={} if drift is None else drift,
        regret={} if regret is None else regret,
        memory={} if memory is None else memory,
        memory_events=[] if memory_events is None else memory_events,
        walls=dict(ref.walls))


def baseline_of(rows):
    """Rows as a ``BENCH_<suite>.json`` payload the runner's ``compare``
    takes (a live reading held like a committed file)."""
    from repro_torch.api.report import jsonable
    return {"rows": [{"name": r.name, "derived": jsonable(r.derived)}
                     for r in rows]}
