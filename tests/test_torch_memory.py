"""The port's fleet memory arbitration (``repro_torch.online.memory``) and
the API's memory axis against the JAX package's (``repro.online.memory``,
``repro.api``), on the CPU.

* The budget: ``MemoryBudget``'s grid, units and validation errors equal
  the reference's.
* The division: ``divide_budget`` on seeded random curves (ties and the
  grid cap included) gives the reference's shares exactly;
  ``memory_cost_curves`` for the reference's tunings carried across
  agrees to rel 1e-5, and ``FleetArbiter.initial_shares`` is exact.
* The loop: ``execute_memory_fleet`` on a small ``skew_flip`` spec from
  the reference's compiled plan, its tunings carried across and every
  storm replayed (each storm's share checked too), gives every segment
  record, every division event and every ``LSMTree.retune`` call bit for
  bit, and the reference's report rows.  With arbitration disabled the
  arbitrated fleet is the static one, and the static fleet is
  ``execute_drift``'s ``static_robust`` arm, record for record.
* The API: ``run_experiment`` with a memory spec runs on the inline and
  the sharded backend (three ``"cpu"`` devices) to the same report; a
  scenario plan (``tombstone_churn``) runs, bit for bit with the
  reference's tunings carried across.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.api as R
import repro.online as RO
import repro_torch.api as T
import repro_torch.online as TO
from repro.api import compile as rcompile
from repro.lsm import LSMTree as RTree
from repro.online import memory as rmemory
from repro_torch.api import report as treport
from repro_torch.bench import memory as tmemory
from repro_torch.lsm import LSMTree as TTree
from repro_torch.online import memory as tmem

import torch_carry as carry


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The storms' lane batches are small: torch's intra-op threads gain
    nothing on them and, beside other busy test processes, spin-wait."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The budget and its division
# ---------------------------------------------------------------------------

BUDGETS = [dict(total_bpe=12.0), dict(total_bpe=12.0, floor_bpe=2.0,
                                      quantum_bpe=1.0),
           dict(total_bpe=7.3, floor_bpe=1.5, quantum_bpe=0.7),
           dict(total_bpe=6.0, floor_bpe=3.0, quantum_bpe=0.25)]


@pytest.mark.parametrize("kw", BUDGETS)
def test_memory_budget_grid_and_units(kw):
    r, t = RO.MemoryBudget(**kw), TO.MemoryBudget(**kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(r)
    for n in (1, 2, 3):
        if r.total_bpe < n * r.floor_bpe - 1e-9:
            continue
        assert t.units(n) == r.units(n)
        np.testing.assert_array_equal(t.grid(n), r.grid(n))
        assert t.grid(n).dtype == r.grid(n).dtype == np.float64


@pytest.mark.parametrize("kw", [dict(total_bpe=8.0, floor_bpe=0.0),
                                dict(total_bpe=8.0, quantum_bpe=-1.0)])
def test_memory_budget_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError) as want:
        RO.MemoryBudget(**kw)
    with pytest.raises(ValueError) as got:
        TO.MemoryBudget(**kw)
    assert str(got.value) == str(want.value)


def test_memory_budget_validate_as_the_reference():
    r, t = RO.MemoryBudget(5.0), TO.MemoryBudget(5.0)
    r.validate(2)
    t.validate(2)
    with pytest.raises(ValueError) as want:
        r.validate(3)
    with pytest.raises(ValueError) as got:
        t.validate(3)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", range(6))
def test_divide_budget_is_the_reference_s_exactly(seed):
    rng = np.random.default_rng(seed)
    F = int(rng.integers(2, 6))
    budget = dict(total_bpe=float(F * rng.integers(3, 8)),
                  floor_bpe=float(rng.choice([1.0, 2.0])),
                  quantum_bpe=float(rng.choice([0.5, 1.0])))
    G = RO.MemoryBudget(**budget).units(F) + 1
    # decreasing curves with random marginals; seed 0 makes two tenants'
    # curves equal (ties go to the lowest index), odd seeds cut the grid
    # short, so tenants reach its cap (the -inf gain) while the fleet's
    # grid still holds every quantum
    curves = np.cumsum(-rng.exponential(1.0, (F, G)), axis=1) + 50.0
    if seed == 0:
        curves[1] = curves[0]
    if seed % 2:
        units = G - 1
        curves = curves[:, :min(G, -(-units // (F - 1)) + 1)]
    weights = rng.uniform(0.5, 3.0, F) if seed % 3 else np.ones(F)
    want = rmemory.divide_budget(curves, weights, RO.MemoryBudget(**budget))
    got = tmem.divide_budget(curves, weights, TO.MemoryBudget(**budget))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# A small skew_flip run in the reference, carried across
# ---------------------------------------------------------------------------

#: the memory suite's skew_flip at 8,000 keys, 4 segments of 300 queries,
#: with a smaller first tuning and smaller storms; the run divides the
#: budget (two storms, one per granted share) and re-divides after the flip
SMALL = dict(n_keys=8_000, segments=4, seg_queries=300)


def _small_spec(enabled=True):
    spec = tmemory.make_spec("skew_flip", tmemory.SCENARIOS[0][1],
                             enabled=enabled, **SMALL)
    return dataclasses.replace(
        spec, design=T.DesignSpec(n_starts=16, steps=60, seed=0),
        drift=dataclasses.replace(spec.drift, retune_starts=8,
                                  retune_steps=40))


@pytest.fixture(scope="module")
def small_memory():
    """The reference's run of the small spec (its storms and
    ``LSMTree.retune`` calls recorded), and the port's
    ``execute_memory_fleet`` from its plan, every storm replayed."""
    spec = carry.port_spec(_small_spec())            # the JAX text, loaded
    rspec = R.ExperimentSpec.from_json(spec.to_json())
    with jax.threefry_partitionable(False), \
            carry.recorded_storms(rmemory) as storms, \
            carry.retune_calls(RTree) as rcalls:
        ref = R.run_experiment(rspec)
    rplan = rcompile.compile_spec(rspec).build_memory(ref)
    plan = carry.port_memory_plan(rplan, rspec)
    with carry.replayed_storms(tmem, storms) as done, \
            carry.retune_calls(TTree) as tcalls:
        results, events = TO.execute_memory_fleet(plan, device="cpu")
    return dict(ref=ref, rspec=rspec, rplan=rplan, plan=plan, storms=storms,
                replayed=done, results=results, events=events, rcalls=rcalls,
                tcalls=tcalls)


def test_execute_memory_fleet_with_the_reference_tunings_is_bit_identical(
        small_memory):
    d = small_memory
    ref = d["ref"]
    assert list(d["results"]) == list(ref.memory)
    assert carry.drift_records(d["results"]) \
        == carry.drift_records(ref.memory)
    assert d["events"] == ref.memory_events
    assert d["tcalls"] == d["rcalls"] and len(d["tcalls"]) >= 1
    # the initial division's two storms (one per granted share) and the
    # re-division's, each replayed under its share
    assert len(d["replayed"]) == len(d["storms"]) >= 3
    assert len({float(s.bits_per_entry) for _, _, s in d["storms"]}) == 2
    assert [e["segment"] for e in ref.memory_events][:1] == [-1]
    assert any(e["segment"] >= 0 for e in ref.memory_events)
    for key, res in ref.memory.items():
        assert d["results"][key].retunes == res.retunes
        assert d["results"][key].avg_io_per_query == res.avg_io_per_query


def test_memory_report_rows_are_the_reference_s(small_memory):
    """``Report.memory`` / ``memory_events``, ``memory_fleet_throughput``
    and the ``{name}_memory_w{widx}_{fleet}`` / ``{name}_memory_fleet``
    rows over the carried-across results print the reference's rows."""
    ref = small_memory["ref"]
    port = carry.port_report(ref, memory=small_memory["results"],
                             memory_events=small_memory["events"])
    for fleet in TO.MEMORY_ARMS:
        assert port.memory_fleet_throughput(fleet) \
            == ref.memory_fleet_throughput(fleet)
    want = {r.name: r.csv() for r in ref.rows() if "_memory_" in r.name}
    got = {r.name: r.csv() for r in port.rows() if "_memory_" in r.name}
    assert len(want) == 5 and got == want


def test_build_memory_lowers_as_the_reference(small_memory):
    """From the same tunings, the port's ``build_memory`` gives the
    reference's tenants, arms, budget, mixes and schedules."""
    ref, rplan = small_memory["ref"], small_memory["rplan"]
    tspec = carry.port_spec(small_memory["rspec"])
    cx = T.compile_spec(tspec)
    report = treport.Report(
        spec=tspec, sys=cx.sys, cells=ref.cells,
        tunings={c: {p: carry.port_tuning(r) for p, r in arms.items()}
                 for c, arms in ref.tunings.items()},
        arm_costs=ref.arm_costs, chosen=ref.chosen,
        model_costs=ref.model_costs)
    plan = cx.build_memory(report)
    assert [f.name for f in dataclasses.fields(plan)] \
        == [f.name for f in dataclasses.fields(rplan)]
    assert (plan.policies, plan.policy_params, plan.rho0) \
        == (rplan.policies, rplan.policy_params, rplan.rho0)
    for a, b in zip(plan.tunings, rplan.tunings):
        np.testing.assert_array_equal(a.phi.K.numpy(), np.asarray(b.phi.K))
        assert float(a.phi.T) == float(np.asarray(b.phi.T))
    np.testing.assert_array_equal(plan.schedules, rplan.schedules)
    np.testing.assert_array_equal(plan.expected, rplan.expected)
    assert dataclasses.asdict(plan.memory) == dataclasses.asdict(rplan.memory)
    assert dataclasses.asdict(plan.sys) == dataclasses.asdict(rplan.sys)
    assert plan.design.value == rplan.design.value and plan.scenario is None


def test_memory_cost_curves_for_the_reference_tunings(small_memory):
    """Every tuning the reference's run deployed (first and re-tuned),
    under the base system and each granted share's, on the budget grid:
    the port's curves to rel 1e-5 of the reference's."""
    tunings = list(small_memory["rplan"].tunings) \
        + [r for _, results, _ in small_memory["storms"] for r in results]
    rsys = small_memory["rplan"].sys
    budget = RO.MemoryBudget(12.0, 2.0, 1.0)
    grid = budget.grid(len(tunings))
    rng = np.random.default_rng(5)
    mixes = rng.dirichlet(np.ones(4), len(tunings))
    for share in (6.0, 2.0, 10.0):
        rs = [rsys.replace(bits_per_entry=share)] * len(tunings)
        ts = [carry.port_sys(s) for s in rs]
        want = rmemory.memory_cost_curves([t.phi for t in tunings], rs,
                                          mixes, grid)
        got = tmem.memory_cost_curves(
            [carry.port_tuning(t).phi for t in tunings], ts, mixes, grid)
        assert got.shape == want.shape and got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_initial_shares_are_the_reference_s(small_memory):
    """``FleetArbiter.initial_shares`` from the reference's first tunings:
    the same shares and the same event, for the suite's budget and two
    others."""
    rplan = small_memory["rplan"]
    policy = dict(kl_threshold=0.2, min_windows=2, cooldown=2)
    for kw in (dict(total_bpe=12.0, floor_bpe=2.0, quantum_bpe=1.0),
               dict(total_bpe=12.0, floor_bpe=2.0, quantum_bpe=0.5),
               dict(total_bpe=9.0, floor_bpe=3.0, quantum_bpe=0.25)):
        ra = RO.FleetArbiter(RO.MemoryBudget(**kw), rplan.sys,
                             RO.DriftPolicy(**policy))
        ta = TO.FleetArbiter(TO.MemoryBudget(**kw),
                             carry.port_sys(rplan.sys),
                             TO.DriftPolicy(**policy), device="cpu")
        want = ra.initial_shares(rplan.tunings, rplan.expected)
        got = ta.initial_shares([carry.port_tuning(t)
                                 for t in rplan.tunings], rplan.expected)
        np.testing.assert_array_equal(got, want)
        assert ta.events == ra.events


def test_disabled_arbitration_is_the_static_fleet_and_drift_s_arm(
        small_memory):
    """With ``enabled=False`` (the reference's plan, its tunings carried
    across) the arbitrated fleet gives the static fleet's records bit for
    bit and no division; and the static fleet is ``execute_drift``'s
    ``static_robust`` arm on the same tunings."""
    from repro_torch.api import compile as tcompile
    plan = dataclasses.replace(
        small_memory["plan"],
        memory=dataclasses.replace(small_memory["plan"].memory,
                                   enabled=False))
    with carry.replayed_storms(tmem, []):
        results, events = TO.execute_memory_fleet(plan, device="cpu")
    assert events == []
    for f in range(len(tmemory.TENANTS)):
        assert carry.drift_records({0: results[(f, "static")]}) \
            == carry.drift_records({0: results[(f, "arbitrated")]})
    assert tmemory.disabled_identical(carry.port_report(
        small_memory["ref"], memory=results, memory_events=events))
    # the static fleet of the enabled run too: it never re-tunes
    assert carry.drift_records(
        {k: v for k, v in small_memory["results"].items()
         if k[1] == "static"}) \
        == carry.drift_records({k: v for k, v in results.items()
                                if k[1] == "static"})
    drift = tcompile.DriftPlan(
        arms=[tcompile.DriftArmInit(widx=f, arm="static_robust",
                                    tuning=plan.tunings[f], rho=plan.rho0,
                                    policy=plan.policies[f],
                                    policy_params=plan.policy_params[f])
              for f in range(len(plan.tunings))],
        expected=plan.expected, schedules=plan.schedules, drift=plan.drift,
        sys=plan.sys, design=plan.design)
    robust, _ = TO.execute_drift(drift, device="cpu")
    for f in range(len(plan.tunings)):
        assert carry.drift_records({0: robust[(f, "static_robust")]}) \
            == carry.drift_records({0: results[(f, "static")]})


def test_run_experiment_memory_on_the_inline_and_sharded_backends():
    """``run_experiment`` with a memory spec (the port's own starts, a few
    steps): both fleets of both tenants, the division events and
    ``walls["memory_s"]``, and no drift arm; the sharded backend (three
    ``"cpu"`` devices) gives the same report, row for row."""
    spec = dataclasses.replace(
        _small_spec(), design=T.DesignSpec(n_starts=4, steps=20, seed=1),
        drift=dataclasses.replace(_small_spec().drift, retune_starts=4,
                                  retune_steps=10, n_keys=4000))
    inline = T.run_experiment(spec, device="cpu")
    sharded = T.run_experiment(spec, T.ShardedBackend(devices=["cpu"] * 3),
                               device="cpu")
    assert sorted(inline.memory) == [(f, arm) for f in range(2)
                                     for arm in sorted(TO.MEMORY_ARMS)]
    assert inline.drift == {} and inline.memory_events
    assert inline.walls["memory_s"] > 0 and "memory_s" in sharded.walls
    assert sharded.walls["tuning_devices"] == 3
    assert carry.drift_records(sharded.memory) \
        == carry.drift_records(inline.memory)
    assert sharded.memory_events == inline.memory_events
    timed = ("_walls",)
    assert [(r.name, r.derived) for r in sharded.rows()
            if not r.name.endswith(timed)] \
        == [(r.name, r.derived) for r in inline.rows()
            if not r.name.endswith(timed)]
    names = {r.name for r in inline.rows()}
    assert {"memory_skew_flip_memory_fleet",
            "memory_skew_flip_memory_w0_static",
            "memory_skew_flip_memory_w1_arbitrated"} <= names


def test_scenario_plan_runs_and_matches_the_reference():
    """The small spec under the ``tombstone_churn`` scenario (after a calm
    first segment, half of every session's writes delete the oldest live
    keys), with the reference's tunings carried across and every storm
    replayed: every segment record and division event bit for bit."""
    spec = dataclasses.replace(
        _small_spec(), drift=dataclasses.replace(_small_spec().drift,
                                                 kind="tombstone_churn"))
    rspec = R.ExperimentSpec.from_json(spec.to_json())
    with jax.threefry_partitionable(False), \
            carry.recorded_storms(rmemory) as storms:
        ref = R.run_experiment(rspec)
    plan = carry.port_memory_plan(
        rcompile.compile_spec(rspec).build_memory(ref), rspec)
    assert plan.scenario.kind == "tombstone_churn"
    with carry.replayed_storms(tmem, storms):
        results, events = TO.execute_memory_fleet(plan, device="cpu")
    assert carry.drift_records(results) == carry.drift_records(ref.memory)
    assert events == ref.memory_events


def test_memory_suite_spec_is_the_reference_text():
    """The suite's specs (both scenarios and the disabled check) are the
    JAX package's, JSON text for text."""
    from benchmarks import bench_memory_fleet as ref
    for kind, target in tmemory.SCENARIOS:
        assert tmemory.make_spec(kind, target).to_json() \
            == ref.make_spec(kind, target).to_json()
    assert tmemory.make_spec("skew_flip", tmemory.SCENARIOS[0][1],
                             enabled=False,
                             **tmemory.DISABLED_SIZES).to_json() \
        == ref.make_spec("skew_flip", ref.SCENARIOS[0][1], enabled=False,
                         n_keys=6_000, segments=3,
                         seg_queries=200).to_json()
    assert tmemory.SCENARIOS == ref.SCENARIOS
    assert tmemory.TENANTS == ref.TENANTS
