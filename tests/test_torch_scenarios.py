"""The port's scenario engine (``repro_torch.scenarios``) and its hooks in
the drift loop, the memory axis and the report, against the JAX package's
(``repro.scenarios``), on the CPU at small sizes (2,500 keys, 3 segments
of 150 queries, 4-start 40-step storms).

* The generators: every kind's ``schedule``, ``segment_queries`` and
  ``session_kwargs``, default and overridden, exactly the reference's
  (numpy float64 in both), and the registry's validation errors too.
* ``materialize_session`` with ``hot_offset`` and ``zipf_a``: the
  reference's plan exactly; ``hot_offset=0`` leaves a classic plan as it
  was.
* The adversary: ``attack`` on seeded tunings, centers and budgets agrees
  with the reference's to rel 1e-5, ``le_dual_bound`` equal.
* The loop: ``execute_drift`` for each of the five kinds, from the
  reference's compiled plan with its tunings carried across, every storm
  replayed and (for the adversary) every attacked mix carried across,
  gives every segment record bit for bit; the port's own attack on each
  defender state matches the reference's record to rel 1e-5, and no
  attacked cost vector is flat.  ``execute_memory_fleet`` under
  ``zipf_migrate`` likewise, with its division events.
* The API: ``run_experiment`` on the inline and the sharded backend
  (three ``"cpu"`` devices) measures the same segment I/O; the regret row
  prints the reference's; the suite's specs are the reference's JSON text.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.api as R
import repro.core as RC
import repro.lsm as RL
import repro.scenarios as RS
import repro_torch.api as T
import repro_torch.core as TC
import repro_torch.lsm as TL
import repro_torch.online as TO
import repro_torch.scenarios as TS
from repro.api import compile as rcompile
from repro.online import memory as rmemory
from repro.online import session as rsession
from repro.scenarios.adversary import DEFENDER_ORDER as R_DEFENDERS
from repro_torch.bench import scenarios as tsuite
from repro_torch.online import memory as tmemory
from repro_torch.online import session as tsession
from repro_torch.scenarios.adversary import DEFENDER_ORDER as T_DEFENDERS

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
# The registry and the generators
# ---------------------------------------------------------------------------

def test_registry_is_the_reference_s():
    assert TS.__all__ == RS.__all__
    assert TS.SCENARIO_KINDS == RS.SCENARIO_KINDS
    assert list(TS.SCENARIOS) == list(RS.SCENARIOS)
    for kind, cls in TS.SCENARIOS.items():
        assert cls.__name__ == RS.SCENARIOS[kind].__name__
        assert cls.PARAMS == RS.SCENARIOS[kind].PARAMS
    assert T_DEFENDERS == R_DEFENDERS
    assert TS.get_scenario(T.DriftSpec(kind="flip",
                                       target=(0.3, 0.3, 0.3, 0.1))) is None


#: (kind, scenario_params, target, segments, n_queries)
GENERATOR_CASES = [
    ("zipf_migrate", (), None, 8, 600),
    ("zipf_migrate", (("zipf_a", 1.1), ("migrate", 0.4)),
     (0.2, 0.5, 0.2, 0.1), 5, 333),
    ("burst_storm", (), None, 9, 600),
    ("burst_storm", (("amplitude", 6.0), ("period", 3)), None, 8, 600),
    ("burst_storm", (("amplitude", 2.5), ("period", 2)),
     (0.4, 0.4, 0.1, 0.1), 7, 151),
    ("tombstone_churn", (), None, 8, 600),
    ("tombstone_churn", (("delete_fraction", 0.3),), None, 1, 100),
    ("scan_heavy", (), None, 8, 600),
    ("scan_heavy", (("scan_scale", 3.0),), (0.1, 0.1, 0.7, 0.1), 4, 200),
    ("adversary", (), None, 8, 600),
    ("adversary", (("rho", 0.4), ("iters", 40)), None, 3, 150),
]


@pytest.mark.parametrize("case", GENERATOR_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(GENERATOR_CASES)])
def test_generators_are_the_reference_s_exactly(case):
    kind, params, target, segments, nq = case
    kw = dict(kind=kind, segments=segments, n_queries=nq,
              scenario_params=params, target=target, range_fraction=5e-4)
    t, r = TS.get_scenario(T.DriftSpec(**kw)), \
        RS.get_scenario(R.DriftSpec(**kw))
    assert t.params == r.params and t.is_adversary == r.is_adversary
    for widx in (4, 11):
        expected = np.asarray(RC.EXPECTED_WORKLOADS[widx], np.float64)
        np.testing.assert_array_equal(t.schedule(expected),
                                      r.schedule(expected))
    for s in range(segments):
        assert t.segment_queries(s) == r.segment_queries(s)
        for n_existing in (0, 1, 2500, 100_017):
            assert t.session_kwargs(s, n_existing) \
                == r.session_kwargs(s, n_existing)
    # the compiler's lowering delegates to the generator in both
    exp = np.asarray(RC.EXPECTED_WORKLOADS[4], np.float64)
    np.testing.assert_array_equal(
        T.drift_schedule(exp, T.DriftSpec(**kw)),
        R.drift_schedule(exp, R.DriftSpec(**kw)))


#: drift specs the generators or the spec refuse
BAD_DRIFTS = {
    "unknown_param": dict(kind="zipf_migrate",
                          scenario_params=(("zipf_b", 1.0),)),
    "amplitude_low": dict(kind="burst_storm",
                          scenario_params=(("amplitude", 0.5),)),
    "amplitude_high": dict(kind="burst_storm",
                           scenario_params=(("amplitude", 1001.0),)),
    "period": dict(kind="burst_storm", scenario_params=(("period", 1),)),
    "delete_fraction": dict(kind="tombstone_churn",
                            scenario_params=(("delete_fraction", 1.5),)),
    "adversary_rho": dict(kind="adversary", scenario_params=(("rho", 0.0),)),
    "target_length": dict(kind="scan_heavy", target=(0.5, 0.5)),
    "unknown_kind": dict(kind="mystery", target=(0.25,) * 4),
    "params_on_classic": dict(kind="flip", target=(0.25,) * 4,
                              scenario_params=(("zipf_a", 1.2),)),
}


@pytest.mark.parametrize("name", sorted(BAD_DRIFTS))
def test_validation_errors_are_the_reference_s(name):
    kw = BAD_DRIFTS[name]
    with pytest.raises(ValueError) as want:
        R.DriftSpec(**kw)
    with pytest.raises(ValueError) as got:
        T.DriftSpec(**kw)
    assert str(got.value) == str(want.value)
    if "scenario_params" in kw and kw["kind"] in TS.SCENARIOS:
        assert _error(TS.validate_scenario_params, kw) \
            == _error(RS.validate_scenario_params, kw)


def _error(validate, kw):
    try:
        validate(kw["kind"], kw["scenario_params"])
    except ValueError as e:
        return str(e)
    return None


def test_memory_axis_runs_trace_shaped_kinds_and_rejects_the_adversary():
    base = _memory_spec("zipf_migrate").to_json()
    for kind in sorted(TS.SCENARIO_KINDS):
        text = base.replace('"kind": "zipf_migrate"', f'"kind": "{kind}"')
        if kind == "adversary":
            with pytest.raises(ValueError) as got:
                T.ExperimentSpec.from_json(text)
            with pytest.raises(ValueError) as want:
                R.ExperimentSpec.from_json(text)
            assert str(got.value) == str(want.value)
        else:
            spec = T.ExperimentSpec.from_json(text)
            assert spec.drift.kind == kind and spec.to_json() == text
            assert R.ExperimentSpec.from_json(text).to_json() == text


# ---------------------------------------------------------------------------
# materialize_session's scenario shaping
# ---------------------------------------------------------------------------

def _plan_fields(plan):
    return {f.name: (None if getattr(plan, f.name) is None
                     else np.asarray(getattr(plan, f.name)))
            for f in dataclasses.fields(plan)}


@pytest.mark.parametrize("kw", [
    dict(), dict(hot_offset=0), dict(zipf_a=1.35),
    dict(zipf_a=1.35, hot_offset=625), dict(zipf_a=1.1, hot_offset=7_777),
    dict(hot_offset=1234), dict(zipf_a=1.35, hot_offset=3,
                                delete_fraction=0.5),
    dict(delete_fraction=0.5, range_fraction=4e-3)])
def test_materialize_session_is_the_reference_s(kw):
    keys = RL.draw_keys(2500, seed=100, key_space=2 ** 26)
    w = np.asarray([0.1, 0.5, 0.15, 0.25])
    args = dict(n_queries=900, seed=17, key_space=2 ** 26, **kw)
    got = _plan_fields(TL.materialize_session(keys, w, **args))
    want = _plan_fields(RL.materialize_session(keys, w, **args))
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        if value is None:
            assert got[name] is None, name
        else:
            np.testing.assert_array_equal(got[name], value, err_msg=name)
    if kw.get("hot_offset", None) == 0:
        classic = _plan_fields(TL.materialize_session(
            keys, w, n_queries=900, seed=17, key_space=2 ** 26))
        for name, value in classic.items():
            np.testing.assert_array_equal(got[name], value)


# ---------------------------------------------------------------------------
# The adversary's attack
# ---------------------------------------------------------------------------

#: (T, filter bits per entry, K, w_center, rho_live) on a 100,000-entry
#: system at 6 bits per entry
ATTACKS = [
    (10.0, 5.0, 1.0, (0.25, 0.25, 0.25, 0.25), 0.5),
    (4.0, 3.0, 3.0, RC.EXPECTED_WORKLOADS[4], 0.177),
    (7.0, 5.5, 2.0, RC.EXPECTED_WORKLOADS[11], 0.9),
    (3.0, 1.0, 1.0, (0.1, 0.7, 0.1, 0.1), 0.0),       # the fallback rho
    (12.0, 4.0, 6.0, (0.05, 0.05, 0.85, 0.05), 2.5),
    (5.0, 2.0, 1.0, RC.EXPECTED_WORKLOADS[0], 0.05),
]


@pytest.mark.parametrize("case", ATTACKS,
                         ids=[f"a{i}" for i in range(len(ATTACKS))])
def test_attack_matches_the_reference(case):
    T_, bpe, K, w, rho = case
    pairs = dict(tsuite.SYSTEM)
    rsys, tsys = RC.LSMSystem(**pairs), TC.LSMSystem(**pairs)
    mfilt = bpe * pairs["N"]
    rphi = RC.make_phi(T_, mfilt, K, rsys)
    tphi = TC.make_phi(T_, mfilt, K, tsys)
    drift = dict(kind="adversary", scenario_params=(("rho", 0.3),))
    w_adv_r, rec_r = RS.get_scenario(R.DriftSpec(**drift)).attack(
        rphi, np.asarray(w), rho, rsys)
    w_adv_t, rec_t = TS.get_scenario(T.DriftSpec(**drift)).attack(
        tphi, np.asarray(w), rho, tsys, device="cpu")
    carry.assert_records_close(rec_t, rec_r)
    np.testing.assert_allclose(w_adv_t, w_adv_r, rtol=1e-5, atol=1e-7)
    assert rec_t["le_dual_bound"] and rec_t["rho"] == (rho or 0.3)
    assert rec_t["kl_adv"] <= rec_t["rho"] * (1 + 1e-4)


# ---------------------------------------------------------------------------
# The loop, with the reference's tunings (and mixes) carried across
# ---------------------------------------------------------------------------

#: the reference's own end-to-end scenario matrix
SCENARIO_MATRIX = [
    ("zipf_migrate", ()),
    ("burst_storm", (("amplitude", 3.0), ("period", 2))),
    ("tombstone_churn", (("delete_fraction", 0.4),)),
    ("scan_heavy", (("scan_scale", 4.0),)),
    ("adversary", (("rho", 0.2),)),
]
SYS_PAIRS = (("N", 8000.0), ("entry_bits", 512.0), ("bits_per_entry", 6.0),
             ("min_buf_bits", 512.0 * 64), ("max_T", 20.0))


def _drift_spec(kind, params, detector="kl"):
    return T.DriftSpec(kind=kind, segments=3, n_queries=150,
                       scenario_params=params, detector=detector,
                       n_keys=2500, key_space=2 ** 20, window=2,
                       min_windows=1, cooldown=1, kl_threshold=0.05,
                       retune_starts=4, retune_steps=40)


def _scenario_spec(kind, params):
    return T.ExperimentSpec(
        name=f"sc_{kind}",
        workload=T.WorkloadSpec(indices=(4,), nominal=True,
                                rho_source="from_history",
                                history=((0.01, 0.01, 0.01, 0.97),
                                         (0.3, 0.3, 0.3, 0.1))),
        design=T.DesignSpec(n_starts=8, steps=60, seed=3),
        system=SYS_PAIRS, drift=_drift_spec(kind, params))


def _memory_spec(kind="zipf_migrate"):
    return T.ExperimentSpec(
        name=f"mem_{kind}",
        workload=T.WorkloadSpec(workloads=((0.01, 0.01, 0.01, 0.97),
                                           (0.49, 0.49, 0.01, 0.01)),
                                nominal=False, rhos=(0.5,)),
        design=T.DesignSpec(n_starts=8, steps=60, seed=3),
        system=SYS_PAIRS,
        drift=dataclasses.replace(_drift_spec(kind, ()),
                                  arms=("static_robust",)),
        memory=T.MemorySpec(floor_bits_per_entry=2.0,
                            quantum_bits_per_entry=1.0, min_windows=1,
                            cooldown=1))


def _flat(c) -> bool:
    c = np.asarray(c, np.float64)
    return float(c.max() - c.min()) <= 1e-6 * float(np.abs(c).max())


@pytest.fixture(scope="module")
def carried():
    """Each kind of the matrix: the reference's run (storms and attacks
    recorded) and the port's ``execute_drift`` from its compiled plan,
    every storm and attacked mix carried across."""
    out = {}
    for kind, params in SCENARIO_MATRIX:
        spec = _scenario_spec(kind, params)
        rspec = R.ExperimentSpec.from_json(spec.to_json())
        with jax.threefry_partitionable(False), \
                carry.recorded_storms(rsession) as storms, \
                carry.recorded_attacks(RS.AdversaryScenario) as attacks:
            ref = R.run_experiment(rspec)
        plan = carry.port_drift_plan(
            rcompile.compile_spec(rspec).build_drift(ref), rspec)
        with carry.replayed_storms(tsession, storms), \
                carry.replayed_attacks(attacks) as own:
            results, regret = TO.execute_drift(plan, device="cpu")
        out[kind] = dict(ref=ref, plan=plan, storms=storms, attacks=attacks,
                         own=own, results=results, regret=regret)
    return out


@pytest.mark.parametrize("kind", [k for k, _ in SCENARIO_MATRIX])
def test_execute_drift_with_the_reference_tunings_is_bit_identical(
        carried, kind):
    d = carried[kind]
    ref = d["ref"]
    assert type(d["plan"].scenario).__name__ \
        == type(RS.get_scenario(ref.spec.drift)).__name__
    assert list(d["results"]) == list(ref.drift)
    assert carry.drift_records(d["results"]) == carry.drift_records(ref.drift)
    qs = {tuple(r.queries for r in res.records)
          for res in d["results"].values()}
    assert len(qs) == 1                       # paired arms, same volume
    if kind == "burst_storm":
        assert qs == {(150, 450, 150)}
    if kind == "adversary":
        assert len(d["attacks"]) == len(d["own"]) == 3
        assert sorted(d["regret"]) == [0]
    else:
        assert d["attacks"] == [] and d["regret"] == {} and ref.regret == {}


def test_regret_records_match_the_reference(carried):
    """Every field of each window's record: the reference's labels and
    measured I/O exactly (the segment records are bit for bit), its model
    costs and bound to rel 1e-5 from the port's own attack on the same
    defender state, ``le_dual_bound`` equal."""
    d = carried["adversary"]
    got, want = d["regret"][0], d["ref"].regret[0]
    assert [r["segment"] for r in got] == [0, 1, 2]
    for g, w, (_, own) in zip(got, want, d["own"]):
        assert g == w
        carry.assert_records_close(
            dict(own, segment=w["segment"], widx=w["widx"],
                 defender=w["defender"], measured_io=w["measured_io"]), w)
    assert all(r["le_dual_bound"] for r in got)
    assert {r["defender"] for r in got} == {"online"}


def test_no_attacked_cost_vector_is_flat(carried):
    """The port's ``worst_case_workload`` parts from the reference's only
    on flat costs (ROADMAP.md section 3); no attack here meets one."""
    d = carried["adversary"]
    sys = d["plan"].sys
    for (T_, mfilt, K, _, _), _ in d["attacks"]:
        c = TC.cost_vector(TC.Phi(T=torch.as_tensor(T_),
                                  mfilt_bits=torch.as_tensor(mfilt),
                                  K=torch.as_tensor(K)), sys)
        assert not _flat(c.numpy()), c


def test_report_regret_row_is_the_reference_s(carried):
    d = carried["adversary"]
    ref = d["ref"]
    port = carry.port_report(ref, drift=d["results"], regret=d["regret"])
    want = [r.csv() for r in ref.rows() if "_regret_" in r.name]
    got = [r.csv() for r in port.rows() if "_regret_" in r.name]
    assert len(want) == 1 and got == want
    assert [r.csv() for r in port.rows() if "_drift_" in r.name] \
        == [r.csv() for r in ref.rows() if "_drift_" in r.name]


def test_execute_memory_fleet_under_zipf_migrate_is_bit_identical():
    spec = _memory_spec("zipf_migrate")
    rspec = R.ExperimentSpec.from_json(spec.to_json())
    with jax.threefry_partitionable(False), \
            carry.recorded_storms(rmemory) as storms:
        ref = R.run_experiment(rspec)
    plan = carry.port_memory_plan(
        rcompile.compile_spec(rspec).build_memory(ref), rspec)
    assert plan.scenario.kind == "zipf_migrate"
    with carry.replayed_storms(tmemory, storms):
        results, events = TO.execute_memory_fleet(plan, device="cpu")
    assert carry.drift_records(results) == carry.drift_records(ref.memory)
    assert events == ref.memory_events
    got = carry.port_report(ref, memory=results, memory_events=events)
    assert [r.csv() for r in got.rows() if "_memory_" in r.name] \
        == [r.csv() for r in ref.rows() if "_memory_" in r.name]


# ---------------------------------------------------------------------------
# The API
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["burst_storm", "adversary"])
def test_run_experiment_on_the_inline_and_sharded_backends(kind):
    """The port's own starts, a few steps: every arm, the same segment I/O
    on both backends, and (for the adversary) a regret row whose claim
    holds."""
    params = dict(SCENARIO_MATRIX)[kind]
    spec = dataclasses.replace(_scenario_spec(kind, params),
                               design=T.DesignSpec(n_starts=4, steps=20,
                                                   seed=1))
    inline = T.run_experiment(spec, device="cpu")
    sharded = T.run_experiment(spec, T.ShardedBackend(devices=["cpu"] * 3),
                               device="cpu")
    assert sorted(inline.drift) == [(0, arm) for arm in sorted(TO.ARMS)]
    assert sharded.walls["tuning_devices"] == 3
    ios = {key: [r.avg_io_per_query for r in res.records]
           for key, res in sorted(inline.drift.items())}
    assert {key: [r.avg_io_per_query for r in res.records]
            for key, res in sorted(sharded.drift.items())} == ios
    assert sharded.regret == inline.regret
    names = {r.name for r in inline.rows()}
    if kind == "adversary":
        row = next(r for r in inline.rows() if r.name == "sc_adversary"
                   "_regret_w0")
        assert row.derived["claim_regret_le_dual_bound"] is True
        assert len(row.derived["trace"]) == 3
    else:
        assert inline.regret == {} and not any("_regret_" in n
                                               for n in names)


def test_suite_specs_round_trip_with_the_reference_text():
    from benchmarks import bench_scenarios as ref
    assert tsuite.SCENARIOS == ref.SCENARIOS
    assert tsuite.SYSTEM == ref.SYSTEM and tsuite.ARMS == ref.ARMS
    for (kind, spec), args in zip(tsuite.specs(), ref.SCENARIOS):
        text = spec.to_json()
        assert text == ref.make_spec(*args).to_json()
        assert T.ExperimentSpec.from_json(text) == spec
        assert R.ExperimentSpec.from_json(text).to_json() == text
        assert spec.name == f"scenarios_{kind}"
    for args in ref.SCENARIOS:
        assert tsuite.make_spec(*args, 2500, 3, 150).to_json() \
            == ref.make_spec(*args, 2500, 3, 150).to_json()
