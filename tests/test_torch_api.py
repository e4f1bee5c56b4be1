"""The port's experiment API (``repro_torch.api``) against the JAX package's
(``repro.api``), on the CPU.  ``tests/test_api_spec.py`` is the checklist.

* Specs: the same JSON text from ``to_json`` for every spec both packages
  build (the suites', the API checklist's, one with faults, one with a
  classic drift), and ``from_json`` of the reference's text gives an equal
  spec; every spec the reference rejects, the port rejects.
* Backends: every backend of the reference is the port's own class; the
  remote stub refuses to execute with the reference's
  ``NotImplementedError``.
* ``FaultPlan``: the same firings over a grid of shards, attempts and
  basenames.
* Tunings and arms: from the same starts, ``run_experiment`` matches the
  reference's to rel 1e-4 on the exact re-scored cost with the same chosen
  arms, and equals the port's own direct ``tune_*_many`` bit for bit, on
  the inline and the sharded backend (three ``"cpu"`` devices).
* Trial: one ``TrialPlan`` built from the reference's numbers gives the
  same ``IOStats`` and ``TreeProbe`` through both ``execute_trial``.
* Report: the same ``BENCH_<suite>.json`` bytes for the same report.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import repro.api as R
import repro.core as RC
import repro.faults as RF
import repro_torch.api as T
import repro_torch.core as TC
import repro_torch.faults as TF
from benchmarks import (bench_api, bench_flexible_robustness,
                        bench_online_drift, bench_rho_choice,
                        bench_rho_impact, bench_robust_vs_nominal,
                        bench_system_eval)
from repro.api import backends as rbackends
from repro.api import compile as rcompile
from repro.api import report as rreport
from repro_torch import obs as tobs
from repro_torch.api import backends as tbackends
from repro_torch.api import compile as tcompile
from repro_torch.api import report as treport
from repro_torch.bench import (api, common, fig6, fig7_8, fig9, fig19,
                               online, tab5)
from repro_torch.convert import phi_from_numpy
from repro import obs as robs

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tunings' lane batches are small: torch's intra-op threads gain
    nothing on them and, beside other busy test processes, spin-wait the
    run 30x longer."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the API checklist's sizes (tests/test_api_spec.py)
SMALL = dict(n_starts=8, steps=60, seed=3)
RHOS = (0.25, 1.0)
WIDX = (7, 11)
SYS_PAIRS = (("N", 8000.0), ("entry_bits", 512.0), ("bits_per_entry", 6.0),
             ("min_buf_bits", 512.0 * 64), ("max_T", 20.0))
SESSIONS = ((0.05, 0.85, 0.05, 0.05), (0.05, 0.05, 0.05, 0.85))


def _checklist_specs(m):
    """Every spec ``tests/test_api_spec.py`` builds, from API module ``m``
    (``repro.api`` or ``repro_torch.api``)."""
    def spec(**kw):
        base = dict(name="t",
                    workload=m.WorkloadSpec(indices=WIDX, rhos=RHOS,
                                            nominal=True),
                    design=m.DesignSpec(**SMALL), system=SYS_PAIRS)
        base.update(kw)
        return m.ExperimentSpec(**base)

    return {
        "round_trip": spec(
            trial=m.TrialSpec(n_keys=5000, n_queries=300, sessions=SESSIONS,
                              key_space=2 ** 22, session_seeds=(4, 5)),
            design=m.DesignSpec(policies=("klsm", "lazy_leveling"),
                                policy_params=(
                                    ("lazy_leveling",
                                     (("read_trigger", 64),)),),
                                **SMALL),
            backend="subprocess", backend_params=(("workers", 2),)),
        "direct": spec(),
        "sharded": spec(backend="sharded"),
        "trial": spec(
            workload=m.WorkloadSpec(indices=WIDX, rhos=(1.0,),
                                    nominal=False),
            trial=m.TrialSpec(n_keys=5000, n_queries=300, sessions=SESSIONS,
                              key_space=2 ** 22, range_fraction=1e-3,
                              key_seed=7)),
        "subprocess": spec(
            workload=m.WorkloadSpec(indices=WIDX, rhos=(1.0,),
                                    nominal=False),
            trial=m.TrialSpec(n_keys=5000, n_queries=300, sessions=SESSIONS,
                              key_space=2 ** 22, per_workload_keys=True),
            backend="subprocess", backend_params=(("workers", 2),)),
        "arms": m.ExperimentSpec(
            name="arms",
            workload=m.WorkloadSpec(indices=(4, 11), rhos=(1.0,),
                                    nominal=False),
            design=m.DesignSpec(policies=("klsm", "lazy_leveling"),
                                **SMALL)),
        "payload": spec(workload=m.WorkloadSpec(indices=(7,), rhos=(1.0,),
                                                nominal=True, bench_n=200)),
        "fixed": m.ExperimentSpec(
            name="fixed",
            workload=m.WorkloadSpec(workloads=((0.25, 0.25, 0.25, 0.25),),
                                    rhos=(), nominal=True),
            design=m.DesignSpec(fixed=(6.0, 4.0, 1.0),
                                policies=("klsm", "lazy_leveling")),
            system=SYS_PAIRS),
        "faults": spec(faults=(
            m.FaultSpec(kind="crash", p=0.5, max_hits=2, shards=(0, 2),
                        seed=9),
            m.FaultSpec(kind="torn_write", match="BENCH", seed=1))),
        "drift": spec(drift=m.DriftSpec(
            kind="gradual", segments=4, target=(0.1, 0.1, 0.1, 0.7),
            detector="cusum", arms=("stale_nominal", "online"))),
        "memory": spec(drift=m.DriftSpec(kind="flip", segments=4,
                                         target=(0.7, 0.1, 0.1, 0.1)),
                       memory=m.MemorySpec(total_bits_per_entry=12.0)),
        "history": spec(workload=m.WorkloadSpec(
            workloads=((1.0, 2.0, 3.0, 4.0),), rhos=(0.5,),
            rho_source="from_history",
            history=((1.0, 1.0, 1.0, 1.0), (4.0, 1.0, 1.0, 1.0)))),
        "spaces": spec(design=m.DesignSpec(
            spaces=("klsm", ("fluid", 16)), **SMALL)),
    }


def _suite_specs():
    """(reference, port) pairs of the suites' specs."""
    ref19 = bench_flexible_robustness
    axis = R.ExperimentSpec(
        name="fig19_designs",
        workload=R.WorkloadSpec(indices=ref19.WIDX, nominal=True,
                                bench_n=10_000, bench_seed=0),
        design=R.DesignSpec(space="classic", n_starts=64, seed=0,
                            spaces=tuple((space, n) for _, space, n
                                         in ref19.NOMINAL_MODELS)))
    return {
        "fig7_8": (bench_rho_impact.SPEC, fig7_8.make_spec()),
        "fig9": (bench_rho_choice.SPEC, fig9.make_spec()),
        "fig19_designs": (axis, fig19.axis_spec()),
        "fig19_endure_rho2": (ref19._spec("endure_rho2", "classic", 64,
                                          rhos=(2.0,)), fig19.robust_spec()),
        "tab5": (bench_system_eval.SPEC, tab5.make_spec()),
        "api": (bench_api.SPEC, api.SPEC),
        "fig6": (bench_robust_vs_nominal.SPEC, fig6.SPEC),
        **{f"online_{kind}": (bench_online_drift.make_spec(kind, w, target),
                              online.make_spec(kind, w, target))
           for kind, w, target in online.SCENARIOS},
    }


SUITE_SPECS = _suite_specs()
CHECKLIST = sorted(_checklist_specs(R))


@pytest.mark.parametrize("name", sorted(SUITE_SPECS))
def test_suite_specs_round_trip_with_the_reference_text(name):
    ref, port = SUITE_SPECS[name]
    text = ref.to_json()
    back = T.ExperimentSpec.from_json(text)
    assert back.to_json() == text
    assert T.ExperimentSpec.from_json(back.to_json()) == back
    if port is not None:               # the port's own suite module's spec
        assert port.to_json() == text
        assert port == back


@pytest.mark.parametrize("name", CHECKLIST)
def test_checklist_specs_round_trip_with_the_reference_text(name):
    ref = _checklist_specs(R)[name]
    port = _checklist_specs(T)[name]
    text = ref.to_json()
    assert port.to_json() == text
    assert T.ExperimentSpec.from_json(text) == port
    assert R.ExperimentSpec.from_json(port.to_json()) == ref
    assert port.to_dict() == ref.to_dict()


#: constructor calls the reference rejects with ValueError
INVALID = {
    "both_indices_and_workloads": lambda m: m.WorkloadSpec(
        indices=(1,), workloads=((0.25,) * 4,)),
    "no_cells": lambda m: m.WorkloadSpec(indices=(1,), rhos=(),
                                         nominal=False),
    "no_policy": lambda m: m.DesignSpec(policies=()),
    "no_session": lambda m: m.TrialSpec(sessions=()),
    "rho_source": lambda m: m.WorkloadSpec(indices=(1,), rho_source="x"),
    "short_history": lambda m: m.WorkloadSpec(
        indices=(1,), rho_source="from_history", history=((1, 1, 1, 1),)),
    "fixed_len": lambda m: m.DesignSpec(fixed=(6.0, 4.0)),
    "spaces_and_fixed": lambda m: m.DesignSpec(spaces=("klsm",),
                                               fixed=(6.0, 4.0, 1.0)),
    "spaces_entry": lambda m: m.DesignSpec(spaces=(("klsm", 8, 1),)),
    "spaces_duplicate": lambda m: m.DesignSpec(spaces=("klsm",
                                                       ("klsm", 16))),
    "drift_kind": lambda m: m.DriftSpec(kind="sideways"),
    "drift_no_target": lambda m: m.DriftSpec(kind="gradual"),
    "drift_schedule_rows": lambda m: m.DriftSpec(
        kind="schedule", segments=2, schedule=((0.25,) * 4,)),
    "drift_schedule_width": lambda m: m.DriftSpec(
        kind="schedule", segments=1, schedule=((0.5, 0.5),)),
    "drift_scenario_params": lambda m: m.DriftSpec(
        kind="flip", target=(0.25,) * 4, scenario_params=(("a", 1),)),
    "drift_detector": lambda m: m.DriftSpec(
        kind="flip", target=(0.25,) * 4, detector="x"),
    "drift_segments": lambda m: m.DriftSpec(
        kind="flip", target=(0.25,) * 4, segments=0),
    "drift_arms": lambda m: m.DriftSpec(
        kind="flip", target=(0.25,) * 4, arms=("nope",)),
    "drift_no_arm": lambda m: m.DriftSpec(
        kind="flip", target=(0.25,) * 4, arms=()),
    "memory_floor": lambda m: m.MemorySpec(floor_bits_per_entry=0.0),
    "memory_quantum": lambda m: m.MemorySpec(quantum_bits_per_entry=0.0),
    "memory_total": lambda m: m.MemorySpec(total_bits_per_entry=-1.0),
    "memory_kl": lambda m: m.MemorySpec(rebalance_kl=0.0),
    "memory_windows": lambda m: m.MemorySpec(min_windows=0),
    "fault_kind": lambda m: m.FaultSpec(kind="meteor"),
    "fault_p": lambda m: m.FaultSpec(kind="crash", p=1.5),
    "fault_hits": lambda m: m.FaultSpec(kind="crash", max_hits=-1),
    "fault_delay": lambda m: m.FaultSpec(kind="slow", delay_s=-1.0),
    "faults_entry": lambda m: m.ExperimentSpec(
        name="x", workload=m.WorkloadSpec(indices=(1,)), faults=("crash",)),
    "drift_needs_robust": lambda m: m.ExperimentSpec(
        name="x", workload=m.WorkloadSpec(indices=(1,)),
        drift=m.DriftSpec(kind="flip", target=(0.25,) * 4)),
    "drift_needs_nominal": lambda m: m.ExperimentSpec(
        name="x", workload=m.WorkloadSpec(indices=(1,), rhos=(1.0,),
                                          nominal=False),
        drift=m.DriftSpec(kind="flip", target=(0.25,) * 4,
                          arms=("stale_nominal",))),
    "memory_needs_drift": lambda m: m.ExperimentSpec(
        name="x", workload=m.WorkloadSpec(indices=(1,), rhos=(1.0,)),
        memory=m.MemorySpec()),
    "memory_needs_robust": lambda m: m.ExperimentSpec(
        name="x", workload=m.WorkloadSpec(indices=(1,)),
        drift=m.DriftSpec(kind="flip", target=(0.25,) * 4,
                          arms=("stale_nominal",)),
        memory=m.MemorySpec()),
}


@pytest.mark.parametrize("name", sorted(INVALID))
def test_spec_validation_rejects_what_the_reference_rejects(name):
    for m in (R, T):
        with pytest.raises(ValueError):
            INVALID[name](m)


def test_refusals_name_their_roadmap_queue():
    specs = _checklist_specs(T)
    # the drift and memory axes are ported: a drift spec lowers without a
    # memory spec, and an empty report's memory fleets read as the
    # reference's do
    report = treport.Report(spec=specs["direct"], sys=TC.LSMSystem(),
                            cells=[], tunings={}, arm_costs={}, chosen={},
                            model_costs={})
    ref_report = rreport.Report(spec=None, sys=None, cells=[], tunings={},
                                arm_costs={}, chosen={}, model_costs={})
    assert report.memory_fleet_throughput("static") \
        == ref_report.memory_fleet_throughput("static")
    assert T.compile_spec(specs["drift"]).build_memory(None) is None
    assert T.compile_spec(specs["direct"]).build_drift(None) is None
    assert isinstance(T.get_backend("subprocess", (("workers", 2),)),
                      T.SubprocessBackend)
    remote = T.get_backend("remote", (("queue", "gpu"),))
    assert isinstance(remote, T.RemoteBackend)
    with pytest.raises(NotImplementedError, match="scheduling stub"):
        T.run_experiment(dataclasses.replace(specs["subprocess"],
                                             backend="remote"),
                         device="cpu")
    with pytest.raises(NotImplementedError, match="scheduling stub"):
        remote.run_trial(None, report)
    with pytest.raises(ValueError, match="unknown backend"):
        T.get_backend("carrier_pigeon")
    assert set(T.BACKENDS) == set(R.BACKENDS)
    assert {n: c.__name__ for n, c in T.BACKENDS.items()} \
        == {n: c.__name__ for n, c in R.BACKENDS.items()}
    assert all(c.__module__ == "repro_torch.api.backends"
               for c in T.BACKENDS.values())


def test_api_exports_what_the_reference_exports_but_the_queued_backends():
    assert T.__all__ == R.__all__
    assert all(hasattr(T, name) for name in T.__all__)
    assert tcompile.ARM_DESIGNS == rcompile.ARM_DESIGNS
    assert tcompile.MODEL_ONLY_PARAMS == rcompile.MODEL_ONLY_PARAMS


def test_fault_plan_fires_as_the_reference_does():
    kw = [dict(kind="crash", p=0.5, max_hits=3, seed=4),
          dict(kind="hang", p=0.3, max_hits=2, shards=(1, 3), seed=2),
          dict(kind="slow", p=0.7, max_hits=5, delay_s=0.25),
          dict(kind="corrupt", p=0.4, max_hits=4, seed=11),
          dict(kind="torn_write", p=0.6, match="BENCH", seed=5),
          dict(kind="torn_write", p=0.5, seed=8)]
    ref = RF.FaultPlan.from_specs([RF.FaultSpec(**k) for k in kw])
    got = TF.FaultPlan.from_specs([TF.FaultSpec(**k) for k in kw])
    assert bool(got) and not TF.FaultPlan()
    fired = 0
    for shard in range(6):
        for attempt in range(6):
            a, b = ref.worker_fault(shard, attempt), \
                got.worker_fault(shard, attempt)
            assert (a is None) == (b is None)
            if a is not None:
                fired += 1
                assert (b.kind, b.delay_s) == (a.kind, a.delay_s)
            for s in (RF.FaultSpec(**kw[0]), RF.FaultSpec(**kw[1])):
                assert TF.FaultSpec(**dataclasses.asdict(s)).fires_worker(
                    shard, attempt) == s.fires_worker(shard, attempt)
    assert 0 < fired < 36
    names = [f"BENCH_{s}.json" for s in ("fig4", "fig9", "api", "tab5")] \
        + [f"shard_{i}.pkl" for i in range(8)]
    assert [got.tears_write(n) for n in names] \
        == [ref.tears_write(n) for n in names]
    assert any(got.tears_write(n) for n in names)
    for key in [(0, "crash", 1, 2), (7, "torn_write", "x.json"), ()]:
        assert TF.u01(*key) == RF.u01(*key)
    assert (TF.KINDS, TF.WORKER_KINDS, TF.ARTIFACT_KINDS, TF.HANG_SLEEP_S) \
        == (RF.KINDS, RF.WORKER_KINDS, RF.ARTIFACT_KINDS, RF.HANG_SLEEP_S)


def test_artifact_writes_match_the_reference(tmp_path):
    payload = {"suite": "x", "rows": [{"a": 1.5}], "error": None}
    TF.atomic_write_json(tmp_path / "t.json", dict(payload))
    RF.atomic_write_json(tmp_path / "r.json", dict(payload))
    assert (tmp_path / "t.json").read_bytes() \
        == (tmp_path / "r.json").read_bytes()
    assert TF.load_checked_json(tmp_path / "t.json")["suite"] == "x"
    plan = TF.FaultPlan.from_specs([TF.FaultSpec(kind="torn_write")])
    with pytest.raises(TF.TornWriteError):
        TF.atomic_write_json(tmp_path / "torn.json", dict(payload),
                             fault=plan)
    with pytest.raises(ValueError):
        TF.load_checked_json(tmp_path / "torn.json")
    (tmp_path / "bare.json").write_text(json.dumps(payload))
    with pytest.raises(ValueError, match="no 'checksum'"):
        TF.load_checked_json(tmp_path / "bare.json")
    assert list(tmp_path.glob("*.tmp")) == []


def test_drift_schedule_matches_the_reference():
    w = RC.EXPECTED_WORKLOADS[7]
    for kw in (dict(kind="gradual", segments=5, target=(0.1, 0.1, 0.1, 0.7)),
               dict(kind="flip", segments=4, target=(0.7, 0.1, 0.1, 0.1)),
               dict(kind="cyclic", segments=3, target=(1.0, 2.0, 3.0, 4.0)),
               dict(kind="schedule", segments=2,
                    schedule=((1, 1, 1, 1), (4, 3, 2, 1)))):
        np.testing.assert_array_equal(
            tcompile.drift_schedule(w, T.DriftSpec(**kw)),
            rcompile.drift_schedule(w, R.DriftSpec(**kw)))


# ---------------------------------------------------------------------------
# Tunings and arms
# ---------------------------------------------------------------------------

#: two workloads, nominal + rho 1, two policy arms (two tuning plans: the
#: primary CLASSIC one and lazy leveling's), at the committed draws' size
#: and the tuners' 250 steps.  (At 60 steps w4's nominal tiering tuning has
#: not converged: its filter memory sits in a flat region, where float32
#: Adam under XLA and under torch part by 3%, and the exact cost by 0.3%.)
ARMS_SPEC = dict(name="arms2",
                 workload=dict(indices=(4, 11), rhos=(1.0,), nominal=True),
                 design=dict(n_starts=64, steps=250, seed=0,
                             policies=("klsm", "lazy_leveling"),
                             policy_params=(("lazy_leveling",
                                             (("fill", 0.25),)),)))


def _arms_spec(m, **design):
    d = dict(ARMS_SPEC["design"], **design)
    return m.ExperimentSpec(name=ARMS_SPEC["name"],
                            workload=m.WorkloadSpec(**ARMS_SPEC["workload"]),
                            design=m.DesignSpec(**d))


@pytest.fixture(scope="module")
def arms_reports():
    """The reference's run from the committed draws (its former PRNG), and
    the port's from the same draws."""
    with jax.threefry_partitionable(False):
        ref = R.run_experiment(_arms_spec(R))
    got = T.run_experiment(_arms_spec(T), device="cpu",
                           starts=common.committed_starts)
    return ref, got


def test_run_experiment_matches_the_reference(arms_reports):
    """Exact re-scored costs to rel 1e-4, every arm's objective to rel
    1e-4, the same chosen arm and design in every cell.  (Not each cost
    component: where the objective is flat in the filter memory, w11's
    nominal K-LSM tuning ends 0.15% apart in it, and its empty-read cost
    0.35%, at the same total.)"""
    ref, got = arms_reports
    assert got.cells == ref.cells
    for cell in ref.cells:
        assert got.chosen[cell] == ref.chosen[cell]
        for pol in ("klsm", "lazy_leveling"):
            a, b = ref.tuning(cell, pol), got.tuning(cell, pol)
            assert b.design.value == a.design.value
            assert b.cost == pytest.approx(a.cost, rel=1e-4)
            assert got.arm_costs[cell][pol] == pytest.approx(
                ref.arm_costs[cell][pol], rel=1e-4)
    assert got.chosen[(0, 1.0)] == "lazy_leveling"      # w4: write-heavy
    assert got.chosen[(1, 1.0)] == "klsm"


def _assert_same_tuning(a, b):
    assert torch.equal(a.phi.T, b.phi.T)
    assert torch.equal(a.phi.K, b.phi.K)
    assert torch.equal(a.phi.mfilt_bits, b.phi.mfilt_bits)
    assert a.cost == b.cost
    assert a.design is b.design


def _seeded_starts(design, n_starts, seed):
    """A starts provider other than the tuners' own draw."""
    gen = torch.Generator().manual_seed(100 + seed)
    n_par = TC.designs.n_params(design, TC.LSMSystem())
    return torch.rand((1, n_starts, n_par), generator=gen) * 6.0 - 3.0


@pytest.mark.parametrize("starts", ["provided", "own"])
def test_run_experiment_equals_direct_tuners_and_sharded(starts):
    """Inline: bit for bit the port's direct ``tune_*_many`` per plan,
    from a provider's starts or the tuners' own draw.  Sharded over three
    ``"cpu"`` devices: bit for bit inline."""
    provider = _seeded_starts if starts == "provided" else None
    spec = _arms_spec(T, n_starts=8, steps=40, seed=2)
    inline = T.run_experiment(spec, device="cpu", starts=provider)
    sharded = T.run_experiment(
        spec, tbackends.ShardedBackend(devices=["cpu"] * 3), device="cpu",
        starts=provider)
    assert sharded.walls["tuning_devices"] == 3
    assert "tuning_devices" not in inline.walls
    sys_t = TC.LSMSystem()
    W = TC.EXPECTED_WORKLOADS[[4, 11]]
    for pol, design in (("klsm", TC.DesignSpace.CLASSIC),
                        ("lazy_leveling", TC.DesignSpace.LAZY_LEVELING)):
        kw = dict(design=design, n_starts=8, steps=40, seed=2,
                  device="cpu", starts=provider(design, 8, 2)
                  if provider else None)
        nominal = TC.tune_nominal_many(W, sys_t, **kw)
        robust = TC.tune_robust_many(W, [1.0], sys_t, **kw)
        for i in range(2):
            for report in (inline, sharded):
                _assert_same_tuning(report.tuning((i, None), pol),
                                    nominal[i])
                _assert_same_tuning(report.tuning((i, 1.0), pol),
                                    robust[i][0])
    assert sharded.chosen == inline.chosen
    assert sharded.arm_costs == inline.arm_costs


def test_sharded_backend_splits_unevenly_and_keeps_order():
    """Five robust problems over three devices (chunks 2, 1, 2) and the
    nominal pair over three (one empty chunk): the same tunings as one
    inline call, bit for bit."""
    spec = T.ExperimentSpec(
        name="split", workload=T.WorkloadSpec(indices=(0, 11),
                                              rhos=(0.1, 0.5, 2.0)),
        design=T.DesignSpec(space="fluid", n_starts=4, steps=20, seed=5),
        system=SYS_PAIRS)
    plan = next(iter(T.compile_spec(spec).tuning_plans().values()))
    inline = T.InlineBackend().solve(plan, device="cpu")
    backend = T.ShardedBackend(devices=("cpu", "cpu", "cpu"))
    sharded = backend.solve(plan, device="cpu")
    assert backend.used == 3 and list(sharded) == list(inline)
    for cell in inline:
        _assert_same_tuning(sharded[cell], inline[cell])
    assert T.get_backend("sharded").devices_for("cpu") \
        == [torch.device("cpu")]


def test_fixed_design_skips_tuning():
    spec = _checklist_specs(T)["fixed"]
    report = T.run_experiment(spec, device="cpu")
    assert report.walls["tuning_s"] == pytest.approx(0.0, abs=0.05)
    r = report.tuning((0, None), "klsm")
    assert float(r.phi.T) == 6.0 and r.solver == "fixed"
    mc = report.model_costs[(0, None)]
    assert not np.allclose(mc["klsm"], mc["lazy_leveling"])
    ref = R.run_experiment(_checklist_specs(R)["fixed"])
    for pol in ("klsm", "lazy_leveling"):
        np.testing.assert_allclose(mc[pol], ref.model_costs[(0, None)][pol],
                                   rtol=1e-5)
    assert report.chosen == ref.chosen


# ---------------------------------------------------------------------------
# Trial
# ---------------------------------------------------------------------------

TRIAL_CASES = {
    # the Table-5 convention, two arms, tombstones seeded after populate
    "per_workload_keys": dict(n_keys=4000, n_queries=400, sessions=SESSIONS,
                              key_space=2 ** 22, range_fraction=1e-3,
                              per_workload_keys=True, key_seed=100,
                              delete_fraction=0.05),
    # one shared key draw, explicit session seeds, a Zipf-skewed read mix
    "shared_keys": dict(n_keys=5000, n_queries=300,
                        sessions=SESSIONS + ((0.3, 0.3, 0.1, 0.3),),
                        key_space=2 ** 22, session_seeds=(4, 5, 6),
                        zipf_a=1.2),
}


def _trial_plan(case):
    """The reference's TrialPlan for the checklist's spec with two arms
    and the case's trial, and the port's from the same numbers."""
    spec = _checklist_specs(R)["direct"]
    spec = dataclasses.replace(
        spec, workload=R.WorkloadSpec(indices=WIDX, rhos=(1.0,),
                                      nominal=True),
        design=R.DesignSpec(policies=("klsm", "lazy_leveling"),
                            policy_params=(("lazy_leveling",
                                            (("read_trigger", 64),
                                             ("fill", 0.25))),),
                            **SMALL),
        trial=R.TrialSpec(**TRIAL_CASES[case]))
    cx = rcompile.compile_spec(spec)
    solved = {key: rbackends.InlineBackend().solve(plan)
              for key, plan in cx.tuning_plans().items()}
    ref_plan = cx.build_trial(cx.select_arms(solved))
    fields = dataclasses.asdict(ref_plan)
    fields["trees"] = [tcompile.TreeBuild(**dataclasses.asdict(b))
                       for b in ref_plan.trees]
    return ref_plan, tcompile.TrialPlan(**fields)


@pytest.mark.parametrize("case", sorted(TRIAL_CASES))
def test_execute_trial_matches_the_reference(case):
    ref_plan, plan = _trial_plan(case)
    assert all(b.policy_params in ((), (("read_trigger", 64),))
               for b in plan.trees)          # "fill" is the model's only
    ref = rbackends.execute_trial(ref_plan)
    got = tbackends.execute_trial(plan, device="cpu")
    assert len(got[0]) == len(ref[0]) == len(plan.trees) == 8
    for a_row, b_row in zip(ref[0], got[0]):
        assert len(b_row) == len(a_row) == len(plan.sessions)
        for a, b in zip(a_row, b_row):
            assert b.io.as_dict() == a.io.as_dict()
            assert b.avg_io_per_query == a.avg_io_per_query
            np.testing.assert_array_equal(b.window_ops, a.window_ops)
    for a, b in zip(ref[1], got[1]):
        assert dataclasses.asdict(b) == dataclasses.asdict(a)
        assert b.max_tombstone_age == a.max_tombstone_age
    if plan.delete_fraction:
        assert any(p.tomb_ages for p in got[1])
    # a shard of the grid runs alone as it runs in the whole grid
    shard = tbackends.execute_trial(plan, plan.trees[2:4], device="cpu")
    assert [[r.io.as_dict() for r in row] for row in shard[0]] \
        == [[r.io.as_dict() for r in row] for row in got[0][2:4]]


# ---------------------------------------------------------------------------
# Report
# ---------------------------------------------------------------------------

def _port_report(ref):
    """The port's Report holding the reference report's numbers."""
    def tuning(r):
        return TC.TuningResult(
            phi=phi_from_numpy(np.asarray(r.phi.T), np.asarray(
                r.phi.mfilt_bits), np.asarray(r.phi.K)),
            cost=r.cost, design=TC.DesignSpace(r.design.value),
            solver=r.solver)

    return treport.Report(
        spec=T.ExperimentSpec.from_json(ref.spec.to_json()),
        sys=TC.LSMSystem(**dataclasses.asdict(ref.sys)), cells=ref.cells,
        tunings={c: {p: tuning(r) for p, r in arms.items()}
                 for c, arms in ref.tunings.items()},
        arm_costs=ref.arm_costs, chosen=ref.chosen,
        model_costs=ref.model_costs, bench_costs=ref.bench_costs,
        bench_set=ref.bench_set, fleet=ref.fleet, walls=dict(ref.walls))


def test_bench_payload_is_the_reference_bytes(tmp_path):
    spec = dataclasses.replace(
        _checklist_specs(R)["payload"],
        design=R.DesignSpec(policies=("klsm", "lazy_leveling"), **SMALL),
        trial=R.TrialSpec(n_keys=3000, n_queries=200, sessions=SESSIONS,
                          key_space=2 ** 22))
    ref = R.run_experiment(spec)
    got = _port_report(ref)
    with robs.scoped(enabled=False), tobs.scoped(enabled=False):
        a, b = ref.to_bench_payload(), got.to_bench_payload()
        assert json.dumps(b, sort_keys=True) == json.dumps(a, sort_keys=True)
        assert set(b) == {"suite", "wall_time_s", "error", "rows",
                          "checksum"}
        assert TF.checksum_ok(b)
        ref.write_bench_json(str(tmp_path / "r.json"))
        got.write_bench_json(str(tmp_path / "t.json"))
    assert (tmp_path / "t.json").read_bytes() \
        == (tmp_path / "r.json").read_bytes()
    assert [r.csv() for r in got.rows()] == [r.csv() for r in ref.rows()]
    assert got.wall_time_s == ref.wall_time_s
    np.testing.assert_array_equal(got.delta_tp_vs_nominal(0, 1.0),
                                  ref.delta_tp_vs_nominal(0, 1.0))
    np.testing.assert_array_equal(
        got.model_session_io((0, 1.0), SESSIONS, "lazy_leveling"),
        ref.model_session_io((0, 1.0), SESSIONS, "lazy_leveling"))
    np.testing.assert_array_equal(got.measured_io((0, None)),
                                  ref.measured_io((0, None)))
    with tobs.scoped(enabled=True, clock="ticks"):
        traced = got.to_bench_payload()
    assert set(traced) == {"suite", "wall_time_s", "error", "rows",
                           "metrics", "checksum"}
    assert TF.checksum_ok(traced)


def test_report_helpers_are_the_reference_module_s():
    assert treport.Cell == rreport.Cell
    assert [f.name for f in dataclasses.fields(treport.TreeProbe)] \
        == [f.name for f in dataclasses.fields(rreport.TreeProbe)]
    assert [f.name for f in dataclasses.fields(treport.Report)] \
        == [f.name for f in dataclasses.fields(rreport.Report)]
    # the subprocess backend's recovery rows, text for text
    failed = {((0, None), "klsm"): "Traceback\nshard 0 attempt 1: worker "
              "exited 17; stderr: InjectedWorkerCrash: chaos",
              ((1, 0.5), "lazy_leveling"): ""}
    attempts = [{"shard": 0, "attempt": 0, "ok": False, "latency_s": 2.5},
                {"shard": 0, "attempt": 1, "ok": True, "latency_s": 3.25},
                {"shard": 1, "attempt": 0, "ok": True, "latency_s": 3.0}]
    rows = []
    for m, rep in ((T, treport), (R, rreport)):
        report = rep.Report(spec=_checklist_specs(m)["direct"], sys=None,
                            cells=[], tunings={}, arm_costs={}, chosen={},
                            model_costs={}, failed_cells=dict(failed),
                            shard_attempts=list(attempts),
                            walls={"shard_retries": 1.0})
        rows.append([r.csv() for r in report.rows()])
    assert rows[0] == rows[1]
    assert [r.split(",")[0] for r in rows[0]] == ["t_failed", "t_shards",
                                                  "t_walls"]
