"""The port's trace export and calibration (``repro_torch.obs.trace``,
``repro_torch.obs.calibrate``) against the JAX package's, on the CPU.
``tests/test_obs.py`` is the checklist; the telemetry core is held in the
engine and API tests already.

* ``chrome_trace`` of one event list is the reference's document.
* A traced small fleet under the ``ticks`` clock emits the reference's
  event list (names, kinds, tracks, attrs, ``ts``); the ``write_trace``
  documents and the counters are equal once the ``kernel.dispatch.*``
  names are mapped (the port names the device, ``cpu`` here; the
  reference its mode, ``numpy``).
* ``calibrate`` of the same events and model costs is the reference's
  payload: the numpy float64 parts exactly, and the lazy-leveling fill fit
  (through each package's float32 cost model) to the same fill, its
  losses within 1e-5.
* ``import repro_torch.obs, repro_torch.obs.trace`` loads neither torch
  nor numpy.
* A flapping shard's attempts surface in the report, its counters and its
  events; a traced robust tuning counts its ``dual_solve`` dispatches.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.api as R
import repro.core as RC
import repro_torch.api as T
import repro_torch.core as TC
from repro import obs as robs
from repro.obs import calibrate as rcal
from repro.obs import trace as rtrace
from repro_torch import obs as tobs
from repro_torch.bench import obs as tobs_suite
from repro_torch.convert import phi_from_numpy
from repro_torch.obs import calibrate as tcal
from repro_torch.obs import trace as ttrace

SRC = Path(__file__).resolve().parents[1] / "src"
#: the port's dispatch counters name the device, the reference's its mode
DISPATCH = {"kernel.dispatch.merge.cpu": "kernel.dispatch.merge.numpy",
            "kernel.dispatch.point_read.cpu":
                "kernel.dispatch.point_read.numpy"}


@pytest.fixture(autouse=True)
def _isolated_obs():
    """Both packages' process-global telemetry saved and restored around
    every test."""
    prev = tobs.get(), robs.get()
    tobs.disable()
    robs.disable()
    yield
    tobs.core._T, robs.core._T = prev


def _fleet_spec(m):
    """A small traced fleet: three policies, two sessions, tombstones."""
    return m.ExperimentSpec(
        name="obs_golden",
        workload=m.WorkloadSpec(workloads=((0.25, 0.25, 0.25, 0.25),),
                                rhos=(), nominal=True),
        design=m.DesignSpec(fixed=(4.0, 4.0, 1.0),
                            policies=("klsm", "lazy_leveling",
                                      "tombstone_ttl")),
        trial=m.TrialSpec(n_keys=4_000, n_queries=400,
                          sessions=((0.4, 0.2, 0.2, 0.2),
                                    (0.1, 0.1, 0.1, 0.7)),
                          key_space=2 ** 20, key_seed=7,
                          session_seeds=(11, 12), delete_fraction=0.01),
        system=(("N", 4000.0), ("entry_bits", 512.0),
                ("page_bits", 4096.0 * 8), ("bits_per_entry", 6.0),
                ("min_buf_bits", 512.0 * 64), ("s_rq", 1e-3),
                ("max_T", 30.0)))


def test_chrome_trace_is_the_reference_document(tmp_path):
    tobs.configure(enabled=True, clock="ticks")
    with tobs.track("w0/klsm"):
        with tobs.span("engine.flush", entries=5):
            tobs.event("drift.decide", kl=0.1)
    tobs.event("outside")
    tobs.count("engine.flush")
    events = tobs.events_snapshot()
    counters = tobs.metrics_snapshot()["counters"]
    for clock in ("ticks", "wall"):
        for name in ("repro", "port"):
            assert ttrace.chrome_trace(events, clock, counters, name) \
                == rtrace.chrome_trace(events, clock, counters, name)
    doc = ttrace.chrome_trace(events, "ticks", counters)
    assert {e["ph"] for e in doc["traceEvents"]} == {"M", "X", "i", "C"}
    assert any(e["ph"] == "M" and e["args"].get("name") == "w0/klsm"
               for e in doc["traceEvents"])
    path = tmp_path / "trace.json"
    assert ttrace.write_trace(str(path)) == len(events)
    on_disk = json.loads(path.read_text())
    assert on_disk.pop("checksum") and on_disk == doc
    tobs.disable()
    assert ttrace.write_trace(str(path)) == 0
    assert json.loads(path.read_text())["traceEvents"] == []


def test_traced_fleet_is_the_reference_s(tmp_path):
    with robs.scoped(enabled=True, clock="ticks") as rt:
        R.run_experiment(_fleet_spec(R))
    with tobs.scoped(enabled=True, clock="ticks") as tt:
        T.run_experiment(_fleet_spec(T), device="cpu")
    events = tt.events_snapshot()
    assert events == rt.events_snapshot()
    assert sum(e["name"] == "session.execute" for e in events) == 6
    counters = tt.metrics_snapshot()["counters"]
    assert set(DISPATCH) <= set(counters)
    assert {DISPATCH.get(k, k): v for k, v in counters.items()} \
        == rt.metrics_snapshot()["counters"]
    ttrace.write_trace(str(tmp_path / "t.json"), tt)
    rtrace.write_trace(str(tmp_path / "r.json"), rt)
    got = json.loads((tmp_path / "t.json").read_text())
    want = json.loads((tmp_path / "r.json").read_text())
    for doc in (got, want):
        doc.pop("checksum")
    for ev in got["traceEvents"]:
        ev["name"] = DISPATCH.get(ev["name"], ev["name"])
    got["traceEvents"].sort(key=lambda e: (e["ph"] == "C", e["name"]))
    want["traceEvents"].sort(key=lambda e: (e["ph"] == "C", e["name"]))
    assert got == want
    lanes = {e["args"]["name"] for e in got["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"w0.rhoNone/klsm", "w0.rhoNone/lazy_leveling",
            "w0.rhoNone/tombstone_ttl"} <= lanes


def _ref_traced_leg():
    """The obs suite's traced leg in the JAX package at a small size."""
    from benchmarks import bench_obs
    spec = dataclasses.replace(
        bench_obs.SPEC,
        trial=dataclasses.replace(bench_obs.SPEC.trial, n_keys=8000,
                                  n_queries=800),
        system=(("N", 8000.0),) + bench_obs.SPEC.system[1:])
    with robs.scoped(enabled=True, clock="wall") as t:
        report = R.run_experiment(spec)
    return report, t.events_snapshot()


def test_calibration_is_the_reference_payload(tmp_path):
    report, events = _ref_traced_leg()
    cell = tobs_suite.CELL
    pols = tobs_suite.POLICIES
    phis = {p: report.tuning(cell, p).phi for p in pols}
    want = rcal.calibrate(events, model_costs=report.model_costs[cell],
                          phi_by_policy=phis, sys=report.sys,
                          policy_params=report.spec.design.policy_params)
    got = tcal.calibrate(
        events, model_costs=report.model_costs[cell],
        phi_by_policy={p: phi_from_numpy(np.asarray(ph.T),
                                         np.asarray(ph.mfilt_bits),
                                         np.asarray(ph.K))
                       for p, ph in phis.items()},
        sys=TC.LSMSystem(**dataclasses.asdict(report.sys)),
        policy_params=report.spec.design.policy_params, device="cpu")
    assert set(got["policies"]) == set(want["policies"]) == set(pols)
    assert got["schema"] == want["schema"] == "repro.obs.calibration.v1"
    assert got["all_fitted_ge_hand"] is want["all_fitted_ge_hand"] is True
    for pol in pols:
        g, w = dict(got["policies"][pol]), dict(want["policies"][pol])
        gf, wf = g.pop("fill", None), w.pop("fill", None)
        assert g == w, pol                     # numpy float64: exact
        assert (gf is None) == (wf is None) == (pol != "lazy_leveling")
    gf = got["policies"]["lazy_leveling"]["fill"]
    wf = want["policies"]["lazy_leveling"]["fill"]
    assert (gf["fill_hand"], gf["fill_fitted"]) \
        == (wf["fill_hand"], wf["fill_fitted"])
    for key in ("loss_hand", "loss_fitted"):
        assert abs(gf[key] - wf[key]) <= 1e-5, key
    tcal.write_calibration(str(tmp_path / "t.json"), got)
    on_disk = json.loads((tmp_path / "t.json").read_text())
    from repro_torch.faults import checksum_ok
    assert checksum_ok(on_disk) and on_disk["schema"] == tcal.SCHEMA


def _synthetic_events(c, n=6, seed=0):
    rng = np.random.default_rng(seed)
    events = []
    eye = np.eye(4) * 0.85 + 0.05
    for i in range(n):
        mix = eye[i % 4] / eye[i % 4].sum() if i < 4 else \
            rng.dirichlet((1.0,) * 4)
        events.append({
            "seq": i, "kind": "span", "name": "session.execute",
            "ts": float(i), "track": "w0/klsm", "dur": 1.0,
            "sid": i + 1, "parent": 0,
            "attrs": {"mix": [float(x) for x in mix],
                      "avg_io": float(mix @ c), "queries": 100},
        })
    return events


def test_weight_fit_is_the_reference_s():
    c_true = np.array([1.5, 0.4, 2.0, 3.0])
    c_hand = c_true * np.array([1.3, 0.7, 1.1, 0.9])
    events = _synthetic_events(c_true)
    got = tcal.calibrate(events, model_costs={"klsm": c_hand,
                                              "partial": c_hand})
    assert got == rcal.calibrate(events, model_costs={"klsm": c_hand,
                                                      "partial": c_hand})
    fit = got["policies"]["klsm"]
    assert set(got["policies"]) == {"klsm"}      # no partial samples
    np.testing.assert_allclose(fit["c_fitted"], c_true, rtol=1e-4)
    np.testing.assert_allclose(fit["alpha"], c_true / c_hand, rtol=1e-4)
    samples = tcal.session_samples(events)
    for a, b in zip(samples, rcal.session_samples(events)):
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(a["mix"], b["mix"])
        assert (a["label"], a["avg_io"], a["queries"]) \
            == (b["label"], b["avg_io"], b["queries"])
    assert tcal.agreement(np.array([2.0]), np.array([1.0])) \
        == rcal.agreement(np.array([2.0]), np.array([1.0])) == (2.0, 0.5)


def test_obs_import_is_torch_and_numpy_free():
    code = ("import sys, repro_torch.obs, repro_torch.obs.trace\n"
            "bad = {'torch', 'numpy', 'jax', 'repro'} & set(sys.modules)\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("REPRO_OBS", None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_flapping_shard_attempts_surface_in_report(monkeypatch):
    """A shard that crashes once and recovers: every attempt is logged, the
    walls carry the count, rows() renders the flapping-shard summary, and
    telemetry sees the fault."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    spec = T.ExperimentSpec(
        name="flap",
        workload=T.WorkloadSpec(indices=(7, 11), rhos=(), nominal=True,
                                bench_n=0),
        design=T.DesignSpec(fixed=(6.0, 4.0, 1.0)),
        trial=T.TrialSpec(n_keys=4000, n_queries=300,
                          sessions=((0.05, 0.85, 0.05, 0.05),)),
        system=(("N", 8000.0), ("bits_per_entry", 6.0), ("max_T", 20.0)),
        backend="subprocess",
        backend_params=(("workers", 2), ("max_retries", 2),
                        ("backoff_s", 0.01), ("timeout_s", 120.0)),
        faults=(T.FaultSpec(kind="crash", shards=(0,), max_hits=1, seed=3),),
    )
    with tobs.scoped(enabled=True, clock="ticks"):
        report = T.run_experiment(spec, device="cpu")
        counters = tobs.metrics_snapshot()["counters"]
        names = {e["name"] for e in tobs.events_snapshot()}
    log = report.shard_attempts
    print("attempt latencies:", log)
    assert log, "per-attempt log missing from Report"
    assert report.walls["shard_attempt_count"] == len(log)
    shard0 = [a for a in log if a["shard"] == 0]
    assert [a["ok"] for a in shard0] == [False, True]     # flapped
    assert all(a["latency_s"] >= 0 for a in log)
    row = next(r for r in report.rows() if r.name.endswith("_shards"))
    assert row.derived["flapping_shards"] == [0]
    assert row.derived["failed_attempts"] == 1
    assert row.derived["attempts"] == len(log)
    assert counters["shard.failed_attempts"] == 1
    assert counters["shard.attempts"] == len(log)
    assert counters["shard.resumed"] == 0
    assert {"shard.fault_injected", "shard.attempt"} <= names


def test_traced_robust_tuning_counts_dual_solve_dispatches():
    """The dispatch counters of ``dual_solve`` name the device, as the merge
    and read paths' do: a traced robust tuning of 4 Adam steps calls the
    warm solve once per step and once more for the final iterate, and
    records the reference's counter name; a nominal tuning calls none; a
    direct lane-batched call counts ``dual_solve_batch``."""
    w = (0.25, 0.25, 0.25, 0.25)
    with tobs.scoped(enabled=True, clock="ticks"):
        TC.tune_nominal(w, TC.LSMSystem(), n_starts=2, steps=4,
                        device="cpu")
        assert not any("dual_solve" in k for k in
                       tobs.metrics_snapshot().get("counters", {}))
        TC.tune_robust(w, 0.5, TC.LSMSystem(), n_starts=2, steps=4,
                       device="cpu")
        counters = tobs.metrics_snapshot()["counters"]
    dual = {k: v for k, v in counters.items() if "dual_solve" in k}
    assert dual == {"kernel.dispatch.dual_solve.cpu": 5}
    with robs.scoped(enabled=True, clock="ticks"):
        RC.tune_robust(np.asarray(w, np.float32), 0.5, RC.LSMSystem(),
                       n_starts=2, steps=4)
        ref = robs.metrics_snapshot()["counters"]
    assert {k.rsplit(".", 1)[0] for k in ref if "dual_solve" in k} \
        == {"kernel.dispatch.dual_solve"}
    import torch
    from repro_torch.kernels.dual_solve import ops
    C = torch.ones(3, 4)
    with tobs.scoped(enabled=True, clock="ticks"):
        ops.dual_solve_warm_batch(C, torch.full((4,), 0.25),
                                  torch.full((3,), 0.5), torch.zeros(3))
        assert tobs.metrics_snapshot()["counters"] \
            == {"kernel.dispatch.dual_solve_batch.cpu": 1}


def test_runner_trace_writes_the_trace_and_metrics(tmp_path, monkeypatch,
                                                   capsys):
    """``python -m repro_torch.bench.run --spec FILE --trace DIR``: telemetry
    on, ``REPRO_OBS_OUT`` set, and the run's Chrome trace and metrics
    written, checksummed, with the fleet's lanes and session spans."""
    from repro_torch.bench import run
    from repro_torch.faults import load_checked_json
    monkeypatch.setenv("REPRO_OBS_OUT", "")
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(_fleet_spec(T).to_json())
    out = tmp_path / "trace"
    assert run.main(["--spec", str(spec_path), "--device", "cpu",
                     "--trace", str(out)]) == 0
    assert os.environ["REPRO_OBS_OUT"] == str(out)
    text = capsys.readouterr().out
    assert "# trace obs_golden: " in text
    doc = load_checked_json(str(out / "trace_obs_golden.json"))
    assert sum(e["ph"] == "X" and e["name"] == "session.execute"
               for e in doc["traceEvents"]) == 6
    metrics = load_checked_json(str(out / "metrics_obs_golden.json"))
    assert metrics["counters"]["kernel.dispatch.merge.cpu"] > 0
