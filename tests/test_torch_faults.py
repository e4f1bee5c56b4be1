"""The port's fault layer (``repro_torch.faults``) and its subprocess and
remote backends (``repro_torch.api.backends``) against the JAX package's,
on the CPU.  ``tests/test_faults.py`` is the checklist; the fault-spec
validation, ``FaultPlan`` firings, ``u01`` and the checksummed JSON writer
are held in ``tests/test_torch_api.py`` already.

* Pure parts, the same outputs for the same inputs: ``RetryPolicy.delay``
  and ``ShardSupervisor.reassign`` on a grid, ``_partition``, the bytes of
  ``dump_job``, the ``RemoteBackend`` envelope text.
* The recovery invariant: every chaos scenario's subprocess report (its
  workers on the CPU) is bit-identical to the port's inline report and to
  the JAX package's inline report of the same small spec — crash, corrupt
  plus slow, hang, the probabilistic storm, a dead shard re-sharded;
  systemic failure degrades to ``failed_cells`` with the worker's stderr;
  resume reuses persisted shards and ignores torn and foreign ones.
* A worker asked for the card on this CPU-only host fails visibly (a
  ``ShardFailure`` with its stderr), never running on the CPU instead.
* ``python -m repro_torch.bench.run --spec --run-dir [--resume]``, and the
  runner's counterparts of the JAX runner's baseline validation.

Each worker is a fresh interpreter that imports torch (about 3 s here), so
the spec is the reference's small one (4,000 keys, 300 queries) and the
inline references are computed once.  The hang test's ``timeout_s`` is 30
s, not the reference's 10, so a healthy attempt's start-up cannot reach
it.
"""

import dataclasses
import glob
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro.api as R
import repro.faults as RF
import repro_torch.api as T
import repro_torch.faults as TF
from repro.api import backends as rbackends
from repro.api import compile as rcompile
from repro_torch.api import backends as tbackends
from repro_torch.bench import run as trun
from repro_torch.bench.faults import trial_signature as _trial

REPO = Path(__file__).resolve().parents[1]
SESSIONS = ((0.05, 0.85, 0.05, 0.05),)
SEED = 0


@pytest.fixture(scope="module", autouse=True)
def _one_thread_workers():
    """Workers inherit the environment: one intra-op thread each, so two
    workers beside other busy test processes do not oversubscribe."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")
    yield
    mp.undo()


def _spec(m, **kw):
    """The reference's chaos spec, from API module ``m``."""
    base = dict(
        name="chaos",
        workload=m.WorkloadSpec(indices=(7, 11), rhos=(), nominal=True,
                                bench_n=0),
        design=m.DesignSpec(fixed=(6.0, 4.0, 1.0)),
        trial=m.TrialSpec(n_keys=4000, n_queries=300, sessions=SESSIONS),
        system=(("N", 8000.0), ("bits_per_entry", 6.0), ("max_T", 20.0)),
    )
    base.update(kw)
    return m.ExperimentSpec(**base)


def _sub_params(**kw):
    base = dict(workers=2, max_retries=2, backoff_s=0.01, timeout_s=120.0,
                retry_seed=SEED)
    base.update(kw)
    return tuple(base.items())


def _chaos(*faults, **params):
    return T.run_experiment(_spec(T, backend="subprocess",
                                  backend_params=_sub_params(**params),
                                  faults=tuple(faults)), device="cpu")


@pytest.fixture(scope="module")
def inline():
    """The two references every chaos scenario must reproduce exactly:
    the port's inline report and the JAX package's."""
    port = T.run_experiment(_spec(T), device="cpu")
    ref = R.run_experiment(_spec(R))
    return port, ref


def _assert_identical(inline, chaos):
    """The recovery invariant, at full strength, against both references."""
    port, ref = inline
    assert _trial(port) == _trial(ref)
    assert _trial(chaos) == _trial(port)
    assert set(chaos.fleet) == set(port.fleet) and chaos.fleet
    assert not chaos.failed_cells


# ---------------------------------------------------------------------------
# Pure parts against the reference
# ---------------------------------------------------------------------------

def test_retry_policy_and_supervisor_are_the_reference_s():
    for seed in (0, 3):
        for backoff in (0.01, 0.1):
            pt = TF.RetryPolicy(max_retries=3, backoff_s=backoff, seed=seed)
            pr = RF.RetryPolicy(max_retries=3, backoff_s=backoff, seed=seed)
            assert pt.attempts() == pr.attempts() == 4
            for shard in range(5):
                for attempt in range(-1, 5):
                    assert pt.delay(shard, attempt) \
                        == pr.delay(shard, attempt)
    pol = TF.RetryPolicy(max_retries=3, backoff_s=0.1, seed=SEED)
    d1, d2, d3 = (pol.delay(0, a) for a in (1, 2, 3))
    assert 0.05 <= d1 < 0.15 and 0.10 <= d2 < 0.30 and 0.20 <= d3 < 0.60
    assert pol.delay(1, 1) != d1          # de-synchronized across shards

    st, sr = TF.ShardSupervisor(), RF.ShardSupervisor()
    for sup in (st, sr):
        sup.record_failure(1, "boom")
        sup.record_failure(1, "boom again")
        sup.mark_dead(1)
        sup.mark_dead(1)
        sup.mark_completed(0)
    assert (st.dead, st.retries, st.last_error(1), st.last_error(5)) \
        == (sr.dead, sr.retries, sr.last_error(1), sr.last_error(5)) \
        == ([1], 2, "boom again", "<no error recorded>")
    for trees in ([], [3], [9, 3, 5], list(range(11, 0, -2)), [4, 4, 1]):
        for cap in (0, 1, 2, 3, 8):
            assert st.reassign(trees, cap) == sr.reassign(trees, cap)
    assert st.reassign([9, 3, 5], capacity=2) == [[3, 9], [5]]


def test_partition_is_the_reference_s():
    for per_workload in (False, True):
        for widx in ((7, 11), (4, 7, 9, 11), (0, 3, 5, 7, 9)):
            specs = [_spec(m, workload=m.WorkloadSpec(
                indices=widx, rhos=(), nominal=True, bench_n=0),
                design=m.DesignSpec(fixed=(6.0, 4.0, 1.0),
                                    policies=("klsm", "lazy_leveling")),
                trial=m.TrialSpec(n_keys=4000, n_queries=300,
                                  sessions=SESSIONS,
                                  per_workload_keys=per_workload))
                for m in (T, R)]
            tplan = T.compile_spec(specs[0]).build_trial(
                T.compile_spec(specs[0]).select_arms({}))
            rplan = rcompile.compile_spec(specs[1]).build_trial(
                rcompile.compile_spec(specs[1]).select_arms({}))
            for workers in (1, 2, 3, 4, 16):
                assert tbackends.SubprocessBackend(
                    workers=workers)._partition(tplan) \
                    == rbackends.SubprocessBackend(
                        workers=workers)._partition(rplan)


def test_job_files_are_the_reference_s(tmp_path):
    payload = {"plan": "d", "trees": {0: (1, 2.5, "x"), 3: [None, True]},
               "populate_s": 0.25}
    TF.dump_job(str(tmp_path / "t.pkl"), payload)
    RF.dump_job(str(tmp_path / "r.pkl"), payload)
    assert (tmp_path / "t.pkl").read_bytes() \
        == (tmp_path / "r.pkl").read_bytes()
    assert TF.load_job(str(tmp_path / "r.pkl")) == payload
    assert RF.load_job(str(tmp_path / "t.pkl")) == payload
    # an injected torn write: truncated bytes at the final path, an error,
    # and a loader that never trusts the result
    tear = TF.FaultPlan.from_specs((TF.FaultSpec(kind="torn_write",
                                                 match="job_", seed=SEED),))
    path = str(tmp_path / "job_a.pkl")
    with pytest.raises(TF.TornWriteError):
        TF.dump_job(path, payload, fault=tear)
    assert TF.load_job(path) is None
    assert TF.load_job(str(tmp_path / "absent.pkl")) is None
    (tmp_path / "garbage.pkl").write_bytes(b"\x00\x01nonsense")
    assert TF.load_job(str(tmp_path / "garbage.pkl")) is None
    TF.atomic_write_bytes(str(tmp_path / "sub.bin"), b"x" * 1000)
    assert sorted(os.listdir(tmp_path)) == ["garbage.pkl", "job_a.pkl",
                                           "r.pkl", "sub.bin", "t.pkl"]


def test_remote_envelope_is_the_reference_s():
    params = dict(scheduler="slurm", queue="gpu", max_retries=3,
                  backoff_s=0.2, timeout_s=60.0, retry_seed=7)
    for name in ("faults", "round_trip"):
        kw = dict(backend="remote")
        if name == "faults":
            kw["faults"] = (T.FaultSpec(kind="crash", p=0.5, seed=2),)
        tspec = _spec(T, **kw)
        rspec = _spec(R, **{k: v if k != "faults" else
                            (R.FaultSpec(kind="crash", p=0.5, seed=2),)
                            for k, v in kw.items()})
        text = R.RemoteBackend(**params).serialize_job(rspec)
        assert T.RemoteBackend(**params).serialize_job(tspec) == text
        spec, retry = T.RemoteBackend.deserialize_job(text)
        assert spec == tspec and spec.to_dict() == rspec.to_dict()
        assert retry == {"max_retries": 3, "backoff_s": 0.2,
                         "timeout_s": 60.0, "seed": 7}
        env = json.loads(text)
        with pytest.raises(ValueError, match="checksum"):
            T.RemoteBackend.deserialize_job(
                json.dumps(dict(env, queue="cpu")))
        with pytest.raises(ValueError, match="version"):
            T.RemoteBackend.deserialize_job(
                json.dumps(TF.stamp_checksum(dict(env, version=1))))
        with pytest.raises(ValueError):
            T.RemoteBackend.deserialize_job(text[: len(text) // 2])
        with pytest.raises(ValueError, match="version"):
            T.RemoteBackend.deserialize_job("[2]")


# ---------------------------------------------------------------------------
# The recovery invariant, end to end
# ---------------------------------------------------------------------------

def test_crash_retry_bit_identical(inline):
    chaos = _chaos(TF.FaultSpec(kind="crash", shards=(0,), max_hits=1,
                                seed=SEED))
    assert chaos.walls["shard_retries"] >= 1
    _assert_identical(inline, chaos)


def test_corrupt_and_slow_bit_identical(inline):
    chaos = _chaos(TF.FaultSpec(kind="corrupt", shards=(1,), max_hits=1,
                                seed=SEED),
                   TF.FaultSpec(kind="slow", shards=(0,), delay_s=0.2,
                                max_hits=1, seed=SEED))
    assert chaos.walls["shard_retries"] >= 1    # the corrupt result
    _assert_identical(inline, chaos)


def test_hung_worker_times_out_and_recovers(inline):
    chaos = _chaos(TF.FaultSpec(kind="hang", shards=(1,), max_hits=1,
                                seed=SEED), timeout_s=30.0)
    print("attempt latencies:", chaos.shard_attempts)
    assert chaos.walls["shard_retries"] == 1
    hung = [a for a in chaos.shard_attempts if not a["ok"]]
    assert [(a["shard"], a["attempt"]) for a in hung] == [(1, 0)]
    assert hung[0]["latency_s"] >= 30.0
    assert all(a["latency_s"] < 30.0 for a in chaos.shard_attempts
               if a["ok"])
    _assert_identical(inline, chaos)


def test_probabilistic_chaos_storm_bit_identical(inline):
    """Mixed-kind storm with p < 1; max_hits=1 bounds every population to
    first attempts, so the retry budget always wins."""
    chaos = _chaos(TF.FaultSpec(kind="crash", p=0.6, max_hits=1, seed=SEED),
                   TF.FaultSpec(kind="corrupt", p=0.6, max_hits=1,
                                seed=SEED + 1),
                   TF.FaultSpec(kind="slow", p=0.6, delay_s=0.1, max_hits=1,
                                seed=SEED + 2), max_retries=3)
    _assert_identical(inline, chaos)


def test_dead_shard_resharded_onto_survivors(inline):
    """Every retry on shard 1 crashes, so its trees regroup onto fresh
    slots (which re-roll the fault draws)."""
    chaos = _chaos(TF.FaultSpec(kind="crash", shards=(1,), max_hits=99,
                                seed=SEED), max_retries=1)
    assert chaos.walls["reshard_trees"] >= 1
    assert chaos.walls["shards_run"] >= 3       # 2 first-round + re-shard
    _assert_identical(inline, chaos)


def test_systemic_failure_degrades_gracefully():
    """Every shard dead on every attempt: no survivors, no re-shard; the
    sweep completes with explicit failed_cells whose errors carry the
    worker's stderr, and the report renders and serializes."""
    chaos = _chaos(TF.FaultSpec(kind="crash", max_hits=99, seed=SEED),
                   max_retries=1)
    assert not chaos.fleet
    assert len(chaos.failed_cells) == 2
    for err in chaos.failed_cells.values():
        assert "stderr:" in err and "InjectedWorkerCrash" in err
        assert "exited 17" in err
    failed_rows = [r for r in chaos.rows() if r.name.endswith("_failed")]
    assert len(failed_rows) == 1
    assert failed_rows[0].derived["failed"] == 2
    payload = chaos.to_bench_payload()
    json.dumps(payload, allow_nan=False)
    assert TF.checksum_ok(payload)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a host with a card runs its workers there")
def test_worker_asked_for_the_card_fails_visibly(inline):
    """On a host without CUDA a worker asked for the card (the port's
    default) raises and exits non-zero: its attempt is a ShardFailure
    carrying its stderr, and the sweep degrades instead of running on the
    CPU."""
    backend = T.SubprocessBackend(workers=2, max_retries=0)
    port = inline[0]
    cx = T.compile_spec(port.spec)
    plan = cx.build_trial(cx.select_arms({}))
    with pytest.raises(tbackends.ShardFailure) as err:
        backend._launch(tbackends._worker_cmd(), tbackends._worker_env(),
                        plan, [0], 0, 0, None, "cuda")
    assert "worker exited 1" in str(err.value)
    assert "CUDA is not available" in str(err.value)
    report = T.run_experiment(dataclasses.replace(
        port.spec, backend="subprocess",
        backend_params=_sub_params(max_retries=0)))
    assert not report.fleet and len(report.failed_cells) == 2
    assert all("CUDA is not available" in e
               for e in report.failed_cells.values())


# ---------------------------------------------------------------------------
# Persistence and resume
# ---------------------------------------------------------------------------

def test_resume_reuses_completed_shards(tmp_path, inline):
    run_dir = str(tmp_path / "run")
    # run 1: shard 1 permanently dead, no re-sharding -> partial sweep,
    # shard 0's results persisted as they completed
    r1 = _chaos(TF.FaultSpec(kind="crash", shards=(1,), max_hits=99,
                             seed=SEED),
                max_retries=1, reshard=False, run_dir=run_dir)
    assert r1.failed_cells and len(r1.fleet) == 1
    assert glob.glob(os.path.join(run_dir, "job_*.pkl"))
    # run 2: same plan, no faults, resume -> only the missing tree runs
    r2 = _chaos(run_dir=run_dir, resume=True)
    assert r2.walls["resumed_trees"] == 1
    assert r2.walls["shards_run"] == 1
    _assert_identical(inline, r2)
    # run 3: everything persisted -> zero shards execute
    r3 = _chaos(run_dir=run_dir, resume=True)
    assert r3.walls["resumed_trees"] == 2
    assert r3.walls["shards_run"] == 0
    _assert_identical(inline, r3)


def test_resume_ignores_other_plans_and_torn_jobs(tmp_path, inline):
    run_dir = str(tmp_path / "run")
    # the first run tears shard 0's job file (an injected torn write: the
    # file's name ends with a tag of its shard's trees)
    tag = tbackends._job_tag([0])
    first = _chaos(TF.FaultSpec(kind="torn_write", match=tag, seed=SEED),
                   run_dir=run_dir)
    jobs = sorted(glob.glob(os.path.join(run_dir, "job_*.pkl")))
    assert len(jobs) == 2 and first.walls["persist_failures"] == 1
    assert sum(TF.load_job(j) is None for j in jobs) == 1
    _assert_identical(inline, first)
    # plant one job from a foreign plan
    TF.dump_job(os.path.join(run_dir, "job_feedbeef_cafe.pkl"),
                {"plan": "feedbeef", "trees": {0: ("wrong", "wrong")}})
    r = _chaos(run_dir=run_dir, resume=True)
    # torn job -> its tree re-executed; foreign plan -> never consumed
    assert r.walls["resumed_trees"] == 1
    assert r.walls["shards_run"] == 1
    _assert_identical(inline, r)


def test_run_cli_spec_run_dir_and_resume(tmp_path):
    """The operator workflow: ``--spec --run-dir``, then ``--resume``."""
    spec = _spec(T, name="fcli", backend="subprocess",
                 backend_params=_sub_params())
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(spec.to_json())
    run_dir = str(tmp_path / "run")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))

    def cli(*extra):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.bench.run", "--spec",
             str(spec_path), "--device", "cpu", *extra],
            cwd=tmp_path, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, timeout=300)

    first = cli("--run-dir", run_dir)
    assert first.returncode == 0, first.stderr.decode()
    assert glob.glob(os.path.join(run_dir, "job_*.pkl"))
    second = cli("--run-dir", run_dir, "--resume")
    assert second.returncode == 0, second.stderr.decode()
    text = second.stdout.decode()
    assert "shards_run=0" in text and "resumed_trees=2" in text

    def rows(t):
        return [ln for ln in t.splitlines() if ln.startswith("fcli_w")
                and not ln.startswith("fcli_walls")]
    assert rows(first.stdout.decode()) == rows(text) and rows(text)
    # --resume without --run-dir is a usage error, not a fresh run
    out = cli("--resume")
    assert out.returncode == 2 and b"--run-dir" in out.stderr


# ---------------------------------------------------------------------------
# The runner's baseline validation
# ---------------------------------------------------------------------------

def test_runner_rejects_invalid_baselines(tmp_path):
    """The counterpart of the JAX runner's ``_load_baselines`` check: a
    torn file, a checksum mismatch and a file without a checksum are each
    refused as a ``BaselineError``; a valid one loads."""
    (tmp_path / "BENCH_x.json").write_text('{"suite": "x", "wall')
    good = TF.atomic_write_json(str(tmp_path / "BENCH_y.json"),
                                {"suite": "y", "wall_time_s": 1.0,
                                 "rows": []})
    (tmp_path / "BENCH_y.json").write_text(
        json.dumps(dict(good, wall_time_s=2.0)))
    (tmp_path / "BENCH_z.json").write_text(
        json.dumps({"suite": "z", "wall_time_s": 1.0, "rows": []}))
    with pytest.raises(trun.BaselineError, match="unreadable"):
        trun.load_baseline("x", tmp_path)
    for suite in ("y", "z"):
        with pytest.raises(trun.BaselineError, match="checksum"):
            trun.load_baseline(suite, tmp_path)
    TF.atomic_write_json(str(tmp_path / "BENCH_x.json"),
                         {"suite": "x", "wall_time_s": 1.0, "rows": []})
    assert trun.load_baseline("x", tmp_path)["suite"] == "x"


def test_committed_baselines_are_checksum_valid():
    """Every committed ``BENCH_<suite>.json`` passes the port's loaders,
    the ones of the port's suites through the runner's."""
    paths = sorted(REPO.glob("BENCH_*.json"))
    assert paths
    for path in paths:
        TF.load_checked_json(str(path))
        suite = path.stem[len("BENCH_"):]
        if suite in trun.SUITES:
            assert trun.load_baseline(suite, REPO)["suite"] == suite
