"""The port's online drift loop (``repro_torch.online``) and re-tune storm
(``repro_torch.checkpoint.store``) against the JAX package's
(``repro.online``, ``repro.checkpoint.store``), on the CPU.

* Estimation: ``normalize_counts``, ``smooth_mix``, ``kl_np``, the window
  history (its ring wrap-around), both estimators and ``rho_from_windows``
  bit-equal in float64 on seeded counts; ``rho_from_history_batch``
  (float32 in both, through each package's ``kl_divergence``) to rel 1e-6.
* Triggers: Page-Hinkley, CUSUM and ``DriftPolicy.decide`` fire on the same
  segments of seeded KL streams, with the same state.
* Storms: ``retune_storm`` from the committed starts matches the
  reference's exact costs to rel 1e-4 on robust requests and 1e-3 on
  nominal ones, padded and unpadded, and padding leaves the surviving
  results bit for bit as they are.
* The loop: ``execute_drift`` on a small flip spec with the reference's
  tunings carried across (every storm replayed) gives the reference's
  segment records, its re-tunes and its ``LSMTree.retune`` calls bit for
  bit, through the port's ``run_drift`` and ``Report.drift`` rows too;
  the sharded backend's drift equals the inline one's; so does a
  scenario plan (``burst_storm``).
* The tuner's step: tab5's w7 nominal lanes in float64 follow the
  reference's trajectories to 1e-9 for 34 Adam steps from a first
  difference of one ulp, and end on the same integral tunings; the
  float32 parting is that rounding, grown.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as R
import repro.checkpoint.store as rstore
import repro.core as RC
import repro.online as RO
import repro_torch.api as T
import repro_torch.checkpoint.store as tstore
import repro_torch.core as TC
import repro_torch.online as TO
from repro.api import compile as rcompile
from repro.online import session as rsession
from repro_torch import obs as tobs
from repro_torch.api import report as treport
from repro_torch.bench import common, online as tonline, tab5 as ttab5
from repro_torch.online import session as tsession
from repro import obs as robs

import torch_carry as carry


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The storms' lane batches are small: torch's intra-op threads gain
    nothing on them and, beside other busy test processes, spin-wait the
    run 30x longer."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _counts(seed, n=12, zero_rows=(3,), zero_cols=((5, 2),)):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 400, (n, 4)).astype(np.int64)
    for i in zero_rows:
        c[i] = 0
    for i, j in zero_cols:
        c[i, j] = 0
    return c


# ---------------------------------------------------------------------------
# Estimation
# ---------------------------------------------------------------------------

def test_exports_are_the_reference_s_but_memory_arbitration():
    """The reference's exports, memory arbitration included since it was
    ported (the name predates it)."""
    assert set(TO.__all__) == set(RO.__all__)
    assert TO.MEMORY_ARMS == RO.MEMORY_ARMS
    assert all(hasattr(TO, name) for name in TO.__all__)
    assert TO.ARMS == RO.ARMS
    assert [f.name for f in dataclasses.fields(TO.SegmentRecord)] \
        == [f.name for f in dataclasses.fields(RO.SegmentRecord)]
    assert [f.name for f in dataclasses.fields(TO.DriftPolicy)] \
        == [f.name for f in dataclasses.fields(RO.DriftPolicy)]
    assert TO.DriftPolicy() == TO.DriftPolicy(**dataclasses.asdict(
        RO.DriftPolicy()))
    import repro.checkpoint as rcheck
    import repro_torch.checkpoint as tcheck
    assert set(tcheck.__all__) == set(rcheck.__all__)
    assert all(hasattr(tcheck, name) for name in tcheck.__all__)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mix_helpers_are_bit_equal(seed):
    c = _counts(seed)
    np.testing.assert_array_equal(TO.normalize_counts(c),
                                  RO.normalize_counts(c))
    np.testing.assert_array_equal(TO.normalize_counts(c[0]),
                                  RO.normalize_counts(c[0]))
    m = RO.normalize_counts(c)
    for eps in (0.004, 0.1):
        np.testing.assert_array_equal(TO.smooth_mix(m, eps),
                                      RO.smooth_mix(m, eps))
    q = RO.smooth_mix(m[::-1])
    np.testing.assert_array_equal(TO.kl_np(m, q), RO.kl_np(m, q))
    np.testing.assert_array_equal(TO.kl_np(m[1], m[2]), RO.kl_np(m[1], m[2]))


def _histories(cap):
    return TO.WindowHistory(cap), RO.WindowHistory(cap)


def _same_history(a, b):
    assert (len(a), a.total_windows) == (len(b), b.total_windows)
    for last in (None, 1, 2, a.capacity, a.capacity + 3):
        np.testing.assert_array_equal(a.counts(last), b.counts(last))
        np.testing.assert_array_equal(a.mixes(last), b.mixes(last))
        np.testing.assert_array_equal(a.total_mix(last), b.total_mix(last))


def test_window_history_wraps_as_the_reference():
    """Single rows, small batches that wrap the ring, a batch larger than
    the ring, and the empty and all-zero histories (uniform)."""
    c = _counts(7, n=40)
    a, b = _histories(5)
    _same_history(a, b)
    np.testing.assert_array_equal(a.total_mix(), np.full(4, 0.25))
    for i in range(7):
        a.append(c[i])
        b.append(c[i])
        _same_history(a, b)
    for lo, hi in ((7, 10), (10, 14), (14, 22), (22, 23), (23, 28)):
        a.append(c[lo:hi])
        b.append(c[lo:hi])
        _same_history(a, b)
    z, zr = _histories(3)
    z.append(np.zeros((2, 4), np.int64))
    zr.append(np.zeros((2, 4), np.int64))
    _same_history(z, zr)
    for bad in (lambda m: m.WindowHistory(0),
                lambda m: m.WindowHistory(4).append(np.ones((2, 3)))):
        for m in (TO, RO):
            with pytest.raises(ValueError):
                bad(m)


@pytest.mark.parametrize("name,kw", [("window", {}), ("window",
                                                      dict(window=3)),
                                     ("ewma", {}), ("ewma", dict(alpha=0.8))])
def test_estimators_are_bit_equal(name, kw):
    c = _counts(11, n=20)
    a, b = _histories(8)
    ea, eb = TO.make_estimator(name, **kw), RO.make_estimator(name, **kw)
    assert type(ea).__name__ == type(eb).__name__ and ea.name == eb.name
    np.testing.assert_array_equal(ea.estimate(a), eb.estimate(b))
    for i in range(len(c)):
        a.append(c[i])
        b.append(c[i])
        np.testing.assert_array_equal(ea.estimate(a), eb.estimate(b))
    assert sorted(TO.ESTIMATORS) == sorted(RO.ESTIMATORS)
    for m in (TO, RO):
        with pytest.raises(ValueError, match="unknown estimator"):
            m.make_estimator("kalman")
        with pytest.raises(ValueError):
            m.EWMAEstimator(alpha=0.0)


def test_rho_from_windows_and_history_batch():
    c = _counts(5, n=9)
    for center in (None, c[2], RO.smooth_mix(RO.normalize_counts(c[4])[0])):
        for floor in (0.0, 0.05, 10.0):
            assert TO.rho_from_windows(c, center, floor) \
                == RO.rho_from_windows(c, center, floor)
    for empty in (np.zeros((0, 4)), np.zeros((3, 4))):
        assert TO.rho_from_windows(empty, floor=0.07) \
            == RO.rho_from_windows(empty, floor=0.07) == 0.07
    rng = np.random.default_rng(3)
    E = rng.dirichlet(np.ones(4), 5)
    C = rng.integers(0, 500, (5, 7, 4)).astype(np.float64)
    C[1, 3] = 0.0
    C[2, :, 1] = 0.0
    for floor in (0.0, 0.2):
        got = TO.rho_from_history_batch(E, C, floor)
        want = RO.rho_from_history_batch(E, C, floor)
        assert got.dtype == want.dtype and got.shape == (5,)
        np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(
        TO.rho_from_history_batch(E, np.zeros((5, 0, 4)), 0.3),
        RO.rho_from_history_batch(E, np.zeros((5, 0, 4)), 0.3))
    with pytest.raises(ValueError, match="counts must be"):
        TO.rho_from_history_batch(E, C[:, :, :3])


# ---------------------------------------------------------------------------
# Triggers
# ---------------------------------------------------------------------------

def _kl_stream(seed, n=80):
    """Per-segment KL observations: a quiet stretch, a burst, a level
    shift, and noise throughout."""
    rng = np.random.default_rng(seed)
    x = rng.exponential(0.01, n)
    x[20:24] += 0.3
    x[50:] += rng.uniform(0.02, 0.08)
    return x


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("kind,kw", [
    ("PageHinkleyDetector", {}), ("PageHinkleyDetector",
                                  dict(delta=0.001, lam=0.05)),
    ("CusumDetector", {}), ("CusumDetector", dict(k=0.03, h=0.05))])
def test_detectors_fire_on_the_same_segments(seed, kind, kw):
    a, b = getattr(TO, kind)(**kw), getattr(RO, kind)(**kw)
    fired = []
    for i, x in enumerate(_kl_stream(seed)):
        fa, fb = a.update(x), b.update(x)
        assert fa == fb
        assert vars(a) == vars(b)
        if fa:
            fired.append(i)
            a.reset()
            b.reset()
    assert fired, "the stream must trip the detector at least once"


def test_drift_policy_decides_as_the_reference():
    policies = [dict(), dict(kl_threshold=0.2, cooldown=2, min_windows=3),
                dict(budget_slack=0.5, detector="page_hinkley"),
                dict(detector="cusum", cusum_k=0.02, cusum_h=0.1)]
    rng = np.random.default_rng(9)
    for kw in policies:
        pa, pb = TO.DriftPolicy(**kw), RO.DriftPolicy(**kw)
        da, db = pa.make_detector(), pb.make_detector()
        assert type(da).__name__ == type(db).__name__
        reasons = set()
        for _ in range(400):
            args = (float(rng.exponential(0.1)),
                    float(rng.choice([0.0, 0.05, 0.3])),
                    int(rng.integers(0, 5)), int(rng.integers(0, 4)),
                    bool(rng.random() < 0.2))
            ra, rb = pa.decide(*args[:4], change_point=args[4]), \
                pb.decide(*args[:4], change_point=args[4])
            assert ra == rb
            reasons.add(ra)
        assert {None, "kl_threshold"} <= reasons


# ---------------------------------------------------------------------------
# Storms
# ---------------------------------------------------------------------------

#: a storm as the drift loop makes them: the oracle's nominal requests and
#: the online arm's robust ones, under the online suite's system
STORM_W = np.array([[0.1, 0.1, 0.1, 0.7], [0.33, 0.33, 0.33, 0.01],
                    [0.475, 0.475, 0.04, 0.01], [0.2, 0.5, 0.2, 0.1],
                    [0.6, 0.2, 0.1, 0.1]])
STORM_RHO = np.array([0.0, 0.3, 0.3, 0.62, 0.0])


@pytest.fixture(scope="module")
def storms():
    sys_pairs = dict(tonline.SYSTEM)
    rsys = RC.LSMSystem(**sys_pairs)
    tsys = TC.LSMSystem(**sys_pairs)
    kw = dict(seed=0, n_starts=32, steps=200)
    with jax.threefry_partitionable(False):
        ref = {pad: rstore.retune_storm(STORM_W, STORM_RHO, rsys,
                                        pad_pow2=pad, **kw)
               for pad in (False, True)}
    starts = common.committed_starts(TC.DesignSpace.CLASSIC, 32, 0)
    got = {pad: tstore.retune_storm(STORM_W, STORM_RHO, tsys, pad_pow2=pad,
                                    device="cpu", starts=starts, **kw)
           for pad in (False, True)}
    return ref, got, tsys


def test_retune_storm_matches_the_reference(storms):
    """From the committed starts, at the drift loop's storm size (32
    starts, 200 steps), padded and unpadded: the same design and integral
    T for every request, the robust requests' exact re-scored costs to rel
    1e-4, the nominal ones' to rel 1e-3.  (Under this system the nominal
    objective is flat in the filter memory: the two float32 tuners end its
    requests 0.3% apart in h and 2.7e-4 and 3.2e-4 apart in cost, one
    each way; at 64 starts and 250 steps, 3.7e-4 and 5.4e-4.)  Padding
    leaves the surviving results bit for bit as they are."""
    ref, got, _ = storms
    for pad in (False, True):
        assert len(got[pad]) == len(STORM_W)
        for a, b, rho in zip(ref[pad], got[pad], STORM_RHO):
            assert b.design.value == a.design.value
            assert float(b.phi.T) == float(np.asarray(a.phi.T))
            assert b.cost == pytest.approx(a.cost,
                                           rel=1e-4 if rho > 0 else 1e-3)
    for a, b in zip(got[False], got[True]):
        assert torch.equal(a.phi.T, b.phi.T)
        assert torch.equal(a.phi.K, b.phi.K)
        assert torch.equal(a.phi.mfilt_bits, b.phi.mfilt_bits)
        assert a.cost == b.cost


def test_retune_fleet_and_manifests(storms):
    """``retune_fleet`` is the padded storm of its requests, with the
    reference's counters and span; ``tuned_manifest_trees`` deploys one
    tree per spec from one storm per store size, as the reference's
    does."""
    _, got, tsys = storms
    reqs = [TO.RetuneRequest(w=w, rho=r, reason=f"r{i}")
            for i, (w, r) in enumerate(zip(STORM_W, STORM_RHO))]
    starts = common.committed_starts(TC.DesignSpace.CLASSIC, 32, 0)
    with tobs.scoped(enabled=True, clock="ticks"):
        out = TO.retune_fleet(reqs, tsys, n_starts=32, steps=200, seed=0,
                              device="cpu", starts=starts)
        counters = tobs.metrics_snapshot()["counters"]
    assert TO.retune_fleet([], tsys) == []
    for a, b in zip(out, got[True]):
        assert torch.equal(a.phi.T, b.phi.T) and a.cost == b.cost
    assert counters["tuner.retune_fleet"] == 1
    assert counters["tuner.storms"] == 1
    assert counters["tuner.storm_requests"] == len(reqs)
    with pytest.raises(ValueError, match="workloads for"):
        tstore.retune_storm(STORM_W, STORM_RHO[:2], tsys)
    for args in [(100, 0.3), (7, 0.9, 0.2)]:
        np.testing.assert_array_equal(
            tstore.framework_storage_workload(*args),
            rstore.framework_storage_workload(*args))
    for name in ("ckpt/3", "tensor/12/['w']", "latest"):
        assert tstore._key_of(name) == rstore._key_of(name)
    specs = [dict(expected_entries=3000, rho=1.0),
             dict(expected_entries=3000, ckpt_interval=10, rho=0.5),
             dict(expected_entries=5000, restore_prob=0.8)]
    kw = dict(seed=0)
    trees = tstore.tuned_manifest_trees(specs, device="cpu", **kw)
    ref = rstore.tuned_manifest_trees(specs, **kw)
    assert [t.cfg.expected_entries for t in trees] \
        == [t.cfg.expected_entries for t in ref]
    one = tstore.tuned_manifest_tree(expected_entries=3000, device="cpu")
    assert one.cfg.expected_entries == 3000 and one.cfg.entry_bytes == 256


# ---------------------------------------------------------------------------
# The loop, with the reference's tunings carried across
# ---------------------------------------------------------------------------

#: a small flip experiment: the online suite's spec at 20,000 keys, 4
#: segments of 500 queries, with a tighter trigger so the online arm
#: re-tunes within the run
SMALL = dict(n_keys=20_000, segments=4, seg_queries=500)


def _small_spec(m):
    spec = tonline.make_spec("flip", 4, tonline.SCENARIOS[1][2], **SMALL)
    text = spec.to_json()
    return m.ExperimentSpec.from_json(text.replace(
        '"kl_threshold": 0.2', '"kl_threshold": 0.05').replace(
        '"cooldown": 2', '"cooldown": 1'))


@contextlib.contextmanager
def _counting(obs_module):
    with obs_module.scoped(enabled=True, clock="ticks"):
        snap = {}
        yield snap
        snap.update(obs_module.metrics_snapshot()["counters"])


@pytest.fixture(scope="module")
def small_drift():
    """The reference's run of the small flip spec (its storms recorded),
    and the port's ``execute_drift`` from its plan and storms."""
    spec = _small_spec(R)
    with jax.threefry_partitionable(False), \
            carry.recorded_storms(rsession) as storms, \
            _counting(robs) as rcount:
        ref = R.run_experiment(spec)
    rplan = rcompile.compile_spec(spec).build_drift(ref)
    plan = carry.port_drift_plan(rplan, spec)
    with carry.replayed_storms(tsession, storms) as done, \
            _counting(tobs) as tcount:
        results, regret = TO.execute_drift(plan, device="cpu")
    return dict(ref=ref, storms=storms, results=results, regret=regret,
                replayed=done, rcount=rcount, tcount=tcount, spec=spec)


def test_execute_drift_with_the_reference_tunings_is_bit_identical(
        small_drift):
    d = small_drift
    ref, got = d["ref"].drift, d["results"]
    assert list(got) == list(ref)
    assert carry.drift_records(got) == carry.drift_records(ref)
    assert d["regret"] == {}
    for key in ref:
        assert got[key].retunes == ref[key].retunes
        assert got[key].avg_io_per_query == ref[key].avg_io_per_query
    # the oracle's storm up front, then at least one online re-tune storm
    assert len(d["replayed"]) == len(d["storms"]) >= 2
    assert got[(0, "online")].retunes >= 1
    for name in ("engine.retune", "engine.retune.noop", "drift.retunes"):
        assert d["tcount"].get(name) == d["rcount"].get(name), name
    assert d["tcount"]["engine.retune"] >= 1
    triggers = {k: v for k, v in d["rcount"].items()
                if k.startswith("drift.trigger.")}
    assert {k: d["tcount"].get(k) for k in triggers} == triggers


def test_drift_report_rows_are_the_reference_s(small_drift):
    """``Report.drift`` and its ``{name}_drift_w{widx}_{arm}`` rows: the
    port's report over the carried-across results prints the reference's
    rows."""
    ref = small_drift["ref"]
    port = treport.Report(spec=carry.port_spec(ref.spec),
                          sys=carry.port_sys(ref.sys), cells=[], tunings={},
                          arm_costs={}, chosen={}, model_costs={},
                          drift=small_drift["results"])
    names = [f"online_flip_drift_w0_{arm}" for arm in TO.ARMS]
    want = {r.name: r.csv() for r in ref.rows() if r.name in names}
    got = {r.name: r.csv() for r in port.rows() if r.name in names}
    assert sorted(want) == sorted(names) and got == want


def test_build_drift_lowers_as_the_reference(small_drift):
    """From the same tunings, the port's ``build_drift`` gives the
    reference's arms, budgets, mixes and schedules."""
    ref = small_drift["ref"]
    spec = small_drift["spec"]
    rplan = rcompile.compile_spec(spec).build_drift(ref)
    tspec = carry.port_spec(spec)
    cx = T.compile_spec(tspec)
    report = treport.Report(
        spec=tspec, sys=cx.sys, cells=ref.cells,
        tunings={c: {p: carry.port_tuning(r) for p, r in arms.items()}
                 for c, arms in ref.tunings.items()},
        arm_costs=ref.arm_costs, chosen=ref.chosen,
        model_costs=ref.model_costs)
    plan = cx.build_drift(report)
    assert [(a.widx, a.arm, a.rho, a.policy, a.policy_params)
            for a in plan.arms] == [(a.widx, a.arm, a.rho, a.policy,
                                     a.policy_params) for a in rplan.arms]
    for a, b in zip(plan.arms, rplan.arms):
        assert (a.tuning is None) == (b.tuning is None)
    np.testing.assert_array_equal(plan.schedules, rplan.schedules)
    np.testing.assert_array_equal(plan.expected, rplan.expected)
    assert plan.design.value == rplan.design.value
    assert plan.scenario is None
    assert cx.rhos == rcompile.compile_spec(spec).rhos


def test_run_drift_on_the_inline_and_sharded_backends():
    """``run_experiment`` with a drift spec (the port's own starts, a few
    steps): every arm's records, and ``walls["drift_s"]``; the sharded
    backend (three ``"cpu"`` devices) runs the same shared driver from the
    same tunings, record for record."""
    spec = dataclasses.replace(
        _small_spec(T), design=T.DesignSpec(n_starts=4, steps=20, seed=1),
        drift=dataclasses.replace(_small_spec(T).drift, retune_starts=4,
                                  retune_steps=10, n_keys=5000))
    inline = T.run_experiment(spec, device="cpu")
    sharded = T.run_experiment(spec, T.ShardedBackend(devices=["cpu"] * 3),
                               device="cpu")
    assert sorted(inline.drift) == [(0, arm) for arm in sorted(TO.ARMS)]
    assert inline.walls["drift_s"] > 0 and "drift_s" in sharded.walls
    assert carry.drift_records(sharded.drift) \
        == carry.drift_records(inline.drift)
    assert {r.name for r in inline.rows()} >= {
        f"online_flip_drift_w0_{arm}" for arm in TO.ARMS}


def test_scenario_plan_runs_and_matches_the_reference():
    """The small spec as a ``burst_storm`` scenario under the Page-Hinkley
    detector (bursts of 3x the volume every second segment), with the
    reference's tunings carried across and every storm replayed: the
    port's drift gives the reference's segment records, bit for bit."""
    text = _small_spec(T).to_json().replace(
        '"kind": "flip"', '"kind": "burst_storm"').replace(
        '"scenario_params": []',
        '"scenario_params": [["amplitude", 3.0], ["period", 2]]').replace(
        '"detector": "kl"', '"detector": "page_hinkley"')
    spec = R.ExperimentSpec.from_json(text)
    assert spec.drift.kind == "burst_storm"
    with jax.threefry_partitionable(False), \
            carry.recorded_storms(rsession) as storms:
        ref = R.run_experiment(spec)
    plan = carry.port_drift_plan(rcompile.compile_spec(spec).build_drift(ref),
                                 spec)
    assert plan.scenario.kind == "burst_storm"
    with carry.replayed_storms(tsession, storms):
        results, regret = TO.execute_drift(plan, device="cpu")
    assert carry.drift_records(results) == carry.drift_records(ref.drift)
    assert regret == {} == ref.regret
    assert [r.queries for r in results[(0, "online")].records] \
        == [500, 1500, 500, 1500]


# ---------------------------------------------------------------------------
# The tuner's step (tab5 w7 nominal, ROADMAP.md section 3)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _x64():
    """JAX in float64 throughout.  (Under the ``jax.enable_x64(True)``
    context the reference's first Adam step still parts from a float64
    step by 1.1e-7, a float32 rounding; with the config flag set it
    agrees to 4.4e-16.)"""
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", was)


def _w7_lanes():
    pairs = dict(ttab5.make_spec().system)
    with jax.threefry_partitionable(False):
        from repro.core.designs import random_inits
        base = np.asarray(random_inits(jax.random.PRNGKey(0), 64,
                                       RC.DesignSpace.CLASSIC,
                                       RC.LSMSystem(**pairs)), np.float32)
    thetas = np.concatenate([base, base])
    pols = np.concatenate([np.zeros(64), np.ones(64)])
    return pairs, thetas, pols, np.asarray(RC.EXPECTED_WORKLOADS[7])


def test_w7_nominal_trajectories_agree_in_float64():
    """tab5's w7 nominal cell: all 128 lanes (64 starts x leveling and
    tiering) from the committed starts, 250 Adam steps through each
    package's own optimizer and cost model in float64.  The first step
    differs by one ulp (4.4e-16); the difference grows about tenfold every
    five steps, so every lane agrees to 1e-9 through step 34 and start 21
    (leveling) through step 49, and by step 250 they are 1.9e-2 apart —
    yet every lane ends on the same integral tuning in both, start 21 at
    T 6 (raw 5.037).  In float32 the same growth starts from one float32
    ulp: by step 30 the lanes have parted, and start 21 ends at raw T 4.905
    (T 5) in the port, 5.04 (T 6) in the reference."""
    from repro.core import _opt as ropt, batch as rbatch
    from repro_torch.core import _opt as topt, batch as tbatch
    pairs, thetas, pols, w = _w7_lanes()
    steps = 250
    with _x64():
        rsys = RC.LSMSystem(**pairs)
        rec = []

        def run(theta0, pol, lane):
            def obj(theta):
                jax.debug.callback(
                    lambda t, i: rec.append((int(i), np.asarray(t))),
                    theta, lane)
                return RC.expected_cost(
                    jnp.asarray(w), rbatch._phi_of(theta, pol,
                                                   RC.DesignSpace.CLASSIC,
                                                   rsys, True),
                    rsys, smooth=True)
            return ropt.minimize_adam(obj, theta0, steps=steps, lr=0.25)[0]

        best_r = np.asarray(jax.jit(jax.vmap(run))(
            jnp.asarray(thetas, jnp.float64), jnp.asarray(pols, jnp.float64),
            jnp.arange(128)))
    traj_r = np.zeros((steps + 1, 128, 2))
    seen = np.zeros(128, int)
    for lane, theta in rec:
        traj_r[seen[lane], lane] = theta
        seen[lane] += 1
    assert (seen == steps + 1).all()

    tsys = TC.LSMSystem(**pairs)
    W = torch.tensor(np.repeat(w[None], 128, 0), dtype=torch.float64)
    pol = torch.tensor(pols, dtype=torch.float64)
    traj_t = []

    def obj_t(theta):
        traj_t.append(theta.detach().numpy().copy())
        c = TC.cost_vector(tbatch._phi_of(theta, pol, TC.DesignSpace.CLASSIC,
                                          tsys, True), tsys, smooth=True)
        assert c.dtype == torch.float64
        return (W * c).sum(-1)

    best_t, _ = topt.minimize_adam(obj_t, torch.tensor(thetas,
                                                       dtype=torch.float64),
                                   steps=steps, lr=0.25)
    d = np.abs(np.stack(traj_t) - traj_r).max(axis=-1)   # (steps + 1, 128)
    assert d[0].max() == 0.0
    assert 0.0 < d[1].max() <= 1e-15
    assert d[:35].max() <= 1e-9
    assert d[:50, 21].max() <= 1e-9
    assert d[-1].max() > 1e-6          # the rounding has grown by the end

    def integral_T(best):
        raw = tbatch._phi_of(torch.tensor(best, dtype=torch.float32),
                             torch.tensor(pols, dtype=torch.float32),
                             TC.DesignSpace.CLASSIC, tsys, False)
        return raw.round_integral(tsys).T.numpy(), raw.T.numpy()

    T_r, raw_r = integral_T(best_r)
    T_t, raw_t = integral_T(best_t.numpy())
    np.testing.assert_array_equal(T_t, T_r)
    assert T_r[21] == 6.0 and abs(raw_r[21] - raw_t[21]) < 0.01


# ---------------------------------------------------------------------------
# The online suite against the JAX package's live reading
# ---------------------------------------------------------------------------

#: the stale arm's per-segment I/O, fed by w4's nominal cell: the JAX
#: package's live reading misses it against the committed file, the
#: port's against both (the same T and K, the filter bits apart under the
#: float32 tuners, so another buffer size and other flushes)
STALE_MISSES = {"online_gradual.segment_io_stale",
                "online_flip.segment_io_stale"}


def test_online_suite_matches_the_jax_package_s_live_reading():
    """At the committed size (3 scenarios x 4 arms, 250,000 keys, 10
    segments of 1,000 queries), from the committed starts, in both
    packages: the port's rows against the JAX package's within the
    runner's tolerance, and each against the committed file.  Then the
    reference's tunings carried across, every storm replayed: the port's
    drift gives every segment record bit for bit, the same re-tune storms,
    and exactly the rows the reference printed."""
    from benchmarks import bench_online_drift
    from repro_torch.bench import run
    runs = []
    real = bench_online_drift.run_experiment

    def recorded(spec, *a, **kw):
        with carry.recorded_storms(rsession) as storms:
            runs.append((spec, real(spec, *a, **kw), storms))
        return runs[-1][1]

    bench_online_drift.run_experiment = recorded
    try:
        with jax.threefry_partitionable(False):
            ref_rows = bench_online_drift.run()
    finally:
        bench_online_drift.run_experiment = real
    port_reports = tonline.scenario_reports(device="cpu",
                                            starts=common.committed_starts)
    rows = tonline.rows_of(port_reports)
    for (_, got), (_, ref, _) in zip(port_reports, runs):
        a, b = got.tuning((0, None)), ref.tuning((0, None))
        assert float(a.phi.T) == float(np.asarray(b.phi.T))
        np.testing.assert_array_equal(a.phi.K.numpy(), np.asarray(b.phi.K))
        assert float(a.phi.mfilt_bits) != float(np.asarray(b.phi.mfilt_bits))
    committed = run.load_baseline("online", carry.REPO)

    def missed(a, base):
        return {f for f, *_ in run.compare(a, 0.0, base)["missed"]}

    assert missed(ref_rows, committed) == STALE_MISSES
    assert missed(rows, carry.baseline_of(ref_rows)) == STALE_MISSES
    assert missed(rows, committed) == STALE_MISSES

    reports = []
    for (spec, ref, storms), (kind, *_) in zip(runs, tonline.SCENARIOS):
        plan = carry.port_drift_plan(
            rcompile.compile_spec(spec).build_drift(ref), spec)
        with carry.replayed_storms(tsession, storms):
            results, _ = TO.execute_drift(plan, device="cpu")
        assert carry.drift_records(results) == carry.drift_records(ref.drift)
        reports.append((kind, carry.port_report(ref, drift=results)))
    carried = tonline.rows_of(reports)
    timed = {"online_fleet"}
    assert [(r.name, r.derived) for r in carried
            if r.name not in timed] \
        == [(r.name, r.derived) for r in ref_rows if r.name not in timed]
