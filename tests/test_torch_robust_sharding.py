"""The port's robust layout selection (``repro_torch.core.robust_sharding``)
and its suite (``repro_torch.bench.robust_sharding``) against the JAX
package's, on the CPU.

* On seeded synthetic candidate sets (a trade-off between a cheap layout
  with one slow class and flatter ones), ``nominal_layout``,
  ``robust_layout`` and ``robust_layout_sweep`` pick the reference's
  candidates; ``worst_case_grid`` and the ``worst_case`` /
  ``nominal_worst_case`` the sweep leaves on the candidates agree to rel
  1e-5, and ``adversarial_mix`` too.
* ``candidates_from_dryrun`` over a directory of synthetic ``ok`` /
  ``skipped`` / failed / missing records builds the reference's
  candidates, and the suite prints the committed file's three skip rows
  where there are no records, and full rows where there are.
"""

import dataclasses
import json

import numpy as np
import pytest

from repro.core import robust_sharding as R
from repro_torch.core import robust_sharding as T

RHOS = (0.1, 0.25, 0.5, 1.0, 2.0, 3.0)


def _costs(seed, n=64):
    """(n, 4) step costs: a base cost per layout and one slow class whose
    penalty grows as the base falls, so the nominal pick is spiky and the
    robust pick moves with rho."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.5, 2.0, n)
    costs = base[:, None] * rng.uniform(0.8, 1.2, (n, 4))
    slow = rng.integers(0, 4, n)
    costs[np.arange(n), slow] *= 1.0 + 40.0 / base ** 3
    return costs


def _mix(seed):
    return np.random.default_rng(100 + seed).dirichlet(np.ones(4) * 2.0)


def _cands(pkg, costs):
    return [pkg.LayoutCandidate(f"c{i}", c) for i, c in enumerate(costs)]


@pytest.mark.parametrize("seed", range(4))
def test_layout_picks_and_grid_are_the_reference_s(seed):
    costs, mix = _costs(seed), _mix(seed)
    rc, tc = _cands(R, costs), _cands(T, costs)
    assert T.nominal_layout(tc, mix).name == R.nominal_layout(rc, mix).name
    want = R.worst_case_grid(rc, mix, RHOS)
    got = T.worst_case_grid(tc, mix, RHOS, device="cpu")
    assert got.shape == want.shape == (len(costs), len(RHOS))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5)
    rp = R.robust_layout_sweep(rc, mix, RHOS)
    tp = T.robust_layout_sweep(tc, mix, RHOS, device="cpu")
    assert [c.name for c in tp] == [c.name for c in rp]
    for a, b in zip(tc, rc):             # scored under the LAST rho
        np.testing.assert_allclose(a.worst_case, b.worst_case, rtol=1e-5)
        np.testing.assert_allclose(a.nominal_worst_case,
                                   b.nominal_worst_case, rtol=1e-5)
    for rho in (0.25, 1.0):
        assert T.robust_layout(tc, mix, rho, device="cpu").name \
            == R.robust_layout(rc, mix, rho).name


def test_synthetic_candidates_trade_nominal_for_robust():
    """The synthetic sets exercise the selection: the robust pick parts
    from the nominal one as rho grows, in both packages."""
    parted = 0
    for seed in range(4):
        costs, mix = _costs(seed), _mix(seed)
        nom = T.nominal_layout(_cands(T, costs), mix).name
        picks = [c.name for c in T.robust_layout_sweep(
            _cands(T, costs), mix, RHOS, device="cpu")]
        parted += picks[-1] != nom
        assert len(set(picks)) >= 2
    assert parted >= 3


@pytest.mark.parametrize("rho", [0.1, 0.5, 1.0, 3.0])
def test_adversarial_mix_is_the_reference_s(rho):
    costs = _costs(7, n=8)
    for i, c in enumerate(costs):
        mix = _mix(i)
        want = R.adversarial_mix(R.LayoutCandidate("x", c), mix, rho)
        got = T.adversarial_mix(T.LayoutCandidate("x", c), mix, rho,
                                device="cpu")
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        assert abs(float(got.sum()) - 1.0) < 1e-5


def test_module_constants_and_exports():
    import repro.core as RC
    import repro_torch.core as TC
    assert T.STEP_CLASSES == R.STEP_CLASSES
    assert [f.name for f in dataclasses.fields(T.LayoutCandidate)] \
        == [f.name for f in dataclasses.fields(R.LayoutCandidate)]
    # not exported from core, as the reference's is not
    assert "robust_layout" not in TC.__all__
    assert "robust_layout" not in RC.__all__


def _write(d, arch, shape, tag, status, step=None, mesh="single"):
    rec = {"status": status}
    if step is not None:
        rec["roofline"] = {"step_time_s": step}
    (d / f"{arch}__{shape}__{mesh}__{tag}.json").write_text(json.dumps(rec))


SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _dryrun(tmp_path):
    """Records: arch ``a`` has ``baseline`` all ok and ``opt`` with one
    skipped class; ``b`` has ``opt`` with a failed class and ``baseline``
    missing a shape; ``c`` has ``baseline`` on another mesh too."""
    rng = np.random.default_rng(3)
    for tag in ("baseline", "opt"):
        for i, shape in enumerate(SHAPES):
            status = "skipped" if (tag, i) == ("opt", 3) else "ok"
            _write(tmp_path, "a", shape, tag, status,
                   None if status == "skipped" else float(rng.uniform(1, 9)))
    for i, shape in enumerate(SHAPES):
        _write(tmp_path, "b", shape, "opt",
               "error" if i == 1 else "ok", float(rng.uniform(1, 9)))
        if i < 3:
            _write(tmp_path, "b", shape, "baseline", "ok",
                   float(rng.uniform(1, 9)))
        for mesh in ("single", "multi"):
            _write(tmp_path, "c", shape, "baseline", "ok",
                   float(rng.uniform(1, 9)), mesh=mesh)
    return str(tmp_path)


def test_candidates_from_dryrun_are_the_reference_s(tmp_path):
    d = _dryrun(tmp_path)
    cases = [("a", ("baseline", "opt"), "single"),
             ("a", ("opt",), "single"), ("b", ("baseline", "opt"), "single"),
             ("c", ("baseline",), "multi"), ("c", ("baseline", "opt"),
                                             "single"),
             ("nope", ("baseline",), "single")]
    for arch, tags, mesh in cases:
        want = R.candidates_from_dryrun(arch, d, tags=tags, mesh=mesh)
        got = T.candidates_from_dryrun(arch, d, tags=tags, mesh=mesh)
        assert [c.name for c in got] == [c.name for c in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.step_costs, b.step_costs)
    a = T.candidates_from_dryrun("a", d, tags=("baseline", "opt"))
    assert len(a) == 2 and a[1].step_costs[3] == 1e3
    assert T.candidates_from_dryrun("b", d, tags=("baseline", "opt")) == []


def test_suite_prints_the_committed_skip_rows_and_full_rows(tmp_path,
                                                           monkeypatch):
    """Without records: the committed file's three skip rows.  With two
    tagged candidates for one arch: the reference's full row."""
    from benchmarks import bench_robust_sharding as ref
    from repro_torch.bench import robust_sharding as suite, run
    rows = suite.run(device="cpu")
    cmp = run.compare(rows, 0.0, run.load_baseline("robust_sharding",
                                                   run.REPO_ROOT))
    assert cmp["missed"] == [] and len(cmp["held"]) == 3
    assert suite.ARCHS == ref.ARCHS
    rng = np.random.default_rng(9)
    for tag in ("baseline", "opt"):
        for shape in SHAPES:
            _write(tmp_path, "rwkv6-3b", shape, tag, "ok",
                   float(rng.uniform(1, 30)))
    monkeypatch.setattr(ref, "DRYRUN", str(tmp_path))
    monkeypatch.setattr(suite, "DRYRUN", str(tmp_path))
    want = ref.run()
    got = suite.run(device="cpu")
    assert [r.name for r in got] == [r.name for r in want]
    assert [r.derived for r in got] == [r.derived for r in want]
    assert "nominal" in got[-1].derived and "skipped" in got[0].derived
