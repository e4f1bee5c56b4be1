"""The port's paper-suite runner (``repro_torch.bench``) and the helpers it
shares with the JAX package, on the CPU.

* The checksum helpers (``repro_torch.faults``) give the JAX package's
  digests and validate the committed ``BENCH_{fig4,fig10,tuner}.json``; a
  payload with one field changed fails, and the runner refuses it.
* The report helpers (``repro_torch.api.report``) match ``repro.api.report``.
* Each suite runs through the runner with its size constants cut: its
  rows and derived keys are the committed file's, and the fields the
  runner does not compare are exactly the time-derived and start-dependent
  ones.
* fig4 runs at its committed size from the starts the committed file was
  made from (the JAX package's, ``bench/jax_starts.npz``) and reproduces
  it at its printed precision.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.core as R
from repro.api import report as jreport
from repro.faults import artifacts as jartifacts
import repro_torch.core as T
from repro_torch.api import report as treport
from repro_torch.bench import common, fig4, fig10, run, tuner
from repro_torch.faults import artifacts as tartifacts

REPO = Path(__file__).resolve().parents[1]
SUITES = ("fig4", "fig10", "tuner")


def _committed(suite):
    return json.loads((REPO / f"BENCH_{suite}.json").read_text())


@pytest.mark.parametrize("suite", SUITES)
def test_committed_checksums_validate(suite, tmp_path):
    base = _committed(suite)
    assert tartifacts.payload_checksum(base) == base["checksum"] \
        == jartifacts.payload_checksum(base)
    assert tartifacts.checksum_ok(base)
    assert tartifacts.canonical_json(base) == jartifacts.canonical_json(base)
    assert run.load_baseline(suite, REPO) == base
    bad = json.loads(json.dumps(base))
    key = sorted(bad["rows"][0]["derived"])[0]
    value = bad["rows"][0]["derived"][key]
    bad["rows"][0]["derived"][key] = (not value) if isinstance(value, bool) \
        else value + 1 if isinstance(value, (int, float)) else value + "x"
    assert not tartifacts.checksum_ok(bad)
    (tmp_path / f"BENCH_{suite}.json").write_text(json.dumps(bad))
    with pytest.raises(run.BaselineError, match="checksum"):
        run.load_baseline(suite, tmp_path)
    tartifacts.stamp_checksum(bad)
    assert bad["checksum"] == jartifacts.payload_checksum(bad)
    assert tartifacts.checksum_ok(bad)
    with pytest.raises(run.BaselineError, match="unreadable"):
        run.load_baseline(suite, tmp_path / "absent")


def test_report_helpers_match_reference():
    derived = dict(a=1.5, b=True, c="x", d=np.float32(0.25), e=np.int64(3),
                   f=float("nan"), g=(1.0, float("inf")),
                   h=torch.tensor(2.5), i={"k": np.arange(3)})
    for mod in (treport, jreport):
        assert mod.Row("r", 12.345, u=1, v="w").csv() == "r,12.3,u=1;v=w"
        assert mod.fmt(0.000123456) == "0.0001235"
    assert treport.jsonable(derived) == jreport.jsonable(derived)
    us, out = treport.timed(lambda x: x + 1, 2)
    assert out == 3 and us >= 0.0
    rng = np.random.default_rng(1)
    cn, cr = rng.uniform(1, 5, 50), rng.uniform(1, 5, 50)
    np.testing.assert_array_equal(treport.delta_tp(cn, cr),
                                  jreport.delta_tp(cn, cr))
    B = R.sample_benchmark(500, seed=3)
    np.testing.assert_allclose(
        treport.costs_over_benchmark(T.make_phi(7.0, 4e10, 3.0,
                                                T.LSMSystem()),
                                     T.LSMSystem(), B),
        jreport.costs_over_benchmark(R.make_phi(7.0, 4e10, 3.0,
                                                R.LSMSystem()),
                                     R.LSMSystem(), B), rtol=1e-6)


def test_core_exports_what_the_reference_exports():
    assert T.__all__ == R.__all__
    assert all(hasattr(T, name) for name in T.__all__)


#: the sizes each suite's CPU run is cut to
SHRINK = {
    "fig4": (fig4, dict(N_STARTS=2, KLSM_STARTS=2, STEPS=3)),
    "fig10": (fig10, dict(N_STARTS=2, STEPS=3)),
    "tuner": (tuner, dict(GRID_WORKLOADS=R.EXPECTED_WORKLOADS[:1],
                          GRID_STARTS=2, GRID_STEPS=2, NOMINAL_STARTS=2,
                          NOMINAL_STEPS=3, SLSQP_STARTS=1, KLSM_SEEDS=2,
                          KLSM_STARTS=2, KLSM_SLSQP_STARTS=1)),
}
#: what the runner does not compare: (time-derived, start-dependent)
UNCOMPARED = {
    "fig4": ({"wall_time_s", "fig4_nominal_designs_w7.us_per_call",
              "fig4_nominal_designs_w11.us_per_call"}, set()),
    "fig10": ({"wall_time_s", "fig10_entry_size_w7.us_per_call",
               "fig10_entry_size_w11.us_per_call"}, set()),
    "tuner": ({"wall_time_s", "perf_tuner_classic.us_per_call",
               "perf_tuner_classic.slsqp_us",
               "perf_tuner_klsm_stability.us_per_call",
               "perf_tuner_klsm_stability.slsqp_us",
               "perf_tuner_throughput.us_per_call",
               "perf_tuner_throughput.tunings_per_sec",
               "perf_tuner_fig6_grid.us_per_call",
               "perf_tuner_fig6_grid.batched_s",
               "perf_tuner_fig6_grid.sequential_s",
               "perf_tuner_fig6_grid.seed_style_s",
               "perf_tuner_fig6_grid.speedup_vs_sequential",
               "perf_tuner_fig6_grid.speedup_vs_seed_style",
               "perf_tuner_fig6_grid.claim_speedup_ge_10x"},
              {"perf_tuner_klsm_stability.jax_spread",
               "perf_tuner_klsm_stability.slsqp_spread",
               "perf_tuner_fig6_grid.max_rel_cost_diff_vs_sequential",
               "perf_tuner_fig6_grid.max_rel_cost_diff_vs_seed_style"}),
}


@pytest.mark.parametrize("suite", SUITES)
def test_suite_runs_through_the_runner_on_cpu(suite, monkeypatch, tmp_path):
    mod, sizes = SHRINK[suite]
    for name, value in sizes.items():
        assert hasattr(mod, name)
        monkeypatch.setattr(mod, name, value)
    result = run.run_suite(suite, device="cpu", json_dir=str(tmp_path))
    base = _committed(suite)
    assert [r.name for r in result["rows"]] \
        == [r["name"] for r in base["rows"]]
    for row, brow in zip(result["rows"], base["rows"]):
        assert set(row.derived) == set(brow["derived"])
    cmp = result["comparison"]
    time_fields, spreads = UNCOMPARED[suite]
    assert {f for f, *_ in cmp["time"]} == time_fields
    assert {f for f, *_ in cmp["spread"]} == spreads
    n_fields = sum(len(r["derived"]) for r in base["rows"])
    assert len(cmp["held"]) + len(cmp["missed"]) \
        == n_fields + 1 + len(base["rows"]) - len(time_fields) - len(spreads)
    # at these sizes values may miss; no row or key may be missing
    assert all(got is not None and want is not None
               for _, got, want in cmp["missed"])
    written = json.loads((tmp_path / f"BENCH_torch_{suite}.json").read_text())
    assert tartifacts.checksum_ok(written)
    assert set(written) == set(base)
    assert [r["name"] for r in written["rows"]] \
        == [r["name"] for r in base["rows"]]
    assert written["error"] is None


def test_runner_cli_prints_every_field_and_exits_on_a_miss(monkeypatch,
                                                           tmp_path, capsys):
    """The CLI on rows equal to the committed ones exits 0 and writes its
    file; against a baseline one held field away it prints the miss by
    name with both values and exits 1."""
    base = _committed("fig4")
    rows = [run.Row(r["name"], r["us_per_call"], **r["derived"])
            for r in base["rows"]]
    monkeypatch.setattr(fig4, "run", lambda device=None, starts=None: rows)
    out_dir = tmp_path / "out"
    assert run.main(["fig4", "--device", "cpu", "--baseline", str(REPO),
                     "--json", str(out_dir)]) == 0
    text = capsys.readouterr().out
    assert "# device: cpu" in text
    assert "# held fig4_nominal_designs_w7.klsm_best: True (committed True)" \
        " ok" in text
    assert "# time fig4_nominal_designs_w11.us_per_call: 1168201.3" in text
    written = json.loads((out_dir / "BENCH_torch_fig4.json").read_text())
    assert tartifacts.checksum_ok(written)
    assert [r["derived"] for r in written["rows"]] \
        == [r["derived"] for r in base["rows"]]

    bad = json.loads(json.dumps(base))
    bad["rows"][1]["derived"]["io_norm_fluid"] = 1.05
    (tmp_path / "BENCH_fig4.json").write_text(
        json.dumps(tartifacts.stamp_checksum(bad)))
    assert run.main(["fig4", "--device", "cpu", "--baseline",
                     str(tmp_path)]) == 1
    text = capsys.readouterr().out
    assert "# MISS fig4_nominal_designs_w11.io_norm_fluid: 1.0 " \
        "(committed 1.05)" in text
    assert "1 missed" in text


def test_field_kinds_and_tolerance():
    assert run.field_kind("claim_speedup_ge_10x") == "time"
    assert run.field_kind("claim_costs_match_1pct") == "held"
    assert run.field_kind("klsm_best") == "held"
    assert run.field_kind("max_rel_cost_diff_vs_anything") == "spread"
    assert run._holds(1.476 + 0.0247, 1.476)           # 0.01 + 0.01 * 1.476
    assert not run._holds(1.476 + 0.0248, 1.476)
    assert not run._holds(1, True) and not run._holds(76, 75)
    assert run._holds("15 workloads, one jit", "15 workloads, one jit")


def test_committed_starts_file_holds_the_jax_draws():
    """``bench/jax_starts.npz`` holds what ``tests/jax_starts.py`` draws
    with the JAX package, and each draw is ``random_inits`` of a design
    with that many parameters."""
    import jax_starts
    from repro.core.designs import random_inits
    want = jax_starts.draws()
    with np.load(common.STARTS_FILE) as f:
        assert sorted(f.files) == sorted(want)
        for key in f.files:
            np.testing.assert_array_equal(f[key], want[key])
    with jax.threefry_partitionable(False):
        ref = np.asarray(random_inits(jax.random.PRNGKey(3), 128,
                                      R.DesignSpace.KLSM, R.LSMSystem()))
    np.testing.assert_array_equal(
        common.committed_starts(T.DesignSpace.KLSM, 128, 3)[0].numpy(), ref)


def test_fig4_from_the_committed_starts_reproduces_the_committed_file():
    """fig4 at its committed size, every design started from the starts
    the committed file was made from, reproduces each ``io_norm_*`` and
    ``klsm_io`` to one unit of its last printed digit (float32 Adam
    drifts between XLA and torch over 250 steps: w7's 1-leveling prints
    2.079 against 2.08) and every flag exactly."""
    rows = fig4.run(device="cpu", starts=common.committed_starts)
    base = _committed("fig4")
    for row, brow in zip(rows, base["rows"]):
        assert row.name == brow["name"]
        for key, want in brow["derived"].items():
            got = row.derived[key]
            if isinstance(want, bool):
                assert got is want, key
            else:
                assert abs(got - want) <= 0.001 + 1e-9, (row.name, key)
    cmp = run.compare(rows, 0.0, run.load_baseline("fig4", REPO))
    assert cmp["missed"] == [] and len(cmp["held"]) == 18
