"""The port's ``kernels`` and ``roofline`` suites and the runner's
``--list``, ``--list --gated``, ``--check``, ``--tolerance`` and
``--records``, on the CPU (where each kernel wrapper runs its plain
version) against the committed files and the JAX runner's gate."""

import json
import shutil

import pytest
import torch

from repro_torch.api import Row
from repro_torch.bench import kernels, robust_sharding, roofline, run
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.faults import stamp_checksum

REPO = run.REPO_ROOT


@pytest.fixture(autouse=True)
def small_timings(monkeypatch):
    # the copy ceiling's tensor: 1 GiB on the card, 16 MiB here; one timed
    # call a version (the counts do not depend on the timing); one thread,
    # as the small ops of the plain versions stall on a shared CPU with many
    monkeypatch.setattr(roofline, "COPY_BYTES", 1 << 24)
    monkeypatch.setattr(kernels, "REPEATS", 1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _committed_kernel_cells(device=None):
    """The roofline's measured row with the committed file's cells, for
    the gate's exit-code cases (its measurement is held above)."""
    base = run.load_baseline("roofline", REPO)
    derived = dict(base["rows"][0]["derived"])
    return Row("roofline_kernels", 0.0, **derived)


def test_kernels_suite_counts_are_the_committed_file_s():
    """Every held field of ``BENCH_kernels.json`` (the level's 12,288
    entries in 3 runs, 1,427 probes, 114 reads, 9 false positives, the
    lanes, chain and merge sizes, each effective byte count) matches; the
    JAX package's times are listed, not compared."""
    res = run.run_suite("kernels", device="cpu", baseline_dir=REPO)
    cmp = res["comparison"]
    assert cmp["missed"] == []
    assert len(cmp["held"]) == 16
    times = {f for f, _, _ in cmp["time"]}
    assert {"kernels_point_read.us_pallas_interpret",
            "kernels_point_read.us_kernel",
            "kernels_merge.us_plain"} <= times
    rows = {r.name: r.derived for r in res["rows"]}
    assert rows["kernels_point_read"]["probes"] == 1427
    assert rows["kernels_dual_solve"]["g_evals_fused"] == 12


@pytest.mark.parametrize("suite,row,drop,add,missed", [
    # the kernels suite's renamed times: listed on the side that lacks them
    ("kernels", 0, "us_pallas_interpret", "us_kernel", False),
    # a time field one side lacks outside RENAMED_TIMES is missed
    ("kernels", 0, "speedup_fused_vs_ref", None, True),
    ("kernels", 0, None, "us_other", True),
    ("faults", 1, "overhead_ratio", None, True),
    ("fig4", 0, None, "us_kernel", True),
])
def test_only_renamed_times_may_be_absent(suite, row, drop, add, missed):
    """``compare`` lists a committed time field the port does not write,
    or one the port writes in its place, only where ``RENAMED_TIMES``
    names it for that suite; any other field one side lacks is missed."""
    base = run.load_baseline(suite, REPO)
    brow = base["rows"][row]
    derived = dict(brow["derived"])
    if drop is not None:
        assert drop in derived
        del derived[drop]
    if add is not None:
        derived[add] = 1.0
    rows = [Row(r["name"], 0.0, **(derived if i == row else r["derived"]))
            for i, r in enumerate(base["rows"])]
    cmp = run.compare(rows, 0.0, base)
    fields = {f"{brow['name']}.{k}" for k in (drop, add) if k is not None}
    got = {f for f, *_ in cmp["missed"]}
    assert (fields <= got) if missed else not (fields & got)
    if not missed:
        assert fields <= {f for f, *_ in cmp["time"]}


def test_roofline_suite_keeps_the_committed_rows():
    """Three measured cells against the copy ceiling, and, with no records
    directory, the committed skip rows word for word."""
    res = run.run_suite("roofline", device="cpu", baseline_dir=REPO)
    assert res["comparison"]["missed"] == []
    rows = {r.name: r.derived for r in res["rows"]}
    assert rows["roofline_kernels"]["measured_cells"] == 3
    assert rows["roofline_kernels"]["copy_peak_gbps"] > 0
    committed = {r["name"]: r["derived"] for r in
                 run.load_baseline("roofline", REPO)["rows"]}
    for mesh in ("single", "multipod"):
        assert rows[f"roofline_{mesh}"] == committed[f"roofline_{mesh}"]


def _record(d, arch, shape, mesh, tag, status, step=1.0, frac=0.5):
    rec = {"arch": arch, "shape": shape, "mesh": mesh, "tag": tag,
           "status": status}
    if status == "ok":
        rec["roofline"] = {"step_time_s": step, "bottleneck": "compute",
                           "roofline_frac": frac, "memory_per_dev_gb": 10.0}
    elif status == "skipped":
        rec["reason"] = "pure full-attention arch"
    else:
        rec["error"] = "RuntimeError: aten.bincount.default"
    (d / f"{arch}__{shape}__{mesh}__{tag}.json").write_text(json.dumps(rec))


def test_records_turn_the_skip_rows_into_numbers(tmp_path):
    """Given a records directory, the mesh rows count the records by
    status and bottleneck, and ``robust_sharding``'s rwkv6-3b row picks
    from two tags; without one both keep the committed skip rows."""
    for i, shape in enumerate(sorted(SHAPES)):
        for tag, step in (("baseline", 1.0 + i), ("opt", 2.0 - 0.3 * i)):
            _record(tmp_path, "rwkv6-3b", shape, "single", tag, "ok", step)
    _record(tmp_path, "qwen3-14b", "long_500k", "single", "baseline",
            "skipped")
    _record(tmp_path, "mixtral-8x7b", "train_4k", "single", "baseline",
            "error")
    row = roofline.mesh_row(tmp_path, "single")
    assert row.derived["cells"] == f"6/{len(ARCHS) * len(SHAPES)}"
    assert (row.derived["ok"], row.derived["skipped"],
            row.derived["errors"]) == (4, 1, 1)
    assert row.derived["all_compile"] is False
    assert row.derived["bottlenecks"] == {"compute": 4}
    assert roofline.mesh_row(tmp_path, "multipod").derived["cells"] == \
        "skipped"
    rows = {r.name: r.derived for r in
            robust_sharding.run(device="cpu", records=tmp_path)}
    got = rows["robust_sharding_rwkv6-3b"]
    assert got["candidates"] == 2 and got["nominal"] in ("baseline", "opt")
    assert "skipped" in rows["robust_sharding_mixtral-8x7b"]
    assert all("skipped" in d for d in
               (r.derived for r in robust_sharding.run(device="cpu")))


def test_list_and_gated_follow_the_jax_runner(capsys):
    from benchmarks.run import CHECK_METRICS
    assert run.CHECK_METRICS == CHECK_METRICS
    assert run.main(["--list"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == list(run.SUITES)
    assert any(ln.startswith("kernels") and "hand-written kernel" in ln
               for ln in lines)
    assert run.main(["--list", "--gated"]) == 0
    gated = capsys.readouterr().out.splitlines()
    assert gated == [s for s in run.SUITES if s in CHECK_METRICS]
    assert set(gated) == set(CHECK_METRICS)


def _write_port_baseline(d, **edit):
    path = d / "BENCH_torch_roofline.json"
    base = json.loads(path.read_text())
    base.pop("checksum")
    base.update(edit)
    path.write_text(json.dumps(stamp_checksum(base)))


def test_check_exit_codes(tmp_path, monkeypatch, capsys):
    """``--check`` exits 0 within tolerance of both baselines, 1 on a
    regression (the wall time against the port's own baseline) or a
    crashed suite, and 2 when the port's baseline is missing or a
    committed file lacks a gated metric."""
    monkeypatch.setattr(roofline, "kernel_cells_row", _committed_kernel_cells)
    shutil.copy(REPO / "BENCH_roofline.json", tmp_path)
    args = ["roofline", "--device", "cpu", "--baseline", str(tmp_path)]
    assert run.main(["--check"] + args) == 2          # no port baseline
    assert "BENCH_torch_roofline.json" in capsys.readouterr().out
    assert run.main(args + ["--json", str(tmp_path)]) == 0
    _write_port_baseline(tmp_path, wall_time_s=1e6)
    assert run.main(["--check"] + args) == 0
    assert "--check passed" in capsys.readouterr().out
    _write_port_baseline(tmp_path, wall_time_s=1e-9)
    assert run.main(["--check", "--tolerance", "1.5"] + args) == 1
    assert "REGRESSION" in capsys.readouterr().out
    _write_port_baseline(tmp_path, wall_time_s=1e6)

    def crash(**kw):
        raise RuntimeError("boom")
    with monkeypatch.context() as m:
        m.setattr(roofline, "run", crash)
        assert run.main(["--check"] + args) == 1
    committed = json.loads((tmp_path / "BENCH_roofline.json").read_text())
    committed.pop("checksum")
    del committed["rows"][0]["derived"]["measured_cells"]
    (tmp_path / "BENCH_roofline.json").write_text(
        json.dumps(stamp_checksum(committed)))
    assert run.main(["--check"] + args) == 2
    out = capsys.readouterr().out
    assert "measured_cells: missing from BENCH_roofline.json" in out
