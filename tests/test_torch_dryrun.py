"""The port's dry run against the JAX package's.

A reduced ``qwen3-14b`` (every dimension divisible by 2) on a ``2x2``
mesh at train, prefill and decode: the port's per-device FLOPs from an
eager trace of fake DTensors must be within 3% of the FLOPs the JAX
package's HLO analysis counts, run in a subprocess with ``Auto`` mesh
axes (``tests/torch_mesh_oracle.py``).  Bytes and collective bytes are
printed beside the JAX package's and not held: the port's bytes are
unfused.  Every test that starts a fake process group leaves none
behind.
"""

import json
import os
import subprocess
import sys

import pytest
import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.core.robust_sharding import candidates_from_dryrun
from repro_torch.launch import dryrun

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from torch_mesh_oracle import REDUCED  # noqa: E402

CELLS = ("train_4k", "prefill_32k", "decode_32k")


@pytest.fixture(scope="module")
def ref_cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("oracle") / "dryrun.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    subprocess.run([sys.executable, os.path.join(HERE, "torch_mesh_oracle.py"),
                    "dryrun", str(out)], check=True, env=env, timeout=900)
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def port_cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("records")
    recs = {s: dryrun.run_cell("qwen3-14b", s, "2x2", overrides=REDUCED,
                               verbose=False, out_dir=out) for s in CELLS}
    recs["long_500k"] = dryrun.run_cell("qwen3-14b", "long_500k", "2x2",
                                        overrides=REDUCED, verbose=False,
                                        out_dir=out)
    return out, recs


@pytest.fixture(autouse=True)
def no_process_group_left():
    yield
    assert not dist.is_initialized()


@pytest.mark.parametrize("shape", CELLS)
def test_per_device_flops_match_the_reference(shape, ref_cells, port_cells):
    ref = ref_cells[shape]
    assert ref["status"] == "ok", ref.get("error")
    rec = port_cells[1][shape]
    assert rec["status"] == "ok", rec.get("error")
    got, want = rec["trace"]["flops_per_dev"], ref["hlo"]["flops_per_dev"]
    print(f"{shape}: flops/dev {got:.6g} (reference {want:.6g}); "
          f"bytes/dev {rec['trace']['bytes_per_dev']:.6g} (reference "
          f"{ref['hlo']['bytes_per_dev']:.6g}, fused); collective bytes "
          f"{rec['trace']['collective_bytes_by_axis']} (reference "
          f"{ref['hlo']['collective_bytes_by_axis']}); collectives "
          f"{rec['trace']['collective_count']} (reference "
          f"{ref['hlo']['collective_count']})")
    assert abs(got - want) <= 0.03 * want
    assert rec["trace"]["while_trips"] == []
    assert rec["chips"] == 4
    assert rec["memory_analysis"]["total_live_gb"] >= \
        rec["memory_analysis"]["argument_gb"] > 0
    terms = rec["roofline"]
    assert terms["step_time_s"] == max(terms["compute_s"], terms["memory_s"],
                                       terms["collective_s"]) > 0
    assert set(terms["collective_by_axis"]) <= {"data", "model"}


def test_reference_dry_run_fails_on_explicit_axes(ref_cells):
    """The JAX package's fault on JAX 0.9.0: ``jax.make_mesh`` builds
    Explicit axes, which ``with_sharding_constraint`` refuses inside the
    step, so the unwrapped cell records ``error``; with Auto axes the same
    cell is ``ok``."""
    bad = ref_cells["unwrapped_train_4k"]
    assert bad["status"] == "error"
    assert "Auto axes" in bad["error"]
    assert ref_cells["train_4k"]["status"] == "ok"


def test_records_are_read_by_the_layout_selection(port_cells):
    """The records keep the schema ``candidates_from_dryrun`` reads: an
    ok cell's ``roofline.step_time_s``, a skipped cell's penalty."""
    out, recs = port_cells
    assert recs["long_500k"]["status"] == "skipped"
    assert "full-attention" in recs["long_500k"]["reason"]
    names = sorted(p.name for p in out.iterdir())
    assert names == sorted(f"qwen3-14b__{s}__2x2__baseline.json"
                           for s in SHAPES)
    (cand,) = candidates_from_dryrun("qwen3-14b", str(out), mesh="2x2")
    assert list(cand.step_costs) == [
        recs["train_4k"]["roofline"]["step_time_s"],
        recs["prefill_32k"]["roofline"]["step_time_s"],
        recs["decode_32k"]["roofline"]["step_time_s"], 1e3]


def test_a_cell_that_raises_is_recorded_as_an_error(tmp_path):
    """A DTensor operator with no sharding strategy (the MoE router's
    ``bincount``) is recorded as ``error`` with the operator named, never
    skipped."""
    cfg = ARCHS["mixtral-8x7b"].reduced()
    over = {k: str(getattr(cfg, k)) for k in
            ("num_layers", "d_model", "num_heads", "num_kv_heads",
             "head_dim", "d_ff", "vocab_size")}
    rec = dryrun.run_cell("mixtral-8x7b", "decode_32k", "2x2",
                          overrides=over, verbose=False, out_dir=tmp_path)
    assert rec["status"] == "error"
    assert "aten." in rec["error"]
    saved = json.loads((tmp_path / "mixtral-8x7b__decode_32k__2x2__baseline"
                                    ".json").read_text())
    assert saved["status"] == "error" and saved["error"] == rec["error"]


def test_cli_writes_one_record_per_cell(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    dryrun.main(["--arch", "qwen3-14b", "--shape", "decode_32k", "--mesh",
                 "2x2", "--tag", "opt"]
                + [f"--set={k}={v}" for k, v in REDUCED.items()])
    rec = json.loads((tmp_path / "qwen3-14b__decode_32k__2x2__opt.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["tag"] == "opt"
    assert rec["overrides"] == REDUCED
    assert rec["trace"]["flops_per_dev"] > 0
