"""Run the paper suites on the port and hold them against the committed
``BENCH_<suite>.json``.

    PYTHONPATH=src python -m repro_torch.bench.run fig4 fig10 tuner
    PYTHONPATH=src python -m repro_torch.bench.run fig7_8 fig9 fig19
    PYTHONPATH=src python -m repro_torch.bench.run fig6 tab5 api online
    PYTHONPATH=src python -m repro_torch.bench.run compaction memory \\
        robust_sharding scenarios
    PYTHONPATH=src python -m repro_torch.bench.run fig4 --device cpu
    PYTHONPATH=src python -m repro_torch.bench.run tuner --json out/ \\
        --baseline .
    PYTHONPATH=src python -m repro_torch.bench.run kernels roofline
    PYTHONPATH=src python -m repro_torch.bench.run roofline robust_sharding \\
        --records experiments/dryrun_torch
    PYTHONPATH=src python -m repro_torch.bench.run --list [--gated]
    PYTHONPATH=src python -m repro_torch.bench.run --check kernels roofline \\
        --baseline DIR [--tolerance 1.5]

Each suite prints its rows as ``name,us_per_call,derived`` CSV, then every
field of the committed file beside the port's value.  The committed file
is read as data from ``--baseline`` (default: the repo root) after its
checksum validates; a bad checksum is an error.  Fields fall in three
kinds (:func:`field_kind`):

* **time** — the card's own, printed and not compared (the committed
  ones are another machine's): ``us_per_call``, ``wall_time_s``,
  ``*_us``, ``*_s``, ``us``, ``us_*``, ``speedup_*``,
  ``tunings_per_sec``, ``claim_speedup_ge_10x``, the faults and obs
  suites' ``overhead_ratio`` and ``overhead_pct`` (ratios of two wall
  times), and the kernels and roofline suites' bandwidths
  (``achieved_gbps``, ``copy_peak_gbps``, ``frac_of_copy_peak``).  The
  kernels suite names its own times (``RENAMED_TIMES``: ``us_kernel``
  and ``us_plain``, where the JAX package timed its Pallas kernel in
  interpret mode, its jnp references and numpy); those are listed, not
  missed, on the side that lacks them;
* **spread** — start-dependent, printed beside the committed value and
  not held (the port's starts come from a ``torch.Generator``, not
  ``jax.random``): ``jax_spread``, ``slsqp_spread``,
  ``max_rel_cost_diff_vs_*``;
* **held** — every other field: a bool or string must equal the
  committed value (the ``claim_*`` flags, ``klsm_best``, ``batch``,
  ``paper_reports``), an integer too (``cells``), a float must lie
  within ``ABS_TOL + REL_TOL * |committed|`` of it, a dict (fig19's
  ``degradation``) must have the committed keys and a list (the api
  suite's ``measured_io``, online's ``segment_io_*``) the committed
  length, each value or element held so (a time field inside a dict, as
  in the roofline suite's ``cells``, is not compared).

A held field that misses, or a committed row or key the port lacks, is
printed by name with both values, and the runner exits 1.  ``--json DIR``
writes ``BENCH_torch_<suite>.json`` in the committed schema, stamped with
its checksum, atomically.  The suites run on the card unless ``--device cpu``.

``--records DIR`` hands the ``roofline`` and ``robust_sharding`` suites a
directory of dry-run records (``launch/dryrun.py``); without it they print
the committed skip rows.

``--list`` prints the suite names, each with the first line of its
module's docstring, and exits; ``--list --gated`` prints only the suites
the gate watches (``CHECK_METRICS``' keys), bare, one a line.  ``--check``
runs the named suites and holds them to two baselines in ``--baseline
DIR``: the committed ``BENCH_<suite>.json`` for the held fields and the
claim flags and counts of ``CHECK_METRICS``, and a
``BENCH_torch_<suite>.json`` that the port wrote (``--json``) for the
suite's wall time and the time fields of ``CHECK_METRICS`` (the committed
times are the JAX package's, on a CPU).  Each metric must stay within
``--tolerance`` (default 1.5; the wall time twice that) of its baseline in
its direction.  Exit codes: 1 for a regression, a missed held field or a
crashed suite; 2 for a misconfigured gate (a baseline missing, failing
its checksum, or lacking a ``CHECK_METRICS`` key).

``--trace DIR`` turns telemetry on (``repro_torch.obs``) and sets
``REPRO_OBS_OUT``; after each suite it writes ``trace_<suite>.json``
(Chrome/Perfetto) and ``metrics_<suite>.json`` into DIR (the obs suite
also writes its calibration artifact there).  ``--spec FILE.json`` runs
one declarative experiment (``repro_torch.api.ExperimentSpec`` JSON, the
JAX package's text) and prints its report's rows; ``--run-dir DIR`` and
``--resume`` set the subprocess backend's persistence (the CLI wins over
the spec's ``backend_params``), so one spec file serves a fresh run and a
resume.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..api.report import Row, jsonable
from ..faults import atomic_write_json, checksum_ok, stamp_checksum
from .common import committed_starts, own_starts

#: suite key -> module of this package; all but fig4, fig10, tuner and
#: robust_sharding run through the experiment API
#: (``repro_torch.api.run_experiment``), online and scenarios through its
#: drift axis and memory through its memory axis
SUITES = ("fig4", "fig10", "tuner", "kernels", "roofline", "fig7_8", "fig9",
          "fig19", "fig6", "tab5", "api", "online", "compaction",
          "robust_sharding", "memory", "scenarios", "faults", "obs")
#: suites that read a directory of dry-run records (``--records``)
RECORD_SUITES = ("roofline", "robust_sharding")
#: suite -> {"row_name.metric": "lower"|"higher"}: the gate's directional
#: metrics beside every suite's wall_time_s ("lower"), the JAX package's
CHECK_METRICS = {
    "tuner": {
        "perf_tuner_fig6_grid.batched_s": "lower",
        "perf_tuner_throughput.tunings_per_sec": "higher",
    },
    "tab5": {
        "tab5_fleet.engine_s": "lower",
    },
    "compaction": {
        "compaction_fleet.engine_s": "lower",
    },
    "api": {
        "api_fleet.engine_s": "lower",
    },
    "online": {
        "online_fleet.engine_s": "lower",
        "online_summary.online_recovery_min": "higher",
        # bool (int subclass): flipping to False reads as 0 < 1/tol
        "online_summary.claim_online_ge_robust_ge_stale": "higher",
    },
    "faults": {
        # bool: recovered-under-chaos results bit-identical to inline
        "faults_recovery.identical_to_inline": "higher",
        # supervised no-fault path vs raw path: must stay near 1.0
        "faults_overhead.overhead_ratio": "lower",
    },
    "kernels": {
        # fused data plane must stay faster than its jnp references
        "kernels_point_read.speedup_fused_vs_ref": "higher",
        "kernels_dual_solve.speedup_fused_vs_ref": "higher",
    },
    "roofline": {
        # the roofline table must keep measuring real kernel cells —
        # an all-empty run raises, and a shrinking cell count gates
        "roofline_kernels.measured_cells": "higher",
    },
    "memory": {
        "memory_fleet.engine_s": "lower",
        # arbitrated fleet throughput over the static equal split
        "memory_summary.fleet_speedup_min": "higher",
        # bools: arbitration never loses; disabled stays bit-identical
        "memory_summary.claim_arbitrated_ge_static": "higher",
        "memory_summary.claim_disabled_identical": "higher",
    },
    "scenarios": {
        "scenarios_fleet.engine_s": "lower",
        # bools: the robust hedge survives every named stress pattern,
        # and every adversary window's realized model cost stays under
        # the independently-solved KL dual bound (Eq. 13, measured live)
        "scenarios_summary.claim_robust_ge_stale": "higher",
        "scenarios_summary.claim_regret_le_dual_bound": "higher",
    },
    "obs": {
        "obs_fleet.engine_s": "lower",
        # enabled-vs-disabled telemetry tax on the same fleet (<= 1.05
        # gated in the suite itself; the baseline watches for creep)
        "obs_overhead.overhead_ratio": "lower",
        # bools: tracing never perturbs engine results; the measured-IO
        # calibration fit is at least as close as the hand constants
        "obs_identity.claim_bit_identical": "higher",
        "obs_calibration.claim_fit_ge_hand": "higher",
    },
}
EXIT_REGRESSION = 1
EXIT_MISCONFIGURED = 2
#: a held float lies within ABS_TOL + REL_TOL * |committed| of the
#: committed value: tuned costs move with the starts
ABS_TOL, REL_TOL = 0.01, 0.01
TIME_FIELDS = {"us_per_call", "wall_time_s", "tunings_per_sec",
               "claim_speedup_ge_10x", "overhead_ratio", "overhead_pct",
               "us", "achieved_gbps", "copy_peak_gbps", "frac_of_copy_peak"}
SPREAD_FIELDS = {"jax_spread", "slsqp_spread"}
#: suite -> (the committed time fields the port does not write, the ones
#: it writes in their place)
RENAMED_TIMES = {
    "kernels": ({"us_pallas_interpret", "us_numpy", "us_jnp", "us_jnp_ref",
                 "us_fused", "us_ref"}, {"us_kernel", "us_plain"}),
}
REPO_ROOT = Path(__file__).resolve().parents[3]


class BaselineError(RuntimeError):
    """A committed ``BENCH_<suite>.json`` that is missing or fails its
    checksum."""


def field_kind(name: str) -> str:
    """``"time"``, ``"spread"`` or ``"held"`` (see the module docstring)."""
    if name in TIME_FIELDS or name.endswith(("_us", "_s")) \
            or name.startswith(("speedup_", "us_")):
        return "time"
    if name in SPREAD_FIELDS or name.startswith("max_rel_cost_diff_vs_"):
        return "spread"
    return "held"


def load_baseline(suite: str, baseline_dir) -> dict:
    """The committed ``BENCH_<suite>.json`` in ``baseline_dir``."""
    return load_baseline_file(Path(baseline_dir) / f"BENCH_{suite}.json")


def load_baseline_file(path) -> dict:
    """A ``BENCH_*.json`` whose checksum validates."""
    try:
        with open(path) as f:
            base = json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        raise BaselineError(f"{path}: unreadable ({e})") from e
    if not isinstance(base, dict) or not checksum_ok(base):
        raise BaselineError(f"{path}: checksum mismatch (corrupt, truncated "
                            "or hand-edited baseline)")
    return base


def _holds(got, want) -> bool:
    if isinstance(want, dict) or isinstance(got, dict):
        return isinstance(got, dict) and isinstance(want, dict) \
            and set(got) == set(want) \
            and all(field_kind(str(k)) == "time" or _holds(got[k], want[k])
                    for k in want)
    if isinstance(want, list) or isinstance(got, list):
        return isinstance(got, list) and isinstance(want, list) \
            and len(got) == len(want) \
            and all(_holds(g, w) for g, w in zip(got, want))
    if want is None or got is None \
            or isinstance(want, (bool, str)) or isinstance(got, (bool, str)):
        return type(got) is type(want) and got == want
    if isinstance(want, int) and isinstance(got, int):
        return got == want
    return abs(got - want) <= ABS_TOL + REL_TOL * abs(want)


def compare(rows: List[Row], wall_s: float, base: dict) -> dict:
    """Every field of the committed payload beside the port's: lists of
    (field, port, committed) for ``held`` (matched), ``missed``, ``time``
    and ``spread`` (the latter two not compared)."""
    out = {"held": [], "missed": [], "time": [("wall_time_s", wall_s, None)],
           "spread": []}
    committed_only, port_only = RENAMED_TIMES.get(base.get("suite"),
                                                  (set(), set()))
    got_rows = {r.name: r for r in rows}
    for brow in base["rows"]:
        name = brow["name"]
        row = got_rows.get(name)
        if row is None:
            out["missed"].append((name, None, "row"))
            continue
        out["time"].append((f"{name}.us_per_call", row.us, None))
        derived = jsonable(row.derived)
        for key in sorted(set(brow["derived"]) | set(derived)):
            field = f"{name}.{key}"
            want, got = brow["derived"].get(key), derived.get(key)
            kind = field_kind(key)
            if key not in derived and key in committed_only \
                    or key not in brow["derived"] and key in port_only:
                out["time"].append((field, got, None))
            elif key not in derived or key not in brow["derived"]:
                out["missed"].append((field, got, want))
            elif kind == "time":
                out["time"].append((field, got, None))
            elif kind == "spread":
                out["spread"].append((field, got, want))
            else:
                out["held" if _holds(got, want) else "missed"].append(
                    (field, got, want))
    for name in sorted(set(got_rows) - {r["name"] for r in base["rows"]}):
        out["missed"].append((name, "row", None))
    return out


def payload(suite: str, rows: List[Row], wall_s: float) -> dict:
    """The ``BENCH_<suite>.json`` schema, checksum stamped."""
    return stamp_checksum({
        "suite": suite, "wall_time_s": round(wall_s, 3), "error": None,
        "rows": [{"name": r.name, "us_per_call": jsonable(round(r.us, 1)),
                  "derived": jsonable(r.derived)} for r in rows]})


def write_trace_files(trace_dir: str, name: str) -> int:
    """``trace_<name>.json`` and ``metrics_<name>.json`` of the live
    telemetry into ``trace_dir``; returns the events exported."""
    from .. import obs
    from ..obs.trace import write_trace
    n = write_trace(os.path.join(trace_dir, f"trace_{name}.json"))
    atomic_write_json(os.path.join(trace_dir, f"metrics_{name}.json"),
                      jsonable(obs.metrics_snapshot()))
    return n


def run_suite(suite: str, device=None, baseline_dir=REPO_ROOT,
              json_dir: Optional[str] = None, starts=own_starts,
              trace_dir: Optional[str] = None, records=None) -> dict:
    """Run one suite and hold it against its committed file (validated
    before the suite starts).  ``starts`` says where its tunings' starts
    come from (``common.py``); ``records`` is the dry-run records
    directory of the ``RECORD_SUITES``.  With ``trace_dir`` (telemetry
    on), the ring is cleared first and the suite's trace and metrics
    written after.  Returns the rows, the wall time and the comparison
    (:func:`compare`)."""
    if suite not in SUITES:
        raise ValueError(f"unknown suite {suite!r}; known: {SUITES}")
    base = load_baseline(suite, baseline_dir)
    mod = importlib.import_module(f".{suite}", __package__)
    if trace_dir is not None:
        from .. import obs
        obs.clear()             # per-suite trace files, not one giant ring
    kw = {"records": records} if suite in RECORD_SUITES else {}
    t0 = time.time()
    rows = mod.run(device=device, starts=starts, **kw)
    wall = time.time() - t0
    result = {"suite": suite, "rows": rows, "wall_s": wall,
              "comparison": compare(rows, wall, base)}
    if trace_dir is not None:
        result["trace_events"] = write_trace_files(trace_dir, suite)
    if json_dir is not None:
        os.makedirs(json_dir, exist_ok=True)
        path = os.path.join(json_dir, f"BENCH_torch_{suite}.json")
        atomic_write_json(path, payload(suite, rows, wall))
        result["json"] = path
    return result


def report(result: dict) -> List[str]:
    """The lines :func:`main` prints for one suite's result."""
    lines = [r.csv() for r in result["rows"]]
    cmp = result["comparison"]
    for field, got, want in cmp["held"]:
        lines.append(f"# held {field}: {got} (committed {want}) ok")
    for field, got, want in cmp["missed"]:
        lines.append(f"# MISS {field}: {got} (committed {want})")
    for field, got, want in cmp["spread"]:
        lines.append(f"# spread {field}: {got} (committed {want}, "
                     "not held)")
    for field, got, _ in cmp["time"]:
        lines.append(f"# time {field}: {got}")
    if "trace_events" in result:
        lines.append(f"# trace {result['suite']}: "
                     f"{result['trace_events']} events")
    lines.append(f"# {result['suite']} done in {result['wall_s']:.1f}s: "
                 f"{len(cmp['held'])} held fields matched, "
                 f"{len(cmp['missed'])} missed")
    return lines


def _device_name(device) -> str:
    import torch

    from ..kernels._compat import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return str(dev)


def suite_description(suite: str) -> str:
    """The first line of a suite module's docstring (read with ``ast``,
    without importing the suite)."""
    import ast
    path = Path(__file__).with_name(f"{suite}.py")
    doc = ast.get_docstring(ast.parse(path.read_text(encoding="utf-8")))
    return doc.strip().splitlines()[0] if doc else ""


def load_port_baseline(suite: str, baseline_dir) -> dict:
    """The port's own ``BENCH_torch_<suite>.json`` (``--json``), checksum
    validated: the gate's baseline for wall times and time fields."""
    path = Path(baseline_dir) / f"BENCH_torch_{suite}.json"
    if not path.exists():
        raise BaselineError(f"{path}: missing (write it with --json and "
                            "keep it before gating)")
    return load_baseline_file(path)


def check_suite(result: dict, committed: dict, port: dict,
                tol: float) -> Tuple[List[str], List[str]]:
    """(regressions, misconfigured) of one suite's run against the
    committed file and the port's own baseline: the wall time at twice
    ``tol``, each ``CHECK_METRICS`` metric at ``tol`` in its direction, a
    time metric against ``port``, any other against ``committed``."""
    suite = result["suite"]
    regressions: List[str] = []
    misconfigured: List[str] = []

    def gate(label, measured, reference, direction, slack=1.0):
        if not isinstance(measured, (int, float)) \
                or not isinstance(reference, (int, float)) or reference <= 0:
            return
        t = tol * slack
        ratio = measured / reference
        bad = ratio > t if direction == "lower" else ratio < 1.0 / t
        print(f"# check {label}: {measured:.4g} vs baseline "
              f"{reference:.4g} ({direction} is better) "
              f"[{'REGRESSION' if bad else 'ok'}]", flush=True)
        if bad:
            regressions.append(f"{label}: {measured:.4g} vs {reference:.4g}")

    def by_row(base):
        return {r["name"]: r.get("derived") or {}
                for r in base.get("rows", []) if isinstance(r, dict)}

    gate(f"{suite}.wall_time_s", result["wall_s"], port.get("wall_time_s"),
         "lower", slack=2.0)
    got = {r.name: jsonable(r.derived) for r in result["rows"]}
    for spec, direction in CHECK_METRICS.get(suite, {}).items():
        row, metric = spec.rsplit(".", 1)
        timed = field_kind(metric) == "time"
        base = port if timed else committed
        reference = by_row(base).get(row, {}).get(metric)
        if reference is None:
            misconfigured.append(
                f"{spec}: missing from BENCH_{'torch_' if timed else ''}"
                f"{suite}.json")
            continue
        measured = got.get(row, {}).get(metric)
        if measured is None:
            regressions.append(f"{spec}: missing (run)")
            continue
        gate(spec, float(measured), float(reference), direction)
    if result["comparison"]["missed"]:
        regressions.append(f"{suite}: held fields missed "
                           f"{result['comparison']['missed']}")
    return regressions, misconfigured


def run_check(args, starts) -> int:
    """``--check``: every named suite against its two baselines; the
    exit code as the module docstring says."""
    try:
        bases = {s: (load_baseline(s, args.baseline),
                     load_port_baseline(s, args.baseline))
                 for s in args.suites}
    except BaselineError as e:
        print(f"error: invalid or missing perf-gate baseline: {e}",
              flush=True)
        return EXIT_MISCONFIGURED
    regressions: List[str] = []
    misconfigured: List[str] = []
    crashed = 0
    print("name,us_per_call,derived", flush=True)
    for suite in args.suites:
        try:
            result = run_suite(suite, args.device, args.baseline, args.json,
                               starts, args.trace, args.records)
        except Exception as e:
            crashed += 1
            print(f"{suite},nan,ERROR {type(e).__name__}: {e}", flush=True)
            traceback.print_exc()
            continue
        for line in report(result):
            print(line, flush=True)
        r, m = check_suite(result, *bases[suite], args.tolerance)
        regressions += r
        misconfigured += m
    if crashed:
        print(f"# {crashed} suites crashed", flush=True)
        return EXIT_REGRESSION
    if misconfigured:
        print("error: misconfigured perf gate:\n  "
              + "\n  ".join(misconfigured), flush=True)
        return EXIT_MISCONFIGURED
    if regressions:
        print("# perf regressions:\n  " + "\n  ".join(regressions),
              flush=True)
        return EXIT_REGRESSION
    print("# --check passed: no perf regressions", flush=True)
    return 0


def run_spec(args, starts) -> int:
    """``--spec FILE.json``: run one declarative experiment end to end and
    print its report's rows, its recovery walls and any unrecovered cell.
    ``--run-dir``/``--resume`` override the subprocess backend's
    persistence knobs."""
    from ..api import ExperimentSpec, get_backend, run_experiment
    with open(args.spec) as f:
        spec = ExperimentSpec.from_json(f.read())
    backend = None
    if args.run_dir or args.resume:
        params = dict(spec.backend_params)
        params["run_dir"] = args.run_dir
        params["resume"] = args.resume
        backend = get_backend(spec.backend, tuple(params.items()))
    print(f"# spec {args.spec!r} -> experiment {spec.name!r} "
          f"(backend={spec.backend}"
          + (f", run_dir={args.run_dir!r}" if args.run_dir else "")
          + (", resume" if args.resume else "") + ")", flush=True)
    print("name,us_per_call,derived", flush=True)
    report = run_experiment(spec, backend=backend, device=args.device,
                            starts=starts)
    rows = report.rows()
    for row in rows:
        print(row.csv(), flush=True)
    recovery = {k: int(v) for k, v in report.walls.items()
                if k in ("resumed_trees", "shards_run", "shard_retries",
                         "reshard_trees", "failed_trees")}
    if recovery:
        print("# recovery: " + " ".join(f"{k}={v}"
                                        for k, v in sorted(recovery.items())),
              flush=True)
    for a in report.shard_attempts:
        print(f"# shard {a['shard']} attempt {a['attempt']}: "
              f"{'ok' if a['ok'] else 'failed'} in {a['latency_s']} s",
              flush=True)
    for (cell, pol), err in sorted(report.failed_cells.items(),
                                   key=lambda kv: str(kv[0])):
        print(f"# WARNING unrecovered cell {cell} arm {pol!r}: "
              + (err.splitlines()[-1][:200] if err else "?"), flush=True)
    print(f"# {spec.name} done in {report.wall_time_s:.1f}s", flush=True)
    if args.trace:
        n = write_trace_files(args.trace, spec.name)
        print(f"# trace {spec.name}: {n} events -> "
              f"{args.trace}/trace_{spec.name}.json", flush=True)
    if args.json:
        os.makedirs(args.json, exist_ok=True)
        path = os.path.join(args.json, f"BENCH_{spec.name}.json")
        report.write_bench_json(path, rows)
        print(f"# wrote {path}", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("suites", nargs="*", choices=SUITES,
                    help="suites to run (optional with --spec)")
    ap.add_argument("--json", metavar="DIR", default=None,
                    help="write BENCH_torch_<suite>.json into DIR")
    ap.add_argument("--baseline", metavar="DIR", default=str(REPO_ROOT),
                    help="directory of the committed BENCH_<suite>.json "
                    "(default: the repo root)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--committed-starts", action="store_true",
                    help="start every tuning from the starts the committed "
                    "files were made from (bench/jax_starts.npz), not from "
                    "the port's own torch.Generator draws")
    ap.add_argument("--spec", metavar="FILE.json", default=None,
                    help="run one declarative ExperimentSpec and print its "
                    "report (honors --json and --trace)")
    ap.add_argument("--run-dir", metavar="DIR", default=None,
                    help="with --spec: persist per-shard results into DIR "
                    "(atomic, checksummed) as they complete")
    ap.add_argument("--resume", action="store_true",
                    help="with --spec --run-dir: reuse valid persisted "
                    "shard results, execute only the remainder")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="enable telemetry and write trace_<suite>.json "
                    "(Chrome/Perfetto) and metrics_<suite>.json into DIR")
    ap.add_argument("--records", metavar="DIR", default=None,
                    help="dry-run records (launch/dryrun.py) for the "
                    "roofline and robust_sharding suites (default: their "
                    "committed skip rows)")
    ap.add_argument("--list", action="store_true",
                    help="print the suites with their descriptions, and "
                    "exit")
    ap.add_argument("--gated", action="store_true",
                    help="with --list: only the suites the gate watches "
                    "(CHECK_METRICS), bare")
    ap.add_argument("--check", action="store_true",
                    help="hold the named suites to the committed files and "
                    "to the port's BENCH_torch_<suite>.json in --baseline; "
                    "exit 1 on a regression, 2 on a misconfigured gate")
    ap.add_argument("--tolerance", type=float, default=1.5,
                    help="--check slack factor on every metric "
                    "(default 1.5x)")
    args = ap.parse_args(argv)
    if args.list:
        for suite in SUITES:
            if not args.gated:
                print(f"{suite:<16} {suite_description(suite)}".rstrip())
            elif suite in CHECK_METRICS:
                print(suite)
        return 0
    if args.resume and not args.run_dir:
        ap.error("--resume requires --run-dir (the directory holding the "
                 "persisted shard results)")
    if (args.run_dir or args.resume) and not args.spec:
        ap.error("--run-dir/--resume only apply to --spec runs")
    if args.spec and args.suites:
        ap.error("--spec runs one experiment; name no suites beside it")
    if args.check and not args.suites:
        ap.error("--check needs the suites to gate (--list --gated)")
    if not (args.spec or args.suites):
        ap.error("name at least one suite, or --spec FILE.json")
    starts = committed_starts if args.committed_starts else own_starts
    if args.trace:
        from .. import obs
        os.makedirs(args.trace, exist_ok=True)
        os.environ["REPRO_OBS_OUT"] = args.trace
        obs.configure(enabled=True, clock="wall")
    print(f"# device: {_device_name(args.device)}", flush=True)
    if args.spec:
        return run_spec(args, starts)
    if args.check:
        return run_check(args, starts)
    print("name,us_per_call,derived", flush=True)
    missed: Dict[str, int] = {}
    for suite in args.suites:
        result = run_suite(suite, args.device, args.baseline, args.json,
                           starts, args.trace, args.records)
        for line in report(result):
            print(line, flush=True)
        missed[suite] = len(result["comparison"]["missed"])
    if any(missed.values()):
        print(f"# held fields missed: {missed}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
