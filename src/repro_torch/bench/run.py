"""Run the paper suites on the port and hold them against the committed
``BENCH_<suite>.json``.

    PYTHONPATH=src python -m repro_torch.bench.run fig4 fig10 tuner
    PYTHONPATH=src python -m repro_torch.bench.run fig7_8 fig9 fig19
    PYTHONPATH=src python -m repro_torch.bench.run fig4 --device cpu
    PYTHONPATH=src python -m repro_torch.bench.run tuner --json out/ \\
        --baseline .

Each suite prints its rows as ``name,us_per_call,derived`` CSV, then every
field of the committed file beside the port's value.  The committed file
is read as data from ``--baseline`` (default: the repo root) after its
checksum validates; a bad checksum is an error.  Fields fall in three
kinds (:func:`field_kind`):

* **time** — the card's own, printed and not compared (the committed
  ones are another machine's): ``us_per_call``, ``wall_time_s``,
  ``*_us``, ``*_s``, ``speedup_*``, ``tunings_per_sec`` and
  ``claim_speedup_ge_10x``;
* **spread** — start-dependent, printed beside the committed value and
  not held (the port's starts come from a ``torch.Generator``, not
  ``jax.random``): ``jax_spread``, ``slsqp_spread``,
  ``max_rel_cost_diff_vs_*``;
* **held** — every other field: a bool or string must equal the
  committed value (the ``claim_*`` flags, ``klsm_best``, ``batch``,
  ``paper_reports``), an integer too (``cells``), a float must lie
  within ``ABS_TOL + REL_TOL * |committed|`` of it, and a dict (fig19's
  ``degradation``) must have the committed keys, each value held so.

A held field that misses, or a committed row or key the port lacks, is
printed by name with both values, and the runner exits 1.  ``--json DIR``
writes ``BENCH_torch_<suite>.json`` in the committed schema, stamped with
its checksum, atomically.  The suites run on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional

from ..api.report import Row, jsonable
from ..faults import atomic_write_json, checksum_ok, stamp_checksum
from .common import committed_starts, own_starts

#: suite key -> module of this package; fig7_8, fig9 and fig19 run
#: through the experiment API (``repro_torch.api.run_experiment``)
SUITES = ("fig4", "fig10", "tuner", "fig7_8", "fig9", "fig19")
#: a held float lies within ABS_TOL + REL_TOL * |committed| of the
#: committed value: tuned costs move with the starts
ABS_TOL, REL_TOL = 0.01, 0.01
TIME_FIELDS = {"us_per_call", "wall_time_s", "tunings_per_sec",
               "claim_speedup_ge_10x"}
SPREAD_FIELDS = {"jax_spread", "slsqp_spread"}
REPO_ROOT = Path(__file__).resolve().parents[3]


class BaselineError(RuntimeError):
    """A committed ``BENCH_<suite>.json`` that is missing or fails its
    checksum."""


def field_kind(name: str) -> str:
    """``"time"``, ``"spread"`` or ``"held"`` (see the module docstring)."""
    if name in TIME_FIELDS or name.endswith(("_us", "_s")) \
            or name.startswith("speedup_"):
        return "time"
    if name in SPREAD_FIELDS or name.startswith("max_rel_cost_diff_vs_"):
        return "spread"
    return "held"


def load_baseline(suite: str, baseline_dir) -> dict:
    path = Path(baseline_dir) / f"BENCH_{suite}.json"
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
            and all(_holds(got[k], want[k]) for k in want)
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
            if key not in derived or key not in brow["derived"]:
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


def run_suite(suite: str, device=None, baseline_dir=REPO_ROOT,
              json_dir: Optional[str] = None, starts=own_starts) -> dict:
    """Run one suite and hold it against its committed file (validated
    before the suite starts).  ``starts`` says where its tunings' starts
    come from (``common.py``).  Returns the rows, the wall time and the
    comparison (:func:`compare`)."""
    if suite not in SUITES:
        raise ValueError(f"unknown suite {suite!r}; known: {SUITES}")
    base = load_baseline(suite, baseline_dir)
    mod = importlib.import_module(f".{suite}", __package__)
    t0 = time.time()
    rows = mod.run(device=device, starts=starts)
    wall = time.time() - t0
    result = {"suite": suite, "rows": rows, "wall_s": wall,
              "comparison": compare(rows, wall, base)}
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("suites", nargs="+", choices=SUITES)
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
    args = ap.parse_args(argv)
    starts = committed_starts if args.committed_starts else own_starts
    print(f"# device: {_device_name(args.device)}", flush=True)
    print("name,us_per_call,derived", flush=True)
    missed: Dict[str, int] = {}
    for suite in args.suites:
        result = run_suite(suite, args.device, args.baseline, args.json,
                           starts)
        for line in report(result):
            print(line, flush=True)
        missed[suite] = len(result["comparison"]["missed"])
    if any(missed.values()):
        print(f"# held fields missed: {missed}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
