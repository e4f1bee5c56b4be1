"""Roofline table: measured kernel cells, and the aggregation of the port's
dry-run records.

The port of ``benchmarks/bench_roofline.py``.  Two kinds of rows:

* ``roofline_kernels`` — **measured on the device**.  Every kernel cell
  of ``bench/kernels.py`` (point read, warm dual solve, compaction merge)
  is timed on the card, its effective bytes come from the engine's own
  I/O accounting, and its achieved bytes/s is set against a *measured*
  ceiling: the device's copy bandwidth, the best of ``COPY_REPEATS``
  copies of a ``COPY_BYTES`` tensor into another on the same device,
  read and write both charged (:func:`copy_gbps`).  ``measured_cells``
  counts the cells with a finite achieved bandwidth; a run in which no
  cell measured and no record exists raises.
* ``roofline_single`` / ``roofline_multipod`` — the port's dry-run
  records (``launch/dryrun.py``) of one mesh, counted by status and
  bottleneck, when a records directory is given (``records``; the
  runner's ``--records``).  Without one these rows are the committed skip
  rows, word for word: the JAX package's dry-run artifacts are another
  package's, and none is committed.
"""

from __future__ import annotations

import json
import math
import pathlib
import time
from collections import Counter
from typing import Dict, List, Optional

import torch

from ..api import Row
from ..configs import ARCHS, SHAPES
from ..kernels._compat import resolve_device
from .common import own_starts

#: why a dryrun row is skipped (the committed rows' text)
NO_ARTIFACTS = ("no dry-run artifacts under experiments/dryrun "
                "(launch/dryrun.py is a separate 512-device process)")
COPY_BYTES = 1 << 30
COPY_REPEATS = 10
#: device memory a record's per-device peak must fit (H100 80 GB)
DEVICE_GB = 80.0


def load_records(records, mesh: str, tag: str = "baseline") -> dict:
    out = {}
    for f in sorted(pathlib.Path(records).glob(f"*__{mesh}__{tag}.json")):
        r = json.loads(f.read_text())
        out[(r["arch"], r["shape"])] = r
    return out


def copy_gbps(device=None, nbytes: Optional[int] = None,
              repeats: Optional[int] = None) -> float:
    """The device's copy bandwidth in GB/s: best of ``repeats`` copies of
    an ``nbytes`` tensor into another on the device, read + write
    charged, as the kernel cells charge their effective bytes."""
    dev = resolve_device(device)
    nbytes = COPY_BYTES if nbytes is None else nbytes
    repeats = COPY_REPEATS if repeats is None else repeats
    src = torch.ones(nbytes // 8, dtype=torch.int64, device=dev)
    dst = torch.empty_like(src)
    best = math.inf
    for _ in range(repeats + 1):            # the first copy warms up
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        dst.copy_(src)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        best = min(best, time.perf_counter() - t0)
    del src, dst
    return 2 * nbytes / best / 1e9


def kernel_cells_row(device=None) -> Row:
    from .kernels import measure_cells
    peak = copy_gbps(device)
    cells: Dict[str, Dict[str, float]] = {}
    for name, d in measure_cells(device).items():
        g = d.get("achieved_gbps")
        if not isinstance(g, (int, float)) or not math.isfinite(g) or g <= 0:
            cells[name] = {"achieved_gbps": None,
                           "skipped_reason": "no finite bandwidth measured"}
            continue
        cells[name] = {"achieved_gbps": g, "frac_of_copy_peak": g / peak,
                       "effective_bytes": d["effective_bytes"],
                       "us": d["us_kernel"]}
    measured = sum(1 for c in cells.values()
                   if c.get("achieved_gbps") is not None)
    return Row("roofline_kernels", 0.0, measured_cells=measured,
               copy_peak_gbps=peak, cells=cells)


def mesh_row(records, mesh: str) -> Row:
    recs = load_records(records, mesh) if records is not None else {}
    expected = len(ARCHS) * len(SHAPES)
    if not recs:
        return Row(f"roofline_{mesh}", 0.0, cells="skipped",
                   expected=expected, skipped_reason=NO_ARTIFACTS)
    statuses = Counter(r["status"] for r in recs.values())
    oks = [r for r in recs.values() if r["status"] == "ok"]
    bottl = Counter(r["roofline"]["bottleneck"] for r in oks)
    fits = [r for r in oks
            if (r["roofline"].get("memory_per_dev_gb") or 0) <= DEVICE_GB]
    worst = min(oks, key=lambda r: r["roofline"]["roofline_frac"],
                default=None)
    return Row(f"roofline_{mesh}", 0.0,
               cells=f"{len(recs)}/{expected}",
               ok=statuses.get("ok", 0),
               skipped=statuses.get("skipped", 0),
               errors=statuses.get("error", 0),
               all_compile=statuses.get("error", 0) == 0,
               bottlenecks=dict(bottl),
               fits_80gb=f"{len(fits)}/{len(oks)}",
               worst_cell=(f"{worst['arch']}x{worst['shape']}"
                           f"={worst['roofline']['roofline_frac']:.3f}"
                           if worst else "n/a"))


def run(device=None, starts=own_starts, records=None) -> List[Row]:
    """The suite's rows; ``records``: a directory of the port's dry-run
    records (none: the committed skip rows).  It runs no tuner, so
    ``starts`` is unused."""
    rows: List[Row] = [kernel_cells_row(device)]
    rows += [mesh_row(records, mesh) for mesh in ("single", "multipod")]
    if rows[0].derived["measured_cells"] == 0 \
            and all(r.derived["cells"] == "skipped" for r in rows[1:]):
        raise RuntimeError(
            "roofline measured nothing: no kernel cell produced a finite "
            "bandwidth and no dry-run record exists")
    return rows
