"""Rows, strict-JSON coercion and benchmark-set metrics for the paper
suites: the numpy-level part of ``repro/api/report.py``.

A suite returns :class:`Row` objects (name, microseconds per call, derived
metrics); ``repro_torch.bench.run`` prints them as CSV and writes them in
the ``BENCH_<suite>.json`` schema.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Tuple

import numpy as np


class Row:
    """One CSV/JSON output row: name, us_per_call, derived metrics."""

    def __init__(self, name: str, us: float, **derived):
        self.name = name
        self.us = us
        self.derived = derived

    def csv(self) -> str:
        d = ";".join(f"{k}={v}" for k, v in self.derived.items())
        return f"{self.name},{self.us:.1f},{d}"


def timed(fn: Callable, *args, **kw) -> Tuple[float, object]:
    t0 = time.time()
    out = fn(*args, **kw)
    return (time.time() - t0) * 1e6, out


def fmt(x: float) -> str:
    return f"{x:.4g}"


def jsonable(x):
    """Best-effort conversion of derived metric values to *strict* JSON types
    (non-finite floats become null: strict parsers reject the bare
    NaN/Infinity literals json.dump emits)."""
    if isinstance(x, dict):
        return {str(k): jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonable(v) for v in x]
    if isinstance(x, bool) or x is None:
        return x
    if hasattr(x, "item"):          # numpy / torch scalars
        try:
            return jsonable(x.item())
        except (ValueError, RuntimeError):
            return str(x)
    if isinstance(x, float):
        return x if math.isfinite(x) else None
    if isinstance(x, (int, str)):
        return x
    return str(x)


def costs_over_benchmark(phi, sys, B: np.ndarray) -> np.ndarray:
    """C(w, phi) for every workload in a benchmark set (vectorized, float64
    on the host over the float32 cost vector)."""
    from ..core import cost_vector
    c = cost_vector(phi, sys).detach().cpu().numpy().astype(np.float64)
    return np.asarray(B, np.float64) @ c


def delta_tp(cn: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """Normalized delta throughput of robust (cr) vs nominal (cn)."""
    return (1.0 / cr - 1.0 / cn) / (1.0 / cn)
