"""Shared singletons of the paper suites: the paper-scale system, the
Section 7 benchmark set B (the JAX package's numpy draw, so the same
10,000 workloads), and where each tuning's multi-starts come from.

A suite asks ``starts(design, n_starts, seed)`` for every Adam tuning it
runs.  :func:`own_starts` answers None: the tuner draws its starts from a
``torch.Generator`` seeded with ``seed``.  :func:`committed_starts` answers
the starts the committed ``BENCH_<suite>.json`` were made from: the JAX
package's ``random_inits(PRNGKey(seed), n_starts, design)`` under its
former PRNG (``jax_threefry_partitionable=False``), which
``tests/jax_starts.py`` writes into ``jax_starts.npz`` beside this module.
Run from those, a suite that misses a committed value shows a fault of the
port; run from its own, it may show the suite's sensitivity to its starts.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..api.report import costs_over_benchmark
from ..core import LSMSystem, sample_benchmark
from ..core.designs import n_params

SYS = LSMSystem()
B_SET = sample_benchmark(10_000, seed=0)
STARTS_FILE = Path(__file__).with_name("jax_starts.npz")


def costs_over_B(phi, sys=SYS) -> np.ndarray:
    """C(w, phi) for every workload in the benchmark set (vectorized)."""
    return costs_over_benchmark(phi, sys, B_SET)


def starts_key(n_par: int, n_starts: int, seed: int) -> str:
    """The name of one draw in ``jax_starts.npz``: ``random_inits``
    depends on the design only through its parameter count."""
    return f"p{n_par}_n{n_starts}_seed{seed}"


def own_starts(design, n_starts: int, seed: int):
    return None


def committed_starts(design, n_starts: int, seed: int) -> torch.Tensor:
    """``(1, n_starts, n_params)`` float32, as the tuners take them."""
    with np.load(STARTS_FILE) as f:
        draw = f[starts_key(n_params(design, SYS), n_starts, seed)]
    return torch.from_numpy(np.array(draw, np.float32))[None]
