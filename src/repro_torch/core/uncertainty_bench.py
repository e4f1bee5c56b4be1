"""The uncertainty benchmark (paper Section 7).

* 15 expected workloads (Table 4): uniform / unimodal / bimodal / trimodal.
* A benchmark set ``B`` of 10,000 sampled workloads: per-class query counts
  drawn uniformly from (0, 10000), normalized.
"""

from __future__ import annotations

import numpy as np

# Table 4, exactly.
EXPECTED_WORKLOADS = np.array([
    [0.25, 0.25, 0.25, 0.25],  # 0  uniform
    [0.97, 0.01, 0.01, 0.01],  # 1  unimodal
    [0.01, 0.97, 0.01, 0.01],  # 2
    [0.01, 0.01, 0.97, 0.01],  # 3
    [0.01, 0.01, 0.01, 0.97],  # 4
    [0.49, 0.49, 0.01, 0.01],  # 5  bimodal
    [0.49, 0.01, 0.49, 0.01],  # 6
    [0.49, 0.01, 0.01, 0.49],  # 7
    [0.01, 0.49, 0.49, 0.01],  # 8
    [0.01, 0.49, 0.01, 0.49],  # 9
    [0.01, 0.01, 0.49, 0.49],  # 10
    [0.33, 0.33, 0.33, 0.01],  # 11 trimodal
    [0.33, 0.33, 0.01, 0.33],  # 12
    [0.33, 0.01, 0.33, 0.33],  # 13
    [0.01, 0.33, 0.33, 0.33],  # 14
], dtype=np.float64)

WORKLOAD_CATEGORY = (
    ["uniform"] + ["unimodal"] * 4 + ["bimodal"] * 6 + ["trimodal"] * 4
)


def sample_benchmark(n: int = 10_000, seed: int = 0,
                     max_count: int = 10_000) -> np.ndarray:
    """The benchmark set B: counts ~ U(0, max_count) per class, normalized."""
    rng = np.random.default_rng(seed)
    counts = rng.uniform(1.0, float(max_count), size=(n, 4))
    return counts / counts.sum(axis=1, keepdims=True)


def zippydb_like() -> np.ndarray:
    """Facebook ZippyDB mix (paper Section 7): 78% gets, 19% writes, 3% range.

    Gets are split empty/non-empty evenly (the survey does not distinguish)."""
    return np.array([0.39, 0.39, 0.03, 0.19], dtype=np.float64)
