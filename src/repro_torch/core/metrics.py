"""Evaluation metrics (paper Section 8.1) on torch tensors.

The port of ``repro/core/metrics.py``.  Workloads may be array-likes
(taken as float32, the JAX package's default precision) or tensors; the
result lies on the tunings' device.
"""

from __future__ import annotations

import torch

from .lsm_cost import LSMSystem, Phi, cost_vector


def _on(x, phi: Phi) -> torch.Tensor:
    return torch.as_tensor(x, dtype=phi.T.dtype, device=phi.T.device)


def delta_throughput(w, phi1: Phi, phi2: Phi, sys: LSMSystem
                     ) -> torch.Tensor:
    """Normalized delta throughput Delta_w(phi1, phi2); > 0 iff phi2 wins."""
    w = _on(w, phi1)
    c1 = (w * cost_vector(phi1, sys)).sum(dim=-1)
    c2 = (w * cost_vector(phi2, sys)).sum(dim=-1)
    return (1.0 / c2 - 1.0 / c1) / (1.0 / c1)


def delta_throughput_batch(W, phi1: Phi, phi2: Phi, sys: LSMSystem
                           ) -> torch.Tensor:
    """Vectorized over a workload set, shape (n, 4) -> (n,)."""
    W = _on(W, phi1)
    c1 = W @ cost_vector(phi1, sys)
    c2 = W @ cost_vector(phi2, sys)
    return (1.0 / c2 - 1.0 / c1) / (1.0 / c1)


def throughput_range(W, phi: Phi, sys: LSMSystem) -> torch.Tensor:
    """Theta_B(phi) = max 1/C - min 1/C over the benchmark set."""
    thr = 1.0 / (_on(W, phi) @ cost_vector(phi, sys))
    return thr.max() - thr.min()
