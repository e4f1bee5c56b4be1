"""Workloads, KL-divergence uncertainty regions, and the rho heuristics.

The port of ``repro/core/workload.py``.  A workload is a probability vector
``w = (z0, z1, q, w_frac)`` over the four query classes (paper Section 3).
The uncertainty region (Eq. 12) is

    U^rho_w = { w' >= 0 : sum w' = 1, I_KL(w', w) <= rho }.

Array-likes become float32 tensors (the JAX package's default precision);
tensors keep their dtype and device.
"""

from __future__ import annotations

import numpy as np
import torch

QUERY_CLASSES = ("z0", "z1", "q", "w")
DIM = 4


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


def normalize(w: torch.Tensor) -> torch.Tensor:
    w = torch.clamp(w, min=0.0)
    return w / w.sum(dim=-1, keepdim=True)


def kl_divergence(p, q) -> torch.Tensor:
    """I_KL(p, q) = sum_i p_i log(p_i / q_i); 0 log 0 := 0 (Definition 1)."""
    p = _as_tensor(p)
    q = _as_tensor(q).to(p.dtype)
    ratio = torch.where(p > 0, p / torch.clamp(q, min=1e-30),
                        torch.ones_like(p))
    return torch.where(p > 0, p * torch.log(ratio),
                       torch.zeros_like(p)).sum(dim=-1)


def worst_case_workload(c, w, rho: float, iters: int = 80) -> torch.Tensor:
    """Exact inner maximizer of Eq. 13: argmax_{w' in U^rho_w} w'^T c.

    The maximizer is the exponential tilt ``w'_i ∝ w_i exp(c_i / lam)`` with
    ``lam`` chosen by geometric bisection so that I_KL(w', w) = rho (or the
    point-mass-limit tilt when even that stays inside the ball).  Rho <= 0
    and flat costs return ``w`` itself.  Unlike the JAX package, the flat
    guard tests the raw span: there the span is clamped to >= 1e-12 before
    the test, so the guard never fires and flat costs return a float32
    tilt at tiny lam (uniform) instead of ``w``."""
    c = _as_tensor(c)
    w = normalize(_as_tensor(w).to(c.dtype))
    span_raw = c.max() - c.min()
    span = torch.clamp(span_raw, min=1e-12)

    def tilt(lam):
        return torch.softmax(torch.log(w) + c / torch.clamp(lam, min=1e-12),
                             dim=-1)

    def kl_at(lam):
        return kl_divergence(tilt(lam), w)

    lo, hi = span * 1e-9, span * 1e9
    for _ in range(iters):
        mid = torch.sqrt(lo * hi)   # geometric bisection over many decades
        too_spread = kl_at(mid) > rho
        lo, hi = torch.where(too_spread, mid, lo), torch.where(too_spread,
                                                               hi, mid)
    w_hat = tilt(torch.sqrt(lo * hi))
    if kl_at(span * 1e-9) <= rho:
        w_hat = tilt(span * 1e-9)
    if rho <= 0.0 or span_raw < 1e-12:
        return w
    return w_hat


def rho_from_history(workloads) -> float:
    """Algorithm 1: rho = max_i I_KL(w_i, w_bar) over historical workloads."""
    W = np.asarray(workloads, dtype=np.float64)
    w_bar = W.mean(axis=0)
    return max(float(kl_divergence(w, w_bar)) for w in W)


def rho_from_pair(expected, off_period) -> float:
    """DBA heuristic: KL between an expected and an off-period workload."""
    return float(kl_divergence(np.asarray(off_period), np.asarray(expected)))


def rho_from_ranges(lo, hi, n_samples: int = 4096, seed: int = 0) -> float:
    """DBA heuristic: sample workloads within per-class ranges (the JAX
    package's numpy draw), apply Algorithm 1."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    samples = rng.uniform(lo, hi, size=(n_samples, DIM))
    samples = samples / samples.sum(axis=1, keepdims=True)
    return rho_from_history(samples)
