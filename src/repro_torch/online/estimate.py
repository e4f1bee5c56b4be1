"""Streaming workload estimation over observed flush-window op counts: the
port of ``repro/online/estimate.py``.

The observation stream is the ``SessionResult.window_ops`` arrays the
session executor emits (one (z0, z1, q, w) count row per flush window, see
:mod:`repro_torch.lsm.workload_runner`).  This module turns that stream into

* a bounded history (:class:`WindowHistory`, a fixed-capacity ring buffer of
  window counts — O(capacity) memory regardless of session length);
* a current-mix *estimate* (:class:`SlidingWindowEstimator` — count-weighted
  mean of the last W windows — and :class:`EWMAEstimator` — exponentially
  weighted mean of per-window mixes);
* a *robustness budget*: :func:`rho_from_windows` is the online form of the
  paper's Algorithm 1 (rho = max KL of the observed window mixes against a
  center), and :func:`rho_from_history_batch` evaluates the measured
  KL divergence between expected and observed mixes for a whole fleet in one
  broadcast :func:`repro_torch.core.kl_divergence` call — the
  ``rho_from_history`` rho source of :class:`repro_torch.api.WorkloadSpec`,
  fed from live history.

Everything here is numpy on the host: the loop reads a few counts per
segment.  Only the fleet-batched entry point goes through torch (float32 on
the CPU, as the tuners' cost vectors are).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

#: probability floor used inside KL, matching repro_torch.core.workload's clamp.
_KL_EPS = 1e-30


def normalize_counts(counts) -> np.ndarray:
    """Rows of op counts (or mixes) -> normalized probability rows."""
    c = np.atleast_2d(np.asarray(counts, np.float64))
    tot = np.maximum(c.sum(axis=1, keepdims=True), 1e-30)
    return c / tot


def smooth_mix(mix, eps: float = 0.004) -> np.ndarray:
    """Floor a mix away from the simplex boundary: (1-eps) m + eps/4.

    An estimate that serves as a KL *center* (drift reference, re-tune
    target) must not carry zero-probability classes: a single later
    observation of a zero-count class would otherwise produce an unbounded
    divergence — and an unbounded robustness budget.  ``eps`` bounds any
    KL against the smoothed center by ~ln(4/eps) nats."""
    m = np.asarray(mix, np.float64)
    return (1.0 - eps) * m + eps / m.shape[-1]


def kl_np(p, q) -> np.ndarray:
    """I_KL(p, q) with 0 log 0 := 0 — numpy twin of core.kl_divergence."""
    p = np.asarray(p, np.float64)
    q = np.asarray(q, np.float64)
    ratio = np.where(p > 0, p / np.maximum(q, _KL_EPS), 1.0)
    return np.sum(np.where(p > 0, p * np.log(ratio), 0.0), axis=-1)


class WindowHistory:
    """Fixed-capacity ring buffer of per-window (z0, z1, q, w) counts.

    ``append`` takes one window row or a whole ``window_ops`` batch; the
    oldest windows fall off once ``capacity`` is exceeded.  Accessors return
    chronological (oldest -> newest) views."""

    def __init__(self, capacity: int = 128):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._buf = np.zeros((self.capacity, 4), np.int64)
        self._next = 0            # next write slot
        self._n = 0               # live rows (<= capacity)
        self.total_windows = 0    # windows ever observed

    def __len__(self) -> int:
        return self._n

    def append(self, counts) -> None:
        rows = np.atleast_2d(np.asarray(counts, np.int64))
        if rows.shape[-1] != 4:
            raise ValueError(f"window counts must be (., 4), got {rows.shape}")
        self.total_windows += len(rows)
        if len(rows) >= self.capacity:   # only the newest `capacity` survive
            self._buf[:] = rows[-self.capacity:]
            self._next = 0
            self._n = self.capacity
            return
        for row in rows:                 # small batches: ring insert
            self._buf[self._next] = row
            self._next = (self._next + 1) % self.capacity
            self._n = min(self._n + 1, self.capacity)

    def counts(self, last: Optional[int] = None) -> np.ndarray:
        """The newest ``last`` (default: all live) windows, chronological."""
        n = self._n if last is None else min(int(last), self._n)
        idx = (self._next - n + np.arange(n)) % self.capacity
        return self._buf[idx]

    def mixes(self, last: Optional[int] = None) -> np.ndarray:
        return normalize_counts(self.counts(last))

    def total_mix(self, last: Optional[int] = None) -> np.ndarray:
        """Count-weighted mix over the newest ``last`` windows.  An empty
        (or all-zero) history has no evidence and estimates uniform — the
        only mix that biases no query class, and a proper distribution for
        downstream KL centers (all-zero would not be)."""
        c = self.counts(last).sum(axis=0)
        if c.sum() <= 0:
            return np.full(4, 0.25)
        return normalize_counts(c)[0]


class SlidingWindowEstimator:
    """Count-weighted mean mix over the newest ``window`` flush windows."""

    name = "window"

    def __init__(self, window: int = 16, **_):
        self.window = int(window)

    def estimate(self, history: WindowHistory) -> np.ndarray:
        return history.total_mix(last=self.window)


class EWMAEstimator:
    """Exponentially weighted mean of per-window mixes (newest weight
    ``alpha``); weights renormalize over the live history, so the estimate
    is a proper convex combination from the very first window."""

    name = "ewma"

    def __init__(self, alpha: float = 0.35, **_):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.alpha = float(alpha)

    def estimate(self, history: WindowHistory) -> np.ndarray:
        mixes = history.mixes()                     # chronological
        n = len(mixes)
        if n == 0:                 # no evidence: uniform, like total_mix
            return np.full(4, 0.25)
        w = self.alpha * (1.0 - self.alpha) ** np.arange(n - 1, -1, -1.0)
        w /= w.sum()
        return w @ mixes


ESTIMATORS = {
    SlidingWindowEstimator.name: SlidingWindowEstimator,
    EWMAEstimator.name: EWMAEstimator,
}


def make_estimator(name: str, **kw):
    try:
        cls = ESTIMATORS[name]
    except KeyError:
        raise ValueError(f"unknown estimator {name!r}; "
                         f"known: {sorted(ESTIMATORS)}") from None
    return cls(**kw)


def rho_from_windows(counts, center=None, floor: float = 0.0) -> float:
    """Algorithm 1 on an observed window history: rho = max_i I_KL(m_i, c).

    ``counts`` are window count (or mix) rows; ``center`` defaults to their
    mean mix (exactly :func:`repro_torch.core.rho_from_history` on the normalized
    rows), or pass the estimator's current mix to budget the spread around
    the tuning target.  ``floor`` clamps the result away from zero so a
    perfectly steady history still leaves a hedge.  An empty history has
    measured no drift: the budget is exactly the floor."""
    mixes = normalize_counts(counts)
    if mixes.shape[0] == 0 or not np.any(np.asarray(counts)):
        return float(floor)
    c = mixes.mean(axis=0) if center is None else \
        normalize_counts(center)[0]
    return float(max(kl_np(mixes, c).max(), floor))


def rho_from_history_batch(expected, counts, floor: float = 0.0):
    """Fleet-vectorized rho-from-history: measured drift per tree.

    ``expected`` is the (F, 4) matrix of tuning-time expected mixes and
    ``counts`` the (F, W, 4) stack of observed window counts (one history
    per tree).  Returns the (F,) robustness budgets rho_f = max over windows
    of I_KL(observed mix, expected_f) — the measured KL divergence between
    what each tree was tuned for and what it actually served — through one
    broadcast :func:`repro_torch.core.kl_divergence` call."""
    from ..core import kl_divergence
    E = np.atleast_2d(np.asarray(expected, np.float64))
    C = np.asarray(counts, np.float64)
    if C.ndim != 3 or C.shape[0] != E.shape[0] or C.shape[-1] != 4:
        raise ValueError(f"counts must be (F, W, 4) matching expected "
                         f"(F, 4); got {C.shape} vs {E.shape}")
    if C.shape[1] == 0:            # no windows observed: no measured drift
        return np.full(E.shape[0], floor, np.float64)
    mixes = C / np.maximum(C.sum(axis=-1, keepdims=True), 1e-30)
    kls = kl_divergence(mixes, E[:, None, :]).numpy()
    return np.maximum(kls.max(axis=-1), floor)
