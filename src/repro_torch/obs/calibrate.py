"""Measured-cost calibration: regress profile constants from telemetry.

The port's copy of ``repro/obs/calibrate.py``.  The cost model's profile
constants — per-op I/O weights on the (Z0, Z1, Q, W)
cost vector and the lazy-leveling fill factor (`LAZY_LEVELING_FILL`) —
were hand-fit against one benchmark; this pass refits them from captured
``session.execute`` span telemetry (per-phase IOStats deltas attached to
spans by ``workload_runner.execute_session``) and emits a calibration
artifact recording measured-vs-model agreement per policy, before and
after the fit.

The fit is deliberately simple and well-conditioned:

* **per-op weights** — for one policy with model cost vector ``c`` (4,)
  and S captured sessions (mix matrix ``M`` (S,4), measured I/O ``y``
  (S,)), solve the least-squares ``y ~= M @ (c * alpha)`` for the
  multiplicative correction ``alpha`` (clipped non-negative).  The bench
  fleet's four near-pure sessions make this a well-conditioned 4x4
  system, so the fitted agreement is near-exact by construction — the
  artifact's value is *alpha itself*: how far each hand constant sits
  from measurement.
* **lazy-leveling fill** — a 1-D grid search on the ``fill`` knob of
  :func:`repro_torch.core.policy_effective_phi`, minimising the squared
  log-ratio between measured and model session I/O.  This is the exact
  constant the hand calibration fixed at 0.125.  The model costs come
  from the port's float32 cost model on ``device`` (the card unless
  ``device="cpu"``); the regression around them is numpy float64.

Agreement is reported as the suite's ``agreement_ratio`` (measured mean
over model mean) plus its symmetric *closeness* ``min(a, 1/a)`` — 1.0 is
perfect, and "fitted >= hand" is the gate in ``BENCH_obs.json``.

Unlike the rest of :mod:`repro_torch.obs` this module needs numpy, and the
fill fit lazily imports the torch cost model — it is a leaf submodule,
never imported by ``repro_torch.obs.__init__``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..faults import atomic_write_json, stamp_checksum

SCHEMA = "repro.obs.calibration.v1"


def session_samples(events: Sequence[dict]) -> List[dict]:
    """Extract calibration samples from ``session.execute`` span events.

    Returns one dict per span that carried a mix and a measured I/O:
    ``{"label", "mix" (4,), "avg_io", "queries"}``; ``label`` is the
    tree's obs label (``.../<policy>`` by fleet convention)."""
    out: List[dict] = []
    for ev in events:
        if ev.get("kind") != "span" or ev.get("name") != "session.execute":
            continue
        attrs = ev.get("attrs") or {}
        if "mix" not in attrs or "avg_io" not in attrs:
            continue
        out.append({
            "label": str(ev.get("track", "") or attrs.get("label", "")),
            "mix": np.asarray(attrs["mix"], np.float64),
            "avg_io": float(attrs["avg_io"]),
            "queries": int(attrs.get("queries", 0)),
        })
    return out


def group_by_policy(samples: Sequence[dict]
                    ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Group samples into per-policy ``(M, y)`` regression inputs.

    The fleet labels trees ``<tenant-or-cell>/<policy>``; the suffix
    after the last ``/`` is the policy name."""
    grouped: Dict[str, List[dict]] = {}
    for s in samples:
        policy = s["label"].rsplit("/", 1)[-1] if s["label"] else ""
        grouped.setdefault(policy, []).append(s)
    out = {}
    for policy, rows in grouped.items():
        M = np.stack([r["mix"] for r in rows])
        y = np.array([r["avg_io"] for r in rows], np.float64)
        out[policy] = (M, y)
    return out


def agreement(measured: np.ndarray, model: np.ndarray) -> Tuple[float, float]:
    """(ratio, closeness): the BENCH_compaction ``agreement_ratio`` and
    its symmetric closeness ``min(a, 1/a)`` in (0, 1]."""
    a = float(np.mean(measured) / max(float(np.mean(model)), 1e-12))
    closeness = min(a, 1.0 / a) if a > 0 else 0.0
    return a, closeness


def fit_io_weights(M: np.ndarray, y: np.ndarray, c_model: np.ndarray
                   ) -> Dict[str, object]:
    """Least-squares per-op I/O weight corrections (see module docstring).

    Returns alpha (4,), the fitted cost vector, and hand/fitted
    agreement for this policy's captured sessions."""
    M = np.atleast_2d(np.asarray(M, np.float64))
    y = np.asarray(y, np.float64)
    c = np.asarray(c_model, np.float64)
    A = M * c[None, :]
    alpha, *_ = np.linalg.lstsq(A, y, rcond=None)
    alpha = np.clip(alpha, 0.0, None)
    c_fit = c * alpha
    hand_ratio, hand_close = agreement(y, M @ c)
    fit_ratio, fit_close = agreement(y, M @ c_fit)
    return {
        "alpha": [round(float(a), 6) for a in alpha],
        "c_model": [round(float(x), 6) for x in c],
        "c_fitted": [round(float(x), 6) for x in c_fit],
        "agreement_hand": round(hand_ratio, 4),
        "agreement_fitted": round(fit_ratio, 4),
        "closeness_hand": round(hand_close, 4),
        "closeness_fitted": round(fit_close, 4),
        "sessions": int(len(y)),
    }


def fit_lazy_fill(phi, sys, M: np.ndarray, y: np.ndarray,
                  params: tuple = (),
                  grid: Optional[Sequence[float]] = None,
                  device=None) -> Dict[str, float]:
    """Grid-refit the lazy-leveling ``fill`` constant from measurement.

    Minimises the mean squared log-ratio between measured session I/O and
    the model prediction at each candidate fill.  Lazily imports the torch
    cost model and runs it on ``device`` (the card unless
    ``device="cpu"``); returns the fitted fill, the hand value in use, and
    the loss at both."""
    from ..core import (LAZY_LEVELING_FILL, Phi, cost_vector,
                        policy_effective_phi)
    from ..kernels._compat import resolve_device
    dev = resolve_device(device)
    phi = Phi(T=phi.T.to(dev), mfilt_bits=phi.mfilt_bits.to(dev),
              K=phi.K.to(dev))
    M = np.atleast_2d(np.asarray(M, np.float64))
    y = np.asarray(y, np.float64)
    hand = float(dict(params).get("fill", LAZY_LEVELING_FILL))
    if grid is None:
        grid = [round(0.025 * g, 3) for g in range(1, 33)]   # 0.025 .. 0.8

    def loss_at(fill: float) -> float:
        p = tuple(kv for kv in params if kv[0] != "fill") + (("fill", fill),)
        eff = policy_effective_phi(phi, sys, "lazy_leveling", p)
        c = cost_vector(eff, sys).detach().cpu().numpy().astype(np.float64)
        pred = np.maximum(M @ c, 1e-12)
        return float(np.mean(np.log(np.maximum(y, 1e-12) / pred) ** 2))

    losses = {float(f): loss_at(float(f)) for f in grid}
    best = min(losses, key=lambda f: (losses[f], f))
    return {"fill_hand": hand, "fill_fitted": best,
            "loss_hand": round(loss_at(hand), 6),
            "loss_fitted": round(losses[best], 6)}


def calibrate(events: Sequence[dict],
              model_costs: Dict[str, np.ndarray],
              phi_by_policy: Optional[Dict[str, object]] = None,
              sys=None,
              policy_params: Dict[str, tuple] = (),
              device=None) -> Dict[str, object]:
    """The full calibration pass: telemetry events -> artifact payload.

    ``model_costs`` maps policy -> hand-calibrated cost vector (4,)
    (``Report.model_costs[cell]``).  When ``phi_by_policy``/``sys`` are
    given and a lazy_leveling group exists, the fill constant is refit
    too, through the cost model on ``device``."""
    groups = group_by_policy(session_samples(events))
    policies: Dict[str, object] = {}
    for policy in sorted(model_costs):
        if policy not in groups:
            continue
        M, y = groups[policy]
        fit = fit_io_weights(M, y, model_costs[policy])
        if (policy == "lazy_leveling" and phi_by_policy
                and policy in phi_by_policy and sys is not None):
            fit["fill"] = fit_lazy_fill(
                phi_by_policy[policy], sys, M, y,
                params=dict(policy_params).get(policy, ()), device=device)
        policies[policy] = fit
    payload = {
        "schema": SCHEMA,
        "policies": policies,
        "all_fitted_ge_hand": bool(policies) and all(
            p["closeness_fitted"] >= p["closeness_hand"] - 1e-9
            for p in policies.values()),
    }
    return payload


def write_calibration(path: str, payload: Dict[str, object]) -> None:
    """Persist the calibration artifact (checksummed, atomic)."""
    atomic_write_json(path, stamp_checksum(dict(payload)))
