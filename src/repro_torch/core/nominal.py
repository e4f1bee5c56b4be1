"""NOMINAL TUNING (paper Problem 1): Phi_N = argmin_Phi C(w, Phi).

The port of ``repro/core/nominal.py``.  Two solvers:

* :func:`tune_nominal` — the batched multi-start Adam tuner of
  ``batch.py`` on a one-workload grid;
* :func:`tune_nominal_slsqp` — paper-faithful SciPy SLSQP on the host, with
  values and gradients from ``torch.autograd`` on the caller's device and
  the JAX package's numpy starts, so both packages start from the same x0.

Results are integral tunings (ceil/round per Section 5.2) re-scored with
the exact cost model.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..kernels._compat import resolve_device
from . import designs
from .designs import DesignSpace
from .lsm_cost import LSMSystem, Phi, expected_cost


@dataclasses.dataclass
class TuningResult:
    phi: Phi                     # integral, deploy-ready (CPU tensors)
    cost: float                  # exact C(w, phi) after rounding
    design: DesignSpace
    raw_phi: Optional[Phi] = None  # pre-rounding solution
    solver: str = "torch"

    def describe(self, sys: LSMSystem) -> str:
        return designs.describe(self.phi, sys)


def tune_nominal(w, sys: LSMSystem,
                 design: DesignSpace = DesignSpace.CLASSIC,
                 n_starts: int = 64, steps: int = 250, lr: float = 0.25,
                 seed: int = 0, device=None, starts=None) -> TuningResult:
    """Solve NOMINAL TUNING for ``design``; CLASSIC = best of {level, tier}.
    ``starts`` (n_starts, n_params) replaces the seeded draw."""
    from .batch import tune_nominal_many  # batch imports this module
    if starts is not None:
        starts = torch.as_tensor(np.array(starts, np.float32))[None]
    return tune_nominal_many([w], sys, design=design, n_starts=n_starts,
                             steps=steps, lr=lr, seed=seed, device=device,
                             starts=starts)[0]


# ---------------------------------------------------------------------------
# SciPy SLSQP (paper parity)
# ---------------------------------------------------------------------------

def _theta_bounds(design: DesignSpace, sys: LSMSystem):
    return [(-8.0, 8.0)] * designs.n_params(design, sys)


def _value_and_grad(obj, dev):
    """SciPy's objective: x (float64) -> (value, float64 gradient) of
    ``obj`` at the float32 ``x`` on ``dev``, through autograd."""
    def f(x):
        th = torch.tensor(x, dtype=torch.float32, device=dev,
                          requires_grad=True)
        v = obj(th)
        (g,) = torch.autograd.grad(v, th)
        return float(v.detach()), g.to(torch.float64).cpu().numpy()
    return f


def _slsqp_best(f, starts, bounds, maxiter: int):
    """Bounded SLSQP from each start; the best finite ``res.x``, or None
    when every start failed (paper Section 11's failure mode).  A start
    that SciPy fails is skipped; an error raised inside the objective
    (torch, the device) propagates."""
    from scipy.optimize import minimize  # lazy: scipy only needed here

    raised = []

    def traced(x):
        try:
            return f(x)
        except Exception as e:
            raised.append(e)
            raise

    best_x, best_v = None, np.inf
    for x0 in starts:
        try:
            res = minimize(traced, x0, jac=True, method="SLSQP",
                           bounds=bounds,
                           options={"maxiter": maxiter, "ftol": 1e-12})
        except Exception:
            if raised:
                raise
            continue
        if np.isfinite(res.fun) and res.fun < best_v:
            best_x, best_v = res.x, float(res.fun)
    return best_x


def tune_nominal_slsqp(w, sys: LSMSystem,
                       design: DesignSpace = DesignSpace.CLASSIC,
                       n_starts: int = 8, seed: int = 0,
                       device=None) -> TuningResult:
    """Paper-faithful SLSQP on the smooth objective, in the same sigmoid
    coordinates as the Adam tuner (box constraints hold by construction).
    CLASSIC is the better of the LEVELING and TIERING solves; if SLSQP fails
    on every start, the Adam tuner answers."""
    if design is DesignSpace.CLASSIC:
        cands = [tune_nominal_slsqp(w, sys, d, n_starts, seed, device)
                 for d in (DesignSpace.LEVELING, DesignSpace.TIERING)]
        return min(cands, key=lambda r: r.cost)

    dev = resolve_device(device)
    w32 = np.asarray(w, np.float32)
    w_dev = torch.as_tensor(w32, device=dev)
    f = _value_and_grad(lambda th: expected_cost(
        w_dev, designs.to_phi(th, design, sys, smooth=True), sys,
        smooth=True), dev)
    rng = np.random.default_rng(seed)
    starts = [rng.uniform(-3, 3, designs.n_params(design, sys))
              for _ in range(n_starts)]
    best_x = _slsqp_best(f, starts, _theta_bounds(design, sys), maxiter=200)
    if best_x is None:
        return tune_nominal(w, sys, design, seed=seed, device=device)

    raw_phi = designs.to_phi(torch.tensor(best_x, dtype=torch.float32),
                             design, sys)
    phi = raw_phi.round_integral(sys)
    cost = float(expected_cost(torch.from_numpy(w32), phi, sys))
    return TuningResult(phi=phi, cost=cost, design=design, raw_phi=raw_phi,
                        solver="slsqp")
