"""ROBUST TUNING (paper Problem 2, Section 6): ENDURE, on torch tensors.

The port of ``repro/core/robust.py``.

    Phi_R = argmin_Phi  max_{w' in U^rho_w}  w'^T c(Phi)

solved through the Ben-Tal et al. dual in its entropic-risk form

    g(lam; Phi) = rho*lam + lam * logsumexp_i( log w_i + c_i(Phi) / lam ),

minimized over ``lam`` (1-D, convex in log lam) and over ``Phi`` by the
batched multi-start Adam of ``batch.py``.  Every function is lane-batched:
``c`` is ``(L, 4)``, ``w`` ``(L, 4)`` or ``(4,)``, ``rho`` ``(L,)``.

* :func:`robust_cost` / :func:`dual_solve_cold` — full grid + golden
  solves, plain torch ops (the JAX package has no kernel for them);
* :func:`dual_solve_warm` — the 3-point warm refinement the tuner runs at
  every Adam step, through kernel 1 (``kernels/dual_solve``);
* :func:`tune_robust_slsqp` — SciPy SLSQP on Eq. 17 over (Phi, lam, eta)
  jointly (:func:`dual_objective_explicit`), gradients from autograd on the
  caller's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels._compat import resolve_device
from ..kernels.dual_solve.ops import dual_solve_warm  # noqa: F401 (re-export)
from . import designs
from .designs import DesignSpace
from .lsm_cost import LSMSystem, Phi, cost_vector
from .nominal import TuningResult, _slsqp_best, _theta_bounds, _value_and_grad
from .workload import worst_case_workload

_GR = 0.6180339887498949  # golden ratio conjugate


def _col(x: torch.Tensor) -> torch.Tensor:
    return x[..., None]


def dual_objective_explicit(c: torch.Tensor, w, rho, lam, eta
                            ) -> torch.Tensor:
    """Eq. 16 verbatim: eta + rho lam + lam sum w_i (exp((c_i-eta)/lam) - 1),
    over the last axis of ``c``; ``lam`` and ``eta`` broadcast against the
    leading ones."""
    lam = torch.clamp(torch.as_tensor(lam, dtype=c.dtype, device=c.device),
                      min=1e-12)
    eta = torch.as_tensor(eta, dtype=c.dtype, device=c.device)
    s = (c - _col(eta)) / _col(lam)
    return eta + rho * lam + lam * (w * (torch.exp(s) - 1.0)).sum(dim=-1)


def _g_of_lam(c: torch.Tensor, w: torch.Tensor, rho, lam: torch.Tensor
              ) -> torch.Tensor:
    """g(lam) = rho lam + lam * LSE(log w + c/lam); c, w (L, n), lam (L,)."""
    lam = torch.clamp(lam, min=1e-12)
    return rho * lam + lam * torch.logsumexp(torch.log(w) + c / _col(lam),
                                             dim=-1)


def _g_at(c, w, rho, lams: torch.Tensor) -> torch.Tensor:
    """g at several lambdas per lane at once: ``lams`` (L, G) -> (L, G),
    each column as ``_g_of_lam`` gives it."""
    return _g_of_lam(c[:, None], w[:, None], rho[:, None], lams)


def _golden_refine(c, w, rho, llo, lhi, n_golden: int):
    """Golden-section minimization of g(exp(llam)) on the log-lam bracket;
    both interior points of a step in one evaluation."""
    for _ in range(n_golden):
        a = lhi - _GR * (lhi - llo)
        b = llo + _GR * (lhi - llo)
        g = _g_at(c, w, rho, torch.exp(torch.stack([a, b], dim=1)))
        smaller = g[:, 0] < g[:, 1]
        llo, lhi = torch.where(smaller, llo, a), torch.where(smaller, b, lhi)
    return llo, lhi


def _grid_bracket(c, w, rho, lams):
    """argmin over a per-lane lam grid (L, G) -> (log lo, log hi); every
    grid point in one evaluation, as the JAX package's vmap."""
    n = lams.shape[-1]
    i = torch.argmin(_g_at(c, w, rho, lams), dim=1, keepdim=True)
    lo = lams.gather(1, torch.clamp(i - 1, min=0))[:, 0]
    hi = lams.gather(1, torch.clamp(i + 1, max=n - 1))[:, 0]
    return torch.log(lo), torch.log(hi)


def _lanes(c, w, rho):
    c = torch.atleast_2d(c)
    w = torch.as_tensor(w, dtype=c.dtype, device=c.device).expand_as(c)
    rho = torch.as_tensor(rho, dtype=c.dtype, device=c.device)
    return c, w, rho.expand(c.shape[0])


def _bracket_solve(c, w, rho, n_grid: int, n_golden: int):
    span = torch.clamp(c.max(dim=-1).values - c.min(dim=-1).values,
                       min=1e-9)
    grid = torch.logspace(-6.0, 6.0, n_grid, dtype=c.dtype, device=c.device)
    llo, lhi = _grid_bracket(c, w, rho, _col(span) * grid)
    return _golden_refine(c, w, rho, llo, lhi, n_golden)


def robust_cost(c, w, rho, n_grid: int = 64, n_golden: int = 40
                ) -> torch.Tensor:
    """Worst-case expected cost max_{w' in U^rho_w} w'^T c via the dual, per
    lane: a geometric lam grid spanning the cost scale, then golden-section
    refinement (the cold solve used for final scoring).  ``rho <= 0`` gives
    the nominal expected cost.  Accepts a single (4,) cost vector too."""
    squeeze = torch.as_tensor(c).dim() == 1
    c, w, rho = _lanes(c, w, rho)
    with torch.no_grad():
        llo, lhi = _bracket_solve(c, w, rho, n_grid, n_golden)
    g = _g_of_lam(c, w, rho, torch.exp(0.5 * (llo + lhi)))
    out = torch.where(rho <= 0.0, (w * c).sum(dim=-1), g)
    return out[0] if squeeze else out


def dual_solve_cold(c, w, rho, n_grid: int = 24, n_golden: int = 20):
    """Full dual solve from scratch per lane; returns ``(value, log lam*)``.
    The grid only has to bracket the minimum; used once per start to seed
    the warm carry."""
    c, w, rho = _lanes(c, w, rho)
    with torch.no_grad():
        llo, lhi = _bracket_solve(c, w, rho, n_grid, n_golden)
        llam = 0.5 * (llo + lhi)
    val = torch.where(rho <= 0.0, (w * c).sum(dim=-1),
                      _g_of_lam(c, w, rho, torch.exp(llam)))
    return val, llam


def robust_phi_objective(phi: Phi, w, rho: float, sys: LSMSystem,
                         smooth: bool = False) -> torch.Tensor:
    return robust_cost(cost_vector(phi, sys, smooth=smooth), w, rho)


def tune_robust(w, rho: float, sys: LSMSystem,
                design: DesignSpace = DesignSpace.CLASSIC,
                n_starts: int = 64, steps: int = 250, lr: float = 0.25,
                seed: int = 0, device=None, starts=None) -> TuningResult:
    """ENDURE: ROBUST TUNING for one workload at radius ``rho`` (a 1x1 grid
    of :func:`repro_torch.core.batch.tune_robust_many`)."""
    from .batch import tune_robust_many  # batch imports this module
    if starts is not None:
        starts = torch.as_tensor(np.array(starts, np.float32))[None]
    return tune_robust_many([w], [rho], sys, design=design, n_starts=n_starts,
                            steps=steps, lr=lr, seed=seed, device=device,
                            starts=starts)[0][0]


def tune_robust_slsqp(w, rho: float, sys: LSMSystem,
                      design: DesignSpace = DesignSpace.CLASSIC,
                      n_starts: int = 8, seed: int = 0,
                      device=None) -> TuningResult:
    """Paper-faithful SLSQP solve of Eq. 17 over (theta, log lam, eta)
    jointly, from the JAX package's numpy starts.  CLASSIC is the better
    of the LEVELING and TIERING solves; if SLSQP fails on every start, the
    Adam tuner answers.  The integral tuning is scored with the cold-grid
    :func:`robust_cost`."""
    if design is DesignSpace.CLASSIC:
        cands = [tune_robust_slsqp(w, rho, sys, d, n_starts, seed, device)
                 for d in (DesignSpace.LEVELING, DesignSpace.TIERING)]
        return min(cands, key=lambda r: r.cost)

    dev = resolve_device(device)
    w32 = np.asarray(w, np.float32)
    w_dev = torch.as_tensor(w32, device=dev)
    n_phi = designs.n_params(design, sys)

    def obj(x):
        phi = designs.to_phi(x[:n_phi], design, sys, smooth=True)
        c = cost_vector(phi, sys, smooth=True)
        return dual_objective_explicit(c, w_dev, rho, torch.exp(x[n_phi]),
                                       x[n_phi + 1])

    rng = np.random.default_rng(seed)
    starts = [np.concatenate([rng.uniform(-3, 3, n_phi), [0.0], [1.0]])
              for _ in range(n_starts)]
    bounds = _theta_bounds(design, sys) + [(-10.0, 10.0), (None, None)]
    best_x = _slsqp_best(_value_and_grad(obj, dev), starts, bounds,
                         maxiter=300)
    if best_x is None:
        return tune_robust(w, rho, sys, design, seed=seed, device=device)

    raw_phi = designs.to_phi(torch.tensor(best_x[:n_phi],
                                          dtype=torch.float32), design, sys)
    phi = raw_phi.round_integral(sys)
    cost = float(robust_phi_objective(phi, torch.from_numpy(w32), rho, sys))
    return TuningResult(phi=phi, cost=cost, design=design, raw_phi=raw_phi,
                        solver="slsqp")


def primal_worst_case(phi: Phi, w, rho: float, sys: LSMSystem):
    """(worst-case workload, worst-case cost) for the primal problem."""
    c = cost_vector(phi, sys)
    w_hat = worst_case_workload(c, torch.as_tensor(w, dtype=c.dtype), rho)
    return w_hat, (w_hat * c).sum(dim=-1)
