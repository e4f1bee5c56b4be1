"""Batched tuning engine: (workload x rho x design) sweeps as one lane batch.

The port of ``repro/core/batch.py``.  The full

    (workload x rho) x multi-start [x CLASSIC branch]

grid is flattened into one lane axis: ``theta`` is one ``(L, p)`` tensor,
every Adam step scores all L lanes with one batched ``cost_vector`` and,
in robust mode, one launch of the warm dual-solve kernel, and one backward
pass gives each lane its own gradient.

CLASSIC (= best of {LEVELING, TIERING}) is *folded* into the lane axis:
both designs share the 2-parameter theta layout, so each problem runs
``2 * n_starts`` lanes, the second half with ``policy = 1.0`` (tiering)
through :func:`designs.to_phi_policy`.  The winner is the first minimum of
the exact re-scored costs, so leveling wins ties, as the JAX package's
recursive solver and its fold do.

Robust mode seeds each lane's log lambda with one cold dual solve at
theta_0 and carries it through the Adam steps, refining it with
:func:`robust.dual_solve_warm`.  The winning start is re-scored with the
full cold-grid :func:`robust.robust_cost` on the integral tuning, so
reported costs do not depend on the warm start.

Starts: drawn from a ``torch.Generator`` seeded with ``seed``, unless the
caller passes ``starts`` (``(P or 1, n_starts, n_params)``), e.g. the JAX
package's ``designs.random_inits_many`` for a parity run.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..kernels._compat import resolve_device
from . import designs
from .designs import DesignSpace
from .lsm_cost import LSMSystem, Phi, cost_vector
from ._opt import minimize_adam, minimize_adam_carry
from .nominal import TuningResult
from .robust import dual_solve_cold, dual_solve_warm, robust_cost


def _phi_of(theta, policy, design: DesignSpace, sys: LSMSystem,
            smooth: bool) -> Phi:
    """theta -> Phi; CLASSIC routes through the policy lane axis."""
    if design is DesignSpace.CLASSIC:
        return designs.to_phi_policy(theta, policy, sys, smooth=smooth)
    return designs.to_phi(theta, design, sys, smooth=smooth)


def solve_grid(W, rhos, design: DesignSpace, sys: LSMSystem, n_starts: int,
               steps: int, lr: float, robust: bool, seed: int = 0,
               device=None, starts=None, dual_warm=None):
    """The sweep over a flat grid: W (P, 4) workloads, rhos (P,) radii.

    Returns per-problem CPU tensors: exact cost of the winning start, its
    CLASSIC policy, and the raw + integral-rounded Phi components; pair
    with :func:`build_results`.  ``dual_warm`` replaces the kernel-backed
    warm solve (``chip_smoke.py`` passes the plain version to compare the
    two on the card)."""
    dev = resolve_device(device)
    W = torch.as_tensor(np.asarray(W, np.float32)).to(dev)
    rhos = torch.as_tensor(np.asarray(rhos, np.float32)).reshape(-1).to(dev)
    P = W.shape[0]
    if starts is None:
        gen = torch.Generator().manual_seed(int(seed))
        base = designs.random_inits_many(gen, P, n_starts, design, sys)
    else:
        base = torch.as_tensor(np.array(starts, np.float32))
        base = base.expand((P,) + base.shape[1:])
    if base.shape[1] != n_starts:
        raise ValueError(f"starts hold {base.shape[1]} starts, "
                         f"n_starts={n_starts}")
    if design is DesignSpace.CLASSIC:
        base = torch.cat([base, base], dim=1)     # leveling | tiering lanes
        policies = torch.cat([torch.zeros(n_starts), torch.ones(n_starts)])
    else:
        policies = torch.zeros(n_starts)
    S = base.shape[1]
    theta0 = base.reshape(P * S, -1).to(dev)
    pol = policies.repeat(P).to(dev)
    W_l = W.repeat_interleave(S, dim=0)
    rho_l = rhos.repeat_interleave(S)

    if robust:
        warm = dual_solve_warm if dual_warm is None else dual_warm

        def obj(theta, llam):
            c = cost_vector(_phi_of(theta, pol, design, sys, True), sys,
                            smooth=True)
            return warm(c, W_l, rho_l, llam)

        with torch.no_grad():
            c0 = cost_vector(_phi_of(theta0, pol, design, sys, True), sys,
                             smooth=True)
            _, llam0 = dual_solve_cold(c0, W_l, rho_l)
        best_t, _, _ = minimize_adam_carry(obj, theta0, llam0, steps=steps,
                                           lr=lr)
    else:
        def obj(theta):
            c = cost_vector(_phi_of(theta, pol, design, sys, True), sys,
                            smooth=True)
            return (W_l * c).sum(dim=-1)

        best_t, _ = minimize_adam(obj, theta0, steps=steps, lr=lr)

    # Exact re-evaluation (ceil/round, cold-grid dual) before picking a
    # winner: the smooth warm-started objective is only a surrogate.
    with torch.no_grad():
        raw = _phi_of(best_t, pol, design, sys, False)
        phi = raw.round_integral(sys)
        c = cost_vector(phi, sys, smooth=False)
        exact = robust_cost(c, W_l, rho_l) if robust \
            else (W_l * c).sum(dim=-1)
        exact = exact.reshape(P, S)
        i = torch.argmin(torch.where(torch.isfinite(exact), exact,
                                     torch.full_like(exact, torch.inf)),
                         dim=1)
        win = torch.arange(P, device=dev) * S + i
        out = (exact[torch.arange(P, device=dev), i], pol[win], raw.T[win],
               raw.mfilt_bits[win], raw.K[win], phi.T[win], phi.K[win])
    return tuple(t.cpu() for t in out)


def build_results(out, design: DesignSpace,
                  sys: LSMSystem) -> List[TuningResult]:
    """:func:`solve_grid` outputs -> one TuningResult per problem."""
    cost, pol, T_raw, mfilt, K_raw, T_int, K_int = out
    results = []
    for p in range(cost.shape[0]):
        if design is DesignSpace.CLASSIC:
            d = DesignSpace.TIERING if pol[p] > 0.5 else DesignSpace.LEVELING
        else:
            d = design
        raw_phi = Phi(T=T_raw[p], mfilt_bits=mfilt[p], K=K_raw[p])
        phi = Phi(T=T_int[p], mfilt_bits=mfilt[p], K=K_int[p])
        results.append(TuningResult(phi=phi, cost=float(cost[p]), design=d,
                                    raw_phi=raw_phi))
    return results


def _as_workload_matrix(workloads) -> np.ndarray:
    W = np.atleast_2d(np.asarray(workloads, np.float32))
    if W.ndim != 2 or W.shape[1] != 4:
        raise ValueError(f"workloads must be (P, 4), got {W.shape}")
    return W


def tune_nominal_many(workloads, sys: LSMSystem,
                      design: DesignSpace = DesignSpace.CLASSIC,
                      n_starts: int = 64, steps: int = 250, lr: float = 0.25,
                      seed: int = 0, device=None,
                      starts: Optional[torch.Tensor] = None
                      ) -> List[TuningResult]:
    """NOMINAL TUNING for every workload as one lane batch (on the card
    unless ``device="cpu"``)."""
    W = _as_workload_matrix(workloads)
    out = solve_grid(W, np.zeros(W.shape[0], np.float32), design, sys,
                     n_starts, steps, lr, robust=False, seed=seed,
                     device=device, starts=starts)
    return build_results(out, design, sys)


def tune_robust_many(workloads, rhos: Sequence[float], sys: LSMSystem,
                     design: DesignSpace = DesignSpace.CLASSIC,
                     n_starts: int = 64, steps: int = 250, lr: float = 0.25,
                     seed: int = 0, device=None,
                     starts: Optional[torch.Tensor] = None
                     ) -> List[List[TuningResult]]:
    """ROBUST TUNING over the (workloads x rhos) grid as one lane batch;
    returns a nested list indexed ``[workload][rho]``."""
    W = _as_workload_matrix(workloads)
    R = np.asarray(rhos, np.float32).reshape(-1)
    n_w, n_r = W.shape[0], R.shape[0]
    out = solve_grid(np.repeat(W, n_r, axis=0), np.tile(R, n_w), design, sys,
                     n_starts, steps, lr, robust=True, seed=seed,
                     device=device, starts=starts)
    flat = build_results(out, design, sys)
    return [flat[i * n_r:(i + 1) * n_r] for i in range(n_w)]
