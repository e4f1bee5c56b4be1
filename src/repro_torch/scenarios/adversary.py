"""The adversary arm: the robust objective's inner max as a live opponent
(the port of ``repro/scenarios/adversary.py``).

ENDURE's guarantee is a dual bound: for a tuning ``phi`` with cost vector
``c = c(phi)``, every workload ``w'`` inside the KL ball
``U^rho_w = {w' : I_KL(w', w) <= rho}`` satisfies

    w'^T c  <=  max_{w'' in U^rho_w} w''^T c  =  min_lam [dual]  (Eq. 13)

so a robust tuning's *measured regret* — realized cost over the nominal
cost ``w^T c`` — can never exceed the dual bound's margin while the
executed workload stays inside the ball.  This scenario turns the
quantifier into an opponent: each drift window it reads the defender's
live state (deployed ``phi``, current KL center ``w``, live budget
``rho``), solves the inner max *exactly*
(:func:`repro_torch.core.worst_case_workload`: exponential tilt +
bisection on ``I_KL = rho``), and executes that worst case against every
arm.  Each window emits a regret record — chosen mix, its KL from the
center, the nominal / realized model costs, and the independently-solved
dual bound (:func:`repro_torch.core.robust_cost`) — and the gated claim
``claim_regret_le_dual_bound`` asserts realized <= bound on every window.

The solves run in float32 on the caller's device, as the JAX package's run
in its default precision; the nominal and realized costs are the float32
cost vector widened to float64, as there.

The defender is the adapting arm when present (``online``), else the
robust one, else whatever deployed — so the ball tracks re-centering: an
online defender that re-tunes moves both ``w`` and ``rho``, and the
adversary re-aims inside the *new* ball.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .base import Scenario

#: defender preference: the adversary attacks the adapting arm when it is
#: deployed, else the static robust arm, else whatever is present.
DEFENDER_ORDER = ("online", "static_robust", "stale_nominal", "oracle")


class AdversaryScenario(Scenario):
    """Per-window worst-case workload inside the defender's rho-ball.

    ``rho`` is the fallback ball radius when the defender carries none (a
    nominal deployment has ``rho_live = 0``; its "ball" is a point, which
    makes the claim vacuous); ``iters`` is the bisection depth of the
    inner-max solve.  The static schedule is a placeholder (the expected
    mix tiled) — ``execute_drift`` replaces every segment's mix with
    :meth:`attack`'s choice at run time."""

    kind = "adversary"
    PARAMS = {"rho": 0.25, "iters": 80}

    def __init__(self, drift):
        super().__init__(drift)
        if float(self.params["rho"]) <= 0.0:
            raise ValueError("adversary fallback rho must be > 0")

    @property
    def is_adversary(self) -> bool:
        return True

    def attack(self, phi, w_center, rho_live: float, sys,
               device=None) -> Tuple[np.ndarray, dict]:
        """Solve the inner max against one deployed tuning on ``device``
        (``None``: the card).

        Returns ``(w_adv, record)``: the worst-case mix inside the ball
        ``U^rho_{w_center}`` for the tuning's cost vector, plus the regret
        record (model costs, KL dual bound, per-window verdict).  Torch is
        imported here, so specs load without it."""
        import torch

        from ..core import (Phi, cost_vector, kl_divergence, robust_cost,
                            worst_case_workload)
        from ..kernels._compat import resolve_device
        dev = resolve_device(device)
        w0 = np.asarray(w_center, np.float64)
        w0 = w0 / w0.sum()
        rho = float(rho_live) if rho_live > 0.0 else float(self.params["rho"])
        phi = Phi(T=phi.T.to(dev), mfilt_bits=phi.mfilt_bits.to(dev),
                  K=phi.K.to(dev))
        c32 = cost_vector(phi, sys)
        w32 = torch.as_tensor(w0, dtype=torch.float32, device=dev)
        c = c32.double().cpu().numpy()
        w_adv = worst_case_workload(c32, w32, rho,
                                    iters=int(self.params["iters"]))
        w_adv = np.asarray(w_adv.cpu().numpy(), np.float64)
        w_adv = np.maximum(w_adv, 0.0)
        w_adv = w_adv / w_adv.sum()
        nominal = float(c @ w0)
        realized = float(c @ w_adv)
        bound = float(robust_cost(c32, w32, rho))
        kl = kl_divergence(torch.as_tensor(w_adv, dtype=torch.float32,
                                           device=dev), w32)
        record = {
            "rho": rho,
            "w_center": [round(float(x), 6) for x in w0],
            "w_adv": [round(float(x), 6) for x in w_adv],
            "kl_adv": float(kl),
            "cost_nominal": nominal,
            "cost_adv": realized,
            "dual_bound": bound,
            "regret": realized - nominal,
            # realized <= bound up to solver tolerance: the dual bound is
            # computed by an independent solver (1-D dual minimization vs
            # the primal tilt), so this is a real cross-check, not x <= x
            "le_dual_bound": bool(realized <= bound * (1.0 + 1e-6) + 1e-9),
        }
        return w_adv, record


def record_mismatches(got: dict, want: dict, rtol: float = 1e-5) -> list:
    """The keys on which regret record ``got`` parts from ``want`` when both
    come from one defender state: the labels, the center and the verdict
    must be equal, the attacked mix (printed to six decimals) within one
    unit of its last digit, and every other number within ``rtol`` of
    ``want``'s.  Empty when the two records agree."""
    if set(got) != set(want):
        return sorted(set(got) ^ set(want))
    bad = []
    for key, value in want.items():
        if isinstance(value, (bool, str)) \
                or key in ("segment", "widx", "w_center"):
            ok = got[key] == value
        elif key == "w_adv":
            ok = len(got[key]) == len(value) and all(
                abs(a - b) <= 1e-6 + 1e-12 for a, b in zip(got[key], value))
        else:
            ok = abs(got[key] - value) <= rtol * abs(value)
        if not ok:
            bad.append(key)
    return bad
