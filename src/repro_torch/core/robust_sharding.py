"""Beyond-paper: the ENDURE robust-tuning paradigm applied to mesh/layout
selection under an uncertain workload mix — the port of
``repro/core/robust_sharding.py``.

The paper's final remark (Section 11) observes that the robust formulation
generalizes to "any database tuning problem [with] a known cost model".
This module instantiates that for the *framework itself*:

  * workload vector  w = (train, prefill, decode, long) step fractions
    (exactly the 4-dim simplex of the paper's (z0, z1, q, w));
  * configurations Phi = discrete layout candidates (mesh split, remat,
    attention impl, SP on/off), each with a measured cost vector c(Phi) =
    per-class step seconds from the dry-run roofline terms;
  * ROBUST TUNING = argmin_Phi max_{w' in KL-ball} w'.c(Phi), solved with
    the same zero-gap dual (:func:`repro_torch.core.robust_cost`) — here
    the "design space" is discrete, so the outer argmin is exact
    enumeration.

The (candidate x rho) grid of duals is one broadcast lane batch of
``robust_cost`` on ``device`` (the card unless ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..kernels._compat import resolve_device
from .robust import robust_cost
from .workload import worst_case_workload

STEP_CLASSES = ("train", "prefill", "decode", "long")


@dataclasses.dataclass
class LayoutCandidate:
    name: str
    step_costs: np.ndarray          # seconds per step class, shape (4,)
    meta: Optional[Dict] = None
    worst_case: float = float("nan")
    nominal_worst_case: float = float("nan")

    def expected_cost(self, mix: np.ndarray) -> float:
        return float(np.asarray(mix) @ self.step_costs)


def nominal_layout(candidates: Sequence[LayoutCandidate],
                   mix: np.ndarray) -> LayoutCandidate:
    """Problem 1 analogue: best layout for the expected mix."""
    return min(candidates, key=lambda c: c.expected_cost(mix))


def robust_layout(candidates: Sequence[LayoutCandidate], mix: np.ndarray,
                  rho: float, device=None) -> LayoutCandidate:
    """Problem 2 analogue: best worst-case layout over the KL ball.

    Discrete Phi -> exact enumeration; the inner max uses the same
    eta-eliminated dual as the LSM tuner (zero duality gap)."""
    return robust_layout_sweep(candidates, mix, [rho], device=device)[0]


def worst_case_grid(candidates: Sequence[LayoutCandidate], mix: np.ndarray,
                    rhos: Sequence[float], device=None) -> np.ndarray:
    """``(len(candidates), len(rhos))`` worst-case costs, float32, from one
    broadcast evaluation of ``robust_cost`` over the flat (candidate x rho)
    lane axis on ``device`` — a re-tuning storm of every serving cell
    re-evaluating its layout is one lane batch, as the LSM tuner's grid."""
    dev = resolve_device(device)
    C = torch.as_tensor(np.stack([c.step_costs for c in candidates]),
                        dtype=torch.float32, device=dev)
    R = torch.as_tensor(np.asarray(rhos, np.float32), device=dev)
    w = torch.as_tensor(np.asarray(mix, np.float32), device=dev)
    n, r = C.shape[0], R.shape[0]
    grid = robust_cost(C.repeat_interleave(r, dim=0), w, R.repeat(n))
    return grid.reshape(n, r).cpu().numpy()


def robust_layout_sweep(candidates: Sequence[LayoutCandidate],
                        mix: np.ndarray, rhos: Sequence[float],
                        device=None) -> List[LayoutCandidate]:
    """The robust pick for every rho, from one batched worst-case grid.

    Equivalent to ``[robust_layout(candidates, mix, rho) for rho in rhos]``;
    the returned candidates carry ``worst_case`` / ``nominal_worst_case``
    for the LAST rho they were scored under (matching the sequential
    API)."""
    grid = worst_case_grid(candidates, mix, rhos, device=device)
    nom = nominal_layout(candidates, mix)
    nom_idx = next(i for i, c in enumerate(candidates) if c is nom)
    picks = []
    for j in range(grid.shape[1]):
        best_i = int(np.argmin(grid[:, j]))
        for i, c in enumerate(candidates):
            c.worst_case = float(grid[i, j])
            c.nominal_worst_case = float(grid[nom_idx, j])
        picks.append(candidates[best_i])
    return picks


def adversarial_mix(candidate: LayoutCandidate, mix: np.ndarray,
                    rho: float, device=None) -> np.ndarray:
    """The traffic mix that realizes the worst case for a layout."""
    dev = resolve_device(device)
    return worst_case_workload(
        torch.as_tensor(np.asarray(candidate.step_costs, np.float32),
                        device=dev),
        torch.as_tensor(np.asarray(mix, np.float32), device=dev),
        rho).cpu().numpy()


def candidates_from_dryrun(arch: str, dryrun_dir: str,
                           tags: Sequence[str] = ("baseline",),
                           mesh: str = "single") -> List[LayoutCandidate]:
    """Build layout candidates for one arch from dry-run records: one
    candidate per tag, cost vector = step_time_s of the four shapes."""
    d = pathlib.Path(dryrun_dir)
    shape_for = {"train": "train_4k", "prefill": "prefill_32k",
                 "decode": "decode_32k", "long": "long_500k"}
    out = []
    for tag in tags:
        costs = []
        ok = True
        for cls in STEP_CLASSES:
            f = d / f"{arch}__{shape_for[cls]}__{mesh}__{tag}.json"
            if not f.exists():
                ok = False
                break
            r = json.loads(f.read_text())
            if r["status"] == "skipped":
                costs.append(1e3)   # inapplicable class: huge penalty
            elif r["status"] != "ok":
                ok = False
                break
            else:
                costs.append(r["roofline"]["step_time_s"])
        if ok:
            out.append(LayoutCandidate(name=f"{arch}:{tag}:{mesh}",
                                       step_costs=np.asarray(costs)))
    return out
