"""NOMINAL TUNING (paper Problem 1): Phi_N = argmin_Phi C(w, Phi).

The port of ``repro/core/nominal.py`` (the SLSQP solver is not ported
yet): :func:`tune_nominal` is the batched multi-start Adam tuner of
``batch.py`` on a one-workload grid.  Results are integral tunings
(ceil/round per Section 5.2) re-scored with the exact cost model.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import designs
from .designs import DesignSpace
from .lsm_cost import LSMSystem, Phi


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
