"""The scenario generator contract (the port of ``repro/scenarios/base.py``).

A scenario owns three decisions of a drift experiment, each a pure
function of (spec, segment index) so replays are deterministic and
backends stay bit-identical:

* :meth:`Scenario.schedule` — the (S, 4) true-mix trajectory (what the
  classic kinds compute in ``repro_torch.api.compile.drift_schedule``);
* :meth:`Scenario.segment_queries` — the arrival volume of a segment
  (burst scenarios scale it; everything else returns the spec's
  ``n_queries``);
* :meth:`Scenario.session_kwargs` — extra
  :func:`repro_torch.lsm.materialize_session` shaping (Zipf exponent + hot-set
  offset, delete fraction, range-scan span).

The adversary overrides none of these usefully — its mix is chosen *live*
per window against the deployed tuning (``is_adversary`` routes
``repro_torch.online.execute_drift`` to :meth:`AdversaryScenario.attack`), so
its static schedule is a placeholder tile of the expected mix.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def _norm(w) -> np.ndarray:
    w = np.asarray(w, np.float64)
    return w / w.sum()


class Scenario:
    """Base generator: constant-at-expected schedule, unshaped sessions."""

    kind: str = ""
    #: knob name -> default; ``DriftSpec.scenario_params`` overrides these
    #: (unknown names are rejected at spec construction).
    PARAMS: Dict[str, Any] = {}

    def __init__(self, drift):
        self.drift = drift
        given = dict(drift.scenario_params)
        unknown = sorted(set(given) - set(self.PARAMS))
        if unknown:
            raise ValueError(f"unknown {self.kind!r} scenario params "
                             f"{unknown}; known: {sorted(self.PARAMS)}")
        self.params = {**self.PARAMS, **given}

    @property
    def is_adversary(self) -> bool:
        return False

    def target_mix(self, default) -> np.ndarray:
        """The spec's ``target`` when declared, else the scenario default."""
        t = self.drift.target
        return _norm(default if t is None else t)

    def ramp(self, expected, target, t: np.ndarray) -> np.ndarray:
        """Interpolated (S, 4) schedule along blend coefficients ``t``."""
        w0, w1 = _norm(expected), _norm(target)
        sched = (1.0 - t)[:, None] * w0 + t[:, None] * w1
        return sched / sched.sum(axis=1, keepdims=True)

    # -- the three hooks ----------------------------------------------------

    def schedule(self, expected) -> np.ndarray:
        """Per-segment true mixes, (S, 4); default holds the expected mix."""
        return np.tile(_norm(expected), (int(self.drift.segments), 1))

    def segment_queries(self, segment: int) -> int:
        """Arrival volume of one segment (default: the spec's)."""
        return int(self.drift.n_queries)

    def session_kwargs(self, segment: int, n_existing: int) -> Dict[str, Any]:
        """Extra ``materialize_session`` kwargs for one segment."""
        return {}
