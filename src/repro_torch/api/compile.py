"""Lower an :class:`~repro_torch.api.spec.ExperimentSpec` onto the batched
tuners and the fleet executor: the port of ``repro/api/compile.py``.

``compile_spec`` turns the declarative spec into

* one :class:`TuningPlan` per distinct *tuning design* — the whole
  (workload x rho x multi-start) grid of a plan is one
  ``tune_nominal_many`` / ``tune_robust_many`` lane batch (policy arms that
  reshape the steady-state K profile, e.g. ``lazy_leveling``, tune under
  their matching continuous design; profile-preserving arms share the
  spec's primary design, so the common single-arm case stays ONE grid and
  is bit-identical to calling the batched tuners directly);
* a joint *policy-arm selection*: every arm's effective configuration
  (:func:`repro_torch.core.policy_effective_phi`) is scored under the
  cell's exact objective (expected cost for nominal cells, the KL-dual
  worst case for robust cells) and the argmin arm is recorded per cell;
* one :class:`TrialPlan` — the flat (tree x session) fleet grid in exactly
  :func:`repro_torch.lsm.run_policy_fleet`'s conventions (shared key draws,
  shared session plans), executed by the spec's backend.

A plan carries plain numbers (workload matrix, design, ``n_starts``,
``seed``), so the caller's starts provider can answer for it.  The drift
and memory plans are lowered by the JAX package's ``online`` loop, which the
port does not have yet: :meth:`CompiledExperiment.build_drift` and
:meth:`CompiledExperiment.build_memory` refuse (ROADMAP.md queue 3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .report import Cell, Report
from .spec import ExperimentSpec, Pairs

#: policy arm -> the continuous design space whose K profile matches the
#: arm's steady state; arms not listed preserve the tuning's own profile and
#: share the spec's primary design grid.
ARM_DESIGNS = {"lazy_leveling": "lazy_leveling"}

#: ``DesignSpec.policy_params`` entries consumed by the cost model
#: (``policy_effective_phi``) only — stripped before the engine planner
#: constructor sees them.
MODEL_ONLY_PARAMS = frozenset({"fill"})

_ONLINE = ("the online drift loop and memory arbitration are not ported "
           "yet (ROADMAP.md queue 3: retuning and online)")


@dataclasses.dataclass
class TuningPlan:
    """One batched-tuner dispatch: the full (workload x rho) grid for one
    design, solved robust (``rhos``) and/or nominal (``nominal``)."""

    W: np.ndarray                    # (n_w, 4) workload matrix
    rhos: Tuple[float, ...]
    nominal: bool
    design: object                   # repro_torch.core.DesignSpace
    n_starts: int
    steps: int
    lr: float
    seed: int
    sys: object                      # repro_torch.core.LSMSystem


@dataclasses.dataclass
class TreeBuild:
    """One engine deployment: a (cell, policy) tree, as plain data."""

    cell: Cell
    policy: str
    policy_params: Pairs
    T: float
    mfilt_bits: float
    K: Tuple[float, ...]
    key_group: int                   # trees sharing a group share a key draw
    key_seed: int
    session_seeds: Tuple[int, ...]


@dataclasses.dataclass
class DriftArmInit:
    """One drift-experiment deployment: its workload, arm kind, and the
    tuning it starts from (``None`` for oracle — pre-tuned per segment)."""

    widx: int
    arm: str
    tuning: object                   # TuningResult; None for oracle
    rho: float                       # live budget of the initial tuning
    policy: str
    policy_params: Pairs


@dataclasses.dataclass
class DriftPlan:
    """A compiled drift experiment (:class:`repro_torch.api.spec.DriftSpec`):
    per-workload expected mixes + true-mix schedules, one arm list, and the
    live system for re-tune storms."""

    arms: List[DriftArmInit]
    expected: np.ndarray             # (n_w, 4)
    schedules: np.ndarray            # (n_w, S, 4)
    drift: object                    # the DriftSpec
    sys: object                      # repro_torch.core.LSMSystem
    design: object = None            # DesignSpace re-tunes solve in
    scenario: object = None          # scenario generator; None (classic)


@dataclasses.dataclass
class MemoryPlan:
    """A compiled memory-arbitration experiment
    (:class:`repro_torch.api.spec.MemorySpec` over a drift schedule): one
    tenant per workload row, each starting from its robust cell's chosen
    policy arm, plus the budget spec and the equal-split base system."""

    tunings: List[object]            # per-tenant initial TuningResult
    policies: List[str]              # per-tenant chosen policy arm
    policy_params: List[Pairs]
    rho0: float                      # live budget of the initial tunings
    expected: np.ndarray             # (F, 4)
    schedules: np.ndarray            # (F, S, 4)
    drift: object                    # the DriftSpec (schedule + loop knobs)
    memory: object                   # the MemorySpec (budget semantics)
    sys: object                      # equal-split base LSMSystem
    design: object = None            # DesignSpace re-tunes solve in
    scenario: object = None          # scenario generator; None (classic)


def drift_schedule(expected: np.ndarray, drift) -> np.ndarray:
    """Materialize a classic drift spec's per-segment true mixes, (S, 4).
    (Scenario kinds never get here: the spec refuses them.)"""
    S = int(drift.segments)
    w0 = np.asarray(expected, np.float64)
    w0 = w0 / w0.sum()
    if drift.kind == "schedule":
        sched = np.asarray(drift.schedule, np.float64)
        return sched / sched.sum(axis=1, keepdims=True)
    w1 = np.asarray(drift.target, np.float64)
    w1 = w1 / w1.sum()
    if drift.kind == "gradual":
        t = np.arange(S, dtype=np.float64) / max(S - 1, 1)
    elif drift.kind == "flip":
        t = (np.arange(S) >= S / 2).astype(np.float64)
    else:                                        # cyclic
        t = (np.arange(S) % 2).astype(np.float64)
    sched = (1.0 - t)[:, None] * w0 + t[:, None] * w1
    return sched / sched.sum(axis=1, keepdims=True)


@dataclasses.dataclass
class TrialPlan:
    """The flat fleet grid plus everything needed to run it."""

    trees: List[TreeBuild]
    sessions: Tuple[Tuple[float, ...], ...]
    n_keys: int
    n_queries: int
    key_space: int
    range_fraction: float
    entry_bytes: int
    delete_fraction: float
    f_a: float
    f_seq: float
    zipf_a: Optional[float]
    bits_per_entry: float            # sys fields from_phi reads
    sys_N: float
    probe_dead_keys: int = 200       # dead keys per tree checked for resurface


def _arm_scorer(sys, policy: str, params: Pairs):
    """phi -> (effective cost vector, exact objective at rho), on the
    tuning's device (the tuners hand back CPU tensors).  ``rho`` 0.0
    degenerates to the nominal expected cost inside ``robust_cost``."""
    from ..core import cost_vector, policy_effective_phi, robust_cost

    def score(phi, w, rho):
        eff = policy_effective_phi(phi, sys, policy, params)
        c = cost_vector(eff, sys)
        return c, robust_cost(c, torch.as_tensor(w, dtype=c.dtype,
                                                 device=c.device), rho)

    return score


class CompiledExperiment:
    """The lowered experiment: resolved system, workload matrix, tuning
    plans keyed by (design, n_starts), and the trial builder."""

    def __init__(self, spec: ExperimentSpec):
        from ..core import (DesignSpace, EXPECTED_WORKLOADS, LSMSystem,
                            rho_from_history, sample_benchmark)
        self.spec = spec
        self.sys = LSMSystem().replace(**dict(spec.system)) if spec.system \
            else LSMSystem()
        wl = spec.workload
        if wl.indices is not None:
            self.W = np.asarray(EXPECTED_WORKLOADS[list(wl.indices)],
                                np.float64)
            self.widx = list(wl.indices)
        else:
            W = np.asarray(wl.workloads, np.float64)
            self.W = W / W.sum(axis=1, keepdims=True)
            self.widx = list(range(len(self.W)))
        # resolved rho cells: the declared radii, plus — for the
        # "from_history" rho source — one radius measured from the observed
        # history (Algorithm 1 over its normalized rows)
        self.rhos: Tuple[float, ...] = tuple(wl.rhos)
        if wl.rho_source == "from_history":
            H = np.asarray(wl.history, np.float64)
            H = H / np.maximum(H.sum(axis=1, keepdims=True), 1e-30)
            self.rhos += (float(rho_from_history(H)),)
        self.cells: List[Cell] = []
        if wl.nominal:
            self.cells += [(i, None) for i in range(len(self.W))]
        self.cells += [(i, rho) for i in range(len(self.W))
                       for rho in self.rhos]
        self.bench = sample_benchmark(wl.bench_n, seed=wl.bench_seed) \
            if wl.bench_n else None

        # -- arm -> tuning design grouping --------------------------------
        # plans are keyed (DesignSpace, n_starts): the design-space axis
        # may tune the same space at a different multi-start budget
        self.primary_design = DesignSpace(spec.design.space)
        self.arm_design: Dict[str, object] = {}
        for pol in spec.design.policies:
            space = ARM_DESIGNS.get(pol)
            self.arm_design[pol] = DesignSpace(space) if space is not None \
                else self.primary_design
        self.space_arms: List[Tuple[str, Tuple[object, int]]] = [
            (name, (DesignSpace(name), n_starts))
            for name, n_starts in spec.design.space_arms()]

    # -- tuning -----------------------------------------------------------

    def tuning_plans(self) -> Dict[Tuple[object, int], TuningPlan]:
        """One plan per distinct (design, n_starts) among the policy arms
        and the design-space axis (usually one)."""
        if self.spec.design.fixed is not None:
            return {}
        d = self.spec.design
        keys: List[Tuple[object, int]] = []
        for pol in d.policies:
            key = (self.arm_design[pol], d.n_starts)
            if key not in keys:
                keys.append(key)
        for _, key in self.space_arms:
            if key not in keys:
                keys.append(key)
        return {key: TuningPlan(W=self.W, rhos=self.rhos,
                                nominal=self.spec.workload.nominal,
                                design=key[0], n_starts=key[1],
                                steps=d.steps, lr=d.lr, seed=d.seed,
                                sys=self.sys)
                for key in keys}

    def _fixed_phi(self):
        from ..core import make_phi
        from ..core.nominal import TuningResult
        T, filt_bpe, K = self.spec.design.fixed
        phi = make_phi(float(T), float(filt_bpe) * self.sys.N, float(K),
                       self.sys)
        return TuningResult(phi=phi, cost=float("nan"),
                            design=self.primary_design, solver="fixed")

    def select_arms(self, solved: Dict[object, Dict[Cell, object]]) -> Report:
        """Joint policy-arm selection + the model-side report skeleton.

        ``solved`` maps (design, n_starts) -> cell -> TuningResult (the
        backends' output).  Each arm is scored by the exact objective of
        its *effective* phi — expected cost for nominal cells, the
        cold-grid KL-dual worst case at the cell's rho for robust cells;
        ties break to the first arm in spec order (the primary arm), so
        single-arm specs carry the TuningResult through untouched."""
        spec = self.spec
        fixed = self._fixed_phi() if spec.design.fixed is not None else None
        scorers = {pol: _arm_scorer(self.sys, pol,
                                    spec.design.params_for(pol))
                   for pol in spec.design.policies}
        tunings: Dict[Cell, Dict[str, object]] = {}
        arm_costs: Dict[Cell, Dict[str, float]] = {}
        chosen: Dict[Cell, str] = {}
        model_costs: Dict[Cell, Dict[str, np.ndarray]] = {}
        bench_costs: Dict[Cell, np.ndarray] = {}
        for cell in self.cells:
            i, rho = cell
            w = np.asarray(self.W[i], np.float32)
            arms: Dict[str, object] = {}
            costs: Dict[str, float] = {}
            models: Dict[str, np.ndarray] = {}
            for pol in spec.design.policies:
                r = fixed if fixed is not None \
                    else solved[(self.arm_design[pol],
                                 spec.design.n_starts)][cell]
                c, cost = scorers[pol](r.phi, w, rho or 0.0)
                arms[pol] = r
                costs[pol] = float(cost)
                models[pol] = c.detach().cpu().numpy().astype(np.float64)
            best = min(costs, key=lambda p: (costs[p],
                                             spec.design.policies.index(p)))
            tunings[cell] = arms
            arm_costs[cell] = costs
            chosen[cell] = best
            model_costs[cell] = models
            if self.bench is not None:
                bench_costs[cell] = np.asarray(self.bench, np.float64) \
                    @ models[best]
        # -- the design-space axis: per-arm tunings + benchmark costs ------
        # (scored through the primary policy's effective-phi scorer, so a
        # space arm equals a separate spec with that primary space exactly)
        design_tunings: Dict[str, Dict[Cell, object]] = {}
        design_bench_costs: Dict[str, Dict[Cell, np.ndarray]] = {}
        primary_scorer = scorers[spec.design.policies[0]]
        for name, key in self.space_arms:
            per_cell = dict(solved[key])
            design_tunings[name] = per_cell
            if self.bench is not None:
                B = np.asarray(self.bench, np.float64)
                costs_d: Dict[Cell, np.ndarray] = {}
                for cell in self.cells:
                    i, rho = cell
                    c, _ = primary_scorer(per_cell[cell].phi,
                                          np.asarray(self.W[i], np.float32),
                                          rho or 0.0)
                    costs_d[cell] = B @ c.detach().cpu().numpy().astype(
                        np.float64)
                design_bench_costs[name] = costs_d
        return Report(spec=spec, sys=self.sys, cells=list(self.cells),
                      tunings=tunings, arm_costs=arm_costs, chosen=chosen,
                      model_costs=model_costs, bench_costs=bench_costs,
                      bench_set=self.bench, design_tunings=design_tunings,
                      design_bench_costs=design_bench_costs)

    # -- trial -------------------------------------------------------------

    def build_trial(self, report: Report) -> Optional[TrialPlan]:
        """The flat (cell x policy) tree grid in run_policy_fleet order."""
        tr = self.spec.trial
        if tr is None:
            return None
        S = len(tr.sessions)
        if tr.session_seeds is not None:
            base_seeds = tuple(int(s) for s in tr.session_seeds)
        else:
            base_seeds = tuple(range(S))
        trees: List[TreeBuild] = []
        for cell in self.cells:
            i, _ = cell
            if tr.per_workload_keys:
                # Table-5 convention: the nominal/robust pair of a workload
                # shares one key draw and one session-seed row, so run_fleet
                # materializes each drifted session once per workload.
                group, kseed = i, tr.key_seed + self.widx[i]
                seeds = tuple(kseed + s for s in range(S))
            else:
                group, kseed = 0, tr.key_seed
                seeds = base_seeds
            for pol in self.spec.design.policies:
                r = report.tunings[cell][pol]
                engine_params = tuple(
                    (k, v) for k, v in self.spec.design.params_for(pol)
                    if k not in MODEL_ONLY_PARAMS)
                trees.append(TreeBuild(
                    cell=cell, policy=pol,
                    policy_params=engine_params,
                    T=float(r.phi.T), mfilt_bits=float(r.phi.mfilt_bits),
                    K=tuple(float(k) for k in r.phi.K.tolist()),
                    key_group=group, key_seed=kseed, session_seeds=seeds))
        return TrialPlan(trees=trees, sessions=tr.sessions,
                         n_keys=tr.n_keys, n_queries=tr.n_queries,
                         key_space=tr.key_space,
                         range_fraction=tr.range_fraction,
                         entry_bytes=tr.entry_bytes,
                         delete_fraction=tr.delete_fraction,
                         f_a=tr.f_a, f_seq=tr.f_seq, zipf_a=tr.zipf_a,
                         bits_per_entry=self.sys.bits_per_entry,
                         sys_N=self.sys.N)

    # -- drift / memory ------------------------------------------------------

    def build_drift(self, report: Report) -> Optional[DriftPlan]:
        """None without a drift spec; the drift loop is not ported yet."""
        if self.spec.drift is None:
            return None
        raise NotImplementedError(_ONLINE)

    def build_memory(self, report: Report) -> Optional[MemoryPlan]:
        """None without a memory spec; memory arbitration is not ported
        yet."""
        if self.spec.memory is None:
            return None
        raise NotImplementedError(_ONLINE)


def compile_spec(spec: ExperimentSpec) -> CompiledExperiment:
    return CompiledExperiment(spec)
