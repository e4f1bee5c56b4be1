"""Declarative experiment specs: the paper's pipeline as one frozen value.

The port of ``repro/api/spec.py``: the same frozen dataclasses, the same
validation and the same JSON text.  An :class:`ExperimentSpec` states an
*uncertain workload* (expected mixes + KL radii), a *design space*
(continuous Theta plus the engine compaction policy as a discrete arm), and
optionally a *system trial* that deploys the tunings on the executable LSM
engine and measures I/O per query; :mod:`repro_torch.api.compile` lowers it
onto the batched tuners and the fleet executor.

Every spec is built from JSON-native scalars and tuples, so the whole
experiment round-trips through JSON (``to_json`` /
``ExperimentSpec.from_json``), and a spec the JAX package wrote loads here
unchanged.  The execution *backend* (``inline`` | ``sharded``, see
:mod:`repro_torch.api.backends`) and the failure process (``faults``, a
tuple of :class:`repro_torch.faults.FaultSpec`) are axes of the spec too.

Every drift kind validates here (the classic ones and the scenario
kinds of :mod:`repro_torch.scenarios`), and so does :class:`MemorySpec`;
``run_experiment`` runs them all.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

from ..faults import FaultSpec
from ..scenarios import SCENARIO_KINDS, get_scenario

Pairs = Tuple[Tuple[str, Any], ...]


def _tupled(x):
    """Recursively convert lists (JSON arrays) back to tuples."""
    if isinstance(x, list):
        return tuple(_tupled(v) for v in x)
    return x


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """The uncertain workload: expected mixes plus KL uncertainty radii.

    ``indices`` selects rows of the paper's Table-4
    :data:`repro_torch.core.EXPECTED_WORKLOADS`; ``workloads`` gives explicit
    (z0, z1, q, w) mixes instead (exactly one of the two must be set).
    ``rhos`` are the KL radii of ROBUST TUNING cells (one robust tuning per
    workload x rho).  ``nominal`` adds the rho-free NOMINAL TUNING baseline
    per workload.  ``bench_n`` > 0 requests model evaluation of every
    tuning over a sampled benchmark set B (``sample_benchmark(bench_n,
    bench_seed)``), the Section 8 metric source.

    ``rho_source`` declares where the robustness budget comes from:

    * ``"fixed"`` (default) — exactly the declared ``rhos``; compilation is
      bit-identical to a spec without the field.
    * ``"from_history"`` — ``history`` carries observed workload mixes (or
      op-count rows, e.g. ``SessionResult.window_ops`` windows) and the
      compiler APPENDS one rho cell per workload whose radius is the
      paper's Algorithm 1 on that history
      (:func:`repro_torch.core.rho_from_history`): the budget is the *measured*
      KL spread of what was executed, not a declared guess."""

    indices: Optional[Tuple[int, ...]] = None
    workloads: Optional[Tuple[Tuple[float, ...], ...]] = None
    rhos: Tuple[float, ...] = ()
    nominal: bool = True
    bench_n: int = 0
    bench_seed: int = 0
    rho_source: str = "fixed"
    history: Optional[Tuple[Tuple[float, ...], ...]] = None

    def __post_init__(self):
        if (self.indices is None) == (self.workloads is None):
            raise ValueError("set exactly one of indices / workloads")
        if self.rho_source not in ("fixed", "from_history"):
            raise ValueError(f"unknown rho_source {self.rho_source!r}; "
                             "use 'fixed' or 'from_history'")
        if self.rho_source == "from_history":
            if self.history is None or len(self.history) < 2:
                raise ValueError("rho_source='from_history' needs a history "
                                 "of at least 2 observed mixes")
        elif not self.rhos and not self.nominal:
            raise ValueError("no tuning cells: empty rhos and nominal=False")


@dataclasses.dataclass(frozen=True)
class DesignSpec:
    """The design space: continuous Theta plus policy as a discrete arm.

    ``space`` names a :class:`repro_torch.core.DesignSpace` (the continuous
    parameterization the tuner optimizes).  ``policies`` are engine
    compaction-policy arms (:data:`repro_torch.core.ENGINE_POLICIES`): the tuners
    optimize Theta once per cell and the compiler then scores every arm's
    *effective* configuration (:func:`repro_torch.core.policy_effective_phi`,
    the policy's steady-state K profile) under the cell's exact objective,
    selecting the best arm jointly — the ROADMAP "tune over the policy axis"
    item.  ``policy_params`` carries per-arm planner constructor kwargs as
    (policy, ((name, value), ...)) pairs.

    ``fixed`` = (T, filter bits/entry, K) bypasses tuning entirely and
    deploys that configuration in every cell (the compaction design-space
    sweeps pin Theta to isolate the policy axis).

    ``spaces`` makes the design space itself an experiment AXIS: each entry
    is a design-space name or a ``(name, n_starts)`` pair, every arm is
    tuned over the full cell grid (one batched plan per distinct
    (space, n_starts)), and the report carries per-arm tunings and
    benchmark costs (``Report.design_tunings`` / ``design_bench_costs``)
    next to the primary results — the Figure-19 "flexibility vs robustness"
    comparison as one spec instead of a loop of specs.  ``space`` stays the
    *primary* design (rows, policy-arm selection, trials)."""

    space: str = "classic"
    policies: Tuple[str, ...] = ("klsm",)
    policy_params: Tuple[Tuple[str, Pairs], ...] = ()
    n_starts: int = 64
    steps: int = 250
    lr: float = 0.25
    seed: int = 0
    fixed: Optional[Tuple[float, ...]] = None
    spaces: Tuple[Any, ...] = ()

    def __post_init__(self):
        if not self.policies:
            raise ValueError("at least one policy arm is required")
        if self.fixed is not None and len(self.fixed) != 3:
            raise ValueError("fixed must be (T, filt_bits_per_entry, K)")
        if self.spaces and self.fixed is not None:
            raise ValueError("the design-space axis requires tuning; "
                             "drop `spaces` or `fixed`")
        for arm in self.spaces:
            if not (isinstance(arm, str)
                    or (isinstance(arm, tuple) and len(arm) == 2
                        and isinstance(arm[0], str))):
                raise ValueError(f"spaces entries are a name or a "
                                 f"(name, n_starts) pair, got {arm!r}")
        names = [a if isinstance(a, str) else a[0] for a in self.spaces]
        if len(set(names)) != len(names):
            # report results are keyed by space name; a repeated name
            # would silently overwrite one arm with the other
            raise ValueError(f"duplicate design-space arms in {names}")

    def params_for(self, policy: str) -> Pairs:
        return dict(self.policy_params).get(policy, ())

    def space_arms(self) -> Tuple[Tuple[str, int], ...]:
        """The design-space axis as (name, n_starts) pairs."""
        return tuple((arm, self.n_starts) if isinstance(arm, str)
                     else (arm[0], int(arm[1])) for arm in self.spaces)


@dataclasses.dataclass(frozen=True)
class TrialSpec:
    """The system trial: deploy every (cell, policy) tuning on the
    executable engine and measure I/O per query over workload sessions.

    Mirrors :func:`repro_torch.lsm.run_policy_fleet`'s conventions exactly (one
    shared key draw at ``key_seed``, per-session seeds ``session_seeds`` or
    ``0..S-1``), so a single-arm spec is bit-identical to a direct call.
    ``per_workload_keys`` switches to the Table-5 convention: each
    workload's trees share a key draw seeded ``key_seed + widx`` and
    session seeds ``key_seed + widx + s`` (the nominal/robust pair of a
    workload then shares materialized session plans).  ``delete_fraction``
    seeds tombstones after populate (every ``1/fraction``-th key), the
    tombstone-TTL policies' workload."""

    n_keys: int = 100_000
    n_queries: int = 2000
    sessions: Tuple[Tuple[float, ...], ...] = ()
    key_space: int = 2 ** 48
    range_fraction: float = 2e-5
    entry_bytes: int = 64
    key_seed: int = 7
    session_seeds: Optional[Tuple[int, ...]] = None
    per_workload_keys: bool = False
    delete_fraction: float = 0.0
    f_a: float = 1.0
    f_seq: float = 1.0
    zipf_a: Optional[float] = None

    def __post_init__(self):
        if not self.sessions:
            raise ValueError("a trial needs at least one session mix")


@dataclasses.dataclass(frozen=True)
class DriftSpec:
    """An online drift experiment: the executed workload moves away from
    the expected one over ``segments`` equal segments of ``n_queries``
    queries, and per-arm deployments react (or don't) — the
    :mod:`repro_torch.online` loop as a declarative schedule.

    **Schedule** — ``kind`` generates the per-segment true mixes from the
    workload's expected mix and ``target``: ``"gradual"`` (linear rotation
    expected -> target), ``"flip"`` (abrupt switch at mid-schedule),
    ``"cyclic"`` (alternate expected / target per segment), or
    ``"schedule"`` (take ``schedule`` rows verbatim, one per segment).
    Scenario kinds (:data:`repro_torch.scenarios.SCENARIO_KINDS`:
    ``zipf_migrate`` / ``burst_storm`` / ``tombstone_churn`` /
    ``scan_heavy`` / ``adversary``) delegate the schedule — and session
    shaping like Zipf skew, burst volume, delete fraction, scan span — to
    the scenario generator; ``scenario_params`` overrides its knobs and
    ``target`` (optional here) overrides its default drift target.  The
    ``adversary`` kind picks every segment's mix live: the worst workload
    inside the deployed tuning's rho-ball (see ``docs/scenarios.md``).

    **Arms** — any of ``repro.online.ARMS``: ``stale_nominal`` deploys the
    workload's nominal cell and never re-tunes; ``static_robust`` deploys
    the robust cell at the spec's LAST resolved rho (with
    ``rho_source="from_history"`` that is the history-derived budget) and
    never re-tunes; ``online`` starts from the same robust cell and runs
    the estimator + drift-trigger loop; ``oracle`` re-tunes every segment
    to the true upcoming mix (the adaptation upper bound).  Arms of one
    workload share the key population and per-segment session plans, so
    throughput differences are tuning differences.

    **Deployment** mirrors :class:`TrialSpec` (shared key draw at
    ``key_seed``, engine scale via ``n_keys``/``entry_bytes``); estimator /
    trigger / re-tune solver knobs map onto
    :class:`repro.online.DriftPolicy`, ``repro.online.ESTIMATORS`` and
    :func:`repro.online.retune_fleet`."""

    kind: str = "gradual"
    segments: int = 8
    n_queries: int = 1000
    target: Optional[Tuple[float, ...]] = None
    schedule: Optional[Tuple[Tuple[float, ...], ...]] = None
    #: scenario-kind knobs as (name, value) pairs, validated against the
    #: generator's declared PARAMS (see repro_torch.scenarios)
    scenario_params: Pairs = ()
    arms: Tuple[str, ...] = ("stale_nominal", "static_robust", "online",
                             "oracle")
    # deployment (TrialSpec conventions)
    n_keys: int = 100_000
    key_space: int = 2 ** 48
    range_fraction: float = 2e-5
    entry_bytes: int = 64
    key_seed: int = 7
    session_seed: int = 0
    f_a: float = 1.0
    f_seq: float = 1.0
    # estimator
    estimator: str = "window"
    alpha: float = 0.35
    window: int = 16
    capacity: int = 128
    # drift triggers
    kl_threshold: float = 0.05
    budget_slack: float = 1.0
    min_windows: int = 2
    cooldown: int = 1
    rho_floor: float = 0.05
    #: change-point detector beside the KL triggers: "kl" (none extra),
    #: "page_hinkley" (mean-shift detector over per-segment observed KL —
    #: catches burst storms the windowed estimator dilutes), or "cusum"
    #: (one-sided upper CUSUM with an absolute reference level in KL space)
    detector: str = "kl"
    ph_delta: float = 0.005
    ph_lambda: float = 0.25
    cusum_k: float = 0.01
    cusum_h: float = 0.15
    # re-tune solver
    retune_starts: int = 32
    retune_steps: int = 200
    retune_seed: int = 0

    def __post_init__(self):
        classic = ("gradual", "flip", "cyclic", "schedule")
        if self.kind not in classic and self.kind not in SCENARIO_KINDS:
            raise ValueError(f"unknown drift kind {self.kind!r}; classic "
                             f"kinds {classic} or scenario kinds "
                             f"{sorted(SCENARIO_KINDS)}")
        if self.kind == "schedule":
            if self.schedule is None or len(self.schedule) != self.segments:
                raise ValueError("kind='schedule' needs one schedule row "
                                 "per segment")
            if any(len(row) != 4 for row in self.schedule):
                raise ValueError("schedule rows must be 4-class mixes")
        elif self.kind in SCENARIO_KINDS:
            # target overrides the scenario's default drift target; the
            # generator's constructor validates knob names and ranges
            if self.target is not None and len(self.target) != 4:
                raise ValueError("target must be a 4-class mix")
            get_scenario(self)
        elif self.target is None or len(self.target) != 4:
            raise ValueError(f"kind={self.kind!r} needs a 4-class target "
                             "mix")
        if self.scenario_params and self.kind not in SCENARIO_KINDS:
            raise ValueError(f"scenario_params only apply to scenario "
                             f"kinds {sorted(SCENARIO_KINDS)}, not "
                             f"{self.kind!r}")
        if self.detector not in ("kl", "page_hinkley", "cusum"):
            raise ValueError(f"unknown detector {self.detector!r}; use "
                             "'kl', 'page_hinkley', or 'cusum'")
        if self.segments < 1:
            raise ValueError("segments must be >= 1")
        bad = set(self.arms) - {"stale_nominal", "static_robust", "online",
                                "oracle"}
        if bad or not self.arms:
            raise ValueError(f"unknown drift arms {sorted(bad)}"
                             if bad else "at least one arm is required")


@dataclasses.dataclass(frozen=True)
class MemorySpec:
    """Fleet-level memory arbitration over the drift schedule — the JAX
    package's ``repro.online.memory`` subsystem as a spec axis, run by
    :func:`repro_torch.online.execute_memory_fleet`.

    Composes with (and requires) :class:`DriftSpec`: the drift spec
    supplies the tenants (the workload rows), the per-tenant true-mix
    schedules, the deployment scale, and the estimator / trigger / re-tune
    solver knobs; this spec supplies the budget semantics.  Execution
    replaces the drift arms with a paired two-fleet comparison (``static``
    fixed equal split vs ``arbitrated``; see
    :func:`repro_torch.online.execute_memory_fleet`).

    **Budget** — ``total_bits_per_entry`` is the global budget summed over
    tenants (default: ``n_tenants * sys.bits_per_entry``, i.e. exactly the
    memory the fixed-split fleet already holds, so the comparison is
    division, not provisioning).  ``floor_bits_per_entry`` bounds how far a
    tenant can be squeezed; ``quantum_bits_per_entry`` is the allocation
    granularity (spatial hysteresis).

    **Trigger/hysteresis** — per-tenant KL triggers reuse the
    :class:`repro_torch.online.DriftPolicy` contract with the drift spec's
    ``kl_threshold`` (override with ``rebalance_kl``) and ``rho_floor``;
    ``min_windows`` and ``cooldown`` here gate the *fleet-level* decision
    (one re-division resets every tenant's cooldown).

    ``enabled=False`` deploys the arbitrated fleet at the fixed equal
    split and never re-divides: its results are bit-identical to the
    static fleet (the disabled-arbitration invariant the memory bench
    gates)."""

    enabled: bool = True
    total_bits_per_entry: Optional[float] = None
    floor_bits_per_entry: float = 2.0
    quantum_bits_per_entry: float = 0.5
    rebalance_kl: Optional[float] = None
    min_windows: int = 2
    cooldown: int = 2

    def __post_init__(self):
        if self.floor_bits_per_entry <= 0.0:
            raise ValueError("floor_bits_per_entry must be > 0")
        if self.quantum_bits_per_entry <= 0.0:
            raise ValueError("quantum_bits_per_entry must be > 0")
        if self.total_bits_per_entry is not None \
                and self.total_bits_per_entry <= 0.0:
            raise ValueError("total_bits_per_entry must be > 0 (or None "
                             "for n_tenants * sys.bits_per_entry)")
        if self.rebalance_kl is not None and self.rebalance_kl <= 0.0:
            raise ValueError("rebalance_kl must be > 0 (or None for the "
                             "drift spec's kl_threshold)")
        if self.min_windows < 1 or self.cooldown < 0:
            raise ValueError("min_windows must be >= 1 and cooldown >= 0")


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """The whole experiment: workload uncertainty x design x trial x backend.

    ``system`` holds :class:`repro_torch.core.LSMSystem` overrides as (name,
    value) pairs (the reduced-scale Table-5 systems); ``backend`` selects
    the execution backend (:data:`repro_torch.api.backends.BACKENDS`) and
    ``backend_params`` its constructor kwargs (e.g. ``(("workers", 4),)``
    for ``subprocess`` — which also accepts the fault-tolerance knobs
    ``max_retries`` / ``backoff_s`` / ``timeout_s`` / ``retry_seed`` /
    ``reshard`` / ``run_dir`` / ``resume``).

    ``faults`` is the injected failure schedule
    (:class:`repro_torch.faults.FaultSpec` tuple): worker-scoped faults fire in
    the ``subprocess`` backend's workers, ``torn_write`` faults in the
    artifact persistence path.  The backend contract is unchanged by any
    fault schedule — recovered results must be bit-identical to
    :class:`repro_torch.api.backends.InlineBackend` (see ``docs/faults.md``)."""

    name: str
    workload: WorkloadSpec
    design: DesignSpec = DesignSpec()
    trial: Optional[TrialSpec] = None
    drift: Optional[DriftSpec] = None
    memory: Optional[MemorySpec] = None
    system: Pairs = ()
    backend: str = "inline"
    backend_params: Pairs = ()
    faults: Tuple[FaultSpec, ...] = ()

    def __post_init__(self):
        for f in self.faults:
            if not isinstance(f, FaultSpec):
                raise ValueError(f"faults entries must be FaultSpec, "
                                 f"got {type(f).__name__}: {f!r}")
        if self.drift is not None:
            need_robust = {"static_robust", "online"} & set(self.drift.arms)
            if need_robust and not self.workload.rhos \
                    and self.workload.rho_source != "from_history":
                raise ValueError(f"drift arms {sorted(need_robust)} need a "
                                 "robust cell: declare rhos or "
                                 "rho_source='from_history'")
            if "stale_nominal" in self.drift.arms \
                    and not self.workload.nominal:
                raise ValueError("drift arm 'stale_nominal' needs "
                                 "workload.nominal=True")
        if self.memory is not None:
            if self.drift is None:
                raise ValueError(
                    "memory arbitration rides the drift schedule: a "
                    "MemorySpec needs a DriftSpec (tenants, schedules, "
                    "deployment scale, estimator/trigger knobs)")
            if self.drift.kind == "adversary":
                raise ValueError(
                    "kind='adversary' solves its mix against a drift "
                    "defender arm per segment; memory fleets have no such "
                    "arm — use a trace-shaped scenario kind instead")
            if not self.workload.rhos \
                    and self.workload.rho_source != "from_history":
                raise ValueError(
                    "memory fleets deploy each tenant's robust cell: "
                    "declare rhos or rho_source='from_history'")

    # -- JSON round-trip ----------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 1)
        kw.setdefault("sort_keys", True)
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentSpec":
        d = dict(d)
        wl = {k: _tupled(v) for k, v in d.pop("workload").items()}
        ds = {k: _tupled(v) for k, v in d.pop("design", {}).items()}
        tr = d.pop("trial", None)
        dr = d.pop("drift", None)
        me = d.pop("memory", None)
        fa = d.pop("faults", ())
        return cls(workload=WorkloadSpec(**wl), design=DesignSpec(**ds),
                   trial=TrialSpec(**{k: _tupled(v) for k, v in tr.items()})
                   if tr is not None else None,
                   drift=DriftSpec(**{k: _tupled(v) for k, v in dr.items()})
                   if dr is not None else None,
                   memory=MemorySpec(**{k: _tupled(v) for k, v in me.items()})
                   if me is not None else None,
                   faults=tuple(
                       f if isinstance(f, FaultSpec)
                       else FaultSpec(**{k: _tupled(v) for k, v in f.items()})
                       for f in fa),
                   **{k: _tupled(v) for k, v in d.items()})

    @classmethod
    def from_json(cls, text: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(text))
