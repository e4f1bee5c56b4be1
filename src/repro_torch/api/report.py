"""One report schema for every experiment: the port of
``repro/api/report.py``.

A :class:`Report` is the single result tree a compiled experiment produces:
the tunings of every (workload, rho) cell and policy arm, the model cost
vectors next to the engine-measured ones, Delta-throughput metrics, and the
phase wall times, serialized in exactly the ``BENCH_<suite>.json`` schema::

    {"suite": <name>, "wall_time_s": <float>, "error": null,
     "rows": [{"name": ..., "us_per_call": ..., "derived": {...}}, ...],
     "checksum": "sha256:..."}

For the same report the payload is the JAX package's, byte for byte,
checksum included.  The row layer the paper suites share (:class:`Row`,
strict-JSON coercion, benchmark-set cost evaluation, Delta-throughput)
lives here too; ``repro_torch.bench.run`` prints rows as CSV.  So does
the adversary scenario's regret trace (``Report.regret``, one
``{name}_regret_w{widx}`` row per attacked workload), and the subprocess
backend's recovery (``Report.failed_cells``, ``Report.shard_attempts``:
the ``{name}_failed`` and ``{name}_shards`` rows).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


class Row:
    """One CSV/JSON output row: name, us_per_call, derived metrics."""

    def __init__(self, name: str, us: float, **derived):
        self.name = name
        self.us = us
        self.derived = derived

    def csv(self) -> str:
        d = ";".join(f"{k}={v}" for k, v in self.derived.items())
        return f"{self.name},{self.us:.1f},{d}"


def timed(fn: Callable, *args, **kw) -> Tuple[float, object]:
    t0 = time.time()
    out = fn(*args, **kw)
    return (time.time() - t0) * 1e6, out


def fmt(x: float) -> str:
    return f"{x:.4g}"


def jsonable(x):
    """Best-effort conversion of derived metric values to *strict* JSON types
    (non-finite floats become null: strict parsers reject the bare
    NaN/Infinity literals json.dump emits)."""
    if isinstance(x, dict):
        return {str(k): jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonable(v) for v in x]
    if isinstance(x, bool) or x is None:
        return x
    if hasattr(x, "item"):          # numpy / torch scalars
        try:
            return jsonable(x.item())
        except (ValueError, RuntimeError):
            return str(x)
    if isinstance(x, float):
        return x if math.isfinite(x) else None
    if isinstance(x, (int, str)):
        return x
    return str(x)


def costs_over_benchmark(phi, sys, B: np.ndarray) -> np.ndarray:
    """C(w, phi) for every workload in a benchmark set (vectorized, float64
    on the host over the float32 cost vector)."""
    from ..core import cost_vector
    c = cost_vector(phi, sys).detach().cpu().numpy().astype(np.float64)
    return np.asarray(B, np.float64) @ c


def delta_tp(cn: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """Normalized delta throughput of robust (cr) vs nominal (cn)."""
    return (1.0 / cr - 1.0 / cn) / (1.0 / cn)


# ---------------------------------------------------------------------------
# Structured results
# ---------------------------------------------------------------------------

#: A tuning cell: (workload_index_in_spec, rho) with rho=None for nominal.
Cell = Tuple[int, Optional[float]]


@dataclasses.dataclass
class TreeProbe:
    """Post-trial engine introspection, as plain data."""

    shape: List[Tuple[int, List[int]]]
    last_level_runs: int
    flush_seq: int
    tomb_ages: List[int]                 # flush_seq - tomb_seq per live run
    dead_keys_resurfaced: int = 0
    intern_table_len: int = 0

    @property
    def max_tombstone_age(self) -> int:
        return max(self.tomb_ages, default=0)

    @classmethod
    def from_tree(cls, tree, dead_keys=None) -> "TreeProbe":
        ages = [tree.flush_seq - ts for lv in tree.store.levels
                for ts in lv.tomb_seqs if ts >= 0]
        shape = tree.shape()
        resurfaced = 0
        if dead_keys is not None and len(dead_keys):
            resurfaced = sum(tree.get(int(k)) is not None for k in dead_keys)
        return cls(shape=shape,
                   last_level_runs=len(shape[-1][1]) if shape else 0,
                   flush_seq=tree.flush_seq, tomb_ages=ages,
                   dead_keys_resurfaced=resurfaced,
                   intern_table_len=len(tree.store.codec.objects))


@dataclasses.dataclass
class Report:
    """The one result tree of an experiment.

    Everything is keyed by :data:`Cell` = (workload index within the spec,
    rho-or-None) and policy-arm name, in the deterministic cell order
    ``cells`` (nominal cells first, then the (workload-major, rho-minor)
    robust grid — the same flattening ``tune_robust_many`` uses)."""

    spec: Any                                 # the ExperimentSpec
    sys: Any                                  # resolved LSMSystem
    cells: List[Cell]
    tunings: Dict[Cell, Dict[str, Any]]       # cell -> arm -> TuningResult
    arm_costs: Dict[Cell, Dict[str, float]]   # exact objective per arm
    chosen: Dict[Cell, str]                   # joint policy-arm winner
    model_costs: Dict[Cell, Dict[str, np.ndarray]]  # c(effective phi), (4,)
    bench_costs: Dict[Cell, np.ndarray] = dataclasses.field(
        default_factory=dict)                 # C over benchmark set B
    bench_set: Optional[np.ndarray] = None
    fleet: Dict[Tuple[Cell, str], list] = dataclasses.field(
        default_factory=dict)                 # -> [SessionResult per session]
    probes: Dict[Tuple[Cell, str], TreeProbe] = dataclasses.field(
        default_factory=dict)
    #: the design-space axis (DesignSpec.spaces): space name -> cell ->
    #: TuningResult, and the matching benchmark-set costs
    design_tunings: Dict[str, Dict[Cell, Any]] = dataclasses.field(
        default_factory=dict)
    design_bench_costs: Dict[str, Dict[Cell, np.ndarray]] = \
        dataclasses.field(default_factory=dict)
    #: the drift experiment (ExperimentSpec.drift): (workload index, arm)
    #: -> repro_torch.online.DriftArmResult
    drift: Dict[Tuple[int, str], Any] = dataclasses.field(
        default_factory=dict)
    #: adversary-scenario regret trace (DriftSpec.kind="adversary"):
    #: workload index -> per-segment records (attacked mix, its KL from the
    #: live center, nominal/realized model cost, the independently-solved
    #: KL dual bound, and the per-segment ``le_dual_bound`` verdict)
    regret: Dict[int, List[dict]] = dataclasses.field(default_factory=dict)
    #: the memory-arbitration experiment (ExperimentSpec.memory):
    #: (tenant index, fleet in repro_torch.online.MEMORY_ARMS) ->
    #: DriftArmResult, plus the arbiter's division event log (initial
    #: division + every online re-division: segment, reasons, granted
    #: shares, re-tuned set)
    memory: Dict[Tuple[int, str], Any] = dataclasses.field(
        default_factory=dict)
    memory_events: List[dict] = dataclasses.field(default_factory=list)
    #: graceful degradation: trial trees whose shard exhausted every retry
    #: and re-shard attempt, keyed like ``fleet``, valued with the final
    #: error (worker stderr included) — the sweep completes with explicit
    #: holes instead of crashing.
    failed_cells: Dict[Tuple[Cell, str], str] = dataclasses.field(
        default_factory=dict)
    #: SubprocessBackend per-attempt log: one dict per worker launch
    #: ({"shard", "attempt", "ok", "latency_s"}), successes included — a
    #: shard that flapped (failed, then succeeded on retry) is visible
    #: here even though the sweep reported no failure.
    shard_attempts: List[dict] = dataclasses.field(default_factory=list)
    walls: Dict[str, float] = dataclasses.field(default_factory=dict)

    # -- accessors ----------------------------------------------------------

    def tuning(self, cell: Cell, policy: Optional[str] = None):
        arms = self.tunings[cell]
        return arms[policy or self.chosen[cell]]

    def measured_io(self, cell: Cell, policy: Optional[str] = None
                    ) -> np.ndarray:
        """avg I/O per query for every session of one deployed tree."""
        res = self.fleet[(cell, policy or self.chosen[cell])]
        return np.array([r.avg_io_per_query for r in res])

    def model_session_io(self, cell: Cell, sessions,
                         policy: Optional[str] = None) -> np.ndarray:
        """The cost model's prediction for each session mix (S,)."""
        c = self.model_costs[cell][policy or self.chosen[cell]]
        return np.atleast_2d(np.asarray(sessions, np.float64)) @ c

    def delta_tp_vs_nominal(self, widx: int, rho: float,
                            policy: Optional[str] = None) -> np.ndarray:
        """Model Delta-throughput of the robust cell vs its nominal baseline
        over the benchmark set B (requires ``bench_n`` > 0 in the spec)."""
        cn = self.bench_costs[(widx, None)]
        cr = self.bench_costs[(widx, rho)]
        return delta_tp(cn, cr)

    def memory_fleet_throughput(self, fleet: str) -> float:
        """Fleet-wide throughput of one memory arm (``"static"`` /
        ``"arbitrated"``): total queries over total measured I/O across
        every tenant — tenants serving more traffic weigh more, exactly
        like the per-tree query weighting."""
        recs = [rec for (_, arm), res in self.memory.items()
                if arm == fleet for rec in res.records]
        q = sum(r.queries for r in recs)
        io = sum(r.avg_io_per_query * r.queries for r in recs)
        return q / max(io, 1e-9)

    @property
    def wall_time_s(self) -> float:
        """Total of the phase timings (keys ending in ``_s``; other keys in
        ``walls`` are annotations, e.g. device counts)."""
        return float(sum(v for k, v in self.walls.items()
                         if k.endswith("_s")))

    # -- rows / serialization ----------------------------------------------

    def rows(self) -> List[Row]:
        """The default row rendering: one row per cell (chosen arm, per-arm
        objective costs, measured-vs-model when a trial ran) plus a wall-time
        summary row."""
        name = self.spec.name
        out: List[Row] = []
        for cell in self.cells:
            widx, rho = cell
            tag = f"w{widx}" if rho is None else f"w{widx}_rho{rho:g}"
            r = self.tuning(cell)
            derived = dict(
                chosen_policy=self.chosen[cell],
                design=r.design.value,
                tuning=r.describe(self.sys),
                cost=round(float(r.cost), 4),
                arm_costs={p: round(float(c), 4)
                           for p, c in self.arm_costs[cell].items()},
            )
            if (cell, self.chosen[cell]) in self.fleet:
                sessions = self.spec.trial.sessions
                measured = self.measured_io(cell)
                model = self.model_session_io(cell, sessions)
                derived.update(
                    measured_io=[round(float(x), 3) for x in measured],
                    model_io=[round(float(x), 3) for x in model],
                    agreement_ratio=round(
                        float(measured.mean() / model.mean()), 3),
                )
            out.append(Row(f"{name}_{tag}", 0.0, **derived))
        for (widx, arm), res in self.drift.items():
            last = res.records[-1]
            out.append(Row(
                f"{name}_drift_w{widx}_{arm}", 0.0,
                avg_io=round(res.avg_io_per_query, 4),
                throughput=round(res.throughput, 4),
                retunes=res.retunes,
                segments=len(res.records),
                final_kl=round(float(last.kl_est), 4),
                final_rho=round(float(last.rho_live), 4),
                segment_io=[round(r.avg_io_per_query, 3)
                            for r in res.records],
            ))
        for widx, recs in sorted(self.regret.items()):
            out.append(Row(
                f"{name}_regret_w{widx}", 0.0,
                segments=len(recs),
                defender=recs[-1]["defender"],
                max_regret=round(max(r["regret"] for r in recs), 6),
                max_kl_adv=round(max(r["kl_adv"] for r in recs), 6),
                # the robustness claim: on EVERY attacked segment the
                # realized model cost stayed under the KL dual bound
                claim_regret_le_dual_bound=bool(
                    all(r["le_dual_bound"] for r in recs)),
                trace=[{"segment": r["segment"], "rho": round(r["rho"], 4),
                        "kl_adv": round(r["kl_adv"], 5),
                        "cost_nominal": round(r["cost_nominal"], 5),
                        "cost_adv": round(r["cost_adv"], 5),
                        "dual_bound": round(r["dual_bound"], 5),
                        "measured_io": round(r["measured_io"], 4)}
                       for r in recs],
            ))
        for (widx, fleet), res in sorted(self.memory.items()):
            last = res.records[-1]
            out.append(Row(
                f"{name}_memory_w{widx}_{fleet}", 0.0,
                avg_io=round(res.avg_io_per_query, 4),
                throughput=round(res.throughput, 4),
                retunes=res.retunes,
                segments=len(res.records),
                final_kl=round(float(last.kl_est), 4),
                segment_io=[round(r.avg_io_per_query, 3)
                            for r in res.records],
            ))
        if self.memory:
            tp_static = self.memory_fleet_throughput("static")
            tp_arb = self.memory_fleet_throughput("arbitrated")
            out.append(Row(
                f"{name}_memory_fleet", 0.0,
                tenants=len({w for w, _ in self.memory}),
                tp_static=round(tp_static, 4),
                tp_arbitrated=round(tp_arb, 4),
                fleet_speedup=round(tp_arb / max(tp_static, 1e-9), 4),
                divisions=len(self.memory_events),
                events=[{"segment": e["segment"], "reason": e["reason"],
                         "shares": [round(s, 3) for s in e["shares"]],
                         "retuned": e["retuned"]}
                        for e in self.memory_events],
            ))
        if self.failed_cells:
            out.append(Row(
                f"{name}_failed", 0.0,
                failed=len(self.failed_cells),
                cells=[f"w{w}" + ("" if rho is None else f"_rho{rho:g}")
                       + f":{pol}"
                       for (w, rho), pol in sorted(
                           self.failed_cells, key=str)],
                errors=[err.splitlines()[-1][:200] if err else ""
                        for _, err in sorted(self.failed_cells.items(),
                                             key=lambda kv: str(kv[0]))],
            ))
        if self.shard_attempts:
            lat = [a["latency_s"] for a in self.shard_attempts]
            failed = {a["shard"] for a in self.shard_attempts if not a["ok"]}
            flapping = sorted(
                failed & {a["shard"] for a in self.shard_attempts
                          if a["ok"]})
            out.append(Row(
                f"{name}_shards", 0.0,
                attempts=len(self.shard_attempts),
                failed_attempts=sum(not a["ok"]
                                    for a in self.shard_attempts),
                flapping_shards=flapping,
                max_attempt_latency=round(max(lat), 4),
                mean_attempt_latency=round(sum(lat) / len(lat), 4),
            ))
        out.append(Row(f"{name}_walls", self.wall_time_s * 1e6,
                       **{k: round(v, 3) for k, v in self.walls.items()},
                       cells=len(self.cells),
                       policies=len(self.spec.design.policies),
                       backend=self.spec.backend))
        return out

    def to_bench_payload(self, rows: Optional[List[Row]] = None,
                         error: Optional[str] = None) -> Dict[str, Any]:
        """Exactly the ``BENCH_<suite>.json`` schema (suite / wall_time_s /
        error / rows / checksum; a ``metrics`` block only while telemetry
        is live)."""
        from .. import obs
        from ..faults import stamp_checksum
        rows = self.rows() if rows is None else rows
        payload: Dict[str, Any] = {
            "suite": self.spec.name,
            "wall_time_s": round(self.wall_time_s, 3),
            "error": error,
            "rows": [{"name": r.name,
                      "us_per_call": jsonable(round(float(r.us), 1)),
                      "derived": jsonable(r.derived)} for r in rows],
        }
        if obs.enabled():
            payload["metrics"] = jsonable(obs.metrics_snapshot())
        return stamp_checksum(payload)

    def write_bench_json(self, path: str,
                         rows: Optional[List[Row]] = None) -> None:
        """Atomic (tmp + ``os.replace``), checksummed baseline write — a
        crash mid-save leaves the previous file, never a torn one."""
        from ..faults import atomic_write_json
        atomic_write_json(path, self.to_bench_payload(rows))
