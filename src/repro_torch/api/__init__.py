"""The unified experiment API on the port: declarative specs over the
whole stack (the port of ``repro.api``).

One call::

    from repro_torch.api import ExperimentSpec, WorkloadSpec, run_experiment

    spec = ExperimentSpec(
        name="demo",
        workload=WorkloadSpec(indices=(7, 11), rhos=(1.0,), bench_n=2000),
    )
    report = run_experiment(spec)                  # on the card
    report = run_experiment(spec, device="cpu")    # the plain path

lowers the spec (:mod:`repro_torch.api.compile`) onto the batched tuners
and the fleet executor, runs it on the spec's execution backend
(:mod:`repro_torch.api.backends`), and returns one :class:`Report`
(:mod:`repro_torch.api.report`), serializable in the
``BENCH_<suite>.json`` schema.  Specs round-trip through JSON with the
JAX package's text.

A drift spec of any kind runs, the scenario kinds of
:mod:`repro_torch.scenarios` included (the adversary's regret trace lands
in ``Report.regret``).  Every backend of the JAX package is here:
``inline``, ``sharded``, ``subprocess`` (fleet shards in worker processes
on the caller's device, with retries, re-sharding and resume) and the
``remote`` scheduling stub.
"""

from __future__ import annotations

import time

from ..faults import FaultPlan, FaultSpec
from .backends import (BACKENDS, ExecutionBackend, InlineBackend,
                       RemoteBackend, ShardedBackend, SubprocessBackend,
                       execute_trial, get_backend)
from .compile import (CompiledExperiment, DriftPlan, MemoryPlan, TrialPlan,
                      TuningPlan, compile_spec, drift_schedule)
from .report import (Report, Row, TreeProbe, costs_over_benchmark, delta_tp,
                     fmt, jsonable, timed)
from .spec import (DesignSpec, DriftSpec, ExperimentSpec, MemorySpec,
                   TrialSpec, WorkloadSpec)

__all__ = [
    "ExperimentSpec", "WorkloadSpec", "DesignSpec", "TrialSpec", "DriftSpec",
    "MemorySpec",
    "FaultSpec", "FaultPlan",
    "Report", "Row", "TreeProbe", "run_experiment",
    "compile_spec", "CompiledExperiment", "TuningPlan", "TrialPlan",
    "DriftPlan", "MemoryPlan", "drift_schedule",
    "BACKENDS", "ExecutionBackend", "InlineBackend", "ShardedBackend",
    "SubprocessBackend", "RemoteBackend", "get_backend", "execute_trial",
    "costs_over_benchmark", "delta_tp", "timed", "fmt", "jsonable",
]


def run_experiment(spec: ExperimentSpec, backend=None, *, device=None,
                   starts=None) -> Report:
    """Compile and execute an :class:`ExperimentSpec`; returns its
    :class:`Report`.

    ``backend`` overrides the spec's backend instance; by default the
    spec's ``backend`` / ``backend_params`` fields select it.  ``device``
    is where the tunings, the trial, the drift loop and the memory
    arbitration loop run (``None`` is the card).  ``starts(design,
    n_starts, seed)`` gives each tuning plan's starts and every re-tune
    storm's (``repro_torch.bench.common``); with ``None`` the tuners draw
    their own from ``seed``.  ``spec.faults`` compiles into a
    :class:`~repro_torch.faults.FaultPlan` handed to the trial executor.
    A memory spec runs its paired fleets *in place of* the drift arms."""
    cx = compile_spec(spec)
    if backend is None:
        backend = get_backend(spec.backend, spec.backend_params)
    faults = FaultPlan.from_specs(spec.faults) if spec.faults else None

    t0 = time.time()
    solved = {key: backend.solve(
        plan, device=device,
        starts=None if starts is None
        else starts(plan.design, plan.n_starts, plan.seed))
        for key, plan in cx.tuning_plans().items()}
    tuning_s = time.time() - t0

    t0 = time.time()
    report = cx.select_arms(solved)
    report.walls["tuning_s"] = tuning_s
    report.walls["select_s"] = time.time() - t0
    backend.annotate(report)

    trial = cx.build_trial(report)
    if trial is not None:
        backend.run_trial(trial, report, faults=faults, device=device)
    memory = cx.build_memory(report)
    if memory is not None:
        # the memory axis REPLACES drift-arm execution: the drift spec is
        # consumed as the schedule/loop configuration of the paired
        # static/arbitrated fleet comparison
        backend.run_memory(memory, report, device=device, starts=starts)
    else:
        drift = cx.build_drift(report)
        if drift is not None:
            backend.run_drift(drift, report, device=device, starts=starts)
    return report
