"""Fault-tolerance suite: the recovery invariant and its overhead.

Two claims (the JAX package's ``BENCH_faults.json``):

* ``faults_recovery.identical_to_inline`` — a chaos schedule (worker crash
  + corrupted result pickle, deterministic seeds) thrown at the hardened
  subprocess backend recovers results bit-identical to the inline
  reference.  A flip to False is the robustness layer silently changing
  semantics — the one thing it must never do.
* ``faults_overhead.overhead_ratio`` — the supervision machinery
  (fault-plan consultation, retry bookkeeping, shard supervision) with NO
  faults injected, measured against a bare launch of the identical shard
  set with none of that machinery.  A ratio of two wall times, printed as
  time.

Both legs run on ``device``: on the card every worker process holds its
own CUDA context and launches ``merge`` and ``point_read`` itself; the
parent adds each accepted attempt's launches to its own counts.  The sizes
are module constants, read when the suite runs.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import List

from ..api import (DesignSpec, ExperimentSpec, FaultSpec, Row, TrialSpec,
                   WorkloadSpec, compile_spec, get_backend, run_experiment)
from .common import own_starts

N_KEYS = 30_000
QUERIES = 1500
SESSIONS = ((0.05, 0.85, 0.05, 0.05),)
REPS = 5     # overhead legs: median over REPS runs per path

CHAOS = (FaultSpec(kind="crash", shards=(0,), max_hits=1, seed=0),
         FaultSpec(kind="corrupt", shards=(1,), max_hits=1, seed=0))


def make_spec() -> ExperimentSpec:
    """The suite's spec at the module's sizes."""
    return ExperimentSpec(
        name="faults",
        workload=WorkloadSpec(indices=(4, 7, 9, 11), rhos=(), nominal=True),
        design=DesignSpec(fixed=(6.0, 4.0, 1.0)),   # no tuning: engine-only
        trial=TrialSpec(n_keys=N_KEYS, n_queries=QUERIES, sessions=SESSIONS,
                        key_space=2 ** 24, per_workload_keys=True,
                        key_seed=11),
        system=(("N", float(N_KEYS)), ("entry_bits", 64.0 * 8),
                ("bits_per_entry", 6.0), ("min_buf_bits", 64.0 * 8 * 64),
                ("max_T", 20.0)),
    )


def chaos_spec(spec: ExperimentSpec) -> ExperimentSpec:
    """``spec`` on the subprocess backend under :data:`CHAOS` (after a
    JSON round trip: a chaos scenario is a spec like any other)."""
    return dataclasses.replace(
        ExperimentSpec.from_json(spec.to_json()), backend="subprocess",
        backend_params=(("workers", 2), ("max_retries", 2),
                        ("timeout_s", 300.0)),
        faults=CHAOS)


def trial_signature(report) -> dict:
    """Every tree's ``IOStats``, I/O per query and ``TreeProbe``, as plain
    data: two trials are the same trial when their signatures are equal."""
    return {key: ([r.io.as_dict() for r in res],
                  [r.avg_io_per_query for r in res],
                  dataclasses.asdict(report.probes[key]))
            for key, res in report.fleet.items()}


def _identical(a, b) -> bool:
    if a.failed_cells or b.failed_cells:
        return False
    return trial_signature(a) == trial_signature(b)


def _bare_wall(backend, plan, device) -> float:
    """The machinery-free reference: the same shard partition launched
    directly on the port's worker (no fault plan, no retry loop, no
    supervisor, no persistence)."""
    import concurrent.futures
    import pickle
    import subprocess

    import torch

    from ..api.backends import _worker_cmd, _worker_env
    shards = backend._partition(plan)
    env, cmd = _worker_env(), _worker_cmd()
    dev = str(torch.device("cuda" if device is None else device))

    def launch(shard):
        job = pickle.dumps((plan, [plan.trees[t] for t in shard], None, dev),
                           protocol=pickle.HIGHEST_PROTOCOL)
        proc = subprocess.run(cmd, input=job, stdout=subprocess.PIPE,
                              env=env, check=True)
        return pickle.loads(proc.stdout)

    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(len(shards)) as pool:
        list(pool.map(launch, shards))
    return time.time() - t0


def recovery_row(device=None) -> Row:
    """Leg 1, recovery fidelity under chaos: the suite's spec inline and on
    the subprocess backend under :data:`CHAOS`, both on ``device``."""
    spec = make_spec()
    inline = run_experiment(spec, device=device)
    t0 = time.time()
    chaos = run_experiment(chaos_spec(spec), device=device)
    chaos_s = time.time() - t0
    return Row(
        "faults_recovery", chaos_s * 1e6,
        identical_to_inline=_identical(inline, chaos),
        injected=len(CHAOS), shard_retries=int(chaos.walls["shard_retries"]),
        shards_run=int(chaos.walls["shards_run"]),
        failed_trees=int(chaos.walls["failed_trees"]),
        trees=len(chaos.fleet), n_keys=spec.trial.n_keys,
        n_queries=spec.trial.n_queries,
    )


def overhead_row(device=None) -> Row:
    """Leg 2, the machinery's overhead with faults disabled: the median of
    :data:`REPS` supervised trials against as many bare launches of the
    same shards."""
    cx = compile_spec(make_spec())
    solved = {d: get_backend("inline", ()).solve(p, device=device)
              for d, p in cx.tuning_plans().items()}
    backend = get_backend("subprocess", (("workers", 2),))
    plan = cx.build_trial(cx.select_arms(solved))
    supervised, bare = [], []
    for _ in range(REPS):
        report = cx.select_arms(solved)
        t0 = time.time()
        backend.run_trial(plan, report, device=device)  # empty fault plan
        supervised.append(time.time() - t0)
        bare.append(_bare_wall(backend, plan, device))
    sup_s = statistics.median(supervised)
    bare_s = statistics.median(bare)
    return Row(
        "faults_overhead", sup_s * 1e6,
        overhead_ratio=round(sup_s / bare_s, 4),
        overhead_pct=round((sup_s / bare_s - 1.0) * 100.0, 2),
        supervised_s=round(sup_s, 3), bare_s=round(bare_s, 3),
        reps=REPS, workers=2, trees=len(plan.trees),
    )


def run(device=None, starts=own_starts) -> List[Row]:
    """The suite on ``device``; it runs no tuner, so ``starts`` is
    unused."""
    return [recovery_row(device), overhead_row(device)]
