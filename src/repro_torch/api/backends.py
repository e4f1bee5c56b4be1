"""Pluggable execution backends: the *where/how* axis of an experiment.

The port of ``repro/api/backends.py``.  A backend executes a compiled
experiment's heavy phases — the batched tuning grid, the engine fleet
trial and the drift loop — without changing their semantics.

The drift loop (:meth:`ExecutionBackend.run_drift`) and the memory
arbitration loop (:meth:`ExecutionBackend.run_memory`) are one driver each
that every backend shares.

* :class:`InlineBackend` (``"inline"``, default) — one
  ``tune_nominal_many`` / ``tune_robust_many`` lane batch per plan on the
  caller's device, one :func:`repro_torch.lsm.run_fleet` call for the whole
  (tree x session) grid.  Every other backend must produce results
  identical to this one.
* :class:`ShardedBackend` (``"sharded"``) — splits the flattened
  (workload x rho) problem axis into one contiguous chunk per device (by
  default every card of the host), solves each chunk there, and
  concatenates the chunks in order.  The starts are drawn once for the
  whole axis before the split, and the lanes are independent, so the
  split cannot change a result.  On one card every chunk runs on that
  card; the report's ``walls`` say how many devices took part.

* :class:`SubprocessBackend` (``"subprocess"``) — shards the fleet grid's
  *trees* across worker processes, each running :func:`execute_trial` on
  its shard on the caller's device (on the card, each worker holds its own
  CUDA context and launches ``merge`` and ``point_read`` itself).  Trees
  sharing a key draw stay on one worker; tuning runs inline.  Retries,
  elastic re-sharding, graceful degradation and checksummed resume as in
  the JAX package.
* :class:`RemoteBackend` (``"remote"``) — a scheduling stub: it
  serializes the versioned, checksummed job envelope and refuses to
  execute.

**The fault-recovery invariant.**  Under any injected fault schedule
(:class:`repro_torch.faults.FaultPlan`), every result the subprocess
backend recovers is bit-identical to :class:`InlineBackend`'s: keys and
session plans are pure functions of their seeds and the engine is
bit-identical across devices, so retrying, re-sharding and resuming move
work and never change it.  When recovery is exhausted the sweep completes
with the lost trees in ``Report.failed_cells``.

Every backend takes ``device`` (``None`` is the card, as everywhere in the
port) and ``starts``, the ``(1, n_starts, n_params)`` starts of a plan or
None for the tuners' own seeded draw.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..faults import RetryPolicy
from ..kernels._compat import resolve_device
from .compile import TreeBuild, TrialPlan, TuningPlan
from .report import Cell, Report, TreeProbe


# ---------------------------------------------------------------------------
# The shared trial executor
# ---------------------------------------------------------------------------

class _SysLite:
    """The two LSMSystem fields ``LSMTree.from_phi`` reads, as plain
    floats."""

    __slots__ = ("bits_per_entry", "N")

    def __init__(self, bits_per_entry: float, N: float):
        self.bits_per_entry = bits_per_entry
        self.N = N


class _PhiLite:
    __slots__ = ("T", "mfilt_bits", "K")

    def __init__(self, T: float, mfilt_bits: float, K: Tuple[float, ...]):
        self.T = T
        self.mfilt_bits = mfilt_bits
        self.K = np.asarray(K, np.float64)


def execute_trial(plan: TrialPlan, trees: Optional[List[TreeBuild]] = None,
                  device=None):
    """Build, populate, and run one shard of the fleet grid on ``device``
    (the card unless ``device="cpu"``; on the card every compaction runs
    the ``merge`` kernel and every read batch ``point_read``).

    Returns ``(results, probes, populate_s, fleet_s)`` with one entry per
    :class:`TreeBuild` (in input order): the per-session
    :class:`~repro_torch.lsm.SessionResult` list and the post-trial
    :class:`TreeProbe`.  The engine is bit-identical across devices, so
    where a trial runs cannot change measured I/O."""
    from ..lsm import IOStats, LSMTree, draw_keys, populate, run_fleet

    builds = plan.trees if trees is None else trees
    sys_lite = _SysLite(plan.bits_per_entry, plan.sys_N)
    t0 = time.time()
    keys_by_group: Dict[int, np.ndarray] = {}
    dead_by_group: Dict[int, np.ndarray] = {}
    engine_trees, keys_list, seed_rows = [], [], []
    with obs.span("trial.populate", trees=len(builds)):
        for b in builds:
            keys = keys_by_group.get(b.key_group)
            if keys is None:
                keys = draw_keys(plan.n_keys, seed=b.key_seed,
                                 key_space=plan.key_space)
                keys_by_group[b.key_group] = keys
                if plan.delete_fraction > 0:
                    dead_by_group[b.key_group] = \
                        keys[::int(1 / plan.delete_fraction)]
            tree = LSMTree.from_phi(_PhiLite(b.T, b.mfilt_bits, b.K),
                                    sys_lite,
                                    expected_entries=plan.n_keys,
                                    entry_bytes=plan.entry_bytes,
                                    policy=b.policy,
                                    policy_params=b.policy_params,
                                    device=device)
            tree.obs_label = f"w{b.cell[0]}.rho{b.cell[1]}/{b.policy}"
            populate(tree, plan.n_keys, key_space=plan.key_space, keys=keys)
            if plan.delete_fraction > 0:
                for k in dead_by_group[b.key_group]:  # seed tombstones
                    tree.delete(int(k))
                tree.flush()
                tree.stats = IOStats()    # deletes are setup, not workload
            engine_trees.append(tree)
            keys_list.append(keys)
            seed_rows.append(list(b.session_seeds))
    populate_s = time.time() - t0

    t0 = time.time()
    with obs.span("trial.fleet", trees=len(builds),
                  sessions=len(plan.sessions)):
        results = run_fleet(engine_trees,
                            np.asarray(plan.sessions, np.float64),
                            keys_list, n_queries=plan.n_queries,
                            seeds=np.asarray(seed_rows),
                            key_space=plan.key_space,
                            range_fraction=plan.range_fraction,
                            f_a=plan.f_a, f_seq=plan.f_seq,
                            zipf_a=plan.zipf_a)
    fleet_s = time.time() - t0
    probes = [TreeProbe.from_tree(
        t, dead_by_group.get(b.key_group, np.empty(0))[:plan.probe_dead_keys]
        if plan.delete_fraction > 0 else None)
        for t, b in zip(engine_trees, builds)]
    return results, probes, populate_s, fleet_s


def _attach_trial(report: Report, builds: List[TreeBuild], results,
                  probes) -> None:
    for b, res, probe in zip(builds, results, probes):
        report.fleet[(b.cell, b.policy)] = res
        report.probes[(b.cell, b.policy)] = probe


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------

class ExecutionBackend:
    """The backend protocol: solve one tuning plan, run one fleet trial.

    ``solve`` returns ``{cell: TuningResult}`` for every cell of the plan's
    (workload x rho [x nominal]) grid; ``run_trial`` fills the report's
    ``fleet`` / ``probes`` / wall-time fields in place.  Implementations
    must be *semantics-free*: any backend produces the same tunings and the
    same measured ``IOStats`` as :class:`InlineBackend`."""

    name = "abstract"

    def solve(self, plan: TuningPlan, device=None,
              starts=None) -> Dict[Cell, object]:
        raise NotImplementedError

    def run_trial(self, plan: TrialPlan, report: Report, faults=None,
                  device=None) -> None:
        raise NotImplementedError

    def run_drift(self, plan, report: Report, device=None,
                  starts=None) -> None:
        """Run a compiled drift experiment
        (``repro_torch.api.compile.DriftPlan``) on ``device``.

        One shared implementation: the online loop is a feedback system —
        segment s+1's tunings depend on what segment s observed — so it is
        inherently sequential per deployment and every backend runs the
        same inline driver (re-tune storms inside it are still one batched
        dispatch across the whole fleet).  ``starts`` is the provider of
        the storms' starts (``run_experiment``'s)."""
        from ..online import execute_drift
        t0 = time.time()
        results, regret = execute_drift(plan, device=device, starts=starts)
        report.drift.update(results)
        for widx, recs in regret.items():
            report.regret.setdefault(widx, []).extend(recs)
        report.walls["drift_s"] = time.time() - t0

    def run_memory(self, plan, report: Report, device=None,
                   starts=None) -> None:
        """Run a compiled memory-arbitration experiment
        (``repro_torch.api.compile.MemoryPlan``) on ``device``.

        Shared for the same reason as :meth:`run_drift`: the arbitration
        loop feeds observed segments back into memory divisions, so it is
        sequential per fleet and every backend runs the same inline driver
        (its re-tune storms are still one batched dispatch per granted
        share)."""
        from ..online import execute_memory_fleet
        t0 = time.time()
        results, events = execute_memory_fleet(plan, device=device,
                                               starts=starts)
        report.memory.update(results)
        report.memory_events.extend(events)
        report.walls["memory_s"] = time.time() - t0

    def annotate(self, report: Report) -> None:
        """Record what the backend did beside the report's walls."""


class InlineBackend(ExecutionBackend):
    """Single-process reference execution on the caller's device.

    Worker-scoped faults are a no-op here by definition — there is no
    worker process to kill — which is what makes this backend the
    reference side of the fault-recovery invariant."""

    name = "inline"

    def __init__(self, **_):
        pass

    def solve(self, plan: TuningPlan, device=None,
              starts=None) -> Dict[Cell, object]:
        from ..core import tune_nominal_many, tune_robust_many
        kw = dict(design=plan.design, n_starts=plan.n_starts,
                  steps=plan.steps, lr=plan.lr, seed=plan.seed,
                  device=device, starts=starts)
        out: Dict[Cell, object] = {}
        if plan.nominal:
            for i, r in enumerate(tune_nominal_many(plan.W, plan.sys, **kw)):
                out[(i, None)] = r
        if plan.rhos:
            grid = tune_robust_many(plan.W, list(plan.rhos), plan.sys, **kw)
            for i, row in enumerate(grid):
                for j, rho in enumerate(plan.rhos):
                    out[(i, rho)] = row[j]
        return out

    def run_trial(self, plan: TrialPlan, report: Report, faults=None,
                  device=None) -> None:
        results, probes, populate_s, fleet_s = execute_trial(
            plan, device=device)
        _attach_trial(report, plan.trees, results, probes)
        report.walls["populate_s"] = populate_s
        report.walls["fleet_s"] = fleet_s


class ShardedBackend(InlineBackend):
    """Device-sharded tuning: the flattened problem axis in one contiguous
    chunk per entry of ``devices`` (default: every card of the host, or the
    caller's device when that is not a card).  The trial runs inline."""

    name = "sharded"

    def __init__(self, devices=None, **_):
        self.devices = None if devices is None else list(devices)
        self.used: Optional[int] = None

    def devices_for(self, device=None) -> List[torch.device]:
        if self.devices is not None:
            return [resolve_device(d) for d in self.devices]
        dev = resolve_device(device)
        if dev.type != "cuda":
            return [dev]
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]

    def solve(self, plan: TuningPlan, device=None,
              starts=None) -> Dict[Cell, object]:
        from ..core import build_results, solve_grid
        from ..core.designs import random_inits_many
        devices = self.devices_for(device)
        self.used = len(devices)

        def solve_flat(W_flat, rho_flat, robust) -> list:
            P = len(W_flat)
            if starts is None:     # the tuners' own draw, for all P at once
                gen = torch.Generator().manual_seed(int(plan.seed))
                base = random_inits_many(gen, P, plan.n_starts, plan.design,
                                         plan.sys)
            else:
                base = torch.as_tensor(np.array(starts, np.float32))
                base = base.expand((P,) + base.shape[1:])
            bounds = np.linspace(0, P, len(devices) + 1).round().astype(int)
            chunks = [solve_grid(W_flat[lo:hi], rho_flat[lo:hi], plan.design,
                                 plan.sys, plan.n_starts, plan.steps,
                                 plan.lr, robust, seed=plan.seed, device=dev,
                                 starts=base[lo:hi])
                      for dev, lo, hi in zip(devices, bounds[:-1],
                                             bounds[1:]) if hi > lo]
            out = tuple(torch.cat(parts) for parts in zip(*chunks))
            return build_results(out, plan.design, plan.sys)

        out: Dict[Cell, object] = {}
        n_w = len(plan.W)
        if plan.nominal:
            flat = solve_flat(np.asarray(plan.W, np.float32),
                              np.zeros(n_w, np.float32), robust=False)
            out.update({(i, None): r for i, r in enumerate(flat)})
        if plan.rhos:
            R = np.asarray(plan.rhos, np.float32)
            W_flat = np.repeat(np.asarray(plan.W, np.float32),
                               len(R), axis=0)
            rho_flat = np.tile(R, n_w)
            flat = solve_flat(W_flat, rho_flat, robust=True)
            for i in range(n_w):
                for j, rho in enumerate(plan.rhos):
                    out[(i, rho)] = flat[i * len(R) + j]
        return out

    def annotate(self, report: Report) -> None:
        if self.used is not None:
            report.walls["tuning_devices"] = self.used


# ---------------------------------------------------------------------------
# Subprocess fleet backend: workers, retries, re-sharding, resume
# ---------------------------------------------------------------------------

#: what a worker process runs: a fresh interpreter (exec, never fork: the
#: parent may hold a CUDA context), fed one pickled job on stdin
WORKER_CMD = ("-c", "from repro_torch.api.backends import _worker_main; "
              "_worker_main()")


class ShardFailure(RuntimeError):
    """One shard attempt failed; the message carries the phase (launch /
    timeout / exit code / result decode) and the worker's stderr tail."""


def _stderr_tail(data, limit: int = 2000) -> str:
    if not data:
        return "<no stderr>"
    if isinstance(data, bytes):
        data = data.decode("utf-8", "replace")
    return data[-limit:].strip()


def _worker_env() -> Dict[str, str]:
    import os
    import sys
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
    return env


def _worker_cmd() -> List[str]:
    import sys
    return [sys.executable, *WORKER_CMD]


def _inject_worker_fault(fault) -> None:
    """Execute a pre-launch worker fault (crash / hang / slow) inside the
    worker process.  Crash announces itself on stderr first — the parent's
    stderr capture is part of what the chaos suite verifies."""
    import os
    import sys
    from ..faults import HANG_SLEEP_S
    if fault.kind == "crash":
        print("InjectedWorkerCrash: deterministic chaos fault (kind=crash)",
              file=sys.stderr)
        sys.stderr.flush()
        os._exit(17)
    elif fault.kind == "hang":
        time.sleep(HANG_SLEEP_S)     # parent's per-shard timeout kills us
    elif fault.kind == "slow":
        time.sleep(fault.delay_s)


def _worker_main() -> None:
    """Entry point of one fleet-shard worker process (:data:`WORKER_CMD`).

    Reads a pickled ``(plan, builds, fault, device)`` job from stdin (the
    reference's 2-tuple ``(plan, builds)`` and 3-tuple with a fault are
    accepted too, and run on the card, the port's default), runs
    :func:`execute_trial` on ``device``, and writes the pickled result to
    stdout.  ``fault`` is the parent's resolved
    :class:`repro_torch.faults.FaultAction` for this (shard, attempt)
    coordinate — crash/hang/slow execute before the work, ``corrupt``
    truncates the result pickle after it.

    The result is the reference's ``(results, probes, populate_s,
    fleet_s)`` with one field added, internal to the port's processes: the
    worker's kernel launch counts (``kernels._build.LAUNCHES``, a dict), so
    the parent can add them to its own.  A worker asked for the card on a
    host with none raises, exits non-zero and leaves its traceback on
    stderr; it never runs on the CPU instead."""
    import pickle
    import sys
    from ..kernels import _build
    job = pickle.load(sys.stdin.buffer)
    plan, builds = job[0], job[1]
    fault = job[2] if len(job) > 2 else None
    device = job[3] if len(job) > 3 else None
    if fault is not None and fault.kind in ("crash", "hang", "slow"):
        _inject_worker_fault(fault)
    out = execute_trial(plan, builds, device=device)
    payload = pickle.dumps((*out, dict(_build.LAUNCHES)),
                           protocol=pickle.HIGHEST_PROTOCOL)
    if fault is not None and fault.kind == "corrupt":
        payload = payload[: max(1, len(payload) // 2)]
    sys.stdout.buffer.write(payload)
    sys.stdout.buffer.flush()


def _plan_digest(plan: TrialPlan) -> str:
    """A stable fingerprint of the trial plan, stamped into every persisted
    shard result so a resume never consumes results from a different
    experiment (pickle of the plan's plain-data fields is deterministic
    for equal content)."""
    import hashlib
    import pickle
    return hashlib.sha256(
        pickle.dumps(plan, protocol=4)).hexdigest()[:16]


def _job_tag(shard: List[int]) -> str:
    """The tag that ends a shard's job file name: a hash of its trees."""
    import hashlib
    return hashlib.sha256(",".join(map(str, shard)).encode()).hexdigest()[:12]


class SubprocessBackend(InlineBackend):
    """Fleet-trial sharding across worker processes, hardened against the
    faults :mod:`repro_torch.faults` can inject.

    The (tree x session) grid is partitioned by *key group* (trees sharing
    a key draw — and therefore materialized session plans — stay together),
    groups are assigned to workers largest-first, and each worker process
    runs the same :func:`execute_trial` the inline backend runs, on its
    shard, on the trial's device.  Workers are fresh ``python -c``
    interpreters (:data:`WORKER_CMD`, started with exec, never forked from
    a parent that may hold a CUDA context) fed pickles over stdin/stdout.
    On the card the parent builds the ``merge`` and ``point_read``
    libraries before the first round, so no worker starts its own
    ``nvcc``, and adds each accepted attempt's launch counts to its own
    ``kernels._build.LAUNCHES``.  A worker's start-up (``import torch``,
    its CUDA context) counts against ``timeout_s``.

    Recovery layers, in order (all deterministic — see
    :class:`repro_torch.faults.RetryPolicy`):

    * **per-attempt timeout** (``timeout_s``) — a hung worker is killed and
      the attempt failed, with whatever stderr it produced attached;
    * **bounded retries with seeded exponential backoff**
      (``max_retries`` / ``backoff_s`` / ``retry_seed``) — crashes,
      timeouts, and corrupt result pickles re-launch the same shard;
    * **elastic re-shard** (``reshard``) — a shard dead after every retry
      has its trees regrouped onto fresh worker slots
      (:class:`repro_torch.faults.ShardSupervisor`) and re-run once with a
      fresh retry budget;
    * **graceful degradation** — trees still unrecovered land in
      ``Report.failed_cells`` with their final error; the sweep completes.

    With ``run_dir`` set, every completed shard's per-tree results persist
    atomically (checksummed pickles, :func:`repro_torch.faults.dump_job`)
    as soon as that shard finishes, so a driver killed mid-sweep loses only
    in-flight shards; ``resume=True`` loads any valid persisted results for
    this exact plan (by digest) and executes only the remainder —
    ``python -m repro_torch.bench.run --spec ... --run-dir D --resume`` is
    the CLI."""

    name = "subprocess"

    def __init__(self, workers: int = 0, max_retries: int = 2,
                 backoff_s: float = 0.05, timeout_s: float = 900.0,
                 retry_seed: int = 0, reshard: bool = True,
                 run_dir: str = "", resume: bool = False, **_):
        import os
        self.workers = int(workers) or min(4, os.cpu_count() or 1)
        self.retry = RetryPolicy(max_retries=int(max_retries),
                                 backoff_s=float(backoff_s),
                                 timeout_s=float(timeout_s),
                                 seed=int(retry_seed))
        self.reshard = bool(reshard)
        self.run_dir = str(run_dir or "")
        self.resume = bool(resume)

    # -- sharding ----------------------------------------------------------

    def _partition(self, plan: TrialPlan) -> List[List[int]]:
        """Tree indices per shard.  Prefer keeping key groups together
        (trees sharing a draw also share materialized session plans):
        largest-group-first onto the emptiest shard.  With fewer groups
        than workers, split within groups instead — each worker re-draws
        the (seed-deterministic) keys, trading one redundant draw for
        tree-level parallelism."""
        by_group: Dict[int, List[int]] = {}
        for t, b in enumerate(plan.trees):
            by_group.setdefault(b.key_group, []).append(t)
        if len(by_group) >= self.workers:
            shards: List[List[int]] = [[] for _ in range(self.workers)]
            for members in sorted(by_group.values(), key=len, reverse=True):
                min(shards, key=len).extend(members)
        else:
            order = list(range(len(plan.trees)))
            shards = [order[i::self.workers] for i in range(self.workers)]
        return [s for s in shards if s]

    # -- one shard attempt -------------------------------------------------

    def _launch(self, cmd, env, plan: TrialPlan, shard: List[int],
                sid: int, attempt: int, faults, device: str):
        """One worker launch on ``device``; raises :class:`ShardFailure` on
        timeout, nonzero exit, or an undecodable/short result — always with
        the worker's stderr attached.  Returns ``(results, probes,
        populate_s, fleet_s, launches)``."""
        import pickle
        import subprocess
        fault = faults.worker_fault(sid, attempt) if faults else None
        if fault is not None and obs.enabled():
            # cross-reference: this attempt's outcome event carries the
            # same (shard, attempt) key as the injection that shaped it
            obs.event("shard.fault_injected", shard=sid, attempt=attempt,
                      fault=getattr(fault, "kind", None) or str(fault))
        job = pickle.dumps((plan, [plan.trees[t] for t in shard], fault,
                            device), protocol=pickle.HIGHEST_PROTOCOL)
        try:
            proc = subprocess.run(cmd, input=job, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, env=env,
                                  timeout=self.retry.timeout_s)
        except subprocess.TimeoutExpired as exc:
            raise ShardFailure(
                f"shard {sid} attempt {attempt}: no result within "
                f"timeout_s={self.retry.timeout_s:g} (hung worker killed); "
                f"stderr: {_stderr_tail(exc.stderr)}") from None
        if proc.returncode != 0:
            raise ShardFailure(
                f"shard {sid} attempt {attempt}: worker exited "
                f"{proc.returncode}; stderr: {_stderr_tail(proc.stderr)}")
        try:
            results, probes, p_s, f_s, launches = pickle.loads(proc.stdout)
            if len(results) != len(shard) or len(probes) != len(shard):
                raise ValueError(f"{len(results)} results for "
                                 f"{len(shard)} trees")
        except Exception as exc:
            raise ShardFailure(
                f"shard {sid} attempt {attempt}: corrupt result pickle "
                f"({type(exc).__name__}: {exc}); "
                f"stderr: {_stderr_tail(proc.stderr)}") from None
        return results, probes, p_s, f_s, launches

    def _job_path(self, digest: str, shard: List[int]) -> str:
        import os
        return os.path.join(self.run_dir,
                            f"job_{digest}_{_job_tag(shard)}.pkl")

    def _load_resumed(self, digest: str, n_trees: int) -> Dict[int, tuple]:
        """Per-tree results recovered from a previous (killed) sweep:
        every valid ``job_<digest>_*.pkl`` in the run dir whose plan digest
        matches.  Torn or corrupt files load as ``None`` and are simply
        re-executed — a checksum never trusts, it only skips work."""
        import glob
        import os
        from ..faults import load_job
        out: Dict[int, tuple] = {}
        if not (self.run_dir and os.path.isdir(self.run_dir)):
            return out
        for path in sorted(glob.glob(
                os.path.join(self.run_dir, f"job_{digest}_*.pkl"))):
            payload = load_job(path)
            if not isinstance(payload, dict) \
                    or payload.get("plan") != digest:
                continue
            for t, entry in payload.get("trees", {}).items():
                if isinstance(t, int) and 0 <= t < n_trees:
                    out[t] = entry
        return out

    def _persist(self, digest: str, shard: List[int], out, faults) -> int:
        """Atomically persist one completed shard's per-tree results (the
        reference's job format); returns 1 if the write failed (injected
        torn write / disk error) — the sweep itself continues, a later
        resume just re-runs the shard."""
        if not self.run_dir:
            return 0
        import os
        from ..faults import dump_job
        results, probes, p_s, f_s, _ = out
        os.makedirs(self.run_dir, exist_ok=True)
        try:
            dump_job(self._job_path(digest, shard),
                     {"plan": digest,
                      "trees": {t: (results[i], probes[i])
                                for i, t in enumerate(shard)},
                      "populate_s": p_s, "fleet_s": f_s},
                     fault=faults)
            return 0
        except OSError:
            return 1

    # -- the sweep ---------------------------------------------------------

    def run_trial(self, plan: TrialPlan, report: Report, faults=None,
                  device=None) -> None:
        if self.workers <= 1 or len(plan.trees) <= 1:
            return super().run_trial(plan, report, faults, device)
        import concurrent.futures
        from ..faults import FaultPlan, ShardSupervisor
        from ..kernels import _build

        faults = faults if faults is not None else FaultPlan(())
        sup = ShardSupervisor()
        digest = _plan_digest(plan)
        # not resolve_device: a card the host lacks is the workers' failure
        dev = torch.device("cuda" if device is None else device)

        shards = self._partition(plan)
        report.walls["trial_workers"] = len(shards)

        # -- resume: trust only checksum-valid results for this exact plan
        done: Dict[int, tuple] = \
            self._load_resumed(digest, len(plan.trees)) if self.resume else {}
        report.walls["resumed_trees"] = len(done)
        pending = [(sid, [t for t in s if t not in done])
                   for sid, s in enumerate(shards)]
        jobs = [(sid, s) for sid, s in pending if s]
        if jobs and dev.type == "cuda" and torch.cuda.is_available():
            _build.build(("merge", "point_read"))    # once, not per worker

        env = _worker_env()
        cmd = _worker_cmd()

        stats = {"attempts": 0, "persist_failures": 0, "shards_run": 0}
        walls = {"populate_s": 0.0, "fleet_s": 0.0}
        # Every attempt — including the ones a later success masks — is
        # recorded here and surfaced in the Report.  list.append is atomic,
        # so the pool threads share this without a lock.
        attempt_log: List[dict] = []

        def run_with_retries(job):
            """(sid, shard) -> (sid, shard, out-or-None, [errors]).
            Bounded retries with seeded backoff; persists on success so a
            killed driver keeps every completed shard.  Per-attempt
            latencies and outcomes land in ``attempt_log`` either way."""
            sid, shard = job
            errors: List[str] = []
            for attempt in range(self.retry.attempts()):
                if attempt:
                    time.sleep(self.retry.delay(sid, attempt))
                a_t0 = time.perf_counter()
                try:
                    out = self._launch(cmd, env, plan, shard, sid, attempt,
                                       faults, str(dev))
                except ShardFailure as exc:
                    latency = time.perf_counter() - a_t0
                    attempt_log.append({"shard": sid, "attempt": attempt,
                                        "ok": False,
                                        "latency_s": round(latency, 6)})
                    obs.count("shard.attempts")
                    obs.count("shard.failed_attempts")
                    if obs.enabled():
                        obs.event("shard.attempt", shard=sid,
                                  attempt=attempt, ok=False,
                                  latency_s=round(latency, 6),
                                  error=str(exc)[:200])
                    errors.append(str(exc))
                    continue
                latency = time.perf_counter() - a_t0
                attempt_log.append({"shard": sid, "attempt": attempt,
                                    "ok": True,
                                    "latency_s": round(latency, 6)})
                obs.count("shard.attempts")
                if obs.enabled():
                    obs.event("shard.attempt", shard=sid, attempt=attempt,
                              ok=True, latency_s=round(latency, 6))
                stats["persist_failures"] += \
                    self._persist(digest, shard, out, faults)
                return sid, shard, out, errors
            return sid, shard, None, errors

        def run_round(round_jobs):
            """Execute one round of shard jobs; returns the tree indices
            (with errors) that exhausted this round's retry budget."""
            if not round_jobs:
                return []
            stats["shards_run"] += len(round_jobs)
            with concurrent.futures.ThreadPoolExecutor(
                    len(round_jobs)) as pool:
                outs = list(pool.map(run_with_retries, round_jobs))
            lost: List[Tuple[int, str]] = []
            for sid, shard, out, errors in outs:
                for err in errors:
                    sup.record_failure(sid, err)
                stats["attempts"] += 1 + len(errors)
                if out is None:
                    sup.mark_dead(sid)
                    lost.extend((t, errors[-1]) for t in shard)
                    continue
                sup.mark_completed(sid)
                results, probes, p_s, f_s, launches = out
                for name, n in launches.items():
                    if name in _build.LAUNCHES:
                        _build.LAUNCHES[name] += n
                for i, t in enumerate(shard):
                    done[t] = (results[i], probes[i])
                # workers run in parallel: phase wall = slowest worker
                walls["populate_s"] = max(walls["populate_s"], p_s)
                walls["fleet_s"] = max(walls["fleet_s"], f_s)
            return lost

        lost = run_round(jobs)

        # -- elastic re-shard: dead workers' trees onto fresh slots, once.
        # With zero surviving shards the failure is systemic (the machine,
        # not the shard), so degrade instead of re-running everything
        # doomed.
        report.walls["reshard_trees"] = 0
        if lost and self.reshard and sup.completed:
            last_err = dict(lost)
            regrouped = sup.reassign([t for t, _ in lost], self.workers)
            report.walls["reshard_trees"] = len(last_err)
            obs.count("shard.reshards")
            if obs.enabled():
                obs.event("shard.reshard", trees=len(last_err),
                          new_shards=len(regrouped))
            next_sid = len(shards)
            lost = run_round([(next_sid + j, s)
                              for j, s in enumerate(regrouped)])

        # -- graceful degradation: explicit holes, not a crash
        for t, err in lost:
            b = plan.trees[t]
            report.failed_cells[(b.cell, b.policy)] = err

        for t, (res, probe) in done.items():
            b = plan.trees[t]
            report.fleet[(b.cell, b.policy)] = res
            report.probes[(b.cell, b.policy)] = probe

        report.walls["populate_s"] = walls["populate_s"]
        report.walls["fleet_s"] = walls["fleet_s"]
        report.walls["shards_run"] = stats["shards_run"]
        report.walls["shard_retries"] = sup.retries
        report.walls["failed_trees"] = len(report.failed_cells)
        if stats["persist_failures"]:
            report.walls["persist_failures"] = stats["persist_failures"]
        # per-attempt accounting (sorted: pool threads interleave appends)
        report.shard_attempts = sorted(
            attempt_log, key=lambda a: (a["shard"], a["attempt"]))
        report.walls["shard_attempt_count"] = len(attempt_log)
        obs.count("shard.resumed", report.walls["resumed_trees"])


class RemoteBackend(ExecutionBackend):
    """Cluster-scheduler stub.

    Registered so ``ExperimentSpec.backend = "remote"`` round-trips through
    JSON and ``get_backend`` like any real backend, and so the submission
    payload contract is pinned: :meth:`serialize_job` emits the versioned
    job envelope (the JAX package's text, byte for byte) a scheduler shim
    would ship to a worker that runs ``python -m repro_torch.bench.run
    --spec job-spec.json`` — the spec, a content checksum the worker
    validates before executing (a torn submission must be rejected, not
    run), and the retry/timeout policy the remote executor should apply.
    Execution itself is NOT implemented — every execution entry point
    raises rather than silently running locally, so a misconfigured
    deployment cannot masquerade as a cluster run."""

    name = "remote"
    #: bumped when the envelope shape changes; v2 added spec_checksum and
    #: the retry/timeout policy block.
    ENVELOPE_VERSION = 2
    _MSG = ("the 'remote' backend is a scheduling stub: it serializes the "
            "experiment (RemoteBackend.serialize_job(spec) -> JSON job "
            "envelope for `python -m repro_torch.bench.run --spec`) but "
            "cannot execute it in this process.  Submit the payload to your "
            "cluster scheduler, or pick "
            "backend='inline'/'sharded'/'subprocess' to run here.")

    def __init__(self, scheduler: str = "", queue: str = "",
                 max_retries: int = 2, backoff_s: float = 0.05,
                 timeout_s: float = 900.0, retry_seed: int = 0, **_):
        self.scheduler = scheduler
        self.queue = queue
        self.retry = RetryPolicy(max_retries=int(max_retries),
                                 backoff_s=float(backoff_s),
                                 timeout_s=float(timeout_s),
                                 seed=int(retry_seed))

    def serialize_job(self, spec) -> str:
        """The submission payload: a versioned envelope of the spec's JSON
        round-trip, its content checksum, and the retry/timeout policy the
        remote executor must honor."""
        import json
        from ..faults import stamp_checksum
        return json.dumps(stamp_checksum({
            "version": self.ENVELOPE_VERSION,
            "scheduler": self.scheduler,
            "queue": self.queue,
            "retry": {"max_retries": self.retry.max_retries,
                      "backoff_s": self.retry.backoff_s,
                      "timeout_s": self.retry.timeout_s,
                      "seed": self.retry.seed},
            "spec": spec.to_dict(),
        }), indent=1, sort_keys=True)

    @classmethod
    def deserialize_job(cls, text: str):
        """Validate + unpack an envelope: ``(ExperimentSpec, retry dict)``.
        Raises ``ValueError`` on a version mismatch or a checksum failure —
        a torn/tampered submission must never execute."""
        import json
        from ..faults import checksum_ok
        from .spec import ExperimentSpec
        env = json.loads(text)
        version = env.get("version") if isinstance(env, dict) else None
        if version != cls.ENVELOPE_VERSION:
            raise ValueError(f"unknown job envelope version {version!r}; "
                             f"expected {cls.ENVELOPE_VERSION}")
        if not checksum_ok(env):
            raise ValueError("job envelope checksum mismatch "
                             "(torn or tampered submission)")
        return ExperimentSpec.from_dict(env["spec"]), dict(env["retry"])

    def solve(self, plan: TuningPlan, device=None,
              starts=None) -> Dict[Cell, object]:
        raise NotImplementedError(self._MSG)

    def run_trial(self, plan: TrialPlan, report: Report, faults=None,
                  device=None) -> None:
        raise NotImplementedError(self._MSG)

    def run_drift(self, plan, report: Report, device=None,
                  starts=None) -> None:
        raise NotImplementedError(self._MSG)

    def run_memory(self, plan, report: Report, device=None,
                   starts=None) -> None:
        raise NotImplementedError(self._MSG)


BACKENDS = {
    "inline": InlineBackend,
    "sharded": ShardedBackend,
    "subprocess": SubprocessBackend,
    "remote": RemoteBackend,
}


def get_backend(name: str, params=()):
    try:
        cls = BACKENDS[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; "
                         f"known: {sorted(BACKENDS)}") from None
    return cls(**dict(params))
