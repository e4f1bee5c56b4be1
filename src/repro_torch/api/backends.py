"""Pluggable execution backends: the *where/how* axis of an experiment.

The port of ``repro/api/backends.py``.  A backend executes a compiled
experiment's two heavy phases — the batched tuning grid and the engine
fleet trial — without changing their semantics:

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

The ``subprocess`` and ``remote`` backends of the JAX package are not
ported yet: :func:`get_backend` refuses them (ROADMAP.md queue 5).

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


def _not_ported(name: str):
    def refuse(**_):
        raise NotImplementedError(
            f"the {name!r} backend is not ported yet (ROADMAP.md queue 5: "
            "faults, the other backends, and obs)")
    return refuse


BACKENDS = {
    "inline": InlineBackend,
    "sharded": ShardedBackend,
    "subprocess": _not_ported("subprocess"),
    "remote": _not_ported("remote"),
}


def get_backend(name: str, params=()):
    try:
        cls = BACKENDS[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; "
                         f"known: {sorted(BACKENDS)}") from None
    return cls(**dict(params))
