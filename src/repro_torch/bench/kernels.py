"""Kernel-tier microbenchmarks: each hand-written kernel against its plain
version, at the committed shapes.

The port of ``benchmarks/bench_kernels.py``.  One row per kernel of the
data plane, each timed on the device it runs on (the card unless the
caller asks for the CPU, where the wrappers run the plain versions):

* ``kernels_point_read`` — the per-level batched point read (Bloom probe,
  fence window, per-run binary search) of ``csrc/point_read.cu`` against
  ``kernels/point_read/ref.py``, on the level of a populated engine that
  the JAX suite reads (the most runs, then the most entries: 12,288
  entries in 3 runs) with a batch of 512 keys, half of them present;
* ``kernels_dual_solve`` — the robust tuner's warm dual solve,
  ``csrc/dual_solve.cu`` against ``kernels/dual_solve/ref.py``, as a
  chain of 12 warm solves (one Adam step's re-solve each) over 1,024
  lanes of 64 costs;
* ``kernels_merge`` — the compaction fold of ``csrc/merge.cu`` against
  the plain two-way merge, over 40,000 entries in 3 newest-first runs.

The counts (probes, reads, false positives, entries, lanes, effective
bytes) are the engine's and the committed file's, bit for bit.  The
times are the port's own: ``us_kernel`` (the hand-written kernel, on the
card) and ``us_plain`` (its plain version on the same inputs), best of N
with the device synchronised; ``speedup_fused_vs_ref`` is their ratio.
``g_evals_ref`` and ``g_evals_fused`` are the g-evaluations a solve
takes before and after the JAX package's fusion (16 and 12 at
``n_local=3, n_golden=6``); the port's kernel and its plain version are
both the fused algorithm.  Effective bytes follow the JAX suite: filter
words probed, pages read and the batch for the point read; the cost
matrices for the solve; keys and values read and written for the merge.
``bench/roofline.py`` reuses :func:`measure_cells`.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from ..api import Row
from ..kernels._compat import resolve_device
from .common import own_starts

PR_BATCH = 512          # point-read query batch
DS_LANES = 1024         # dual-solve lane count
DS_COSTS = 64           # workloads per lane cost vector
DS_STEPS = 12           # chained warm solves per call
DS_LOCAL, DS_GOLDEN = 3, 6
MG_SIZES = (20_000, 15_000, 5_000)   # newest-first run lengths
REPEATS = 5


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _best_us(fn: Callable[[], object], dev: torch.device,
             warmup: int = 1) -> float:
    """Best of ``REPEATS`` wall times in microseconds, the device
    synchronised."""
    for _ in range(warmup):
        fn()
    _sync(dev)
    best = math.inf
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


def _point_read_fixture(dev):
    """A populated engine's level and a query batch (half present, half
    absent), drawn as the JAX suite draws them."""
    from ..lsm import EngineConfig, LSMTree
    from ..utils.u64 import to_device_keys
    tree = LSMTree(EngineConfig(T=4, K=(3, 3, 3), buf_entries=256,
                                expected_entries=30_000,
                                mfilt_bits_per_entry=8.0), device=dev)
    rng = np.random.default_rng(7)
    keys = rng.choice(1 << 40, 30_000, replace=False).astype(np.uint64)
    tree.put_batch(keys, [int(k) % 997 for k in keys])
    tree.flush()
    lv = max((lv for lv in tree.store.levels if lv.num_runs),
             key=lambda lv: (lv.num_runs, lv.entries))
    q = np.concatenate([
        rng.choice(keys, PR_BATCH // 2, replace=False),
        rng.choice(1 << 40, PR_BATCH - PR_BATCH // 2).astype(np.uint64),
    ]).astype(np.uint64)
    return tree, lv, to_device_keys(q, dev)


def _point_read_cell(dev) -> Dict[str, float]:
    from ..kernels.point_read.ops import point_read_level
    from ..kernels.point_read.ref import point_read_level_ref
    tree, lv, q = _point_read_fixture(dev)
    pack = lv.pack

    def kernel():
        return point_read_level(q, lv.keys, lv.vals, pack)

    def plain():
        return point_read_level_ref(q, lv.keys, lv.vals, pack.starts,
                                    pack.n_bits, pack.ks, pack.fence_lo,
                                    pack.fence_hi, pack.words,
                                    pack.word_off)

    us_kernel = _best_us(kernel, dev)
    us_plain = _best_us(plain, dev)
    _, _, probes, reads, fps = kernel()
    probes, reads, fps = (int(t.sum()) for t in (probes, reads, fps))
    k_mean = float(np.mean(pack.ks)) if len(pack.ks) else 0.0
    eff_bytes = 8 * q.shape[0] + probes * k_mean * 8 \
        + reads * tree.cfg.page_bytes
    return {"us_kernel": us_kernel, "us_plain": us_plain,
            "probes": probes, "reads": reads, "false_positives": fps,
            "runs": lv.num_runs, "level_entries": lv.entries,
            "batch": q.shape[0], "effective_bytes": eff_bytes,
            "achieved_gbps": eff_bytes / (us_kernel * 1e-6) / 1e9,
            "speedup_fused_vs_ref": us_plain / us_kernel}


def _dual_solve_cell(dev) -> Dict[str, float]:
    from ..kernels.dual_solve.ops import dual_solve_warm_batch
    from ..kernels.dual_solve.ref import dual_solve_warm_ref
    rng = np.random.default_rng(3)
    C = rng.gamma(2.0, 2.0, (DS_LANES, DS_COSTS)).astype(np.float32)
    W = rng.dirichlet(np.ones(DS_COSTS), DS_LANES).astype(np.float32)
    rho = np.full(DS_LANES, 0.25, np.float32)
    llam = np.log(C.max(1) - C.min(1)).astype(np.float32)
    Ct, Wt, rt, lt = (torch.from_numpy(a).to(dev)
                      for a in (C, W, rho, llam))

    def chain(solve):
        def call():
            ll = lt
            for _ in range(DS_STEPS):
                _, ll = solve(Ct, Wt, rt, ll, n_local=DS_LOCAL,
                              n_golden=DS_GOLDEN)[:2]
            return ll
        return call

    us_kernel = _best_us(chain(dual_solve_warm_batch), dev)
    us_plain = _best_us(chain(dual_solve_warm_ref), dev)
    eff_bytes = DS_STEPS * (C.nbytes + W.nbytes + rho.nbytes + llam.nbytes
                            + 2 * DS_LANES * 4)
    return {"us_kernel": us_kernel, "us_plain": us_plain,
            "lanes": DS_LANES, "costs_per_lane": DS_COSTS,
            "chain_steps": DS_STEPS,
            "g_evals_ref": DS_LOCAL + 2 * DS_GOLDEN + 1,
            "g_evals_fused": DS_LOCAL + 2 + DS_GOLDEN + 1,
            "effective_bytes": eff_bytes,
            "achieved_gbps": eff_bytes / (us_kernel * 1e-6) / 1e9,
            "speedup_fused_vs_ref": us_plain / us_kernel}


def _plain_merge(keys_list, vals_list):
    """The newest-first fold of ``kernels/merge/ops.py`` in plain ops."""
    from ..kernels.merge.ops import drop_adjacent_duplicates
    from ..kernels.merge.ref import two_way_merge_ref
    acc_k, acc_v = keys_list[0], vals_list[0]
    for k, v in zip(keys_list[1:], vals_list[1:]):
        acc_k, acc_v = drop_adjacent_duplicates(
            *two_way_merge_ref(acc_k, acc_v, k, v))
    return acc_k, acc_v


def _merge_cell(dev) -> Dict[str, float]:
    from ..kernels.merge.ops import merge_runs
    from ..utils.u64 import to_device_keys
    rng = np.random.default_rng(11)
    keys_list, vals_list = [], []
    for n in MG_SIZES:
        k = np.sort(rng.choice(1 << 40, n, replace=False).astype(np.uint64))
        keys_list.append(to_device_keys(k, dev))
        vals_list.append(torch.from_numpy(
            rng.integers(0, 1 << 30, n).astype(np.int64)).to(dev))
    us_kernel = _best_us(lambda: merge_runs(keys_list, vals_list), dev)
    us_plain = _best_us(lambda: _plain_merge(keys_list, vals_list), dev)
    n_total = sum(MG_SIZES)
    eff_bytes = 2 * n_total * 16        # read keys+vals, write keys+vals
    return {"us_kernel": us_kernel, "us_plain": us_plain,
            "entries": n_total, "runs": len(MG_SIZES),
            "effective_bytes": eff_bytes,
            "achieved_gbps": eff_bytes / (us_kernel * 1e-6) / 1e9}


#: cell name -> measurement fn; bench/roofline.py reuses this registry.
CELLS = {
    "point_read": _point_read_cell,
    "dual_solve": _dual_solve_cell,
    "merge": _merge_cell,
}


def measure_cells(device=None) -> Dict[str, Dict[str, float]]:
    """Run every kernel cell once on ``device`` (the card unless
    ``"cpu"``)."""
    dev = resolve_device(device)
    return {name: fn(dev) for name, fn in CELLS.items()}


def run(device=None, starts=own_starts) -> List[Row]:
    """The suite's rows.  It runs no tuner, so ``starts`` is unused."""
    return [Row(f"kernels_{name}", d["us_kernel"], **d)
            for name, d in measure_cells(device).items()]
