"""ENDURE-tuned LSM manifests and the storm-batched re-tune path: the tuning
half of ``repro/checkpoint/store.py``.

The framework derives an expected storage workload mix from a run's
behaviour (checkpoint writes vs. restore reads vs. manifest scans) and an
uncertainty radius rho, and deploys the robust tuner's output through
``LSMTree.from_phi``.  Every re-tune in the port goes through one batched
path, :func:`retune_storm`: the online drift loop's triggers
(:mod:`repro_torch.online.retune`) and a fleet of manifests re-deriving
their tunings alike.

``CheckpointStore`` — tensor shards written as ``.npy`` files with their
metadata in a tuned manifest tree, restored elastically — saves a trainer's
state; it waits for the trainer it serves (ROADMAP.md queue 6: the rest of
the LM tier).
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Sequence

import numpy as np

from .. import obs
from ..core import LSMSystem, tune_robust_many
from ..lsm import LSMTree


def _key_of(name: str) -> int:
    """Manifest keys are uint64 hashes of the logical name."""
    return int.from_bytes(hashlib.blake2b(name.encode(),
                                          digest_size=8).digest(), "big")


def framework_storage_workload(ckpt_interval: int, restore_prob: float,
                               scan_frac: float = 0.05) -> np.ndarray:
    """Map run behaviour to the paper's (z0, z1, q, w) workload vector.

    writes  ~ manifest puts per checkpoint; z1 ~ restores + lookups;
    z0 ~ existence probes of absent steps; q ~ manifest scans (listing)."""
    w_write = 1.0 / max(ckpt_interval, 1) * 20
    z1 = 0.2 + restore_prob
    z0 = 0.1
    q = scan_frac
    v = np.array([z0, z1, q, w_write], np.float64)
    return v / v.sum()


def retune_storm(workloads, rhos, sys, seed: int = 0, design=None,
                 n_starts: int = 64, steps: int = 250, lr: float = 0.25,
                 pad_pow2: bool = False, device=None, starts=None) -> list:
    """One batched tuner dispatch for a fleet-wide re-tuning storm.

    A batch of (workload, rho) re-tune requests becomes ONE
    ``tune_robust_many`` grid (workloads on one axis, the distinct positive
    rhos on the other, each request picking its cell) plus one
    ``tune_nominal_many`` batch for the ``rho <= 0`` requests, instead of a
    per-request ``tune_robust`` loop.

    ``pad_pow2`` pads the workload axis to the next power of two with
    repeats of the last row (dropped from the result), so storm sizes fall
    in O(log fleet) lane-batch shapes.  The lanes are independent, so
    padding never changes the surviving results.  ``device`` is where the
    storm runs (``None``: the card); ``starts`` (``(1, n_starts, n_params)``
    or None for the tuners' own draw from ``seed``) seeds every lane.

    Returns one :class:`repro_torch.core.TuningResult` per request, in
    order."""
    W = np.atleast_2d(np.asarray(workloads, np.float64))
    R = np.asarray(rhos, np.float64).reshape(-1)
    if len(W) != len(R):
        raise ValueError(f"{len(W)} workloads for {len(R)} rhos")
    obs.count("tuner.storms")
    obs.count("tuner.storm_requests", len(W))
    with obs.span("tuner.storm", requests=len(W), pad_pow2=bool(pad_pow2)):
        return _retune_storm(W, R, sys, seed, design, n_starts, steps, lr,
                             pad_pow2, device, starts)


def _retune_storm(W, R, sys, seed, design, n_starts, steps, lr,
                  pad_pow2, device, starts) -> list:
    from ..core import tune_nominal_many
    kw = dict(n_starts=n_starts, steps=steps, lr=lr, seed=seed,
              device=device, starts=starts)
    if design is not None:
        kw["design"] = design

    def padded(M: np.ndarray) -> np.ndarray:
        if not pad_pow2 or len(M) < 2:
            return M
        P = 1 << (len(M) - 1).bit_length()
        return np.concatenate([M, np.repeat(M[-1:], P - len(M), axis=0)])

    out: list = [None] * len(W)
    nom = np.flatnonzero(R <= 0)
    if nom.size:
        res = tune_nominal_many(padded(W[nom]), sys, **kw)
        for i, r in zip(nom, res):
            out[i] = r
    rob = np.flatnonzero(R > 0)
    if rob.size:
        uniq = sorted(set(float(r) for r in R[rob]))
        grid = tune_robust_many(padded(W[rob]), uniq, sys, **kw)
        for row, i in zip(grid, rob):
            out[i] = row[uniq.index(float(R[i]))]
    return out


def tuned_manifest_trees(specs: Sequence[Dict[str, Any]], seed: int = 0,
                         device=None) -> list:
    """Deploy ENDURE-tuned manifests for a whole fleet in ONE tuner dispatch
    per distinct store size.

    ``specs`` is a sequence of dicts with the :func:`tuned_manifest_tree`
    keywords (``expected_entries``, ``ckpt_interval``, ``restore_prob``,
    ``rho``); their tunings go through :func:`retune_storm` (one batched
    grid per distinct store size), and each tree is deployed on
    ``device``."""
    trees: list = [None] * len(specs)
    by_n: Dict[int, list] = {}
    for i, spec in enumerate(specs):
        by_n.setdefault(int(spec.get("expected_entries", 50_000)),
                        []).append(i)
    for n_entries, idxs in by_n.items():
        sys_small = LSMSystem(N=float(n_entries), entry_bits=256 * 8,
                              page_bits=4096 * 8, bits_per_entry=16.0,
                              min_buf_bits=256 * 8 * 64, s_rq=2e-5)
        W = [framework_storage_workload(
            specs[i].get("ckpt_interval", 100),
            specs[i].get("restore_prob", 0.3)) for i in idxs]
        rhos = [float(specs[i].get("rho", 1.0)) for i in idxs]
        tunings = retune_storm(np.stack(W), rhos, sys_small, seed=seed,
                               device=device)
        for i, tuning in zip(idxs, tunings):
            trees[i] = LSMTree.from_phi(tuning.phi, sys_small,
                                        expected_entries=n_entries,
                                        entry_bytes=256, device=device)
    return trees


def tuned_manifest_tree(expected_entries: int = 50_000,
                        ckpt_interval: int = 100,
                        restore_prob: float = 0.3,
                        rho: float = 1.0,
                        seed: int = 0, device=None) -> LSMTree:
    """An LSM manifest whose (T, K, memory split) comes from ENDURE."""
    return tuned_manifest_trees([dict(expected_entries=expected_entries,
                                      ckpt_interval=ckpt_interval,
                                      restore_prob=restore_prob, rho=rho)],
                                seed=seed, device=device)[0]
