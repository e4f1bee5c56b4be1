"""Execute uncertainty-benchmark workload sessions against the LSM engine.

The port of ``repro/lsm/workload_runner.py`` (the paper's Section 9.2
experiment design): the database is initialized with N unique keys; each
session executes a sampled workload (z0, z1, q, w mix) for a fixed number
of queries, measuring average I/Os per query with compaction I/O amortized
over writes.

A session is *materialized* on the host first (:func:`materialize_session`,
the JAX package's numpy rng call sequence, so the same seed draws the same
queries) and then *executed* in flush windows (:func:`execute_session`):
each window's point reads are one ``classify_point_batch`` (one point-read
kernel launch per level), its range queries one ``range_query_batch``, its
writes one ``put_batch`` whose last insertion flushes (merge kernel
launches).  Window boundaries fall only at flushes, so every query sees the
tree state it would see in per-query execution and ``IOStats`` are exact.

:func:`run_fleet` runs a whole (tree x session) grid, materializing each
distinct session plan once and replaying it against every tree that shares
its key set; :func:`run_policy_fleet` builds that grid from tunings and
compaction policies.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .. import obs
from .engine import IOStats, LSMTree, TOMBSTONE
from .store import TOMB


@dataclasses.dataclass
class SessionResult:
    workload: np.ndarray
    queries: int
    avg_io_per_query: float
    io: IOStats
    #: per-flush-window observed op counts, shape (n_windows, 4) int64 in
    #: (z0, z1, q, w) order; the rows sum to the session plan's op counts
    window_ops: Optional[np.ndarray] = None

    @property
    def throughput(self) -> float:
        return 1.0 / max(self.avg_io_per_query, 1e-9)

    @property
    def observed_mix(self) -> np.ndarray:
        """The session's executed (z0, z1, q, w) mix, from the counters."""
        c = self.window_ops.sum(axis=0).astype(np.float64)
        return c / max(c.sum(), 1.0)


@dataclasses.dataclass
class SessionPlan:
    """A fully-materialized workload session: query kinds in stream order
    plus the per-kind argument arrays, consumed in order by the executor."""

    workload: np.ndarray       # normalized (z0, z1, q, w)
    kinds: np.ndarray          # (n_queries,) 0=z0 1=z1 2=q 3=w
    point_keys: np.ndarray     # uint64, one per kind-0/1 query, stream order
    range_los: np.ndarray      # uint64, one per kind-2 query
    range_his: np.ndarray
    write_keys: np.ndarray     # uint64, one per kind-3 query
    #: optional per-write delete mask (True: a tombstone for an existing
    #: key); None means every write is a fresh insert
    write_tombs: Optional[np.ndarray] = None

    @property
    def n_queries(self) -> int:
        return len(self.kinds)

    @property
    def insert_keys(self) -> np.ndarray:
        """Fresh-key inserts only (delete targets excluded): the keys a
        caller appends to its live-key population after the session."""
        if self.write_tombs is None:
            return self.write_keys
        return self.write_keys[~self.write_tombs]


def draw_keys(n: int, seed: int = 7, key_space: int = 2 ** 48) -> np.ndarray:
    """The population key draw, exposed so several trees share one draw."""
    rng = np.random.default_rng(seed)
    return rng.choice(key_space, size=n, replace=False).astype(np.uint64)


def populate(tree: LSMTree, n: int, seed: int = 7,
             key_space: int = 2 ** 48,
             keys: Optional[np.ndarray] = None) -> np.ndarray:
    """Insert n unique random keys; returns the key array (for z1 queries).

    Keys go in via :meth:`LSMTree.put_batch` in buffer-sized chunks, each
    flushed as a sorted run to the tree's device.  Pass ``keys`` (from
    :func:`draw_keys`) to skip the draw when several trees share one."""
    if keys is None:
        keys = draw_keys(n, seed=seed, key_space=key_space)
    values = (keys % np.uint64(997)).astype(np.int64)
    tree.put_batch(keys, values)
    tree.flush()
    # Population writes/compactions are setup cost, not workload cost.
    tree.stats = IOStats()
    return keys


def materialize_session(existing_keys: np.ndarray, w: np.ndarray,
                        n_queries: int = 2000, seed: int = 0,
                        key_space: int = 2 ** 48,
                        range_fraction: float = 2e-5,
                        zipf_a: Optional[float] = None,
                        hot_offset: int = 0,
                        delete_fraction: float = 0.0) -> SessionPlan:
    """Draw every query of a session up front, with the JAX package's exact
    rng call sequence (kinds, then the fresh-key block, then one draw per
    read/range query in stream order, then the optional delete retarget),
    so a seed gives the same plan in both packages.  Non-empty reads sample
    existing keys (optionally Zipfian-ranked, the rank->key mapping rotated
    by ``hot_offset``: a post-draw modular shift, so the rng sequence is
    untouched); empty reads miss; range queries use a small span; writes
    insert fresh keys, a ``delete_fraction`` of them retargeted as
    tombstones for the oldest live keys."""
    rng = np.random.default_rng(seed)
    w = np.asarray(w, np.float64)
    w = w / w.sum()
    kinds = rng.choice(4, size=n_queries, p=w)
    span = max(1, int(range_fraction * key_space))
    existing = np.asarray(existing_keys, np.uint64)
    n_writes = int((kinds == 3).sum())
    fresh = rng.choice(key_space, size=max(n_writes, 1) + 8,
                       replace=False).astype(np.uint64)
    point_keys: List[int] = []
    range_los: List[int] = []
    range_his: List[int] = []
    for kind in kinds:
        if kind == 0:        # empty point read: perturb to near-certain miss
            point_keys.append(int(rng.integers(0, key_space)) | (1 << 60))
        elif kind == 1:      # non-empty point read
            if zipf_a is not None:
                idx = min(len(existing) - 1, rng.zipf(zipf_a) - 1)
            else:
                idx = int(rng.integers(0, len(existing)))
            if hot_offset:
                idx = (idx + int(hot_offset)) % len(existing)
            point_keys.append(int(existing[idx]))
        elif kind == 2:      # short range query
            lo = int(rng.integers(0, key_space - span))
            range_los.append(lo)
            range_his.append(lo + span)
    write_keys = fresh[:n_writes]
    write_tombs = None
    if delete_fraction > 0.0 and n_writes and len(existing):
        pool = max(1, len(existing) // 2)    # the oldest half of the keys
        n_del = min(int(round(delete_fraction * n_writes)), n_writes, pool)
        if n_del > 0:
            slots = np.sort(rng.choice(n_writes, size=n_del, replace=False))
            targets = np.sort(rng.choice(pool, size=n_del, replace=False))
            write_keys = write_keys.copy()
            write_keys[slots] = existing[targets]
            write_tombs = np.zeros(n_writes, bool)
            write_tombs[slots] = True
    return SessionPlan(workload=w, kinds=kinds,
                       point_keys=np.asarray(point_keys, np.uint64),
                       range_los=np.asarray(range_los, np.uint64),
                       range_his=np.asarray(range_his, np.uint64),
                       write_keys=write_keys,
                       write_tombs=write_tombs)


def _resolve_against_pending(tree: LSMTree, read_keys: np.ndarray,
                             read_pos: np.ndarray, write_keys: np.ndarray,
                             write_pos: np.ndarray, write_encs):
    """Per-read resolution against the evolving write buffer of a window
    (host side): a read at stream position p sees the buffer as it was at
    window start plus every window write at a position < p, newest wins.
    ``write_encs`` is the per-write encoded value (a scalar broadcasts)."""
    n = len(read_keys)
    resolved = np.zeros(n, bool)
    found = np.zeros(n, bool)
    enc = np.zeros(n, np.int64)
    if tree.buffer:
        bkeys, benc = tree._buffer_sorted()
        hit, henc = LSMTree.resolve_in_sorted(bkeys, benc, read_keys)
        if hit.any():
            resolved |= hit
            found[hit] = henc != TOMB
            enc[hit] = henc
    if len(write_keys):
        wenc = np.broadcast_to(np.asarray(write_encs, np.int64),
                               write_keys.shape)
        order = np.argsort(write_keys, kind="stable")  # pos ascending in ties
        wks = write_keys[order]
        wps = write_pos[order]
        wes = wenc[order]
        lo = np.searchsorted(wks, read_keys, side="left")
        hi = np.searchsorted(wks, read_keys, side="right")
        for i in np.flatnonzero(hi > lo):
            j = int(np.searchsorted(wps[lo[i]:hi[i]], read_pos[i]))
            if j > 0:
                e = int(wes[lo[i] + j - 1])    # latest write before the read
                resolved[i] = True
                found[i] = e != TOMB
                enc[i] = e
    return resolved, found, enc


def execute_session(tree: LSMTree, plan: SessionPlan,
                    f_a: float = 1.0, f_seq: float = 1.0) -> SessionResult:
    """Execute a materialized session in flush windows (see module
    docstring); measured ``IOStats`` equal per-query execution's."""
    with obs.track(tree.obs_label), obs.span("session.execute") as sp:
        return _execute_session(tree, plan, f_a, f_seq, sp)


def _execute_session(tree: LSMTree, plan: SessionPlan, f_a: float,
                     f_seq: float, sp) -> SessionResult:
    before = tree.stats.snapshot()
    kinds = plan.kinds
    n = len(kinds)
    pos = np.arange(n)
    pt_pos = pos[kinds <= 1]
    rq_pos = pos[kinds == 2]
    wr_pos = pos[kinds == 3]
    cap = tree.cfg.buf_entries
    write_enc = tree.store.codec.encode(1)    # sessions write value 1
    tombs = plan.write_tombs
    write_encs_all = None
    if tombs is not None:
        write_encs_all = np.where(tombs, TOMB, write_enc).astype(np.int64)
    pi = qi = wi = 0
    n_wr = len(wr_pos)
    win_start = 0
    win_counts: List[np.ndarray] = []
    while pi < len(pt_pos) or qi < len(rq_pos) or wi < n_wr:
        # -- window extent: writes until the buffer reaches capacity --------
        if wi < n_wr:
            w_rem = plan.write_keys[wi:]
            room = cap - len(tree.buffer)
            if tree.buffer:
                buf_keys = np.fromiter(tree.buffer.keys(), np.uint64,
                                       len(tree.buffer))
                fresh = ~np.isin(w_rem, buf_keys)   # dups don't grow the buffer
            else:
                fresh = np.ones(len(w_rem), bool)
            cut = int(np.searchsorted(np.cumsum(fresh), room))
            if cut < len(w_rem):
                m = cut + 1
                win_end = int(wr_pos[wi + m - 1])   # flush fires at this put
            else:
                m = len(w_rem)
                win_end = n
        else:
            m = 0
            win_end = n
        # -- observed op mix of the window ----------------------------------
        boundary = win_end + 1 if win_end < n else n
        win_counts.append(np.bincount(kinds[win_start:boundary],
                                      minlength=4).astype(np.int64))
        if obs.enabled():
            obs.event("session.window", index=len(win_counts) - 1,
                      ops=win_counts[-1].tolist())
        win_start = boundary
        # -- reads of the window, against pre-flush levels ------------------
        pt_hi = int(np.searchsorted(pt_pos, win_end))
        if pt_hi > pi:
            rk = plan.point_keys[pi:pt_hi]
            pend_enc = write_enc if write_encs_all is None \
                else write_encs_all[wi:wi + m]
            resolved, found, enc = _resolve_against_pending(
                tree, rk, pt_pos[pi:pt_hi], plan.write_keys[wi:wi + m],
                wr_pos[wi:wi + m], pend_enc)
            tree.classify_point_batch(rk, resolved=resolved, found=found,
                                      enc=enc, use_buffer=False)
            pi = pt_hi
        rq_hi = int(np.searchsorted(rq_pos, win_end))
        if rq_hi > qi:
            tree.range_query_batch(plan.range_los[qi:rq_hi],
                                   plan.range_his[qi:rq_hi])
            qi = rq_hi
        # -- the window's writes (put_batch flushes at the boundary) --------
        if m:
            tslice = tombs[wi:wi + m] if tombs is not None else None
            if tslice is not None and tslice.any():
                vals = np.empty(m, object)
                vals[:] = 1
                for j in np.flatnonzero(tslice):
                    vals[j] = TOMBSTONE
                tree.put_batch(plan.write_keys[wi:wi + m], vals)
            else:
                tree.put_batch(plan.write_keys[wi:wi + m],
                               np.ones(m, np.int64))
            wi += m
    delta = tree.stats.minus(before)
    reads_io = delta.random_reads + f_seq * delta.seq_reads
    write_io = f_seq * (delta.comp_pages_read + f_a * delta.comp_pages_written)
    avg = (reads_io + write_io) / max(n, 1)
    window_ops = np.stack(win_counts) if win_counts \
        else np.zeros((0, 4), np.int64)
    result = SessionResult(workload=plan.workload, queries=n,
                           avg_io_per_query=avg, io=delta,
                           window_ops=window_ops)
    if sp:
        sp.set(label=tree.obs_label, queries=n, windows=len(win_counts),
               avg_io=round(float(avg), 9),
               mix=[round(float(x), 9) for x in result.observed_mix],
               io=delta.as_dict())
        obs.count("session.executed")
        obs.count("session.windows", len(win_counts))
    return result


def run_session(tree: LSMTree, existing_keys: np.ndarray, w: np.ndarray,
                n_queries: int = 2000, seed: int = 0,
                key_space: int = 2 ** 48,
                range_fraction: float = 2e-5,
                f_a: float = 1.0, f_seq: float = 1.0,
                zipf_a: Optional[float] = None) -> SessionResult:
    """Run one workload session; returns measured avg I/O per query."""
    plan = materialize_session(existing_keys, w, n_queries=n_queries,
                               seed=seed, key_space=key_space,
                               range_fraction=range_fraction, zipf_a=zipf_a)
    return execute_session(tree, plan, f_a=f_a, f_seq=f_seq)


def run_fleet(trees: Sequence[LSMTree], sessions, existing_keys,
              n_queries: int = 2000, seeds=None, key_space: int = 2 ** 48,
              range_fraction: float = 2e-5, f_a: float = 1.0,
              f_seq: float = 1.0, zipf_a: Optional[float] = None
              ) -> List[List[SessionResult]]:
    """Run the full (tree x session) grid; returns ``results[tree][sess]``.

    ``sessions`` is an (S, 4) array of workload mixes.  ``existing_keys``
    is one key array shared by every tree or a per-tree list; ``seeds`` is
    the per-(tree, session) seed matrix (an (S,) vector is broadcast to all
    trees).  Trees that share a key array and a seed row share one
    materialized :class:`SessionPlan` per session."""
    sessions = np.atleast_2d(np.asarray(sessions, np.float64))
    n_trees, n_sess = len(trees), sessions.shape[0]
    if isinstance(existing_keys, np.ndarray):
        keys_list = [existing_keys] * n_trees
    else:
        keys_list = list(existing_keys)
        if len(keys_list) != n_trees:
            raise ValueError(f"{len(keys_list)} key arrays for "
                             f"{n_trees} trees")
    seeds = np.arange(n_sess) if seeds is None else np.asarray(seeds)
    if seeds.ndim == 1:
        seeds = np.broadcast_to(seeds, (n_trees, n_sess))
    plans: dict = {}
    out: List[List[SessionResult]] = []
    for t, tree in enumerate(trees):
        row: List[SessionResult] = []
        for s in range(n_sess):
            cache_key = (id(keys_list[t]), int(seeds[t, s]), s)
            plan = plans.get(cache_key)
            if plan is None:
                plan = materialize_session(
                    keys_list[t], sessions[s], n_queries=n_queries,
                    seed=int(seeds[t, s]), key_space=key_space,
                    range_fraction=range_fraction, zipf_a=zipf_a)
                plans[cache_key] = plan
            row.append(execute_session(tree, plan, f_a=f_a, f_seq=f_seq))
        out.append(row)
    return out


def run_policy_fleet(phis, sys, policies, sessions, n_keys: int,
                     n_queries: int = 2000, seed: int = 7,
                     key_space: int = 2 ** 48, range_fraction: float = 2e-5,
                     policy_params=None, entry_bytes: int = 64,
                     f_a: float = 1.0, f_seq: float = 1.0, seeds=None,
                     zipf_a: Optional[float] = None, device=None):
    """The (tuning x compaction-policy x session) grid in one fleet call.

    Builds one tree per (phi, policy) cell on ``device`` (the card unless
    ``device="cpu"``) — ``phis`` are tuner outputs, ``policies`` names from
    :data:`repro_torch.lsm.planner.POLICIES`, ``policy_params`` an optional
    per-policy dict of constructor kwargs — populates every tree from ONE
    shared key draw, and runs every session against every tree via
    :func:`run_fleet`.  Returns ``(trees, results)``, both indexed
    ``[phi][policy]``; ``results[p][j][s]`` is tuning ``p`` under policy
    ``policies[j]`` on session ``s``."""
    try:
        phis = list(phis)
    except TypeError:
        phis = [phis]
    policy_params = policy_params or {}
    keys = draw_keys(n_keys, seed=seed, key_space=key_space)
    trees: List[List[LSMTree]] = []
    for phi in phis:
        row = []
        for pol in policies:
            params = tuple(sorted(policy_params.get(pol, {}).items()))
            tree = LSMTree.from_phi(phi, sys, expected_entries=n_keys,
                                    entry_bytes=entry_bytes, policy=pol,
                                    policy_params=params, device=device)
            populate(tree, n_keys, key_space=key_space, keys=keys)
            row.append(tree)
        trees.append(row)
    flat = [t for row in trees for t in row]
    results_flat = run_fleet(flat, sessions, keys, n_queries=n_queries,
                             seeds=seeds, key_space=key_space,
                             range_fraction=range_fraction, f_a=f_a,
                             f_seq=f_seq, zipf_a=zipf_a)
    n_pol = len(policies)
    results = [results_flat[i * n_pol:(i + 1) * n_pol]
               for i in range(len(phis))]
    return trees, results


def measured_cost_vector(tree_factory, n_keys: int, n_queries: int = 2000,
                         seed: int = 0) -> np.ndarray:
    """Measure per-class I/O costs (z0, z1, q, w) with pure sessions, one
    fresh tree from ``tree_factory`` each (its device is the factory's), to
    validate the analytic cost vector c(Phi) component-wise."""
    out = []
    pure = np.eye(4) * 0.97 + 0.01
    for i in range(4):
        tree = tree_factory()
        keys = populate(tree, n_keys, seed=seed)
        res = run_session(tree, keys, pure[i], n_queries=n_queries,
                          seed=seed + i)
        out.append(res.avg_io_per_query)
    return np.asarray(out)
