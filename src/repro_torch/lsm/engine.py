"""An executable LSM-tree key-value engine with K-LSM compaction semantics.

The port of ``repro/lsm/engine.py``: the same memtable, immutable sorted
runs, Monkey Bloom filters, fence keys and K_i-parameterized compaction,
with the same exact logical-I/O accounting, but the runs live on a torch
device.

* **Storage** (:mod:`repro_torch.lsm.store`) keeps each level's runs as
  device arenas of ordered int64 keys (``utils/u64.py``) and encoded int64
  values, plus host-side metadata (run offsets, fences, Bloom parameters,
  flush lineage) for the planner.
* **Policy** (:mod:`repro_torch.lsm.planner`) is the JAX package's planner,
  host logic reading that metadata.
* **Execution** is this module: the plan-execute-replan write loop, every
  merge through the merge kernel, and the batched reads — one point-read
  kernel launch per non-empty level per read batch, and range queries as
  device ``searchsorted`` calls per run.

The memtable is a host dict, as in the JAX package; a flush sorts it on the
host and uploads one run.  Per read batch the engine syncs with the device
once per visited level (to size the still-unresolved key set) and once at
the end (answers and I/O counters).

Keys at the API are Python ints or uint64 arrays in ``[0, 2**64)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..kernels._compat import resolve_device
from ..utils.u64 import order_keys, to_device_keys
from .bloom import monkey_bits_per_key
from .planner import make_planner
from .read_path import point_read_level
from .store import TOMB, RunData, RunStore, pages_of

TOMBSTONE = object()


@dataclasses.dataclass
class IOStats:
    random_reads: int = 0        # random page reads (point lookups, seeks)
    seq_reads: int = 0           # sequential page reads (range scans)
    comp_pages_read: int = 0     # compaction input pages (sequential)
    comp_pages_written: int = 0  # compaction/flush output pages (sequential)
    bloom_probes: int = 0
    bloom_false_positives: int = 0
    queries: dict = dataclasses.field(
        default_factory=lambda: {"z0": 0, "z1": 0, "q": 0, "w": 0})

    def snapshot(self) -> "IOStats":
        return dataclasses.replace(self, queries=dict(self.queries))

    def minus(self, other: "IOStats") -> "IOStats":
        return IOStats(
            random_reads=self.random_reads - other.random_reads,
            seq_reads=self.seq_reads - other.seq_reads,
            comp_pages_read=self.comp_pages_read - other.comp_pages_read,
            comp_pages_written=self.comp_pages_written - other.comp_pages_written,
            bloom_probes=self.bloom_probes - other.bloom_probes,
            bloom_false_positives=self.bloom_false_positives
            - other.bloom_false_positives,
            queries={k: self.queries[k] - other.queries[k]
                     for k in self.queries},
        )

    def as_dict(self) -> dict:
        """Plain-dict view (telemetry span attributes, JSON sinks)."""
        return {
            "random_reads": self.random_reads,
            "seq_reads": self.seq_reads,
            "comp_pages_read": self.comp_pages_read,
            "comp_pages_written": self.comp_pages_written,
            "bloom_probes": self.bloom_probes,
            "bloom_false_positives": self.bloom_false_positives,
            "queries": dict(self.queries),
        }

    def io_per_query(self, f_a: float = 1.0, f_seq: float = 1.0) -> dict:
        """Measured average logical I/O per query class, write-amortized the
        way the paper does (compaction I/O redistributed over writes)."""
        n = self.queries
        reads = max(n["z0"] + n["z1"] + n["q"], 1)
        out = {}
        out["read_io"] = (self.random_reads + f_seq * self.seq_reads) / reads
        writes = max(n["w"], 1)
        out["write_io"] = (f_seq * (self.comp_pages_read
                                    + f_a * self.comp_pages_written)) / writes
        return out


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    T: int = 4
    K: Tuple[int, ...] = ()            # per-level caps; empty -> leveling
    buf_entries: int = 1024            # memtable capacity (entries)
    entry_bytes: int = 64
    page_bytes: int = 4096
    mfilt_bits_per_entry: float = 10.0  # Monkey budget, bits per *total* entry
    expected_entries: int = 200_000     # N used for Monkey allocation + L
    #: compaction policy name (see planner.POLICIES) + its constructor
    #: params as (name, value) pairs (a tuple, so the config stays hashable)
    policy: str = "klsm"
    policy_params: Tuple[Tuple[str, Any], ...] = ()

    @property
    def entries_per_page(self) -> int:
        return max(1, self.page_bytes // self.entry_bytes)

    def k_at(self, level: int) -> int:
        """1-indexed level -> K_i, clamped to [1, T-1]."""
        if level - 1 < len(self.K):
            k = self.K[level - 1]
        elif len(self.K) > 0:
            k = self.K[-1]
        else:
            k = 1
        return int(max(1, min(k, self.T - 1)))

    @property
    def est_levels(self) -> int:
        ratio = self.expected_entries / self.buf_entries
        return max(1, int(math.ceil(math.log(ratio + 1, self.T))))


class LSMTree:
    """The engine.  Keys: ints (uint64 range); values: arbitrary objects.
    Runs live on ``device`` (the card unless ``device="cpu"``)."""

    def __init__(self, config: EngineConfig, device=None):
        self.cfg = config
        self.device = resolve_device(device)
        self.buffer: dict = {}           # int key -> int64-encoded value
        self.store = RunStore(config.entries_per_page, self.device)
        self.planner = make_planner(config)
        self.stats = IOStats()
        self.flush_seq = 0               # logical clock: flushes so far
        self.obs_label = ""
        #: intern-table sweep threshold (doubling schedule)
        self._intern_sweep_at = 64

    # -- construction from a tuning -------------------------------------

    @staticmethod
    def config_from_phi(phi, sys, expected_entries: int,
                        buf_entries: Optional[int] = None,
                        entry_bytes: int = 64, page_bytes: int = 4096,
                        policy: str = "klsm",
                        policy_params: Tuple[Tuple[str, Any], ...] = ()
                        ) -> EngineConfig:
        """Lower a tuner-recommended Phi to an :class:`EngineConfig` at
        reduced scale: the shape of the tuning (T, K profile, filter
        bits/entry) carries over; N and the buffer scale with the memory
        split preserved as bits-per-entry."""
        T = int(float(phi.T))
        K = tuple(int(k) for k in torch.as_tensor(phi.K).tolist())
        m_total_bpe = sys.bits_per_entry
        filt_bpe = float(phi.mfilt_bits) / sys.N
        if filt_bpe > 1024:
            raise ValueError(
                f"filter bits/entry = {filt_bpe:.3g}: `sys` must be the SAME "
                "LSMSystem the tuning was produced under (mfilt_bits is "
                "normalized by sys.N)")
        buf_bpe = m_total_bpe - filt_bpe
        if buf_entries is None:
            buf_bits = buf_bpe * expected_entries   # preserve buffer share
            buf_entries = max(64, int(buf_bits / (entry_bytes * 8)))
        return EngineConfig(T=T, K=K, buf_entries=buf_entries,
                            entry_bytes=entry_bytes, page_bytes=page_bytes,
                            mfilt_bits_per_entry=filt_bpe,
                            expected_entries=expected_entries,
                            policy=policy, policy_params=tuple(policy_params))

    @classmethod
    def from_phi(cls, phi, sys, expected_entries: int,
                 buf_entries: Optional[int] = None,
                 entry_bytes: int = 64, page_bytes: int = 4096,
                 policy: str = "klsm",
                 policy_params: Tuple[Tuple[str, Any], ...] = (),
                 device=None) -> "LSMTree":
        """Deploy a tuner-recommended Phi at reduced scale
        (see :meth:`config_from_phi`)."""
        return cls(cls.config_from_phi(
            phi, sys, expected_entries, buf_entries=buf_entries,
            entry_bytes=entry_bytes, page_bytes=page_bytes, policy=policy,
            policy_params=policy_params), device=device)

    def retune(self, phi, sys) -> None:
        """Swap the deployed tuning in place, at a flush boundary (the
        buffer flushes under the old tuning; existing runs keep their
        layout and converge through normal compaction).  A re-tune that
        resolves to the current config is a no-op."""
        cfg = self.config_from_phi(
            phi, sys, self.cfg.expected_entries,
            entry_bytes=self.cfg.entry_bytes,
            page_bytes=self.cfg.page_bytes, policy=self.cfg.policy,
            policy_params=self.cfg.policy_params)
        if cfg == self.cfg:
            obs.count("engine.retune.noop")
            return
        obs.count("engine.retune")
        with obs.track(self.obs_label), \
                obs.span("engine.retune", policy=cfg.policy,
                         T=cfg.T, buf_entries=cfg.buf_entries):
            self.flush()
            self.cfg = cfg
            self.planner = make_planner(cfg)
            self._maintain()

    # -- bits allocation --------------------------------------------------

    def _bits_per_key(self, level: int) -> float:
        return monkey_bits_per_key(
            level, self.cfg.est_levels, float(self.cfg.T),
            self.cfg.mfilt_bits_per_entry * self.cfg.expected_entries,
            float(self.cfg.expected_entries))

    # -- write path --------------------------------------------------------

    def _encode(self, value: Any) -> int:
        if value is TOMBSTONE:
            return TOMB
        return self.store.codec.encode(value)

    def put(self, key: int, value: Any) -> None:
        self.stats.queries["w"] += 1
        self.buffer[int(key)] = self._encode(value)
        if len(self.buffer) >= self.cfg.buf_entries:
            self.flush()

    def delete(self, key: int) -> None:
        self.put(key, TOMBSTONE)

    def put_batch(self, keys, values: Sequence[Any]) -> None:
        """Bulk insert in buffer-sized chunks; equivalent to sequential
        :meth:`put` calls (same flush boundaries, later duplicates win)."""
        keys = np.asarray(keys, np.uint64)
        n = len(keys)
        if len(values) != n:
            raise ValueError(f"put_batch: {n} keys but {len(values)} values")
        int_vals = isinstance(values, np.ndarray) and values.dtype.kind in "iu"
        i = 0
        while i < n:
            room = max(1, self.cfg.buf_entries - len(self.buffer))
            chunk = keys[i:i + room]
            vals = values[i:i + room]
            # encode per chunk, never ahead of insertion (a flush may sweep
            # the intern table, which only sees slots already stored)
            if int_vals:
                enc = self.store.codec.encode_many(vals)
            else:
                enc = np.fromiter((self._encode(v) for v in vals), np.int64,
                                  len(chunk))
            self.buffer.update(zip(chunk.tolist(), enc.tolist()))
            self.stats.queries["w"] += len(chunk)
            i += len(chunk)
            if len(self.buffer) >= self.cfg.buf_entries:
                self.flush()

    def flush(self) -> None:
        if not self.buffer:
            return
        obs.count("engine.flush")
        keys, vals = self._buffer_sorted()
        self.flush_seq += 1
        tomb_seq = self.flush_seq if bool((vals == TOMB).any()) else -1
        run = RunData.build(to_device_keys(keys, self.device),
                            torch.from_numpy(vals).to(self.device),
                            self._bits_per_key(1), flushes=1,
                            tomb_seq=tomb_seq,
                            bounds=(int(keys[0]), int(keys[-1])))
        self.stats.comp_pages_written += pages_of(
            len(run), self.cfg.entries_per_page)   # sequential flush
        self.buffer.clear()
        self._push_run(1, run)
        self._maintain()
        # intern reclamation while the buffer is empty
        if len(self.store.codec.objects) >= self._intern_sweep_at:
            self.store.reclaim_interned()
            self._intern_sweep_at = max(64, 2 * len(self.store.codec.objects))

    def _execute_plan(self, plan, run, bpk):
        """``store.execute`` with per-plan telemetry counters attached."""
        if not obs.enabled():
            return self.store.execute(plan, run, self.stats, bpk)
        s = self.stats
        read0, written0 = s.comp_pages_read, s.comp_pages_written
        out = self.store.execute(plan, run, s, bpk)
        obs.count("engine.plan." + plan.kind)
        obs.count("engine.compaction." + self.cfg.policy)
        obs.count("engine.comp_pages_read", s.comp_pages_read - read0)
        obs.count("engine.comp_pages_written",
                  s.comp_pages_written - written0)
        return out

    def _push_run(self, level: int, run: RunData) -> None:
        """Plan-execute-replan until the incoming run finds a home."""
        while True:
            occ = self.store.occupancy(min_levels=level)
            plan = self.planner.plan_push(occ, level, len(run), run.flushes)
            if plan.kind == "spill":
                run = self._execute_plan(plan, run,
                                         self._bits_per_key(level + 1))
                level += 1
                continue
            bpk = self._bits_per_key(level)
            self._execute_plan(plan, run, bpk)
            for clamp in self.planner.plan_clamps(
                    self.store.occupancy(min_levels=level), level):
                self._execute_plan(clamp, None, bpk)
            return

    def _maintain(self) -> None:
        """Poll the planner's maintenance hook until it is satisfied
        (read-pressure squeezes, partial spills, tombstone-TTL sweeps);
        a no-op for the K-LSM planner."""
        if not self.planner.has_maintenance:
            return
        for _ in range(100_000):
            plans = self.planner.plan_maintenance(self.store, self.stats,
                                                  self.flush_seq)
            if not plans:
                return
            for plan in plans:
                bpk = self._bits_per_key(plan.target_level)
                if plan.kind == "spill":
                    out = self._execute_plan(plan, None, bpk)
                    if len(out):
                        self._push_run(plan.target_level, out)
                else:
                    self._execute_plan(plan, None, bpk)
        raise RuntimeError(
            f"{type(self.planner).__name__}.plan_maintenance did not "
            "converge within 100000 rounds")

    # -- read path ----------------------------------------------------------

    def _buffer_sorted(self) -> Tuple[np.ndarray, np.ndarray]:
        bkeys = np.fromiter(self.buffer.keys(), np.uint64, len(self.buffer))
        benc = np.fromiter(self.buffer.values(), np.int64, len(self.buffer))
        order = np.argsort(bkeys)
        return bkeys[order], benc[order]

    @staticmethod
    def resolve_in_sorted(bkeys: np.ndarray, benc: np.ndarray,
                          keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(hit, encoded) membership of ``keys`` in a sorted host buffer
        view (the memtable side of every read, on the host)."""
        loc = np.searchsorted(bkeys, keys)
        inb = loc < len(bkeys)
        hit = np.zeros(len(keys), bool)
        hit[inb] = bkeys[loc[inb]] == keys[inb]
        henc = benc[loc[hit]] if hit.any() else np.empty(0, np.int64)
        return hit, henc

    def _lookup_batch(self, keys_arr: np.ndarray,
                      resolved: Optional[np.ndarray] = None,
                      found: Optional[np.ndarray] = None,
                      enc: Optional[np.ndarray] = None,
                      use_buffer: bool = True
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """(found, encoded_values) for a uint64 key batch, as host arrays.

        The buffer resolves on the host; the unresolved keys then go to
        the device once and visit every level newest -> oldest, one
        point-read kernel launch per non-empty level over the keys still
        unresolved, so ``IOStats`` is identical to per-key execution.
        Callers that resolved some keys upstream pass ``resolved`` /
        ``found`` / ``enc`` and ``use_buffer=False``."""
        n = len(keys_arr)
        resolved = np.zeros(n, bool) if resolved is None else resolved
        found = np.zeros(n, bool) if found is None else found
        enc = np.zeros(n, np.int64) if enc is None else enc
        if use_buffer and self.buffer:
            if n == 1:        # scalar get/point_query: O(1) dict probe
                v = self.buffer.get(int(keys_arr[0]))
                if v is not None:
                    resolved[0] = True
                    found[0] = v != TOMB
                    enc[0] = v
            else:
                bkeys, benc = self._buffer_sorted()
                hit, henc = self.resolve_in_sorted(bkeys, benc, keys_arr)
                if hit.any():
                    resolved |= hit
                    found[hit] = henc != TOMB
                    enc[hit] = henc
        levels = [lv for lv in self.store.levels if lv.num_runs]
        todo = np.flatnonzero(~resolved)
        if not levels or todo.size == 0:
            return found, enc
        dev = self.device
        q = torch.from_numpy(order_keys(keys_arr[todo])).to(dev)
        sub = torch.arange(len(todo), device=dev)   # unresolved, into q
        l_enc = torch.zeros(len(todo), dtype=torch.int64, device=dev)
        l_hit = torch.zeros(len(todo), dtype=torch.bool, device=dev)
        counts = torch.zeros(3, dtype=torch.int64, device=dev)
        for lv in levels:
            if lv is not levels[0]:
                sub = sub[~hit]                  # one sync: sizes the batch
            if sub.shape[0] == 0:
                break
            hit, henc, c = point_read_level(lv, q[sub])
            counts += c
            l_hit[sub] = hit
            l_enc[sub] = torch.where(hit, henc, l_enc[sub])
        probes, reads, fps = counts.tolist()
        stats = self.stats
        stats.bloom_probes += probes
        stats.random_reads += reads
        stats.bloom_false_positives += fps
        l_hit, l_enc = l_hit.cpu().numpy(), l_enc.cpu().numpy()
        gidx = todo[l_hit]
        venc = l_enc[l_hit]
        resolved[gidx] = True
        found[gidx] = venc != TOMB
        enc[gidx] = venc
        return found, enc

    def get(self, key: int) -> Optional[Any]:
        found, enc = self._lookup_batch(np.asarray([key], np.uint64))
        return self.store.codec.decode(enc[0]) if found[0] else None

    def point_query(self, key: int) -> Optional[Any]:
        """A classified point query (updates z0/z1 accounting)."""
        found, enc = self._lookup_batch(np.asarray([key], np.uint64))
        self.stats.queries["z1" if found[0] else "z0"] += 1
        out = self.store.codec.decode(enc[0]) if found[0] else None
        self._maintain()     # read-triggered policies (lazy leveling)
        return out

    def point_query_batch(self, keys) -> List[Optional[Any]]:
        """Classified point queries for a key batch; equivalent to
        ``[point_query(k) for k in keys]``."""
        keys_arr = np.asarray(keys, np.uint64)
        found, enc = self.classify_point_batch(keys_arr)
        results: List[Optional[Any]] = [None] * len(keys_arr)
        idx = np.flatnonzero(found)
        for i, v in zip(idx.tolist(),
                        self.store.codec.decode_many(enc[idx])):
            results[i] = v
        return results

    def classify_point_batch(self, keys_arr: np.ndarray,
                             resolved: Optional[np.ndarray] = None,
                             found: Optional[np.ndarray] = None,
                             enc: Optional[np.ndarray] = None,
                             use_buffer: bool = True
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """The accounting core of :meth:`point_query_batch`, without
        materializing a Python result list (the session executor's path)."""
        s = self.stats
        before = ((s.bloom_probes, s.bloom_false_positives, s.random_reads)
                  if obs.enabled() else None)
        found, enc = self._lookup_batch(keys_arr, resolved=resolved,
                                        found=found, enc=enc,
                                        use_buffer=use_buffer)
        nz1 = int(found.sum())
        self.stats.queries["z1"] += nz1
        self.stats.queries["z0"] += len(keys_arr) - nz1
        if before is not None:
            obs.count("engine.read.batches")
            obs.count("engine.read.keys", len(keys_arr))
            obs.count("engine.bloom.probes", s.bloom_probes - before[0])
            obs.count("engine.bloom.false_positives",
                      s.bloom_false_positives - before[1])
            obs.count("engine.read.random_reads",
                      s.random_reads - before[2])
        self._maintain()     # read-triggered policies fire at batch ends
        return found, enc

    def range_query(self, lo: int, hi: int) -> List[Tuple[int, Any]]:
        return self.range_query_batch([lo], [hi], return_results=True)[0]

    def range_query_batch(self, los, his, return_results: bool = False
                          ) -> Optional[List[List[Tuple[int, Any]]]]:
        """A batch of inclusive-lo, exclusive-hi range queries.

        Per run that a query overlaps (host fence test): one two-sided
        device ``searchsorted`` for the whole batch; each overlapping
        (query, run) pair counts 1 seek + sequential page reads.  The
        counters come back in one sync at the end.  With
        ``return_results`` the matching entries are gathered on the device
        (:func:`_multi_ranges`) and the newest-wins merge across runs and
        buffer runs on the host, where the answers go."""
        los = np.asarray(los, np.uint64)
        his = np.asarray(his, np.uint64)
        Q = len(los)
        self.stats.queries["q"] += Q
        if obs.enabled():
            obs.count("engine.range.batches")
            obs.count("engine.range.queries", Q)
        epp = self.cfg.entries_per_page
        dev = self.device
        qlo = torch.from_numpy(order_keys(los)).to(dev)
        qhi = torch.from_numpy(order_keys(his)).to(dev)
        qids = torch.arange(Q, device=dev)
        counts = torch.zeros(2, dtype=torch.int64, device=dev)
        pieces = []                         # (qid, keys, vals, recency)
        recency = 0
        for lv in self.store.levels:
            for r in range(lv.num_runs):    # newest -> oldest
                if lv.run_len(r) == 0:
                    recency += 1
                    continue
                # fence fast-path (host metadata): runs no query overlaps
                # cost nothing
                if not ((los <= lv.max_keys[r]) & (his > lv.min_keys[r])
                        ).any():
                    recency += 1
                    continue
                rkeys, rvals = lv.run_slice(r)
                i = torch.searchsorted(rkeys, qlo, side="left")
                j = torch.searchsorted(rkeys, qhi, side="left")
                ov = i < j
                counts += torch.stack([
                    ov.sum(), torch.where(ov, (j - 1) // epp - i // epp,
                                          0).sum()])
                if return_results:
                    idx, qid = _multi_ranges(i[ov], j[ov], qids[ov])
                    pieces.append((qid, rkeys[idx], rvals[idx], recency))
                recency += 1
        seeks, seq = counts.tolist()
        self.stats.random_reads += seeks
        self.stats.seq_reads += seq
        self._maintain()     # range seeks count as read pressure too
        if not return_results:
            return None
        host = [(p[0].cpu().numpy(), p[1].cpu().numpy(), p[2].cpu().numpy(),
                 np.full(p[0].shape[0], p[3], np.int64)) for p in pieces]
        if self.buffer:                     # newest of all: recency -1
            bkeys, benc = self._buffer_sorted()
            i = np.searchsorted(bkeys, los, side="left")
            j = np.searchsorted(bkeys, his, side="left")
            for q in np.flatnonzero(i < j):
                host.append((np.full(j[q] - i[q], q, np.int64),
                             order_keys(bkeys[i[q]:j[q]]), benc[i[q]:j[q]],
                             np.full(j[q] - i[q], -1, np.int64)))
        results: List[List[Tuple[int, Any]]] = [[] for _ in range(Q)]
        if not host:
            return results
        qid = np.concatenate([p[0] for p in host])
        keys = np.concatenate([p[1] for p in host])
        vals = np.concatenate([p[2] for p in host])
        rec = np.concatenate([p[3] for p in host])
        order = np.lexsort((rec, keys, qid))
        qid, keys, vals = qid[order], keys[order], vals[order]
        keep = np.ones(len(qid), bool)      # first (newest) version per
        keep[1:] = (qid[1:] != qid[:-1]) | (keys[1:] != keys[:-1])  # (q, key)
        sel = keep & (vals != TOMB)
        qs = qid[sel].tolist()
        ks = (keys[sel].view(np.uint64) ^ np.uint64(1 << 63)).tolist()
        vs = self.store.codec.decode_many(vals[sel])
        for q, k, v in zip(qs, ks, vs):
            results[q].append((k, v))
        return results

    # -- introspection --------------------------------------------------------

    @property
    def num_entries(self) -> int:
        return len(self.buffer) + self.store.total_entries

    def shape(self) -> List[Tuple[int, List[int]]]:
        """[(level, [run sizes])] for non-empty levels."""
        return self.store.shape()

    def filter_bits_in_use(self) -> int:
        return self.store.filter_bits_in_use()


def _multi_ranges(starts: torch.Tensor, ends: torch.Tensor,
                  qids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flatten ``[starts, ends)`` index ranges into one gather-index tensor
    plus the query id of every gathered element (device ops; one sync to
    size the output)."""
    lens = ends - starts
    total = int(lens.sum())
    offs = torch.cumsum(lens, 0) - lens
    idx = (torch.arange(total, dtype=torch.int64, device=starts.device)
           - torch.repeat_interleave(offs, lens, output_size=total)
           + torch.repeat_interleave(starts, lens, output_size=total))
    return idx, torch.repeat_interleave(qids, lens, output_size=total)
