"""Structure-of-arrays run store with device arenas: the engine's storage.

The port of ``repro/lsm/store.py``.  Each populated level is a
:class:`LevelStore` holding ALL of its runs as contiguous arenas — one key
tensor and one encoded-value tensor on the engine's device, runs ordered
newest -> oldest — so the point-read and merge kernels read them in place.
Keys are in the ordered int64 form of ``utils/u64.py`` (``u ^ 2**63``:
signed order is unsigned key order).

The host keeps what the planner and the read path's layout need, so that
neither has to wait for the device: run offsets (``starts``), fence keys
(``min_keys``/``max_keys``, uint64), Bloom parameters (``n_bits``, ``ks``),
flush lineage and tombstone ages.  A run's Bloom words and, on the card,
its key sample for the point read (``point_read.ops.run_sample``) are
built on the device on the first read of its level and kept with the run;
each layout of the level packs them flat (``kernels/point_read.LevelLayout``),
and a change of the level's runs drops the layout (``_set_runs``), not
what unchanged runs keep.

Values are encoded int64s (:class:`ValueCodec`, host side): inline ints,
interned objects, and the tombstone sentinel ``TOMB``.  The store only
executes :class:`~repro_torch.lsm.planner.MergePlan`s; merges run through
the merge kernel and count exact logical compaction I/O into ``IOStats``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.point_read import ops as read_ops
from ..kernels.point_read.ops import LevelLayout
from ..utils.u64 import ordered_to_int
from .bloom import bloom_params, build_words
from .merge_path import merge_runs

#: Encoded-value sentinel for deletes.  Even (never an intern slot, those are
#: non-negative evens) and negative, so it cannot collide with either inline
#: ints (odd) or interned object ids.
TOMB = -2

_INLINE_MAX = 2 ** 62  # inline ints v are stored as 2v+1: |v| must fit
_HALF = 1 << 63


class ValueCodec:
    """Encode arbitrary Python values into int64 slots (host side).

    * ``int`` values with ``|v| < 2**62`` are stored inline as ``2v + 1``;
    * any other object is interned: slot ``2 * table_index`` (even, >= 0);
    * deletes are :data:`TOMB`.
    """

    __slots__ = ("objects",)

    def __init__(self):
        self.objects: List[Any] = []

    def encode(self, value: Any) -> int:
        if isinstance(value, (int, np.integer)) \
                and not isinstance(value, bool) \
                and -_INLINE_MAX < value < _INLINE_MAX:
            return 2 * int(value) + 1
        self.objects.append(value)
        return 2 * (len(self.objects) - 1)

    def encode_many(self, values) -> np.ndarray:
        """Vectorized encode for integer arrays; falls back per-element."""
        if isinstance(values, np.ndarray) and values.dtype.kind in "iu":
            v = values.astype(np.int64, copy=False)
            lo, hi = int(v.min(initial=0)), int(v.max(initial=0))
            if -_INLINE_MAX < lo and hi < _INLINE_MAX and not (
                    values.dtype.kind == "u"
                    and int(values.max(initial=0)) >= _INLINE_MAX):
                return 2 * v + 1
        return np.fromiter((self.encode(v) for v in values), np.int64,
                           len(values))

    def decode(self, enc: int) -> Any:
        enc = int(enc)
        if enc & 1:
            return enc >> 1
        return self.objects[enc >> 1]

    def decode_many(self, enc: np.ndarray) -> List[Any]:
        """Decode a tombstone-free encoded array to a list of values."""
        enc = np.asarray(enc, np.int64)
        if len(enc) == 0 or bool((enc & 1).all()):
            return (enc >> 1).tolist()
        return [self.decode(e) for e in enc]


def pages_of(entries: int, entries_per_page: int) -> int:
    return (entries + entries_per_page - 1) // entries_per_page


def key_bounds(okeys: torch.Tensor) -> Tuple[int, int]:
    """(min, max) unsigned key of a sorted ordered-key run; (0, 0) if empty.
    One device read."""
    if okeys.shape[0] == 0:
        return 0, 0
    lo, hi = torch.stack([okeys[0], okeys[-1]]).tolist()
    return ordered_to_int(lo), ordered_to_int(hi)


@dataclasses.dataclass
class RunData:
    """One immutable sorted run in transit (flush output / merge output).

    ``keys``/``vals`` live on the engine's device; ``min_key``/``max_key``
    are its unsigned fence keys, kept on the host.  The Bloom parameters
    (n_bits, k) are fixed at build time; the words and the key sample
    materialize lazily on the level's first read.  ``tomb_seq`` is the
    flush sequence of the oldest tombstone in the run (-1 when
    tombstone-free)."""

    keys: torch.Tensor        # ordered int64, sorted ascending, unique
    vals: torch.Tensor        # int64, encoded
    flushes: int
    n_bits: int
    k: int
    min_key: int = 0
    max_key: int = 0
    words: Optional[torch.Tensor] = None
    tomb_seq: int = -1
    sample: Optional[torch.Tensor] = None

    @classmethod
    def build(cls, keys: torch.Tensor, vals: torch.Tensor,
              bits_per_key: float, flushes: int, tomb_seq: int = -1,
              bounds: Optional[Tuple[int, int]] = None) -> "RunData":
        n_bits, k = bloom_params(keys.shape[0], bits_per_key)
        lo, hi = key_bounds(keys) if bounds is None else bounds
        return cls(keys=keys, vals=vals, flushes=flushes, n_bits=n_bits,
                   k=k, min_key=lo, max_key=hi, tomb_seq=tomb_seq)

    def __len__(self) -> int:
        return self.keys.shape[0]


def builds_samples(device: torch.device) -> bool:
    """Whether a level on ``device`` builds the point read's key samples:
    only the kernel reads them, and it runs only on the card (the plain
    ``point_read_level_ref`` of CPU tensors never does)."""
    return device.type == "cuda"


class LevelStore:
    """All runs of one level as device arenas + host metadata."""

    __slots__ = ("device", "keys", "vals", "starts", "flushes", "n_bits",
                 "ks", "words_list", "samples_list", "min_keys",
                 "max_keys", "tomb_seqs", "_pack")

    def __init__(self, device):
        self.device = torch.device(device)
        self.keys = torch.empty(0, dtype=torch.int64, device=self.device)
        self.vals = torch.empty(0, dtype=torch.int64, device=self.device)
        self.starts = np.zeros(1, np.int64)     # R+1 offsets, newest first
        self.flushes: List[int] = []
        self.n_bits: List[int] = []
        self.ks: List[int] = []
        self.words_list: List[Optional[torch.Tensor]] = []
        self.samples_list: List[Optional[torch.Tensor]] = []
        self.min_keys = np.empty(0, np.uint64)
        self.max_keys = np.empty(0, np.uint64)
        self.tomb_seqs: List[int] = []
        self._pack: Optional[LevelLayout] = None

    # -- introspection ----------------------------------------------------

    @property
    def num_runs(self) -> int:
        return len(self.starts) - 1

    @property
    def entries(self) -> int:
        return int(self.starts[-1])

    def run_slice(self, r: int) -> Tuple[torch.Tensor, torch.Tensor]:
        s, e = int(self.starts[r]), int(self.starts[r + 1])
        return self.keys[s:e], self.vals[s:e]

    def run_len(self, r: int) -> int:
        return int(self.starts[r + 1] - self.starts[r])

    def run_lens(self) -> List[int]:
        return np.diff(self.starts).tolist()

    @property
    def pack(self) -> LevelLayout:
        """The level's read layout; builds missing Bloom words first, then,
        on the card, the missing key samples of runs of at least
        ``SAMPLE_MIN_RUN`` entries (``point_read.ops.run_sample``)."""
        if self._pack is None:
            sampled = builds_samples(self.device)
            for r in range(self.num_runs):
                keys, _ = self.run_slice(r)
                if self.words_list[r] is None:
                    self.words_list[r] = build_words(keys, self.n_bits[r],
                                                     self.ks[r])
                if sampled and self.samples_list[r] is None \
                        and len(keys) >= read_ops.SAMPLE_MIN_RUN:
                    self.samples_list[r] = read_ops.run_sample(keys)
            lens = [w.shape[0] for w in self.words_list]
            words = torch.cat(self.words_list) if self.words_list else \
                torch.zeros(0, dtype=torch.int64, device=self.device)
            self._pack = LevelLayout(
                starts=self.starts.tolist(), n_bits=list(self.n_bits),
                ks=list(self.ks),
                fence_lo=[int(k) - _HALF for k in self.min_keys],
                fence_hi=[int(k) - _HALF for k in self.max_keys],
                word_off=np.concatenate([[0], np.cumsum(lens)]).tolist(),
                words=words, **read_ops.pack_samples(
                    self.samples_list, self.run_lens(), self.keys))
        return self._pack

    # -- mutation ----------------------------------------------------------

    def _set_runs(self, runs: Sequence[RunData]) -> None:
        """Rebuild the arenas from a newest-first run list."""
        if runs:
            self.keys = torch.cat([r.keys for r in runs])
            self.vals = torch.cat([r.vals for r in runs])
        else:
            self.keys = self.keys[:0]
            self.vals = self.vals[:0]
        lens = np.fromiter((len(r) for r in runs), np.int64, len(runs))
        self.starts = np.concatenate([np.zeros(1, np.int64), np.cumsum(lens)])
        self.flushes = [r.flushes for r in runs]
        self.n_bits = [r.n_bits for r in runs]
        self.ks = [r.k for r in runs]
        self.words_list = [r.words for r in runs]
        self.samples_list = [r.sample for r in runs]
        self.tomb_seqs = [r.tomb_seq for r in runs]
        self.min_keys = np.array([r.min_key for r in runs], np.uint64)
        self.max_keys = np.array([r.max_key for r in runs], np.uint64)
        self._pack = None

    def _as_rundata(self, r: int) -> RunData:
        keys, vals = self.run_slice(r)
        return RunData(keys=keys, vals=vals, flushes=self.flushes[r],
                       n_bits=self.n_bits[r], k=self.ks[r],
                       min_key=int(self.min_keys[r]),
                       max_key=int(self.max_keys[r]),
                       words=self.words_list[r], tomb_seq=self.tomb_seqs[r],
                       sample=self.samples_list[r])

    def runs(self) -> List[RunData]:
        return [self._as_rundata(r) for r in range(self.num_runs)]


class RunStore:
    """The tree's storage: one :class:`LevelStore` per populated level."""

    def __init__(self, entries_per_page: int, device):
        self.entries_per_page = entries_per_page
        self.device = torch.device(device)
        self.levels: List[LevelStore] = []
        self.codec = ValueCodec()

    # -- views --------------------------------------------------------------

    def level(self, level: int) -> LevelStore:
        """1-indexed accessor, growing the level list on demand."""
        while len(self.levels) < level:
            self.levels.append(LevelStore(self.device))
        return self.levels[level - 1]

    def occupancy(self, min_levels: int = 0):
        """(entries, run_counts, active_flushes) arrays for the planner."""
        n = max(len(self.levels), min_levels)
        entries = np.zeros(n, np.int64)
        run_counts = np.zeros(n, np.int64)
        active_flushes = np.zeros(n, np.int64)
        for i, lv in enumerate(self.levels):
            entries[i] = lv.entries
            run_counts[i] = lv.num_runs
            if lv.num_runs:
                active_flushes[i] = lv.flushes[0]
        return entries, run_counts, active_flushes

    @property
    def total_entries(self) -> int:
        return sum(lv.entries for lv in self.levels)

    def shape(self) -> List[Tuple[int, List[int]]]:
        return [(i + 1, lv.run_lens())
                for i, lv in enumerate(self.levels) if lv.num_runs]

    def filter_bits_in_use(self) -> int:
        return sum(sum(lv.n_bits) for lv in self.levels)

    # -- intern-table reclamation -------------------------------------------

    def reclaim_interned(self) -> int:
        """Compaction-time intern-table sweep: drop dead slots, remap live
        ones in the arenas (interned encodings are even and >= 0).  Must
        run while the write buffer is empty.  Returns the slots dropped."""
        codec = self.codec
        n_old = len(codec.objects)
        if n_old == 0:
            return 0
        live = np.zeros(n_old, bool)
        for lv in self.levels:
            iv = lv.vals[(lv.vals >= 0) & (lv.vals & 1 == 0)]
            live[iv.cpu().numpy() >> 1] = True
        n_live = int(live.sum())
        if n_live == n_old:
            return 0
        remap = torch.from_numpy(np.cumsum(live) - 1).to(self.device)
        codec.objects = [codec.objects[i] for i in np.flatnonzero(live)]
        for lv in self.levels:
            m = (lv.vals >= 0) & (lv.vals & 1 == 0)
            lv.vals[m] = 2 * remap[lv.vals[m] >> 1]
        return n_old - n_live

    # -- plan execution ------------------------------------------------------

    def place_run(self, level: int, run: RunData) -> None:
        """Logical move: prepend ``run`` as the level's new newest run."""
        lv = self.level(level)
        lv._set_runs([run] + lv.runs())

    def merge(self, inputs: Sequence[RunData], bits_per_key: float,
              stats, drop_tombstones: bool = False) -> RunData:
        """Newest-wins merge of ``inputs`` (newest first) on the device.

        Tombstones are dropped only when the planner marked the merge as
        deepest; compaction I/O is counted per input/output page."""
        epp = self.entries_per_page
        for r in inputs:
            stats.comp_pages_read += pages_of(len(r), epp)
        keys_u, vals_u = merge_runs([r.keys for r in inputs],
                                    [r.vals for r in inputs])
        if drop_tombstones:
            live = vals_u != TOMB
            keys_u, vals_u = keys_u[live], vals_u[live]
            tomb_seq = -1
        else:
            in_seqs = [r.tomb_seq for r in inputs if r.tomb_seq >= 0]
            tomb_seq = min(in_seqs) if in_seqs and \
                bool((vals_u == TOMB).any()) else -1
        out = RunData.build(keys_u, vals_u, bits_per_key,
                            flushes=sum(r.flushes for r in inputs),
                            tomb_seq=tomb_seq)
        stats.comp_pages_written += pages_of(len(out), epp)
        return out

    def execute(self, plan, incoming: Optional[RunData], stats,
                bits_per_key: float) -> Optional[RunData]:
        """Apply one MergePlan.  Returns the spill output (the run the engine
        must re-push at ``plan.target_level``) or None for in-level plans."""
        lv = self.level(plan.level)
        if plan.kind == "spill":
            head = [incoming] if incoming is not None else []
            merged = self.merge(head + lv.runs(), bits_per_key, stats,
                                drop_tombstones=plan.drop_tombstones)
            lv._set_runs([])
            return merged
        if plan.kind == "eager":
            runs = lv.runs()
            runs[0] = self.merge([incoming, runs[0]], bits_per_key, stats)
            lv._set_runs(runs)
            return None
        if plan.kind == "move":
            self.place_run(plan.level, incoming)
            return None
        if plan.kind == "clamp":
            runs = lv.runs()
            n = max(2, len(plan.run_ids))
            merged = self.merge(runs[:n], bits_per_key, stats,
                                drop_tombstones=plan.drop_tombstones)
            lv._set_runs([merged] + runs[n:])
            return None
        if plan.kind == "partial":
            self._execute_partial(plan, stats, bits_per_key)
            return None
        raise ValueError(f"unknown plan kind {plan.kind!r}")

    def _slice_level(self, level: int, lo: int, hi: int) -> List[RunData]:
        """Extract the ``[lo, hi)`` (unsigned) key slice out of every run of
        ``level``; returns the pieces newest-first and leaves the
        remainders in place (empty remainders vanish), with Bloom
        parameters re-derived from the new lengths and flush lineage
        apportioned by entry count."""
        lv = self.level(level)
        bounds = torch.tensor([lo - _HALF, hi - _HALF], dtype=torch.int64,
                              device=self.device)
        pieces: List[RunData] = []
        remainders: List[RunData] = []
        for r in range(lv.num_runs):
            keys, vals = lv.run_slice(r)
            i, j = torch.searchsorted(keys, bounds, side="left").tolist()
            if i == j:                        # run untouched by the slice
                remainders.append(lv._as_rundata(r))
                continue
            n = len(keys)
            piece_fl = min(lv.flushes[r],
                           max(0, round(lv.flushes[r] * (j - i) / n)))
            pieces.append(RunData.build(
                keys[i:j], vals[i:j], self._bpk_of(lv, r),
                flushes=piece_fl, tomb_seq=lv.tomb_seqs[r]))
            rem_keys = torch.cat([keys[:i], keys[j:]])
            if len(rem_keys):
                rem_vals = torch.cat([vals[:i], vals[j:]])
                tomb = lv.tomb_seqs[r] if bool((rem_vals == TOMB).any()) \
                    else -1
                remainders.append(RunData.build(
                    rem_keys, rem_vals, self._bpk_of(lv, r),
                    flushes=lv.flushes[r] - piece_fl, tomb_seq=tomb))
        lv._set_runs(remainders)
        return pieces

    @staticmethod
    def _bpk_of(lv: LevelStore, r: int) -> float:
        """Recover a run's bits-per-key ratio for re-derived sub-runs."""
        n = lv.run_len(r)
        return lv.n_bits[r] / n if n else 1.0

    def _execute_partial(self, plan, stats, bits_per_key: float) -> None:
        """Key-range-sliced merge: extract ``[key_lo, key_hi)`` from every
        run of the source level AND the target level, merge the pieces
        (source pieces are newer), and place the output as the target
        level's newest run."""
        lo = int(plan.key_lo)
        hi = min(int(plan.key_hi), 2 ** 64 - 1)
        src = self._slice_level(plan.level, lo, hi)
        tgt = self._slice_level(plan.target_level, lo, hi)
        inputs = src + tgt                     # source level is newer
        if not inputs:
            return
        merged = self.merge(inputs, bits_per_key, stats,
                            drop_tombstones=plan.drop_tombstones)
        if len(merged):
            self.place_run(plan.target_level, merged)
