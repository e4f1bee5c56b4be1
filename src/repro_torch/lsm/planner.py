"""Compaction planners: WHEN/WHAT to compact, as plain data.

The port's own copy of the JAX package's ``lsm/planner.py``: host logic,
unchanged, reading only the host-side metadata the port's store keeps
beside its device arenas.

The policy layer of the LSM engine.  A planner never touches key arrays: it
reads the store's level-occupancy arrays (entries, run counts, active-run
flush lineage) plus per-run fence/tombstone *metadata* and emits
:class:`MergePlan` values; the store executes them with a vectorized
lexsort-merge and the engine drives the plan-execute-replan loop.  This
separation is the "compaction as data" view of the design-space taxonomy
(Sarkar et al., "Constructing and Analyzing the LSM Compaction Design
Space"): a trigger/granularity/data-movement policy decoupled from merge
execution, so alternative policies are new planners, not new engines.

Four policies span the taxonomy's axes (see ``docs/compaction.md`` for the
coordinate mapping):

* :class:`KLSMPlanner` — the paper's K-LSM semantics (Section 4.2),
  reproduced exactly: capacity-triggered full-level spills, eager in-level
  merges bounded by the per-run flush lineage cap ``ceil((T-1)/K_i)``,
  logical moves, and clamp merges restoring the ``K_i`` run cap.
* :class:`LazyLevelingPlanner` — Dostoevsky-style lazy leveling: runs
  accumulate tiering-style (cap ``T-1``) on every level, and the *deepest*
  level is squeezed back to one run only when read pressure since its last
  squeeze crosses a threshold ("merge on reads", not on writes).
* :class:`PartialCompactionPlanner` — partial/partitioned granularity: a
  level that overflows sheds a *key-range slice* (``MergePlan.key_lo`` /
  ``key_hi``, a round-robin cursor over the level's fence span) into the
  next level per trigger, instead of merging the whole level at once.
* :class:`TombstoneTTLPlanner` — K-LSM triggers plus an age-driven sweep: a
  run whose oldest tombstone exceeds ``ttl_flushes`` logical flushes is
  compacted level-by-level toward the deepest level, where the tombstone is
  dropped — bounding delete persistence (FADE-style TTLs).

``make_planner`` builds a policy from an :class:`EngineConfig` via the
``POLICIES`` registry.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MergePlan:
    """One compaction step, as data.

    ``kind``: "spill" | "eager" | "move" | "clamp" | "partial".  ``run_ids``
    are indices into the level's newest-first run list that participate in
    the merge (the incoming run, when present, is implicitly newest);
    ``target_level`` is where the output lands; ``drop_tombstones`` marks
    merges below which no data lives, so deletes can be discarded for good.
    ``key_lo``/``key_hi`` (``None`` for whole-run plans) restrict a
    "partial" plan to the key slice ``[key_lo, key_hi)``: the store extracts
    that slice from every listed run *and* from the target level's runs,
    merges the pieces, and leaves the remainders in place."""

    kind: str
    level: int
    run_ids: Tuple[int, ...]
    target_level: int
    drop_tombstones: bool = False
    key_lo: Optional[int] = None
    key_hi: Optional[int] = None


def level_capacity(level: int, T: int, buf_entries: int) -> int:
    return (T - 1) * T ** (level - 1) * buf_entries


class CompactionPolicy:
    """Base compaction policy: K-LSM-shaped push planning + a maintenance
    hook.

    ``plan_push``/``plan_clamps`` drive the write path (where does an
    arriving run go); ``plan_maintenance`` is polled by the engine after
    flushes and read batches (only when ``has_maintenance``) and may emit
    follow-up plans — read-triggered squeezes, partial spills, TTL sweeps —
    until it returns ``[]``."""

    #: engines skip the maintenance poll entirely when False (the K-LSM hot
    #: path stays byte-identical to the pre-policy engine)
    has_maintenance = False

    def __init__(self, cfg):
        self.cfg = cfg

    # -- write-path planning ------------------------------------------------

    def run_cap(self, level: int) -> int:
        """K_i: the level's run cap (policies override the profile)."""
        return self.cfg.k_at(level)

    def plan_push(self, occupancy, level: int, incoming_entries: int,
                  incoming_flushes: int) -> MergePlan:
        """Decide the fate of a run arriving at ``level``.

        ``occupancy`` is the store's ``(entries, run_counts,
        active_flushes)`` triple; entries beyond its length are empty."""
        entries, run_counts, active_flushes = occupancy
        n = len(entries)
        lv_entries = int(entries[level - 1]) if level - 1 < n else 0
        lv_runs = int(run_counts[level - 1]) if level - 1 < n else 0
        cap = level_capacity(level, self.cfg.T, self.cfg.buf_entries)
        if lv_entries + incoming_entries > cap and lv_entries > 0:
            plan = self.plan_overflow(occupancy, level, lv_runs)
            if plan is not None:
                return plan
        K = self.run_cap(level)
        flush_cap = max(1, math.ceil((self.cfg.T - 1) / K))
        if lv_runs > 0 and \
                int(active_flushes[level - 1]) + incoming_flushes <= flush_cap:
            return MergePlan(kind="eager", level=level, run_ids=(0,),
                             target_level=level)
        return MergePlan(kind="move", level=level, run_ids=(),
                         target_level=level)

    def plan_overflow(self, occupancy, level: int,
                      lv_runs: int) -> Optional[MergePlan]:
        """The capacity trigger: default is the K-LSM full-level spill.
        Returning ``None`` falls through to eager/move placement (policies
        that handle overflow in maintenance, e.g. partial compaction)."""
        _, run_counts, _ = occupancy
        deepest = int(run_counts[level:].sum()) == 0
        return MergePlan(kind="spill", level=level,
                         run_ids=tuple(range(lv_runs)),
                         target_level=level + 1,
                         drop_tombstones=deepest)

    def plan_clamps(self, occupancy, level: int) -> List[MergePlan]:
        """Merge-down plans restoring the K_i run cap after a move."""
        _, run_counts, _ = occupancy
        lv_runs = int(run_counts[level - 1]) if level - 1 < len(run_counts) \
            else 0
        K = self.run_cap(level)
        return [MergePlan(kind="clamp", level=level, run_ids=(0, 1),
                          target_level=level)
                for _ in range(max(0, lv_runs - K))]

    # -- maintenance --------------------------------------------------------

    def plan_maintenance(self, store, stats, clock: int) -> List[MergePlan]:
        """Follow-up plans, polled until empty.  ``store`` is the live
        :class:`~repro_torch.lsm.store.RunStore` (planners read occupancy and
        fence/tombstone metadata, never key arrays); ``stats`` the engine's
        ``IOStats``; ``clock`` the logical flush sequence number."""
        return []


class KLSMPlanner(CompactionPolicy):
    """The paper's K-LSM trigger policy over an :class:`EngineConfig`."""


class LazyLevelingPlanner(CompactionPolicy):
    """Lazy leveling: tiering-style accumulation, read-triggered last-level
    squeeze (Dostoevsky's fluid LSM, taken to its lazy extreme).

    Writes see pure tiering (run cap ``T-1`` on every level), so merge work
    on the write path is minimal.  The *deepest populated* level — the one
    holding most of the data, where point lookups bottom out — is merged
    back to a single run only when ``read_trigger`` random page reads have
    accumulated since its last squeeze: reads, not writes, pay for (and
    benefit from) the merge.  Steady read load therefore drives the tree to
    the lazy-leveling shape (``K_i = T-1`` above, one run at the bottom);
    write-only load never merges the last level at all."""

    has_maintenance = True

    def __init__(self, cfg, read_trigger: int = 256):
        super().__init__(cfg)
        self.read_trigger = int(read_trigger)
        self._reads_at_squeeze = 0

    def run_cap(self, level: int) -> int:
        return max(1, self.cfg.T - 1)

    def plan_maintenance(self, store, stats, clock: int) -> List[MergePlan]:
        deepest = 0
        for i, lv in enumerate(store.levels):
            if lv.num_runs:
                deepest = i + 1
        if deepest == 0:
            return []
        lv = store.levels[deepest - 1]
        pressure = stats.random_reads - self._reads_at_squeeze
        if lv.num_runs > 1 and pressure >= self.read_trigger:
            self._reads_at_squeeze = stats.random_reads
            return [MergePlan(kind="clamp", level=deepest,
                              run_ids=tuple(range(lv.num_runs)),
                              target_level=deepest, drop_tombstones=True)]
        return []


class PartialCompactionPlanner(CompactionPolicy):
    """Partial/partitioned compaction: capacity overflow sheds one key-range
    slice per trigger instead of the whole level.

    In-level placement (eager/move/clamp) follows K-LSM, but the capacity
    trigger is disarmed on the write path: an overfull level is drained by
    maintenance, one ``[key_lo, key_hi)`` slice at a time.  ``select``
    picks the slice:

    * ``"round_robin"`` (default, byte-identical to the original planner) —
      a cursor walks the level's fence span in ``1/parts`` strides, so each
      trigger moves roughly ``entries/parts`` entries and costs a bounded,
      level-capacity-independent amount of I/O (RocksDB-leveled-style
      compaction latency, at run granularity);
    * ``"overlap"`` — score each of the ``parts`` candidate slices by its
      estimated *overlap* with the target level (per-run fence spans +
      entry counts under a uniform-density assumption — metadata only,
      planners never read key arrays) and shed the least-overlapping slice
      first: the merge that rewrites the fewest target-level entries per
      source entry moved, RocksDB's min-overlapping-ratio file picker at
      slice granularity.  A per-level skip-set of slices already tried
      since the level last changed guarantees progress (a chosen slice may
      contain no source keys; round-robin advances past it by
      construction, overlap must not re-pick it forever)."""

    has_maintenance = True

    SELECTS = ("round_robin", "overlap")

    def __init__(self, cfg, parts: int = 4, select: str = "round_robin"):
        super().__init__(cfg)
        self.parts = max(1, int(parts))
        if select not in self.SELECTS:
            raise ValueError(f"unknown slice selection {select!r}; "
                             f"known: {self.SELECTS}")
        self.select = select
        self._cursors: dict = {}        # level -> next slice start key
        self._tried: dict = {}          # level -> slice starts tried
        self._state: dict = {}          # level -> (entries, num_runs) seen

    def plan_overflow(self, occupancy, level: int,
                      lv_runs: int) -> Optional[MergePlan]:
        return None                     # maintenance drains over-capacity

    def _candidates(self, lo_key: int, hi_key: int,
                    width: int) -> List[Tuple[int, int]]:
        """The ``parts`` slice intervals ``[lo, hi)`` tiling the fence span
        (the last one absorbs the floor-division remainder)."""
        out = []
        for j in range(self.parts):
            clo = lo_key + j * width
            if clo > hi_key:
                break
            chi = hi_key + 1 if (j == self.parts - 1
                                 or clo + width > hi_key) else clo + width
            out.append((clo, chi))
        return out

    def _overlap_score(self, store, level: int, clo: int,
                       chi: int) -> float:
        """Estimated target-level entries a merge of ``[clo, chi)`` must
        rewrite: each target run contributes its entry count times the
        fraction of its fence span the slice covers (uniform density)."""
        if level >= len(store.levels):      # no target level yet: free
            return 0.0
        tgt = store.levels[level]           # 0-indexed: level+1's runs
        score = 0.0
        lens = tgt.run_lens()
        for r in range(tgt.num_runs):
            mn = int(tgt.min_keys[r])
            mx = int(tgt.max_keys[r])
            inter = min(chi - 1, mx) - max(clo, mn) + 1
            if inter > 0:
                score += lens[r] * inter / (mx - mn + 1)
        return score

    def _pick_overlap(self, store, level: int, lo_key: int, hi_key: int,
                      width: int) -> Tuple[int, int]:
        lv = store.levels[level - 1]
        state = (int(lv.entries), int(lv.num_runs))
        if self._state.get(level) != state:     # the level moved: re-arm
            self._state[level] = state
            self._tried[level] = set()
        tried = self._tried.setdefault(level, set())
        cands = self._candidates(lo_key, hi_key, width)
        fresh = [c for c in cands if c[0] not in tried]
        if not fresh:       # full cycle without movement: start over
            tried.clear()
            fresh = cands
        _, clo, chi = min((self._overlap_score(store, level, clo, chi),
                           clo, chi) for clo, chi in fresh)
        tried.add(clo)
        return clo, chi

    def plan_maintenance(self, store, stats, clock: int) -> List[MergePlan]:
        run_counts = [lv.num_runs for lv in store.levels]
        deepest = max((i + 1 for i, r in enumerate(run_counts) if r),
                      default=0)
        for i, lv in enumerate(store.levels):
            level = i + 1
            if lv.num_runs == 0:
                continue
            # restore the K cap first: partial outputs land as new runs
            if lv.num_runs > self.run_cap(level):
                return [MergePlan(kind="clamp", level=level, run_ids=(0, 1),
                                  target_level=level)]
            cap = level_capacity(level, self.cfg.T, self.cfg.buf_entries)
            if lv.entries <= cap:
                continue
            lo_key = int(lv.min_keys.min())
            hi_key = int(lv.max_keys.max())
            width = max(1, (hi_key - lo_key + 1) // self.parts)
            if self.select == "overlap":
                cur, key_hi = self._pick_overlap(store, level, lo_key,
                                                 hi_key, width)
            else:
                cur = self._cursors.get(level, lo_key)
                if cur < lo_key or cur > hi_key:
                    cur = lo_key
                key_hi = hi_key + 1 if cur + width > hi_key else cur + width
                self._cursors[level] = key_hi
            return [MergePlan(kind="partial", level=level,
                              run_ids=tuple(range(lv.num_runs)),
                              target_level=level + 1,
                              drop_tombstones=level + 1 >= deepest,
                              key_lo=cur, key_hi=key_hi)]
        return []


class TombstoneTTLPlanner(CompactionPolicy):
    """K-LSM triggers plus tombstone-TTL sweeps bounding delete persistence.

    The store stamps every run with the flush-sequence of its *oldest*
    tombstone (``tomb_seq``); once a tombstone has aged ``ttl_flushes``
    logical flushes, maintenance compacts its level into the next one,
    cascading until the tombstone reaches the deepest populated level and is
    physically dropped.  After every flush's maintenance pass, no run holds
    a tombstone older than the TTL — the invariant the paper's
    delete-persistence discussion (and FADE) asks for — while deletes
    *never* resurface because drops still only happen below all live data."""

    has_maintenance = True

    def __init__(self, cfg, ttl_flushes: int = 16):
        super().__init__(cfg)
        self.ttl_flushes = int(ttl_flushes)

    def plan_maintenance(self, store, stats, clock: int) -> List[MergePlan]:
        run_counts = [lv.num_runs for lv in store.levels]
        deepest = max((i + 1 for i, r in enumerate(run_counts) if r),
                      default=0)
        for i, lv in enumerate(store.levels):
            level = i + 1
            if lv.num_runs == 0:
                continue
            expired = any(ts >= 0 and clock - ts >= self.ttl_flushes
                          for ts in lv.tomb_seqs)
            if not expired:
                continue
            if level == deepest:
                # bottom of the tree: squeeze in place, dropping tombstones
                return [MergePlan(kind="clamp", level=level,
                                  run_ids=tuple(range(lv.num_runs)),
                                  target_level=level, drop_tombstones=True)]
            # the spill output lands ABOVE the target level's live runs, so
            # tombstones must survive until they reach the deepest level
            return [MergePlan(kind="spill", level=level,
                              run_ids=tuple(range(lv.num_runs)),
                              target_level=level + 1,
                              drop_tombstones=False)]
        return []


#: policy name -> planner class; ``EngineConfig.policy`` selects from here.
POLICIES = {
    "klsm": KLSMPlanner,
    "lazy_leveling": LazyLevelingPlanner,
    "partial": PartialCompactionPlanner,
    "tombstone_ttl": TombstoneTTLPlanner,
}


def make_planner(cfg) -> CompactionPolicy:
    """Build the planner named by ``cfg.policy`` (params from
    ``cfg.policy_params``, a tuple of (name, value) pairs)."""
    try:
        cls = POLICIES[cfg.policy]
    except KeyError:
        raise ValueError(f"unknown compaction policy {cfg.policy!r}; "
                         f"known: {sorted(POLICIES)}") from None
    return cls(cfg, **dict(getattr(cfg, "policy_params", ())))
