"""Deterministic, seeded fault injection: chaos scenarios as spec data.

The port's own copy of ``repro/faults/spec.py`` (stdlib only).  A
:class:`FaultSpec` declares one fault population (what kind, which worker
shards, how many attempts, with what probability); a tuple of them rides on
``ExperimentSpec.faults`` and round-trips through JSON like every other
axis.  A :class:`FaultPlan` compiles the tuple into a pure decision
function: every injection decision is a counter-free hash draw over
``(seed, kind, shard, attempt)``, so the same schedule fires on the same
shards and attempts as the JAX package's, run after run, independent of
thread interleaving.

Fault taxonomy (``FaultSpec.kind``):

* ``"crash"``   — the worker process dies before doing any work (preemption);
* ``"hang"``    — the worker sleeps past any reasonable deadline (the
  backend's per-shard timeout is the detector);
* ``"slow"``    — the worker sleeps ``delay_s`` then completes (straggler);
* ``"corrupt"`` — the worker completes but ships a truncated result pickle;
* ``"torn_write"`` — an artifact write is cut short mid-file *at the final
  path*, exercising the checksum validation every artifact loader performs.

The worker kinds fire in the subprocess backend
(:class:`repro_torch.api.SubprocessBackend`), inside its worker processes.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Tuple

#: worker-scoped kinds are injected inside the worker process; artifact
#: kinds are injected in the artifact-write path of the parent.
WORKER_KINDS = ("crash", "hang", "slow", "corrupt")
ARTIFACT_KINDS = ("torn_write",)
KINDS = WORKER_KINDS + ARTIFACT_KINDS

#: a hung worker sleeps this long (forever, at sweep timescales); the
#: backend's per-shard timeout is what bounds the damage.
HANG_SLEEP_S = 6 * 3600.0


def u01(*key) -> float:
    """A uniform [0, 1) draw as a pure hash of the key tuple.

    Counter-free by construction: the draw for one ``(seed, kind, shard,
    attempt)`` coordinate never depends on how many other draws happened or
    in what order, which is what keeps a multi-threaded fault schedule
    deterministic."""
    h = hashlib.blake2b(repr(key).encode(), digest_size=8).digest()
    return int.from_bytes(h, "big") / 2.0 ** 64


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One declarative fault population.

    A fault *fires* for worker-shard coordinate ``(shard, attempt)`` when
    all three hold:

    * ``shards`` is empty (match every shard) or contains ``shard``;
    * ``attempt < max_hits`` — a bounded fault retires after its first
      ``max_hits`` attempts per shard, so retry/re-shard can make progress
      (``max_hits`` large enough models a permanently dead worker);
    * the deterministic draw ``u01(seed, kind, shard, attempt) < p``.

    ``torn_write`` faults target artifact writes instead: they fire for a
    file whose basename contains ``match`` (empty = every artifact) with
    probability ``p`` drawn over ``(seed, kind, basename)``.

    ``delay_s`` is the injected latency of ``slow`` faults; ``hang``
    ignores it and sleeps effectively forever (the backend timeout is the
    recovery path under test)."""

    kind: str
    p: float = 1.0
    max_hits: int = 1
    shards: Tuple[int, ...] = ()
    delay_s: float = 0.0
    match: str = ""
    seed: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {sorted(KINDS)}")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"fault probability p={self.p} outside [0, 1]")
        if self.max_hits < 0:
            raise ValueError(f"max_hits={self.max_hits} must be >= 0")
        if self.delay_s < 0:
            raise ValueError(f"delay_s={self.delay_s} must be >= 0")

    def fires_worker(self, shard: int, attempt: int) -> bool:
        if self.kind not in WORKER_KINDS:
            return False
        if self.shards and shard not in self.shards:
            return False
        if attempt >= self.max_hits:
            return False
        return u01(self.seed, self.kind, shard, attempt) < self.p

    def fires_write(self, basename: str) -> bool:
        if self.kind not in ARTIFACT_KINDS:
            return False
        if self.match and self.match not in basename:
            return False
        return u01(self.seed, self.kind, basename) < self.p


@dataclasses.dataclass(frozen=True)
class FaultAction:
    """One resolved injection, shipped to the worker inside its job pickle
    (plain data)."""

    kind: str
    delay_s: float = 0.0


class FaultPlan:
    """A compiled fault schedule: the pure decision functions the execution
    layer consults.  Stateless and thread-safe; an empty plan answers
    ``None``/``False`` everywhere, which is the production fast path."""

    __slots__ = ("specs",)

    def __init__(self, specs: Tuple[FaultSpec, ...] = ()):
        self.specs = tuple(specs)

    @classmethod
    def from_specs(cls, specs) -> "FaultPlan":
        return cls(tuple(specs))

    def __bool__(self) -> bool:
        return bool(self.specs)

    def worker_fault(self, shard: int, attempt: int) -> Optional[FaultAction]:
        """The fault (if any) injected into worker ``shard``'s
        ``attempt``-th launch; first matching spec wins."""
        for s in self.specs:
            if s.fires_worker(shard, attempt):
                return FaultAction(kind=s.kind, delay_s=s.delay_s)
        return None

    def tears_write(self, basename: str) -> bool:
        """Whether the write of artifact ``basename`` is torn mid-file."""
        return any(s.fires_write(basename) for s in self.specs)
