"""Deterministic, shard-aware, resumable synthetic token pipeline.

The port's copy of ``repro/data/pipeline.py`` (numpy only, so the batches
are the JAX package's bit for bit).

Batches are a pure function of (seed, step, shard) — so any worker can
recompute any batch, which is the foundation for:

* exactly-once semantics across checkpoint/restart (the cursor is one int),
* straggler/failure reassignment (a surviving worker re-derives a lost
  shard's batches deterministically),
* elastic re-sharding (changing the shard count re-partitions the same
  global stream).

The synthetic stream is a mixture of structured sequences (arithmetic-mod
chains, repeated motifs) so that a real LM can actually reduce loss on it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 1024
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 1234


@dataclasses.dataclass
class DataState:
    """The resumable cursor (saved in checkpoints)."""
    step: int = 0

    def to_dict(self) -> Dict[str, int]:
        return {"step": self.step}

    @classmethod
    def from_dict(cls, d: Dict[str, int]) -> "DataState":
        return cls(step=int(d["step"]))


def _sequence(rng: np.random.Generator, V: int, S: int) -> np.ndarray:
    """One structured sequence: motif repetition + modular ramps."""
    kind = rng.integers(0, 3)
    if kind == 0:  # repeated motif
        m = rng.integers(2, 9)
        motif = rng.integers(0, V, m)
        reps = -(-(S + 1) // m)
        seq = np.tile(motif, reps)[:S + 1]
    elif kind == 1:  # modular ramp
        start = rng.integers(0, V)
        stride = rng.integers(1, 7)
        seq = (start + stride * np.arange(S + 1)) % V
    else:  # noisy copy of a short prefix
        p = rng.integers(4, 16)
        prefix = rng.integers(0, V, p)
        reps = -(-(S + 1) // p)
        seq = np.tile(prefix, reps)[:S + 1]
        flips = rng.random(S + 1) < 0.05
        seq = np.where(flips, rng.integers(0, V, S + 1), seq)
    return seq.astype(np.int32)


def global_batch_at(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """The full (tokens, labels) global batch for a step (pure function)."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    seqs = np.stack([_sequence(rng, cfg.vocab_size, cfg.seq_len)
                     for _ in range(cfg.global_batch)])
    return {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}


def shard_batch_at(cfg: DataConfig, step: int, shard: int,
                   num_shards: int) -> Dict[str, np.ndarray]:
    """This shard's slice of the step's global batch."""
    assert cfg.global_batch % num_shards == 0
    per = cfg.global_batch // num_shards
    full = global_batch_at(cfg, step)
    sl = slice(shard * per, (shard + 1) * per)
    return {k: v[sl] for k, v in full.items()}


def iterate(cfg: DataConfig, state: Optional[DataState] = None,
            shard: int = 0, num_shards: int = 1
            ) -> Iterator[Dict[str, np.ndarray]]:
    state = state or DataState()
    while True:
        yield shard_batch_at(cfg, state.step, shard, num_shards)
        state.step += 1
