"""Bloom filters with Monkey-style per-level memory allocation, on tensors.

The port of ``repro/lsm/bloom.py``: the same splitmix64 hashing with
per-hash-function seeds 1..k, the same little-endian word layout (bit
``b`` of word ``w`` is filter bit ``64 w + b``), so filters are bit-identical
to the JAX package's.  Hashes and words are int64 bit patterns
(``utils/u64.py``); :func:`build_words` runs as torch ops on the device that
holds the run.

Two probe granularities, as there:

* :class:`BloomFilter` — one filter over one run (scalar + batch probes);
* :class:`BloomPack`   — the filters of every run of a level in one padded
  ``(runs, words)`` matrix, probed for a whole key batch with k shared hash
  rounds, bit for bit per-run ``might_contain``.

Both take uint64 keys on the host and answer on the host; their words live
on ``device`` (the card unless ``device="cpu"``).  The engine does not use
them: its levels keep packed words beside their arenas (``lsm/store.py``).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from ..kernels._compat import resolve_device
from ..utils.u64 import (_MIX1, _MIX2, MASK64, SPLITMIX_GAMMA, lsr,
                         ordered_to_bits, splitmix64, to_device_keys, umod)


def splitmix64_seeds(x: torch.Tensor, kmax: int) -> torch.Tensor:
    """All k hash rounds at once: ``(kmax, len(x))`` bit patterns, row j
    bit-identical to ``splitmix64(x, j + 1)``."""
    return torch.stack([splitmix64(x, j + 1) for j in range(kmax)])


def splitmix64_scalar(x: int, seed: int) -> int:
    """Scalar splitmix64 on Python ints, bit-identical to
    :func:`splitmix64` (the JAX package's function, verbatim)."""
    z = (x + seed * SPLITMIX_GAMMA) & MASK64
    z = ((z ^ (z >> 30)) * _MIX1) & MASK64
    z = ((z ^ (z >> 27)) * _MIX2) & MASK64
    return z ^ (z >> 31)


def _key_bits(keys, device) -> torch.Tensor:
    """uint64 host keys -> their bit patterns (int64) on ``device``."""
    keys = np.ascontiguousarray(np.asarray(keys, np.uint64))
    return torch.from_numpy(keys.view(np.int64)).to(device)


def _test_bits(words: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Filter bit ``h`` (a non-negative bit index) of ``words``."""
    return ((words[h >> 6] >> (h & 63)) & 1).bool()


def bloom_params(n_keys: int, bits_per_key: float) -> Tuple[int, int]:
    """(n_bits, k) for a run of ``n_keys`` keys — the engine-wide layout."""
    n_bits = max(64, int(math.ceil(bits_per_key * max(n_keys, 1))))
    k = max(1, int(round(bits_per_key * math.log(2))))
    return n_bits, k


def build_words(okeys: torch.Tensor, n_bits: int, k: int) -> torch.Tensor:
    """The packed filter of a run of ordered keys, as int64 words.

    Every (round, key) bit position is scattered into a byte-per-bit
    bitmap, then each 8 bits pack into a byte (``sum(bit << b)``: the bits
    are distinct, so the sum is the OR) and each 8 little-endian bytes read
    as one int64 word — the byte order ``np.packbits(bitorder="little")
    .view(np.uint64)`` gives the JAX package's words."""
    n_words = (n_bits + 63) // 64
    dev = okeys.device
    bitmap = torch.zeros(n_words * 64, dtype=torch.uint8, device=dev)
    if okeys.shape[0]:
        bits = ordered_to_bits(okeys)
        for j in range(k):
            bitmap[umod(splitmix64(bits, j + 1), n_bits)] = 1
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    packed = (bitmap.view(-1, 8) << shifts).sum(dim=1, dtype=torch.uint8)
    return packed.view(torch.int64)


class BloomFilter:
    """Standard Bloom filter over uint64 keys; ``bits_per_key`` chooses the
    optimal number of hash functions k = bits_per_key * ln 2."""

    __slots__ = ("n_bits", "k", "words", "n_keys")

    def __init__(self, keys, bits_per_key: float, device=None):
        keys = np.asarray(keys, np.uint64)
        self.n_keys = len(keys)
        self.n_bits, self.k = bloom_params(self.n_keys, bits_per_key)
        self.words = build_words(to_device_keys(keys, resolve_device(device)),
                                 self.n_bits, self.k)

    def might_contain(self, key: int) -> bool:
        key = int(key)
        h = [splitmix64_scalar(key, j) % self.n_bits
             for j in range(1, self.k + 1)]
        idx = torch.tensor(h, dtype=torch.int64, device=self.words.device)
        return bool(_test_bits(self.words, idx).all())

    def might_contain_batch(self, keys) -> np.ndarray:
        bits = _key_bits(keys, self.words.device)
        out = torch.ones(bits.shape, dtype=torch.bool, device=bits.device)
        for j in range(self.k):
            out &= _test_bits(self.words,
                              umod(splitmix64(bits, j + 1), self.n_bits))
        return out.cpu().numpy()

    @property
    def bits_used(self) -> int:
        return self.n_bits


class BloomPack:
    """All Bloom filters of one level, packed for whole-level batch probes.

    ``words`` is a ``(runs, max_words)`` int64 matrix, rows zero-padded to
    the widest filter (padding is never addressed: hashes are reduced mod
    the row's own ``n_bits``).  ``words_list`` holds each run's words, as
    int64 tensors or uint64 arrays."""

    __slots__ = ("words", "n_bits", "ks", "n_runs")

    def __init__(self, words_list: Sequence, n_bits: Sequence[int],
                 ks: Sequence[int], device=None):
        dev = resolve_device(device)
        rows = [w if isinstance(w, torch.Tensor)
                else _key_bits(w, dev) for w in words_list]
        self.n_runs = len(rows)
        wmax = max((len(w) for w in rows), default=0)
        self.words = torch.zeros((self.n_runs, wmax), dtype=torch.int64,
                                 device=dev)
        for r, w in enumerate(rows):
            self.words[r, :len(w)] = w.to(dev)
        self.n_bits = torch.tensor(list(n_bits), dtype=torch.int64,
                                   device=dev)
        self.ks = torch.tensor(list(ks), dtype=torch.int64, device=dev)

    def probe(self, keys) -> np.ndarray:
        """(runs, batch) bool: bit-identical to per-run ``might_contain``."""
        bits = _key_bits(keys, self.words.device)
        R, B = self.n_runs, bits.shape[0]
        if R == 0 or B == 0:
            return np.ones((R, B), bool)
        kmax = int(self.ks.max())
        h = splitmix64_seeds(bits, kmax)                       # (kmax, B)
        hm = umod(h[None], self.n_bits[:, None, None])          # (R, kmax, B)
        rows = torch.arange(R, device=bits.device)[:, None, None]
        w = self.words[rows, lsr(hm, 6)]
        hit = ((w >> (hm & 63)) & 1).bool()
        # rounds past a run's own k never veto that run
        rounds = torch.arange(kmax, device=bits.device)[None, :, None]
        hit |= rounds >= self.ks[:, None, None]
        return hit.all(dim=1).cpu().numpy()


def monkey_bits_per_key(level: int, num_levels: int, T: float,
                        mfilt_bits: float, N: float) -> float:
    """Invert Eq. 3: level-i FPR -> bits/key = -ln(f_i) / ln(2)^2, floored at 0.

    f_i(T) = T^{T/(T-1)} / T^{L+1-i} * exp(-(m_filt/N) ln(2)^2)
    """
    ln2sq = math.log(2) ** 2
    log_f = ((T / (T - 1.0)) * math.log(T)
             - (num_levels + 1.0 - level) * math.log(T)
             - (mfilt_bits / N) * ln2sq)
    log_f = min(log_f, 0.0)
    return max(0.0, -log_f / ln2sq)
