"""Bloom filters with Monkey-style per-level memory allocation, on tensors.

The port of ``repro/lsm/bloom.py``: the same splitmix64 hashing with
per-hash-function seeds 1..k, the same little-endian word layout (bit
``b`` of word ``w`` is filter bit ``64 w + b``), so filters are bit-identical
to the JAX package's.  Hashes and words are int64 bit patterns
(``utils/u64.py``); :func:`build_words` runs as torch ops on the device that
holds the run.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..utils.u64 import ordered_to_bits, splitmix64, umod


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
