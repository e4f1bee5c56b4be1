"""Plain PyTorch version of the fused per-level point read (kernel 3).

The op order of the JAX package's Pallas tile
(``repro/kernels/point_read/kernel.py:39``) and dense reference
(``ref.py``), vectorised over the key batch with masks: k splitmix64 rounds
shared across runs, then per run, newest to oldest, ``probes += live``, the
Bloom bit test mod the run's ``n_bits``, ``reads += pos``, the fence window
and a branchless lower-bound search over the run's arena slice, and
``fps += pos & ~found``.  Keys are the engine's ordered int64 form; hashes
take the uint64 bit pattern back (``utils/u64.py``).  Bloom words are one
flat int64 tensor with per-run word offsets.  It runs on any device; the
port's wrapper uses it only for CPU tensors.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ...utils.u64 import ordered_to_bits, splitmix64, umod


def point_read_level_ref(q: torch.Tensor, arena_keys: torch.Tensor,
                         arena_vals: torch.Tensor, starts: Sequence[int],
                         n_bits: Sequence[int], ks: Sequence[int],
                         fence_lo: Sequence[int], fence_hi: Sequence[int],
                         words: torch.Tensor, word_off: Sequence[int]
                         ) -> Tuple[torch.Tensor, ...]:
    """(hit, enc, probes, reads, fps), each (B,), for ordered keys ``q``
    against the level whose run layout is given as host sequences."""
    B = q.shape[0]
    dev = q.device
    R = len(starts) - 1
    kmax = max(ks) if R else 0
    bits = ordered_to_bits(q)
    hs = [splitmix64(bits, j + 1) for j in range(kmax)]

    hit = torch.zeros(B, dtype=torch.bool, device=dev)
    enc = torch.zeros(B, dtype=torch.int64, device=dev)
    live = torch.ones(B, dtype=torch.bool, device=dev)
    probes = torch.zeros(B, dtype=torch.int64, device=dev)
    reads = torch.zeros(B, dtype=torch.int64, device=dev)
    fps = torch.zeros(B, dtype=torch.int64, device=dev)

    for r in range(R):                    # newest -> oldest
        probes = probes + live
        bloom_ok = torch.ones(B, dtype=torch.bool, device=dev)
        for j in range(ks[r]):
            hm = umod(hs[j], n_bits[r])
            w = words[word_off[r] + (hm >> 6)]
            bloom_ok &= ((w >> (hm & 63)) & 1).bool()
        pos = live & bloom_ok
        reads = reads + pos
        s, e = starts[r], starts[r + 1]
        if e > s:
            in_fence = pos & (q >= fence_lo[r]) & (q <= fence_hi[r])
            lo = torch.full((B,), s, dtype=torch.int64, device=dev)
            hi = torch.full((B,), e, dtype=torch.int64, device=dev)
            for _ in range(max(1, (e - s - 1).bit_length() + 1)):
                active = lo < hi
                mid = (lo + hi) >> 1
                less = arena_keys[torch.clamp(mid, s, e - 1)] < q
                lo = torch.where(active & less, mid + 1, lo)
                hi = torch.where(active & ~less, mid, hi)
            safe = torch.clamp(lo, s, e - 1)
            found = in_fence & (lo < e) & (arena_keys[safe] == q)
            hit = hit | found
            enc = torch.where(found, arena_vals[safe], enc)
            live = live & ~found
        else:
            found = torch.zeros(B, dtype=torch.bool, device=dev)
        fps = fps + (pos & ~found)
    return hit, enc, probes, reads, fps
