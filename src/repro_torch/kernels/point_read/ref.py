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

:func:`point_read_sampled_ref` is the twin of the CUDA kernel
(``csrc/point_read.cu``): the same function by the kernel's algorithm —
the modulo by each run's reciprocal, and the search through the run's
sample (the top level bisected, a node a level below it, the window of
``stride`` keys) — so that the CPU tests hold the kernel's design
against the JAX package.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ...utils.u64 import (mod_magic, ordered_to_bits, splitmix64, umod,
                          umod_magic)


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


def _bisect(arr: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
            q: torch.Tensor, span: int) -> torch.Tensor:
    """Per key, the first index in ``[lo, hi)`` whose ``arr`` entry is not
    below ``q`` (``hi`` if none), for ranges of at most ``span`` entries:
    ``span.bit_length()`` masked halvings."""
    top = max(arr.shape[0] - 1, 0)
    for _ in range(max(1, int(span).bit_length())):
        active = lo < hi
        mid = (lo + hi) >> 1
        less = arr[torch.clamp(mid, 0, top)] < q
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    return lo


def point_read_sampled_ref(q: torch.Tensor, arena_keys: torch.Tensor,
                           arena_vals: torch.Tensor, layout
                           ) -> Tuple[torch.Tensor, ...]:
    """(hit, enc, probes, reads, fps), each (B,), by the kernel's
    algorithm, for ordered keys ``q`` against the level whose
    ``ops.LevelLayout`` is ``layout`` (with its sample,
    ``ops.sample_runs``).

    Per run, newest to oldest: the Bloom test with each hash reduced by
    ``umod_magic`` (the hashes computed once); for a run with a sample, the
    count c of level-1 entries below the key (``_sample_count``), then the
    window of ``stride`` keys from ``(c-1) stride + 1`` (from 0 when c is
    0): the key is found where one of them equals it, at the window's
    start plus the number below it; a run without one takes a plain lower
    bound."""
    B = q.shape[0]
    dev = q.device
    s = layout.stride
    starts, ks, n_bits = layout.starts, layout.ks, layout.n_bits
    R = len(starts) - 1
    bits = ordered_to_bits(q)
    hs = [splitmix64(bits, j + 1) for j in range(max(ks, default=0))]

    hit = torch.zeros(B, dtype=torch.bool, device=dev)
    enc = torch.zeros(B, dtype=torch.int64, device=dev)
    live = torch.ones(B, dtype=torch.bool, device=dev)
    probes = torch.zeros(B, dtype=torch.int64, device=dev)
    reads = torch.zeros(B, dtype=torch.int64, device=dev)
    fps = torch.zeros(B, dtype=torch.int64, device=dev)
    window = torch.arange(s, device=dev)

    def full(v):
        return torch.full((B,), v, dtype=torch.int64, device=dev)

    for r in range(R):                    # newest -> oldest
        probes = probes + live
        bloom_ok = torch.ones(B, dtype=torch.bool, device=dev)
        magic = mod_magic(n_bits[r])
        for j in range(ks[r]):
            hm = umod_magic(hs[j], n_bits[r], magic)
            w = layout.words[layout.word_off[r] + (hm >> 6)]
            bloom_ok &= ((w >> (hm & 63)) & 1).bool()
        pos = live & bloom_ok
        reads = reads + pos
        s0, e = starts[r], starts[r + 1]
        found = torch.zeros(B, dtype=torch.bool, device=dev)
        if e > s0:
            in_fence = pos & (q >= layout.fence_lo[r]) & \
                (q <= layout.fence_hi[r])
            if layout.top_level[r] == 0:  # a short run: no sample
                lo = _bisect(arena_keys, full(s0), full(e), q, e - s0)
                safe = torch.clamp(lo, s0, e - 1)
                found = in_fence & (lo < e) & (arena_keys[safe] == q)
            else:
                c = _sample_count(q, layout, r, e - s0)
                base = torch.where(c == 0, 0, (c - 1) * s + 1)
                idx = s0 + base[:, None] + window
                valid = idx < e
                wk = arena_keys[torch.clamp(idx, max=e - 1)]
                below = (valid & (wk < q[:, None])).sum(dim=1)
                found = in_fence & (valid & (wk == q[:, None])).any(dim=1)
                safe = torch.clamp(s0 + base + below, max=e - 1)
            hit = hit | found
            enc = torch.where(found, arena_vals[safe], enc)
            live = live & ~found
        fps = fps + (pos & ~found)
    return hit, enc, probes, reads, fps


def _sample_count(q: torch.Tensor, layout, r: int, n: int) -> torch.Tensor:
    """Per key, the number of run r's level-1 sample entries below it: the
    count at the top level f, bisected, then down the levels: at level l
    the node (``fanout`` adjacent entries) under the level-(l+1) count c
    starts at ``fanout * (c-1)`` (under c = 0 the count stays 0), and the
    count there is the node's start plus its entries below the key."""
    fo = layout.fanout
    f = layout.top_level[r]
    to, tn = layout.top_off[r], layout.top_off[r + 1] - layout.top_off[r]
    c = _bisect(layout.top, torch.full_like(q, to),
                torch.full_like(q, to + tn), q, tn) - to
    sizes = [0] + level_sizes(n, layout.stride, fo)
    node = torch.arange(fo, device=q.device)
    for lvl in range(f - 1, 0, -1):
        off = layout.sample_off[r] + sum(sizes[1:lvl])
        start = torch.clamp((c - 1) * fo, min=0)
        below = (layout.sample[off + start[:, None] + node]
                 < q[:, None]).sum(dim=1)
        c = torch.where(c > 0, start + below, 0)
    return c


def level_sizes(n: int, stride: int, fanout: int):
    """The entries of sample levels 1, 2, ... of a run of ``n`` entries
    (level 1 every ``stride``-th key, each later level every
    ``fanout``-th entry of the one below), down to one entry, each padded
    to a multiple of ``fanout``."""
    sizes, m = [], -(-n // stride)
    while True:
        sizes.append(-(-m // fanout) * fanout)
        if m <= 1:
            return sizes
        m = -(-m // fanout)
