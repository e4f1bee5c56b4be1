"""Plain PyTorch version of the stable two-way merge (kernel 2).

The merge-path algorithm of ``csrc/merge.cu`` and of the JAX package's
Pallas tile (``repro/kernels/merge/kernel.py:33``), vectorised over output
positions: every position ``m`` binary-searches its split ``i`` on the
diagonal with the rule ``take_more_a = !(B[m-i-1] < A[i])`` (A newer, so A
comes first on equal keys), then gathers from A or B.  Keys are the
engine's ordered int64 form, values int64.  It runs on any device; the
port's wrapper uses it only for CPU tensors.

:func:`merge_tiled_ref` is the kernels' own algorithm (tiles, per-thread
splits, keep flags, offsets) in plain Python, for the tests at small tile
sizes; nothing else calls it.
"""

from __future__ import annotations

from typing import Tuple

import torch


def two_way_merge_ref(a_keys: torch.Tensor, a_vals: torch.Tensor,
                      b_keys: torch.Tensor, b_vals: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable interleave of (A newer, B older); (keys, vals) of |A|+|B|."""
    na, nb = a_keys.shape[0], b_keys.shape[0]
    n = na + nb
    dev = a_keys.device
    m = torch.arange(n, dtype=torch.int64, device=dev)
    lo = torch.clamp(m - nb, min=0)
    hi = torch.clamp(m, max=na)
    for _ in range(max(1, n.bit_length() + 1)):
        active = lo < hi
        i = (lo + hi) >> 1
        a_cand = a_keys[torch.clamp(i, 0, max(na - 1, 0))] if na else m
        b_cand = b_keys[torch.clamp(m - i - 1, 0, max(nb - 1, 0))] \
            if nb else m
        take_more_a = ~(b_cand < a_cand)
        lo = torch.where(active & take_more_a, i + 1, lo)
        hi = torch.where(active & ~take_more_a, i, hi)
    i = lo
    j = m - i
    ia = torch.clamp(i, 0, max(na - 1, 0))
    jb = torch.clamp(j, 0, max(nb - 1, 0))
    if na == 0:
        return b_keys[jb], b_vals[jb]
    if nb == 0:
        return a_keys[ia], a_vals[ia]
    a_key, b_key = a_keys[ia], b_keys[jb]
    take_a = (i < na) & ((j >= nb) | (a_key <= b_key))
    return (torch.where(take_a, a_key, b_key),
            torch.where(take_a, a_vals[ia], b_vals[jb]))


def _split(a, b, d: int) -> int:
    """The merge-path split of diagonal ``d`` of lists ``a`` (newer) and
    ``b``: the smallest ``i`` with ``b[d-i-1] < a[i]``, by binary search,
    as each thread of a tile searches its windows."""
    lo, hi = max(0, d - len(b)), min(d, len(a))
    while lo < hi:
        i = (lo + hi) >> 1
        if not b[d - i - 1] < a[i]:
            lo = i + 1
        else:
            hi = i
    return lo


def split_kary(a, b, d: int, ways: int = 32) -> int:
    """The same split by the partition's search: each round probes
    ``ways`` evenly spaced ``i`` (one a lane of the group that owns the
    boundary; the kernel takes 32, or 8 from 1,024 tiles) and
    keeps the segment where the test turns true."""
    lo, hi = max(0, d - len(b)), min(d, len(a))
    while lo < hi:
        step = -(-(hi - lo) // ways)
        probes = [lo + lane * step for lane in range(ways)]
        right = [p < hi and b[d - p - 1] < a[p] for p in probes]
        if any(right):
            f = right.index(True)
            top = lo + f * step
            lo, hi = (top - step + 1 if f else top), top
        else:
            lo += (hi - 1 - lo) // step * step + 1
    return lo


def merge_tiled_ref(a_keys: torch.Tensor, a_vals: torch.Tensor,
                    b_keys: torch.Tensor, b_vals: torch.Tensor, tile: int,
                    k: int, drop: bool = True, ways: int = 32
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stages of ``csrc/merge.cu`` in Python, for tests at small tiles
    of ``tile`` outputs, ``k`` per thread: the partition (each tile
    boundary's split in the whole runs, by :func:`split_kary` with
    ``ways`` probes a round), each tile's merge (each thread's
    split at diagonal ``thread * k`` of the tile's windows, then ``k``
    outputs serially), the keep flags (a thread's first output against the
    larger of the last A and last B before its split, the tile's first
    against the same in the whole runs), the tiles' kept counts, their
    offsets (an exclusive scan, which the kernel's look-back computes) and
    the compaction.  With ``drop=False`` every output is kept (the
    interleave, ``two_way_merge``'s function)."""
    a, av = a_keys.tolist(), a_vals.tolist()
    b, bv = b_keys.tolist(), b_vals.tolist()
    n = len(a) + len(b)
    ntiles = -(-n // tile)
    splits = [split_kary(a, b, min(t * tile, n), ways)
              for t in range(ntiles + 1)]
    tiles = []
    for t in range(ntiles):
        d0, i0 = t * tile, splits[t]
        j0, la = d0 - i0, splits[t + 1] - i0
        lb = min(tile, n - d0) - la
        sa, sva = a[i0:i0 + la], av[i0:i0 + la]
        sb, svb = b[j0:j0 + lb], bv[j0:j0 + lb]
        before = a[i0 - 1:i0] + b[j0 - 1:j0] if t else []
        tile_pred = max(before) if before else None
        kept = []
        for th in range(tile // k):
            diag = min(th * k, la + lb)
            i = _split(sa, sb, diag)
            j = diag - i
            before = sa[i - 1:i] + sb[j - 1:j] if i + j else []
            prev = max(before) if diag else tile_pred
            for _ in range(min(k, la + lb - diag)):
                take_a = i < la and (j >= lb or sa[i] <= sb[j])
                key, val = (sa[i], sva[i]) if take_a else (sb[j], svb[j])
                i, j = (i + 1, j) if take_a else (i, j + 1)
                if not drop or prev is None or key != prev:
                    kept.append((key, val))
                prev = key
        tiles.append(kept)
    counts = [len(kept) for kept in tiles]
    offsets = [sum(counts[:t]) for t in range(ntiles)]
    keys = torch.empty(sum(counts), dtype=torch.int64)
    vals = torch.empty(sum(counts), dtype=torch.int64)
    for off, kept in zip(offsets, tiles):
        for r, (key, val) in enumerate(kept):
            keys[off + r], vals[off + r] = key, val
    return keys, vals
