"""Plain PyTorch version of the stable two-way merge (kernel 2).

The merge-path algorithm of ``csrc/merge.cu`` and of the JAX package's
Pallas tile (``repro/kernels/merge/kernel.py:33``), vectorised over output
positions: every position ``m`` binary-searches its split ``i`` on the
diagonal with the rule ``take_more_a = !(B[m-i-1] < A[i])`` (A newer, so A
comes first on equal keys), then gathers from A or B.  Keys are the
engine's ordered int64 form, values int64.  It runs on any device; the
port's wrapper uses it only for CPU tensors.
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
