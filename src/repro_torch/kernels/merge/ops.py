"""Dispatch for the compaction merge (kernel 2).

* :func:`two_way_merge` — one stable two-way merge: the CUDA kernel
  (``csrc/merge.cu``) for CUDA tensors, the plain version
  (``ref.two_way_merge_ref``) for CPU tensors.
* :func:`merge_runs` — the engine's k-way newest-wins merge, the fold of
  ``repro/kernels/merge/ops.py:45-59``: runs come newest first; each step
  merges the accumulated (newer) run with the next (older) one and drops
  adjacent duplicate keys, keeping the first (newest).  Newest-wins is
  associative, so the fold equals the JAX package's global stable
  argsort-merge (``lsm/merge_path.py::merge_runs_numpy``) bit for bit.  The
  duplicate drop runs on the device, as torch ops.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .. import _build
from .._build import I64, P
from .ref import two_way_merge_ref

_LAUNCH_ARGS = (P, P, I64, P, P, I64, P, P, P)


def two_way_merge(a_keys: torch.Tensor, a_vals: torch.Tensor,
                  b_keys: torch.Tensor, b_vals: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable interleave of (A newer, B older), int64 keys and values."""
    ts = (a_keys, a_vals, b_keys, b_vals)
    if any(t.dtype != torch.int64 or t.dim() != 1 for t in ts):
        raise TypeError("merge takes 1-D int64 keys and values")
    if a_keys.shape != a_vals.shape or b_keys.shape != b_vals.shape:
        raise ValueError("merge: keys and values differ in length")
    dev = a_keys.device
    if any(t.device != dev for t in ts):
        raise ValueError("merge: tensors on different devices")
    if dev.type == "cpu":
        return two_way_merge_ref(*ts)
    if dev.type != "cuda":
        raise ValueError(f"merge: no kernel for device {dev}")
    a_keys, a_vals, b_keys, b_vals = (t.contiguous() for t in ts)
    na, nb = a_keys.shape[0], b_keys.shape[0]
    out_k = torch.empty(na + nb, dtype=torch.int64, device=dev)
    out_v = torch.empty_like(out_k)
    if na + nb == 0:
        return out_k, out_v
    fn = _build.kernel_fn("merge", "merge_launch", _LAUNCH_ARGS)
    _build.launch("merge", fn, a_keys.data_ptr(), a_vals.data_ptr(), na,
                  b_keys.data_ptr(), b_vals.data_ptr(), nb, out_k.data_ptr(),
                  out_v.data_ptr(), device=dev)
    return out_k, out_v


def drop_adjacent_duplicates(keys: torch.Tensor, vals: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the first of each run of equal adjacent keys (the newest)."""
    keep = torch.ones_like(keys, dtype=torch.bool)
    keep[1:] = keys[1:] != keys[:-1]
    return keys[keep], vals[keep]


def merge_runs(keys_list: Sequence[torch.Tensor],
               vals_list: Sequence[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Newest-first k-way merge -> (sorted unique keys, newest values)."""
    acc_k, acc_v = keys_list[0], vals_list[0]
    for k, v in zip(keys_list[1:], vals_list[1:]):
        if k.shape[0] == 0:
            continue
        if acc_k.shape[0] == 0:
            acc_k, acc_v = k, v
            continue
        acc_k, acc_v = drop_adjacent_duplicates(
            *two_way_merge(acc_k, acc_v, k, v))
    return acc_k, acc_v
