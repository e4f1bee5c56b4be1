"""Dispatch for the compaction merge (kernel 2).

* :func:`two_way_merge` — one stable two-way merge, the Pallas kernel's
  function: the interleave of A (newer) and B (older), duplicates kept,
  A first on equal keys.
* :func:`merge_newest_wins` — one fold step: that merge, then the drop of
  adjacent equal keys, keeping the first (A's, the newest).
* :func:`merge_runs` — the engine's k-way newest-wins merge, the fold of
  ``repro/kernels/merge/ops.py:45-59``: runs come newest first; each step
  is :func:`merge_newest_wins` of the accumulated (newer) run and the next
  (older) one.  Newest-wins is associative, so the fold equals the JAX
  package's global stable argsort-merge
  (``lsm/merge_path.py::merge_runs_numpy``) bit for bit.

For CUDA tensors both entries launch ``csrc/merge.cu`` (a partition launch
and a tile launch; with the drop, the tile launch also compacts, and the
kept total comes back to the host once to size the output, which is then
a view of the first ``n_out`` entries of an ``na + nb`` buffer).  For CPU
tensors they run the plain versions (``ref.two_way_merge_ref``, then
:func:`drop_adjacent_duplicates`).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

from .. import _build
from .._build import I32, I64, P
from .ref import two_way_merge_ref

_LAUNCH_ARGS = (P, P, I64, P, P, I64, P, P, P, I32, P)


@functools.lru_cache(maxsize=None)
def _tile() -> int:
    """Outputs per block of ``csrc/merge.cu``, as its library exports them
    (the scratch holds a few words per tile)."""
    return _build.library_int("merge", "merge_tile_entries")


def _device_of(ts) -> torch.device:
    if any(t.dtype != torch.int64 or t.dim() != 1 for t in ts):
        raise TypeError("merge takes 1-D int64 keys and values")
    if ts[0].shape != ts[1].shape or ts[2].shape != ts[3].shape:
        raise ValueError("merge: keys and values differ in length")
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("merge: tensors on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"merge: no kernel for device {dev}")
    return dev


def _launch(ts, drop: bool, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    a_keys, a_vals, b_keys, b_vals = (t.contiguous() for t in ts)
    na, nb = a_keys.shape[0], b_keys.shape[0]
    out_k = torch.empty(na + nb, dtype=torch.int64, device=dev)
    out_v = torch.empty(na + nb, dtype=torch.int64, device=dev)
    if na + nb == 0:
        return out_k, out_v
    ntiles = -(-(na + nb) // _tile())
    scratch = torch.empty(2 * ntiles + 3, dtype=torch.int64, device=dev)
    fn = _build.kernel_fn("merge", "merge_launch", _LAUNCH_ARGS)
    _build.launch("merge", fn, a_keys.data_ptr(), a_vals.data_ptr(), na,
                  b_keys.data_ptr(), b_vals.data_ptr(), nb, out_k.data_ptr(),
                  out_v.data_ptr(), scratch.data_ptr(), int(drop),
                  device=dev)
    if not drop:
        return out_k, out_v
    n_out = int(scratch[-1].item())
    return out_k[:n_out], out_v[:n_out]


def two_way_merge(a_keys: torch.Tensor, a_vals: torch.Tensor,
                  b_keys: torch.Tensor, b_vals: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable interleave of (A newer, B older), int64 keys and values."""
    ts = (a_keys, a_vals, b_keys, b_vals)
    dev = _device_of(ts)
    if dev.type == "cpu":
        return two_way_merge_ref(*ts)
    return _launch(ts, False, dev)


def drop_adjacent_duplicates(keys: torch.Tensor, vals: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the first of each run of equal adjacent keys (the newest)."""
    keep = torch.ones_like(keys, dtype=torch.bool)
    keep[1:] = keys[1:] != keys[:-1]
    return keys[keep], vals[keep]


def merge_newest_wins(a_keys: torch.Tensor, a_vals: torch.Tensor,
                      b_keys: torch.Tensor, b_vals: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fold step: the stable merge of (A newer, B older) with adjacent
    equal keys dropped, the first (newest) kept."""
    ts = (a_keys, a_vals, b_keys, b_vals)
    dev = _device_of(ts)
    if dev.type == "cpu":
        return drop_adjacent_duplicates(*two_way_merge_ref(*ts))
    return _launch(ts, True, dev)


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
        acc_k, acc_v = merge_newest_wins(acc_k, acc_v, k, v)
    return acc_k, acc_v
