"""Dispatch for the fused per-level point read (kernel 3).

:class:`LevelLayout` is one level's run layout — run offsets, Bloom
parameters, fence keys and the flat Bloom words — kept on the host for the
plain version and, for the kernel, as one small int64 table on the device
(built once per layout, not re-traced per layout as the Pallas kernel is).
:func:`point_read_level` launches the CUDA kernel (``csrc/point_read.cu``)
for CUDA tensors and runs the plain version (``ref.point_read_level_ref``)
for CPU tensors.  Both return per-key counters; the caller sums them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from .. import _build
from .._build import I32, I64, P
from .ref import point_read_level_ref

_LAUNCH_ARGS = (P, I64, P, P, P, I32, P, P, P, P, P, P, P)


@dataclasses.dataclass
class LevelLayout:
    """Run layout of one level (R runs, newest first).

    ``starts``/``word_off`` have R+1 entries; the others R.  Fence keys are
    in the ordered int64 form of the arenas.  ``words`` is every run's
    Bloom words back to back (int64 bit patterns), run r's at
    ``words[word_off[r]:word_off[r+1]]`` — flat, not padded to the widest
    run, so a tiered level pays no padding."""

    starts: List[int]
    n_bits: List[int]
    ks: List[int]
    fence_lo: List[int]
    fence_hi: List[int]
    word_off: List[int]
    words: torch.Tensor
    _table: Optional[torch.Tensor] = None

    @property
    def num_runs(self) -> int:
        return len(self.starts) - 1

    def table(self) -> torch.Tensor:
        """The (6, R+1) int64 layout table on the words' device."""
        if self._table is None:
            pad = [0]
            rows = [self.starts, self.n_bits + pad, self.ks + pad,
                    self.fence_lo + pad, self.fence_hi + pad, self.word_off]
            self._table = torch.tensor(rows, dtype=torch.int64).to(
                self.words.device)
        return self._table


def point_read_level(q: torch.Tensor, arena_keys: torch.Tensor,
                     arena_vals: torch.Tensor, layout: LevelLayout
                     ) -> Tuple[torch.Tensor, ...]:
    """(hit bool, enc, probes, reads, fps), each (B,), for ordered int64
    query keys ``q`` against one level's arenas."""
    ts = (q, arena_keys, arena_vals, layout.words)
    if any(t.dtype != torch.int64 or t.dim() != 1 for t in ts):
        raise TypeError("point_read takes 1-D int64 keys, arenas and words")
    dev = q.device
    if any(t.device != dev for t in ts):
        raise ValueError("point_read: tensors on different devices")
    if dev.type == "cpu":
        return point_read_level_ref(
            q, arena_keys, arena_vals, layout.starts, layout.n_bits,
            layout.ks, layout.fence_lo, layout.fence_hi, layout.words,
            layout.word_off)
    if dev.type != "cuda":
        raise ValueError(f"point_read: no kernel for device {dev}")
    if arena_keys.shape[0] != layout.starts[-1]:
        raise ValueError("point_read: arena length does not match layout")
    q, arena_keys, arena_vals = (t.contiguous() for t in
                                 (q, arena_keys, arena_vals))
    B = q.shape[0]
    hit = torch.empty(B, dtype=torch.bool, device=dev)
    enc = torch.empty(B, dtype=torch.int64, device=dev)
    probes = torch.empty_like(enc)
    reads = torch.empty_like(enc)
    fps = torch.empty_like(enc)
    if B == 0:
        return hit, enc, probes, reads, fps
    table = layout.table()
    fn = _build.kernel_fn("point_read", "point_read_launch", _LAUNCH_ARGS)
    _build.launch("point_read", fn, q.data_ptr(), B, arena_keys.data_ptr(),
                  arena_vals.data_ptr(), table.data_ptr(), layout.num_runs,
                  layout.words.data_ptr(), hit.data_ptr(), enc.data_ptr(),
                  probes.data_ptr(), reads.data_ptr(), fps.data_ptr(),
                  device=dev)
    return hit, enc, probes, reads, fps
