"""Per-level fused point read: the engine's read hot loop as one op.

The port of ``repro/lsm/read_path.py``.  One call answers a key batch
against ALL runs of one level — Bloom probe, fence window and per-run
binary search — with the engine's sequential-equivalent I/O accounting:
runs are visited newest -> oldest, and a key resolved by a newer run is not
probed in older ones.  There is one implementation, ``kernels/point_read``:
the CUDA kernel on the card, its plain version on the CPU, both
bit-identical to the JAX package's default ``point_read_level_numpy``.
Results stay on the device; the per-key counters come back summed as
0-d device tensors, so the caller syncs once per batch, not per level.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import obs
from ..kernels.point_read.ops import point_read_level as _point_read


def point_read_level(lv, sub_keys: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(hit, enc, counts) for ordered keys ``sub_keys`` against level
    ``lv``: ``hit``/``enc`` per key, ``counts`` the (probes, reads,
    false_positives) sums as one int64 (3,) tensor on the device."""
    if obs.enabled():
        obs.count("kernel.dispatch.point_read." + sub_keys.device.type)
    hit, enc, probes, reads, fps = _point_read(sub_keys, lv.keys, lv.vals,
                                               lv.pack)
    return hit, enc, torch.stack([probes.sum(), reads.sum(), fps.sum()])
