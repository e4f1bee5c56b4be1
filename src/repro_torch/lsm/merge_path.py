"""K-way stable newest-wins merge: the compaction hot loop as one op.

The port of ``repro/lsm/merge_path.py``.  ``RunStore.merge`` reduces a
newest-first list of device runs to one sorted unique run (the newest
version of each key wins).  There is one implementation: the pairwise
newest-first fold of ``kernels/merge/ops.py``, whose two-way merges are the
CUDA merge-path kernel on the card and its plain version on the CPU.  It is
bit-identical to the JAX package's default ``merge_runs_numpy`` (tested).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .. import obs
from ..kernels.merge.ops import merge_runs as _merge_runs


def merge_runs(keys_list: Sequence[torch.Tensor],
               vals_list: Sequence[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Newest-first k-way newest-wins merge of ordered int64 key runs."""
    if obs.enabled():
        obs.count("kernel.dispatch.merge." + keys_list[0].device.type)
    return _merge_runs(keys_list, vals_list)
