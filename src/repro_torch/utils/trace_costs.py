"""Per-device costs of an eager trace: the port's counterpart of
``repro/utils/hlo.py`` (the JAX package's post-compile HLO analysis).

The dry run (``launch/dryrun.py``) runs a step on DTensors whose local
shards are fake tensors, over a fake process group.  :class:`CostCounter`
is a ``TorchDispatchMode`` that sees every operation on the local shards,
that is the per-device program, as the JAX package's compiled SPMD module
is, and counts:

* ``flops`` — matrix products and convolutions (``aten.mm``, ``bmm``,
  ``addmm``, ``baddbmm``, ``convolution``), 2 x result x contracted
  size: the ops the JAX package counts as dots and convs;
* ``bytes`` — each local op's operand and result bytes.  Views move
  nothing and are not counted.  There is no fusion, so this exceeds
  XLA's fused count (every elementwise op reads and writes HBM);
* ``collective_bytes_by_axis`` — each ``_c10d_functional`` collective,
  attributed to the mesh axis whose process group it names, charged with
  the JAX package's ring model (:func:`ring_bytes`);
* ``collective_count``;
* ``peak_live_bytes`` — the most bytes of local storage alive at once,
  the inputs (parameters, optimizer state, batch or cache) included.

``while_trips`` is always empty: an eager trace runs every layer, so the
HLO analysis's correction for ``while`` bodies that XLA's cost analysis
visits once has nothing to correct.

Two kinds of operations are not counted.  An operation on DTensors is
returned unhandled (``NotImplemented``): DTensor then runs it on the local
shards, and those are counted.  And DTensor's sharding propagation runs
each new operation once at its global shapes on fake tensors, to learn
the output's shape; such a call is recognised by its caller
(``ShardingPropagator._propagate_tensor_meta_non_cached``, a private name
of DTensor's) on the Python stack and skipped, since it is no device's
work.  :class:`CostCounter` refuses to start where torch lacks that name:
its calls would then be counted at their global shapes.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import weakref
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_aten = torch.ops.aten
_DOTS = {_aten.mm.default, _aten.bmm.default, _aten.addmm.default,
         _aten.baddbmm.default}
_CONVS = {_aten.convolution.default}
_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "all_reduce": "all-reduce",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "permute_tensor": "collective-permute"}
_PROPAGATION = "_propagate_tensor_meta_non_cached"


@dataclasses.dataclass
class TraceCosts:
    """``HloCosts``' fields, per device."""
    flops: float
    bytes: float
    collective_bytes_by_axis: Dict[str, float]
    collective_count: float
    while_trips: List[int]
    peak_live_bytes: float = 0.0


def ring_bytes(op: str, result_bytes: float, group: int) -> float:
    """Per-device wire bytes of one collective under a ring schedule
    (``hlo.py::_ring_bytes``): ``result_bytes`` is the op's result."""
    if group <= 1:
        return 0.0
    f = (group - 1) / group
    if op == "all-reduce":
        return 2.0 * f * result_bytes
    if op == "all-gather":
        return f * result_bytes           # result = gathered (full) shape
    if op == "reduce-scatter":
        return f * result_bytes * group   # operand = full shape
    if op == "all-to-all":
        return f * result_bytes
    return float(result_bytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _in_propagation() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == _PROPAGATION:
            return True
        f = f.f_back
    return False


def _dot_flops(func, args, out: torch.Tensor) -> float:
    """2 x result x contracted size; the bias of addmm/baddbmm comes
    first."""
    a = args[1] if func in (_aten.addmm.default,
                            _aten.baddbmm.default) else args[0]
    return 2.0 * out.numel() * a.shape[-1]


def _conv_flops(args, out: torch.Tensor) -> float:
    w = args[1]
    per_out = math.prod(w.shape[1:])       # in/groups x kernel
    return 2.0 * out.numel() * per_out


class CostCounter(TorchDispatchMode):
    """Counts the per-device costs of the local operations run under it
    (see the module docstring).  ``mesh``: the ``DeviceMesh`` whose
    process groups name the axes of the collectives."""

    def __init__(self, mesh):
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        if not hasattr(ShardingPropagator, _PROPAGATION):
            raise RuntimeError(
                f"torch {torch.__version__}: DTensor's ShardingPropagator "
                f"has no {_PROPAGATION}; the counter cannot tell its "
                "sharding propagation's global-shape calls from a "
                "device's operations")
        self._dtensor = DTensor
        self.axes: Dict[str, Tuple[str, int]] = {}
        for i, name in enumerate(mesh.mesh_dim_names):
            self.axes[mesh.get_group(i).group_name] = (
                name, tuple(mesh.shape)[i])
        self.flops = 0.0
        self.bytes = 0.0
        self.collective: Dict[str, float] = {}
        self.collective_count = 0
        self.live = 0
        self.peak = 0
        self._sizes: Dict[int, int] = {}

    # ------------------------------------------------------------ memory
    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it is freed."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return
        nb = st.nbytes()
        self._sizes[key] = nb
        self.live += nb
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    # ---------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_propagation():
            return out
        outs = _tensors(out)
        if func.namespace in ("_c10d_functional",
                              "_c10d_functional_autograd"):
            self._collective(func, args, outs)
        elif func in _DOTS:
            self.flops += _dot_flops(func, args, outs[0])
        elif func in _CONVS:
            self.flops += _conv_flops(args, outs[0])
        if not func.is_view and outs:
            self.bytes += sum(_nbytes(t) for t in _tensors(args)) \
                + sum(_nbytes(t) for t in outs)
        for t in outs:
            self.track(t)
        return out

    def _collective(self, func, args, outs) -> None:
        name = func.__name__.split(".")[0]
        op = _COLLECTIVES.get(name)
        if op is None:                      # wait_tensor, broadcast, ...
            return
        axis, group = None, 1
        for a in args:
            if isinstance(a, str) and a in self.axes:
                axis, group = self.axes[a]
        if axis is None:
            raise RuntimeError(f"{func}: a process group of no mesh axis")
        wire = ring_bytes(op, sum(_nbytes(t) for t in outs), group)
        self.collective[axis] = self.collective.get(axis, 0.0) + wire
        self.collective_count += 1

    def costs(self) -> TraceCosts:
        return TraceCosts(flops=self.flops, bytes=self.bytes,
                          collective_bytes_by_axis=dict(self.collective),
                          collective_count=float(self.collective_count),
                          while_trips=[], peak_live_bytes=float(self.peak))
