"""Logical activation-sharding hints: the port of
``repro/utils/shard_hints.py`` (MaxText-style).

Models annotate activations with *logical* axis names
(``hint(x, "batch", "seq", "heads", "head_dim")``); a context manager maps
logical names to mesh axes per run.  Outside a mesh context (serving,
training and the tests on one device) :func:`hint` returns its input
after one thread-local lookup, so model code stays mesh-agnostic.

Inside :func:`mesh_context` a hint redistributes a DTensor to the
placements its logical names resolve to (``launch/sharding.py::placements``),
the counterpart of ``with_sharding_constraint``.  Rules drop axes that are
absent from the mesh, already used by an earlier dimension, or do not
divide the dimension, so one rule set serves every (arch x shape x mesh)
cell.  A tensor that is not a DTensor passes unchanged.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Iterator, Optional, Tuple, Union

import torch

Axes = Union[None, str, Tuple[str, ...]]

# logical axis -> mesh axis (or tuple). The default table serves train and
# prefill shapes; decode/long-context runs override via logical_axis_rules.
DEFAULT_RULES: Dict[str, Axes] = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    # expert_mlp also maps to model: when EP applies (expert count divides
    # the axis) the duplicate-axis guard in hint() drops it automatically,
    # leaving EP; otherwise the expert dim drops and the FFN width is TP.
    "expert_mlp": "model",
    "capacity": None,
    "flat_tokens": ("pod", "data"),
    "state": None,
}

_local = threading.local()


def _rules() -> Dict[str, Axes]:
    return getattr(_local, "rules", DEFAULT_RULES)


@contextlib.contextmanager
def logical_axis_rules(overrides: Dict[str, Axes]) -> Iterator[None]:
    old = _rules()
    _local.rules = {**old, **overrides}
    try:
        yield
    finally:
        _local.rules = old


@contextlib.contextmanager
def mesh_context(mesh) -> Iterator[None]:
    """Hints resolve on ``mesh`` (a ``DeviceMesh``) inside this context
    (``with mesh:`` in the JAX package)."""
    old = getattr(_local, "mesh", None)
    _local.mesh = mesh
    try:
        yield
    finally:
        _local.mesh = old


def current_mesh():
    return getattr(_local, "mesh", None)


def resolve(shape: Tuple[int, ...], logical: Tuple[Optional[str], ...],
            mesh) -> Tuple[Axes, ...]:
    """The spec (one entry a dimension) that ``logical`` resolves to on
    ``mesh`` under the current rules."""
    rules = _rules()
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, tuple(mesh.shape)))
    spec = []
    used: set = set()
    for dim, name in zip(shape, logical):
        ax = rules.get(name) if name is not None else None
        if ax is None:
            spec.append(None)
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        axes = tuple(a for a in axes if a in names and a not in used)
        total = math.prod(sizes[a] for a in axes) if axes else 1
        if axes and dim % total == 0:
            spec.append(axes[0] if len(axes) == 1 else axes)
            used.update(axes)
        else:
            spec.append(None)
    return tuple(spec)


def hint(x, *logical: Optional[str]):
    """Redistribute ``x`` to the placements its logical names resolve to.

    Identity outside a mesh context, for a tensor that is not a DTensor,
    and when the names do not match its rank.  Axes that do not exist in
    the mesh or do not divide the dimension are dropped (never fails)."""
    mesh = getattr(_local, "mesh", None)
    if mesh is None or len(logical) != x.dim():
        return x
    from torch.distributed.tensor import DTensor

    from ..launch.sharding import placements
    if not isinstance(x, DTensor):
        return x
    want = placements(resolve(tuple(x.shape), logical, mesh), mesh)
    return _Constrain.apply(x, mesh, want)


class _Constrain(torch.autograd.Function):
    """Redistribute to ``want``, and the gradient too: the transpose of a
    sharding constraint is the same constraint on the cotangent, as JAX
    transposes ``with_sharding_constraint`` (DTensor's own ``redistribute``
    would hand back the input's placements, partial sums included)."""

    @staticmethod
    def forward(ctx, x, mesh, want):
        ctx.mesh, ctx.want = mesh, want
        return x if tuple(x.placements) == want \
            else x.redistribute(mesh, want)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.want:
            g = g.redistribute(ctx.mesh, ctx.want)
        return g, None, None


def keep_layout(x):
    """``x`` unchanged, its gradient redistributed to ``x``'s layout (the
    identity for a tensor that is not a DTensor): the cotangent of an
    activation takes the activation's sharding."""
    if not hasattr(x, "placements"):
        return x
    return _Constrain.apply(x, x.device_mesh, tuple(x.placements))


def mesh_split(x, dim: int) -> int:
    """Into how many pieces the mesh splits dimension ``dim`` of ``x`` (1
    for a tensor that is not a DTensor)."""
    if not hasattr(x, "placements"):
        return 1
    dim %= x.dim()
    sizes = tuple(x.device_mesh.shape)
    return math.prod(sizes[i] for i, p in enumerate(x.placements)
                     if p.is_shard() and p.dim == dim)


def gather_dim(x, dim: int):
    """``x`` with dimension ``dim`` whole on every rank (the identity for
    a tensor that is not a DTensor)."""
    if mesh_split(x, dim) == 1:
        return x
    from torch.distributed.tensor import Replicate
    dim %= x.dim()
    want = [Replicate() if p.is_shard() and p.dim == dim else p
            for p in x.placements]
    return x.redistribute(x.device_mesh, want)


def decode_rules(sequence_parallel: bool) -> Dict[str, Axes]:
    """Rule overrides for decode shapes. SP (batch=1 long-context): the KV
    sequence axis shards over 'data' (flash-decode style)."""
    if sequence_parallel:
        return {"batch": None, "seq": "data", "kv_seq": "data"}
    return {"kv_seq": None}
