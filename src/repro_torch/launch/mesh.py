"""Device meshes: the port of ``repro/launch/mesh.py``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions (``mesh_dim_names``), the counterpart of a ``jax.sharding.Mesh``
with axis names.  Building one needs a default process group whose world
size is the mesh's size:

* the dry run (``launch/dryrun.py``) traces a production mesh of 256 or
  512 ranks in one process over the ``fake`` backend
  (:func:`fake_process_group`, ``torch.testing._internal.distributed.
  fake_pg``): its collectives move nothing, so shapes and costs can be
  traced with no device, as the JAX package compiles for 512 CPU
  placeholder devices;
* :func:`make_host_mesh` and :func:`make_problem_mesh` build a mesh over
  the ranks that exist, and start a one-rank group (``nccl`` on the card,
  ``gloo`` on the CPU) when none is running.

Every function builds a mesh when called, never at import.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


@contextlib.contextmanager
def fake_process_group(world_size: int) -> Iterator[None]:
    """A default process group of ``world_size`` ranks over the ``fake``
    backend, this process as rank 0, destroyed on exit.  Its collectives
    return at once and move no data.  Refuses to start inside another."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group is already running")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu") -> DeviceMesh:
    """(16, 16) over ("data", "model"), or with ``multi_pod`` (2, 16, 16)
    over ("pod", "data", "model"), on a running group of 256 or 512
    ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: str = "cpu") -> DeviceMesh:
    """A mesh of any shape, ranks row-major, on a running group of
    ``prod(shape)`` ranks."""
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def _ensure_group(device_type: str) -> None:
    if not dist.is_initialized():
        backend = "nccl" if device_type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def _device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_problem_mesh(device_type: Optional[str] = None) -> DeviceMesh:
    """A 1-D mesh over every rank of the running group (one rank, and a
    group started for it, when none is running), dimension ``problem``:
    the sweep-sharding mesh of the batched tuners."""
    dt = _device_type(device_type)
    _ensure_group(dt)
    return make_mesh((dist.get_world_size(),), ("problem",), dt)


def make_host_mesh(model: int = 1,
                   device_type: Optional[str] = None) -> DeviceMesh:
    """A ("data", "model") mesh over the ranks of the running group (one
    rank when none is running: a (1, 1) mesh on a one-card host)."""
    dt = _device_type(device_type)
    _ensure_group(dt)
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"{n} ranks do not split into model axes of {model}")
    return make_mesh((n // model, model), ("data", "model"), dt)


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes that carry the batch dimension (pod + data when present)."""
    names = mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(mesh, name: str) -> int:
    """The size of dimension ``name`` (1 when the mesh lacks it)."""
    names = mesh.mesh_dim_names
    if name not in names:
        return 1
    return tuple(mesh.shape)[names.index(name)]
