"""Dispatch for the blocked-Bloom probe (kernel 6).

* :func:`bloom_probe_kernel` — (N,) f32 membership, the function of the
  JAX package's ``kernel.py:63``: the CUDA kernel (``csrc/bloom_probe.cu``)
  for CUDA tensors, the plain version (``ref.probe_ref``) for CPU tensors.
* :func:`bloom_probe` — (N,) bool, as ``repro/kernels/bloom_probe/ops.py``
  returns it (membership > 0.5).
* :func:`bloom_probe_loads` — the membership and, per key, the plane
  floats the kernel read (``ref.probe_loads_ref`` on the CPU): how far
  the stop at the first zero bit cut a key's loads.

The kernel stops a key at its first zero bit, exact on the 0/1 plane of
the contract.  Its own count of the floats it read is what shows that it
stops: ``ref.probe_loads_ref`` says where a key should stop, not that the
launched kernel did.

Keys are 1-D int64 tensors holding uint32 values (``ref.py`` says why not
``torch.uint32``); the plane is the (num_blocks, block_bits) f32 0/1
bit-plane that ``ref.build_plane`` makes.  Any N is taken: the JAX
wrapper's padding to the 128-key tile (``ops.py:24-29``) has no job here.
Any other device raises, and so does a CUDA tensor the kernel cannot
take: nothing falls back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build
from .._build import I32, I64, P
from .ref import probe_loads_ref, probe_ref

_LAUNCH_ARGS = (P, I64, P, I64, I64, I32, P, P, P)


def _check(keys: torch.Tensor, plane: torch.Tensor, num_hashes: int) -> None:
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise TypeError("bloom_probe takes 1-D int64 keys")
    if plane.dtype != torch.float32 or plane.dim() != 2:
        raise TypeError("bloom_probe takes a 2-D float32 bit-plane")
    num_blocks, block_bits = plane.shape
    if not (0 < num_blocks < 2 ** 32 and 0 < block_bits < 2 ** 32):
        raise ValueError(f"bloom_probe: plane shape {tuple(plane.shape)}; "
                         f"both sides must lie in [1, 2**32)")
    if num_hashes < 0:
        raise ValueError(f"bloom_probe: num_hashes {num_hashes} < 0")
    if plane.device != keys.device:
        raise ValueError("bloom_probe: tensors on different devices")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bloom_probe: no kernel for device {keys.device}")


def _launch(keys: torch.Tensor, plane: torch.Tensor, num_hashes: int,
            loads: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernel on CUDA tensors; writes ``loads`` when given."""
    keys, plane = keys.contiguous(), plane.contiguous()
    N = keys.shape[0]
    out = torch.empty(N, dtype=torch.float32, device=keys.device)
    if N == 0:
        return out
    num_blocks, block_bits = plane.shape
    fn = _build.kernel_fn("bloom_probe", "bloom_probe_launch", _LAUNCH_ARGS)
    _build.launch("bloom_probe", fn, keys.data_ptr(), N, plane.data_ptr(),
                  num_blocks, block_bits, num_hashes, out.data_ptr(),
                  None if loads is None else loads.data_ptr(),
                  device=keys.device)
    return out


def bloom_probe_kernel(keys: torch.Tensor, plane: torch.Tensor,
                       num_hashes: int = 4) -> torch.Tensor:
    """keys: (N,) int64 (uint32 values); plane: (num_blocks, block_bits)
    f32 0/1.  Returns (N,) f32 membership (1.0 = maybe present)."""
    _check(keys, plane, num_hashes)
    if keys.device.type == "cpu":
        return probe_ref(keys, plane, num_hashes)
    return _launch(keys, plane, num_hashes, None)


def bloom_probe_loads(keys: torch.Tensor, plane: torch.Tensor,
                      num_hashes: int = 4
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(membership (N,) f32, plane floats read a key (N,) int32), the
    latter as the kernel counts them in its own launch."""
    _check(keys, plane, num_hashes)
    if keys.device.type == "cpu":
        return (probe_ref(keys, plane, num_hashes),
                probe_loads_ref(keys, plane, num_hashes))
    loads = torch.empty(keys.shape[0], dtype=torch.int32, device=keys.device)
    return _launch(keys, plane, num_hashes, loads), loads


def bloom_probe(keys: torch.Tensor, plane: torch.Tensor,
                num_hashes: int = 4) -> torch.Tensor:
    """keys: (N,) int64 (uint32 values), any N; plane f32 0/1.  Returns
    (N,) bool."""
    return bloom_probe_kernel(keys, plane, num_hashes) > 0.5
