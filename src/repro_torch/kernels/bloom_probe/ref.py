"""The plain PyTorch version of the blocked-Bloom probe (kernel 6).

The twin of ``repro/kernels/bloom_probe/ref.py``: a blocked Bloom filter
kept as an f32 0/1 bit-plane ``(num_blocks, block_bits)``.  A key's block
is ``mix32(key, 1) % num_blocks``; its k bits in that block are
``mix32(key, j + 2) % block_bits`` for j in 0..k-1.

Keys are int64 tensors holding uint32 values.  PyTorch's CPU backend has
no ``>>`` on ``uint32``, so :func:`mix32` computes in int64 and masks to
32 bits after every add and multiply: a product of two values below 2**32
may wrap in int64, but its low 32 bits stay those of the uint32 product.
A key outside [0, 2**32) counts as its low 32 bits, here and in the CUDA
kernel alike.
"""

from __future__ import annotations

import torch

from .._compat import resolve_device

MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_MIX1 = 0x85EBCA6B
_MIX2 = 0xC2B2AE35


def mix32(x: torch.Tensor, seed: int) -> torch.Tensor:
    """``ref.mix32(x, seed)`` of the JAX package, on int64 tensors holding
    uint32 values; returns uint32 values as int64."""
    x = (x + ((seed * _GOLDEN) & MASK32)) & MASK32
    x = ((x ^ (x >> 16)) * _MIX1) & MASK32
    x = ((x ^ (x >> 13)) * _MIX2) & MASK32
    return x ^ (x >> 16)


def _hashes(keys: torch.Tensor, num_blocks: int, block_bits: int,
            num_hashes: int):
    """(block, [bit_0, ..., bit_{k-1}]) of each key, int64."""
    keys = keys & MASK32
    block = mix32(keys, 1) % num_blocks
    return block, [mix32(keys, j + 2) % block_bits
                   for j in range(num_hashes)]


def build_plane(keys: torch.Tensor, num_blocks: int, block_bits: int,
                num_hashes: int, device=None) -> torch.Tensor:
    """Insert int64 ``keys`` (uint32 values) into a new f32 0/1 bit-plane
    ``(num_blocks, block_bits)`` on ``device`` (``None``: the card)."""
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise TypeError("build_plane takes 1-D int64 keys")
    dev = resolve_device(device)
    keys = keys.to(dev)
    plane = torch.zeros((num_blocks, block_bits), dtype=torch.float32,
                        device=dev)
    block, bits = _hashes(keys, num_blocks, block_bits, num_hashes)
    for bit in bits:
        plane[block, bit] = 1.0
    return plane


def probe_ref(keys: torch.Tensor, plane: torch.Tensor,
              num_hashes: int) -> torch.Tensor:
    """(N,) f32 membership of int64 ``keys`` in ``plane``: the product of
    the k fetched plane values, in the order j = 0..k-1 (1.0 = maybe
    present)."""
    num_blocks, block_bits = plane.shape
    block, bits = _hashes(keys, num_blocks, block_bits, num_hashes)
    member = torch.ones(keys.shape, dtype=torch.float32, device=keys.device)
    for bit in bits:
        member = member * plane[block, bit]
    return member


def probe_loads_ref(keys: torch.Tensor, plane: torch.Tensor,
                    num_hashes: int) -> torch.Tensor:
    """(N,) int32: the plane floats the kernel reads for each key, one at a
    time up to and including its first 0: all k for a key whose floats
    are all nonzero."""
    k = num_hashes
    num_blocks, block_bits = plane.shape
    block, bits = _hashes(keys, num_blocks, block_bits, k)
    reads = torch.full(keys.shape, k, dtype=torch.int64, device=keys.device)
    for j in reversed(range(k)):
        reads = torch.where(plane[block, bits[j]] == 0, j + 1, reads)
    return reads.to(torch.int32)
