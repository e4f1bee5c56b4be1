"""64-bit key codec: unsigned keys and hashes carried as int64 tensors.

PyTorch's CPU backend has no uint64 ``+``, ``>>``, ``%`` or
``searchsorted``, so the port never stores uint64.  Two representations:

* **bit pattern** — the int64 whose two's-complement bits equal the uint64
  (hashes, Bloom words).  Wrapping add and multiply are the int64 ones; a
  logical right shift masks off the sign extension; an unsigned ``% n``
  splits off the top bit.
* **ordered** — ``u ^ 2**63`` as int64 (engine keys in the device arenas).
  Signed order on it equals unsigned order on ``u``, so sorts, compares and
  binary searches need no special casing.  Keys are turned back into bit
  patterns before hashing and into uint64 at the host API boundary.

The CUDA kernels use ``uint64_t`` and the same ordered arena keys.
"""

from __future__ import annotations

import numpy as np
import torch

MASK64 = (1 << 64) - 1
SIGN = -(1 << 63)               # int64 with only the top bit set
_LOW63 = (1 << 63) - 1
_M32 = (1 << 32) - 1

SPLITMIX_GAMMA = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB


def as_i64(v: int) -> int:
    """A Python int taken mod 2**64, as the int64 with the same bits."""
    v &= MASK64
    return v - (1 << 64) if v >> 63 else v


def lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of a 64-bit pattern (``0 < s < 64``)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def umod(x: torch.Tensor, n) -> torch.Tensor:
    """Unsigned ``x % n`` for a bit pattern ``x`` and ``0 < n < 2**62``
    (an int or an int64 tensor broadcasting against ``x``)."""
    top = ((1 << 62) % n) * 2 % n          # 2**63 mod n without overflow
    return ((x & _LOW63) % n + (x < 0).long() * top) % n


def umulhi(x: torch.Tensor, m: int) -> torch.Tensor:
    """The high 64 bits of the unsigned 128-bit product of bit patterns
    ``x`` and ``0 <= m < 2**64``, from 32-bit halves (each partial product
    and sum is below 2**64, so int64's wrapping gives its bits)."""
    xl, xh = x & _M32, lsr(x, 32)
    ml, mh = m & _M32, m >> 32
    t = xh * ml + lsr(xl * ml, 32)
    w = (t & _M32) + xl * mh
    return xh * mh + lsr(t, 32) + lsr(w, 32)


def mod_magic(n: int) -> int:
    """The reciprocal of ``n`` for :func:`umod_magic`: ``(2**64 - 1) // n``."""
    return MASK64 // n


def umod_magic(x: torch.Tensor, n: int, magic: int) -> torch.Tensor:
    """Unsigned ``x % n`` by the reciprocal ``magic = mod_magic(n)``, for
    ``1 <= n < 2**62``: ``q = umulhi(x, magic)`` is the quotient or one
    less (``magic >= 2**64 / n - 1``, so ``x * magic / 2**64 > x / n -
    1``), so ``x - q * n`` lies in ``[0, 2n)`` and one subtraction of
    ``n`` corrects it.  The point-read kernel's modulo, step for step."""
    r = x - umulhi(x, magic) * n
    return torch.where(r >= n, r - n, r)


def splitmix64(x: torch.Tensor, seed: int) -> torch.Tensor:
    """Bit pattern of ``repro.lsm.bloom.splitmix64(x, seed)``: wrapping
    add/multiply and logical shifts on int64."""
    z = x + as_i64(seed * SPLITMIX_GAMMA)
    z = (z ^ lsr(z, 30)) * as_i64(_MIX1)
    z = (z ^ lsr(z, 27)) * as_i64(_MIX2)
    return z ^ lsr(z, 31)


# -- ordered keys (the arenas' representation) ------------------------------

def order_keys(keys: np.ndarray) -> np.ndarray:
    """uint64 keys -> ordered int64 (``u ^ 2**63``), host side."""
    return (np.asarray(keys, np.uint64) ^ np.uint64(1 << 63)).view(np.int64)


def unorder_keys(okeys) -> np.ndarray:
    """Ordered int64 keys (array or tensor) -> uint64 on the host."""
    if isinstance(okeys, torch.Tensor):
        okeys = okeys.cpu().numpy()
    return np.asarray(okeys, np.int64).view(np.uint64) ^ np.uint64(1 << 63)


def to_device_keys(keys: np.ndarray, device) -> torch.Tensor:
    """uint64 host keys -> ordered int64 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(order_keys(keys))).to(device)


def ordered_to_bits(okeys: torch.Tensor) -> torch.Tensor:
    """Ordered keys -> the uint64 bit patterns the hash consumes."""
    return okeys ^ SIGN


def ordered_to_int(v: int) -> int:
    """One ordered key (a Python int) -> the unsigned key it encodes."""
    return v + (1 << 63)
