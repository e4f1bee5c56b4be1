"""Dispatch for the RWKV-6 WKV recurrence (kernel 5).

:func:`rwkv6` takes r/k/v/logw ``(B, S, H, n)`` and u ``(H, n)`` in the
model's layout and returns y ``(B, S, H, n)`` and the final state
``(B, H, n, n)``, both float32.  For CUDA tensors it launches one of two
hand-written kernels by the dtype of r/k/v, each reading every (batch,
head) through the strides itself (no ``(BH, S, n)`` transpose and no tile
of u, which the JAX wrapper (``ops.py:18``) makes for the TPU):

* bfloat16: ``csrc/rwkv6_mma.cu``, the chunked form with its products on
  the tensor cores (``mma.sync``, bf16 operands split into two halves)
  and the state carried once a chunk of 32;
* float32: ``csrc/rwkv6.cu``, the per-step recurrence on the CUDA cores,
  the only form that holds the float32 contract (5e-4) over thousands of
  slow-decay steps.

For CPU tensors it takes the plain version (``ref.rwkv6_ref``, the
per-step recurrence).  Any other device raises, and so does a CUDA tensor
that neither kernel takes: nothing falls back.  Like the JAX package's
Pallas kernel, both compute the forward pass only: a call that autograd
would differentiate raises on every device (training takes
``attention_impl="plain"``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
from .._build import I32, I64, P
from .._compat import refuse_gradient
from .ref import rwkv6_ref

# r, k, v, logw, u, y, state; 12 strides; B, S, H, n; stream (both entries)
_LAUNCH_ARGS = (P,) * 7 + (I64,) * 12 + (I32,) * 4 + (P,)

HEAD_DIMS = (16, 32, 64)
_DTYPES = (torch.float32, torch.bfloat16)


def _cp_async_ready(t: torch.Tensor) -> bool:
    """Whether the bf16 kernel's 16-byte copies can read ``t`` in place:
    a 16-byte aligned base, a contiguous last dimension, (batch, seq,
    head) strides that are multiples of 16 bytes (a dimension of size 1
    is never stepped over) and a sequence stride below 2**31 bytes (the
    kernel multiplies it in 32 bits)."""
    if t.stride(-1) != 1 or t.data_ptr() % 16:
        return False
    if t.shape[1] > 1 and t.stride(1) * t.element_size() >= 2 ** 31:
        return False
    return all(size == 1 or (st * t.element_size()) % 16 == 0
               for size, st in zip(t.shape[:3], t.stride()[:3]))


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          logw: torch.Tensor, u: torch.Tensor, chunk: int = 32
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v: (B, S, H, n) float32 or bfloat16, one dtype; logw: (B, S, H,
    n) float32 (< 0); u: (H, n) float32.  Returns (y (B, S, H, n) float32,
    final state (B, H, n, n) float32).

    ``chunk`` is the JAX kernel's chunk length, kept for its contract: a
    sequence longer than ``chunk`` must be a multiple of it, as
    ``rwkv6_chunked`` asserts.  Neither kernel's result depends on it (the
    bf16 kernel's own chunk is 32 tokens, and it pads a shorter last one)."""
    if any(t.dim() != 4 for t in (r, k, v, logw)) or u.dim() != 2:
        raise ValueError("rwkv6 takes r/k/v/logw (B, S, H, n) and u (H, n)")
    B, S, H, n = r.shape
    if k.shape != r.shape or v.shape != r.shape or logw.shape != r.shape \
            or u.shape != (H, n):
        raise ValueError(f"rwkv6: r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, logw {tuple(logw.shape)}, "
                         f"u {tuple(u.shape)}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError("rwkv6 takes float32 or bfloat16 r, k, v of one "
                        "dtype")
    if logw.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError("rwkv6 takes float32 logw and u")
    c = min(chunk, S)
    if c < 1 or S % c:
        raise ValueError(f"rwkv6: sequence length {S} is not a multiple of "
                         f"the chunk {c}")
    refuse_gradient("rwkv6", r, k, v, logw, u)
    dev = r.device
    if any(t.device != dev for t in (k, v, logw, u)):
        raise ValueError("rwkv6: tensors on different devices")
    if dev.type == "cpu":
        return rwkv6_ref(r, k, v, logw, u)
    if dev.type != "cuda":
        raise ValueError(f"rwkv6: no kernel for device {dev}")
    if n not in HEAD_DIMS:
        raise ValueError(f"rwkv6 kernel takes head dim n in {HEAD_DIMS}, "
                         f"got {n}")
    u = u.contiguous()
    y = torch.empty((B, S, H, n), dtype=torch.float32, device=dev)
    state = torch.empty((B, H, n, n), dtype=torch.float32, device=dev)
    if B * H == 0:
        return y, state
    if r.dtype == torch.bfloat16:
        # a packed copy (a fresh, aligned allocation) of what the 16-byte
        # copies cannot read in place
        r, k, v, logw = (t if _cp_async_ready(t)
                         else t.clone(memory_format=torch.contiguous_format)
                         for t in (r, k, v, logw))
        name, symbol, variant = "rwkv6_mma", "rwkv6_mma_launch", "bf16_tc"
    else:
        r, k, v, logw = (t if t.stride(-1) == 1 else t.contiguous()
                         for t in (r, k, v, logw))
        name, symbol, variant = "rwkv6", "rwkv6_launch", "f32_cuda_core"
    strides = [s for t in (r, k, v, logw) for s in t.stride()[:3]]
    fn = _build.kernel_fn(name, symbol, _LAUNCH_ARGS)
    _build.launch("rwkv6", fn, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                  logw.data_ptr(), u.data_ptr(), y.data_ptr(),
                  state.data_ptr(), *strides, B, S, H, n, device=dev,
                  variant=variant)
    return y, state
