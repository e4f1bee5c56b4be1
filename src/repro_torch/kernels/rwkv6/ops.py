"""Dispatch for the RWKV-6 WKV recurrence (kernel 5).

:func:`rwkv6` takes r/k/v/logw ``(B, S, H, n)`` and u ``(H, n)`` in the
model's layout and returns y ``(B, S, H, n)`` and the final state
``(B, H, n, n)``, both float32.  For CUDA tensors it launches the
hand-written kernel (``csrc/rwkv6.cu``), which reads each (batch, head)
through the strides itself: no ``(BH, S, n)`` transpose and no tile of u,
which the JAX wrapper (``ops.py:18``) makes for the TPU.  For CPU tensors
it takes the plain version (``ref.rwkv6_ref``, the per-step recurrence).
Any other device raises, and so does a CUDA tensor the kernel does not
take: nothing falls back.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
from .._build import I32, I64, P
from .ref import rwkv6_ref

# r, k, v, logw, u, y, state; 12 strides; B, S, H, n, dtype; stream
_LAUNCH_ARGS = (P,) * 7 + (I64,) * 12 + (I32,) * 5 + (P,)

HEAD_DIMS = (16, 32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          logw: torch.Tensor, u: torch.Tensor, chunk: int = 32
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v: (B, S, H, n) float32 or bfloat16, one dtype; logw: (B, S, H,
    n) float32 (< 0); u: (H, n) float32.  Returns (y (B, S, H, n) float32,
    final state (B, H, n, n) float32).

    ``chunk`` is the JAX kernel's chunk length, kept for its contract: a
    sequence longer than ``chunk`` must be a multiple of it, as
    ``rwkv6_chunked`` asserts.  The kernel itself steps one token at a
    time, so the chunk does not change a result."""
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
    r, k, v, logw = (t if t.stride(-1) == 1 else t.contiguous()
                     for t in (r, k, v, logw))
    u = u.contiguous()
    y = torch.empty((B, S, H, n), dtype=torch.float32, device=dev)
    state = torch.empty((B, H, n, n), dtype=torch.float32, device=dev)
    if B * H == 0:
        return y, state
    strides = [s for t in (r, k, v, logw) for s in t.stride()[:3]]
    fn = _build.kernel_fn("rwkv6", "rwkv6_launch", _LAUNCH_ARGS)
    _build.launch("rwkv6", fn, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                  logw.data_ptr(), u.data_ptr(), y.data_ptr(),
                  state.data_ptr(), *strides, B, S, H, n, _DTYPES[r.dtype],
                  device=dev)
    return y, state
