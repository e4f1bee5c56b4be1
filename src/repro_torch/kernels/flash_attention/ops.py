"""Dispatch for the prefill attention (kernel 4).

:func:`flash_attention` takes q ``(B, S, H, d)`` and k/v ``(B, Sk, KV, d)``
in the model's layout.  For CUDA tensors it launches one of two
hand-written kernels by dtype, each reading kv head ``h // (H/KV)`` through
the strides itself (no GQA expansion, no transpose):

* bfloat16: ``csrc/flash_attention_wgmma.cu``, bf16 ``wgmma`` products on
  the tensor cores fed by TMA loads, float32 softmax and accumulators;
* float32: ``csrc/flash_attention.cu``, float32 FMAs on the CUDA cores
  (the tensor cores take float32 only as TF32, which cannot hold the
  float32 contract of 2e-5).

For CPU tensors it takes the plain version (``ref.flash_attention_ref``).
Any other device raises, and so does a CUDA tensor that neither kernel
takes: nothing falls back.

The kernels compute the forward pass only, as the JAX package's Pallas
kernel does, so a call that autograd would differentiate raises on every
device (:func:`refuse_gradient`): training takes
``attention_impl="plain"``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import _build
from .._build import F32, I32, I64, P
from .._compat import refuse_gradient
from .ref import flash_attention_ref

# q, k, v, o; 12 strides; B, S, Sk, H, KV, d, causal, window; scale; dtype;
# stream
_LAUNCH_ARGS = (P,) * 4 + (I64,) * 12 + (I32,) * 8 + (F32, I32, P)

HEAD_DIMS = (16, 32, 64, 96, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the bf16 kernel's entry: the same arguments without the dtype
_WGMMA_ARGS = _LAUNCH_ARGS[:-2] + (P,)


def tma_strides(t: torch.Tensor) -> Optional[list]:
    """The (batch, seq, head) element strides of a ``(B, S, n, d)`` bf16
    tensor as a TMA tensor map takes them, or None when TMA cannot read it
    in place: TMA needs a 16-byte aligned base, a contiguous last dimension
    and every other stride a positive multiple of 16 bytes.  A dimension of
    size 1 is never stepped over, so its stride is replaced by the packed
    one."""
    B, S, n, d = t.shape
    if t.stride(-1) != 1 or t.data_ptr() % 16:
        return None
    packed = (S * n * d, n * d, d)
    out = []
    for size, st, pk in zip(t.shape[:3], t.stride()[:3], packed):
        st = st if size > 1 else pk
        if st <= 0 or (st * t.element_size()) % 16:
            return None
        out.append(st)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, H, d); k/v: (B, Sk, KV, d), H a multiple of KV.
    Returns (B, S, H, d) in q's dtype."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q (B, S, H, d) and k/v "
                         "(B, Sk, KV, d)")
    B, S, H, d = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != d \
            or H % KV != 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention takes float32 or bfloat16 q, k, v "
                        "of one dtype")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    refuse_gradient("flash_attention", q, k, v)
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("flash_attention: tensors on different devices")
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {dev}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    out = torch.empty((B, S, H, d), dtype=q.dtype, device=dev)
    if out.numel() == 0 or Sk == 0:
        return out.zero_()
    shape = (B, S, Sk, H, KV, d, int(causal),
             0 if window is None else int(window), 1.0 / math.sqrt(d))
    if q.dtype == torch.bfloat16:
        # a packed copy (a fresh, aligned allocation) of what TMA cannot
        # read in place; contiguous() would keep a misaligned packed view
        q, k, v = (t if tma_strides(t) is not None
                   else t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
        strides = [s for t in (q, k, v) for s in tma_strides(t)]
        strides += out.stride()[:3]
        fn = _build.kernel_fn("flash_attention_wgmma",
                              "flash_attention_wgmma_launch", _WGMMA_ARGS)
        _build.launch("flash_attention", fn, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), *strides, *shape,
                      device=dev, variant="bf16_tc")
        return out
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    fn = _build.kernel_fn("flash_attention", "flash_attention_launch",
                          _LAUNCH_ARGS)
    _build.launch("flash_attention", fn, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), *strides, *shape,
                  _DTYPES[q.dtype], device=dev, variant="f32_cuda_core")
    return out
