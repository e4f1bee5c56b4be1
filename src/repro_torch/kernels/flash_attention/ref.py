"""The plain PyTorch version of the flash-attention kernel.

* :func:`attention_ref` — the twin of
  ``repro/kernels/flash_attention/ref.py::attention_ref``: q/k/v
  ``(BH, S, d)``, one materialised float32 softmax over every key, masked
  scores at NEG_INF = -1e30, output in q's dtype.
* :func:`flash_attention_ref` — the same in the model's layout, q
  ``(B, S, H, d)`` and k/v ``(B, Sk, KV, d)``: it repeats the kv heads and
  folds (batch, head), as the JAX wrapper (``ops.py:31-40``) does around the
  Pallas kernel.  ``ops.flash_attention`` takes it for CPU tensors.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """q/k/v: (BH, S, d) -> (BH, S, d); plain materialized softmax."""
    _, S, d = q.shape
    Sk = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(d)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((S, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, H, d); k/v: (B, Sk, KV, d). Returns (B, S, H, d)."""
    B, S, H, d = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    qf = q.transpose(1, 2).reshape(B * H, S, d)
    kf = k.transpose(1, 2).reshape(B * H, Sk, d)
    vf = v.transpose(1, 2).reshape(B * H, Sk, d)
    out = attention_ref(qf, kf, vf, causal=causal, window=window)
    return out.reshape(B, H, S, d).transpose(1, 2)
