"""The plain PyTorch version of the RWKV-6 WKV kernel.

* :func:`wkv_ref` — the twin of ``repro/kernels/rwkv6/ref.py::wkv_ref``,
  the exact per-step recurrence that is the Pallas kernel's contract:

      y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
      S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T,    S_0 = 0

  r/k/v/logw ``(BH, S, n)``, u ``(BH, n)``; returns y ``(BH, S, n)`` and
  the final state ``(BH, n, n)``, both float32.
* :func:`rwkv6_ref` — the same in the model's layout, r/k/v/logw
  ``(B, S, H, n)`` and u ``(H, n)``: it folds (batch, head) and tiles u,
  as the JAX wrapper (``ops.py:18-24``) does around the Pallas kernel.
  ``ops.rwkv6`` takes it for CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            logw: torch.Tensor, u: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/logw: (BH, S, n); u: (BH, n). Sequential ground truth.

    Returns (y (BH, S, n) float32, final state (BH, n, n) float32)."""
    r, k, v, logw = (t.float() for t in (r, k, v, logw))
    u = u.float()
    BH, S, n = r.shape
    state = torch.zeros((BH, n, n), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(S):
        a = k[:, t, :, None] * v[:, t, None, :]            # (BH, n, n)
        ys.append(torch.einsum("bn,bnm->bm", r[:, t],
                               state + u[:, :, None] * a))
        state = state * torch.exp(logw[:, t])[:, :, None] + a
    return torch.stack(ys, 1), state


def rwkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              logw: torch.Tensor, u: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/logw: (B, S, H, n); u: (H, n).  Returns (y (B, S, H, n)
    float32, final state (B, H, n, n) float32)."""
    B, S, H, n = r.shape
    flat = lambda t: t.transpose(1, 2).reshape(B * H, S, n)  # noqa: E731
    y, state = wkv_ref(flat(r), flat(k), flat(v), flat(logw),
                       u.repeat(B, 1))
    return y.reshape(B, H, S, n).transpose(1, 2), state.view(B, H, n, n)
