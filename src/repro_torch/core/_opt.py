"""Multi-start Adam with cosine decay and best-iterate tracking.

The port of ``repro/core/_opt.py``.  One ``(L, p)`` theta tensor holds
every lane (tuning start x problem); the JAX package's ``lax.scan`` over
steps becomes a Python step loop.  Lanes are independent, so one backward
pass of the summed objective gives each lane its own gradient.

The objective is stateful, ``obj(theta, carry) -> (values (L,), carry')``:
the robust tuner threads its warm-started log lambda through the carry,
which is never differentiated.  Each step evaluates the objective once;
the final iterate gets one more evaluation, so the visited set is
theta_0..theta_N, as in the JAX package.  Scalars of the schedule and the
bias corrections take theta's dtype (float32 on the tuners' path), as
there.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch


def _scalar(x, dtype) -> torch.Tensor:
    return torch.tensor(x, dtype=dtype)


def minimize_adam_carry(obj: Callable, theta0: torch.Tensor, carry0,
                        steps: int, lr: float, lr_decay: float = 0.1,
                        b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
                        ) -> Tuple[torch.Tensor, torch.Tensor, object]:
    """Adam over every lane at once; returns (best_theta, best_value,
    final_carry), the best pair tracked per lane over every iterate."""
    theta = theta0.detach().clone()
    mu = torch.zeros_like(theta)
    nu = torch.zeros_like(theta)
    best_t = theta.clone()
    best_v = torch.full(theta.shape[:-1], math.inf, dtype=theta.dtype,
                        device=theta.device)
    carry = carry0
    denom = float(max(steps - 1, 1))
    dt = theta.dtype
    for i in range(steps):
        frac = _scalar(i, dt) / denom
        lr_i = float(lr * (lr_decay + (1 - lr_decay) * 0.5
                           * (1 + torch.cos(math.pi * frac))))
        th = theta.clone().requires_grad_(True)
        v, carry = obj(th, carry)
        (grad,) = torch.autograd.grad(v.sum(), th)
        grad = torch.where(torch.isfinite(grad), grad, torch.zeros_like(grad))
        v = v.detach()
        better = torch.isfinite(v) & (v < best_v)
        best_t = torch.where(better[..., None], theta, best_t)
        best_v = torch.where(better, v, best_v)
        step = _scalar(i + 1, dt)
        mu = b1 * mu + (1 - b1) * grad
        nu = b2 * nu + (1 - b2) * grad * grad
        mu_hat = mu / float(1 - _scalar(b1, dt) ** step)
        nu_hat = nu / float(1 - _scalar(b2, dt) ** step)
        theta = theta - lr_i * mu_hat / (torch.sqrt(nu_hat) + eps)
    with torch.no_grad():
        v, carry = obj(theta, carry)
    better = torch.isfinite(v) & (v < best_v)
    best_t = torch.where(better[..., None], theta, best_t)
    best_v = torch.where(better, v, best_v)
    return best_t, best_v, carry


def minimize_adam(obj: Callable[[torch.Tensor], torch.Tensor],
                  theta0: torch.Tensor, steps: int, lr: float,
                  lr_decay: float = 0.1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adam on a plain objective ``theta -> values``; (best_theta, best_v)."""
    best_t, best_v, _ = minimize_adam_carry(
        lambda t, c: (obj(t), c), theta0, None, steps=steps, lr=lr,
        lr_decay=lr_decay)
    return best_t, best_v
