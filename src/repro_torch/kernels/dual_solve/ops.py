"""Dispatch for the warm-started dual solve (kernel 1).

* :func:`dual_solve_warm_batch` — no-grad, lane-batched: the CUDA kernel
  (``csrc/dual_solve.cu``) for CUDA tensors, the plain version
  (``ref.dual_solve_warm_ref``) for CPU tensors, and nothing else.  With
  ``grad=True`` it also returns the envelope gradient ``dc`` (L, n) of
  ``repro/core/robust.py:35-45``: at the returned lambda, d value / d c =
  softmax(log w + c / lambda), or w where rho <= 0, which the kernel
  writes from the terms of its last evaluation.
* :func:`dual_solve_warm` — the same solve under autograd, as the robust
  tuner calls it once per Adam step over every lane.  Its forward asks for
  ``dc`` and its backward is ``g_val[:, None] * dc``.  The new log lambda
  is not differentiable (the reference's ``stop_gradient``).  The TPU
  kernel has no backward kernel either.

While telemetry is on, a call of :func:`dual_solve_warm` counts
``kernel.dispatch.dual_solve.<device type>`` and a call of
:func:`dual_solve_warm_batch` ``kernel.dispatch.dual_solve_batch.<device
type>``, as the merge and read paths count theirs (the reference counts
the same names by its mode, once per jit trace; the port counts calls).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ... import obs
from .. import _build
from .._build import F32, I32, I64, P
from .ref import dual_solve_warm_ref

_LAUNCH_ARGS = (P, P, I64, P, P, P, P, P, I64, I32, F32, I32, I32, P)

#: widest cost vector the kernel takes: its large thread group
#: (``kGroupLarge``, 16 threads) with ``kPartsWide`` (4) components a thread
N_MAX = 64


def dual_solve_warm_batch(C: torch.Tensor, W: torch.Tensor,
                          rho: torch.Tensor, llam: torch.Tensor,
                          half_width: float = 0.8, n_local: int = 3,
                          n_golden: int = 6, grad: bool = False
                          ) -> Tuple[torch.Tensor, ...]:
    """(values (L,), new log lam* (L,)), and with ``grad`` the envelope
    gradient (L, n), for C (L, n), W (L, n) or (n,), rho/llam (L,), all
    float32 on one device."""
    if obs.enabled():
        obs.count("kernel.dispatch.dual_solve_batch." + C.device.type)
    return _solve(C, W, rho, llam, half_width, n_local, n_golden, grad)


def _solve(C, W, rho, llam, half_width, n_local, n_golden, grad):
    """:func:`dual_solve_warm_batch`, uncounted."""
    if C.dim() != 2:
        raise ValueError(f"C must be (L, n), got {tuple(C.shape)}")
    L, n = C.shape
    if W.shape not in ((L, n), (n,)) or rho.shape != (L,) \
            or llam.shape != (L,):
        raise ValueError("dual_solve: W must be (L, n) or (n,) and rho, "
                         f"llam (L,); got C {tuple(C.shape)}, W "
                         f"{tuple(W.shape)}, rho {tuple(rho.shape)}, llam "
                         f"{tuple(llam.shape)}")
    if n_local < 1:
        raise ValueError(f"dual_solve: n_local {n_local} < 1")
    ts = (C, W, rho, llam)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("dual_solve takes float32 tensors")
    if any(t.device != C.device for t in ts):
        raise ValueError("dual_solve: tensors on different devices")
    if C.device.type == "cpu":
        with torch.no_grad():
            return dual_solve_warm_ref(C, W, rho, llam, half_width, n_local,
                                       n_golden, grad=grad)
    if C.device.type != "cuda":
        raise ValueError(f"dual_solve: no kernel for device {C.device}")
    if not 1 <= n <= N_MAX:
        raise ValueError(f"dual_solve kernel takes 1 <= n <= {N_MAX}, "
                         f"got {n}")
    C, W, rho, llam = (t.detach().contiguous() for t in ts)
    val = torch.empty(L, dtype=torch.float32, device=C.device)
    lnew = torch.empty_like(val)
    dc = torch.empty_like(C) if grad else None
    out = (val, lnew, dc) if grad else (val, lnew)
    if L == 0:
        return out
    fn = _build.kernel_fn("dual_solve", "dual_solve_warm_launch",
                          _LAUNCH_ARGS)
    _build.launch("dual_solve", fn, C.data_ptr(), W.data_ptr(),
                  n if W.dim() == 2 else 0, rho.data_ptr(), llam.data_ptr(),
                  val.data_ptr(), lnew.data_ptr(),
                  dc.data_ptr() if grad else None, L, n, half_width,
                  n_local, n_golden, device=C.device)
    return out


class DualSolveWarm(torch.autograd.Function):
    """Kernel forward with the envelope gradient; the backward scales it
    (see module docstring)."""

    @staticmethod
    def forward(ctx, C, W, rho, llam, half_width, n_local, n_golden):
        val, lnew, dc = _solve(C, W, rho, llam, half_width, n_local,
                               n_golden, True)
        ctx.save_for_backward(dc)
        ctx.mark_non_differentiable(lnew)
        return val, lnew

    @staticmethod
    def backward(ctx, g_val, g_lnew):
        dc, = ctx.saved_tensors
        return g_val[:, None] * dc, None, None, None, None, None, None


def dual_solve_warm(C: torch.Tensor, W: torch.Tensor, rho: torch.Tensor,
                    llam: torch.Tensor, half_width: float = 0.8,
                    n_local: int = 3, n_golden: int = 6
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable (in C) lane-batched warm solve; the tuner's call.
    Without a gradient to take, the kernel writes no ``dc``."""
    if obs.enabled():
        obs.count("kernel.dispatch.dual_solve." + C.device.type)
    if not (torch.is_grad_enabled() and C.requires_grad):
        return _solve(C, W, rho, llam, half_width, n_local, n_golden,
                      False)
    return DualSolveWarm.apply(C, W, rho, llam.detach(), half_width,
                               n_local, n_golden)
