"""Plain PyTorch version of the warm-started dual solve (kernel 1).

Lane-batched, in the op order of ``csrc/dual_solve.cu`` and of the JAX
package's Pallas tile (``repro/kernels/dual_solve/kernel.py:41``) and its
vmapped ``fused`` path: the hand-written logsumexp, the 3-point local scan
with a first-index argmin, ``n_golden`` cached-point golden iterations (one
new g-evaluation each), the clip to ``log(span) +- 16`` and the final
re-evaluation; and, on request, the envelope gradient the kernel writes
beside its values, by the ops the port's backward used before the kernel
wrote it.  It runs on any device; the port's wrapper (``ops.py``) uses
it only for CPU tensors, and ``chip_smoke.py`` holds the kernel against it
on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

GR = 0.6180339887498949  # golden ratio conjugate


def offsets(half_width: float, n_local: int) -> list:
    """float32 ``linspace(-hw, hw, n_local)``, formed as jnp.linspace
    does (``start * (1 - t) + stop * t``)."""
    hw = torch.tensor(half_width, dtype=torch.float32)
    out = []
    for j in range(n_local):
        t = torch.tensor(j / (n_local - 1) if n_local > 1 else 0.0,
                         dtype=torch.float32)
        out.append(float(-hw * (1.0 - t) + hw * t))
    return out


def g_of_llam(C: torch.Tensor, logW: torch.Tensor, rho: torch.Tensor,
              ll: torch.Tensor) -> torch.Tensor:
    """g(exp(ll)) per lane: C, logW (L, n); rho, ll (L,)."""
    lam = torch.clamp(torch.exp(ll), min=1e-12)
    x = logW + C / lam[:, None]
    m = x.max(dim=-1).values
    s = m + torch.log(torch.exp(x - m[:, None]).sum(dim=-1))
    return rho * lam + lam * s


def envelope_grad(C: torch.Tensor, W: torch.Tensor, rho: torch.Tensor,
                  lnew: torch.Tensor) -> torch.Tensor:
    """d value / d C (L, n) at the solve's log lam* ``lnew``:
    softmax(log w + c / lam) per lane, or w where rho <= 0 (the envelope
    gradient of ``repro/core/robust.py:35-45``)."""
    W = W.expand_as(C)
    lam = torch.clamp(torch.exp(lnew), min=1e-12)
    x = torch.log(W) + C / lam[:, None]
    e = torch.exp(x - x.max(dim=-1, keepdim=True).values)
    return torch.where((rho <= 0.0)[:, None], W, e / e.sum(-1, keepdim=True))


def dual_solve_warm_ref(C: torch.Tensor, W: torch.Tensor, rho: torch.Tensor,
                        llam: torch.Tensor, half_width: float = 0.8,
                        n_local: int = 3, n_golden: int = 6,
                        grad: bool = False) -> Tuple[torch.Tensor, ...]:
    """(values, new log lam*) for C (L, n), W (L, n) or (n,), rho/llam (L,),
    and with ``grad`` the envelope gradient (:func:`envelope_grad`), the
    kernel's third output.

    Differentiable in ``C`` through the final g (log lam* is detached, as
    the reference's ``stop_gradient``), so autograd gives the envelope
    gradient the kernel writes."""
    W = W.expand_as(C)
    logW = torch.log(W)
    llam = llam.detach()

    with torch.no_grad():          # the bracket is not differentiated
        offs = offsets(half_width, n_local)
        lls = torch.stack([llam + o for o in offs], 1)
        vals = torch.stack([g_of_llam(C, logW, rho, lls[:, j])
                            for j in range(n_local)], 1)
        i = torch.argmin(vals, dim=1, keepdim=True)   # first index on ties
        llo = lls.gather(1, torch.clamp(i - 1, min=0))[:, 0]
        lhi = lls.gather(1, torch.clamp(i + 1, max=n_local - 1))[:, 0]

        a = lhi - GR * (lhi - llo)
        b = llo + GR * (lhi - llo)
        fa = g_of_llam(C, logW, rho, a)
        fb = g_of_llam(C, logW, rho, b)
        for _ in range(n_golden):
            smaller = fa < fb
            nlo = torch.where(smaller, llo, a)
            nhi = torch.where(smaller, b, lhi)
            na = torch.where(smaller, nhi - GR * (nhi - nlo), b)
            nb = torch.where(smaller, a, nlo + GR * (nhi - nlo))
            fnew = g_of_llam(C, logW, rho, torch.where(smaller, na, nb))
            fa, fb = (torch.where(smaller, fnew, fb),
                      torch.where(smaller, fa, fnew))
            llo, lhi, a, b = nlo, nhi, na, nb

        span = C.max(dim=-1).values - C.min(dim=-1).values
        lspan = torch.log(torch.clamp(span, min=1e-9))
        lnew = torch.minimum(torch.maximum(0.5 * (llo + lhi), lspan - 16.0),
                             lspan + 16.0)
    val = torch.where(rho <= 0.0, (W * C).sum(dim=-1),
                      g_of_llam(C, logW, rho, lnew))
    if grad:
        with torch.no_grad():
            return val, lnew, envelope_grad(C.detach(), W, rho, lnew)
    return val, lnew
