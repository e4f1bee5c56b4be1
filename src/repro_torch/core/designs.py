"""LSM design-space parameterizations (paper Table 3) on torch tensors.

The port of ``repro/core/designs.py``.  Every design is a differentiable
map from an unconstrained parameter tensor ``theta`` of shape
``(..., n_params)`` to a :class:`~repro_torch.core.lsm_cost.Phi` batched
over the leading dimensions:

    T       = 2 + (maxT - 2) * sigmoid(t0)
    m_filt  = (m_total - min_buf) * sigmoid(t1)      [bits]
    K_i     = 1 + (T - 2) * sigmoid(t_i)             [in [1, T-1]]

Multi-start inits come from an explicit ``torch.Generator`` (on the CPU, so
the same seed gives the same starts whatever device the tuner runs on).
The JAX package draws them from ``jax.random``, which torch cannot replay,
so the tuners also take the starts as an argument.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from .lsm_cost import LSMSystem, Phi, mbuf_bits, num_levels


class DesignSpace(enum.Enum):
    LEVELING = "leveling"           # K_i = 1
    TIERING = "tiering"             # K_i = T - 1
    CLASSIC = "classic"             # best of {leveling, tiering} (ENDURE's pi)
    LAZY_LEVELING = "lazy_leveling"  # K_L = 1, K_i = T-1 otherwise
    ONE_LEVELING = "one_leveling"   # K_1 = T-1, K_i = 1 otherwise
    FLUID = "fluid"                 # K_1..K_{L-1} equal, K_L free
    DOSTOEVSKY = "dostoevsky"       # FLUID with fixed memory split
    KLSM = "klsm"                   # every K_i free


DOSTOEVSKY_BUF_BITS = 2.0 * 1024 * 1024 * 8  # 2 MiB, paper Section 5.3


def n_params(design: DesignSpace, sys: LSMSystem) -> int:
    if design in (DesignSpace.LEVELING, DesignSpace.TIERING, DesignSpace.CLASSIC,
                  DesignSpace.LAZY_LEVELING, DesignSpace.ONE_LEVELING):
        return 2                      # (T, m_filt)
    if design is DesignSpace.FLUID:
        return 4                      # (T, m_filt, K_upper, K_last)
    if design is DesignSpace.DOSTOEVSKY:
        return 3                      # (T, K_upper, K_last); memory fixed
    if design is DesignSpace.KLSM:
        return 2 + sys.max_levels     # (T, m_filt, K_1..K_max)
    raise ValueError(design)


def _T_from(theta0: torch.Tensor, sys: LSMSystem) -> torch.Tensor:
    return 2.0 + (sys.max_T - 2.0) * torch.sigmoid(theta0)


def _mfilt_from(theta1: torch.Tensor, sys: LSMSystem) -> torch.Tensor:
    return (sys.m_total_bits - sys.min_buf_bits) * torch.sigmoid(theta1)


def _K_from(theta: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    return 1.0 + torch.clamp(T - 2.0, min=0.0) * torch.sigmoid(theta)


def to_phi(theta: torch.Tensor, design: DesignSpace, sys: LSMSystem,
           smooth: bool = False) -> Phi:
    """Map unconstrained ``theta`` (..., n_params) -> feasible ``Phi``."""
    idx = torch.arange(1, sys.max_levels + 1, dtype=theta.dtype,
                       device=theta.device)
    ones = torch.ones(theta.shape[:-1] + (sys.max_levels,),
                      dtype=theta.dtype, device=theta.device)
    T = _T_from(theta[..., 0], sys)
    if design is DesignSpace.DOSTOEVSKY:
        mfilt = torch.full_like(T, sys.m_total_bits - DOSTOEVSKY_BUF_BITS)
        K_up = _K_from(theta[..., 1], T)
        K_last = _K_from(theta[..., 2], T)
    else:
        mfilt = _mfilt_from(theta[..., 1], sys)
    K_tier = torch.clamp(T - 1.0, min=1.0)[..., None]

    if design is DesignSpace.LEVELING:
        K = ones
    elif design is DesignSpace.TIERING:
        K = ones * K_tier
    elif design is DesignSpace.CLASSIC:
        raise ValueError("CLASSIC is solved as best-of {LEVELING, TIERING}; "
                         "tuners handle it explicitly.")
    elif design in (DesignSpace.LAZY_LEVELING, DesignSpace.ONE_LEVELING,
                    DesignSpace.FLUID, DesignSpace.DOSTOEVSKY):
        phi_tmp = Phi(T=T, mfilt_bits=mfilt, K=ones)
        L = num_levels(T, mbuf_bits(phi_tmp, sys), sys, smooth=False)
        is_last = idx == L[..., None]
        if design is DesignSpace.LAZY_LEVELING:
            K = torch.where(is_last, ones, K_tier * ones)
        elif design is DesignSpace.ONE_LEVELING:
            K = torch.where(idx == 1, K_tier * ones, ones)
        else:
            if design is DesignSpace.FLUID:
                K_up = _K_from(theta[..., 2], T)
                K_last = _K_from(theta[..., 3], T)
            K = torch.where(is_last, K_last[..., None] * ones,
                            K_up[..., None] * ones)
    elif design is DesignSpace.KLSM:
        K = _K_from(theta[..., 2:2 + sys.max_levels], T[..., None])
    else:
        raise ValueError(design)
    return Phi(T=T, mfilt_bits=mfilt, K=K)


def to_phi_policy(theta: torch.Tensor, policy: torch.Tensor, sys: LSMSystem,
                  smooth: bool = False) -> Phi:
    """Design-axis-aware map for the CLASSIC family.

    ``policy`` (broadcasting against ``theta[..., 0]``) selects the run-cap
    profile: 0.0 is LEVELING (K_i = 1), 1.0 is TIERING (K_i = max(T-1, 1)),
    so the batched tuners fold both CLASSIC branches into one lane axis.
    At policy in {0, 1} this reproduces ``to_phi(theta, LEVELING/TIERING)``.
    """
    T = _T_from(theta[..., 0], sys)
    mfilt = _mfilt_from(theta[..., 1], sys)
    K_tier = torch.clamp(T - 1.0, min=1.0)
    ones = torch.ones(theta.shape[:-1] + (sys.max_levels,),
                      dtype=theta.dtype, device=theta.device)
    K = (1.0 + policy * (K_tier - 1.0))[..., None] * ones
    return Phi(T=T, mfilt_bits=mfilt, K=K)


#: engine-side compaction policies (``repro_torch.lsm.planner.POLICIES``)
#: the cost model knows how to predict for
ENGINE_POLICIES = ("klsm", "lazy_leveling", "partial", "tombstone_ttl")

#: Calibrated steady-state fill of lazy leveling's upper levels, as a
#: fraction of the tiering headroom ``T - 2`` above the 1-run floor:
#: ``K_upper = 1 + LAZY_LEVELING_FILL * (T - 2)``.  The measured engine runs
#: far below the K = T-1 tiering ceiling (read-triggered squeezes drain the
#: deepest level, capacity spills empty upper levels wholesale); 0.125 is
#: the JAX package's calibration against its compaction suite (250k keys x
#: 10k queries, T=6: ~1-1.6 live runs per upper level).
LAZY_LEVELING_FILL = 0.125


def policy_effective_phi(phi: Phi, sys: LSMSystem, policy: str,
                         params: tuple = ()) -> Phi:
    """The Phi whose cost vector predicts ``phi`` deployed under an engine
    compaction policy: ``klsm``, ``partial`` and ``tombstone_ttl`` keep the
    tuning's own K profile; ``lazy_leveling`` gets ``K_i = 1 + fill * (T-2)``
    above the last level and ``K_L = 1``, with ``fill`` from ``params``
    ((name, value) pairs, the policy's engine kwargs) or
    :data:`LAZY_LEVELING_FILL`."""
    if policy not in ENGINE_POLICIES:
        raise ValueError(f"unknown engine policy {policy!r}; "
                         f"known: {ENGINE_POLICIES}")
    if policy != "lazy_leveling":
        return phi
    fill = float(dict(params).get("fill", LAZY_LEVELING_FILL))
    idx = torch.arange(1, sys.max_levels + 1, dtype=phi.K.dtype,
                       device=phi.K.device)
    L = num_levels(phi.T, mbuf_bits(phi, sys), sys, smooth=False)
    K_up = 1.0 + fill * torch.clamp(phi.T - 2.0, min=0.0)
    K = torch.where(idx == L[..., None], torch.ones_like(phi.K),
                    K_up[..., None].expand_as(phi.K))
    return Phi(T=phi.T, mfilt_bits=phi.mfilt_bits, K=K)


def describe(phi: Phi, sys: LSMSystem) -> str:
    """Human-readable tuning summary: (T, m_filt bits/entry, K-profile)."""
    T = float(phi.T)
    h = float(phi.mfilt_bits) / sys.N
    L = int(num_levels(phi.T, mbuf_bits(phi, sys), sys))
    K = phi.K.detach().cpu().numpy()[:L]
    if np.allclose(K, 1.0):
        pol = "L"
    elif np.allclose(K, max(T - 1.0, 1.0), atol=0.5):
        pol = "T"
    else:
        pol = "K=" + ",".join(f"{k:.0f}" for k in K)
    return f"(T={T:.1f}, h={h:.1f}b/e, {pol})"


def random_inits(generator: torch.Generator, n: int, design: DesignSpace,
                 sys: LSMSystem) -> torch.Tensor:
    """Multi-start initial thetas, shape (n, n_params), uniform in [-3, 3)."""
    p = n_params(design, sys)
    return torch.rand((n, p), generator=generator) * 6.0 - 3.0


def random_inits_many(generator: torch.Generator, n_problems: int,
                      n_starts: int, design: DesignSpace, sys: LSMSystem
                      ) -> torch.Tensor:
    """Batched multi-start inits, shape (n_problems, n_starts, n_params):
    every problem gets the same starts, as in the JAX package's default
    (CLASSIC's two folded branches see identical inits)."""
    t = random_inits(generator, n_starts, design, sys)
    return t.expand((n_problems,) + t.shape).clone()
