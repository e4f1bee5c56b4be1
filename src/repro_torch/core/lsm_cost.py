"""K-LSM unified cost model (paper Eqs. 1-9) on torch tensors.

The port of ``repro/core/lsm_cost.py``.  It maps an LSM configuration
``Phi = (T, m_filt, K_1..K_L)`` and system parameters to the expected I/O
cost of the four query classes

    c(Phi) = (Z0, Z1, Q, W)

with Monkey-style per-level Bloom-filter false-positive rates (Eq. 3).

Every function broadcasts over leading batch dimensions: ``phi.T`` and
``phi.mfilt_bits`` of shape ``(...)``, ``phi.K`` of shape
``(..., max_levels)``, so one call scores every lane of a tuner sweep and
autograd gives each lane its own gradient.  The formulas and their op
order are the JAX package's, term for term; levels beyond ``L(T)`` are
masked (a static ``max_levels`` ladder).  Memory quantities are in bits.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

LN2_SQ = 0.4804530139182014  # ln(2)^2


@dataclasses.dataclass(frozen=True)
class LSMSystem:
    """System ("untunable") parameters, paper Table 1 + Section 4.1.

    Defaults follow the paper's model-based study (Sections 5.3, 8.2):
    10B entries of 1 KiB, 4 KiB pages, 10 bits/entry of total memory.
    """

    N: float = 1e10              # total number of entries
    entry_bits: float = 8192.0   # E, bits per entry (1 KiB)
    page_bits: float = 32768.0   # page size in bits (4 KiB)
    bits_per_entry: float = 10.0  # total memory budget m / N (filters + buffer)
    f_a: float = 1.0             # storage read/write asymmetry
    f_seq: float = 1.0           # sequential-vs-random I/O cost ratio
    s_rq: float = 5e-9           # range query selectivity S_RQ (short ranges)
    min_buf_bits: float = 8.0 * 1024 * 1024 * 8  # floor on m_buf (8 MiB)
    max_levels: int = 24         # static ladder size
    max_T: float = 100.0         # solver bound on size ratio

    @property
    def B(self) -> float:
        """Entries per page."""
        return self.page_bits / self.entry_bits

    @property
    def m_total_bits(self) -> float:
        return self.bits_per_entry * self.N

    def replace(self, **kw: Any) -> "LSMSystem":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class Phi:
    """An LSM tuning: size ratio ``T``, filter memory ``mfilt_bits`` (the
    buffer gets the rest) and per-level run caps ``K`` (``(..., max_levels)``;
    entries beyond ``L(T)`` are ignored)."""

    T: torch.Tensor
    mfilt_bits: torch.Tensor
    K: torch.Tensor

    def round_integral(self, sys: LSMSystem) -> "Phi":
        """Deploy-time integer rounding (paper Section 5.2): ceil(T), round(K)."""
        T = torch.ceil(self.T)
        K = torch.minimum(torch.clamp(torch.round(self.K), min=1.0),
                          torch.clamp(T - 1.0, min=1.0)[..., None])
        return Phi(T=T, mfilt_bits=self.mfilt_bits, K=K)


def mbuf_bits(phi: Phi, sys: LSMSystem, m_total_bits=None) -> torch.Tensor:
    """Buffer memory = total budget - filter bits."""
    mtot = sys.m_total_bits if m_total_bits is None else m_total_bits
    return mtot - phi.mfilt_bits


def num_levels(T: torch.Tensor, mbuf: torch.Tensor, sys: LSMSystem,
               smooth: bool = False) -> torch.Tensor:
    """Eq. 1: L(T) = ceil( log_T( N*E/m_buf + 1 ) ). ``smooth`` skips the ceil
    (used only inside gradient-based tuners; evaluation is exact)."""
    T = torch.clamp(T, min=1.0 + 1e-6)
    x = sys.N * sys.entry_bits / torch.clamp(mbuf, min=sys.min_buf_bits) + 1.0
    lf = torch.log(x) / torch.log(T)
    if smooth:
        return torch.clamp(lf, min=1.0)
    return torch.clamp(torch.ceil(lf), min=1.0)


def _levels(sys: LSMSystem, like: torch.Tensor) -> torch.Tensor:
    """The level ladder i = 1..max_levels."""
    return torch.arange(1, sys.max_levels + 1, dtype=like.dtype,
                        device=like.device)


def level_fprs(phi: Phi, sys: LSMSystem, smooth: bool = False
               ) -> torch.Tensor:
    """Eq. 3 (Monkey allocation): per-level false positive rates, shape
    ``(..., max_levels)``, clipped to [1e-30, 1]; callers mask levels
    beyond L."""
    T = torch.clamp(phi.T, min=1.0 + 1e-6)
    L = num_levels(T, mbuf_bits(phi, sys), sys, smooth=smooth)[..., None]
    i = _levels(sys, phi.T)
    log_T = torch.log(T)[..., None]
    Tb = T[..., None]
    log_f = (Tb / (Tb - 1.0)) * log_T - (L + 1.0 - i) * log_T \
        - (phi.mfilt_bits[..., None] / sys.N) * LN2_SQ
    return torch.clamp(torch.exp(torch.clamp(log_f, max=0.0)), 1e-30, 1.0)


def level_mask(phi: Phi, sys: LSMSystem, smooth: bool = False
               ) -> torch.Tensor:
    """1.0 for levels 1..L, 0.0 beyond. With ``smooth`` the last level gets a
    fractional weight so that d(mask)/dT exists through L."""
    L = num_levels(phi.T, mbuf_bits(phi, sys), sys, smooth=smooth)[..., None]
    i = _levels(sys, phi.T)
    if smooth:
        return torch.clamp(L - i + 1.0, 0.0, 1.0)
    return (i <= L).to(phi.T.dtype)


def _clamped_K(phi: Phi) -> torch.Tensor:
    """K_i in [1, T-1] (a leveling run cap floor of 1; tiering cap of T-1)."""
    return torch.minimum(torch.clamp(phi.K, min=1.0),
                         torch.clamp(phi.T - 1.0, min=1.0)[..., None])


# The four cost terms one by one, as the JAX package writes them: each
# recomputes L, the FPRs and the mask.  ``cost_vector`` below fuses them;
# the tuner suite's seed-style baseline measures this unfused pattern.

def empty_read_cost(phi: Phi, sys: LSMSystem, smooth: bool = False
                    ) -> torch.Tensor:
    """Eq. 4: Z0 = sum_i K_i * f_i."""
    f = level_fprs(phi, sys, smooth=smooth)
    m = level_mask(phi, sys, smooth=smooth)
    return (m * _clamped_K(phi) * f).sum(dim=-1)


def nonempty_read_cost(phi: Phi, sys: LSMSystem, smooth: bool = False
                       ) -> torch.Tensor:
    """Eq. 6: expectation over the level holding the entry of
    1 (the hit) + false-positive I/Os above + half the runs within the
    level."""
    T = torch.clamp(phi.T, min=1.0 + 1e-6)
    f = level_fprs(phi, sys, smooth=smooth)
    m = level_mask(phi, sys, smooth=smooth)
    K = _clamped_K(phi)
    mbuf = torch.clamp(mbuf_bits(phi, sys), min=sys.min_buf_bits)
    i = _levels(sys, phi.T)
    # level capacity (entries), (T-1) T^{i-1} m_buf / E (Eq. 5 summand),
    # masked in log-space as in cost_vector
    log_cap = torch.log(T - 1.0)[..., None] + (i - 1.0) \
        * torch.log(T)[..., None] + torch.log(mbuf / sys.entry_bits)[..., None]
    cap = torch.exp(torch.where(m > 0, log_cap,
                                torch.full_like(log_cap, -torch.inf))) * m
    Nf = cap.sum(dim=-1, keepdim=True)        # Eq. 5
    p_level = cap / torch.clamp(Nf, min=1.0)
    kf = m * K * f
    above = torch.cumsum(kf, dim=-1) - kf     # false positives above level i
    per_level = 1.0 + above + 0.5 * (K - 1.0) * f
    return (p_level * per_level).sum(dim=-1)


def range_cost(phi: Phi, sys: LSMSystem, smooth: bool = False
               ) -> torch.Tensor:
    """Eq. 7: Q = f_seq * S_RQ * N/B + sum_i K_i."""
    m = level_mask(phi, sys, smooth=smooth)
    return sys.f_seq * sys.s_rq * sys.N / sys.B \
        + (m * _clamped_K(phi)).sum(dim=-1)


def write_cost(phi: Phi, sys: LSMSystem, smooth: bool = False
               ) -> torch.Tensor:
    """Eq. 9: W = f_seq * (1+f_a)/B * sum_i (T - 1 + K_i) / (2 K_i)."""
    m = level_mask(phi, sys, smooth=smooth)
    K = _clamped_K(phi)
    per_level = (phi.T[..., None] - 1.0 + K) / (2.0 * K)
    return sys.f_seq * (1.0 + sys.f_a) / sys.B * (m * per_level).sum(dim=-1)


def cost_vector(phi: Phi, sys: LSMSystem, smooth: bool = False,
                m_total_bits=None) -> torch.Tensor:
    """c(Phi) = (Z0, Z1, Q, W), shape ``(..., 4)`` (paper Section 3).

    The JAX package's fused form: the shared intermediates (L, per-level
    FPRs, level mask, clamped K) are computed once; ``smooth`` relaxes the
    ceil of L and the level mask for the tuners' gradients."""
    T = torch.clamp(phi.T, min=1.0 + 1e-6)
    mbuf_raw = mbuf_bits(phi, sys, m_total_bits)
    mbuf = torch.clamp(mbuf_raw, min=sys.min_buf_bits)
    L = num_levels(T, mbuf_raw, sys, smooth=smooth)[..., None]
    i = torch.arange(1, sys.max_levels + 1, dtype=phi.T.dtype,
                     device=phi.T.device)
    log_T = torch.log(T)[..., None]
    Tb = T[..., None]

    # Eq. 3 (Monkey FPRs) and the 1..L mask.
    log_f = (Tb / (Tb - 1.0)) * log_T - (L + 1.0 - i) * log_T \
        - (phi.mfilt_bits[..., None] / sys.N) * LN2_SQ
    f = torch.clamp(torch.exp(torch.clamp(log_f, max=0.0)), 1e-30, 1.0)
    if smooth:
        m = torch.clamp(L - i + 1.0, 0.0, 1.0)
    else:
        m = (i <= L).to(phi.T.dtype)
    K = _clamped_K(phi)

    # Eq. 4.
    kf = m * K * f
    z0 = kf.sum(dim=-1)

    # Eqs. 5-6, masked in log-space: exp() of masked-out deep levels would
    # overflow float32 and poison the sum with inf * 0 = nan.
    log_cap = torch.log(Tb - 1.0) + (i - 1.0) * log_T \
        + torch.log(mbuf / sys.entry_bits)[..., None]
    cap = torch.exp(torch.where(m > 0, log_cap,
                                torch.full_like(log_cap, -torch.inf))) * m
    Nf = cap.sum(dim=-1, keepdim=True)
    p_level = cap / torch.clamp(Nf, min=1.0)
    above = torch.cumsum(kf, dim=-1) - kf
    z1 = (p_level * (1.0 + above + 0.5 * (K - 1.0) * f)).sum(dim=-1)

    # Eq. 7.
    q = sys.f_seq * sys.s_rq * sys.N / sys.B + (m * K).sum(dim=-1)

    # Eq. 9.
    w = sys.f_seq * (1.0 + sys.f_a) / sys.B \
        * (m * (phi.T[..., None] - 1.0 + K) / (2.0 * K)).sum(dim=-1)

    return torch.stack([z0, z1, q, w], dim=-1)


def expected_cost(w: torch.Tensor, phi: Phi, sys: LSMSystem,
                  smooth: bool = False) -> torch.Tensor:
    """Eq. 2: C(w, Phi) = w^T c(Phi); w = (z0, z1, q, w)."""
    return (w * cost_vector(phi, sys, smooth=smooth)).sum(dim=-1)


def throughput(w: torch.Tensor, phi: Phi, sys: LSMSystem) -> torch.Tensor:
    """Paper Section 8.1: throughput := 1 / C(w, Phi)."""
    return 1.0 / expected_cost(w, phi, sys)


def cost_across_memory(phi: Phi, sys: LSMSystem, budgets_bpe,
                       smooth: bool = False) -> torch.Tensor:
    """``(G, 4)`` cost vectors of one tuning ``phi`` re-deployed at each
    per-entry memory budget in ``budgets_bpe`` (bits/entry), holding its
    filter/buffer split fraction fixed while the total scales: the
    marginal-benefit curve of the fleet memory arbiter.  One batched
    ``cost_vector`` over the budget axis, with the budget passed through
    ``m_total_bits``."""
    b = torch.as_tensor(budgets_bpe, dtype=torch.float32,
                        device=phi.T.device)
    scale = b / sys.bits_per_entry
    phi_b = Phi(T=phi.T.expand(b.shape), mfilt_bits=phi.mfilt_bits * scale,
                K=phi.K.expand(b.shape + phi.K.shape[-1:]))
    return cost_vector(phi_b, sys, smooth=smooth, m_total_bits=b * sys.N)


def make_phi(T: float, mfilt_bits: float, K, sys: LSMSystem,
             device=None) -> Phi:
    K = torch.broadcast_to(torch.as_tensor(K, dtype=torch.float32),
                           (sys.max_levels,)).clone()
    return Phi(T=torch.tensor(T, dtype=torch.float32, device=device),
               mfilt_bits=torch.tensor(mfilt_bits, dtype=torch.float32,
                                       device=device),
               K=K.to(device))


def leveling_phi(T: float, mfilt_bits: float, sys: LSMSystem,
                 device=None) -> Phi:
    return make_phi(T, mfilt_bits, 1.0, sys, device)


def tiering_phi(T: float, mfilt_bits: float, sys: LSMSystem,
                device=None) -> Phi:
    return make_phi(T, mfilt_bits, max(T - 1.0, 1.0), sys, device)
