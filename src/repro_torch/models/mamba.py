"""Mamba (selective SSM) block, for the Jamba hybrid architecture.

The port of ``repro/models/mamba.py``.  Diagonal selective state space:

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t,    y_t = C_t . h_t + D x_t

with input-dependent (dt, B, C); decode carries (conv window, ssm state)
explicitly.  The JAX module scans time with ``jax.lax.associative_scan``
(log depth) inside chunks of ``cfg.mamba_chunk`` steps; here the
recurrence runs in time order, one fused multiply-add over (B, di, ds) a
step, in torch ops on every device (the reference's scan is plain JAX,
not a Pallas kernel).  The sums are the same; their rounding differs from
the associative tree's (float32 steps in both).

Memory: the reference materialises ``a``, ``b`` and ``h`` at (B, S, di,
ds) in float32.  Without a gradient (prefill) :func:`mamba_full` forms
them one chunk at a time and keeps only the carried state; under autograd
it materialises ``a`` and ``b`` and runs :class:`_Scan`, whose backward is
the reverse recurrence and which saves ``a`` and ``h`` only (no scan
levels).  The chunk contract is the reference's: one chunk when ``S <=
mamba_chunk``, else ``S`` must be a multiple of it.

Parameters are the JAX package's, drawn from a ``torch.Generator`` with
its distributions; ``dt_bias``, ``A_log`` and ``D`` stay float32 whatever
``param_dtype`` is.  :func:`mamba_step` writes the new conv window and
state into the decode cache in place and returns the same tensors (JAX
returns new ones).  The sharding hints (``utils/shard_hints.hint``) are
the JAX module's.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..utils.shard_hints import hint
from .layers import init_normal, torch_dtype

Params = Dict[str, Any]


def init_mamba(gen: torch.Generator, cfg: ModelConfig,
               device=None) -> Params:
    d = cfg.d_model
    di = cfg.d_inner_mamba
    ds = cfg.mamba_d_state
    dc = cfg.mamba_d_conv
    dt_rank = max(1, d // 16)
    dt = torch_dtype(cfg.param_dtype)
    f32 = torch.float32
    states = torch.arange(1, ds + 1, dtype=f32, device=device)
    return {
        "in_proj": init_normal(gen, (d, 2 * di), 1 / math.sqrt(d), dt,
                               device),
        "conv_w": init_normal(gen, (dc, di), 0.2, dt, device),
        "conv_b": torch.zeros(di, dtype=dt, device=device),
        "x_proj": init_normal(gen, (di, dt_rank + 2 * ds),
                              1 / math.sqrt(di), dt, device),
        "dt_proj": init_normal(gen, (dt_rank, di), 1 / math.sqrt(dt_rank),
                               dt, device),
        "dt_bias": torch.full((di,), -4.6, dtype=f32, device=device),
        "A_log": torch.log(states).repeat(di, 1),
        "D": torch.ones(di, dtype=f32, device=device),
        "out_proj": init_normal(gen, (di, d), 1 / math.sqrt(di), dt, device),
    }


def _selective(p: Params, xc: torch.Tensor, cfg: ModelConfig):
    """From conv output xc (B,S,di): dt (B,S,di), A (di,ds), B/C (B,S,ds),
    all float32."""
    ds = cfg.mamba_d_state
    dt_rank = p["dt_proj"].shape[0]
    dt_in, Bm, Cm = torch.split(xc @ p["x_proj"], [dt_rank, ds, ds], dim=-1)
    dt = F.softplus((dt_in @ p["dt_proj"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])                        # (di,ds), negative
    return dt, A, Bm.float(), Cm.float()


def _recurrence(a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 in time order, from ``h0``
    (zeros when None).  a/b: (B, L, ...) -> h: (B, L, ...)."""
    h = torch.empty_like(b)
    prev = h0
    for t in range(b.shape[1]):
        if prev is None:
            h[:, t] = b[:, t]
        else:
            torch.addcmul(b[:, t], a[:, t], prev, out=h[:, t])
        prev = h[:, t]
    return h


class _Scan(torch.autograd.Function):
    """h = the first-order recurrence of (a, b) from a zero state.  The
    backward is the reverse recurrence dh_t = g_t + a_{t+1} dh_{t+1}, with
    da_t = dh_t h_{t-1} and db_t = dh_t; ``a`` and ``h`` are saved."""

    @staticmethod
    def forward(ctx, a, b):
        h = _recurrence(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        S = g.shape[1]
        db = torch.empty_like(g)
        db[:, S - 1] = g[:, S - 1]
        for t in range(S - 2, -1, -1):
            torch.addcmul(g[:, t], a[:, t + 1], db[:, t + 1], out=db[:, t])
        da = torch.zeros_like(g)
        torch.mul(db[:, 1:], h[:, :-1], out=da[:, 1:])
        return da, db


def _check_chunk(S: int, chunk: int) -> None:
    if S > chunk and S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the "
                         f"selective-scan chunk {chunk}")


def _ssm_scan_chunked(a: torch.Tensor, b: torch.Tensor,
                      chunk: int) -> torch.Tensor:
    """First-order linear recurrence h_t = a_t h_{t-1} + b_t over time,
    under the reference's chunk contract (``S <= chunk``, or a multiple of
    it; the state carries across chunks, so the chunk changes no sum
    here).  a/b: (B, S, di, ds) -> h: (B, S, di, ds), differentiable."""
    _check_chunk(a.shape[1], chunk)
    return _Scan.apply(a, b)


def _discretize(dt, A, Bm, xf):
    """a_t = exp(dt*A), b_t = dt*B_t*x_t: (B, L, di, ds) each."""
    a = torch.exp(dt[..., None] * A)
    b = (dt * xf)[..., None] * Bm[..., None, :]
    return a, b


def _ssm(dt, A, Bm, Cm, xf, chunk: int):
    """y_t = C_t . h_t (B, S, di) and the last state h_{S-1} (B, di, ds).
    Under autograd through :class:`_Scan` on whole tensors; otherwise one
    chunk at a time, carrying only the state."""
    S = dt.shape[1]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dt, A, Bm, Cm, xf)):
        h = _ssm_scan_chunked(*_discretize(dt, A, Bm, xf), chunk)
        return torch.einsum("bsnz,bsz->bsn", h, Cm), h[:, -1]
    _check_chunk(S, chunk)
    ys, h = [], None
    for lo in range(0, S, chunk):
        sl = slice(lo, lo + chunk)
        hc = _recurrence(*_discretize(dt[:, sl], A, Bm[:, sl], xf[:, sl]),
                         h)
        ys.append(torch.einsum("bsnz,bsz->bsn", hc, Cm[:, sl]))
        h = hc[:, -1].clone()
        del hc
    return torch.cat(ys, dim=1), h


def _conv(window: torch.Tensor, p: Params, S: int,
          dc: int) -> torch.Tensor:
    """The depthwise causal conv1d over time (the reference's sum, in its
    order) and its SiLU: window (B, S + dc - 1, di) -> (B, S, di)."""
    xc = window[:, 0:S] * p["conv_w"][0]
    for i in range(1, dc):
        xc = xc + window[:, i:i + S] * p["conv_w"][i]
    return F.silu(xc + p["conv_b"])


def mamba_full(p: Params, x: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence Mamba (train/prefill). Returns (out, decode cache):
    ``conv`` the last dc-1 pre-conv inputs (B, dc-1, di), ``ssm`` the
    last state (B, di, ds) float32."""
    B, S, _ = x.shape
    di = cfg.d_inner_mamba
    dc = cfg.mamba_d_conv
    xz = hint(x @ p["in_proj"], "batch", "seq", "mlp")
    xi, z = xz[..., :di], xz[..., di:]
    xpad = torch.cat([xi.new_zeros((B, dc - 1, di)), xi], dim=1)
    xc = hint(_conv(xpad, p, S, dc), "batch", "seq", "mlp")
    dt, A, Bm, Cm = _selective(p, xc, cfg)
    xf = xc.float()
    y, h_last = _ssm(dt, A, Bm, Cm, xf, min(cfg.mamba_chunk, S))
    y = y + p["D"] * xf
    y = y.to(x.dtype) * F.silu(z)
    out = y @ p["out_proj"]
    return out, {"conv": xpad[:, S:].clone(), "ssm": h_last}


def mamba_step(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decode step; x: (B, 1, d).  Writes the new conv window and state
    into ``cache`` and returns it."""
    di = cfg.d_inner_mamba
    dc = cfg.mamba_d_conv
    xz = x @ p["in_proj"]
    xi, z = xz[..., :di], xz[..., di:]
    window = torch.cat([cache["conv"], xi], dim=1)          # (B,dc,di)
    xc = _conv(window, p, 1, dc)                            # (B,1,di)
    dt, A, Bm, Cm = _selective(p, xc, cfg)
    xf = xc.float()
    a, b = _discretize(dt[:, 0], A, Bm[:, 0], xf[:, 0])     # (B,di,ds)
    h = a * cache["ssm"] + b
    y = torch.einsum("bnz,bz->bn", h, Cm[:, 0])
    y = y + p["D"] * xf[:, 0]
    y = y[:, None, :].to(x.dtype) * F.silu(z)
    out = y @ p["out_proj"]
    cache["conv"].copy_(window[:, 1:])
    cache["ssm"].copy_(h)
    return out, cache
