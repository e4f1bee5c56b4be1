"""Mixture-of-Experts MLP with top-k routing, capacity-bounded dispatch
and DeepSeek-MoE-style shared experts.

The port of ``repro/models/moe.py``, with its leaf names (``router``,
``wi_gate``, ``wi_up``, ``wo``, ``shared/{wi_gate,wi_up,wo}``) and its
semantics: a float32 router and softmax, top-k gates renormalised with a
``1e-9`` floor, the load-balancing auxiliary loss ``E * sum(pe * fe)``, and
a capacity of ``ceil(S * k / E * capacity_factor)`` slots per expert and
batch row, filled in token order; an assignment past it is dropped (it
contributes nothing).

What differs from the JAX module:

* Dispatch is per batch row without a loop over rows.  JAX vmaps a stable
  ``argsort`` of each row's expert ids; here one stable ``torch.argsort``
  of ``row * E + expert`` over all ``B * S * k`` assignments gives the same
  order, and an assignment's slot is its sorted index minus its
  ``(row, expert)`` group's start.
* The dispatch buffer ``(B, E, cap, d)`` is written by plain indexing
  (every kept ``(row, expert, slot)`` is unique; dropped assignments go to
  one spare slot past ``cap`` that the experts never read), and the combine
  is a gather back to ``(B, S, k, d)`` summed over ``k`` in a fixed order.
  No float ``index_add_``, whose atomics would let two runs on the card
  differ in their last bits.  JAX adds dropped rows as zeros into slot 0
  and scatter-adds the combine over tokens, so sums run in another order.
* The sharding hints (``utils/shard_hints.hint``) are the JAX module's;
  the dispatch buffer is hinted after the spare slot is cut off.

The expert products are ``torch.einsum`` over every expert, as the JAX
package's are plain einsums outside any kernel: a decode step (capacity 1)
reads every expert's weights.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..utils.shard_hints import hint
from .layers import init_normal, torch_dtype

Params = Dict[str, torch.Tensor]


def init_moe(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    """The JAX package's distributions: router N(0, 1/d) in float32, the
    experts' input projections N(0, 1/d) and output N(0, 1/d_expert)."""
    m = cfg.moe
    d, E, ef = cfg.d_model, m.num_experts, m.d_expert
    dt = torch_dtype(cfg.param_dtype)
    si, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ef)
    p: Dict = {
        "router": init_normal(gen, (d, E), si, torch.float32, device),
        "wi_gate": init_normal(gen, (E, d, ef), si, dt, device),
        "wi_up": init_normal(gen, (E, d, ef), si, dt, device),
        "wo": init_normal(gen, (E, ef, d), so, dt, device),
    }
    if m.num_shared > 0:
        sf = m.num_shared * ef
        p["shared"] = {
            "wi_gate": init_normal(gen, (d, sf), si, dt, device),
            "wi_up": init_normal(gen, (d, sf), si, dt, device),
            "wo": init_normal(gen, (sf, d), so, dt, device),
        }
    return p


def route(p: Params, x: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (probs (B, S, E), gate (B, S, k), eidx (B, S, k)):
    the float32 router's softmax, its top k and their renormalised
    gates."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, eidx


def capacity(cfg: ModelConfig, S: int) -> int:
    """Slots per expert and batch row for ``S`` tokens a row."""
    m = cfg.moe
    return max(1, int(math.ceil(S * m.top_k / m.num_experts
                                * m.capacity_factor)))


def slots(eidx: torch.Tensor, E: int, cap: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """eidx (B, S, k) -> (slot (B, S, k), keep (B, S, k)): each
    assignment's slot within its (row, expert), in token order, and
    whether it is below ``cap``."""
    B = eidx.shape[0]
    n = eidx[0].numel()
    rows = torch.arange(B, device=eidx.device)[:, None]
    key = (rows * E + eidx.reshape(B, n)).reshape(-1)
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=B * E)
    starts = torch.cumsum(counts, 0) - counts           # exclusive
    pos_sorted = torch.arange(B * n, device=eidx.device) - starts[key[order]]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    pos = pos.reshape(eidx.shape)
    return pos, pos < cap


def aux_loss(probs: torch.Tensor, eidx: torch.Tensor, E: int
             ) -> torch.Tensor:
    """Load-balancing loss ``E * sum(pe * fe)`` over all tokens (Switch /
    Mixtral): ``pe`` the mean router probability of each expert, ``fe``
    the share of the top-k assignments it took."""
    pe = probs.reshape(-1, E).mean(dim=0)
    fe = torch.bincount(eidx.reshape(-1), minlength=E).float() \
        * (1.0 / eidx.numel())
    return E * torch.sum(pe * fe)


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux loss (float32 scalar))."""
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.num_experts, m.top_k
    probs, gate, eidx = route(p, x, cfg)
    aux = aux_loss(probs, eidx, E)

    cap = capacity(cfg, S)
    pos, keep = slots(eidx, E, cap)
    slot = torch.where(keep, pos, cap)                  # spare slot `cap`
    rows = torch.arange(B, device=x.device)[:, None, None].expand(B, S, k)
    buf = x.new_zeros((B, E, cap + 1, d))
    buf[rows, eidx, slot] = x[:, :, None, :].expand(B, S, k, d)
    buf = hint(buf[:, :, :cap], "batch", "expert", "capacity", "embed")

    # batched expert FFN: (B, E, C, d) x (E, d, ef) -> (B, E, C, ef)
    g = F.silu(torch.einsum("becd,edf->becf", buf, p["wi_gate"]))
    u = torch.einsum("becd,edf->becf", buf, p["wi_up"])
    g = hint(g, "batch", "expert", "capacity", "expert_mlp")
    u = hint(u, "batch", "expert", "capacity", "expert_mlp")
    eout = hint(torch.einsum("becf,efd->becd", g * u, p["wo"]),
                "batch", "expert", "capacity", "embed")   # (B, E, C, d)
    eout = F.pad(eout, (0, 0, 0, 1))                    # spare slot: zeros

    gate = torch.where(keep, gate, 0.0).to(eout.dtype)
    y = eout[rows, eidx, slot] * gate[..., None]        # (B, S, k, d)
    out = y[:, :, 0]
    for j in range(1, k):
        out = out + y[:, :, j]
    out = hint(out, "batch", "seq", "embed")

    if m.num_shared > 0:
        sp = p["shared"]
        sg = F.silu(hint(x @ sp["wi_gate"], "batch", "seq", "mlp")) \
            * hint(x @ sp["wi_up"], "batch", "seq", "mlp")
        out = out + sg @ sp["wo"]
    return out, aux
