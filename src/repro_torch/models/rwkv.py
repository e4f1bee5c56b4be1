"""RWKV-6 ("Finch") blocks: time mix with data-dependent decay, and the
channel mix.

The port of ``repro/models/rwkv.py``.  The WKV recurrence per head (head
dim n, per batch):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (state: n x n)
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

with per-channel decay ``w_t = exp(-exp(ww_t))`` computed from the input
through a LoRA (the paper's data-dependent decay).  Three paths:

* ``attention_impl="flash"`` (the JAX package's ``"pallas"``):
  ``kernels/rwkv6/ops.rwkv6``, the hand-written kernel for CUDA tensors
  and its plain version (the per-step recurrence) for CPU tensors.
* ``attention_impl="plain"`` (its ``"xla"``): :func:`wkv_chunked`, the
  chunkwise matmul form with pairwise log-space decays, in torch ops.
* :func:`wkv_step` — single-token decode against a carried (n x n) state,
  torch ops on every device, as the JAX package computes it outside any
  Pallas kernel.

Parameters are the JAX package's, drawn from a ``torch.Generator`` with
its distributions; ``w_base`` and ``u`` stay float32 whatever
``param_dtype`` is.  What differs from the JAX module: the step functions
write the new state and ``x_prev`` into the decode cache in place and
return the same tensors (JAX returns new ones).  The sharding hints
(``utils/shard_hints.hint``) are the JAX module's.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.rwkv6.ops import rwkv6
from ..utils.shard_hints import gather_dim, hint, mesh_split
from .layers import init_normal, torch_dtype

Params = Dict[str, Any]


def init_time_mix(gen: torch.Generator, cfg: ModelConfig,
                  device=None) -> Params:
    d = cfg.d_model
    n = cfg.rwkv_head_dim
    H = d // n
    lora = cfg.rwkv_decay_lora
    dt = torch_dtype(cfg.param_dtype)
    s = 1.0 / math.sqrt(d)
    half = lambda: torch.full((d,), 0.5, dtype=dt, device=device)  # noqa
    return {
        # token-shift interpolation weights per stream
        "mu_r": half(), "mu_k": half(), "mu_v": half(), "mu_g": half(),
        "mu_w": half(),
        "wr": init_normal(gen, (d, d), s, dt, device),
        "wk": init_normal(gen, (d, d), s, dt, device),
        "wv": init_normal(gen, (d, d), s, dt, device),
        "wg": init_normal(gen, (d, d), s, dt, device),
        "wo": init_normal(gen, (d, d), s, dt, device),
        # data-dependent decay: ww = w_base + tanh(xw A) B
        "w_base": torch.full((d,), -0.6, dtype=torch.float32, device=device),
        "w_A": init_normal(gen, (d, lora), s, dt, device),
        "w_B": init_normal(gen, (lora, d), 1.0 / math.sqrt(lora), dt,
                           device),
        "u": init_normal(gen, (H, n), 0.1, torch.float32, device),
        "ln_out": torch.ones(d, dtype=dt, device=device),  # group norm scale
    }


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Shifted sequence: row t sees row t-1 (x_prev seeds row 0)."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _project(p: Params, x: torch.Tensor, x_prev: torch.Tensor,
             cfg: ModelConfig):
    """r, k, v, g in the model dtype; logw float32 (always < 0)."""
    xs = _token_shift(x, x_prev)

    def lerp(mu):
        return x + (xs - x) * gather_dim(mu, 0)

    r = hint(lerp(p["mu_r"]) @ p["wr"], "batch", "seq", "mlp")
    k = hint(lerp(p["mu_k"]) @ p["wk"], "batch", "seq", "mlp")
    v = hint(lerp(p["mu_v"]) @ p["wv"], "batch", "seq", "mlp")
    g = hint(lerp(p["mu_g"]) @ p["wg"], "batch", "seq", "mlp")
    # the LoRA's rank axis is whole on every rank of a mesh (DTensor may
    # otherwise split the tokens it flattens over two mesh axes)
    ww = p["w_base"] + (torch.tanh(hint(lerp(p["mu_w"]) @ p["w_A"],
                                        "batch", "seq", None))
                        @ p["w_B"]).float()
    logw = -torch.exp(ww)
    return r, k, v, g, logw


def _heads(x: torch.Tensor, n: int) -> torch.Tensor:
    """(..., d) -> (..., d // n, n).  When the mesh splits the channels
    into pieces that are not whole heads (the dry run: 40 heads on a
    16-way axis), the channels are gathered first."""
    if (x.shape[-1] // n) % mesh_split(x, -1):
        x = gather_dim(x, -1)
    return x.reshape(*x.shape[:-1], x.shape[-1] // n, n)


def wkv_chunked(r, k, v, logw, u, chunk: int = 32):
    """Chunkwise-parallel WKV. All inputs (B, S, H, n) except u (H, n).

    Within a chunk, pairwise decay products are formed in log space
    (exponents masked to -inf above the diagonal *before* ``exp``, so every
    exponent taken is <= 0); across chunks a (B, H, n, n) state is carried
    with the chunk's total decay.  Returns (y (B, S, H, n), final state
    (B, H, n, n)), float32."""
    B, S, H, n = r.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"wkv_chunked: sequence length {S} is not a "
                         f"multiple of the chunk {chunk}")
    C = S // chunk
    rc, kc, vc, lw = (t.float().reshape(B, C, chunk, H, n)
                      for t in (r, k, v, logw))

    # Cumulative log-decay within each chunk: Lc[t] = sum_{s<=t} logw[s].
    Lc = torch.cumsum(lw, dim=2)                      # (B,C,c,H,n)
    Lc_prev = Lc - lw                                 # exclusive: sum_{s<t}
    total = Lc[:, :, -1]                              # (B,C,H,n)

    # ---- intra-chunk: y_t += sum_{j<t} (r_t . e^{Lc_{t-1}-Lc_j} k_j) v_j
    Dexp = Lc_prev[:, :, :, None] - Lc[:, :, None]    # (B,C,c,c,H,n)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    Dexp = torch.where(tri[:, :, None, None], Dexp, -math.inf)
    att = torch.einsum("bcthn,bcjhn,bctjhn->bctjh", rc, kc,
                       torch.exp(Dexp))               # (B,C,c,c,H)
    y_intra = torch.einsum("bctjh,bcjhn->bcthn", att, vc)

    # diagonal (current token) bonus term: (r_t . u k_t) v_t
    diag = torch.einsum("bcthn,hn,bcthn->bcth", rc, u.float(), kc)
    y_intra = y_intra + diag[..., None] * vc

    # ---- inter-chunk: carry state S (B,H,n,n), decayed by e^{total}
    # chunk contribution to state: sum_j e^{total - Lc_j} k_j v_j^T
    k_tail = kc * torch.exp(total[:, :, None] - Lc)   # (B,C,c,H,n)
    chunk_state = torch.einsum("bcjhn,bcjhm->bchnm", k_tail, vc)

    state = torch.zeros((B, H, n, n), dtype=torch.float32, device=r.device)
    y_inter = []
    for i in range(C):
        # y_t += (r_t * e^{Lc_prev,t})^T S
        y_inter.append(torch.einsum("bthn,bhnm->bthm",
                                    rc[:, i] * torch.exp(Lc_prev[:, i]),
                                    state))
        state = state * torch.exp(total[:, i])[..., None] + chunk_state[:, i]
    y = y_intra + torch.stack(y_inter, 1)
    return y.reshape(B, S, H, n), state


def _wkv_local(r, k, v, logw, u, chunk: int = 32):
    """:func:`wkv_chunked` of DTensors (the dry run), on each rank's shard:
    every (batch, head) pair is independent, and the chunk loop's small
    operations then run on the local shards."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    pl = list(r.placements)
    if any(p.is_shard() and p.dim not in (0, 2) for p in pl):
        raise ValueError(f"wkv of a sequence or channel split: {pl}")
    state = [Shard(1) if p.is_shard() and p.dim == 2 else p for p in pl]
    u_pl = [Shard(0) if p.is_shard() and p.dim == 2 else Replicate()
            for p in pl]
    return local_map(wkv_chunked, out_placements=(pl, state),
                     in_placements=(pl, pl, pl, pl, u_pl, None),
                     redistribute_inputs=True)(r, k, v, logw, u, chunk)


def _wkv_step_local(r, k, v, logw, u, state):
    """:func:`wkv_step` of DTensors (the dry run), on each rank's shard of
    the (batch, head) pairs; the state is first laid out as ``r``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    pl = list(r.placements)
    if any(p.is_shard() and p.dim not in (0, 1) for p in pl):
        raise ValueError(f"wkv step of a channel split: {pl}")
    u_pl = [Shard(0) if p.is_shard() and p.dim == 1 else Replicate()
            for p in pl]
    return local_map(wkv_step, out_placements=(pl, pl),
                     in_placements=(pl, pl, pl, pl, u_pl, pl),
                     redistribute_inputs=True)(r, k, v, logw, u, state)


def wkv_step(r, k, v, logw, u, state):
    """One decode step. r/k/v/logw: (B, H, n); state: (B, H, n, n)."""
    r, k, v, logw = (t.float() for t in (r, k, v, logw))
    a = k[..., :, None] * v[..., None, :]             # (B,H,n,n)
    y = torch.einsum("bhn,bhnm->bhm", r, state + u[..., :, None] * a)
    new_state = state * torch.exp(logw)[..., :, None] + a
    return y, new_state


def _group_norm(y: torch.Tensor, scale: torch.Tensor, eps: float,
                n: int) -> torch.Tensor:
    """Per-head normalization of the WKV output (RWKV's GroupNorm), in
    ``y``'s dtype, with the population variance as ``jnp.var``."""
    yh = y.reshape(*y.shape[:-1], y.shape[-1] // n, n) \
        if y.dim() == 3 else y
    mu = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, correction=0)
    yn = (yh - mu) * torch.rsqrt(var + eps)
    yn = yn.reshape(y.shape)
    return yn * scale.to(yn.dtype)


def time_mix_full(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  chunk: int = 32
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence time mix (prefill).  Returns (out, state cache); the
    cache's ``x_prev`` is a copy of the last row of ``x``, the normed
    input (a view would keep all of ``x`` alive with the cache)."""
    B, S, d = x.shape
    n = cfg.rwkv_head_dim
    x_prev0 = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    r, k, v, g, logw = _project(p, x, x_prev0, cfg)
    if cfg.attention_impl == "flash":
        wkv = rwkv6
    elif cfg.attention_impl == "plain":
        wkv = _wkv_local if hasattr(r, "placements") else wkv_chunked
    else:
        raise ValueError(f"attention_impl {cfg.attention_impl!r}: the port "
                         "has 'flash' and 'plain'")
    gathered = (d // n) % mesh_split(r, -1) != 0
    y, S_last = wkv(_heads(r, n), _heads(k, n), _heads(v, n),
                    _heads(logw, n), p["u"], chunk=chunk)
    y = y.reshape(B, S, d).to(x.dtype)
    scale = gather_dim(p["ln_out"], 0) if gathered else p["ln_out"]
    y = _group_norm(y, scale, cfg.norm_eps, n)
    if gathered:
        # the heads were gathered (see _heads): so is the gradient
        y = hint(y, "batch", "seq", "embed")
    out = (y * F.silu(g)) @ p["wo"]
    return out, {"state": S_last, "x_prev": x[:, -1, :].clone()}


def time_mix_step(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                  cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decode step; x: (B, 1, d).  Writes the cache in place."""
    B, _, d = x.shape
    n = cfg.rwkv_head_dim
    r, k, v, g, logw = _project(p, x, cache["x_prev"], cfg)
    rh, kh, vh, lwh = (_heads(t[:, 0], n) for t in (r, k, v, logw))
    step = _wkv_step_local if hasattr(rh, "placements") else wkv_step
    y, new_state = step(rh, kh, vh, lwh, p["u"], cache["state"])
    y = y.reshape(B, 1, d).to(x.dtype)
    y = _group_norm(y, p["ln_out"], cfg.norm_eps, n)
    out = (y * F.silu(g)) @ p["wo"]
    cache["state"].copy_(new_state)
    cache["x_prev"].copy_(x[:, 0, :])
    return out, cache


# ---------------------------------------------------------------------------
# Channel mix (the RWKV FFN)
# ---------------------------------------------------------------------------

def init_channel_mix(gen: torch.Generator, cfg: ModelConfig,
                     device=None) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    dt = torch_dtype(cfg.param_dtype)
    return {
        "mu_k": torch.full((d,), 0.5, dtype=dt, device=device),
        "mu_r": torch.full((d,), 0.5, dtype=dt, device=device),
        "wk": init_normal(gen, (d, ff), 1.0 / math.sqrt(d), dt, device),
        "wv": init_normal(gen, (ff, d), 1.0 / math.sqrt(ff), dt, device),
        "wr": init_normal(gen, (d, d), 1.0 / math.sqrt(d), dt, device),
    }


def _channel_mix(p: Params, x: torch.Tensor,
                 xs: torch.Tensor) -> torch.Tensor:
    xk = x + (xs - x) * gather_dim(p["mu_k"], 0)
    xr = x + (xs - x) * gather_dim(p["mu_r"], 0)
    k = torch.square(F.relu(xk @ p["wk"]))
    return torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"])


def channel_mix_full(p: Params, x: torch.Tensor, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    B, S, d = x.shape
    xs = _token_shift(x, torch.zeros((B, d), dtype=x.dtype, device=x.device))
    return _channel_mix(p, x, xs), {"x_prev": x[:, -1, :].clone()}


def channel_mix_step(p: Params, x: torch.Tensor,
                     cache: Dict[str, torch.Tensor], cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decode step; x: (B, 1, d).  Writes the cache in place."""
    out = _channel_mix(p, x, cache["x_prev"][:, None, :])
    cache["x_prev"].copy_(x[:, 0, :])
    return out, cache
