"""Core layers: norms, RoPE (standard, partial and M-RoPE), GQA attention
(causal / sliding-window / qk-norm / QKV-bias, and cross-attention) and
dense MLPs.

The port of ``repro/models/layers.py``.  Every layer is a function
``apply(params, x, ...)`` on a dict of tensors, with the JAX package's
layouts at the public functions: activations ``(B, S, H, hd)``, ``wq``
``(d, H, hd)``, ``wk``/``wv`` ``(d, KV, hd)``, ``wo`` ``(H, hd, d)``.  The
``init_*`` functions draw the JAX package's distributions from a
``torch.Generator`` (not its numbers).

What differs from the JAX module:

* ``attention_full``'s prefill attention is ``cfg.attention_impl``:
  ``"flash"`` goes through ``kernels.flash_attention.ops`` (the hand-written
  kernel for CUDA tensors, its plain version for CPU tensors: the JAX
  package's ``"pallas"`` branch), ``"plain"`` through :func:`_sdpa` (its
  ``"xla"`` branch).  ``xla_chunked`` is a TPU memory workaround and is not
  ported.
* ``attention_decode`` writes the new token's k/v into the cache in place
  and returns the same tensors (JAX returns updated copies).
* :func:`_sdpa` groups the query heads by kv head instead of repeating the
  kv heads: the same products, without copying the cache.
* ``utils/shard_hints.hint`` annotates the activations as the JAX module
  does (the identity outside a mesh context).  Only on DTensors (the dry
  run) does :func:`_sdpa` repeat the kv heads, as JAX always does.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.flash_attention.ops import flash_attention
from ..utils.shard_hints import gather_dim, hint, keep_layout, mesh_split

Params = Dict[str, Any]
NEG_INF = -1e30  # bf16-safe large-negative for masking


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def init_normal(gen: torch.Generator, shape, scale: float, dtype,
                device) -> torch.Tensor:
    """N(0, 1) * scale in float32, then cast: JAX's ``(normal * s).astype``."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, d: Optional[int] = None,
              device=None) -> Params:
    d = d or cfg.d_model
    dt = torch_dtype(cfg.param_dtype)
    p = {"scale": torch.ones(d, dtype=dt, device=device)}
    if cfg.norm == "ln":
        p["bias"] = torch.zeros(d, dtype=dt, device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """LayerNorm or RMSNorm over the last axis.  In a mesh (the dry run)
    the scale and bias are gathered whole, so the output keeps the
    input's layout."""
    xf = x.float()
    scale = gather_dim(p["scale"], 0).float()
    if cfg.norm == "ln":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * scale + gather_dim(p["bias"], 0).float()
    else:  # rms
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps)
        y = y * scale
    return y.to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Per-head q/k RMSNorm (Qwen3 qk_norm); x: (..., head_dim)."""
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings: standard, partial, and M-RoPE
# ---------------------------------------------------------------------------

def _rope_freqs(dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (torch.tensor(theta, dtype=torch.float32,
                               device=device) ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, n_heads, head_dim); positions: (B, S) or (3, B, S) for
    M-RoPE (t/h/w position triples, Qwen2-VL)."""
    hd = x.shape[-1]
    rot = int(hd * cfg.rotary_pct)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    freqs = _rope_freqs(rot, cfg.rope_theta, x.device)    # (rot/2,)
    if cfg.mrope_sections is not None and positions.dim() == 3:
        # M-RoPE: the rot/2 frequencies split in order into the (t, h, w)
        # sections, each rotated by its own position stream
        sec = cfg.mrope_sections
        if sum(sec) != rot // 2:
            raise ValueError(f"mrope_sections {sec} do not sum to {rot // 2}")
        angles = torch.cat([
            positions[axis][..., None].float() * f
            for axis, f in enumerate(torch.split(freqs, list(sec)))],
            dim=-1)                                        # (B, S, rot/2)
    else:
        pos = positions if positions.dim() == 2 else positions[0]
        angles = pos[..., None].float() * freqs            # (B, S, rot/2)
    cos = torch.cos(angles)[:, :, None, :]                # (B, S, 1, rot/2)
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x_rot[..., ::2], x_rot[..., 1::2]
    xr1 = x1 * cos - x2 * sin
    xr2 = x2 * cos + x1 * sin
    x_rot = torch.stack([xr1, xr2], dim=-1).reshape(x_rot.shape)
    return torch.cat([x_rot.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   device=None, cross: bool = False) -> Params:
    """``cross``: the decoder's cross-attention, without QKV bias or qk
    norm."""
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = torch_dtype(cfg.param_dtype)
    scale_in = 1.0 / math.sqrt(d)
    scale_out = 1.0 / math.sqrt(H * hd)
    p = {
        "wq": init_normal(gen, (d, H, hd), scale_in, dt, device),
        "wk": init_normal(gen, (d, KV, hd), scale_in, dt, device),
        "wv": init_normal(gen, (d, KV, hd), scale_in, dt, device),
        "wo": init_normal(gen, (H, hd, d), scale_out, dt, device),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros((H, hd), dtype=dt, device=device)
        p["bk"] = torch.zeros((KV, hd), dtype=dt, device=device)
        p["bv"] = torch.zeros((KV, hd), dtype=dt, device=device)
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.ones(hd, dtype=dt, device=device)
        p["k_norm"] = torch.ones(hd, dtype=dt, device=device)
    return p


def project_in(x: torch.Tensor, w: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """``(x @ w).astype(dtype)`` with JAX's promotion: a float32 input and
    bfloat16 weights multiply in float32 (the stub frontends' adapters)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return (x.to(dt) @ w.to(dt)).to(dtype)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w) as one matrix product.  A ``w`` whose
    head_dim the mesh splits (the dry run, when the heads do not divide
    the model axis) multiplies as (d, hd * n): a DTensor cannot shard the
    inner axis of a flattened (n, hd)."""
    B, S, d = x.shape
    _, n, hd = w.shape
    if mesh_split(w, 2) > 1:
        y = x.reshape(B * S, d) @ w.transpose(1, 2).reshape(d, hd * n)
        return keep_layout(y.view(B, S, hd, n).transpose(2, 3))
    return (x.reshape(B * S, d) @ w.reshape(d, n * hd)).view(B, S, n, hd)


def _project_qkv(p: Params, xq: torch.Tensor, xkv: torch.Tensor,
                 cfg: ModelConfig):
    q = _heads(xq, p["wq"])
    k = _heads(xkv, p["wk"])
    v = _heads(xkv, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if "q_norm" in p:
        q = rms_head_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_head_norm(p["k_norm"], k, cfg.norm_eps)
    q = hint(q, "batch", "seq", "heads", "head_dim")
    k = hint(k, "batch", "seq", "kv_heads", "head_dim")
    v = hint(v, "batch", "seq", "kv_heads", "head_dim")
    return q, k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd", out, wo) as one matrix product (over
    (hd, H) when the mesh splits ``wo``'s head_dim, as in :func:`_heads`)."""
    B, S, H, hd = out.shape
    if mesh_split(wo, 1) > 1:
        return (out.transpose(2, 3).reshape(B * S, hd * H)
                @ wo.transpose(0, 1).reshape(hd * H, -1)).view(B, S, -1)
    return (out.reshape(B * S, H * hd) @ wo.reshape(H * hd, -1)).view(B, S, -1)


def _repeat_kv(k: torch.Tensor, G: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, KV*G, hd), heads grouped by kv head."""
    if G == 1:
        return k
    B, S, KV, hd = k.shape
    return k[:, :, :, None, :].expand(B, S, KV, G, hd).reshape(
        B, S, KV * G, hd)


def _repeat_kv_hinted(k: torch.Tensor, G: int) -> torch.Tensor:
    """:func:`_repeat_kv`, hinted head-parallel.  When the mesh does not
    split the kv heads, a split of the repeated heads is no split of
    (KV, G), so the gradient is first made whole on the head axis."""
    whole = G > 1 and mesh_split(k, 2) == 1
    k = _repeat_kv(k, G)
    if whole:
        k = hint(k, "batch", "kv_seq", None, "head_dim")
    return hint(k, "batch", "kv_seq", "heads", "head_dim")


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Attention of scaled q (B, Sq, H, hd) over k/v (B, Sk, H, hd)."""
    scores = torch.einsum("bqhd,bshd->bhqs", q, k).float()
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", probs, v)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    """Grouped-query scaled-dot-product attention, materialised.

    q: (B, Sq, H, hd), k/v: (B, Sk, KV, hd), H = KV * G; query head h uses
    kv head h // G.  mask: additive, broadcastable to (B, 1, Sq, Sk), or
    None.  The products run per kv head over its G query heads, which is the
    JAX function's repeat-then-einsum without the copy.  On DTensors (the
    dry run) it is the JAX function's form: the kv heads repeated to H and
    hinted head-parallel, since a DTensor cannot split a sharded head axis
    into (KV, G)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    q = q * (1.0 / math.sqrt(hd))
    if hasattr(q, "placements"):
        # every (batch, head) pair is independent: each rank attends its
        # own shard (a DTensor cannot shard the (B * H) axis the batched
        # product flattens them into over two mesh axes)
        from torch.distributed.tensor.experimental import local_map
        k, v = _repeat_kv_hinted(k, G), _repeat_kv_hinted(v, G)
        pl = list(q.placements)
        return local_map(_attend, out_placements=pl,
                         in_placements=(pl, pl, pl, None),
                         redistribute_inputs=True)(q, k, v, mask)
    qg = q.view(B, Sq, KV, G, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float()
    scores = scores.reshape(B, H, Sq, Sk)
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd",
                       probs.view(B, KV, G, Sq, Sk), v)
    return out.reshape(B, Sq, H, hd)


def causal_mask(Sq: int, Sk: int, window: Optional[int], offset: int = 0,
                device=None) -> torch.Tensor:
    """Additive causal (+ sliding window) mask of shape (1, 1, Sq, Sk).
    ``offset``: absolute position of query row 0 (prefill starts at 0)."""
    qpos = torch.arange(Sq, device=device)[:, None] + offset
    kpos = torch.arange(Sk, device=device)[None, :]
    ok = kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return torch.where(ok, 0.0, NEG_INF)[None, None]


def attention_full(p: Params, x: torch.Tensor, positions: torch.Tensor,
                   cfg: ModelConfig, causal: bool = True
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence attention (prefill). Returns (out, kv_cache)."""
    q, k, v = _project_qkv(p, x, x, cfg)
    q = apply_rope(q, positions, cfg)
    k = apply_rope(k, positions, cfg)
    S = x.shape[1]
    if cfg.attention_impl == "flash":
        out = flash_attention(q, k, v, causal=causal, window=cfg.window)
    elif cfg.attention_impl == "plain":
        mask = causal_mask(S, S, cfg.window, device=x.device) \
            if causal else None
        out = _sdpa(q, k, v, mask, cfg)
    else:
        raise ValueError(f"attention_impl {cfg.attention_impl!r}: the port "
                         "has 'flash' and 'plain'")
    return _out_proj(out, p["wo"]), {"k": k, "v": v}


def attention_decode(p: Params, x: torch.Tensor, pos: int,
                     cache: Dict[str, torch.Tensor], cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token decode. x: (B, 1, d); cache k/v: (B, Smax, KV, hd);
    pos: the new token's position (all three M-RoPE streams at ``pos``).
    Writes the cache in place."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    if cfg.mrope_sections is not None:
        positions = positions[None].expand(3, B, 1)
    q, k_new, v_new = _project_qkv(p, x, x, cfg)
    q = apply_rope(q, positions, cfg)
    k_new = apply_rope(k_new, positions, cfg)
    k, v = cache["k"], cache["v"]
    Smax = k.shape[1]
    # Sliding-window caches are ring buffers of `window` slots: slot = pos %
    # Smax.  RoPE is relative, so keys keep their absolute-position rotation
    # and only validity masking is needed.
    ring = cfg.window is not None and Smax <= cfg.window
    slot = pos % Smax if ring else pos
    k[:, slot] = k_new[:, 0].to(k.dtype)
    v[:, slot] = v_new[:, 0].to(v.dtype)
    kpos = torch.arange(Smax, device=x.device)
    if ring:
        ok = (kpos <= pos) | (pos + 1 >= Smax)  # warm ring: all slots valid
    else:
        ok = kpos <= pos
        if cfg.window is not None:
            ok &= kpos > pos - cfg.window
    mask = torch.where(ok, 0.0, NEG_INF)[None, None, None, :]
    out = _sdpa(q, k, v, mask, cfg)
    return _out_proj(out, p["wo"]), {"k": k, "v": v}


def attention_cross(p: Params, x: torch.Tensor, enc: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Cross-attention (whisper decoder): no RoPE, no mask."""
    q, k, v = _project_qkv(p, x, enc, cfg)
    return _out_proj(_sdpa(q, k, v, None, cfg), p["wo"])


# ---------------------------------------------------------------------------
# Dense MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None, device=None) -> Params:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    dt = torch_dtype(cfg.param_dtype)
    si, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    if cfg.act == "swiglu":
        return {"wi_gate": init_normal(gen, (d, ff), si, dt, device),
                "wi_up": init_normal(gen, (d, ff), si, dt, device),
                "wo": init_normal(gen, (ff, d), so, dt, device)}
    return {"wi": init_normal(gen, (d, ff), si, dt, device),
            "wo": init_normal(gen, (ff, d), so, dt, device)}


def apply_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if "wi_gate" in p:
        g = F.silu(hint(x @ p["wi_gate"], "batch", "seq", "mlp"))
        u = hint(x @ p["wi_up"], "batch", "seq", "mlp")
        return (g * u) @ p["wo"]
    h = hint(x @ p["wi"], "batch", "seq", "mlp")
    return F.gelu(h, approximate="tanh") @ p["wo"]
