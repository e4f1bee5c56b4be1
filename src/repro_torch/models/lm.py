"""Decoder-only LM assembly: blocks, the layer loop, the decode cache,
and the train / prefill / decode entry points.

The port of ``repro/models/lm.py``: the ``attn``/``mamba``/``rwkv`` mixers
and the ``dense``/``moe``/``rwkv_ffn`` MLPs; any pairing of them is a
block, and a pattern may mix them (Jamba's period interleaves Mamba,
attention and MoE blocks).
Parameters are a dict: ``embed`` (V, d) (for stub-embedding inputs,
``cfg.embed_inputs=False``: the frontend's linear ``adapter`` (d, d) and
the output embeddings ``embed_out`` (V, d) in its place), ``final_norm``,
``lm_head`` (d, V) and ``layers``, a list with one block dict per layer
in execution order: the ``cfg.prelude`` blocks first (DeepSeek-MoE's dense
first layer), then ``cfg.pattern`` repeated ``cfg.n_repeats`` times.  (JAX
keeps the prelude blocks in a list under ``prelude`` and stacks the
pattern's layers along a leading axis and scans; here a Python loop walks
one list, and ``convert.py`` maps between the two layouts.)  The cache is
a list with one dict per layer, in the same order: ``{"mixer": {"k",
"v"}}`` for attention, ``{"mixer": {"conv", "ssm"}}`` for Mamba (the last dc-1
pre-conv inputs and the float32 state), ``{"mixer": {"state",
"x_prev"}}`` for the RWKV time mix, and ``"mlp": {"x_prev"}`` beside it
for the RWKV channel mix.

:func:`apply_block` and :func:`apply_stack` return the MoE load-balancing
auxiliary loss beside ``x`` and the cache, as JAX's do: 0 for a block
without a ``moe`` MLP, summed over the layers by :func:`apply_stack` (in
every mode), and :func:`lm_loss` is ``xent + aux_weight * aux``.

Training: :func:`lm_loss` is the next-token cross entropy
(:func:`softmax_xent`, with ``cfg.logits_chunk`` > 0 a streaming
logsumexp over vocabulary chunks), and ``apply_stack``'s ``"train"`` mode
wraps each layer in ``cfg.remat``: ``"none"``; ``"full"``,
``torch.utils.checkpoint`` around the layer (the JAX package's
``jax.checkpoint`` around the scanned group, which here is one layer a
pattern entry); ``"dots"``, a selective checkpoint that keeps the outputs
of plain matrix products (``aten.mm``/``aten.addmm``) and recomputes the
rest (its ``dots_with_no_batch_dims_saveable``).

Stub-embedding inputs (Qwen2-VL's stubbed vision tower) are a batch of
``embeds`` (B, S, d) and, with ``cfg.mrope_sections``, M-RoPE
``positions`` (3, B, S); without them every stream takes the token's
index, which makes M-RoPE plain RoPE.  A decode step takes (B, 1, d)
embeddings in place of tokens.  Encoder-decoder configs are
``models/encdec.py``'s.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ModelConfig
from . import mamba as mamba_mod
from . import moe as moe_mod
from . import rwkv as rwkv_mod
from ..utils.shard_hints import current_mesh, hint
from .layers import (apply_mlp, apply_norm, attention_decode,
                     attention_full, init_attention, init_mlp, init_norm,
                     init_normal, project_in, torch_dtype)

Params = Dict[str, Any]

_MIXERS = ("attn", "mamba", "rwkv")
_MLPS = ("dense", "moe", "rwkv_ffn")


def _check_kind(kind: Tuple[str, str]) -> None:
    for part, known in zip(kind, (_MIXERS, _MLPS)):
        if part not in known:
            raise ValueError(f"unknown block kind {part!r}")


def _check_cfg(cfg: ModelConfig) -> None:
    if cfg.encoder is not None:
        raise ValueError(f"{cfg.name} has an encoder tower: models/encdec.py "
                         "builds it")
    for kind in cfg.prelude + tuple(cfg.pattern):
        _check_kind(kind)


def layer_kinds(cfg: ModelConfig) -> Tuple[Tuple[str, str], ...]:
    """Every layer's (mixer, mlp) kind, in the order of ``params["layers"]``:
    the prelude, then the pattern ``n_repeats`` times."""
    return tuple(cfg.prelude) + tuple(cfg.pattern) * cfg.n_repeats


# ---------------------------------------------------------------------------
# Single block (mixer + channel-mlp with pre-norms and residuals)
# ---------------------------------------------------------------------------

def init_block(gen: torch.Generator, kind: Tuple[str, str],
               cfg: ModelConfig, device=None) -> Params:
    _check_kind(kind)
    mixer, mlp = kind
    if mlp == "dense":
        p_mlp = init_mlp(gen, cfg, device=device)
    elif mlp == "moe":
        p_mlp = moe_mod.init_moe(gen, cfg, device=device)
    else:
        p_mlp = rwkv_mod.init_channel_mix(gen, cfg, device=device)
    init_mixer = {"attn": init_attention, "mamba": mamba_mod.init_mamba,
                  "rwkv": rwkv_mod.init_time_mix}[mixer]
    return {"norm1": init_norm(cfg, device=device),
            "norm2": init_norm(cfg, device=device),
            "mixer": init_mixer(gen, cfg, device=device),
            "mlp": p_mlp}


def block_cache_init(kind: Tuple[str, str], cfg: ModelConfig, batch: int,
                     max_seq: int, dtype: torch.dtype, device=None) -> Params:
    """Zero-initialized decode cache for one block."""
    _check_kind(kind)
    mixer, mlp = kind
    d = cfg.d_model
    if mixer == "attn":
        KV, hd = cfg.num_kv_heads, cfg.head_dim
        # Sliding-window archs keep a ring buffer of `window` slots.
        S = min(max_seq, cfg.window) if cfg.window is not None else max_seq
        cache: Params = {"mixer": {
            "k": torch.zeros((batch, S, KV, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, S, KV, hd), dtype=dtype,
                             device=device)}}
    elif mixer == "mamba":
        di, ds, dc = cfg.d_inner_mamba, cfg.mamba_d_state, cfg.mamba_d_conv
        cache = {"mixer": {
            "conv": torch.zeros((batch, dc - 1, di), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, di, ds), dtype=torch.float32,
                               device=device)}}
    else:
        n = cfg.rwkv_head_dim
        cache = {"mixer": {
            "state": torch.zeros((batch, d // n, n, n), dtype=torch.float32,
                                 device=device),
            "x_prev": torch.zeros((batch, d), dtype=dtype, device=device)}}
    if mlp == "rwkv_ffn":
        cache["mlp"] = {"x_prev": torch.zeros((batch, d), dtype=dtype,
                                              device=device)}
    return cache


def apply_block(p: Params, x: torch.Tensor, kind: Tuple[str, str],
                cfg: ModelConfig, mode: str, cache: Optional[Params] = None,
                pos: Optional[int] = None,
                positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Params, torch.Tensor]:
    """Returns (x, new_cache, aux_loss)."""
    _check_kind(kind)
    mixer, mlp = kind
    decode = mode == "decode"
    new_cache: Params = {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(p["norm1"], x, cfg)
    if mixer == "attn":
        if decode:
            y, new_cache["mixer"] = attention_decode(p["mixer"], h, pos,
                                                     cache["mixer"], cfg)
        else:
            y, new_cache["mixer"] = attention_full(p["mixer"], h, positions,
                                                   cfg)
    elif mixer == "mamba":
        if decode:
            y, new_cache["mixer"] = mamba_mod.mamba_step(p["mixer"], h,
                                                         cache["mixer"], cfg)
        else:
            y, new_cache["mixer"] = mamba_mod.mamba_full(p["mixer"], h, cfg)
    elif decode:
        y, new_cache["mixer"] = rwkv_mod.time_mix_step(p["mixer"], h,
                                                       cache["mixer"], cfg)
    else:
        y, new_cache["mixer"] = rwkv_mod.time_mix_full(p["mixer"], h, cfg)
    x = hint(x + y, "batch", "seq", "embed")
    h2 = apply_norm(p["norm2"], x, cfg)
    if mlp == "dense":
        y2 = apply_mlp(p["mlp"], h2, cfg)
    elif mlp == "moe":
        y2, aux = moe_mod.apply_moe(p["mlp"], h2, cfg)
    elif decode:
        y2, new_cache["mlp"] = rwkv_mod.channel_mix_step(p["mlp"], h2,
                                                         cache["mlp"], cfg)
    else:
        y2, new_cache["mlp"] = rwkv_mod.channel_mix_full(p["mlp"], h2, cfg)
    x = hint(x + y2, "batch", "seq", "embed")
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# Whole-model params
# ---------------------------------------------------------------------------

def init_lm(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    """Parameters drawn from ``gen`` (on ``device``) with the JAX
    package's distributions: embed (and embed_out) N(0, 0.02^2),
    projections (and the stub adapter) N(0, 1/fan_in), norms ones, biases
    zeros."""
    _check_cfg(cfg)
    dt = torch_dtype(cfg.param_dtype)
    V, d = cfg.vocab_size, cfg.d_model
    if cfg.embed_inputs:
        p: Params = {"embed": init_normal(gen, (V, d), 0.02, dt, device)}
    else:
        p = {"adapter": init_normal(gen, (d, d), d ** -0.5, dt, device),
             "embed_out": init_normal(gen, (V, d), 0.02, dt, device)}
    p["layers"] = [init_block(gen, kind, cfg, device)
                   for kind in layer_kinds(cfg)]
    p["final_norm"] = init_norm(cfg, device=device)
    if not cfg.tie_embeddings:
        p["lm_head"] = init_normal(gen, (cfg.d_model, cfg.vocab_size),
                                   cfg.d_model ** -0.5, dt, device)
    return p


def _unembed_matrix(params: Params, cfg: ModelConfig) -> torch.Tensor:
    if not cfg.tie_embeddings:
        return params["lm_head"]
    return params.get("embed", params.get("embed_out")).T


# ---------------------------------------------------------------------------
# Stack application
# ---------------------------------------------------------------------------

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the outputs of plain (batch-free) matrix products."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg: ModelConfig):
    """``fn(x) -> (x, aux)`` wrapped in ``cfg.remat``'s checkpoint policy."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _dots_policy)
        return lambda x: checkpoint(fn, x, use_reentrant=False,
                                    context_fn=ctx)
    if cfg.remat == "full":
        return lambda x: checkpoint(fn, x, use_reentrant=False)
    raise ValueError(f"remat {cfg.remat!r}: none|dots|full")


def apply_stack(params: Params, x: torch.Tensor, cfg: ModelConfig,
                mode: str, cache: Optional[List[Params]] = None,
                pos: Optional[int] = None,
                positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, List[Params], torch.Tensor]:
    """Every layer in order.  Returns (x, new_cache, total_aux), the cache
    one entry a layer; in ``"train"`` mode each layer runs under
    ``cfg.remat`` (the checkpointed function returns its aux beside x) and
    the cache is empty."""
    _check_cfg(cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: List[Params] = []
    for i, (p, kind) in enumerate(zip(params["layers"], layer_kinds(cfg))):
        if mode == "train":
            def layer(h, p=p, kind=kind):
                y, _, aux = apply_block(p, h, kind, cfg, mode,
                                        positions=positions)
                return y, aux
            x, aux = _remat(layer, cfg)(x)
        else:
            c = cache[i] if cache is not None else None
            x, nc, aux = apply_block(p, x, kind, cfg, mode, c, pos,
                                     positions)
            new_cache.append(nc)
        aux_total = aux_total + aux
    return x, new_cache, aux_total


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows ``tokens`` of ``table`` (``F.embedding``).  A DTensor
    table split over the vocabulary (the dry run) gives partial rows,
    summed across that split at once."""
    out = torch.nn.functional.embedding(tokens, table)
    if hasattr(out, "placements") and any(p.is_partial()
                                          for p in out.placements):
        from torch.distributed.tensor import Replicate
        out = out.redistribute(out.device_mesh, [
            Replicate() if p.is_partial() else p for p in out.placements])
    return out


def embed_tokens(params: Params, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (x, positions) for token or stub-embedding inputs; positions
    (3, B, S) under M-RoPE (the batch's, or the token index in all three
    streams), else (B, S)."""
    _check_cfg(cfg)
    dtype = torch_dtype(cfg.dtype)
    if cfg.embed_inputs:
        x = embed_lookup(params["embed"], batch["tokens"]).to(dtype)
    else:
        x = project_in(batch["embeds"], params["adapter"], dtype)
    x = hint(x, "batch", "seq", "embed")
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    if cfg.mrope_sections is not None:
        given = batch.get("positions")
        positions = positions[None].expand(3, B, S) if given is None \
            else given
    return x, positions


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def _pick(lg: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``lg[..., idx]`` along the last axis.  Inside a mesh context (the dry
    run) a masked sum, which has the same value: DTensor cannot reduce
    the result of a gather over a sharded axis."""
    if current_mesh() is None:
        return torch.gather(lg, -1, idx[..., None])[..., 0]
    hit = idx[..., None] == torch.arange(lg.shape[-1], device=lg.device)
    return torch.where(hit, lg, 0.0).sum(-1)


def softmax_xent(h: torch.Tensor, unembed: torch.Tensor,
                 labels: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross entropy. ``cfg.logits_chunk`` > 0 computes the
    logsumexp over vocab chunks (a running max and sum, as the JAX package
    does) so that (B, S, V) is never materialised in one piece."""
    B, S, d = h.shape
    V = unembed.shape[1]
    chunk = cfg.logits_chunk
    labels = labels.long()
    if chunk <= 0 or chunk >= V:
        logits = hint((h @ unembed).float(), "batch", "seq", "vocab")
        lse = torch.logsumexp(logits, dim=-1)
        ll = _pick(logits, labels)
        return torch.mean(lse - ll)

    n_chunks = -(-V // chunk)
    m = torch.full((B, S), -math.inf, dtype=torch.float32, device=h.device)
    s = torch.zeros((B, S), dtype=torch.float32, device=h.device)
    ll = torch.zeros((B, S), dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        lo = i * chunk
        w = unembed[:, lo:lo + chunk]
        lg = hint((h @ w).float(), "batch", "seq", None)
        m_new = torch.maximum(m, lg.amax(-1))
        s = s * torch.exp(m - m_new) \
            + torch.exp(lg - m_new[..., None]).sum(-1)
        m = m_new
        in_chunk = (labels >= lo) & (labels < lo + w.shape[1])
        idx = torch.clamp(labels - lo, 0, w.shape[1] - 1)
        ll = ll + torch.where(in_chunk, _pick(lg, idx), 0.0)
    lse = m + torch.log(s)
    return torch.mean(lse - ll)


def lm_loss(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, aux_weight: float = 0.01):
    """Training loss (+ metrics). batch: tokens (or embeds and optional
    M-RoPE positions) + labels (B, S).
    Returns (loss, {"xent", "aux"}); ``aux`` is the layers' summed MoE
    load-balancing loss (0 without a ``moe`` block)."""
    x, positions = embed_tokens(params, batch, cfg)
    x, _, aux = apply_stack(params, x, cfg, "train", positions=positions)
    x = apply_norm(params["final_norm"], x, cfg)
    xent = softmax_xent(x, _unembed_matrix(params, cfg), batch["labels"],
                        cfg)
    loss = xent + aux_weight * aux
    return loss, {"xent": xent, "aux": aux}


def lm_prefill(params: Params, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig) -> Tuple[torch.Tensor, List[Params]]:
    """Full forward returning (last-position logits (B, 1, V), cache)."""
    x, positions = embed_tokens(params, batch, cfg)
    x, cache, _ = apply_stack(params, x, cfg, "prefill",
                              positions=positions)
    x = apply_norm(params["final_norm"], x, cfg)
    logits = (x[:, -1:] @ _unembed_matrix(params, cfg)).float()
    return logits, cache


def lm_decode_step(params: Params, cache: List[Params],
                   tokens: torch.Tensor, pos: int, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, List[Params]]:
    """One decode step. tokens: (B, 1) (or embeds (B, 1, d) for stub
    frontends); pos: the tokens' position.  Returns (logits (B, 1, V),
    cache), the cache updated in place."""
    dtype = torch_dtype(cfg.dtype)
    x = embed_lookup(params["embed"], tokens).to(dtype) if cfg.embed_inputs \
        else project_in(tokens, params["adapter"], dtype)
    x, new_cache, _ = apply_stack(params, x, cfg, "decode", cache=cache,
                                  pos=pos)
    x = apply_norm(params["final_norm"], x, cfg)
    logits = (x @ _unembed_matrix(params, cfg)).float()
    return logits, new_cache


def lm_init_cache(params_or_none, cfg: ModelConfig, batch: int, max_seq: int,
                  device=None) -> List[Params]:
    _check_cfg(cfg)
    dtype = torch_dtype(cfg.dtype)
    return [block_cache_init(kind, cfg, batch, max_seq, dtype, device)
            for kind in layer_kinds(cfg)]
