"""Encoder-decoder backbone (Whisper-style; the conv/audio frontend stubbed).

The port of ``repro/models/encdec.py``.  The encoder takes precomputed
frame embeddings ``embeds`` (B, S_enc, d_input) through a linear
``frontend`` and applies bidirectional attention blocks; the decoder is a
causal LM with cross-attention to the encoder output.  A decode step runs
the decoder against a self-attention cache and the cross-attention K/V
that the prefill computed once.

Parameters are a dict: ``frontend`` (d_input, d), ``embed`` (V, d),
``enc_layers`` and ``dec_layers`` (a list with one block dict per layer;
JAX stacks each along a leading axis and scans, ``convert.py`` maps
between the two), ``enc_final_norm``, ``final_norm`` and, untied,
``lm_head`` (d, V).  The cache is a list with one dict per decoder layer:
``{"self": {"k", "v"}, "cross": {"k", "v"}}`` (JAX: ``self``, ``cross_k``,
``cross_v``), the self-attention k/v at the decode capacity and the cross
K/V at the encoder's length, S_enc: :func:`encdec_init_cache` takes
``enc_seq`` apart from ``max_seq``.  (The JAX package's server pads the
cross K/V out to ``max_seq`` with zero keys that every decode step then
attends to; ROADMAP.md section 3.)

The encoder runs its layers under ``torch.utils.checkpoint`` whenever
``cfg.remat`` is not ``"none"``, in every mode, and the decoder under
``"train"`` only, as the reference does; both checkpoints save nothing
(the reference's plain ``jax.checkpoint``, for ``"dots"`` too).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from .layers import (_heads, _out_proj, _sdpa, apply_mlp, apply_norm,
                     attention_cross, attention_decode, attention_full,
                     init_attention, init_mlp, init_norm, init_normal,
                     project_in, torch_dtype)

Params = Dict[str, Any]


def _init_enc_layer(gen, cfg: ModelConfig, device) -> Params:
    return {"norm1": init_norm(cfg, device=device),
            "attn": init_attention(gen, cfg, device),
            "norm2": init_norm(cfg, device=device),
            "mlp": init_mlp(gen, cfg, device=device)}


def _init_dec_layer(gen, cfg: ModelConfig, device) -> Params:
    return {"norm1": init_norm(cfg, device=device),
            "self_attn": init_attention(gen, cfg, device),
            "norm_x": init_norm(cfg, device=device),
            "cross_attn": init_attention(gen, cfg, device, cross=True),
            "norm2": init_norm(cfg, device=device),
            "mlp": init_mlp(gen, cfg, device=device)}


def init_encdec(gen: torch.Generator, cfg: ModelConfig,
                device=None) -> Params:
    """Parameters drawn from ``gen`` (on ``device``) with the JAX
    package's distributions: frontend N(0, 1/d_input), embed N(0, 0.02^2),
    projections N(0, 1/fan_in), norms ones."""
    enc = cfg.encoder
    d_in = enc.d_input or cfg.d_model
    dt = torch_dtype(cfg.param_dtype)
    d = cfg.d_model
    p: Params = {
        "frontend": init_normal(gen, (d_in, d), d_in ** -0.5, dt, device),
        "embed": init_normal(gen, (cfg.vocab_size, d), 0.02, dt, device),
        "enc_final_norm": init_norm(cfg, device=device),
        "final_norm": init_norm(cfg, device=device),
        "enc_layers": [_init_enc_layer(gen, cfg, device)
                       for _ in range(enc.num_layers)],
        "dec_layers": [_init_dec_layer(gen, cfg, device)
                       for _ in range(cfg.num_layers)],
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = init_normal(gen, (d, cfg.vocab_size), d ** -0.5, dt,
                                   device)
    return p


def _checkpointed(fn, cfg: ModelConfig):
    """``fn(x)`` under a checkpoint that saves nothing, unless
    ``cfg.remat`` is ``"none"``."""
    if cfg.remat == "none":
        return fn
    return lambda x: checkpoint(fn, x, use_reentrant=False)


def _positions(x: torch.Tensor) -> torch.Tensor:
    B, S = x.shape[:2]
    return torch.arange(S, device=x.device)[None].expand(B, S)


def encode(params: Params, embeds: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """embeds: (B, S_enc, d_input) stub frame embeddings -> (B, S_enc, d).
    Non-causal self-attention through ``cfg.attention_impl``."""
    x = project_in(embeds, params["frontend"], torch_dtype(cfg.dtype))
    positions = _positions(x)

    def layer(x, p):
        h = apply_norm(p["norm1"], x, cfg)
        y, _ = attention_full(p["attn"], h, positions, cfg, causal=False)
        x = x + y
        h = apply_norm(p["norm2"], x, cfg)
        return x + apply_mlp(p["mlp"], h, cfg)

    for p in params["enc_layers"]:
        x = _checkpointed(lambda h, p=p: layer(h, p), cfg)(x)
    return apply_norm(params["enc_final_norm"], x, cfg)


def _dec_block(p: Params, x: torch.Tensor, cfg: ModelConfig, mode: str,
               enc: Optional[torch.Tensor] = None,
               cache: Optional[Params] = None, pos: Optional[int] = None,
               positions: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Params]:
    """One decoder block.  ``"prefill"`` returns the self k/v and the
    cross K/V of ``enc``; ``"decode"`` attends to the cache's cross K/V
    and writes the new token's self k/v in place; ``"train"`` returns no
    cache."""
    new_cache: Params = {}
    h = apply_norm(p["norm1"], x, cfg)
    if mode == "decode":
        y, new_cache["self"] = attention_decode(p["self_attn"], h, pos,
                                                cache["self"], cfg)
    else:
        y, new_cache["self"] = attention_full(p["self_attn"], h, positions,
                                              cfg)
    x = x + y
    h = apply_norm(p["norm_x"], x, cfg)
    ca = p["cross_attn"]
    if mode == "decode":
        q = _heads(h, ca["wq"])
        cross = cache["cross"]
        y = _out_proj(_sdpa(q, cross["k"], cross["v"], None, cfg), ca["wo"])
        new_cache["cross"] = cross
    else:
        y = attention_cross(ca, h, enc, cfg)
        if mode == "prefill":
            new_cache["cross"] = {"k": _heads(enc, ca["wk"]),
                                  "v": _heads(enc, ca["wv"])}
    x = x + y
    h = apply_norm(p["norm2"], x, cfg)
    return x + apply_mlp(p["mlp"], h, cfg), new_cache


def decode_stack(params: Params, x: torch.Tensor, cfg: ModelConfig,
                 mode: str, enc: Optional[torch.Tensor] = None,
                 cache: Optional[List[Params]] = None,
                 pos: Optional[int] = None
                 ) -> Tuple[torch.Tensor, List[Params]]:
    """Every decoder layer, then ``final_norm``.  Returns (x, the cache one
    entry a layer; empty in ``"train"`` mode, where each layer runs under
    ``cfg.remat``)."""
    positions = _positions(x)
    new_cache: List[Params] = []
    for i, p in enumerate(params["dec_layers"]):
        if mode == "train":
            def layer(h, p=p):
                return _dec_block(p, h, cfg, mode, enc=enc,
                                  positions=positions)[0]
            x = _checkpointed(layer, cfg)(x)
        else:
            c = cache[i] if cache is not None else None
            x, nc = _dec_block(p, x, cfg, mode, enc, c, pos, positions)
            new_cache.append(nc)
    return apply_norm(params["final_norm"], x, cfg), new_cache


def _unembed(params: Params, cfg: ModelConfig) -> torch.Tensor:
    return params["lm_head"] if not cfg.tie_embeddings \
        else params["embed"].T


def _embed(params: Params, tokens: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    from .lm import embed_lookup
    return embed_lookup(params["embed"], tokens).to(torch_dtype(cfg.dtype))


def encdec_loss(params: Params, batch: Dict[str, torch.Tensor],
                cfg: ModelConfig, aux_weight: float = 0.0):
    """(xent, {"xent", "aux"}) of a batch of ``embeds`` (B, S_enc,
    d_input), ``tokens`` and ``labels`` (B, S); ``aux`` is 0."""
    from .lm import softmax_xent
    enc = encode(params, batch["embeds"], cfg)
    x, _ = decode_stack(params, _embed(params, batch["tokens"], cfg), cfg,
                        "train", enc=enc)
    xent = softmax_xent(x, _unembed(params, cfg), batch["labels"], cfg)
    return xent, {"xent": xent,
                  "aux": torch.zeros((), dtype=torch.float32,
                                     device=x.device)}


def encdec_prefill(params: Params, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig) -> Tuple[torch.Tensor, List[Params]]:
    """(last-position logits (B, 1, V) float32, cache): the decoder's
    self k/v of the prompt and the cross K/V at S_enc."""
    enc = encode(params, batch["embeds"], cfg)
    x, cache = decode_stack(params, _embed(params, batch["tokens"], cfg),
                            cfg, "prefill", enc=enc)
    logits = (x[:, -1:] @ _unembed(params, cfg)).float()
    return logits, cache


def encdec_decode_step(params: Params, cache: List[Params],
                       tokens: torch.Tensor, pos: int, cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, List[Params]]:
    """One decode step. tokens: (B, 1); pos: their position.  Returns
    (logits (B, 1, V), cache), the self-attention cache written in
    place."""
    x, new_cache = decode_stack(params, _embed(params, tokens, cfg), cfg,
                                "decode", cache=cache, pos=pos)
    return (x @ _unembed(params, cfg)).float(), new_cache


def encdec_init_cache(cfg: ModelConfig, batch: int, max_seq: int,
                      enc_seq: int, device=None) -> List[Params]:
    """Zero caches: self k/v at ``max_seq``, cross K/V at ``enc_seq``."""
    dtype = torch_dtype(cfg.dtype)
    KV, hd = cfg.num_kv_heads, cfg.head_dim

    def kv(S):
        return {n: torch.zeros((batch, S, KV, hd), dtype=dtype,
                               device=device) for n in ("k", "v")}

    return [{"self": kv(max_seq), "cross": kv(enc_seq)}
            for _ in range(cfg.num_layers)]
