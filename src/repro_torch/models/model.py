"""``build_model``: an LM as an ``nn.Module``.

The port of ``repro/models/model.py::build_model``.  A decoder-only
config (attention, Mamba or RWKV-6 time mix; dense, mixture-of-experts or
RWKV channel-mix MLPs; DeepSeek-MoE's prelude layers, which lead the
layer list; hybrid patterns that interleave them, as Jamba's period of
Mamba, attention and MoE blocks does; token or stub-embedding inputs)
gives an :class:`LM` over the functions of ``lm.py``; a config with an
encoder tower gives an :class:`EncDec` over those of ``encdec.py``.
Each holds its parameter dict tree as ``nn.Parameter``s, so
``state_dict`` and ``named_parameters`` see them, and exposes the
reference's entry points: ``loss_fn`` (``ModelAPI.loss_fn``) for
training, and ``prefill``, ``decode_step`` and ``init_cache`` for serving.

The parameters are built frozen (``requires_grad=False``); a trainer calls
``model.requires_grad_(True)`` and takes ``model.params``, whose leaves
then take gradients.  ``prefill`` and ``decode_step`` run under
``torch.no_grad`` either way.

The dry run (``launch/dryrun.py``) builds nothing: :func:`param_specs` and
:func:`input_specs` give ``meta`` tensors (shapes and dtypes, no storage)
of a config's parameter tree, in the port's per-layer layout, and of one
(arch x shape) cell's inputs, the JAX package's ``ModelAPI.param_specs``
and ``input_specs`` (``jax.eval_shape`` stand-ins).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch import nn

from ..configs.base import ModelConfig, ShapeConfig
from ..kernels._compat import resolve_device
from . import encdec as encdec_mod
from . import lm as lm_mod

Params = Dict[str, Any]


def _module(tree) -> nn.Module:
    if isinstance(tree, list):
        return nn.ModuleList(_module(t) for t in tree)
    m = nn.Module()
    for name, val in tree.items():
        if isinstance(val, torch.Tensor):
            m.register_parameter(name, nn.Parameter(val, requires_grad=False))
        else:
            m.add_module(name, _module(val))
    return m


def _tree(m: nn.Module):
    if isinstance(m, nn.ModuleList):
        return [_tree(c) for c in m]
    out: Params = dict(m.named_parameters(recurse=False))
    out.update({name: _tree(c) for name, c in m.named_children()})
    return out


class _Model(nn.Module):
    def __init__(self, cfg: ModelConfig, params: Params,
                 device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.device = device
        self.tree = _module(params)

    @property
    def params(self) -> Params:
        """The parameters as the model module's dict tree (the same
        tensors)."""
        return _tree(self.tree)


class LM(_Model):
    """A decoder-only LM (dense, MoE, RWKV-6, hybrid or stub-embedding)
    on one device."""

    def loss_fn(self, params: Params, batch: Dict[str, torch.Tensor]):
        """(loss, {"xent", "aux"}) of ``batch`` (tokens, or embeds and
        M-RoPE positions; labels (B, S)) under ``params`` (``lm.lm_loss``:
        the cross entropy plus 0.01 x the layers' MoE load-balancing loss,
        ``aux``)."""
        return lm_mod.lm_loss(params, batch, self.cfg)

    @torch.no_grad()
    def prefill(self, batch):
        """tokens (B, S), or a batch dict (``tokens``, or ``embeds``
        (B, S, d) and optional ``positions`` (3, B, S)) -> (last-position
        logits (B, 1, V) float32, each layer's cache of the prompt:
        attention k/v, the Mamba conv window and state, or the RWKV state
        and last rows)."""
        if not isinstance(batch, dict):
            batch = {"tokens": batch}
        return lm_mod.lm_prefill(self.params, batch, self.cfg)

    @torch.no_grad()
    def decode_step(self, cache: List[Params], tokens: torch.Tensor,
                    pos: int):
        """tokens (B, 1) (stub frontends: embeddings (B, 1, d)) at
        position ``pos`` -> (logits (B, 1, V), cache); the cache is
        updated in place."""
        return lm_mod.lm_decode_step(self.params, cache, tokens, pos,
                                     self.cfg)

    def init_cache(self, batch: int, max_seq: int) -> List[Params]:
        return lm_mod.lm_init_cache(None, self.cfg, batch, max_seq,
                                    self.device)


class EncDec(_Model):
    """An encoder-decoder (whisper) on one device."""

    def loss_fn(self, params: Params, batch: Dict[str, torch.Tensor]):
        """(xent, {"xent", "aux"}) of ``batch`` (embeds (B, S_enc,
        d_input), tokens, labels (B, S)) under ``params``."""
        return encdec_mod.encdec_loss(params, batch, self.cfg)

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor]):
        """A batch of ``embeds`` (B, S_enc, d_input) and ``tokens`` (B, S)
        -> (last-position logits (B, 1, V) float32, each decoder layer's
        self k/v and cross K/V)."""
        return encdec_mod.encdec_prefill(self.params, batch, self.cfg)

    @torch.no_grad()
    def decode_step(self, cache: List[Params], tokens: torch.Tensor,
                    pos: int):
        """tokens (B, 1) at position ``pos`` -> (logits (B, 1, V), cache);
        the self-attention cache is updated in place."""
        return encdec_mod.encdec_decode_step(self.params, cache, tokens,
                                             pos, self.cfg)

    def init_cache(self, batch: int, max_seq: int,
                   enc_seq: int) -> List[Params]:
        """Self k/v at ``max_seq`` positions, cross K/V at ``enc_seq``."""
        return encdec_mod.encdec_init_cache(self.cfg, batch, max_seq,
                                            enc_seq, self.device)


def init_params(gen: Optional[torch.Generator], cfg: ModelConfig,
                device=None) -> Params:
    """``cfg``'s parameter tree drawn from ``gen`` on ``device``."""
    if cfg.encoder is not None:
        return encdec_mod.init_encdec(gen, cfg, device)
    return lm_mod.init_lm(gen, cfg, device)


def build_model(cfg: ModelConfig, device=None, seed: int = 0,
                params: Optional[Params] = None):
    """The model of ``cfg`` on ``device`` (the card unless ``"cpu"``): an
    :class:`EncDec` for a config with an encoder tower, else an
    :class:`LM`.  Without ``params`` it draws them with
    :func:`init_params` from a ``torch.Generator`` on the device seeded
    with ``seed``."""
    dev = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            params = init_params(gen, cfg, dev)
    return (EncDec if cfg.encoder is not None else LM)(cfg, params, dev)


def param_specs(cfg: ModelConfig) -> Params:
    """``cfg``'s parameter tree as ``meta`` tensors (the port's layout:
    one dict a layer)."""
    with torch.no_grad():
        return init_params(None, cfg, torch.device("meta"))


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``meta`` inputs of one (arch x shape) cell, the JAX package's
    shapes and dtypes: for train and prefill a batch dict (``tokens``
    int32 (B, S); an encoder-decoder's ``embeds`` (B, S, d_input) beside
    them; a stub frontend's ``embeds`` (B, S, d) and, under M-RoPE,
    ``positions`` (3, B, S) in their place; ``labels`` for train), for
    decode the ``cache`` of S past positions (an encoder-decoder's cross
    K/V at S too), one new ``tokens`` (B, 1) (a stub frontend: (B, 1, d)
    embeddings) and ``pos`` (a 0-d int32)."""
    B, S = shape.global_batch, shape.seq_len
    meta = torch.device("meta")
    d = cfg.d_model
    emb_dt = {"float32": torch.float32,
              "bfloat16": torch.bfloat16}[cfg.dtype]

    def ints(*s):
        return torch.empty(s, dtype=torch.int32, device=meta)

    if shape.kind in ("train", "prefill"):
        batch: Dict[str, Any] = {}
        if cfg.encoder is not None:
            d_in = cfg.encoder.d_input or d
            batch["embeds"] = torch.empty((B, S, d_in), dtype=emb_dt,
                                          device=meta)
            batch["tokens"] = ints(B, S)
        elif cfg.embed_inputs:
            batch["tokens"] = ints(B, S)
        else:
            batch["embeds"] = torch.empty((B, S, d), dtype=emb_dt,
                                          device=meta)
            if cfg.mrope_sections is not None:
                batch["positions"] = ints(3, B, S)
        if shape.kind == "train":
            batch["labels"] = ints(B, S)
        return batch

    if cfg.encoder is not None:
        cache = encdec_mod.encdec_init_cache(cfg, B, S, S, meta)
    else:
        cache = lm_mod.lm_init_cache(None, cfg, B, S, meta)
    if cfg.embed_inputs or cfg.encoder is not None:
        tokens = ints(B, 1)
    else:
        tokens = torch.empty((B, 1, d), dtype=emb_dt, device=meta)
    return {"cache": cache, "tokens": tokens, "pos": ints()}
