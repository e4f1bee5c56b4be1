"""``build_model``: a decoder-only LM as an ``nn.Module``.

The port of ``repro/models/model.py::build_model`` for decoder-only
configs whose blocks ``lm.py`` ports (attention, Mamba or RWKV-6 time mix;
dense, mixture-of-experts or RWKV channel-mix MLPs; DeepSeek-MoE's prelude
layers, which lead the layer list; and hybrid patterns that interleave
them, as Jamba's period of Mamba, attention and MoE blocks does).
:class:`LM` holds the parameters of ``lm.init_lm``'s dict tree as
``nn.Parameter``s, so ``state_dict`` and ``named_parameters`` see them,
and exposes the reference's entry points over the functions of
``lm.py``: ``loss_fn`` (``ModelAPI.loss_fn``) for training, and
``prefill``, ``decode_step`` and ``init_cache`` for serving.

The parameters are built frozen (``requires_grad=False``); a trainer calls
``model.requires_grad_(True)`` and takes ``model.params``, whose leaves
then take gradients.  ``prefill`` and ``decode_step`` run under
``torch.no_grad`` either way.  The dry run's ``input_specs`` and
``param_specs`` (``jax.eval_shape`` stand-ins for a TPU-mesh compile) wait
for the mesh modules (ROADMAP.md queue 1 item 6).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..kernels._compat import resolve_device
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


class LM(nn.Module):
    """A decoder-only LM (dense, MoE, RWKV-6 or hybrid) on one device."""

    def __init__(self, cfg: ModelConfig, params: Params,
                 device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.device = device
        self.tree = _module(params)

    @property
    def params(self) -> Params:
        """The parameters as ``lm.py``'s dict tree (the same tensors)."""
        return _tree(self.tree)

    def loss_fn(self, params: Params, batch: Dict[str, torch.Tensor]):
        """(loss, {"xent", "aux"}) of ``batch`` (tokens, labels (B, S))
        under ``params`` (``lm.lm_loss``: the cross entropy plus 0.01 x the
        layers' MoE load-balancing loss, ``aux``)."""
        return lm_mod.lm_loss(params, batch, self.cfg)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor):
        """tokens (B, S) -> (last-position logits (B, 1, V) float32,
        each layer's cache of the prompt: attention k/v, the Mamba conv
        window and state, or the RWKV state and last rows)."""
        return lm_mod.lm_prefill(self.params, {"tokens": tokens}, self.cfg)

    @torch.no_grad()
    def decode_step(self, cache: List[Params], tokens: torch.Tensor,
                    pos: int):
        """tokens (B, 1) at position ``pos`` -> (logits (B, 1, V), cache);
        the cache is updated in place."""
        return lm_mod.lm_decode_step(self.params, cache, tokens, pos,
                                     self.cfg)

    def init_cache(self, batch: int, max_seq: int) -> List[Params]:
        return lm_mod.lm_init_cache(None, self.cfg, batch, max_seq,
                                    self.device)


def build_model(cfg: ModelConfig, device=None, seed: int = 0,
                params: Optional[Params] = None) -> LM:
    """The model of ``cfg`` on ``device`` (the card unless ``"cpu"``).
    Without ``params`` it draws them with ``lm.init_lm`` from a
    ``torch.Generator`` on the device seeded with ``seed``."""
    dev = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            params = lm_mod.init_lm(gen, cfg, dev)
    return LM(cfg, params, dev)
