"""Config registry: the architectures the port runs.

The three dense decoders and ``rwkv6-3b``; the JAX package's other
architectures (MoE, mamba and hybrid stacks, encoder towers) come with
their families (ROADMAP.md queue 1 item 6).
"""

from . import glm4_9b, phi3_mini_3_8b, qwen3_14b, rwkv6_3b
from .base import ModelConfig

ARCHS = {m.CONFIG.name: m.CONFIG
         for m in (glm4_9b, phi3_mini_3_8b, qwen3_14b, rwkv6_3b)}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(
            f"arch {name!r} is not ported yet (see ROADMAP.md, queue 1 "
            f"item 6); available: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "ModelConfig", "get_config"]
