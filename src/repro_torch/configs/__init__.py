"""Config registry: the architectures the port runs.

The three dense decoders, ``rwkv6-3b``, the two MoE decoders
(``deepseek-moe-16b``, ``mixtral-8x7b``) and the Mamba/attention/MoE
hybrid ``jamba-1.5-large-398b``; the JAX package's other architectures
(encoder towers, M-RoPE and ``qwen1.5-110b``) come with their families
(ROADMAP.md queue 1 item 6).
"""

from . import (deepseek_moe_16b, glm4_9b, jamba_1_5_large_398b,
               mixtral_8x7b, phi3_mini_3_8b, qwen3_14b, rwkv6_3b)
from .base import ModelConfig, MoEConfig

ARCHS = {m.CONFIG.name: m.CONFIG
         for m in (glm4_9b, phi3_mini_3_8b, qwen3_14b, rwkv6_3b,
                   deepseek_moe_16b, mixtral_8x7b, jamba_1_5_large_398b)}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(
            f"arch {name!r} is not ported yet (see ROADMAP.md, queue 1 "
            f"item 6); available: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "ModelConfig", "MoEConfig", "get_config"]
