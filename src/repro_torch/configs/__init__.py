"""Config registry: the JAX package's ten architectures.

The dense decoders (``qwen1.5-110b``, ``glm4-9b``, ``phi3-mini-3.8b``,
``qwen3-14b``), ``rwkv6-3b``, the encoder-decoder ``whisper-base``, the two
MoE decoders (``deepseek-moe-16b``, ``mixtral-8x7b``), the stub-embedding
``qwen2-vl-72b`` with M-RoPE, and the Mamba/attention/MoE hybrid
``jamba-1.5-large-398b``.
"""

from . import (deepseek_moe_16b, glm4_9b, jamba_1_5_large_398b,
               mixtral_8x7b, phi3_mini_3_8b, qwen1_5_110b, qwen2_vl_72b,
               qwen3_14b, rwkv6_3b, whisper_base)
from .base import (SHAPES, EncoderConfig, ModelConfig, MoEConfig,
                   ShapeConfig, shape_applicable)

ARCHS = {m.CONFIG.name: m.CONFIG
         for m in (qwen1_5_110b, glm4_9b, phi3_mini_3_8b, qwen3_14b,
                   rwkv6_3b, whisper_base, deepseek_moe_16b, mixtral_8x7b,
                   qwen2_vl_72b, jamba_1_5_large_398b)}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "SHAPES", "EncoderConfig", "ModelConfig", "MoEConfig",
           "ShapeConfig", "get_config", "shape_applicable"]
