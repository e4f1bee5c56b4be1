"""Config registry: the dense decoders the port runs.

Only the three dense configs are here; the JAX package's other
architectures come with their families (ROADMAP.md queue 1 items 11-12).
"""

from . import glm4_9b, phi3_mini_3_8b, qwen3_14b
from .base import ModelConfig

ARCHS = {m.CONFIG.name: m.CONFIG
         for m in (glm4_9b, phi3_mini_3_8b, qwen3_14b)}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(
            f"arch {name!r} is not ported yet (see ROADMAP.md, queue 1 "
            f"items 11-12); available: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "ModelConfig", "get_config"]
