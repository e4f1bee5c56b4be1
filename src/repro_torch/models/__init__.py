"""The LM tier: dense, MoE, Mamba and RWKV-6 blocks (``layers``, ``moe``,
``mamba``, ``rwkv``), their assembly (``lm``) and ``build_model``."""

from .model import LM, build_model

__all__ = ["LM", "build_model"]
