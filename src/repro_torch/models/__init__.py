"""The LM tier: dense and RWKV-6 blocks (``layers``, ``rwkv``), their
assembly (``lm``) and ``build_model``."""

from .model import LM, build_model

__all__ = ["LM", "build_model"]
