"""The LM tier: dense, MoE, Mamba and RWKV-6 blocks (``layers``, ``moe``,
``mamba``, ``rwkv``), their assembly (``lm``), the encoder-decoder
(``encdec``) and ``build_model``."""

from .model import LM, EncDec, build_model

__all__ = ["EncDec", "LM", "build_model"]
