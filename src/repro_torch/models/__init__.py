"""The LM tier's dense decoder (``layers``, ``lm``) and ``build_model``."""

from .model import LM, build_model

__all__ = ["LM", "build_model"]
