"""AdamW and gradient compression (the port of ``repro.optim``)."""

from . import adamw, compression
from .adamw import AdamWConfig, AdamWState, cosine_schedule

__all__ = ["adamw", "compression", "AdamWConfig", "AdamWState",
           "cosine_schedule"]
