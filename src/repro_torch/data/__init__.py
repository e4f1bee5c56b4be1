"""The synthetic token pipeline (the port's copy of ``repro.data``)."""

from .pipeline import DataConfig, DataState, global_batch_at, iterate, shard_batch_at

__all__ = ["DataConfig", "DataState", "global_batch_at", "iterate",
           "shard_batch_at"]
