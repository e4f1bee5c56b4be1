"""ENDURE-tuned manifests and the batched re-tune storm (the port of
``repro.checkpoint``, its tuning half; ``CheckpointStore`` waits for the
trainer, ROADMAP.md queue 6)."""

from .store import (framework_storage_workload, retune_storm,
                    tuned_manifest_tree, tuned_manifest_trees)

__all__ = ["framework_storage_workload", "retune_storm",
           "tuned_manifest_tree", "tuned_manifest_trees"]
