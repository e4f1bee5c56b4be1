"""Checkpointing with ENDURE-tuned manifests and the batched re-tune
storm (the port of ``repro.checkpoint``)."""

from .store import (CheckpointStore, framework_storage_workload,
                    retune_storm, tuned_manifest_tree,
                    tuned_manifest_trees)

__all__ = ["CheckpointStore", "framework_storage_workload",
           "retune_storm", "tuned_manifest_tree", "tuned_manifest_trees"]
