"""Launchers: ``serve`` (batched prefill + greedy decode)."""
