"""Launchers: ``serve`` (batched prefill + greedy decode), ``train`` (the
training loop) and ``elastic`` (the failure / straggler policy)."""
