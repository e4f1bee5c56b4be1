"""Measurements of the port's kernels on the card (run as modules)."""
