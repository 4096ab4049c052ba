"""Gain-function scan of the paper's partitioner (Definition 1)."""
