"""Synthetic corpora and query workloads."""
