"""Fused Block-Max pivot + kept-slot BM25 scoring kernel family."""
