"""Fused decode + BM25 scoring kernels over the ranked block arena."""
