"""Fused Elias-Fano NextGEQ over 128-value tiles."""
