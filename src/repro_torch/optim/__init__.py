"""Optimizers of the port."""

from .adamw import adamw_init, adamw_update, clip_by_global_norm, cosine_lr
