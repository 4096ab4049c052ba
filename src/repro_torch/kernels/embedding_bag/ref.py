"""Plain version of the fixed-arity EmbeddingBag.

Counterpart of ``repro/kernels/embedding_bag/ref.py::embedding_bag_ref``
and of the Pallas kernel beside it.  It is the CUDA kernel's bit-for-bit
yardstick: f32 accumulation in k order, one rounded multiply and one
rounded add per k, with no fused multiply-add.

Out-of-range ids follow the Pallas kernel (not the jnp oracle, whose
``take`` fills NaN): a negative id wraps once by +V, then every id clamps
to [0, V-1].  So no lookup leaves the table.
"""

from __future__ import annotations

import torch


def clamp_ids(ids: torch.Tensor, V: int) -> torch.Tensor:
    """The row each id reads, as int64: ``id + V`` for a negative id, then
    clamped to [0, V-1]."""
    ids = ids.long()
    return torch.where(ids < 0, ids + V, ids).clamp_(0, V - 1)


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """table [V, D] f32 or bf16, ids [B, K] int32, weights [B, K] f32 ->
    [B, D] f32: ``out[b] = sum_k weights[b, k] * table[ids[b, k]]``."""
    B, K = ids.shape
    rows = clamp_ids(ids, table.shape[0])
    w = weights.to(torch.float32)
    acc = torch.zeros((B, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for k in range(K):
        acc = acc + w[:, k, None] * table.index_select(0, rows[:, k]).float()
    return acc
