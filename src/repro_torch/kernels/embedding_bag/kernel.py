"""Wrapper of the CUDA EmbeddingBag kernel (``csrc/embedding_bag.cu``).

Counterpart of ``repro/kernels/embedding_bag/kernel.py::embedding_bag``,
whose Pallas kernel streams one table row per (b, k) grid step through a
scalar-prefetched id; in the CUDA kernel a warp sums several bags at once,
4 lanes a row, each bag's ids and weights handed out by shuffles, and
sums each column in k order (see the note atop the source).
Same dispatch rule as ``vbyte_decode.kernel``: the plain version
(``ref.py``) for CPU tensors, the kernel or an exception for CUDA tensors.

There is no backward kernel, as the reference has none: a ``table`` that
would carry a gradient is refused rather than silently cut off.
"""

from __future__ import annotations

import torch

from .. import _build
from ..vbyte_decode.kernel import on_cpu, require
from . import ref

TABLE_DTYPES = {torch.float32: "embedding_bag_f32",
                torch.bfloat16: "embedding_bag_bf16"}


def embedding_bag(table, ids, weights):
    """table [V, D] f32 or bf16, ids [B, K] int32, weights [B, K] (cast to
    f32) -> [B, D] f32: ``out[b] = sum_k weights[b, k] * table[ids[b, k]]``,
    summed in k order.  A negative id wraps once by +V, then ids clamp to
    [0, V-1]."""
    if table.dim() != 2 or table.shape[1] < 1:
        raise ValueError(f"table: need [V, D] with D >= 1, got "
                         f"{tuple(table.shape)}")
    if ids.dim() != 2 or tuple(weights.shape) != tuple(ids.shape):
        raise ValueError(f"ids and weights: need one [B, K] shape, got "
                         f"{tuple(ids.shape)} and {tuple(weights.shape)}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids: expected torch.int32, got {ids.dtype}")
    if table.dtype not in TABLE_DTYPES:
        raise TypeError(f"table: expected float32 or bfloat16, got "
                        f"{table.dtype}")
    if table.shape[0] == 0 and ids.numel():
        raise ValueError("table: an empty table has no row to read")
    if table.requires_grad and torch.is_grad_enabled():
        raise ValueError(
            "embedding_bag has no backward kernel (the reference has none): "
            "pass table.detach(), or call it under torch.no_grad()"
        )
    weights = weights.to(torch.float32)
    if on_cpu(table, ids, weights):
        return ref.embedding_bag_ref(table, ids, weights)
    require(table, "table", table.dtype, align=table.element_size())
    require(ids, "ids", torch.int32)
    require(weights, "weights", torch.float32)
    B, K = ids.shape
    V, D = table.shape
    out = torch.empty((B, D), dtype=torch.float32, device=table.device)
    if B:
        name = TABLE_DTYPES[table.dtype]
        fn = _build.bind(_build.load("embedding_bag"), name, 4, 4)
        _build.launch(fn, name, table.device, table.data_ptr(),
                      ids.data_ptr(), weights.data_ptr(), out.data_ptr(),
                      B, K, V, D)
        embedding_bag.launches += 1
    return out


embedding_bag.launches = 0
