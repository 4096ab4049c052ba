"""Bag reductions over an embedding table.

Counterpart of ``repro/kernels/embedding_bag/ops.py``.  The tensors'
device picks the kernel's route (the CUDA kernel on the card, its plain
version on the CPU); the reference's ``use_kernel`` keyword carries over,
its ``interpret`` (a Pallas mode) does not.
"""

from __future__ import annotations

import torch

from .kernel import embedding_bag
from .ref import embedding_bag_ref


def multi_hot_embed(table, ids, mask, use_kernel: bool = True):
    """Multi-hot bag with a boolean mask -> [B, D] f32: ids [B, K] int32,
    mask [B, K] bool (False slots weigh 0).  ``use_kernel`` runs the
    ``embedding_bag`` wrapper, else its plain version on the tensors'
    device."""
    w = mask.to(torch.float32)
    if use_kernel:
        return embedding_bag(table, ids, w)
    return embedding_bag_ref(table, ids, w)


def segment_sum_embed(table, flat_ids, bag_ids, n_bags: int):
    """Ragged bags (the CSR-style path): row ``flat_ids[i]`` of ``table``
    summed into bag ``bag_ids[i]`` -> [n_bags, D] in the table's dtype.
    Plain torch (the reference has no kernel for it); ids must lie in
    range, where the reference would fill NaN or drop."""
    rows = table.index_select(0, flat_ids.long())
    out = torch.zeros((n_bags, table.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    return out.index_add_(0, bag_ids.long(), rows)
