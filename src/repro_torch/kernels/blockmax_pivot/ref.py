"""Plain PyTorch version of the Block-Max pivot selection kernel.

Counterpart of ``repro/kernels/blockmax_pivot/ref.py``, with the signature
of the CUDA wrapper in ``kernel.py``: it takes the resident chunk table
(``qb`` [nc,128], ``nblk`` [nc]) and the chunk row of each cursor.
Integer-only, so it is bit-identical to the kernel by construction.
Compaction is a stable sort (kept lanes keyed below dropped ones) instead
of the kernel's ballots -- the same result.
"""

from __future__ import annotations

import torch

BLOCK_VALS = 128
I32_MAX = 2**31 - 1


def pivot_tiles(qb, qmin, nblk):
    """Gathered chunk rows -> (compact [n,128], count [n], pivot [n],
    maxq [n]), all int32.

    qb / qmin [n,128] int32 bound and minimal-admissible codes, nblk [n]
    valid lanes.  compact lists the kept lanes ascending, -1 past the
    count; pivot is the lowest kept lane with the max kept bound (-1 when
    none), maxq that bound (-1 when none).
    """
    n = qb.shape[0]
    lane = torch.arange(BLOCK_VALS, device=qb.device).expand(n, BLOCK_VALS)
    keep = (qb >= qmin) & (lane < nblk[:, None])
    count = keep.sum(1)
    order = torch.argsort(torch.where(keep, lane, lane + BLOCK_VALS), dim=1)
    compact = torch.where(lane < count[:, None], order, -1)
    neg = torch.full_like(qb, -1)
    maxq = torch.where(keep, qb, neg).amax(1) if n else count.clone()
    at_max = keep & (qb == maxq[:, None])
    pivot = torch.where(at_max, lane, I32_MAX).amin(1) if n else count.clone()
    pivot = torch.where(count > 0, pivot, -1)
    i32 = torch.int32
    return compact.to(i32), count.to(i32), pivot.to(i32), maxq.to(i32)


def pivot_select_ref(qb, nblk, qmin, rows):
    """Pivot selection of chunk rows ``rows`` [n] int32 of the resident
    table (qb [nc,128] int32, nblk [nc] int32) against per-cursor qmin
    tiles [n,128] int32; returns as ``pivot_tiles``."""
    r = rows.long()
    return pivot_tiles(qb[r], qmin, nblk[r])
