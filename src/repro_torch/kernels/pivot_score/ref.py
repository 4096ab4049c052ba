"""Plain PyTorch version of the fused pivot + kept-slot scoring kernel.

Counterpart of ``repro/kernels/pivot_score/ref.py``: the plain pivot of
``blockmax_pivot.ref`` composed with the plain row scorer of
``bm25_score.ref`` around a gather of the kept blocks, with the signature
of the CUDA wrapper in ``kernel.py``.
"""

from __future__ import annotations

from ..blockmax_pivot.ref import pivot_select_ref
from ..bm25_score.ref import score_rows_ref

BLOCK_VALS = 128
SCORE_SLOTS = 16


def slot_rows(base, rows, compact, n_blocks: int, slots: int = SCORE_SLOTS):
    """[n, slots] int32 arena rows scored per cursor: the chunk base plus
    each kept lane, the base itself for slots past the count (compact is
    -1 there: deterministic garbage, masked by the count), clamped to the
    ``n_blocks`` rows that the norm codes and ``lob`` hold."""
    krows = base[rows.long()].long()[:, None] + compact[:, :slots].long().clamp(min=0)
    return krows.clamp(0, n_blocks - 1).int()


def pivot_score_ref(qb, nblk, base, qmin, rows, flens, fdata, norm_q, idf,
                    lob, table, k1p1):
    """Pivot selection + all-lane scores of the first SCORE_SLOTS kept
    blocks of each cursor's chunk.

    qb [nc,128] / nblk [nc] / base [nc] int32: the resident chunk table;
    qmin [n,128] int32 and rows [n] int32 per cursor; the freq sidecar as
    ``bm25_score.ref.score_rows_ref``.  Returns (compact, count, pivot,
    maxq) as ``pivot_select_ref`` plus sscores [n, SCORE_SLOTS, 128]
    float32, slot s holding the scores of arena row ``slot_rows[:, s]``.
    """
    compact, count, pivot, maxq = pivot_select_ref(qb, nblk, qmin, rows)
    n = rows.shape[0]
    krows = slot_rows(base, rows, compact, norm_q.shape[0])
    sscores = score_rows_ref(flens, fdata, norm_q, idf, lob, table, k1p1,
                             krows.reshape(-1))
    return compact, count, pivot, maxq, sscores.reshape(n, SCORE_SLOTS, BLOCK_VALS)
