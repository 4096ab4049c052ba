"""Numpy mirror of the fused pivot + kept-slot scoring kernel.

Counterpart of ``repro/kernels/pivot_score/ops.py``'s numpy backend, a
reference the tests hold the kernel's plain version to.  The pivot half is
integer, the scoring half the f32 BM25 contract, and the gather indices
are the kernel's (slot rows clamped to the real blocks), so the outputs
are bit-identical.
"""

from __future__ import annotations

import numpy as np

from ..blockmax_pivot.ops import pivot_select_np
from ..bm25_score.ops import score_rows_np
from ..vbyte_decode.kernel import BLOCK_VALS
from .kernel import SCORE_SLOTS


def pivot_score_np(
    qb, qmins, nblks, bases, flens, fdata, norms, idf_rows, table, k1p1,
    slots=SCORE_SLOTS,
):
    """Numpy mirror of the fused kernel over gathered chunk rows.

    Invalid slots gather the chunk base (deterministic garbage, masked by
    ``count``); slot rows clamp to the ``len(norms)`` real blocks.
    idf_rows [nb] float32 is the idf of every block's owning list.
    Returns (compact, count, pivot, maxq) int64 plus sscores
    [nr, slots, 128] float32.
    """
    compact, count, pivot, maxq = pivot_select_np(qb, qmins, nblks)
    nr = compact.shape[0]
    nb = np.asarray(norms).shape[0]
    krows = np.clip(
        np.asarray(bases, np.int64)[:, None]
        + np.maximum(compact[:, :slots], 0),
        0, nb - 1,
    )
    g = krows.reshape(-1)
    sscores = score_rows_np(
        np.asarray(flens)[g], np.asarray(fdata)[g], np.asarray(norms)[g],
        np.asarray(idf_rows, np.float32)[g], table, k1p1,
    ).reshape(nr, slots, BLOCK_VALS)
    return compact, count, pivot, maxq, sscores
