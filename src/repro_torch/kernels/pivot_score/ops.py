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


# The family's identity and the signatures of its numpy / plain / CUDA
# triple, checked without importing anything by
# ``repro_torch.analyze.contracts``.  The numpy mirror takes chunk rows and
# per-block rows already gathered; the plain version and the wrapper take
# the resident chunk table and arena and gather through ``rows`` / ``lob``.
CONTRACT = {
    "family": "pivot_score",
    "identity": "f32-bit-exact",
    "ops": {
        "pivot_score": {
            "roles": [
                "qb",
                "qmin",
                "nblk",
                "base",
                "flens",
                "fdata",
                "norms",
                "idf",
                "table",
                "k1p1",
            ],
            "out": [
                "compact:int32[nr,128]",
                "count:int32[nr]",
                "pivot:int32[nr]",
                "maxq:int32[nr]",
                "sscores:float32[nr,slots,128]",
            ],
            "backends": {
                "numpy": {
                    "module": "ops",
                    "fn": "pivot_score_np",
                    "params": [
                        "qb:qb",
                        "qmins:qmin",
                        "nblks:nblk",
                        "bases:base",
                        "flens:flens",
                        "fdata:fdata",
                        "norms:norms",
                        "idf_rows:idf",
                        "table:table",
                        "k1p1:k1p1",
                        "slots:config",
                    ],
                },
                "ref": {
                    "module": "ref",
                    "fn": "pivot_score_ref",
                    "params": [
                        "qb:qb",
                        "nblk:nblk",
                        "base:base",
                        "qmin:qmin",
                        "rows:gather",
                        "flens:flens",
                        "fdata:fdata",
                        "norm_q:norms",
                        "idf:idf",
                        "lob:gather",
                        "table:table",
                        "k1p1:k1p1",
                    ],
                },
                "cuda": {
                    "module": "kernel",
                    "fn": "pivot_score",
                    "source": "csrc/pivot_score.cu",
                    "params": [
                        "qb:qb",
                        "nblk:nblk",
                        "base:base",
                        "qmin:qmin",
                        "rows:gather",
                        "flens:flens",
                        "fdata:fdata",
                        "norm_q:norms",
                        "idf:idf",
                        "lob:gather",
                        "table:table",
                        "k1p1:k1p1",
                    ],
                },
            },
        },
    },
}


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
