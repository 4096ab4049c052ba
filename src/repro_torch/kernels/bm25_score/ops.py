"""Numpy mirrors of the BM25 scoring kernels.

Counterpart of ``repro/kernels/bm25_score/ops.py``'s numpy backend, copied
from the reference: the host path of ``TopKEngine(backend="numpy")`` and a
reference the tests hold the kernels' plain versions to.  They compute the
float32 contract of ``repro_torch.ranked.bm25`` with the norm GATHERED
from the shared 256-entry table, so outputs are bit-identical to the
kernels'.  ``TopKEngine`` calls the kernel wrappers on its resident arena
directly.
"""

from __future__ import annotations

import numpy as np

from ..vbyte_decode.ops import decode_blocks_np


def score_rows_np(flens, fdata, norms, idf_rows, table, k1p1):
    """Numpy mirror of the row scorer: [nr, 128] float32 scores of
    gathered freq rows."""
    tf = (decode_blocks_np(flens, fdata) + 1).astype(np.float32)
    k_hat = np.asarray(table, np.float32)[np.asarray(norms, np.int64)]
    idf_c = np.asarray(idf_rows, np.float32)[:, None]
    return (idf_c * ((tf * np.float32(k1p1)) / (tf + k_hat))).astype(np.float32)


def score_probe_np(
    lens, data, flens, fdata, norms, block_base, rows, probes, idf_rows,
    table, k1p1,
):
    """Numpy mirror of the fused probe kernel; duplicate rows decoded once.

    Returns contrib [C] float32: the BM25 contribution of the probed docID
    in its located row, 0.0 when absent.
    """
    rows = np.asarray(rows, dtype=np.int64)
    probes = np.asarray(probes, dtype=np.int64)
    urows, first, inv = np.unique(rows, return_index=True, return_inverse=True)
    gaps = decode_blocks_np(lens[urows], data[urows])
    vals = np.asarray(block_base, np.int64)[urows][:, None] + np.cumsum(
        gaps + 1, axis=1
    )
    # idf is a property of the row's owning list: every cursor sharing a row
    # carries the same idf, so scoring once per unique row is exact
    scores_u = score_rows_np(
        np.asarray(flens)[urows], np.asarray(fdata)[urows],
        np.asarray(norms)[urows],
        np.asarray(idf_rows, np.float32)[first], table, k1p1,
    )
    match = vals[inv] == probes[:, None]
    return np.where(match, scores_u[inv], np.float32(0.0)).sum(
        axis=1, dtype=np.float32
    )
