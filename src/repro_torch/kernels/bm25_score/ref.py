"""Plain PyTorch versions of the two BM25 scoring kernels.

Counterparts of ``repro/kernels/bm25_score/ref.py``, with the signatures of
the CUDA wrappers in ``kernel.py``: they take the resident ranked arena
(freq tiles, norm codes, idf per list, ``lob`` per block, the norm table)
and gather the rows they score themselves.  The float32 contract of
``repro_torch.ranked.bm25.score_tf`` is kept step for step:

    score = idf * ((tf * k1p1) / (tf + table[norm_q]))

with every operand a float32 tensor (``k1p1`` included: a Python float
would enter the product at another precision), one operation per step, no
``torch.compile`` -- so the CPU results are bit-identical to the numpy
mirror, the Pallas kernels and the CUDA kernels.
"""

from __future__ import annotations

import torch

from ..vbyte_decode.ref import decode_blocks_ref, row_docids


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def score_rows_ref(flens, fdata, norm_q, idf, lob, table, k1p1, rows=None):
    """[n, 128] float32 contract scores of arena rows.

    flens [R,128] int32 / fdata [R,512] uint8: the freq tiles; norm_q
    [nb,128] uint8; idf [n_lists] float32; lob [nb] int32 (owning list per
    block); table [256] float32; k1p1: k1 + 1 as float32.  rows [n] int32
    picks the rows (None: the nb rows of ``norm_q``).  Padding lanes score
    whatever their bytes decode to; callers mask them.
    """
    dev = flens.device
    if rows is None:
        rows = torch.arange(norm_q.shape[0], dtype=torch.int32, device=dev)
    r = rows.long()
    # tf = (decoded + 1) in wrapping int32, then rounded to float32
    tf = (decode_blocks_ref(flens, fdata, rows).long() + 1).to(torch.int32)
    tf = tf.to(torch.float32)
    k_hat = table[norm_q[r].long()]
    idf_r = idf[lob[r].long()][:, None]
    return idf_r * ((tf * _f32(k1p1, dev)) / (tf + k_hat))


def score_probe_ref(lens, data, block_base, codec_row, flens, fdata, norm_q,
                    idf, lob, table, k1p1, rows, pe):
    """[C] float32: the contract score of the lane of block ``rows[c]``
    whose docID equals ``pe[c]``, 0.0 when no lane does.

    lens / data / block_base / codec_row: the docID arena as
    ``decode_search`` takes it; the rest as ``score_rows_ref``.
    """
    vals = row_docids(lens, data, block_base, rows, codec_row)
    scores = score_rows_ref(flens, fdata, norm_q, idf, lob, table, k1p1, rows)
    hit = vals == pe[:, None]
    return torch.where(hit, scores, torch.zeros_like(scores)).sum(1)
