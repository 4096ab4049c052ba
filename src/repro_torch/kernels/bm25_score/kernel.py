"""Wrappers of the CUDA BM25 scoring kernels (``csrc/bm25_score.cu``).

Counterpart of ``repro/kernels/bm25_score/kernel.py``, whose Pallas kernels
take gathered [nr,128] copies plus an ``fmeta`` tile of per-row idf; the
CUDA kernels gather their rows and idf (``idf[lob[row]]``) themselves from
the resident arena (see the note atop the source).

A wrapper takes its plain version (``ref.py``) only for tensors on the
CPU.  For CUDA tensors it checks device, dtype, shape and contiguity,
allocates the output, launches the kernel on the current stream and
raises if the launch failed; there is no fallback.  ``<wrapper>.launches``
counts the launches.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..vbyte_decode.kernel import BLOCK_BYTES, BLOCK_VALS, on_cpu, require
from . import ref

NORM_LEVELS = 256
_LIB = "bm25_score"


def _require_sidecar(flens, fdata, norm_q, idf, lob, table):
    require(flens, "flens", torch.int32, BLOCK_VALS, align=16)
    require(fdata, "fdata", torch.uint8, BLOCK_BYTES, align=16)
    require(norm_q, "norm_q", torch.uint8, BLOCK_VALS, align=16)
    require(idf, "idf", torch.float32, ndim=1)
    require(lob, "lob", torch.int32, ndim=1)
    require(table, "table", torch.float32, ndim=1)
    if table.shape[0] != NORM_LEVELS:
        raise ValueError(f"table: expected {NORM_LEVELS} entries")
    if flens.shape[0] != fdata.shape[0] or flens.shape[0] < norm_q.shape[0]:
        raise ValueError("freq tiles must cover every block of norm_q")
    if lob.shape[0] != norm_q.shape[0]:
        raise ValueError("lob and norm_q must hold one entry per block")


def _k1p1(k1p1) -> float:
    k = np.float32(k1p1)
    return float(k)  # exact in a C float


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def bm25_score_rows(flens, fdata, norm_q, idf, lob, table, k1p1, rows=None):
    """[n, 128] float32 contract scores of arena rows.

    flens [R,128] int32 / fdata [R,512] uint8: the freq tiles (R padded to
    a multiple of 8); norm_q [nb,128] uint8; idf [n_lists] float32; lob
    [nb] int32; table [256] float32; k1p1 = k1 + 1 (float32).  rows [n]
    int32 picks block rows (None: all nb blocks).  Padding lanes score
    garbage; callers mask them with ``lane_valid``.
    """
    if on_cpu(flens, fdata, norm_q, idf, lob, table, rows):
        return ref.score_rows_ref(flens, fdata, norm_q, idf, lob, table, k1p1,
                                  rows)
    _require_sidecar(flens, fdata, norm_q, idf, lob, table)
    if rows is not None:
        require(rows, "rows", torch.int32, ndim=1)
    n = norm_q.shape[0] if rows is None else rows.shape[0]
    out = torch.empty((n, BLOCK_VALS), dtype=torch.float32, device=flens.device)
    if n:
        fn = _build.bind(_build.load(_LIB), "bm25_score_rows", 8, 1, 1)
        _build.check(
            fn(flens.data_ptr(), fdata.data_ptr(), norm_q.data_ptr(),
               idf.data_ptr(), lob.data_ptr(), table.data_ptr(),
               _build.ptr(rows), out.data_ptr(), n, _k1p1(k1p1),
               _stream(flens)),
            "bm25_score_rows",
        )
        bm25_score_rows.launches += 1
    return out


bm25_score_rows.launches = 0


def bm25_score_probe(lens, data, block_base, codec_row, flens, fdata, norm_q,
                     idf, lob, table, k1p1, rows, pe):
    """[C] float32: BM25 contribution of docID ``pe[c]`` in block
    ``rows[c]``, 0.0 when absent.

    lens [R,128] int32 / data [R,512] uint8 / block_base [nb] int32: the
    docID arena, its tiles reached through ``codec_row`` [nb] int32 in a
    multi-codec arena (None: rows are tile rows); the freq sidecar as
    ``bm25_score_rows``.  rows [C] int32 are located block rows, pe [C]
    int32 the probes (each <= its row's endpoint for a meaningful answer;
    callers mask past-the-end cursors).
    """
    if on_cpu(lens, data, block_base, codec_row, flens, fdata, norm_q, idf,
              lob, table, rows, pe):
        return ref.score_probe_ref(lens, data, block_base, codec_row, flens,
                                   fdata, norm_q, idf, lob, table, k1p1, rows,
                                   pe)
    require(lens, "lens", torch.int32, BLOCK_VALS, align=16)
    require(data, "data", torch.uint8, BLOCK_BYTES, align=16)
    require(block_base, "block_base", torch.int32, ndim=1)
    if codec_row is not None:
        require(codec_row, "codec_row", torch.int32, ndim=1)
    _require_sidecar(flens, fdata, norm_q, idf, lob, table)
    require(rows, "rows", torch.int32, ndim=1)
    require(pe, "pe", torch.int32, ndim=1)
    if pe.shape != rows.shape:
        raise ValueError("rows and pe must have one entry per cursor")
    n = rows.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=rows.device)
    if n:
        fn = _build.bind(_build.load(_LIB), "bm25_score_probe", 13, 1, 1)
        _build.check(
            fn(lens.data_ptr(), data.data_ptr(), block_base.data_ptr(),
               _build.ptr(codec_row), flens.data_ptr(), fdata.data_ptr(),
               norm_q.data_ptr(), idf.data_ptr(), lob.data_ptr(),
               table.data_ptr(), rows.data_ptr(), pe.data_ptr(),
               out.data_ptr(), n, _k1p1(k1p1), _stream(rows)),
            "bm25_score_probe",
        )
        bm25_score_probe.launches += 1
    return out


bm25_score_probe.launches = 0
