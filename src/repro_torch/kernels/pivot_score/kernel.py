"""Wrapper of the CUDA fused pivot + scoring kernel (``csrc/pivot_score.cu``).

Counterpart of ``repro/kernels/pivot_score/kernel.py``, which composes two
Pallas kernels around an XLA gather; here one kernel does both halves (see
the note atop the source).  Same dispatch rule as ``vbyte_decode.kernel``:
the plain version (``ref.py``) for CPU tensors, the kernel or an
exception for CUDA tensors.
"""

from __future__ import annotations

import torch

from .. import _build
from ..bm25_score.kernel import _k1p1, _require_sidecar
from ..vbyte_decode.kernel import BLOCK_VALS, on_cpu, require
from . import ref
from .ref import SCORE_SLOTS

__all__ = ["SCORE_SLOTS", "pivot_score"]


def pivot_score(qb, nblk, base, qmin, rows, flens, fdata, norm_q, idf, lob,
                table, k1p1):
    """Fused pivot + kept-slot scoring: (compact [n,128], count [n],
    pivot [n], maxq [n]) int32 as ``blockmax_pivot.kernel.pivot_select``,
    plus sscores [n, SCORE_SLOTS, 128] float32.

    qb [nc,128] / nblk [nc] / base [nc] int32: the resident chunk table
    (base = arena row of the chunk's lane 0); rows [n] int32 and qmin
    [n,128] int32 per cursor; flens / fdata / norm_q / idf / lob / table /
    k1p1: the resident freq sidecar, as ``bm25_score_rows`` takes it.
    Slot s of cursor c holds the scores of arena row
    ``clamp(base + max(compact[c, s], 0), 0, n_blocks - 1)``.
    """
    if on_cpu(qb, nblk, base, qmin, rows, flens, fdata, norm_q, idf, lob,
              table):
        return ref.pivot_score_ref(qb, nblk, base, qmin, rows, flens, fdata,
                                   norm_q, idf, lob, table, k1p1)
    require(qb, "qb", torch.int32, BLOCK_VALS, align=16)
    require(nblk, "nblk", torch.int32, ndim=1)
    require(base, "base", torch.int32, ndim=1)
    require(qmin, "qmin", torch.int32, BLOCK_VALS, align=16)
    require(rows, "rows", torch.int32, ndim=1)
    _require_sidecar(flens, fdata, norm_q, idf, lob, table)
    if not qb.shape[0] == nblk.shape[0] == base.shape[0]:
        raise ValueError("qb, nblk and base must hold one entry per chunk")
    if qmin.shape[0] != rows.shape[0]:
        raise ValueError("one qmin tile per cursor")
    n = rows.shape[0]
    dev = rows.device
    out = torch.empty((n, BLOCK_VALS), dtype=torch.int32, device=dev)
    aux = torch.empty((n, 3), dtype=torch.int32, device=dev)
    sscores = torch.empty((n, SCORE_SLOTS, BLOCK_VALS), dtype=torch.float32,
                          device=dev)
    if n:
        fn = _build.bind(_build.load("pivot_score"), "pivot_score", 14, 2, 1)
        _build.launch(fn, "pivot_score", dev, qb.data_ptr(),
                      nblk.data_ptr(), base.data_ptr(), qmin.data_ptr(),
                      rows.data_ptr(), flens.data_ptr(), fdata.data_ptr(),
                      norm_q.data_ptr(), idf.data_ptr(), lob.data_ptr(),
                      table.data_ptr(), out.data_ptr(), aux.data_ptr(),
                      sscores.data_ptr(), n, norm_q.shape[0], _k1p1(k1p1))
        pivot_score.launches += 1
    return out, aux[:, 0], aux[:, 1], aux[:, 2], sscores


pivot_score.launches = 0
