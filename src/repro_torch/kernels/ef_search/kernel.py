"""Wrapper of the CUDA Elias-Fano NextGEQ kernel (``csrc/ef_search.cu``).

Counterpart of ``repro/kernels/ef_search/kernel.py``.  Same dispatch rule
as ``vbyte_decode.kernel``: the plain version (``ref.py``) for CPU
tensors, the kernel or an exception for CUDA tensors.
"""

from __future__ import annotations

import torch

from .. import _build
from ..vbyte_decode.kernel import BLOCK_VALS, on_cpu, require
from . import ref
from .ref import EF_HI_BITS, EF_HI_WORDS

__all__ = ["EF_HI_BITS", "EF_HI_WORDS", "ef_search"]


def ef_search(lo, hi, lbits, block_base, rows, pe, codec_row=None):
    """Fused EF NextGEQ: (value [C] int32, rank [C] int32).

    lo [E,128] / hi [E,24] / lbits [E]: the resident EF tiles, widened to
    int32 as the arena uploads them.  block_base [nb] int32.  rows [C]
    int32: the block row located for each cursor, mapped through
    ``codec_row`` [nb] int32 to a tile row (None: rows are tile rows).
    pe [C] int32: the probes.  The contract of ``decode_search``.
    """
    if on_cpu(lo, hi, lbits, block_base, rows, pe, codec_row):
        return ref.ef_search_ref(lo, hi, lbits, block_base, rows, pe, codec_row)
    require(lo, "lo", torch.int32, BLOCK_VALS, align=16)
    require(hi, "hi", torch.int32, EF_HI_WORDS, align=8)
    require(lbits, "lbits", torch.int32, ndim=1)
    require(block_base, "block_base", torch.int32, ndim=1)
    require(rows, "rows", torch.int32, ndim=1)
    require(pe, "pe", torch.int32, ndim=1)
    if codec_row is not None:
        require(codec_row, "codec_row", torch.int32, ndim=1)
    if pe.shape != rows.shape:
        raise ValueError("rows and pe must have one entry per cursor")
    if not lo.shape[0] == hi.shape[0] == lbits.shape[0]:
        raise ValueError("lo, hi and lbits must hold the same tiles")
    n = rows.shape[0]
    value = torch.empty(n, dtype=torch.int32, device=rows.device)
    rank = torch.empty(n, dtype=torch.int32, device=rows.device)
    if n:
        fn = _build.bind(_build.load("ef_search"), "ef_search", 9, 1)
        _build.check(
            fn(lo.data_ptr(), hi.data_ptr(), lbits.data_ptr(),
               block_base.data_ptr(), _build.ptr(codec_row), rows.data_ptr(),
               pe.data_ptr(), value.data_ptr(), rank.data_ptr(), n,
               torch.cuda.current_stream(rows.device).cuda_stream),
            "ef_search",
        )
        ef_search.launches += 1
    return value, rank


ef_search.launches = 0
