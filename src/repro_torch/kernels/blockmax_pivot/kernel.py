"""Wrapper of the CUDA Block-Max pivot kernel (``csrc/blockmax_pivot.cu``).

Counterpart of ``repro/kernels/blockmax_pivot/kernel.py``, whose Pallas
kernel takes gathered chunk copies and a meta tile; the CUDA kernel
gathers its chunk row itself from the resident table.  Same dispatch rule
as ``vbyte_decode.kernel``: the plain version (``ref.py``) for CPU
tensors, the kernel or an exception for CUDA tensors.
"""

from __future__ import annotations

import torch

from .. import _build
from ..vbyte_decode.kernel import BLOCK_VALS, on_cpu, require
from . import ref

# block_max_q is u8, so 256 is one past every representable bound code:
# qmin == QMIN_NONE prunes the lane unconditionally
QMIN_NONE = 256

_ENTRY = None


def _entry():
    """The bound C entry point, built and bound at the first launch."""
    global _ENTRY
    if _ENTRY is None:
        _ENTRY = _build.bind(_build.load("blockmax_pivot"),
                             "blockmax_pivot_select", 6, 1)
    return _ENTRY


def pivot_select(qb, nblk, qmin, rows):
    """Keep-test + compaction + pivot: (compact [n,128], count [n],
    pivot [n], maxq [n]), all int32.

    qb [nc,128] int32 / nblk [nc] int32: the resident chunk table; rows [n]
    int32: the chunk row of each cursor; qmin [n,128] int32: each cursor's
    minimal admissible code per lane (QMIN_NONE prunes).  The contract of
    ``ref.pivot_tiles``.
    """
    if on_cpu(qb, nblk, qmin, rows):
        return ref.pivot_select_ref(qb, nblk, qmin, rows)
    require(qb, "qb", torch.int32, BLOCK_VALS, align=16)
    require(nblk, "nblk", torch.int32, ndim=1)
    require(qmin, "qmin", torch.int32, BLOCK_VALS, align=16)
    require(rows, "rows", torch.int32, ndim=1)
    if nblk.shape[0] != qb.shape[0] or qmin.shape[0] != rows.shape[0]:
        raise ValueError("one nblk per chunk and one qmin tile per cursor")
    n = rows.shape[0]
    # out [n, 128] then aux [n, 3] in one allocation (out 16-byte aligned,
    # as the kernel's int4 stores need), cut into the four results by as
    # few tensor ops as will do: the wrapper's host time is most of a call
    a = n * BLOCK_VALS
    buf = torch.empty(a + 3 * n, dtype=torch.int32, device=rows.device)
    if n:
        out = buf.data_ptr()
        _build.launch(_entry(), "blockmax_pivot_select", rows.device,
                      qb.data_ptr(), nblk.data_ptr(), qmin.data_ptr(),
                      rows.data_ptr(), out, out + 4 * a, n)
        pivot_select.launches += 1
    return (buf[:a].view(n, BLOCK_VALS), buf[a::3], buf[a + 1 :: 3],
            buf[a + 2 :: 3])


pivot_select.launches = 0
