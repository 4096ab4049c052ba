"""Wrapper of the CUDA gain-scan kernel (``csrc/gain_scan.cu``).

Counterpart of ``repro/kernels/gain_scan/kernel.py``, whose Pallas kernel
walks the blocks in grid order and carries the running gain in a scalar
scratch cell; the CUDA kernel scans tiles of blocks in one pass and takes
each tile's carry from its predecessors by decoupled look-back (see the
note atop the source).
Same dispatch rule as ``vbyte_decode.kernel``: the plain version
(``ref.py``) for CPU tensors, the kernel or an exception for CUDA tensors.
"""

from __future__ import annotations

import torch

from .. import _build
from ..vbyte_decode.kernel import on_cpu, require
from . import ref

BLOCK = 1024  # elements per block of the (g, block_min, block_max) contract


def gain_scan(gaps):
    """gaps [n] int32, n % 1024 == 0 -> (g [n], block_min [n/1024],
    block_max [n/1024]), all int32: g is the inclusive prefix of
    ``8 * vbytes(max(gap - 1, 0)) - gap``, the min and max taken per
    1024-element block."""
    if gaps.dim() != 1 or gaps.shape[0] % BLOCK:
        raise ValueError(f"gaps: need [n] with n % {BLOCK} == 0, got "
                         f"{tuple(gaps.shape)}")
    if on_cpu(gaps):
        return ref.gain_scan_ref(gaps, BLOCK)
    require(gaps, "gaps", torch.int32, ndim=1, align=16)
    nb = gaps.shape[0] // BLOCK
    g = torch.empty_like(gaps)
    mn = torch.empty(nb, dtype=torch.int32, device=gaps.device)
    mx = torch.empty(nb, dtype=torch.int32, device=gaps.device)
    if nb:
        # the tile counter and a status word a tile (nb + 1 covers any
        # tile size); the entry point zeroes what it uses
        scratch = torch.empty(nb + 1, dtype=torch.int64, device=gaps.device)
        fn = _build.bind(_build.load("gain_scan"), "gain_scan", 5, 1)
        _build.launch(fn, "gain_scan", gaps.device, gaps.data_ptr(),
                      g.data_ptr(), mn.data_ptr(), mx.data_ptr(),
                      scratch.data_ptr(), nb)
        gain_scan.launches += 1
    return g, mn, mx


gain_scan.launches = 0
